"""Sliding-window quantile sketches over the histogram bucket grid.

The port's own copy of ``client_tpu/observability/window.py``.

Cumulative histograms answer "how slow has the service been since it
started"; operators paging on an incident need "how slow is it RIGHT
NOW". :class:`WindowedHistogram` keeps a ring of fixed-width sub-windows
over the same bucket grid the exposition histograms use, so a rolling
p50/p95/p99 over the last 30 s / 5 m is one O(buckets) merge away with
bounded memory (``subwindows × (buckets + 1)`` integers), and two
snapshots (from different replicas or different horizons built on the
same grid) merge associatively — the property the fleet aggregator
(:mod:`client_tpu_torch.observability.fleet`) relies on.

:class:`WindowedCounter` is the two-field (good/bad) twin the SLO
tracker uses for rolling error-budget accounting.

Everything here is clock-injectable (``clock_ns``) and lock-guarded —
requests record from the event loop, the native pump thread, and
executor threads while scrapes snapshot concurrently. No component reads
a wall clock directly (``tools/clock_lint.py`` covers this package).
"""

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["WindowSnapshot", "WindowedCounter", "WindowedHistogram"]


@dataclass
class WindowSnapshot:
    """Merged view of a window's live sub-windows: per-bucket
    (non-cumulative) counts over the same bound grid, plus sum/count.
    Pure data — mergeable across replicas and associatively so."""

    bounds: Tuple[float, ...]
    counts: List[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0
    horizon_s: float = 0.0

    def quantile(self, q: float) -> float:
        """Latency estimate for quantile ``q`` in [0, 1]: linear
        interpolation inside the bucket holding the target rank (the
        standard Prometheus ``histogram_quantile`` estimator). Returns
        0.0 for an empty window; observations past the last finite
        bound report that bound (the estimate cannot exceed the grid)."""
        if self.count <= 0:
            return 0.0
        rank = q * self.count
        cumulative = 0
        for i, bucket_count in enumerate(self.counts):
            previous = cumulative
            cumulative += bucket_count
            if cumulative >= rank and bucket_count > 0:
                if i >= len(self.bounds):  # +Inf overflow bucket
                    return self.bounds[-1] if self.bounds else 0.0
                lower = self.bounds[i - 1] if i > 0 else 0.0
                upper = self.bounds[i]
                return lower + (upper - lower) * (
                    (rank - previous) / bucket_count
                )
        return self.bounds[-1] if self.bounds else 0.0

    def merge(self, other: "WindowSnapshot") -> "WindowSnapshot":
        """Pointwise sum of two snapshots on the same bound grid —
        commutative and associative, so any merge order over a fleet
        produces the same aggregate."""
        if self.bounds != other.bounds:
            raise ValueError(
                "cannot merge window snapshots over different bucket grids"
            )
        return WindowSnapshot(
            bounds=self.bounds,
            counts=[a + b for a, b in zip(self.counts, other.counts)],
            sum=self.sum + other.sum,
            count=self.count + other.count,
            horizon_s=max(self.horizon_s, other.horizon_s),
        )


class _Ring:
    """Rotation bookkeeping shared by the histogram and counter rings.

    Sub-window boundaries are absolute (``clock_ns() // width``), so two
    instances on the same clock rotate in lockstep and a snapshot taken
    right after a record sees exactly the same live set."""

    def __init__(
        self,
        horizon_s: float,
        subwindows: int,
        clock_ns: Callable[[], int],
    ):
        if horizon_s <= 0:
            raise ValueError(f"window horizon must be > 0 s, got {horizon_s}")
        if subwindows < 1:
            raise ValueError(f"need at least 1 sub-window, got {subwindows}")
        self.horizon_s = float(horizon_s)
        self.subwindows = int(subwindows)
        self._width_ns = max(1, int(horizon_s * 1e9 / subwindows))
        self._clock_ns = clock_ns
        self._lock = threading.Lock()
        self._slot: Optional[int] = None  # absolute index of ring head
        self._head = 0  # ring position of the current sub-window

    def _clear_all(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def _clear_one(self, position: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def _rotate_locked(self, now_ns: Optional[int] = None) -> None:
        """Advance the ring to the sub-window containing "now", zeroing
        every sub-window that expired since the last touch. Callers
        recording into several rings off one event (the SLO tracker's
        two latency windows + budget counter) pass a shared ``now_ns``
        so the event costs ONE clock read, not one per ring."""
        slot = (
            self._clock_ns() if now_ns is None else now_ns
        ) // self._width_ns
        if self._slot is None:
            self._slot = slot
            return
        steps = slot - self._slot
        if steps <= 0:
            return
        if steps >= self.subwindows:
            self._clear_all()
            self._head = 0
        else:
            for _ in range(steps):
                self._head = (self._head + 1) % self.subwindows
                self._clear_one(self._head)
        self._slot = slot


class WindowedHistogram(_Ring):
    """Rolling bucket histogram: a ring of ``subwindows`` fixed-width
    sub-windows spanning ``horizon_s`` seconds over the bucket grid
    ``buckets`` (ascending finite bounds; +Inf is implicit).

    ``observe`` is O(1) amortized (bisect + three adds); ``snapshot`` is
    O(subwindows × buckets) — both bounded and allocation-light enough
    to sit on the request hot path (overhead guard in the test suite).
    """

    def __init__(
        self,
        buckets: Sequence[float],
        horizon_s: float = 30.0,
        subwindows: int = 6,
        clock_ns: Callable[[], int] = time.monotonic_ns,
    ):
        buckets = tuple(float(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("window buckets must strictly increase")
        super().__init__(horizon_s, subwindows, clock_ns)
        self.buckets = buckets
        n = len(buckets) + 1  # +Inf overflow slot
        self._counts = [[0] * n for _ in range(self.subwindows)]
        self._sums = [0.0] * self.subwindows
        self._totals = [0] * self.subwindows

    def _clear_all(self) -> None:
        for row in self._counts:
            for i in range(len(row)):
                row[i] = 0
        self._sums = [0.0] * self.subwindows
        self._totals = [0] * self.subwindows

    def _clear_one(self, position: int) -> None:
        row = self._counts[position]
        for i in range(len(row)):
            row[i] = 0
        self._sums[position] = 0.0
        self._totals[position] = 0

    def observe(
        self, value: float, count: int = 1, now_ns: Optional[int] = None
    ) -> None:
        """Record ``count`` observations of ``value`` into the current
        sub-window (merged batch paths book their per-request average
        with count=n, exactly like the exposition histograms)."""
        if count <= 0:
            return
        index = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._rotate_locked(now_ns)
            self._counts[self._head][index] += count
            self._sums[self._head] += value * count
            self._totals[self._head] += count

    def snapshot(self) -> WindowSnapshot:
        """The merged view over the live sub-windows (expired ones are
        rotated out first) — one consistent read under the lock."""
        with self._lock:
            self._rotate_locked()
            merged = [0] * (len(self.buckets) + 1)
            for row in self._counts:
                for i, c in enumerate(row):
                    merged[i] += c
            return WindowSnapshot(
                bounds=self.buckets,
                counts=merged,
                sum=sum(self._sums),
                count=sum(self._totals),
                horizon_s=self.horizon_s,
            )


class WindowedCounter(_Ring):
    """Rolling good/bad counters over the same sub-window ring — the SLO
    tracker's error-budget window (events in, burn rate out)."""

    def __init__(
        self,
        horizon_s: float = 300.0,
        subwindows: int = 10,
        clock_ns: Callable[[], int] = time.monotonic_ns,
    ):
        super().__init__(horizon_s, subwindows, clock_ns)
        self._good = [0] * self.subwindows
        self._bad = [0] * self.subwindows

    def _clear_all(self) -> None:
        self._good = [0] * self.subwindows
        self._bad = [0] * self.subwindows

    def _clear_one(self, position: int) -> None:
        self._good[position] = 0
        self._bad[position] = 0

    def add(
        self, good: int = 0, bad: int = 0, now_ns: Optional[int] = None
    ) -> None:
        with self._lock:
            self._rotate_locked(now_ns)
            self._good[self._head] += good
            self._bad[self._head] += bad

    def totals(self) -> Tuple[int, int]:
        """(good, bad) over the live window."""
        with self._lock:
            self._rotate_locked()
            return sum(self._good), sum(self._bad)

"""Hot-path profiling: per-stage CPU accounting + on-demand wall sampler.

The port's own copy of ``client_tpu/observability/profiling.py``, with
:func:`maybe_torch_trace` (``torch.profiler``) in place of
``maybe_jax_trace``, and :func:`execution_scope` /
:func:`transfer_scope`, which split an execution's CPU into the host's
issue (``compute``) and the transfers the port's models mark
(``device_put``, ``readback``).

The wire path serves far fewer requests per second than the in-process
path (BENCH r05: 0.349x), and wall-clock tracing alone cannot say *why*:
queue wait, GIL contention, and actual codec CPU all look like "time
passed". This module is the instrument that splits them:

:class:`StageCpuAccounting`
    Cumulative ``time.thread_time_ns`` deltas per named request stage
    (``frontend_decode``, ``queue_wait``, ``batch_assembly``,
    ``device_put``, ``compute``, ``readback``, ``package``, ``encode``,
    plus ``rpc`` for non-inference methods). Thread CPU, not wall: a
    stage that slept
    on a lock or the GIL books ~0, so the table shows where cycles go,
    not where time idles. **Default-off** — while disabled the hot paths
    take a single attribute-check branch per stage event, read no
    clocks, and book nothing. The server exports the accounting as the
    ``tpu_request_cpu_seconds{stage}`` histogram
    (:mod:`client_tpu_torch.server.metrics`), which the perf harness's
    ``--profile-server`` reduces to the "Wire-gap attribution" report.

:class:`WallProfiler`
    An on-demand sampling profiler over ``sys._current_frames()``:
    samples every thread's Python stack at ``hz`` for ``duration_s``,
    aggregates identical stacks, and exports collapsed-stack text
    (flamegraph.pl) or speedscope JSON. A measured-overhead guard times
    the first sample and lowers the effective rate so sampling never
    costs more than ``overhead_cap`` of one core. Exposed as
    ``GET /v2/debug/profile`` on the HTTP front-end and
    ``InProcessServer.profile()``; nothing runs unless requested.

:func:`maybe_torch_trace`
    ``torch.profiler`` capture of CPU and CUDA activity around a sampling
    window, written as a Chrome trace (the device timeline the Python
    sampler cannot see). A capture that fails raises.

Everything is clock-injectable — ``wall_ns``/``cpu_ns``/``sleep`` — and
``tools/clock_lint.py`` bans direct ``time.*()`` calls here (including
``thread_time_ns``), so the sampler and the accounting test on fake
clocks without sleeping.
"""

import contextlib
import functools
import itertools
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "STAGES",
    "ProfileResult",
    "StageCpuAccounting",
    "WallProfiler",
    "execution_scope",
    "maybe_torch_trace",
    "prime_device_tracing",
    "stage_scope",
    "transfer_scope",
]

# Canonical stage order (report rows print in this order). The first
# eight decompose one inference request's path through the server
# ("package" = core output packaging, which the in-process path also
# pays; "encode" = front-end wire serialization, which it does not);
# "rpc" collects non-inference methods (statistics/metadata scrapes),
# which share the serving threads and are part of the wire path's CPU
# bill. Each stage has exactly ONE booker per request, so a stage's
# cpu_sum / count is its per-request mean.
STAGES = (
    "frontend_decode",
    "queue_wait",
    "batch_assembly",
    "device_put",
    "compute",
    "readback",
    "package",
    "encode",
    "rpc",
)

# Per-request stages the in-process path never executes: their sum is
# the wire gap's directly-attributable CPU (the rest of the gap is
# syscalls/transport). "rpc" is also wire-only but books per method
# call, not per request, so reports keep it out of per-request sums.
WIRE_ONLY_STAGES = ("frontend_decode", "encode")


class StageCpuAccounting:
    """Per-stage cumulative thread-CPU (and wall) accounting.

    Hot-path contract: callers guard every bracket with ``prof.take()``,
    which while disabled (the default) costs one attribute-check branch
    per stage event — no syscalls, no locks, no bookings. ``account()``
    aggregates under one lock and forwards to ``metrics_hook`` (the
    server's ``tpu_request_cpu_seconds`` histogram) outside it.

    ``enable()`` calibrates against the host's clocks, because
    ``CLOCK_THREAD_CPUTIME_ID`` is not dependable everywhere: syscall-
    trapping sandboxes make it ~1000x the cost of the vDSO wall clock,
    and some kernels quantize it to scheduler ticks (10 ms). Two
    degradations keep the instrument usable there:

    * **wall proxy** — when the CPU clock is too expensive or too coarse,
      brackets read the injected wall clock instead (``clock_mode`` flips
      to ``"wall_proxy"``). A single-threaded stage bracket's wall time
      is its CPU plus any preemption, a documented overestimate.
    * **stride sampling** — when even the chosen clock is expensive,
      only every Nth bracket measures (``sample_stride``). Each stage's
      sum/count stays an unbiased per-request mean; the stride only
      widens the confidence interval.

    ``count`` is the number of requests a booking covers (merged batch
    paths book once per chunk), so ``cpu_ns / count`` is per-request.
    """

    __slots__ = (
        "enabled",
        "clock_mode",
        "sample_stride",
        "clock_cost_ns",
        "_tick",
        "_clock",
        "_cpu_clock_ns",
        "_wall_clock_ns",
        "_auto_calibrate",
        "_metrics_hook",
        "_lock",
        "_totals",
    )

    # calibration bounds: a CPU clock pricier than this per call, or
    # coarser than this per tick, degrades to the wall proxy; a chosen
    # clock pricier than the bracket budget gets stride-sampled
    MAX_CPU_CLOCK_COST_NS = 5_000
    MAX_CPU_CLOCK_QUANTUM_NS = 1_000_000
    BRACKET_BUDGET_NS = 2_000
    MAX_STRIDE = 64
    # sanity cap per booking: a delta larger than this is a clock-epoch
    # mix-up (e.g. a disable/enable race swapping clocks mid-bracket),
    # never a real stage — drop it rather than poison the cumulative mean
    MAX_BOOKING_NS = 600_000_000_000

    def __init__(
        self,
        metrics_hook: Optional[Callable[[str, int, int], None]] = None,
        cpu_clock_ns: Callable[[], int] = time.thread_time_ns,
        wall_clock_ns: Callable[[], int] = time.monotonic_ns,
        auto_calibrate: bool = True,
    ):
        self.enabled = False
        self.clock_mode = "thread_cpu"
        self.sample_stride = 1
        self.clock_cost_ns = 0
        self._tick = 0
        self._cpu_clock_ns = cpu_clock_ns
        self._wall_clock_ns = wall_clock_ns
        self._clock = cpu_clock_ns
        self._auto_calibrate = auto_calibrate
        self._metrics_hook = metrics_hook
        self._lock = threading.Lock()
        # stage -> [count, cpu_ns, wall_ns]
        self._totals: Dict[str, List[int]] = {}

    def enable(self) -> None:
        # idempotent: re-enabling while enabled must NOT re-calibrate —
        # calibration swaps self._clock, and an in-flight bracket that
        # read c0 on the old clock would book c1-c0 across unrelated
        # epochs (monotonic minus thread-CPU is hours of phantom CPU)
        if self.enabled:
            return
        if self._auto_calibrate:
            self._calibrate()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _calibrate(self) -> None:
        """Pick the measurement clock and stride for THIS host (see the
        class docstring); runs once per enable(), bounded ~20 ms."""
        wall = self._wall_clock_ns
        cpu = self._cpu_clock_ns
        w0 = wall()
        for _ in range(8):
            cpu()
        cpu_cost_ns = max(0, wall() - w0) // 8
        coarse = False
        if cpu_cost_ns <= self.MAX_CPU_CLOCK_COST_NS:
            # affordable clock: check its granularity (bounded spin — a
            # tick-quantized clock moves within ~2 scheduler ticks)
            q0 = cpu()
            deadline = wall() + 20_000_000
            quantum_ns = None
            while wall() < deadline:
                q1 = cpu()
                if q1 != q0:
                    quantum_ns = q1 - q0
                    break
            coarse = (
                quantum_ns is None
                or quantum_ns > self.MAX_CPU_CLOCK_QUANTUM_NS
            )
        if cpu_cost_ns > self.MAX_CPU_CLOCK_COST_NS or coarse:
            self.clock_mode = "wall_proxy"
            self._clock = wall
            w1 = wall()
            for _ in range(8):
                wall()
            clock_cost_ns = max(0, wall() - w1) // 8
        else:
            self.clock_mode = "thread_cpu"
            self._clock = cpu
            clock_cost_ns = cpu_cost_ns
        self.clock_cost_ns = clock_cost_ns
        # ~2 clock reads per bracket; keep the average bracket cost under
        # BRACKET_BUDGET_NS by measuring only every Nth occurrence
        self.sample_stride = max(
            1,
            min(self.MAX_STRIDE, round(2 * clock_cost_ns / self.BRACKET_BUDGET_NS)),
        )

    def take(self) -> bool:
        """One stage-bracket admission: True when this occurrence should
        measure. THE hot-path gate — while disabled it is a single
        attribute-check branch; enabled, a counter tick per stride."""
        if not self.enabled:
            return False
        tick = self._tick + 1
        if tick >= self.sample_stride:
            self._tick = 0
            return True
        # benign data race across threads: a lost tick skews the stride
        # by one occurrence, never corrupts a measurement
        self._tick = tick
        return False

    def cpu_now(self) -> int:
        """Current measurement-clock ns (thread CPU, or the wall proxy on
        degraded hosts). Only call behind a ``take()`` — the whole point
        of default-off is not paying this read."""
        return self._clock()

    def account(
        self, stage: str, cpu_ns: int, wall_ns: int = 0, count: int = 1
    ) -> None:
        """Book ``count`` requests' worth of one stage. No-op while
        disabled (so a race with disable() mid-request stays cheap)."""
        if not self.enabled or count <= 0:
            return
        if cpu_ns < 0:
            cpu_ns = 0  # thread clock anomaly; never book negative CPU
        elif cpu_ns > self.MAX_BOOKING_NS:
            return  # cross-epoch clock mix-up, not a real measurement
        with self._lock:
            entry = self._totals.get(stage)
            if entry is None:
                entry = self._totals[stage] = [0, 0, 0]
            entry[0] += count
            entry[1] += cpu_ns
            entry[2] += wall_ns
        if self._metrics_hook is not None:
            self._metrics_hook(stage, cpu_ns, count)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Cumulative totals: stage -> {count, cpu_ns, wall_ns}."""
        with self._lock:
            return {
                stage: {"count": e[0], "cpu_ns": e[1], "wall_ns": e[2]}
                for stage, e in self._totals.items()
            }

    def config(self) -> Dict[str, object]:
        """The debug-endpoint view: enabled + calibration outcome."""
        return {
            "stage_cpu": self.enabled,
            "clock": self.clock_mode,
            "sample_stride": self.sample_stride,
            "clock_cost_ns": self.clock_cost_ns,
        }


@contextlib.contextmanager
def stage_scope(accounting: Optional[StageCpuAccounting], stage: str):
    """Bracket a code region as one stage booking (public hook — models
    that do their own explicit host->device transfers wrap them in
    ``stage_scope(core.profiling, "device_put")``)."""
    if accounting is None or not accounting.take():
        yield
        return
    c0 = accounting.cpu_now()
    try:
        yield
    finally:
        accounting.account(stage, accounting.cpu_now() - c0)


_EXECUTION = threading.local()


@contextlib.contextmanager
def execution_scope(accounting: StageCpuAccounting, count: int = 1):
    """Bracket one model execution and its read back to the host, on its
    executor thread. The transfers marked inside by
    :func:`transfer_scope` book as their stages (``readback`` always,
    ``device_put`` when a model marks its host-to-device copy), the rest
    as ``compute``: the host's issue of the model's work. Only call
    behind a ``take()``."""
    _EXECUTION.accounting = accounting
    _EXECUTION.stages = {"readback": 0}
    c0 = accounting.cpu_now()
    try:
        yield
    finally:
        _EXECUTION.accounting = None
    spent = accounting.cpu_now() - c0
    stages = _EXECUTION.stages
    accounting.account("compute", spent - sum(stages.values()), count=count)
    for stage, ns in stages.items():
        accounting.account(stage, ns, count=count)


@contextlib.contextmanager
def transfer_scope(stage: str):
    """Mark a host-device transfer of a model execution, ``device_put``
    (host to device) or ``readback`` (device to host, which waits for the
    device's work): inside a measured :func:`execution_scope` its CPU
    books as ``stage`` instead of ``compute``; elsewhere it costs one
    thread-local read."""
    accounting = getattr(_EXECUTION, "accounting", None)
    if accounting is None:
        yield
        return
    c0 = accounting.cpu_now()
    try:
        yield
    finally:
        stages = _EXECUTION.stages
        stages[stage] = stages.get(stage, 0) + accounting.cpu_now() - c0


# -- sampling profiler --------------------------------------------------------


@dataclass
class ProfileResult:
    """One sampling run's aggregate: unique stacks -> sample counts.

    Stacks are root->leaf frame-label tuples, prefixed with the thread
    name, exactly as the collapsed exporter prints them.
    """

    duration_s: float = 0.0
    hz_requested: float = 0.0
    hz_effective: float = 0.0
    sample_count: int = 0
    sample_cost_ns: int = 0
    stacks: Dict[Tuple[str, ...], int] = field(default_factory=dict)

    # -- exporters ----------------------------------------------------------

    def collapsed(self) -> str:
        """flamegraph.pl collapsed-stack format: ``f1;f2;f3 count``."""
        lines = [
            ";".join(stack) + f" {count}"
            for stack, count in sorted(self.stacks.items())
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def speedscope(self, name: str = "client-tpu-server") -> Dict:
        """The speedscope.app JSON document (type "sampled"); weights are
        seconds per sample at the effective rate."""
        frame_index: Dict[str, int] = {}
        frames: List[Dict[str, str]] = []
        samples: List[List[int]] = []
        weights: List[float] = []
        period_s = 1.0 / self.hz_effective if self.hz_effective > 0 else 0.0
        for stack, count in sorted(self.stacks.items()):
            indices = []
            for label in stack:
                index = frame_index.get(label)
                if index is None:
                    index = frame_index[label] = len(frames)
                    frames.append({"name": label})
                indices.append(index)
            samples.append(indices)
            weights.append(count * period_s)
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": [
                {
                    "type": "sampled",
                    "name": name,
                    "unit": "seconds",
                    "startValue": 0.0,
                    "endValue": total,
                    "samples": samples,
                    "weights": weights,
                }
            ],
            "name": name,
            "activeProfileIndex": 0,
            "exporter": "client-tpu-profiler",
        }


def _frame_label(frame) -> str:
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class WallProfiler:
    """Wall-clock stack sampler over ``sys._current_frames()``.

    One :meth:`run` samples every OTHER thread's Python stack at ``hz``
    for ``duration_s``. The measured-overhead guard times the first
    sample pass and widens the interval so sampling never exceeds
    ``overhead_cap`` of one core's time — a pathological process (many
    threads, deep stacks) degrades to a slower profile, never to a
    profiler-induced outage. All time sources are injectable (tests run
    on fake clocks; no direct ``time.*()`` calls — clock_lint enforced).
    """

    def __init__(
        self,
        hz: float = 99.0,
        max_depth: int = 64,
        overhead_cap: float = 0.1,
        clock_ns: Callable[[], int] = time.monotonic_ns,
        sleep: Callable[[float], None] = time.sleep,
        frames: Callable[[], Dict] = sys._current_frames,
    ):
        if hz <= 0:
            raise ValueError(f"hz must be > 0, got {hz}")
        if not 0 < overhead_cap <= 1:
            raise ValueError(f"overhead_cap must be in (0, 1], got {overhead_cap}")
        self.hz = float(hz)
        self.max_depth = max_depth
        self.overhead_cap = overhead_cap
        self._clock_ns = clock_ns
        self._sleep = sleep
        self._frames = frames

    def _thread_names(self) -> Dict[int, str]:
        return {
            t.ident: t.name for t in threading.enumerate() if t.ident is not None
        }

    def _sample(self, result: ProfileResult, skip_ident: int) -> None:
        names = self._thread_names()
        for ident, frame in self._frames().items():
            if ident == skip_ident:
                continue
            stack: List[str] = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                stack.append(_frame_label(frame))
                frame = frame.f_back
                depth += 1
            stack.append(names.get(ident, f"thread-{ident}"))
            key = tuple(reversed(stack))  # root -> leaf, thread name first
            result.stacks[key] = result.stacks.get(key, 0) + 1
        result.sample_count += 1

    def run(self, duration_s: float) -> ProfileResult:
        """Sample for ``duration_s`` seconds; returns the aggregate."""
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        own = threading.get_ident()
        result = ProfileResult(duration_s=duration_s, hz_requested=self.hz)
        interval_ns = int(1e9 / self.hz)
        # Overhead guard: EVERY sample is timed and the interval widens
        # so (worst sample cost / interval) stays under overhead_cap.
        # The first sample alone is not enough — it can land while the
        # process has few/shallow threads, and a later, pricier sample
        # (load arrived, stacks deepened) must not turn the loop into a
        # back-to-back busy spin.
        start_ns = self._clock_ns()
        self._sample(result, own)
        now_ns = self._clock_ns()
        result.sample_cost_ns = max(0, now_ns - start_ns)
        interval_ns = max(
            interval_ns, int(result.sample_cost_ns / self.overhead_cap), 1
        )
        result.hz_effective = 1e9 / interval_ns
        deadline_ns = start_ns + int(duration_s * 1e9)
        next_ns = start_ns + interval_ns
        while now_ns < deadline_ns:
            if next_ns > now_ns:
                self._sleep((next_ns - now_ns) / 1e9)
            sample_start_ns = self._clock_ns()
            self._sample(result, own)
            now_ns = self._clock_ns()
            cost_ns = max(0, now_ns - sample_start_ns)
            if cost_ns > result.sample_cost_ns:
                result.sample_cost_ns = cost_ns
                floor_ns = int(cost_ns / self.overhead_cap)
                if floor_ns > interval_ns:
                    interval_ns = floor_ns
                    result.hz_effective = 1e9 / interval_ns
            # never schedule the next sample closer than the idle gap
            # the cap demands (interval >= cost/cap >= cost, so the gap
            # is non-negative) — a lagging next_ns must not busy-loop
            next_ns = max(
                next_ns + interval_ns, now_ns + (interval_ns - cost_ns)
            )
        return result


_TRACE_SEQ = itertools.count()


@functools.cache
def prime_device_tracing() -> None:
    """Start and stop ``torch.profiler``'s CUDA tracing once, on the
    calling thread. Its CUDA tracing initialises on first use and must do
    so on the thread that set CUDA up (on a card, a first capture from
    another thread logs "External init callback must run in same thread
    as registerClient" and records no kernel); once initialised, captures
    from any thread record the card's kernels. A server calls this where
    it is built, before its executor threads run a capture; once a
    process is enough."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


@contextlib.contextmanager
def maybe_torch_trace(log_dir: Optional[str]):
    """``torch.profiler`` around a sampling window when ``log_dir`` is set.

    The wall sampler sees Python frames only; the card's kernels run
    behind them. Passing ``jax_trace_dir`` to the profile endpoint (the
    JAX package's query name, kept so both harnesses drive it) records
    CPU and, with a card, CUDA activity of the whole process, and writes
    it to ``log_dir`` as a Chrome trace (``trace_<pid>_<n>.json``; the
    yielded dict carries its ``path`` once the window closes).
    ``torch.profiler`` is always present, so nothing is skipped: a
    capture that fails raises.
    """
    if not log_dir:
        yield {}
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    result: Dict[str, str] = {}
    with profile(activities=activities) as prof:
        yield result
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
    prof.export_chrome_trace(path)
    result["path"] = path

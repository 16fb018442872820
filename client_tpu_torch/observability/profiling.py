"""Hot-path profiling: the per-stage ledger, per-stage CPU accounting and
an on-demand wall sampler.

The port's own copy of ``client_tpu/observability/profiling.py``, with
:func:`maybe_torch_trace` (``torch.profiler``) in place of
``maybe_jax_trace``, and :func:`execution_scope` /
:func:`transfer_scope`, which split an execution into the host's issue
(``compute``) and the transfers the port's models mark (``device_put``,
``readback``).

**The stage ledger, always on.** Every stage bracket reads the wall
clock on entry and exit whether or not the CPU accounting is on, and the
server books the wall ns into the model's statistics (``stage_stats`` of
``GET /v2/models/<name>/stats``, ``{stage: {count, ns}}``). Beside the
CPU stages it books ``handoff`` (wall only: the hop to the executor
thread and back, which no thread's CPU spends) and, for models on a
card, two stages on the device's own clock (:class:`DeviceClock`):
``device``, the forward's span between two CUDA events, and
``device_gap``, the device's idle time from one execution's forward to
the next. While a ``torch.profiler`` capture records, each bracket also
opens a range named after its stage (:func:`stage_range`), so the
capture's trace shows the host's stages on the kernels' timeline; with
no capture no range is entered.

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
    sampler cannot see). A capture that fails, or that recorded kernel
    launches and no kernel, raises; a CUDA capture under load can kill
    the process inside CUPTI (see the function).

Everything is clock-injectable — ``wall_ns``/``cpu_ns``/``sleep`` — and
``tools/clock_lint.py`` bans direct ``time.*()`` calls here (including
``thread_time_ns``), so the sampler and the accounting test on fake
clocks without sleeping.
"""

import contextlib
import functools
import itertools
import os
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = [
    "STAGES",
    "DeviceClock",
    "ProfileResult",
    "StageCpuAccounting",
    "WallProfiler",
    "execution_scope",
    "maybe_torch_trace",
    "prime_device_tracing",
    "stage_range",
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

    def wall_now(self) -> int:
        """Current wall-clock ns: the stage ledger's clock, read at every
        bracket whether or not the CPU accounting is on."""
        return self._wall_clock_ns()

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


_NO_RANGE = contextlib.nullcontext()


def stage_range(name: str):
    """A ``torch.profiler`` range named ``name`` while a capture records,
    else a shared no-op context. The check reads torch's process-wide
    flag (a capture of every thread, as :func:`maybe_torch_trace` takes,
    sets no thread's own flag) and the calling thread's; it costs a
    fraction of a microsecond, where entering a range with no capture
    running costs about 12 µs."""
    if _autograd_profiler._is_profiler_enabled or _profiler_enabled():
        return record_function(name)
    return _NO_RANGE


class DeviceClock:
    """One model's executions timed on the device's own clock.

    Each execution takes a pair of events (``new_event()``, by default
    ``torch.cuda.Event(enable_timing=True)``) and the model's current
    stream (``current_stream()``). :func:`execution_scope` records the
    first where the forward starts — when the model's ``device_put`` mark
    closes, or at the execution's start for a model that marks none —
    and the second when its first ``readback`` mark opens. Both are read
    after the execution's one device-to-host read, which has waited for
    them; an event not yet complete is never waited on, and that
    execution books no device time. Pairs are reused, one set per model.
    On the serial path (the dynamic batcher, one execution of the model
    at a time) the last pair is kept, so the next execution reads the
    device's idle time between the two forwards (``device_gap``) on the
    same stream."""

    def __init__(self, new_event: Callable[[], Any], current_stream: Callable[[], Any]):
        self._new_event = new_event
        self._current_stream = current_stream
        self._lock = threading.Lock()
        self._idle: List[Tuple[Any, Any]] = []
        # (events, stream) of the serial path's last timed execution
        self._last: Optional[Tuple[Tuple[Any, Any], Any]] = None
        # whether the model marks its host-to-device copy: then the first
        # event waits for that mark's close
        self.marks_put = False

    @classmethod
    def cuda(cls, device) -> "DeviceClock":
        """A clock on ``device``'s current CUDA stream."""
        return cls(functools.partial(torch.cuda.Event, enable_timing=True),
                   functools.partial(torch.cuda.current_stream, device))

    def begin(self) -> Tuple[Tuple[Any, Any], Any]:
        """An idle event pair (a new one when none is idle) and the stream
        this execution runs on."""
        with self._lock:
            events = self._idle.pop() if self._idle else None
        if events is None:
            events = (self._new_event(), self._new_event())
        return events, self._current_stream()

    def release(self, events: Tuple[Any, Any]) -> None:
        """Return a pair whose execution books no device time."""
        with self._lock:
            self._idle.append(events)

    def finish(self, events: Tuple[Any, Any], stream, serial: bool
               ) -> Tuple[Optional[int], Optional[int]]:
        """(device ns, gap ns) of an execution whose both events were
        recorded; either is None where it cannot be read."""
        start, end = events
        device_ns = round(start.elapsed_time(end) * 1e6) if end.query() else None
        gap_ns = None
        with self._lock:
            if not serial:
                self._idle.append(events)
                return device_ns, None
            last, self._last = self._last, None
            if last is not None:
                if device_ns is not None and last[1] == stream:
                    gap_ns = round(last[0][1].elapsed_time(start) * 1e6)
                self._idle.append(last[0])
            if device_ns is None:
                self._idle.append(events)
            else:
                self._last = (events, stream)
        return device_ns, gap_ns


class _Execution:
    """One execution's marks, on its executor thread; what
    :func:`execution_scope` yields, with its ledger once it ends."""

    __slots__ = ("accounting", "measured", "clock", "events", "stream", "started",
                 "ended", "wall", "cpu", "stages")

    def __init__(self, accounting: StageCpuAccounting, measured: bool,
                 clock: Optional[DeviceClock]):
        self.accounting = accounting
        self.measured = measured
        self.clock = clock
        self.events = self.stream = None
        self.started = self.ended = False
        # stage -> wall ns (and CPU ns when measured) of the marks inside
        self.wall: Dict[str, int] = {}
        self.cpu: Dict[str, int] = {"readback": 0}
        # the execution's wall ns by stage, device time included, once it ends
        self.stages: Dict[str, int] = {}

    def record_start(self) -> None:
        self.events[0].record(self.stream)
        self.started = True

    def record_end(self) -> None:
        self.events[1].record(self.stream)
        self.ended = True


_EXECUTION = threading.local()


@contextlib.contextmanager
def execution_scope(accounting: StageCpuAccounting, count: int = 1, measured: bool = False,
                    clock: Optional[DeviceClock] = None, serial: bool = False):
    """Bracket one model execution and its read back to the host, on its
    executor thread, always. Yields the execution; once the block ends
    without raising, its ``stages`` hold the wall ns of the transfers
    marked inside by :func:`transfer_scope` under their stages
    (``readback`` always, ``device_put`` when a model marks its
    host-to-device copy), the rest as ``compute`` (the host's issue of
    the model's work), and, with a :class:`DeviceClock`, ``device`` and
    (``serial``) ``device_gap``. When ``measured`` (behind a ``take()``)
    the same split of the thread's CPU is booked into ``accounting``,
    ``count`` requests' worth. While a capture records, the execution is
    a range named ``execution`` and each mark one named after its
    stage."""
    execution = _Execution(accounting, measured, clock)
    if clock is not None:
        execution.events, execution.stream = clock.begin()
        if not clock.marks_put:
            execution.record_start()
    outer = getattr(_EXECUTION, "current", None)
    _EXECUTION.current = execution
    try:
        with stage_range("execution"):
            c0 = accounting.cpu_now() if measured else 0
            w0 = accounting.wall_now()
            yield execution
            wall = accounting.wall_now() - w0
            spent = accounting.cpu_now() - c0 if measured else 0
    except BaseException:
        if clock is not None:
            clock.release(execution.events)
        raise
    finally:
        _EXECUTION.current = outer
    stages = execution.stages
    stages.update(execution.wall)
    stages["compute"] = max(0, wall - sum(execution.wall.values()))
    if measured:
        cpu = execution.cpu
        accounting.account("compute", spent - sum(cpu.values()), count=count)
        for stage, ns in cpu.items():
            accounting.account(stage, ns, count=count)
    if clock is not None:
        if execution.started and execution.ended:
            device_ns, gap_ns = clock.finish(execution.events, execution.stream, serial)
            if device_ns is not None:
                stages["device"] = device_ns
            if gap_ns is not None:
                stages["device_gap"] = gap_ns
        else:
            clock.release(execution.events)


@contextlib.contextmanager
def transfer_scope(stage: str):
    """Mark a host-device transfer of a model execution, ``device_put``
    (host to device) or ``readback`` (device to host, which waits for the
    device's work): inside an :func:`execution_scope` its wall time (and,
    measured, its CPU) books as ``stage`` instead of ``compute``, and its
    edge times the forward on the device's clock (the first event when a
    ``device_put`` closes, the second when the first ``readback`` opens);
    elsewhere it costs one thread-local read."""
    execution = getattr(_EXECUTION, "current", None)
    if execution is None:
        yield
        return
    accounting = execution.accounting
    if stage == "readback" and execution.clock is not None and not execution.ended:
        execution.record_end()
    with stage_range(stage):
        c0 = accounting.cpu_now() if execution.measured else 0
        w0 = accounting.wall_now()
        try:
            yield
        finally:
            wall = execution.wall
            wall[stage] = wall.get(stage, 0) + accounting.wall_now() - w0
            if execution.measured:
                cpu = execution.cpu
                cpu[stage] = cpu.get(stage, 0) + accounting.cpu_now() - c0
    if stage == "device_put" and execution.clock is not None:
        execution.clock.marks_put = True
        execution.record_start()


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
    process is enough. Where the priming runs does not bear on the crash
    :func:`maybe_torch_trace` describes: priming on a thread of the
    server's own changed nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


_KERNEL_LAUNCH = re.compile(r"cu(da)?Launch\w*Kernel")


def require_kernel_records(events) -> None:
    """Raise unless a CUDA capture's ``events`` (Kineto's, each with
    ``name()`` and ``device_type()``) that hold kernel launches on the
    host also hold activity on the card. Under load CUPTI sometimes
    delivers no device record for a whole window while the runtime's
    launches are all there."""
    from torch.autograd import DeviceType

    launches = on_card = 0
    for event in events:
        if event.device_type() == DeviceType.CUDA:
            on_card += 1
        elif _KERNEL_LAUNCH.match(event.name()):
            launches += 1
    if launches and not on_card:
        raise RuntimeError(f"the CUDA capture recorded {launches} kernel launches and no "
                           "activity on the card")


def _all_threads():
    """Kineto's experimental setting that records every thread, or None
    on a torch that lacks it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def maybe_torch_trace(log_dir: Optional[str]):
    """``torch.profiler`` around a sampling window when ``log_dir`` is set.

    The wall sampler sees Python frames only; the card's kernels run
    behind them. Passing ``jax_trace_dir`` to the profile endpoint (the
    JAX package's query name, kept so both harnesses drive it) records
    CPU and, with a card, CUDA activity of the whole process, and writes
    it to ``log_dir`` as a Chrome trace (``trace_<pid>_<n>.json``; the
    yielded dict carries its ``path`` once the window closes). The
    capture records every thread's operators and ranges (Kineto's
    ``profile_all_threads``; a capture otherwise sees only the thread that
    starts it), so the serving threads' stage ranges (:func:`stage_range`)
    lie on the kernels' timeline. A torch without that setting records
    the calling thread alone.
    ``torch.profiler`` is always present, so nothing is skipped: a
    capture that fails raises.

    With a card, a capture whose host side recorded kernel launches but
    whose CUPTI records hold no activity on the card raises as well: that
    trace would miss what it was taken for.

    A known fault inside CUPTI: on an H100 serving ResNet-50 (its
    kernels from cuDNN) under load, a CUDA capture kills the process in
    about one 2 s window in eleven. CUPTI's own worker thread frees
    corrupt memory inside ``libcupti`` ("double free or corruption",
    "free(): invalid pointer", SIGSEGV) while the window is open. It does
    so with torch 2.11's CUPTI 12.8 and CUDA 12.9's alike, with or
    without a server around the model, and under every setting torch and
    Kineto expose (CUDA activity alone, teardown and lazy
    re-initialisation off, per-thread activity buffers, no external
    correlation, other device buffer sizes, one owner thread for every
    start and stop). A CPU-only capture never crashed. Streams without
    cuDNN's kernels crashed in none of the few windows that recorded
    kernels, too few to clear them; most of their windows recorded
    launches and no kernel, which the check above refuses.
    ``profile_sweep.py`` reruns the control; PERF.md holds the sweep.
    """
    if not log_dir:
        yield {}
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    result: Dict[str, str] = {}
    with profile(activities=activities, experimental_config=_all_threads()) as prof:
        yield result
    if ProfilerActivity.CUDA in activities:
        require_kernel_records(prof.profiler.kineto_results.events())
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
    prof.export_chrome_trace(path)
    result["path"] = path

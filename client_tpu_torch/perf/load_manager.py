"""Async load managers: concurrency, request-rate, custom-interval, periodic.

The port's own copy of ``client_tpu/perf/load_manager.py``. The asyncio
re-expression of the reference's manager/worker hierarchy
(reference load_manager.h:48-180, concurrency_manager.h, request_rate_
manager.h, custom_load_manager.h, periodic_concurrency_manager.h). One loop
drives all in-flight requests; workers are tasks, not threads.
"""

import asyncio
import itertools
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from client_tpu_torch import resilience
from client_tpu_torch.observability import trace as observability
from client_tpu_torch.perf.backend import PerfBackend
from client_tpu_torch.perf.data import DataLoader
from client_tpu_torch.perf.records import RequestRecord
from client_tpu_torch.perf.sequence import SequenceManager
from client_tpu_torch.utils import InferenceServerException


class LoadManager:
    """Base: owns the backend, data loader, and the shared record list.

    Failures are data, not fatal: each error lands in its
    ``RequestRecord`` and the run continues. ``max_error_rate`` (a
    fraction; None disables the check) turns sustained failure into a
    ``check_health()`` abort once at least ``min_error_sample`` requests
    have been issued — the error-tolerant replacement for first-error
    aborts, sized so a couple of transient faults can't kill a run.
    """

    def __init__(
        self,
        backend: PerfBackend,
        model_name: str,
        data_loader: DataLoader,
        model_version: str = "",
        streaming: bool = False,
        sequence_manager: Optional[SequenceManager] = None,
        parameters: Optional[Dict] = None,
        max_error_rate: Optional[float] = None,
        min_error_sample: int = 20,
        priorities: Optional[Sequence[int]] = None,
        queue_timeout_us: Optional[int] = None,
    ):
        self.backend = backend
        self.model_name = model_name
        self.model_version = model_version
        self.data_loader = data_loader
        self.streaming = streaming
        self.sequences = sequence_manager
        self.parameters = parameters
        self.max_error_rate = max_error_rate
        self.min_error_sample = min_error_sample
        # Overload mode: scheduling parameters stamped on every request.
        # A list of priorities is cycled across requests (a mixed
        # "1,2" run produces the report's per-priority latency split).
        self.priorities = list(priorities) if priorities else []
        self.queue_timeout_us = queue_timeout_us
        # cumulative across swap_records() windows
        self.issued_total = 0
        self.errors_total = 0
        self.retries_total = 0
        self.records: List[RequestRecord] = []
        self._request_counter = itertools.count()
        self._tasks: List[asyncio.Task] = []
        self._stopping = False
        # Prepared-request reuse (C++ twin: IssueOne's cache tokens):
        # non-sequence unary requests are deterministic per corpus
        # coordinate, so capable backends resend a previously built wire
        # request. CTPU_PERF_NO_PREPARED_CACHE=1 forces per-send builds
        # for A/B runs.
        self._prepared_enabled = (
            backend.supports_prepared
            and sequence_manager is None
            and os.environ.get("CTPU_PERF_NO_PREPARED_CACHE") != "1"
        )

    # -- issuing -------------------------------------------------------------

    async def issue_one(
        self, stream: int = 0, step: int = 0, slot: Optional[int] = None
    ) -> RequestRecord:
        """Send one request (or one sequence step) and record its timing.

        ``slot`` identifies the issuing worker for sequence bookkeeping —
        each slot owns at most one active sequence at a time (two workers
        must never interleave steps of one sequence id).
        """
        request_index = next(self._request_counter)
        request_id = str(request_index)
        seq_kwargs = {}
        if self.sequences is not None:
            seq_kwargs = self.sequences.next_step(
                slot if slot is not None else stream
            )
        priority = (
            self.priorities[request_index % len(self.priorities)]
            if self.priorities
            else 0
        )
        sched_kwargs = {}
        if priority:
            sched_kwargs["priority"] = priority
        if self.queue_timeout_us:
            sched_kwargs["timeout_us"] = self.queue_timeout_us
        cache_token = None
        if self._prepared_enabled and not self.streaming:
            cache_token = self.data_loader.cache_token(stream, step)
            if cache_token is not None and sched_kwargs:
                # scheduling params are baked into a prepared wire
                # request — a mixed-priority run must not reuse one
                # priority's body for another's
                cache_token = (
                    cache_token,
                    priority,
                    self.queue_timeout_us,
                )
        if cache_token is not None and self.backend.has_prepared(cache_token):
            # Prepared hit: the backend resends its stored wire request —
            # skip input/parameter preparation entirely (C++ twin:
            # IssueOne's cache-hit path).
            inputs = ()
            parameters = None
        else:
            inputs = self.data_loader.get_inputs(stream, step)
            parameters = self.parameters
            step_params = self.data_loader.get_parameters(stream, step)
            if step_params:
                parameters = {**(parameters or {}), **step_params}
        record = RequestRecord(start_ns=time.monotonic_ns(), request_id=request_id)
        resilience.reset_retry_count()
        observability.reset_last_stages()
        try:
            if self.streaming and self.backend.supports_streaming:
                def on_response():
                    record.response_ns.append(time.monotonic_ns())

                await self.backend.stream_infer(
                    self.model_name,
                    inputs,
                    on_response,
                    model_version=self.model_version,
                    request_id=request_id,
                    parameters=parameters,
                    **seq_kwargs,
                )
            else:
                extra = (
                    {"cache_token": cache_token}
                    if cache_token is not None
                    else {}
                )
                await self.backend.infer(
                    self.model_name,
                    inputs,
                    model_version=self.model_version,
                    request_id=request_id,
                    parameters=parameters,
                    **seq_kwargs,
                    **sched_kwargs,
                    **extra,
                )
                record.response_ns.append(time.monotonic_ns())
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - failures are data
            record.success = False
            record.error = str(e)
            if isinstance(e, InferenceServerException):
                # status token (e.g. "429", "StatusCode.RESOURCE_EXHAUSTED")
                # lets the reducer classify sheds vs deadline errors
                record.error_status = e.status()
        record.end_ns = time.monotonic_ns()
        # transparent retries the resilience layer performed for this call
        # (contextvar updates within one task persist across awaits)
        record.retries = resilience.last_retry_count()
        # client-side stage durations from the tracer, when the backend
        # has one configured (same contextvar idiom as the retry count)
        record.stages = observability.last_stages()
        record.priority = priority
        record.sequence_id = seq_kwargs.get("sequence_id", 0)
        record.ctx_id = slot if slot is not None else 0
        self.issued_total += 1
        self.retries_total += record.retries
        if not record.success:
            self.errors_total += 1
        self.records.append(record)
        return record

    def swap_records(self) -> List[RequestRecord]:
        """Hand the accumulated records to the profiler (reference
        SwapRequestRecords)."""
        records, self.records = self.records, []
        return records

    def record_count(self) -> int:
        """Records accumulated since the last swap (count-bounded
        measurement windows poll this)."""
        return len(self.records)

    def check_health(self) -> None:
        """Raise if any worker task died unexpectedly (reference
        CheckHealth), or if the cumulative error rate crossed
        ``max_error_rate`` — individual failures are tolerated and
        recorded, only sustained failure aborts the run."""
        for task in self._tasks:
            if task.done() and not task.cancelled():
                exc = task.exception()
                if exc is not None:
                    raise exc
        if (
            self.max_error_rate is not None
            and self.issued_total > 0
            and self.issued_total >= self.min_error_sample
        ):
            rate = self.errors_total / self.issued_total
            if rate > self.max_error_rate:
                raise InferenceServerException(
                    f"error rate {rate:.1%} exceeds the configured "
                    f"threshold {self.max_error_rate:.1%} "
                    f"({self.errors_total}/{self.issued_total} requests "
                    "failed)"
                )

    async def stop(self) -> None:
        self._stopping = True
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()


class RollingRestartDriver:
    """The ``--rolling-restart`` chaos scenario: while a measurement runs,
    periodically drain-and-restart the serving side by cycling the
    model's ``unload`` -> ``load`` through the repository-control API
    (the in-process stand-in for instance restarts — the server marks
    the model unavailable, drains its queued/in-flight work, then the
    load swaps a fresh model in atomically).

    The run's records then answer the acceptance question with data:
    dropped requests land as errors with 503/UNAVAILABLE status tokens
    (``PerfStatus.unavailable_count``), rerouted ones as successes with
    ``retries > 0`` (``PerfStatus.rerouted_count``).
    """

    def __init__(
        self,
        backend: PerfBackend,
        model_name: str,
        period_s: float,
        settle_s: float = 0.2,
    ):
        self.backend = backend
        self.model_name = model_name
        self.period_s = period_s
        self.settle_s = settle_s
        self.cycles = 0
        self.errors: List[str] = []
        self._task: Optional[asyncio.Task] = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.period_s)
            try:
                await self.backend.unload_model(self.model_name)
                # the unavailability window clients must ride through
                await asyncio.sleep(self.settle_s)
                await self.backend.load_model(self.model_name)
                self.cycles += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - chaos must not kill the run
                if len(self.errors) < 8:
                    self.errors.append(str(e))

    async def stop(self) -> None:
        """Cancel the cycle and make sure the model ends up loaded.
        Idempotent — a second call (the CLI's finally) is a no-op, not
        another server-side reload."""
        if self._stopped:
            return
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        try:
            await self.backend.load_model(self.model_name)
        except Exception as e:  # noqa: BLE001 - surface, don't raise
            if len(self.errors) < 8:
                self.errors.append(f"final load: {e}")


class ConcurrencyManager(LoadManager):
    """Maintains N outstanding requests (closed loop).

    Reference semantics: ConcurrencyManager/ConcurrencyWorker — send until
    the concurrency budget is full, re-issue as responses return
    (reference concurrency_worker.h:99-127).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._concurrency = 0
        self._worker_seq = itertools.count()

    @property
    def concurrency(self) -> int:
        return self._concurrency

    async def change_concurrency(self, concurrency: int) -> None:
        """Grow/shrink the worker pool (reference ChangeConcurrencyLevel)."""
        self._concurrency = concurrency
        while len(self._tasks) < concurrency:
            worker_id = next(self._worker_seq)
            self._tasks.append(
                asyncio.ensure_future(self._worker(worker_id))
            )
        while len(self._tasks) > concurrency:
            task = self._tasks.pop()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    async def _worker(self, worker_id: int) -> None:
        step = 0
        stream = worker_id % max(1, self.data_loader.stream_count or 1)
        while not self._stopping:
            await self.issue_one(stream, step, slot=worker_id)
            step += 1


class RequestRateManager(LoadManager):
    """Open-loop fixed-rate load (constant or Poisson schedule).

    Requests fire at schedule instants regardless of completions
    (reference request_rate_manager.h:105-136). Late dispatches accumulate
    in ``schedule_slip_ns``. The schedule reads ``self.clock`` and waits
    with ``self.sleep`` (``time.monotonic`` and ``asyncio.sleep``), which
    a test may replace with a simulated clock.
    """

    def __init__(
        self,
        *args,
        distribution: str = "constant",
        seed: int = 0,
        num_sequence_slots: int = 4,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.distribution = distribution
        self._rng = np.random.default_rng(seed)
        # Context selection gets its OWN stream: sharing the schedule rng
        # would correlate Poisson intervals with ctx draws (the exact
        # coupling random selection exists to remove).
        self._ctx_rng = np.random.default_rng(seed ^ 0x9E3779B97F4A7C15)
        self._dispatcher: Optional[asyncio.Task] = None
        self._inflight: set = set()
        self.schedule_slip_ns = 0
        # open-loop mode has no workers; sequence ownership cycles over
        # this many slots (reference --num-of-sequences)
        self.num_sequence_slots = max(1, num_sequence_slots)
        self.clock = time.monotonic
        self.sleep = asyncio.sleep

    def _intervals(self, rate: float):
        if self.distribution == "constant":
            while True:
                yield 1.0 / rate
        elif self.distribution == "poisson":
            while True:
                yield float(self._rng.exponential(1.0 / rate))
        else:
            raise ValueError(
                f"unknown schedule distribution '{self.distribution}'"
            )

    async def change_rate(self, rate: float) -> None:
        """Replace the dispatch schedule (reference ChangeRequestRate)."""
        await self.stop_dispatch()
        self._stopping = False
        self._dispatcher = asyncio.ensure_future(
            self._dispatch(self._intervals(rate))
        )
        self._tasks = [self._dispatcher]

    async def start_custom_intervals(self, intervals_s: Sequence[float]) -> None:
        """Replay a fixed interval list, cycling (reference
        CustomLoadManager)."""
        await self.stop_dispatch()
        self._stopping = False
        self._dispatcher = asyncio.ensure_future(
            self._dispatch(itertools.cycle(intervals_s))
        )
        self._tasks = [self._dispatcher]

    async def _dispatch(self, intervals) -> None:
        next_fire = self.clock()
        stream = 0
        step = 0
        slot = 0
        n_streams = max(1, self.data_loader.stream_count or 1)
        for interval in intervals:
            if self._stopping:
                break
            now = self.clock()
            delay = next_fire - now
            if delay > 0:
                await self.sleep(delay)
            else:
                self.schedule_slip_ns += int(-delay * 1e9)
            if self.sequences is None:
                # Non-sequence rate mode: the context id attributed to
                # each dispatch is drawn uniformly at random (reference
                # rand_ctx_id_tracker.h:28-48 via CtxIdTrackerFactory) —
                # round-robin would correlate context reuse with the
                # schedule. This harness's open-loop contexts are virtual
                # (asyncio tasks), so the id's observable effect is the
                # per-request ctx_id attribution in the records.
                slot = int(self._ctx_rng.integers(self.num_sequence_slots))
            task = asyncio.ensure_future(self.issue_one(stream, step, slot=slot))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
            step += 1
            if self.sequences is not None:
                # round-robin sequence ownership over the configured slots;
                # rotate input stream when a slot finishes its sequence
                if self.sequences.rotate_stream(slot):
                    stream = (stream + 1) % n_streams
                slot = (slot + 1) % self.num_sequence_slots
            next_fire += interval

    async def stop_dispatch(self) -> None:
        self._stopping = True
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._dispatcher = None
        # let in-flight requests drain briefly
        if self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
        self._tasks = []

    async def stop(self) -> None:
        await self.stop_dispatch()


class PeriodicConcurrencyManager(ConcurrencyManager):
    """Ramp concurrency start->end by step every ``request_period`` requests
    (reference periodic_concurrency_manager.h; the LLM profiling mode)."""

    def __init__(
        self,
        *args,
        start: int = 1,
        end: int = 1,
        step: int = 1,
        request_period: int = 10,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self._range = (start, end, step)
        self._request_period = request_period
        self._ramp_task: Optional[asyncio.Task] = None

    async def run(self) -> None:
        """Run the full ramp; returns when the end concurrency's period
        completes."""
        start, end, step = self._range
        await self.change_concurrency(start)
        current = start
        while True:
            target = len(self.records) + self._request_period
            while len(self.records) < target:
                await asyncio.sleep(0.005)
                self.check_health()
            if current >= end:
                break
            current = min(end, current + step)
            await self.change_concurrency(current)
        await self.stop()

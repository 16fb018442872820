"""Protocol-independent server engine.

A front-end reduces a request to :class:`CoreRequest` (name->ndarray
inputs, requested outputs and parameters), hands it to
:meth:`ServerCore.infer` (one response) or
:meth:`ServerCore.infer_decoupled` (a stream), and serializes the
:class:`CoreResponse` objects back onto its wire.

Batchable models (``max_batch_size > 1``) run behind a per-model dynamic
batcher: concurrent requests with the same input signature share one
``Model.execute``, ragged dims padded to a shared bucket where the model
allows it. Each execution runs on the core's executor threads, and its
torch outputs come back to the host in one device-to-host read — the
execution's one synchronisation with the device. Statistics are kept the
way Triton's statistics extension reports them (success, fail, queue,
compute_input, compute_infer, compute_output: cumulative count and ns;
inference_count counts rows, execution_count executions).

Inputs and outputs may live in shared-memory regions registered with
:attr:`ServerCore.shm` (system and TPU kinds): an input is a read-only
zero-copy view of its region, and an output asked for in a region is
written there after the execution's one device-to-host read — in a
dynamic batch, each request's own rows into its own region. A request
may instead name a slot of a shared-memory ring
(:attr:`ServerCore.shm_rings`, ``server/shm_ring.py``): the front-end
reads its inputs from the slot and writes its response back there.

Observability, as the reference has it: every booking path feeds the
statistics and the Prometheus families of :attr:`ServerCore.metrics`
(``server/metrics.py``) alike, so a duration histogram's ``_count``
equals the statistics' ``success.count``; device executions add to the
busy-ns counter the duty cycle derives from (models on the CPU book
none); each request lands in the flight recorder (``/v2/debug/requests``)
and, when sampled, in a trace record with five stamps; decoupled streams
get per-response statistics; stage CPU accounting (off by default) books
the executions' ``compute``, ``device_put`` and ``readback``.

Not ported yet: drain and lifecycle, repository control, the direct
(pump-thread) batch path, rate limiting and the admission gate of the
unbatched path.
"""

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np
import torch

from client_tpu_torch.observability.logging import StructuredLogger
from client_tpu_torch.observability.profiling import (
    StageCpuAccounting,
    execution_scope,
    prime_device_tracing,
    transfer_scope,
)
from client_tpu_torch.observability.recorder import FlightRecorder
from client_tpu_torch.observability.server import TraceManager
from client_tpu_torch.scheduling import (
    SCHEDULING_PARAM_KEYS,
    PriorityQueue,
    QueueFullError,
    QueuePolicy,
    QueueTimeoutError,
    SchedulingError,
)
from client_tpu_torch.server.model_repository import (
    STATE_READY,
    Model,
    ModelRepository,
)
from client_tpu_torch.server.metrics import ServerMetrics, device_label
from client_tpu_torch.server.models import pad_batch_bucket
from client_tpu_torch.server.shm import SharedMemoryManager
from client_tpu_torch.server.shm_ring import RingRegistry
from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bf16_tensor,
    deserialize_bytes_tensor,
    np_to_triton_dtype,
    num_elements,
    resolve_device,
    serialize_bf16_tensor,
    serialize_byte_tensor,
    tensors_to_numpy,
    triton_to_np_dtype,
)

SERVER_NAME = "client_tpu_torch_server"
SERVER_VERSION = "0.1.0"
# only what this server implements
SERVER_EXTENSIONS = [
    "classification",
    "model_configuration",
    "binary_tensor_data",
    "parameters",
    "statistics",
    "system_shared_memory",
    "tpu_shared_memory",
    "trace",
    "logging",
    "live_telemetry",
]


@dataclass(slots=True)
class CoreTensor:
    name: str
    datatype: str
    shape: List[int]
    data: np.ndarray  # host ndarray (object dtype for BYTES)


@dataclass(slots=True)
class CoreRequestedOutput:
    name: str
    classification: int = 0  # top-k as classification strings (0 = the raw tensor)
    # the registered region the output is written into (None = inline)
    shm_region: Optional[str] = None
    shm_byte_size: int = 0
    shm_offset: int = 0


@dataclass(slots=True)
class CoreRequest:
    model_name: str
    model_version: str = ""
    id: str = ""
    inputs: List[CoreTensor] = field(default_factory=list)
    outputs: List[CoreRequestedOutput] = field(default_factory=list)
    parameters: Dict[str, Any] = field(default_factory=dict)
    # server trace attached by the front-end (observability.server's
    # ServerTrace); the execution paths stamp its stages
    trace: Optional[Any] = None
    # scheduling fields stamped at admission (QueuePolicy.stamp): the
    # effective queue level (1 = highest) and the absolute queue deadline
    # in monotonic ns (None = no deadline)
    priority_level: int = 0
    deadline_ns: Optional[int] = None
    # shm-ring ticket (server.shm_ring.RingTicket) attached by the
    # front-end when the request sourced its inputs from a ring slot;
    # the front-end routes the response back through ticket.complete()
    shm_ring: Optional[Any] = None


def _trace_id_of(request) -> str:
    """The request's trace id ("" when untraced): the duration
    histogram's exemplar, linking a ``/metrics`` bucket to the same
    request's ``/v2/debug/requests`` entry."""
    trace = request.trace
    return trace.trace_id if trace is not None else ""


def _trace_stages(trace, queue_start_ns: int, compute_start_ns: int,
                  compute_end_ns: int, request_end_ns: int) -> None:
    """Stamp the Triton-style stages on a server trace (no-op when
    untraced); the front-end stamped REQUEST_START."""
    if trace is None:
        return
    trace.event("QUEUE_START", queue_start_ns)
    trace.event("COMPUTE_START", compute_start_ns)
    trace.event("COMPUTE_END", compute_end_ns)
    trace.event("REQUEST_END", request_end_ns)


@dataclass(slots=True)
class CoreResponse:
    model_name: str
    model_version: str
    id: str
    outputs: List[CoreTensor]
    parameters: Dict[str, Any] = field(default_factory=dict)
    # output name -> (region, bytes written, offset) for outputs written
    # into shared memory; the front-end sends no data for them
    shm_outputs: Dict[str, Any] = field(default_factory=dict)


class _Stats:
    """Cumulative per-model statistics (counts + ns). ``metrics`` (the
    core's :class:`ServerMetrics`) gets the same events, outside the
    lock, so the statistics extension and the Prometheus families never
    disagree."""

    FIELDS = ("success", "fail", "queue", "compute_input", "compute_infer", "compute_output")
    RESPONSE_FIELDS = ("success", "fail", "cancel", "compute_infer", "compute_output",
                       "empty_response")

    def __init__(self, metrics: ServerMetrics, model_name: str):
        self._metrics = metrics
        self._model = model_name
        self.lock = threading.Lock()
        self.counts = {f: 0 for f in self.FIELDS}
        self.ns = {f: 0 for f in self.FIELDS}
        self.inference_count = 0
        self.execution_count = 0
        self.last_inference = 0
        # decoupled per-response statistics keyed by response index
        # (Triton's response_stats: key "0" aggregates first responses)
        self.response_stats: Dict[str, Dict[str, List[int]]] = {}

    def record(self, field_name: str, duration_ns: int) -> None:
        with self.lock:
            self.counts[field_name] += 1
            self.ns[field_name] += duration_ns
        if field_name == "fail":
            self._metrics.observe_failure(self._model)

    def record_success(self, batch: int, queue_ns, in_ns, infer_ns, out_ns,
                       executions: int = 1, trace_id: str = "") -> None:
        """Account one successful request. ``executions`` is 0 for requests
        that shared a dynamically batched execution with an earlier
        request of the same batch (Triton semantics: inference_count
        counts rows, execution_count device executions). ``trace_id``
        becomes the duration histogram's exemplar."""
        now_ms = int(time.time() * 1000)
        total = queue_ns + in_ns + infer_ns + out_ns
        with self.lock:
            self.inference_count += batch
            self.execution_count += executions
            self.last_inference = now_ms
            for f, ns in (
                ("success", total),
                ("queue", queue_ns),
                ("compute_input", in_ns),
                ("compute_infer", infer_ns),
                ("compute_output", out_ns),
            ):
                self.counts[f] += 1
                self.ns[f] += ns
        self._metrics.observe_success(self._model, queue_ns, in_ns + infer_ns + out_ns,
                                      total, trace_id=trace_id)

    def record_execution(self) -> None:
        """Count a device execution whose every request failed packaging."""
        with self.lock:
            self.execution_count += 1

    def _response_entry(self, index: int) -> Dict[str, List[int]]:
        return self.response_stats.setdefault(
            str(index), {f: [0, 0] for f in self.RESPONSE_FIELDS})

    def record_response(self, index: int, infer_ns: int, out_ns: int,
                        latency_ns: int, empty: bool) -> None:
        """Account one decoupled response: ``infer_ns`` is the model's
        time since the previous response, ``out_ns`` its packaging,
        ``latency_ns`` the time since the stream started. An empty
        response is not a success and carries no compute samples."""
        with self.lock:
            entry = self._response_entry(index)
            if empty:
                entry["empty_response"][0] += 1
                entry["empty_response"][1] += latency_ns
                return
            for f, ns in (("success", latency_ns), ("compute_infer", infer_ns),
                          ("compute_output", out_ns)):
                entry[f][0] += 1
                entry[f][1] += ns

    def record_response_failure(self, index: int, latency_ns: int,
                                cancelled: bool = False) -> None:
        """Account the response slot a stream failed (or was cancelled) at."""
        with self.lock:
            entry = self._response_entry(index)["cancel" if cancelled else "fail"]
            entry[0] += 1
            entry[1] += latency_ns

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            snap = {
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "last_inference": self.last_inference,
                "inference_stats": {
                    f: {"count": self.counts[f], "ns": self.ns[f]}
                    for f in self.FIELDS
                },
            }
            if self.response_stats:
                snap["response_stats"] = {
                    key: {f: {"count": v[0], "ns": v[1]} for f, v in fields.items()}
                    for key, fields in self.response_stats.items()
                }
            return snap


def _to_host(raw: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Model outputs as host arrays. Torch tensors come back in ONE
    device-to-host read (:func:`tensors_to_numpy`), the execution's one
    synchronisation; numpy outputs pass through. Runs on the executor
    thread, so the event loop never waits on the device."""
    names = [k for k, v in raw.items() if isinstance(v, torch.Tensor)]
    if not names:
        return raw
    out = dict(raw)
    out.update(zip(names, tensors_to_numpy([raw[k] for k in names])))
    return out


class _BatchMeta:
    """Per-model caches and pure helpers of the dynamic batcher.
    Read-only after construction."""

    def __init__(self, model: Model):
        self.model = model
        self.declared = {i["name"] for i in model.inputs}
        self.declared_shapes = {i["name"]: list(i["shape"]) for i in model.inputs}
        self.ragged = bool(model.allow_ragged_batch)

    def validate(self, request: CoreRequest) -> int:
        """Batch-path request validation; returns the request's row count.

        Happens per request so a malformed request fails alone instead of
        poisoning the batch it would have joined: the batch dims, a ragged
        dim over ``ragged_dim_cap``, and whatever the model's own
        :meth:`Model.check_inputs` refuses.
        """
        model = self.model
        declared = self.declared
        rows = 1
        if request.inputs:
            rows = int(request.inputs[0].shape[0]) if request.inputs[0].shape else 1
            for t in request.inputs:
                if declared and t.name not in declared:
                    raise InferenceServerException(
                        f"unexpected inference input '{t.name}' for model "
                        f"'{model.name}'"
                    )
                if not t.shape or int(t.shape[0]) != rows:
                    raise InferenceServerException(
                        f"all inputs must share the batch dimension: input "
                        f"'{t.name}' shape {list(t.shape)} does not match "
                        f"batch size {rows}"
                    )
                self._check_ragged_cap(t)
            if rows > model.max_batch_size:
                raise InferenceServerException(
                    f"inference request batch-size must be <= "
                    f"{model.max_batch_size} for '{model.name}', got {rows}"
                )
            model.check_inputs({t.name: t.data for t in request.inputs})
        return rows

    def _check_ragged_cap(self, tensor: CoreTensor) -> None:
        """Refuse a -1-declared dim longer than the model's cap: merged
        with shorter requests it could not be padded to a shared bucket."""
        cap = self.model.ragged_dim_cap
        declared = self.declared_shapes.get(tensor.name)
        if not self.ragged or cap is None or declared is None:
            return
        dims = tensor.shape[1:]
        if len(dims) != len(declared):
            return
        for d, dd in zip(dims, declared):
            if dd == -1 and int(d) > cap:
                raise InferenceServerException(
                    f"input '{tensor.name}' shape {list(tensor.shape)} exceeds "
                    f"max {cap} in a ragged dim for model '{self.model.name}'"
                )

    @staticmethod
    def _signature_params(parameters: Dict[str, Any]) -> str:
        """Parameter part of the batch-compatibility signature, without
        the scheduling parameters: two same-shape requests that differ
        only in priority or timeout still share a batch."""
        if not parameters:
            return ""
        filtered = [
            (k, v) for k, v in sorted(parameters.items())
            if k not in SCHEDULING_PARAM_KEYS
        ]
        return repr(filtered) if filtered else ""

    def signature(self, request: CoreRequest):
        if not self.ragged:
            return (
                tuple((t.name, t.datatype, tuple(t.shape[1:])) for t in request.inputs),
                self._signature_params(request.parameters),
            )
        sig = []
        for t in request.inputs:
            declared = self.declared_shapes.get(t.name)
            dims = tuple(t.shape[1:])
            if declared is not None and len(declared) == len(dims):
                # drop ragged (-1) dims: they merge via padding. The rank
                # stays in the signature so a wrong-rank request can never
                # share (and poison) a well-formed batch.
                dims = tuple(d for d, dd in zip(dims, declared) if dd != -1)
            sig.append((t.name, t.datatype, len(t.shape), dims))
        return tuple(sig), self._signature_params(request.parameters)

    def pad_ragged(self, name: str, arrays: List[np.ndarray]) -> List[np.ndarray]:
        """Pad the -1-declared dims of ``arrays`` with the model's pad
        value to a shared power-of-two bucket, so they concatenate along
        axis 0."""
        declared = self.declared_shapes.get(name)
        rank = arrays[0].ndim
        if declared is None or len(declared) != rank - 1:
            return arrays
        cap = self.model.ragged_dim_cap
        targets = []
        for ax in range(1, rank):
            if declared[ax - 1] == -1:
                bucket = pad_batch_bucket(max(a.shape[ax] for a in arrays))
                if cap is not None:
                    # never past the model's hard limit: validate() kept
                    # every member within it, so the clamped bucket still
                    # covers them
                    bucket = min(bucket, cap)
                targets.append(bucket)
            else:
                targets.append(arrays[0].shape[ax])
        out = []
        pad_value = self.model.ragged_pad_value
        for a in arrays:
            pads = [(0, 0)] + [(0, targets[ax - 1] - a.shape[ax]) for ax in range(1, rank)]
            if any(p[1] for p in pads):
                a = np.pad(a, pads, constant_values=pad_value)
            out.append(a)
        return out

    def merge_inputs(self, requests: List[CoreRequest]) -> Dict[str, np.ndarray]:
        """Concatenate the batch's inputs along axis 0 (ragged dims padded)."""
        if len(requests) == 1:
            return {t.name: t.data for t in requests[0].inputs}
        merged: Dict[str, np.ndarray] = {}
        for pos, t in enumerate(requests[0].inputs):
            name = t.name
            arrays = []
            for r in requests:
                # clients nearly always order inputs identically (the
                # signature guarantees the same input SET, not order)
                cand = r.inputs[pos]
                if cand.name != name:
                    cand = next(i for i in r.inputs if i.name == name)
                arrays.append(cand.data)
            if self.ragged:
                arrays = self.pad_ragged(name, arrays)
            merged[name] = np.concatenate(arrays, axis=0)
        return merged


class _ModelBatcher:
    """Serial dynamic batcher (the server-side analogue of Triton's
    ``dynamic_batching`` scheduler).

    While one batch executes on the device, newly arriving requests queue;
    the next batch takes everything compatible that is pending, up to
    ``max_batch_size`` rows. The execution time itself is the
    accumulation window — no artificial delay — so a lone request sees no
    added latency while concurrent load shares executions.

    Requests are compatible when their input signature matches: same
    input names, datatypes, non-batch dims and parameters (ragged models:
    -1 dims excluded, padded at merge time). The pending list is a
    bounded multi-level :class:`PriorityQueue`: ``submit()`` rejects with
    429 once ``max_queue_size`` requests wait, batches are taken in
    (priority, arrival) order, and entries whose queue deadline passes
    fail with a deadline error before execution.
    """

    def __init__(self, core: "ServerCore", model: Model):
        self.core = core
        self.model = model
        self.meta = _BatchMeta(model)
        self.policy = QueuePolicy.from_model(model)
        # queued entries: (request, future, signature, rows, arrival_ns)
        self.pending = PriorityQueue(levels=self.policy.levels)
        self.running = False
        self._drain_task: Optional[asyncio.Task] = None

    def submit(self, request: CoreRequest) -> "asyncio.Future[CoreResponse]":
        """Validate + enqueue a request; returns a future for its response.

        Raises :class:`QueueFullError` (booked as a failure) when the
        queue is at ``max_queue_size``."""
        rows = self.meta.validate(request)
        policy = self.policy
        if policy.max_queue_size and len(self.pending) >= policy.max_queue_size:
            error = QueueFullError(self.model.name, policy.max_queue_size)
            self.core._book_rejection(self.model.name, request, error)
            raise error
        arrival_ns = time.monotonic_ns()
        policy.stamp(request, arrival_ns)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self.pending.push(
            (request, future, self.meta.signature(request), rows, arrival_ns),
            level=request.priority_level,
            deadline_ns=request.deadline_ns,
        )
        self._publish_depths()
        if not self.running:
            self.running = True
            self._drain_task = loop.create_task(self._drain())
        return future

    async def _drain(self) -> None:
        try:
            while len(self.pending):
                self._expire_pending()
                if not len(self.pending):
                    break
                await self._execute_batch(self._take_batch())
        finally:
            self.running = False
            if len(self.pending):  # raced with a submit after the check
                self.running = True
                self._drain_task = asyncio.get_running_loop().create_task(self._drain())

    def _expire_pending(self) -> None:
        """Fail queued entries whose deadline passed."""
        now_ns = time.monotonic_ns()
        expired = self.pending.expire(now_ns)
        for item in expired:
            request, future, _sig, _rows, arrival_ns = item.value
            error = QueueTimeoutError(
                self.model.name, self.policy.timeout_us_of(request.parameters))
            self.core._book_rejection(self.model.name, request, error,
                                      latency_ns=now_ns - arrival_ns)
            if not future.done():
                future.set_exception(error)
        if expired:
            self._publish_depths()

    def _take_batch(self) -> List[Any]:
        """Pop the highest-priority oldest request plus every compatible
        queued request, bounded by max_batch_size rows (submit() already
        rejected any single request over it). The scan stops at the
        signature's first entry that does not fit the row budget, so
        arrival order within a (priority, signature) lane is kept."""
        items = self.pending.scan()
        signature = items[0].value[2]
        budget = self.model.max_batch_size
        taken_items, taken, rows = [], [], 0
        for item in items:
            entry = item.value
            if entry[2] != signature:
                continue
            if rows + entry[3] > budget:
                break
            taken_items.append(item)
            taken.append(entry)
            rows += entry[3]
        self.pending.remove(taken_items)
        self._publish_depths()
        return taken

    def _publish_depths(self) -> None:
        self.core.metrics.set_queue_depth(self.model.name, self.pending.depths())

    async def _execute_batch(self, entries: List[Any]) -> None:
        loop = asyncio.get_running_loop()
        model, core = self.model, self.core
        stats = core._stats_for(model.name)
        prof = core.profiling
        exec_start = time.monotonic_ns()
        requests = [e[0] for e in entries]
        n = len(entries)
        # one take() covers the whole batch's stage brackets
        measured = prof.take()
        try:
            if measured:
                # queue_wait is wall time (no thread attached): CPU 0
                prof.account("queue_wait", 0,
                             wall_ns=sum(exec_start - e[4] for e in entries), count=n)
                a0 = prof.cpu_now()
                merged = self.meta.merge_inputs(requests)
                prof.account("batch_assembly", prof.cpu_now() - a0, count=n)
            else:
                merged = self.meta.merge_inputs(requests)
            parameters = requests[0].parameters

            def run():
                return core._execute_measured(model, merged, parameters, measured, n)

            raw = await loop.run_in_executor(core._executor, run)
            infer_end = time.monotonic_ns()
            core.add_busy_ns(model, infer_end - exec_start)
            core.metrics.observe_execution(model.name, sum(e[3] for e in entries))
        except Exception as e:  # noqa: BLE001 - fail every request in the batch
            core._log_request_error("batch_execution_failed", model.name, e, path="batch")
            now = time.monotonic_ns()
            for req, future, _sig, _rows, arrival in entries:
                stats.record("fail", now - arrival)
                core._record_exemplar(model.name, req, path="batch", status="error",
                                      error=str(e), arrival_ns=arrival,
                                      exec_start_ns=exec_start, end_ns=now)
                if not future.done():
                    future.set_exception(e)
            return
        offset = 0
        # The ONE device execution is credited to the first request whose
        # packaging succeeds; if every request fails packaging it is still
        # counted (the execution happened regardless).
        execution_pending = 1
        for request, future, _sig, rows, arrival in entries:
            try:
                if len(entries) == 1:
                    sliced = raw
                else:
                    sliced = {k: v[offset:offset + rows] for k, v in raw.items()}
                response = core._package_profiled(model, request, sliced)
                out_end = time.monotonic_ns()
                stats.record_success(
                    rows,
                    queue_ns=exec_start - arrival,
                    in_ns=0,
                    infer_ns=infer_end - exec_start,
                    out_ns=out_end - infer_end,
                    executions=execution_pending,
                    trace_id=_trace_id_of(request),
                )
                _trace_stages(request.trace, arrival, exec_start, infer_end, out_end)
                core._record_exemplar(model.name, request, path="batch",
                                      arrival_ns=arrival, exec_start_ns=exec_start,
                                      infer_end_ns=infer_end, end_ns=out_end, rows=rows)
                execution_pending = 0
                if not future.done():
                    future.set_result(response)
            except Exception as e:  # noqa: BLE001 - per-request packaging error
                core._log_request_error("packaging_failed", model.name, e, path="batch")
                now = time.monotonic_ns()
                stats.record("fail", now - arrival)
                core._record_exemplar(model.name, request, path="batch", status="error",
                                      error=str(e), arrival_ns=arrival,
                                      exec_start_ns=exec_start, infer_end_ns=infer_end,
                                      end_ns=now, rows=rows)
                if not future.done():
                    future.set_exception(e)
            offset += rows
        if execution_pending:
            stats.record_execution()


class ServerCore:
    """The protocol-independent inference engine: model lookup, the
    dynamic batchers, the executor that device calls run on, statistics,
    the streaming path, and the server's observability (metrics, traces,
    structured log, flight recorder, stage CPU accounting).

    ``device`` is the server's device: the one ``/metrics`` reports the
    memory of and server metadata lists (``cuda`` unless the caller
    passes ``"cpu"``; with no card, those two raise). Models carry their
    own device."""

    def __init__(self, repository: Optional[ModelRepository] = None,
                 max_workers: int = 32, device=None):
        self.repository = repository or ModelRepository()
        self.device = device
        self.stats: Dict[str, _Stats] = {}
        self._stats_lock = threading.Lock()
        self._batchers: Dict[str, _ModelBatcher] = {}
        self.shm = SharedMemoryManager()
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="client-tpu-torch-exec"
        )
        self.live = True
        # the trace extension: sampling, per-model settings, records
        self.trace_manager = TraceManager()
        # cumulative busy ns of device executions, in all and per device:
        # the monotone counter the duty cycle derives from
        self._busy_lock = threading.Lock()
        self._device_busy_ns = 0
        self._device_busy: Dict[str, int] = {}
        self.metrics = ServerMetrics(self, device=device)
        # rings over registered regions, validated once per registration
        self.shm_rings = RingRegistry(self.shm, metrics=self.metrics)
        # stage CPU accounting, off until POST /v2/debug/profiling
        self.profiling = StageCpuAccounting(metrics_hook=self.metrics.observe_stage_cpu)
        if torch.cuda.is_available() and torch.device(device or "cuda").type == "cuda":
            # /v2/debug/profile's device trace runs on an executor thread:
            # the profiler's CUDA tracing must first start on this one
            prime_device_tracing()
        # the logging extension: /v2/logging settings gate what it emits
        self.logger = StructuredLogger(name="server")
        # recent, failed and slowest requests (GET /v2/debug/requests)
        self.flight_recorder = FlightRecorder()

    @property
    def ready(self) -> bool:
        """Live, and every registered model loaded."""
        return self.live and all(
            entry["state"] == STATE_READY for entry in self.repository.index()
        )

    def close(self) -> None:
        """Stop model-owned machinery (the LLM engine's step loop) and the
        executor, unmap every registered shared-memory region, and flush
        the trace records and the log."""
        self.live = False
        for entry in self.repository.index():
            shutdown = getattr(self.repository.peek(entry["name"]), "shutdown", None)
            if shutdown is not None:
                shutdown()
        self._executor.shutdown(wait=False, cancel_futures=True)
        self.shm.unregister_all()
        self.trace_manager.close()
        self.logger.close()

    def _stats_for(self, model_name: str) -> _Stats:
        with self._stats_lock:
            if model_name not in self.stats:
                self.stats[model_name] = _Stats(metrics=self.metrics, model_name=model_name)
            return self.stats[model_name]

    # -- flight recorder, structured log, rejections --------------------------

    def _record_exemplar(self, model_name: str, request: CoreRequest, path: str,
                         status: str = "ok", error: str = "", arrival_ns: int = 0,
                         exec_start_ns: Optional[int] = None,
                         infer_end_ns: Optional[int] = None,
                         end_ns: Optional[int] = None, rows: int = 1,
                         responses: Optional[int] = None) -> None:
        """Book one completed request into the flight recorder, split at
        the same monotonic reads the statistics book (queue = arrival to
        execution, compute = execution to its end, package = the rest)."""
        if end_ns is None:
            end_ns = time.monotonic_ns()
        exec_start = exec_start_ns if exec_start_ns is not None else end_ns
        infer_end = infer_end_ns if infer_end_ns is not None else exec_start
        self.flight_recorder.record(
            model_name,
            request_id=request.id,
            trace_id=_trace_id_of(request),
            status=status,
            error=error,
            path=path,
            queue_us=(exec_start - arrival_ns) / 1e3 if arrival_ns else 0.0,
            compute_us=(infer_end - exec_start) / 1e3,
            package_us=(end_ns - infer_end) / 1e3,
            total_us=((end_ns - arrival_ns) if arrival_ns else (end_ns - exec_start)) / 1e3,
            rows=rows,
            priority=request.priority_level,
            responses=responses,
        )

    def _log_request_error(self, event: str, model_name: str, exc: BaseException,
                           path: str) -> None:
        """The server-side record of a failure otherwise only sent to the
        client; rate-limited per (event, model)."""
        self.logger.error(event, model=model_name, exc=exc,
                          rate_key=(event, model_name), path=path)

    def _book_rejection(self, model_name: str, request: CoreRequest,
                        error: SchedulingError, latency_ns: int = 0) -> None:
        """An admission rejection, booked everywhere it shows: the reject
        counter by reason, the statistics' fail field, the trace, the
        flight recorder and the verbose log."""
        self.metrics.observe_rejection(model_name, error.reason)
        if request.trace is not None:
            request.trace.event("QUEUE_REJECTED")
        self._stats_for(model_name).record("fail", latency_ns)
        now_ns = time.monotonic_ns()
        self._record_exemplar(model_name, request, path="admission", status="rejected",
                              error=error.message(), arrival_ns=now_ns - latency_ns,
                              exec_start_ns=now_ns, end_ns=now_ns)
        self.logger.verbose("request_rejected", model=model_name, reason=error.reason,
                            request_id=request.id)

    # -- device busy accounting (duty cycle) ----------------------------------

    def add_busy_ns(self, model: Model, duration_ns: int) -> None:
        """Credit one device execution's ns to the busy counter of the
        model's device. Models on the CPU never count."""
        device = getattr(model, "device", None)
        if device is None or torch.device(device).type != "cuda":
            return
        label = device_label(device)
        with self._busy_lock:
            self._device_busy_ns += duration_ns
            self._device_busy[label] = self._device_busy.get(label, 0) + duration_ns

    def _default_device_label_value(self) -> str:
        """The label of the server's device (exported at 0 before the
        first device execution)."""
        return device_label(resolve_device(self.device))

    @property
    def device_busy_ns_total(self) -> int:
        with self._busy_lock:
            return self._device_busy_ns

    def device_busy_by_device(self) -> Dict[str, int]:
        """Cumulative busy ns per device label (empty until the first
        device execution)."""
        with self._busy_lock:
            return dict(self._device_busy)

    # -- stage CPU accounting ---------------------------------------------------

    def _execute_measured(self, model: Model, inputs, parameters, measured: bool,
                          count: int = 1) -> Dict[str, np.ndarray]:
        """Executor-side ``model.execute`` and the one device-to-host read;
        when ``measured``, books ``compute``, ``readback`` and the
        ``device_put`` the model marks on this thread's CPU clock."""
        if not measured:
            return _to_host(model.execute(inputs, parameters))
        with execution_scope(self.profiling, count=count):
            raw = model.execute(inputs, parameters)
            with transfer_scope("readback"):
                return _to_host(raw)

    def _package_profiled(self, model: Model, request: CoreRequest,
                          raw: Dict[str, np.ndarray]) -> CoreResponse:
        """:meth:`_package_outputs` with its CPU booked as ``package``."""
        prof = self.profiling
        if not prof.take():
            return self._package_outputs(model, request, raw)
        c0 = prof.cpu_now()
        try:
            return self._package_outputs(model, request, raw)
        finally:
            prof.account("package", prof.cpu_now() - c0)

    def statistics(self, model_name: str = "", model_version: str = "") -> Dict[str, Any]:
        """The statistics extension's document for one model or all."""
        names = [model_name] if model_name else [m["name"] for m in self.repository.index()]
        result = []
        for name in names:
            try:
                model = self.repository.get(name, model_version if model_name else "")
            except InferenceServerException:
                if model_name:
                    raise
                continue
            snap = self._stats_for(name).snapshot()
            snap.update({"name": name, "version": model.version})
            result.append(snap)
        return {"model_stats": result}

    # -- introspection ----------------------------------------------------------

    def device_topology(self) -> Dict[str, Any]:
        """The ``devices`` block of server metadata and ``debug_state()``:
        the server's device platform and its devices (every CUDA card of
        the process, or the CPU). The port has no mesh-sharded models, so
        ``models`` is empty."""
        device = resolve_device(self.device)
        if device.type == "cuda":
            devices = [{"id": i, "kind": torch.cuda.get_device_name(i), "process": 0}
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [{"id": 0, "kind": device.type, "process": 0}]
        return {"platform": device.type, "device_count": len(devices),
                "devices": devices, "models": {}}

    def debug_state(self) -> Dict[str, Any]:
        """One snapshot of the server's live internals
        (``GET /v2/debug/state``), each subsystem under its own lock."""
        queues = {
            name: {
                "depths": {str(level): depth
                           for level, depth in batcher.pending.depths().items()},
                "max_queue_size": batcher.policy.max_queue_size,
            }
            for name, batcher in list(self._batchers.items())
        }
        # engine-backed models: the document engine.stats() returns
        llm: Dict[str, Any] = {}
        for entry in self.repository.index():
            engine = getattr(self.repository.peek(entry["name"]), "engine", None)
            stats = getattr(engine, "stats", None)
            if callable(stats):
                llm[entry["name"]] = stats()
        return {
            "server": {"name": SERVER_NAME, "version": SERVER_VERSION,
                       "live": self.live, "ready": self.ready, "recovering": False},
            "llm": llm,
            "devices": self.device_topology(),
            "queues": queues,
            "models": self.repository.index(),
            "log_settings": self.logger.settings(),
            "log_model_overrides": self.logger.model_overrides(),
            "trace": {
                "settings": self.trace_manager.settings(),
                "started": self.trace_manager.started_count,
                "completed": self.trace_manager.completed_count,
            },
            "profiling": self.profiling.config(),
            "flight_recorder": self.flight_recorder.stats(),
            "slo": self.metrics.telemetry.summary(),
        }

    def debug_slo(self) -> Dict[str, Any]:
        """``GET /v2/debug/slo``: every model's rolling latency windows and
        the error-budget status of models that declare an ``slo``."""
        return self.metrics.telemetry.snapshot()

    # -- inference -----------------------------------------------------------

    @staticmethod
    def _has_batch_dim(model: Model, request: CoreRequest) -> bool:
        """True when the request's input shapes include the batch dim.

        Clients may send a batchable model its unbatched form (e.g. an
        [H, W, 3] image to a [-1, H, W, 3] model); those requests bypass
        the dynamic batcher — concatenating along axis 0 would corrupt
        them — and execute singly. Only a request where EVERY declared
        input matches its unbatched rank counts as unbatched; mixed-rank
        requests stay on the batcher path so its batch-dim validation
        rejects them. A request whose inputs match no declared name
        executes singly too.
        """
        declared = {i["name"]: len(i["shape"]) for i in model.inputs}
        matches = [
            len(t.shape) == declared[t.name]
            for t in request.inputs
            if t.name in declared
        ]
        if not matches:
            return False
        return not all(matches)

    def _resolve_batch(self, model: Model, request: CoreRequest) -> int:
        if not request.inputs:
            return 1
        shape = request.inputs[0].shape
        if model.max_batch_size > 0 and shape and self._has_batch_dim(model, request):
            return int(shape[0])
        return 1

    def _run_model(self, model: Model, request: CoreRequest,
                   policy: QueuePolicy) -> Dict[str, np.ndarray]:
        """Executor-side body of the unbatched path."""
        if request.deadline_ns is not None and time.monotonic_ns() > request.deadline_ns:
            raise QueueTimeoutError(model.name, policy.timeout_us_of(request.parameters))
        declared = {i["name"] for i in model.inputs}
        for t in request.inputs:
            if declared and t.name not in declared:
                raise InferenceServerException(
                    f"unexpected inference input '{t.name}' for model "
                    f"'{model.name}'"
                )
        inputs = {t.name: t.data for t in request.inputs}
        return self._execute_measured(model, inputs, request.parameters,
                                      self.profiling.take())

    def _package_outputs(self, model: Model, request: CoreRequest,
                         raw: Dict[str, np.ndarray]) -> CoreResponse:
        requested = request.outputs or [
            CoreRequestedOutput(name=o["name"]) for o in model.outputs
        ]
        out_tensors: List[CoreTensor] = []
        shm_outputs: Dict[str, Any] = {}
        for req_out in requested:
            if req_out.name not in raw:
                raise InferenceServerException(
                    f"unexpected inference output '{req_out.name}' for model "
                    f"'{model.name}'"
                )
            arr = raw[req_out.name]
            if type(arr) is not np.ndarray:
                arr = np.asarray(arr)
            if req_out.classification > 0:
                arr = self._classify(model, req_out, arr)
            datatype = np_to_triton_dtype(arr.dtype)
            if datatype is None:
                raise InferenceServerException(
                    f"output '{req_out.name}' has unsupported dtype {arr.dtype}"
                )
            if req_out.shm_region is not None:
                payload = (serialize_byte_tensor(arr) if datatype == "BYTES"
                           else np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
                if payload.nbytes > req_out.shm_byte_size:
                    raise InferenceServerException(
                        f"shared memory region for output '{req_out.name}' is too "
                        f"small: need {payload.nbytes} bytes, have {req_out.shm_byte_size}"
                    )
                self.shm.write(req_out.shm_region, req_out.shm_offset, payload)
                shm_outputs[req_out.name] = (req_out.shm_region, payload.nbytes,
                                             req_out.shm_offset)
            out_tensors.append(CoreTensor(req_out.name, datatype, list(arr.shape), arr))
        return CoreResponse(model.name, model.version, request.id, out_tensors,
                            shm_outputs=shm_outputs)

    @staticmethod
    def _classify(model: Model, req_out: CoreRequestedOutput,
                  arr: np.ndarray) -> np.ndarray:
        """Convert a score tensor to Triton classification strings
        ``"value:index[:label]"`` over the last axis."""
        k = min(req_out.classification, arr.shape[-1])
        labels = model.labels(req_out.name)
        flat = arr.reshape(-1, arr.shape[-1])
        rows = []
        for row in flat:
            top = np.argsort(row)[::-1][:k]
            entries = []
            for idx in top:
                s = f"{row[idx]:f}:{idx}"
                if labels and idx < len(labels):
                    s += f":{labels[idx]}"
                entries.append(s.encode("utf-8"))
            rows.append(entries)
        out = np.array(rows, dtype=np.object_)
        return out.reshape(list(arr.shape[:-1]) + [k])

    async def infer(self, request: CoreRequest) -> CoreResponse:
        """Execute a request->response inference (decoupled models
        rejected). Batchable requests go through the model's dynamic
        batcher; the rest execute singly."""
        model = self.repository.get(request.model_name, request.model_version)
        if model.decoupled:
            raise InferenceServerException(
                f"model '{model.name}' is decoupled; use streaming inference"
            )
        self.metrics.pending_inc(model.name)
        try:
            if model.max_batch_size > 1 and self._has_batch_dim(model, request):
                return await self._submit_batched(model, request)
            return await self._infer_single(model, request)
        finally:
            self.metrics.pending_dec(model.name)

    def _submit_batched(self, model: Model,
                        request: CoreRequest) -> "asyncio.Future[CoreResponse]":
        """Route a batchable request to its model's dynamic batcher."""
        batcher = self._batchers.get(model.name)
        if batcher is None or batcher.model is not model:
            batcher = _ModelBatcher(self, model)
            self._batchers[model.name] = batcher
        try:
            return batcher.submit(request)
        except SchedulingError:
            raise  # booked inside submit()
        except InferenceServerException:
            # validation failures surface synchronously; execution
            # failures are booked inside the batcher
            self._stats_for(model.name).record("fail", 0)
            raise

    async def _infer_single(self, model: Model, request: CoreRequest) -> CoreResponse:
        """Unbatched execution (max_batch_size <= 1 or no batch dim)."""
        stats = self._stats_for(model.name)
        t0 = time.monotonic_ns()
        policy = QueuePolicy.from_model(model)
        policy.stamp(request, t0)
        loop = asyncio.get_running_loop()
        try:
            t1 = time.monotonic_ns()
            raw = await loop.run_in_executor(
                self._executor, self._run_model, model, request, policy
            )
            t2 = time.monotonic_ns()
            response = self._package_profiled(model, request, raw)
            t3 = time.monotonic_ns()
        except SchedulingError as e:  # the queue deadline passed
            self._book_rejection(model.name, request, e,
                                 latency_ns=time.monotonic_ns() - t0)
            raise
        except Exception as e:
            now = time.monotonic_ns()
            stats.record("fail", now - t0)
            self._log_request_error("request_failed", model.name, e, path="single")
            self._record_exemplar(model.name, request, path="single", status="error",
                                  error=str(e), arrival_ns=t0, end_ns=now)
            raise
        self.add_busy_ns(model, t2 - t1)
        rows = self._resolve_batch(model, request)
        self.metrics.observe_execution(model.name, rows)
        stats.record_success(
            rows,
            queue_ns=t1 - t0,
            in_ns=0,
            infer_ns=t2 - t1,
            out_ns=t3 - t2,
            trace_id=_trace_id_of(request),
        )
        if self.profiling.take():
            self.profiling.account("queue_wait", 0, wall_ns=t1 - t0)
        _trace_stages(request.trace, t0, t1, t2, t3)
        self._record_exemplar(model.name, request, path="single", arrival_ns=t0,
                              exec_start_ns=t1, infer_end_ns=t2, end_ns=t3, rows=rows)
        return response

    async def infer_decoupled(
        self, request: CoreRequest
    ) -> AsyncIterator[CoreResponse]:
        """Execute a streaming inference; yields 0..N responses, the last
        marked ``triton_final_response``. A non-decoupled model yields
        exactly one response, booked by :meth:`infer`, so a streaming
        front-end serves both kinds (Triton semantics).

        A decoupled stream is booked as one request, as the reference
        books it: queue 0, ``compute_infer`` its life less the packaging of
        its responses, ``compute_output`` that packaging; each response
        also books per-response statistics. A stream whose consumer stops
        after the final response is complete; one stopped earlier books a
        cancelled response, and one that fails a failure. Only the time
        spent waiting for the model's next item counts as device busy:
        the time the consumer takes is not the card's."""
        model = self.repository.get(request.model_name, request.model_version)
        if not model.decoupled:
            yield await self.infer(request)
            return
        # engine-backed models run their device calls on this core's
        # executor and book into its metrics; idempotent per core
        bind = getattr(model, "bind_core", None)
        if bind is not None:
            bind(self)
        stats = self._stats_for(model.name)
        t0 = time.monotonic_ns()
        packaging_ns = 0
        model_wait_ns = 0
        prev_ns = t0
        index = 0
        final_delivered = False

        def book_success() -> None:
            t1 = time.monotonic_ns()
            self.add_busy_ns(model, model_wait_ns)
            stats.record_success(self._resolve_batch(model, request), queue_ns=0,
                                 in_ns=0, infer_ns=t1 - t0 - packaging_ns,
                                 out_ns=packaging_ns, trace_id=_trace_id_of(request))
            _trace_stages(request.trace, t0, t0, t1, t1)
            self._record_exemplar(model.name, request, path="decoupled", arrival_ns=t0,
                                  exec_start_ns=t0, infer_end_ns=t1 - packaging_ns,
                                  end_ns=t1, responses=index)

        self.metrics.pending_inc(model.name)
        inputs = {t.name: t.data for t in request.inputs}
        prof = self.profiling
        try:
            resume_ns = time.monotonic_ns()
            # the loop thread's CPU between resuming the model and its next
            # item is the step's compute (other tasks on the loop blur it)
            measure_step = prof.take()
            cpu_resume = prof.cpu_now() if measure_step else 0
            async for raw in model.execute_decoupled(inputs, request.parameters):
                final = raw.pop("__final__", False)
                p0 = time.monotonic_ns()
                model_wait_ns += p0 - resume_ns
                if measure_step:
                    prof.account("compute", prof.cpu_now() - cpu_resume)
                if raw:
                    response = self._package_profiled(model, request, raw)
                else:
                    response = CoreResponse(model.name, model.version, request.id, [])
                if final:
                    response.parameters["triton_final_response"] = True
                p1 = time.monotonic_ns()
                packaging_ns += p1 - p0
                stats.record_response(index, infer_ns=p0 - prev_ns, out_ns=p1 - p0,
                                      latency_ns=p1 - t0, empty=not raw)
                if request.trace is not None:
                    request.trace.event(f"RESPONSE_{index}", p1)
                prev_ns = p1
                index += 1
                # a close while suspended here means this response WAS
                # delivered: after the final one, the stream is complete
                final_delivered = final
                yield response
                resume_ns = time.monotonic_ns()
                measure_step = prof.take()
                if measure_step:
                    cpu_resume = prof.cpu_now()
        except (asyncio.CancelledError, GeneratorExit):
            if final_delivered:
                book_success()
            else:
                stats.record_response_failure(index, time.monotonic_ns() - t0,
                                              cancelled=True)
            raise
        except Exception as e:
            now = time.monotonic_ns()
            stats.record_response_failure(index, now - t0)
            stats.record("fail", now - t0)
            self._log_request_error("stream_failed", model.name, e, path="decoupled")
            self._record_exemplar(model.name, request, path="decoupled", status="error",
                                  error=str(e), arrival_ns=t0, end_ns=now,
                                  responses=index)
            raise
        else:
            book_success()
        finally:
            self.metrics.pending_dec(model.name)

    # -- wire-side input decoding -------------------------------------------

    def decode_input(self, name: str, datatype: str, shape: List[int],
                     raw: Optional[bytes] = None,
                     json_data: Optional[list] = None,
                     shm_region: Optional[str] = None,
                     shm_byte_size: int = 0,
                     shm_offset: int = 0) -> CoreTensor:
        """Materialize an input tensor from inline binary, JSON or a
        registered shared-memory region."""
        count = num_elements(shape)
        if shm_region is not None:
            # a zero-copy view of the region, read-only so that a model
            # that writes its input raises instead of changing the
            # client's bytes; the region must stay registered while
            # requests that read it are in flight
            raw = self.shm.read(shm_region, shm_offset, shm_byte_size).toreadonly()
        if raw is not None:
            if datatype == "BYTES":
                arr = deserialize_bytes_tensor(raw)
            else:
                np_dtype = triton_to_np_dtype(datatype)
                if np_dtype is None:
                    raise InferenceServerException(
                        f"unsupported datatype '{datatype}' for input '{name}'"
                    )
                expected = count * np_dtype.itemsize
                if len(raw) != expected:
                    raise InferenceServerException(
                        f"input '{name}' expected {expected} bytes for shape "
                        f"{shape} and datatype {datatype}, got {len(raw)}"
                    )
                arr = np.frombuffer(raw, dtype=np_dtype)
        elif json_data is not None:
            if datatype == "BYTES":
                arr = np.array(
                    [d.encode("utf-8") if isinstance(d, str) else d for d in json_data],
                    dtype=np.object_,
                )
            elif datatype == "BF16":
                # JSON carries numbers: round them to bf16 as the wire would
                arr = deserialize_bf16_tensor(
                    serialize_bf16_tensor(np.array(json_data, dtype=np.float32))
                )
            else:
                np_dtype = triton_to_np_dtype(datatype)
                if np_dtype is None:
                    raise InferenceServerException(
                        f"unsupported datatype '{datatype}' for input '{name}'"
                    )
                arr = np.array(json_data, dtype=np_dtype)
        else:
            raise InferenceServerException(
                f"input '{name}' has no data (inline binary, JSON or shared memory)"
            )
        if arr.size != count:
            raise InferenceServerException(
                f"input '{name}' has {arr.size} elements, its shape {shape} "
                f"holds {count}"
            )
        return CoreTensor(name=name, datatype=datatype, shape=list(shape),
                          data=arr.reshape(shape))

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

Not ported yet: metrics, profiling, exemplars, traces, drain and
lifecycle, the direct (pump-thread) batch path, rate limiting and the
admission gate of the unbatched path.
"""

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np
import torch

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
from client_tpu_torch.server.models import pad_batch_bucket
from client_tpu_torch.server.shm import SharedMemoryManager
from client_tpu_torch.server.shm_ring import RingRegistry
from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bf16_tensor,
    deserialize_bytes_tensor,
    np_to_triton_dtype,
    num_elements,
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
    # scheduling fields stamped at admission (QueuePolicy.stamp): the
    # effective queue level (1 = highest) and the absolute queue deadline
    # in monotonic ns (None = no deadline)
    priority_level: int = 0
    deadline_ns: Optional[int] = None
    # shm-ring ticket (server.shm_ring.RingTicket) attached by the
    # front-end when the request sourced its inputs from a ring slot;
    # the front-end routes the response back through ticket.complete()
    shm_ring: Optional[Any] = None


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
    """Cumulative per-model statistics (counts + ns)."""

    FIELDS = ("success", "fail", "queue", "compute_input", "compute_infer", "compute_output")

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = {f: 0 for f in self.FIELDS}
        self.ns = {f: 0 for f in self.FIELDS}
        self.inference_count = 0
        self.execution_count = 0
        self.last_inference = 0

    def record(self, field_name: str, duration_ns: int) -> None:
        with self.lock:
            self.counts[field_name] += 1
            self.ns[field_name] += duration_ns

    def record_success(self, batch: int, queue_ns, in_ns, infer_ns, out_ns,
                       executions: int = 1) -> None:
        """Account one successful request. ``executions`` is 0 for requests
        that shared a dynamically batched execution with an earlier
        request of the same batch (Triton semantics: inference_count
        counts rows, execution_count device executions)."""
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

    def record_execution(self) -> None:
        """Count a device execution whose every request failed packaging."""
        with self.lock:
            self.execution_count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "last_inference": self.last_inference,
                "inference_stats": {
                    f: {"count": self.counts[f], "ns": self.ns[f]}
                    for f in self.FIELDS
                },
            }


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
            self.core._stats_for(self.model.name).record("fail", 0)
            raise QueueFullError(self.model.name, policy.max_queue_size)
        arrival_ns = time.monotonic_ns()
        policy.stamp(request, arrival_ns)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self.pending.push(
            (request, future, self.meta.signature(request), rows, arrival_ns),
            level=request.priority_level,
            deadline_ns=request.deadline_ns,
        )
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
        stats = self.core._stats_for(self.model.name)
        for item in self.pending.expire(now_ns):
            request, future, _sig, _rows, arrival_ns = item.value
            stats.record("fail", now_ns - arrival_ns)
            if not future.done():
                future.set_exception(QueueTimeoutError(
                    self.model.name, self.policy.timeout_us_of(request.parameters)
                ))

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
        return taken

    async def _execute_batch(self, entries: List[Any]) -> None:
        loop = asyncio.get_running_loop()
        model, core = self.model, self.core
        stats = core._stats_for(model.name)
        exec_start = time.monotonic_ns()
        requests = [e[0] for e in entries]
        try:
            merged = self.meta.merge_inputs(requests)
            parameters = requests[0].parameters

            def run():
                return _to_host(model.execute(merged, parameters))

            raw = await loop.run_in_executor(core._executor, run)
            infer_end = time.monotonic_ns()
        except Exception as e:  # noqa: BLE001 - fail every request in the batch
            now = time.monotonic_ns()
            for _req, future, _sig, _rows, arrival in entries:
                stats.record("fail", now - arrival)
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
                response = core._package_outputs(model, request, sliced)
                out_end = time.monotonic_ns()
                stats.record_success(
                    rows,
                    queue_ns=exec_start - arrival,
                    in_ns=0,
                    infer_ns=infer_end - exec_start,
                    out_ns=out_end - infer_end,
                    executions=execution_pending,
                )
                execution_pending = 0
                if not future.done():
                    future.set_result(response)
            except Exception as e:  # noqa: BLE001 - per-request packaging error
                stats.record("fail", time.monotonic_ns() - arrival)
                if not future.done():
                    future.set_exception(e)
            offset += rows
        if execution_pending:
            stats.record_execution()


class ServerCore:
    """The protocol-independent inference engine: model lookup, the
    dynamic batchers, the executor that device calls run on, statistics,
    and the streaming path."""

    def __init__(self, repository: Optional[ModelRepository] = None,
                 max_workers: int = 32):
        self.repository = repository or ModelRepository()
        self.stats: Dict[str, _Stats] = {}
        self._stats_lock = threading.Lock()
        self._batchers: Dict[str, _ModelBatcher] = {}
        self.shm = SharedMemoryManager()
        # rings over registered regions, validated once per registration
        self.shm_rings = RingRegistry(self.shm)
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="client-tpu-torch-exec"
        )
        self.live = True

    @property
    def ready(self) -> bool:
        """Live, and every registered model loaded."""
        return self.live and all(
            entry["state"] == STATE_READY for entry in self.repository.index()
        )

    def close(self) -> None:
        """Stop model-owned machinery (the LLM engine's step loop) and the
        executor, and unmap every registered shared-memory region."""
        self.live = False
        for entry in self.repository.index():
            shutdown = getattr(self.repository.peek(entry["name"]), "shutdown", None)
            if shutdown is not None:
                shutdown()
        self._executor.shutdown(wait=False, cancel_futures=True)
        self.shm.unregister_all()

    def _stats_for(self, model_name: str) -> _Stats:
        with self._stats_lock:
            if model_name not in self.stats:
                self.stats[model_name] = _Stats()
            return self.stats[model_name]

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

    @staticmethod
    def _run_model(model: Model, request: CoreRequest,
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
        return _to_host(model.execute(inputs, request.parameters))

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
        if model.max_batch_size > 1 and self._has_batch_dim(model, request):
            return await self._submit_batched(model, request)
        return await self._infer_single(model, request)

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
            response = self._package_outputs(model, request, raw)
            t3 = time.monotonic_ns()
        except Exception:
            stats.record("fail", time.monotonic_ns() - t0)
            raise
        stats.record_success(
            self._resolve_batch(model, request),
            queue_ns=t1 - t0,
            in_ns=0,
            infer_ns=t2 - t1,
            out_ns=t3 - t2,
        )
        return response

    async def infer_decoupled(
        self, request: CoreRequest
    ) -> AsyncIterator[CoreResponse]:
        """Execute a streaming inference; yields 0..N responses, the last
        marked ``triton_final_response``. A non-decoupled model yields
        exactly one response, booked by :meth:`infer`, so a streaming
        front-end serves both kinds (Triton semantics). A decoupled
        stream that runs to its end is booked as one successful request."""
        model = self.repository.get(request.model_name, request.model_version)
        if not model.decoupled:
            yield await self.infer(request)
            return
        # engine-backed models run their device calls on this core's
        # executor; one getattr per stream start, idempotent per core
        bind = getattr(model, "bind_core", None)
        if bind is not None:
            bind(self)
        # a stream is booked as one request, as the reference books it:
        # queue 0, compute_infer its life less the packaging of its
        # responses, compute_output that packaging; a stream that fails
        # (not one its consumer closes) is booked as a failure
        stats = self._stats_for(model.name)
        t0 = time.monotonic_ns()
        packaging_ns = 0
        inputs = {t.name: t.data for t in request.inputs}
        try:
            async for raw in model.execute_decoupled(inputs, request.parameters):
                p0 = time.monotonic_ns()
                final = raw.pop("__final__", False)
                response = self._package_outputs(model, request, raw)
                if final:
                    response.parameters["triton_final_response"] = True
                packaging_ns += time.monotonic_ns() - p0
                yield response
        except Exception:
            stats.record("fail", time.monotonic_ns() - t0)
            raise
        t1 = time.monotonic_ns()
        stats.record_success(self._resolve_batch(model, request), queue_ns=0, in_ns=0,
                             infer_ns=t1 - t0 - packaging_ns, out_ns=packaging_ns)

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

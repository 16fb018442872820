"""Model abstraction + repository for the port's server.

A model exposes its KServe v2 metadata and config and an execute over
name->ndarray dicts; decoupled models yield multiple responses per
request via an async generator (Triton's decoupled transaction policy).
"""

import threading
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np

from client_tpu_torch.utils import InferenceServerException

# index() states (Triton RepositoryIndex wire values)
STATE_READY = "READY"
STATE_UNAVAILABLE = "UNAVAILABLE"


class ModelUnavailableError(InferenceServerException):
    """A request targeted a model that exists but is not serving (its
    load failed): HTTP 503 / gRPC UNAVAILABLE, unlike the 400 a model
    that never existed gets."""

    http_status = 503
    grpc_code = "UNAVAILABLE"

    def __init__(self, msg: str):
        super().__init__(msg, status="UNAVAILABLE")


class Model:
    """Base class for served models.

    Subclasses define ``inputs``/``outputs`` metadata and implement
    :meth:`execute` (one response) or :meth:`execute_decoupled` (a stream
    of responses; set ``decoupled = True``).
    """

    name: str = "model"
    version: str = "1"
    platform: str = "pytorch"
    backend: str = "pytorch"
    max_batch_size: int = 0
    decoupled: bool = False
    # [{"name", "datatype", "shape"}] — shape without batch dim if
    # max_batch_size > 0, matching Triton config conventions.
    inputs: List[Dict[str, Any]] = []
    outputs: List[Dict[str, Any]] = []
    # Mixed-shape dynamic batching (the server-side half of Triton's
    # ragged batching): when True, concurrent requests whose shapes differ
    # ONLY in dims the model declares as -1 share one execution — the
    # batcher pads those dims with ``ragged_pad_value`` to a shared
    # power-of-two bucket, clamped to ``ragged_dim_cap``, before
    # concatenating. The model must tolerate padding (e.g. mask pad
    # tokens).
    allow_ragged_batch: bool = False
    ragged_pad_value: int = 0
    ragged_dim_cap: Optional[int] = None
    # Admission control (the ModelDynamicBatching priority /
    # ModelQueuePolicy surface, resolved by scheduling.QueuePolicy):
    # priority_levels N declares queue levels 1..N (1 = highest);
    # queue_policy keys: max_queue_size, default_timeout_us,
    # timeout_action ("reject"), allow_timeout_override.
    priority_levels: int = 0
    default_priority_level: int = 0
    queue_policy: Optional[Dict[str, Any]] = None
    # Scheduler declarations, rendered by config() so clients (the perf
    # harness's scheduler detection) see how to drive the model.
    # dynamic_batching is declared for batchable models that declare
    # neither of these (the core's batcher is always on for them).
    sequence_batching: Optional[Dict[str, Any]] = None
    ensemble_scheduling: Optional[Dict[str, Any]] = None

    def metadata(self) -> Dict[str, Any]:
        def entry(tensor):
            batch = [-1] if self.max_batch_size > 0 else []
            return {
                "name": tensor["name"],
                "datatype": tensor["datatype"],
                "shape": batch + list(tensor["shape"]),
            }

        return {
            "name": self.name,
            "versions": [self.version],
            "platform": self.platform,
            "inputs": [entry(i) for i in self.inputs],
            "outputs": [entry(o) for o in self.outputs],
        }

    def config(self) -> Dict[str, Any]:
        def entry(tensor):
            return {
                "name": tensor["name"],
                "data_type": "TYPE_" + tensor["datatype"].replace("BYTES", "STRING"),
                "dims": list(tensor["shape"]),
            }

        config = {
            "name": self.name,
            "platform": self.platform,
            "backend": self.backend,
            "max_batch_size": self.max_batch_size,
            "input": [entry(i) for i in self.inputs],
            "output": [entry(o) for o in self.outputs],
            "model_transaction_policy": {"decoupled": self.decoupled},
        }
        if self.sequence_batching is not None:
            config["sequence_batching"] = dict(self.sequence_batching)
        elif self.max_batch_size > 1 and self.ensemble_scheduling is None:
            # batchable models ride the core's dynamic batcher; declare it
            # the way Triton configs do so clients can see the scheduler
            # (never on an ensemble: the proto's scheduling choice is a
            # oneof)
            dynamic_batching: Dict[str, Any] = {}
            if self.priority_levels:
                dynamic_batching["priority_levels"] = self.priority_levels
                dynamic_batching["default_priority_level"] = self.default_priority_level
            if self.queue_policy:
                qp = self.queue_policy
                # Triton wire names (ModelQueuePolicy)
                dynamic_batching["default_queue_policy"] = {
                    "timeout_action": "REJECT",
                    "default_timeout_microseconds": int(qp.get("default_timeout_us", 0)),
                    "allow_timeout_override": bool(qp.get("allow_timeout_override", True)),
                    "max_queue_size": int(qp.get("max_queue_size", 0)),
                }
            config["dynamic_batching"] = dynamic_batching
        if self.ensemble_scheduling is not None:
            config["ensemble_scheduling"] = {
                "step": [dict(s) for s in self.ensemble_scheduling.get("step", [])]
            }
        return config

    def labels(self, output_name: str) -> Optional[List[str]]:
        """Classification labels for an output (None if unlabeled)."""
        return None

    def check_inputs(self, inputs: Dict[str, np.ndarray]) -> None:
        """Refuse one request's inputs before they join a dynamic batch:
        raise :class:`InferenceServerException` for what :meth:`execute`
        would refuse, so a bad request fails alone. Default: accept."""

    def execute(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> Dict[str, Any]:
        """One response: output name -> numpy array or torch tensor (the
        core reads tensors back to the host in one transfer)."""
        raise InferenceServerException(
            f"model '{self.name}' does not implement execute"
        )

    async def execute_decoupled(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> AsyncIterator[Dict[str, np.ndarray]]:
        raise InferenceServerException(
            f"model '{self.name}' is not decoupled"
        )
        yield {}  # pragma: no cover - makes this an async generator

    def warmup(self) -> None:
        """Called at load: build device state here so the first request
        is fast, and raise if the model cannot serve on this host."""


class ModelRepository:
    """Name -> model registry."""

    def __init__(self):
        self._models: Dict[str, Model] = {}
        self._state: Dict[str, str] = {}
        self._reason: Dict[str, str] = {}
        self._lock = threading.Lock()

    def add_model(self, model: Model) -> None:
        """Register a model after its warmup. A warmup failure does not
        raise: the model registers as UNAVAILABLE with reason ``load
        failed: <why>``, and requests to it get a 503."""
        failure: Optional[str] = None
        try:
            model.warmup()
        except Exception as e:  # noqa: BLE001 - surfaced via the index
            failure = f"load failed: {e}"
        with self._lock:
            self._models[model.name] = model
            self._state[model.name] = STATE_UNAVAILABLE if failure else STATE_READY
            self._reason[model.name] = failure or ""

    def peek(self, name: str) -> Optional[Model]:
        """The registered model regardless of readiness."""
        with self._lock:
            return self._models.get(name)

    def get(self, name: str, version: str = "") -> Model:
        with self._lock:
            model = self._models.get(name)
            ready = self._state.get(name) == STATE_READY
        if model is None:
            raise InferenceServerException(
                f"Request for unknown model: '{name}' is not found"
            )
        if not ready:
            raise ModelUnavailableError(
                f"Request for unavailable model: '{name}' is not ready"
            )
        if version and version != model.version:
            raise InferenceServerException(
                f"Request for unknown model version: '{name}' version "
                f"{version} is not found"
            )
        return model

    def is_ready(self, name: str, version: str = "") -> bool:
        with self._lock:
            if name not in self._models:
                return False
            if version and self._models[name].version != version:
                return False
            return self._state.get(name) == STATE_READY

    def index(self) -> List[Dict[str, str]]:
        with self._lock:
            return [
                {
                    "name": m.name,
                    "version": m.version,
                    "state": self._state.get(m.name, STATE_UNAVAILABLE),
                    "reason": self._reason.get(m.name, ""),
                }
                for m in self._models.values()
            ]

"""Model abstraction + repository for the port's server.

A model exposes its KServe v2 metadata and config and an execute over
name->ndarray dicts; decoupled models yield multiple responses per
request via an async generator (Triton's decoupled transaction policy).

The repository has the reference's load/unload semantics
(``client_tpu/server/model_repository.py``): the LOADING and UNLOADING
states, an atomic swap on reload, and a repository directory of
``<name>/model.py`` files, each defining ``create_model()``. The server's
device reaches a directory model through that function's ``device``
keyword when it declares one.
"""

import importlib.util
import inspect
import json
import os
import threading
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np

from client_tpu_torch.utils import InferenceServerException

# index() states (Triton RepositoryIndex wire values)
STATE_READY = "READY"
STATE_UNAVAILABLE = "UNAVAILABLE"
STATE_LOADING = "LOADING"
STATE_UNLOADING = "UNLOADING"


class ModelUnavailableError(InferenceServerException):
    """A request targeted a model that exists but is not serving
    (unloaded, unloading, or load-failed): HTTP 503 / gRPC UNAVAILABLE,
    a retryable status, unlike the 400 a model that never existed gets."""

    http_status = 503
    grpc_code = "UNAVAILABLE"

    def __init__(self, msg: str):
        super().__init__(msg, status="UNAVAILABLE")


def _mesh_capacity_failure(exc: Optional[BaseException]) -> bool:
    """True when a load failure is a mesh-capacity problem ("mesh
    requires N devices, host has M") anywhere in the cause chain: a
    property of the host, not a broken model, so it must not degrade
    whole-server readiness the way corrupt weights do."""
    from client_tpu_torch.parallel.sharding import MeshUnavailableError

    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, MeshUnavailableError):
            return True
        seen.add(id(exc))
        exc = exc.__cause__
    return False


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
    # ModelQueuePolicy / ModelRateLimiter surface, resolved by
    # scheduling.QueuePolicy): priority_levels N declares queue levels
    # 1..N (1 = highest); queue_policy keys: max_queue_size,
    # default_timeout_us, timeout_action ("reject" | "continue"),
    # allow_timeout_override; rate_limiter: {"resources": [{"name",
    # "count"}], "priority"} — executions acquire those pool resources.
    priority_levels: int = 0
    default_priority_level: int = 0
    queue_policy: Optional[Dict[str, Any]] = None
    rate_limiter: Optional[Dict[str, Any]] = None
    # Scheduler declarations, rendered by config() so clients (the perf
    # harness's scheduler detection) see how to drive the model.
    # dynamic_batching is declared for batchable models that declare
    # neither of these (the core's batcher is always on for them).
    sequence_batching: Optional[Dict[str, Any]] = None
    ensemble_scheduling: Optional[Dict[str, Any]] = None
    # Sharded execution (client_tpu_torch.parallel.sharding): a mesh
    # declaration {"axes": {"dp": 2, "tp": 2}, "inputs": {name: spec},
    # "outputs": {name: spec}} resolved at load time into a MeshPlan.
    # Models that resolve one publish it as ``mesh_plan`` (read by the
    # devices block of server metadata and debug_state(), and by the
    # per-device busy accounting). Too few devices surface the model as
    # UNAVAILABLE with reason "load failed: mesh requires N devices, host
    # has M".
    mesh: Optional[Dict[str, Any]] = None
    mesh_plan: Optional[Any] = None

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
                    "timeout_action": ("DELAY" if qp.get("timeout_action") == "continue"
                                       else "REJECT"),
                    "default_timeout_microseconds": int(qp.get("default_timeout_us", 0)),
                    "allow_timeout_override": bool(qp.get("allow_timeout_override", True)),
                    "max_queue_size": int(qp.get("max_queue_size", 0)),
                }
            config["dynamic_batching"] = dynamic_batching
        if self.rate_limiter:
            config["rate_limiter"] = {
                "resources": [dict(r) for r in self.rate_limiter.get("resources", [])],
                "priority": int(self.rate_limiter.get("priority", 0)),
            }
        if self.ensemble_scheduling is not None:
            config["ensemble_scheduling"] = {
                "step": [dict(s) for s in self.ensemble_scheduling.get("step", [])]
            }
        if isinstance(self.mesh, dict):
            # the mesh topology rides the config's parameters map (the
            # ModelParameter wire shape) so both protocols expose it: a
            # resolved plan reports the live topology, an unresolved
            # declaration what was asked for
            plan = self.mesh_plan
            payload = (plan.describe() if plan is not None
                       else {"axes": dict(self.mesh.get("axes", {})), "resolved": False})
            config["parameters"] = {"mesh": {"string_value": json.dumps(payload)}}
        return config

    def labels(self, output_name: str) -> Optional[List[str]]:
        """Classification labels for an output (None if unlabeled)."""
        return None

    def statistics(self) -> Dict[str, Any]:
        """Entries the model adds to its document of the statistics
        extension (``GET /v2/models/<name>/stats``), beside the server's
        own. Default: none."""
        return {}

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




def _create_model(module, name: str, device):
    """``module.create_model()``, handed the server's device through its
    ``device`` keyword when it declares one."""
    create = getattr(module, "create_model", None)
    if create is None:
        raise InferenceServerException(
            f"failed to load '{name}': model.py must define create_model()"
        )
    if "device" in inspect.signature(create).parameters:
        return create(device=device)
    return create()


class ModelRepository:
    """Name -> model registry with Triton-style load/unload semantics.

    Models are registered programmatically (``add_model``) or loaded from
    a repository directory where each subdirectory holds a ``model.py``
    defining ``create_model()`` (the python_backend analogue), which is
    given ``device`` (the server's) when it takes a ``device`` keyword.
    """

    def __init__(self, repository_path: Optional[str] = None, device=None):
        self._models: Dict[str, Model] = {}
        self._state: Dict[str, str] = {}
        self._reason: Dict[str, str] = {}
        # per-name load/unload generation: async unload finalization and
        # batcher eviction only apply when no load() happened in between
        self._epoch: Dict[str, int] = {}
        # names whose "load failed" is a host-capacity (mesh) problem:
        # left out of degraded() so one oversized mesh never pulls the
        # whole replica out of its load balancer
        self._capacity_failed: set = set()
        self._lock = threading.Lock()
        self._repository_path = repository_path
        self.device = device

    def _set_state(self, name: str, state: str, reason: str = "") -> None:
        # lock held by caller
        self._state[name] = state
        self._reason[name] = reason
        if state == STATE_READY:
            self._capacity_failed.discard(name)

    def _fail_load(self, name: str, exc: BaseException) -> None:
        """Mark a load failure (lock held by caller). Membership of the
        capacity set tracks the latest failure: a capacity miss followed
        by a real load bug must degrade, and vice versa."""
        self._set_state(name, STATE_UNAVAILABLE, f"load failed: {exc}")
        if _mesh_capacity_failure(exc):
            self._capacity_failed.add(name)
        else:
            self._capacity_failed.discard(name)

    def add_model(self, model: Model, ready: bool = True) -> None:
        """Register a programmatic model after its warmup. A warmup
        failure does not raise: the model registers as UNAVAILABLE with
        reason ``load failed: <why>`` (the index semantics a failed
        directory load gets), and requests to it get a 503. A later
        programmatic ``load()`` re-runs warmup and recovers it."""
        failure: Optional[Exception] = None
        try:
            model.warmup()
        except Exception as e:  # noqa: BLE001 - surfaced via the index
            failure = e
        with self._lock:
            self._models[model.name] = model
            if failure is not None:
                self._fail_load(model.name, failure)
            else:
                self._set_state(model.name, STATE_READY if ready else STATE_UNAVAILABLE)
            self._epoch[model.name] = self._epoch.get(model.name, 0) + 1

    def peek(self, name: str) -> Optional[Model]:
        """The registered model regardless of readiness (the core pins
        per-model state across an unload with it)."""
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

    def degraded(self) -> bool:
        """True when the ready set is degraded: a model is mid-load or
        stuck in a failed load. Intentional removals (unloading,
        unloaded) do not degrade readiness, nor does a load that failed
        for want of mesh devices (a property of the host)."""
        with self._lock:
            for name in self._models:
                if self._state.get(name) == STATE_LOADING:
                    return True
                if (self._reason.get(name, "").startswith("load failed")
                        and name not in self._capacity_failed):
                    return True
        return False

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

    def load(self, name: str, config_override: Optional[str] = None) -> None:
        """Load (or reload) a model by name, atomically.

        Directory models are (re-)imported from ``<repo>/<name>/model.py``;
        a serving model keeps serving the OLD object until the new one
        passes ``warmup()``, then requests cut over in one swap. A failed
        load leaves the old model serving (the error still reaches the
        caller). Programmatic models are re-warmed on reload: a bare
        re-mark-ready would resurrect a model that was unloaded because
        its state went bad.
        """
        model_py = (
            os.path.join(self._repository_path, name, "model.py")
            if self._repository_path
            else None
        )
        with self._lock:
            known = name in self._models
            was_ready = self._state.get(name) == STATE_READY
        if model_py is None or not os.path.exists(model_py):
            if not known:
                if self._repository_path is None:
                    raise InferenceServerException(
                        f"failed to load '{name}': no model repository configured"
                    )
                raise InferenceServerException(
                    f"failed to load '{name}': {model_py} not found"
                )
            # programmatic reload: same object, fresh warmup
            model = self._models[name]
            try:
                model.warmup()
            except Exception as e:  # noqa: BLE001 - surfaced to caller
                with self._lock:
                    if not was_ready:
                        self._fail_load(name, e)
                raise InferenceServerException(f"failed to load '{name}': {e}") from e
            with self._lock:
                self._set_state(name, STATE_READY)
                self._epoch[name] = self._epoch.get(name, 0) + 1
            return
        with self._lock:
            # a serving old model keeps serving through the load; a brand
            # new name is LOADING (not ready) until warmup passes
            if known and was_ready:
                self._reason[name] = "loading"
            else:
                self._set_state(name, STATE_LOADING, "loading")
        try:
            spec = importlib.util.spec_from_file_location(
                f"client_tpu_torch_model_{name}", model_py
            )
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            model = _create_model(module, name, self.device)
            if config_override:
                try:
                    overrides = json.loads(config_override)
                except json.JSONDecodeError as e:
                    raise InferenceServerException(
                        f"failed to load '{name}': bad config override: {e}"
                    ) from None
                if "max_batch_size" in overrides:
                    model.max_batch_size = int(overrides["max_batch_size"])
            model.name = name
            model.warmup()
        except Exception as e:  # noqa: BLE001 - load failure bookkeeping
            with self._lock:
                if known and was_ready:
                    # the old model still serves: a failed load is an
                    # event, not a state
                    self._reason[name] = ""
                elif known:
                    self._fail_load(name, e)
                else:
                    # a never-loaded name: no registry entry to degrade
                    self._state.pop(name, None)
                    self._reason.pop(name, None)
            if isinstance(e, InferenceServerException):
                raise
            raise InferenceServerException(f"failed to load '{name}': {e}") from e
        # atomic cutover: one assignment under the lock; requests admitted
        # before this instant run to completion against the old object
        with self._lock:
            self._models[name] = model
            self._set_state(name, STATE_READY)
            self._epoch[name] = self._epoch.get(name, 0) + 1

    def unload(self, name: str) -> int:
        """Begin unloading: the model stops admitting at once (new
        requests get a 503 :class:`ModelUnavailableError`) while queued
        and in-flight work drains. Returns the unload epoch; the caller
        (``ServerCore``) drains, then calls :meth:`finish_unload` with it."""
        with self._lock:
            if name not in self._models:
                raise InferenceServerException(
                    f"failed to unload '{name}': model is not loaded"
                )
            self._set_state(name, STATE_UNLOADING, "unloading")
            self._epoch[name] = self._epoch.get(name, 0) + 1
            return self._epoch[name]

    def epoch_of(self, name: str) -> Optional[int]:
        """The model's current load/unload generation (None if unknown):
        a finalizer whose unload epoch no longer matches was superseded
        by a load and must not touch the new model."""
        with self._lock:
            return self._epoch.get(name)

    def finish_unload(self, name: str, epoch: Optional[int] = None) -> None:
        """Mark an unload complete (UNAVAILABLE, reason "unloaded"). With
        ``epoch``, a no-op when a load() superseded the unload. The model
        object stays registered, and with it whatever device memory it
        holds, as in the reference."""
        with self._lock:
            if epoch is not None and self._epoch.get(name) != epoch:
                return
            if self._state.get(name) == STATE_UNLOADING:
                self._set_state(name, STATE_UNAVAILABLE, "unloaded")

    def scan(self) -> None:
        """Load every model directory found in the repository path."""
        if not self._repository_path:
            return
        for entry in sorted(os.listdir(self._repository_path)):
            if os.path.exists(os.path.join(self._repository_path, entry, "model.py")):
                self.load(entry)


def build_repository(repository_path=None, builtin: bool = True, zoo: bool = False,
                     device=None) -> ModelRepository:
    """The repository bootstrap the server CLI, the in-process server and
    the embedded runner share: the built-in models, optionally the model
    zoo, then a scan of the directory — every model on ``device``
    (``cuda`` unless the caller passes ``"cpu"``)."""
    repository = ModelRepository(repository_path, device=device)
    if builtin:
        from client_tpu_torch.server.models import register_builtin_models

        register_builtin_models(repository, device=device)
    if zoo:
        from client_tpu_torch.models.serving import register_zoo_models

        register_zoo_models(repository, device=device)
    repository.scan()
    return repository

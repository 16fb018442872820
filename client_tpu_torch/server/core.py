"""Protocol-independent server engine.

A front-end reduces a request to :class:`CoreRequest` (name->ndarray
inputs plus parameters), hands it to :meth:`ServerCore.infer_decoupled`,
and serializes the :class:`CoreResponse` objects it yields back onto its
wire. This slice carries the streaming path the LLM engine serves through;
dynamic batching, drain, shared memory, tracing and metrics are not
ported yet.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List

import numpy as np

from client_tpu_torch.server.model_repository import (
    STATE_READY,
    Model,
    ModelRepository,
)
from client_tpu_torch.utils import InferenceServerException

# KServe v2 wire dtype of each numpy dtype a model may return
_NP_TO_WIRE = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
}


@dataclass(slots=True)
class CoreTensor:
    name: str
    datatype: str
    shape: List[int]
    data: np.ndarray


@dataclass(slots=True)
class CoreRequest:
    model_name: str
    model_version: str = ""
    id: str = ""
    inputs: List[CoreTensor] = field(default_factory=list)
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass(slots=True)
class CoreResponse:
    model_name: str
    model_version: str
    id: str
    outputs: List[CoreTensor]
    parameters: Dict[str, Any] = field(default_factory=dict)


class ServerCore:
    """The protocol-independent inference engine: model lookup, the
    executor that device calls run on, and the streaming path."""

    def __init__(self, repository: ModelRepository, max_workers: int = 32):
        self.repository = repository
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
        executor."""
        self.live = False
        for entry in self.repository.index():
            shutdown = getattr(self.repository.peek(entry["name"]), "shutdown", None)
            if shutdown is not None:
                shutdown()
        self._executor.shutdown(wait=False, cancel_futures=True)

    def _package(self, model: Model, request: CoreRequest,
                 raw: Dict[str, np.ndarray]) -> CoreResponse:
        outputs = []
        for declared in model.outputs:
            name = declared["name"]
            if name not in raw:
                raise InferenceServerException(
                    f"model '{model.name}' returned no output '{name}'"
                )
            array = np.asarray(raw[name])
            datatype = _NP_TO_WIRE.get(array.dtype)
            if datatype is None:
                raise InferenceServerException(
                    f"output '{name}' has unsupported dtype {array.dtype}"
                )
            outputs.append(CoreTensor(name, datatype, list(array.shape), array))
        return CoreResponse(model.name, model.version, request.id, outputs)

    async def infer_decoupled(
        self, request: CoreRequest
    ) -> AsyncIterator[CoreResponse]:
        """Execute a streaming inference; yields 0..N responses, the last
        marked ``triton_final_response``. Only decoupled models are
        served: the one-response path comes with dynamic batching."""
        model = self.repository.get(request.model_name, request.model_version)
        if not model.decoupled:
            raise InferenceServerException(
                f"model '{model.name}' is not decoupled; this server streams "
                f"decoupled models only"
            )
        # engine-backed models run their device calls on this core's
        # executor; one getattr per stream start, idempotent per core
        bind = getattr(model, "bind_core", None)
        if bind is not None:
            bind(self)
        inputs = {t.name: t.data for t in request.inputs}
        async for raw in model.execute_decoupled(inputs, request.parameters):
            final = raw.pop("__final__", False)
            response = self._package(model, request, raw)
            if final:
                response.parameters["triton_final_response"] = True
            yield response

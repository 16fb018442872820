"""TensorFlow-Serving and TorchServe REST compatibility front-ends.

The port's own copy of ``client_tpu/server/compat_frontends.py``, on the
port's HTTP router: thin protocol adapters over :class:`ServerCore` that
give the perf harness's ``tfserving`` / ``torchserve`` backends live
endpoints to drive.

- TFS (REST API): ``POST /v1/models/<m>:predict`` with
  ``{"instances": [...]}`` (row format) or ``{"inputs": ...}`` (column
  format) -> ``{"predictions": ...}``, string tensors as ``{"b64": ...}``
  objects both ways; ``GET /v1/models/<m>`` (status) and
  ``GET /v1/models/<m>/metadata`` (a signature block carrying name,
  dtype and shape per tensor).
- TorchServe inference API: ``POST /predictions/<m>`` with a raw tensor
  body (or a JSON list) -> JSON prediction list; ``GET /ping``.

These adapt the wire protocols; model semantics stay KServe (dtypes and
shapes come from the model's own metadata).
"""

import base64
import re
from typing import Any, Dict

import numpy as np

from client_tpu_torch.server.core import CoreRequest, CoreTensor, ServerCore
from client_tpu_torch.server.http_server import json_response
from client_tpu_torch.utils import (
    KSERVE_TO_TF_DTYPE,
    InferenceServerException,
    triton_to_np_dtype,
)


def _body_json(request) -> Any:
    try:
        return request.json()
    except (UnicodeDecodeError, ValueError) as e:
        raise InferenceServerException(f"malformed request body: {e}") from None


class CompatFrontends:
    """The TFS and TorchServe routes for the port's HTTP router."""

    def __init__(self, core: ServerCore):
        self.core = core

    def routes(self):
        """(method, pattern, handler) entries; ':' is no separator, so
        '<name>:predict' arrives as one path segment."""
        return [
            ("GET", re.compile(r"/ping"), self.handle_ping),
            ("POST", re.compile(r"/predictions/(?P<model>[^/]+)"), self.handle_torchserve),
            ("GET", re.compile(r"/v1/models/(?P<model>[^/]+)/metadata"),
             self.handle_tfs_metadata),
            ("GET", re.compile(r"/v1/models/(?P<model_op>[^/]+)"), self.handle_tfs_get),
            ("POST", re.compile(r"/v1/models/(?P<model_op>[^/]+)"), self.handle_tfs_post),
        ]

    # -- TorchServe ----------------------------------------------------------

    async def handle_ping(self, request):
        return json_response({"status": "Healthy" if self.core.live else "Unhealthy"})

    async def handle_torchserve(self, request):
        model_name = request.params["model"]
        model = self.core.repository.get(model_name)
        if len(model.inputs) != 1:
            raise InferenceServerException(
                f"torchserve adapter serves single-input models; "
                f"'{model_name}' declares {len(model.inputs)}"
            )
        desc = model.inputs[0]
        np_dtype = triton_to_np_dtype(desc["datatype"])
        if request.headers.get("content-type", "").startswith("application/json"):
            arr = np.asarray(_body_json(request), dtype=np_dtype)
        else:
            arr = np.frombuffer(request.body, dtype=np_dtype)
            try:
                arr = arr.reshape(self._resolved_shape(desc))
            except ValueError:
                arr = arr.reshape([1, -1] if model.max_batch_size > 0 else [-1])
        if model.max_batch_size > 0 and arr.ndim == len(desc["shape"]):
            # batchable models declare shapes without the batch dim; a
            # bare instance gains it
            arr = arr[None]
        response = await self.core.infer(CoreRequest(
            model_name=model_name,
            inputs=[CoreTensor(desc["name"], desc["datatype"], list(arr.shape), arr)],
        ))
        return json_response(np.asarray(response.outputs[0].data).tolist())

    # -- TensorFlow Serving --------------------------------------------------

    async def handle_tfs_get(self, request):
        model = self.core.repository.get(request.params["model_op"])
        ready = self.core.repository.is_ready(model.name, "")
        return json_response({
            "model_version_status": [{
                "version": model.version,
                "state": "AVAILABLE" if ready else "LOADING",
                "status": {"error_code": "OK", "error_message": ""},
            }]
        })

    async def handle_tfs_metadata(self, request):
        model = self.core.repository.get(request.params["model"])

        def tensor_block(descs):
            block: Dict[str, Any] = {}
            for d in descs:
                shape = [-1] + list(d["shape"]) if model.max_batch_size > 0 else d["shape"]
                block[d["name"]] = {
                    "dtype": KSERVE_TO_TF_DTYPE.get(d["datatype"], "DT_INVALID"),
                    "tensor_shape": {"dim": [{"size": str(s)} for s in shape]},
                    "name": d["name"],
                }
            return block

        return json_response({
            "model_spec": {"name": model.name, "version": model.version},
            "metadata": {"signature_def": {"signature_def": {"serving_default": {
                "inputs": tensor_block(model.inputs),
                "outputs": tensor_block(model.outputs),
            }}}},
        })

    async def handle_tfs_post(self, request):
        model_op = request.params["model_op"]
        if not model_op.endswith(":predict"):
            raise InferenceServerException(
                f"unsupported TFS verb in '{model_op}' (only :predict)"
            )
        model_name = model_op[: -len(":predict")]
        model = self.core.repository.get(model_name)
        payload = _body_json(request)
        if not isinstance(payload, dict):
            raise InferenceServerException("TFS predict body must be a JSON object")
        inputs = []
        if "instances" in payload:
            # row format: one entry per batch row; single-input models take
            # bare values, multi-input models {name: value} objects
            rows = payload["instances"]
            if not rows:
                raise InferenceServerException("'instances' is empty")
            if isinstance(rows[0], dict) and set(rows[0].keys()) != {"b64"}:
                names = rows[0].keys()
                for i, row in enumerate(rows):
                    if not isinstance(row, dict) or row.keys() != names:
                        raise InferenceServerException(
                            f"instance {i} does not carry the same inputs "
                            f"as instance 0 ({sorted(names)})"
                        )
                for name in names:
                    desc = self._input_desc(model, name)
                    arr = self._decode_values(desc, [row[name] for row in rows])
                    inputs.append(CoreTensor(name, desc["datatype"], list(arr.shape), arr))
            else:
                if len(model.inputs) != 1:
                    raise InferenceServerException(
                        "bare 'instances' rows need a single-input model"
                    )
                desc = model.inputs[0]
                arr = self._decode_values(desc, rows)
                inputs.append(CoreTensor(desc["name"], desc["datatype"], list(arr.shape), arr))
        elif "inputs" in payload:
            # column format: {name: full tensor}, or a bare tensor for a
            # single-input model
            cols = payload["inputs"]
            if not isinstance(cols, dict):
                desc = model.inputs[0]
                cols = {desc["name"]: np.asarray(cols, dtype=triton_to_np_dtype(desc["datatype"]))}
            for name, values in cols.items():
                desc = self._input_desc(model, name)
                arr = self._decode_values(desc, values)
                inputs.append(CoreTensor(name, desc["datatype"], list(arr.shape), arr))
        else:
            raise InferenceServerException("TFS predict body needs 'instances' or 'inputs'")

        response = await self.core.infer(CoreRequest(model_name=model_name, inputs=inputs))

        def encode(t):
            arr = np.asarray(t.data)
            if t.datatype == "BYTES":
                flat = [
                    {"b64": base64.b64encode(
                        v if isinstance(v, bytes) else str(v).encode()).decode("ascii")}
                    for v in arr.reshape(-1)
                ]
                return np.array(flat, dtype=object).reshape(arr.shape).tolist()
            return arr.tolist()

        if len(response.outputs) == 1:
            predictions = encode(response.outputs[0])
        else:
            predictions = {t.name: encode(t) for t in response.outputs}
        return json_response({"predictions": predictions})

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _decode_values(desc, values):
        """JSON values -> ndarray; TFS string tensors arrive as
        {"b64": ...} objects (the REST API's binary encoding)."""
        if desc["datatype"] == "BYTES":
            def decode(v):
                if isinstance(v, dict) and "b64" in v:
                    return base64.b64decode(v["b64"])
                if isinstance(v, str):
                    return v.encode("utf-8")
                return bytes(v)

            flat = np.asarray(values, dtype=object)
            return np.array([decode(v) for v in flat.reshape(-1)],
                            dtype=object).reshape(flat.shape)
        return np.asarray(values, dtype=triton_to_np_dtype(desc["datatype"]))

    @staticmethod
    def _input_desc(model, name):
        for d in model.inputs:
            if d["name"] == name:
                return d
        raise InferenceServerException(f"model '{model.name}' has no input '{name}'")

    @staticmethod
    def _resolved_shape(desc):
        shape = [1] + [int(s) for s in desc["shape"]]
        return [s if s > 0 else -1 for s in shape]

"""Shape bucketing and the built-in models of the port's server.

``simple`` (the add_sub model every quick-start uses) and the identity
passthroughs (``identity_fp32``, ``identity_bf16``, ``identity_bytes``),
as ``client_tpu/server/models.py`` has them. Each takes the server's
device (``cuda`` unless the caller passes ``"cpu"``): AddSub computes
there, and the fixed-size identities copy their tensor through it, so
the wire-to-device-to-wire path is exercised bit for bit.
"""

import time
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from client_tpu_torch.server.model_repository import Model
from client_tpu_torch.utils import (
    InferenceServerException,
    numpy_to_tensor,
    resolve_device,
    tensors_to_numpy,
)


def pad_batch_bucket(rows: int, minimum: int = 1) -> int:
    """Next power-of-two bucket at or above ``rows`` (and ``minimum``):
    batches and prompts are padded to it, which bounds the set of shapes
    the device sees."""
    bucket = max(minimum, 1)
    while bucket < rows:
        bucket *= 2
    return bucket


def run_bucketed(fn: Callable[..., Sequence[torch.Tensor]], *arrays,
                 device: torch.device) -> Tuple[np.ndarray, ...]:
    """Move ``arrays`` (host arrays or tensors) to ``device``, pad their
    leading (batch) dim with zeros to a shared power-of-two bucket, call
    ``fn(*padded)``, read ALL its outputs back with ONE device-to-host
    transfer, and slice them to the true batch size. ``fn`` returns a
    tuple of tensors batched on the leading dim."""
    tensors = [
        a.to(device) if isinstance(a, torch.Tensor) else numpy_to_tensor(a, device)
        for a in arrays
    ]
    rows = tensors[0].shape[0]
    bucket = pad_batch_bucket(rows)
    if bucket != rows:
        tensors = [
            torch.cat([t, t.new_zeros((bucket - rows,) + tuple(t.shape[1:]))])
            for t in tensors
        ]
    with torch.inference_mode():
        outputs = tensors_to_numpy(list(fn(*tensors)))
    return tuple(o[:rows] for o in outputs)


def _add_sub(a: torch.Tensor, b: torch.Tensor):
    return a + b, a - b


class AddSubModel(Model):
    """The canonical 'simple' model: OUTPUT0 = INPUT0 + INPUT1, OUTPUT1 =
    INPUT0 - INPUT1, INT32 [16] a row, on ``device``."""

    max_batch_size = 64
    inputs = [
        {"name": "INPUT0", "datatype": "INT32", "shape": [16]},
        {"name": "INPUT1", "datatype": "INT32", "shape": [16]},
    ]
    outputs = [
        {"name": "OUTPUT0", "datatype": "INT32", "shape": [16]},
        {"name": "OUTPUT1", "datatype": "INT32", "shape": [16]},
    ]

    def __init__(self, name: str = "simple", device=None):
        self.name = name
        self.device = resolve_device(device)

    def warmup(self) -> None:
        z = np.zeros([1, 16], dtype=np.int32)
        run_bucketed(_add_sub, z, z, device=self.device)

    def execute(self, inputs, parameters):
        a, b = inputs.get("INPUT0"), inputs.get("INPUT1")
        if a is None or b is None:
            raise InferenceServerException(
                "model 'simple' expects inputs INPUT0 and INPUT1"
            )
        if a.shape != b.shape:
            raise InferenceServerException(
                f"INPUT0 shape {list(a.shape)} != INPUT1 shape {list(b.shape)}"
            )
        out0, out1 = run_bucketed(_add_sub, a, b, device=self.device)
        return {"OUTPUT0": out0, "OUTPUT1": out1}


class IdentityModel(Model):
    """Fixed-dtype passthrough (any shape): OUTPUT0 = INPUT0, copied
    through ``device``."""

    max_batch_size = 0

    def __init__(self, name: str = "identity_fp32", datatype: str = "FP32",
                 device=None):
        self.name = name
        self.device = resolve_device(device)
        self.inputs = [{"name": "INPUT0", "datatype": datatype, "shape": [-1]}]
        self.outputs = [{"name": "OUTPUT0", "datatype": datatype, "shape": [-1]}]

    def _passthrough(self, array: np.ndarray) -> np.ndarray:
        (out,) = tensors_to_numpy([numpy_to_tensor(array, self.device)])
        return out

    def execute(self, inputs, parameters):
        if "INPUT0" not in inputs:
            raise InferenceServerException(
                f"model '{self.name}' expects input INPUT0"
            )
        # execution-delay knob for timeout/deadline tests (the role of the
        # reference identity backend's execute_delay parameter)
        delay_ms = parameters.get("delay_ms") if parameters else None
        if delay_ms:
            time.sleep(min(float(delay_ms), 10_000) / 1000.0)
        return {"OUTPUT0": self._passthrough(inputs["INPUT0"])}


class BytesIdentityModel(IdentityModel):
    """BYTES passthrough — exercises string-tensor serialization. Strings
    have no device form, so they stay on the host."""

    def __init__(self, name: str = "identity_bytes", device=None):
        super().__init__(name=name, datatype="BYTES", device=device)

    def _passthrough(self, array: np.ndarray) -> np.ndarray:
        return array


def register_builtin_models(repository, device=None) -> None:
    """Install the built-in models into a repository, on ``device``."""
    repository.add_model(AddSubModel(device=device))
    repository.add_model(IdentityModel("identity_fp32", "FP32", device=device))
    repository.add_model(IdentityModel("identity_bf16", "BF16", device=device))
    repository.add_model(BytesIdentityModel(device=device))

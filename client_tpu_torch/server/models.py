"""Shape bucketing and the built-in models of the port's server.

``simple`` (the add_sub model every quick-start uses), the identity
passthroughs (``identity_fp32``, ``identity_bf16``, ``identity_bytes``),
the decoupled ``repeat_int32``, the stateful ``sequence_accumulate`` and
the ``add_sub_chain`` ensemble (``simple`` -> ``simple``), as
``client_tpu/server/models.py`` has them. Each takes the server's device
(``cuda`` unless the caller passes ``"cpu"``): AddSub computes there, the
fixed-size identities and ``repeat_int32`` copy their tensor through it,
and ``sequence_accumulate`` keeps its running sums there, so the
wire-to-device-to-wire path is exercised bit for bit.
"""

import asyncio
import threading
import time
from typing import Any, AsyncIterator, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from client_tpu_torch.observability.profiling import transfer_scope
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
    with transfer_scope("device_put"):
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
        outputs = list(fn(*tensors))
    with transfer_scope("readback"):
        outputs = tensors_to_numpy(outputs)
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


class RepeatModel(Model):
    """Decoupled: streams ``IN[i]`` back as one response per element,
    ``delay_us`` (a request parameter) between responses; ``IN`` is
    copied through ``device`` first."""

    decoupled = True
    max_batch_size = 0
    inputs = [{"name": "IN", "datatype": "INT32", "shape": [-1]}]
    outputs = [{"name": "OUT", "datatype": "INT32", "shape": [1]}]

    def __init__(self, name: str = "repeat_int32", device=None):
        self.name = name
        self.device = resolve_device(device)

    async def execute_decoupled(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> AsyncIterator[Dict[str, np.ndarray]]:
        if "IN" not in inputs:
            raise InferenceServerException("model 'repeat' expects input IN")
        delay_us = int(parameters.get("delay_us", 0))
        (values,) = tensors_to_numpy([
            numpy_to_tensor(np.ascontiguousarray(inputs["IN"]).reshape(-1), self.device)])
        for i, v in enumerate(values):
            if delay_us:
                await asyncio.sleep(delay_us / 1e6)
            yield {
                "OUT": np.array([v], dtype=np.int32),
                "__final__": i == len(values) - 1,
            }


class SequenceAccumulatorModel(Model):
    """Stateful sequence model: ``OUTPUT`` is the running int32 sum (it
    wraps) of ``INPUT`` over the requests of one ``sequence_id``;
    ``sequence_start`` resets it, ``sequence_end`` evicts it. Declares
    ``sequence_batching``, so clients detect the scheduler. The sums live
    on ``device`` as int64 kept in int32's range; the core runs
    ``execute`` on executor threads, so the state is keyed by sequence id
    under a lock."""

    max_batch_size = 0
    sequence_batching: Dict[str, Any] = {}
    inputs = [{"name": "INPUT", "datatype": "INT32", "shape": [1]}]
    outputs = [{"name": "OUTPUT", "datatype": "INT32", "shape": [1]}]

    def __init__(self, name: str = "sequence_accumulate", device=None):
        self.name = name
        self.device = resolve_device(device)
        self._totals: Dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()

    def execute(self, inputs, parameters):
        if "INPUT" not in inputs:
            raise InferenceServerException(
                f"model '{self.name}' expects input INPUT"
            )
        seq_id = int(parameters.get("sequence_id", 0))
        if seq_id == 0:
            raise InferenceServerException(
                f"model '{self.name}' is a sequence model; requests need a "
                "non-zero sequence_id"
            )
        value = numpy_to_tensor(
            np.asarray(inputs["INPUT"]).reshape(-1)[:1].astype(np.int64), self.device)
        with self._lock:
            if parameters.get("sequence_start"):
                self._totals[seq_id] = torch.zeros([1], dtype=torch.int64, device=self.device)
            if seq_id not in self._totals:
                raise InferenceServerException(
                    f"sequence {seq_id} has no open state; send "
                    "sequence_start first"
                )
            # int32 wraparound, computed in int64: load generators feed
            # arbitrary int32 values
            total = ((self._totals[seq_id] + value + 2**31) & 0xFFFFFFFF) - 2**31
            self._totals[seq_id] = total
            if parameters.get("sequence_end"):
                del self._totals[seq_id]
        return {"OUTPUT": total.to(torch.int32)}


class EnsembleModel(Model):
    """Composes other models into a pipeline (Triton ensembles).

    ``steps`` are Triton's ``ensemble_scheduling.step`` entries: each
    step's ``input_map`` maps the composing model's input names to
    ensemble-scope tensors, its ``output_map`` its outputs into ensemble
    scope. The steps run in order inside ONE execution, and the tensors
    between them never touch the wire. The pool carries host arrays:
    each composing model's outputs come back in one device-to-host read.
    A decoupled step is refused, and the declared outputs' coverage is
    checked at warmup. ``device`` is the composing models' device.
    """

    platform = "ensemble"
    backend = "ensemble"

    def __init__(self, name, repository, inputs, outputs, steps,
                 max_batch_size: int = 0, device=None):
        self.name = name
        self.device = resolve_device(device)
        self._repository = repository
        self.inputs = inputs
        self.outputs = outputs
        self.max_batch_size = max_batch_size
        self._steps = steps
        self.ensemble_scheduling = {"step": steps}

    def warmup(self) -> None:
        produced = {i["name"] for i in self.inputs}
        for step in self._steps:
            model = self._repository.get(step["model_name"])
            if model.decoupled:
                raise InferenceServerException(
                    f"ensemble '{self.name}' cannot compose decoupled "
                    f"model '{model.name}'"
                )
            produced.update(step["output_map"].values())
        # every declared output must come from some step (or an input)
        for out in self.outputs:
            if out["name"] not in produced:
                raise InferenceServerException(
                    f"ensemble '{self.name}' declares output "
                    f"'{out['name']}' but no step's output_map produces it"
                )

    def execute(self, inputs, parameters):
        pool = dict(inputs)
        for step in self._steps:
            model = self._repository.get(step["model_name"])
            sub_inputs = {}
            for comp_name, ens_name in step["input_map"].items():
                if ens_name not in pool:
                    raise InferenceServerException(
                        f"ensemble '{self.name}' step "
                        f"'{step['model_name']}' needs tensor '{ens_name}' "
                        "which no prior step produced"
                    )
                sub_inputs[comp_name] = pool[ens_name]
            # request parameters flow to every composing model
            raw = model.execute(sub_inputs, parameters)
            tensors = [k for k, v in raw.items() if isinstance(v, torch.Tensor)]
            if tensors:
                raw = dict(raw)
                raw.update(zip(tensors, tensors_to_numpy([raw[k] for k in tensors])))
            for comp_name, ens_name in step["output_map"].items():
                if comp_name not in raw:
                    raise InferenceServerException(
                        f"composing model '{step['model_name']}' produced "
                        f"no output '{comp_name}'"
                    )
                pool[ens_name] = raw[comp_name]
        missing = [o["name"] for o in self.outputs if o["name"] not in pool]
        if missing:
            raise InferenceServerException(
                f"ensemble '{self.name}' produced no tensor for declared "
                f"outputs {missing}"
            )
        return {o["name"]: pool[o["name"]] for o in self.outputs}


def register_builtin_models(repository, device=None) -> None:
    """Install the built-in models into a repository, on ``device``."""
    repository.add_model(AddSubModel(device=device))
    repository.add_model(IdentityModel("identity_fp32", "FP32", device=device))
    repository.add_model(IdentityModel("identity_bf16", "BF16", device=device))
    repository.add_model(BytesIdentityModel(device=device))
    repository.add_model(RepeatModel(device=device))
    repository.add_model(SequenceAccumulatorModel(device=device))
    # simple -> simple: OUTPUT0 = 2 * INPUT0, OUTPUT1 = 2 * INPUT1
    # ((a + b) + (a - b), (a + b) - (a - b))
    repository.add_model(EnsembleModel(
        "add_sub_chain",
        repository,
        inputs=[{"name": "INPUT0", "datatype": "INT32", "shape": [16]},
                {"name": "INPUT1", "datatype": "INT32", "shape": [16]}],
        outputs=[{"name": "OUTPUT0", "datatype": "INT32", "shape": [16]},
                 {"name": "OUTPUT1", "datatype": "INT32", "shape": [16]}],
        steps=[
            {
                "model_name": "simple",
                "input_map": {"INPUT0": "INPUT0", "INPUT1": "INPUT1"},
                "output_map": {"OUTPUT0": "mid0", "OUTPUT1": "mid1"},
            },
            {
                "model_name": "simple",
                "input_map": {"INPUT0": "mid0", "INPUT1": "mid1"},
                "output_map": {"OUTPUT0": "OUTPUT0", "OUTPUT1": "OUTPUT1"},
            },
        ],
        max_batch_size=64,
        device=device,
    ))

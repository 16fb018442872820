"""Input-data management for the port's perf harness.

The port's own copy of ``client_tpu/perf/data.py``. The reference's
DataLoader (reference src/c++/perf_analyzer/data_loader.h:41-229)
supports synthetic generation, multi-stream JSON corpora, and a directory
of per-input files; this module implements all three
(:meth:`DataLoader.generate_synthetic`, :meth:`DataLoader.read_from_json`,
:meth:`DataLoader.read_from_dir`) over model metadata, producing
PerfInferInput sets per (stream, step).
"""

import base64
import json
import os
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from client_tpu_torch.perf.backend import PerfInferInput
from client_tpu_torch.utils import (
    InferenceServerException,
    triton_to_np_dtype,
)


def _resolve_shape(shape, batch_size: int, tensor_name: str, shape_overrides):
    resolved = []
    for dim in shape:
        dim = int(dim)
        if dim < 0:
            override = (shape_overrides or {}).get(tensor_name)
            if override is None:
                raise InferenceServerException(
                    f"input '{tensor_name}' has dynamic shape {list(shape)}; "
                    "provide --shape overrides"
                )
            return list(override)
        resolved.append(dim)
    return resolved


class DataLoader:
    """Materializes request inputs from synthetic/random or JSON data."""

    def __init__(
        self,
        metadata: Dict[str, Any],
        batch_size: int = 1,
        shape_overrides: Optional[Dict[str, List[int]]] = None,
        seed: int = 0,
        batched: bool = False,
    ):
        """``batched=True`` means the model supports batching
        (config.max_batch_size > 0), so a leading -1 in metadata shapes is
        the batch dimension rather than a free dynamic dim."""
        self._metadata = metadata
        self._batch_size = batch_size
        self._batched = batched
        self._shape_overrides = shape_overrides or {}
        self._rng = np.random.default_rng(seed)
        # streams[i] is a list of steps; each step maps name -> ndarray
        self._streams: List[List[Dict[str, np.ndarray]]] = []
        # per-step request parameters, parallel to _streams (None = none)
        self._params: List[List[Optional[Dict[str, Any]]]] = []

    @property
    def stream_count(self) -> int:
        return len(self._streams)

    def step_count(self, stream: int) -> int:
        return len(self._streams[stream])

    def cache_token(self, stream: int, step: int) -> tuple:
        """Canonical key for a backend's prepared-request cache: equal
        tokens guarantee get_inputs()/get_parameters() yield an identical
        request (the corpus is immutable after loading; coordinates wrap
        the same way get_inputs wraps). C++ twin:
        IInferDataManager::CacheToken."""
        if not self._streams:
            raise InferenceServerException(
                "no input data loaded; call generate_synthetic or "
                "read_from_json"
            )
        s = stream % len(self._streams)
        return (s, step % len(self._streams[s]))

    def _input_descs(self):
        return self._metadata.get("inputs", [])

    def _batched_shape(self, shape: List[int]) -> List[int]:
        # metadata shapes on batched models lead with -1; replace with batch
        if self._batched and shape and int(shape[0]) == -1:
            return [self._batch_size] + [int(s) for s in shape[1:]]
        return [int(s) for s in shape]

    def generate_synthetic(self, zero_data: bool = False) -> None:
        """One stream, one step of random (or zero) tensors per input."""
        step: Dict[str, np.ndarray] = {}
        for desc in self._input_descs():
            name = desc["name"]
            datatype = desc["datatype"]
            # replace the leading batch dim first, then resolve any
            # remaining dynamic dims via --shape overrides
            shape = _resolve_shape(
                self._batched_shape(desc.get("shape", [])),
                self._batch_size,
                name,
                self._shape_overrides,
            )
            np_dtype = triton_to_np_dtype(datatype)
            if datatype == "BYTES":
                flat = [
                    b"synthetic_%d" % i for i in range(int(np.prod(shape) or 1))
                ]
                arr = np.array(flat, dtype=np.object_).reshape(shape)
            elif zero_data:
                arr = np.zeros(shape, dtype=np_dtype)
            elif np.dtype(np_dtype).kind in ("i", "u"):
                arr = self._rng.integers(0, 127, size=shape).astype(np_dtype)
            elif np_dtype == np.bool_:
                arr = self._rng.integers(0, 2, size=shape).astype(np.bool_)
            else:
                arr = self._rng.random(size=shape).astype(np_dtype)
            step[name] = arr
        self._streams = [[step]]
        self._params = [[None]]

    def read_from_json(self, path: str) -> None:
        """Load the reference's --input-data JSON format.

        {"data": [ {input-name: {"content": [...], "shape": [...]}, ...} |
                   [ {...step...}, ... ]   # nested list = one stream
                 ]}
        Values may be flat lists, nested lists, or {"b64": "..."} raw blobs.
        """
        with open(path) as f:
            doc = json.load(f)
        if "data" not in doc:
            raise InferenceServerException(
                f"input data file '{path}' missing top-level 'data'"
            )
        descs = {d["name"]: d for d in self._input_descs()}
        streams: List[List[Dict[str, np.ndarray]]] = []
        params: List[List[Optional[Dict[str, Any]]]] = []
        entries = doc["data"]
        for entry in entries:
            steps = entry if isinstance(entry, list) else [entry]
            stream = []
            stream_params = []
            for step in steps:
                # reserved key: per-step request parameters (how genai-perf
                # embeds per-request sampled max_tokens)
                step_params = step.get("parameters")
                stream.append(self._parse_step(step, descs))
                stream_params.append(
                    dict(step_params) if step_params else None
                )
            streams.append(stream)
            params.append(stream_params)
        if not isinstance(entries[0] if entries else None, list):
            # flat list of steps = a single stream (reference semantics)
            streams = [[s[0] for s in streams]]
            params = [[p[0] for p in params]]
        self._streams = streams
        self._params = params

    def read_from_dir(self, path: str) -> None:
        """Load a directory of per-input files (reference ReadDataFromDir,
        data_loader.h:63): each input reads ``<dir>/<input name>`` — raw
        little-endian bytes validated against the resolved shape for
        numeric dtypes, the whole file as a single element for BYTES.
        Produces one stream with one step.
        """
        step: Dict[str, np.ndarray] = {}
        for desc in self._input_descs():
            name = desc["name"]
            datatype = desc["datatype"]
            fpath = os.path.join(path, name)
            if not os.path.exists(fpath):
                raise InferenceServerException(
                    f"input data directory '{path}' has no file for input "
                    f"'{name}'"
                )
            with open(fpath, "rb") as f:
                raw = f.read()
            if datatype == "BYTES":
                step[name] = np.array([raw], dtype=np.object_)
                continue
            shape = _resolve_shape(
                self._batched_shape(desc.get("shape", [])),
                self._batch_size,
                name,
                self._shape_overrides,
            )
            np_dtype = triton_to_np_dtype(datatype)
            expected = int(np.prod(shape)) * np.dtype(np_dtype).itemsize
            if len(raw) != expected:
                raise InferenceServerException(
                    f"file '{fpath}' holds {len(raw)} bytes but input "
                    f"'{name}' needs {expected} for shape {shape}"
                )
            step[name] = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
        self._streams = [[step]]
        self._params = [[None]]

    def _parse_step(self, step: Dict, descs: Dict) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for name, value in step.items():
            if name == "parameters":
                continue
            desc = descs.get(name)
            if desc is None:
                raise InferenceServerException(
                    f"input data references unknown input '{name}'"
                )
            datatype = desc["datatype"]
            np_dtype = triton_to_np_dtype(datatype)
            if isinstance(value, dict) and "b64" in value:
                raw = base64.b64decode(value["b64"])
                shape = value.get(
                    "shape",
                    _resolve_shape(
                        desc.get("shape", []), self._batch_size, name,
                        self._shape_overrides,
                    ),
                )
                arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
            else:
                content = value["content"] if isinstance(value, dict) else value
                shape = (
                    value.get("shape")
                    if isinstance(value, dict) and "shape" in value
                    else None
                )
                if datatype == "BYTES":
                    flat = [
                        c.encode("utf-8") if isinstance(c, str) else c
                        for c in np.asarray(content, dtype=object).reshape(-1)
                    ]
                    arr = np.array(flat, dtype=np.object_)
                    if shape:
                        arr = arr.reshape(shape)
                else:
                    arr = np.asarray(content, dtype=np_dtype)
                    if shape:
                        arr = arr.reshape(shape)
            out[name] = arr
        return out

    def get_inputs(self, stream: int = 0, step: int = 0) -> List[PerfInferInput]:
        """The PerfInferInput list for (stream, step)."""
        if not self._streams:
            raise InferenceServerException(
                "no input data loaded; call generate_synthetic or "
                "read_from_json"
            )
        data = self._streams[stream % len(self._streams)]
        tensors = data[step % len(data)]
        inputs = []
        for desc in self._input_descs():
            name = desc["name"]
            if name not in tensors:
                raise InferenceServerException(
                    f"input data stream {stream} step {step} missing "
                    f"input '{name}'"
                )
            arr = tensors[name]
            inputs.append(
                PerfInferInput(
                    name=name,
                    shape=list(arr.shape),
                    datatype=desc["datatype"],
                    data=arr,
                )
            )
        return inputs

    def get_parameters(
        self, stream: int = 0, step: int = 0
    ) -> Optional[Dict[str, Any]]:
        """Per-step request parameters for (stream, step), or None."""
        if not self._params:
            return None
        data = self._params[stream % len(self._params)]
        return data[step % len(data)] if data else None


class ShmDataPlane:
    """Shared-memory data plane over a DataLoader (system or tpu kind).

    The Python twin of the reference's InferDataManagerShm
    (reference infer_data_manager_shm.cc:1-384): every (stream, step, input)
    tensor is staged ONCE into a created-and-registered region at
    :meth:`setup`; :meth:`get_inputs` then returns PerfInferInput objects
    carrying only region references, so request bodies stay tiny no matter
    the tensor size. Kind "tpu" registers over the tpu-shm extension with
    the JSON raw handle (client_tpu_torch.utils.tpu_shared_memory),
    "system" over the system-shm extension. Region names (and system-shm
    keys) carry the pid and a uuid: ``/dev/shm`` is shared by every run on
    the machine.

    Exposes the DataLoader read API (get_inputs/get_parameters/
    stream_count/step_count) so load managers can use it as a drop-in.
    """

    def __init__(self, loader: DataLoader, backend, kind: str = "system",
                 prefix: Optional[str] = None):
        if kind not in ("system", "tpu"):
            raise InferenceServerException(
                f"unsupported shared-memory kind '{kind}'"
            )
        self._loader = loader
        self._backend = backend
        self._kind = kind
        self._prefix = prefix or (
            f"ctpu_pyperf_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        )
        # (stream, step, input name) -> (region name, byte size)
        self._refs: Dict[Any, Any] = {}
        self._handles: List[Any] = []
        self._registered: List[str] = []

    @property
    def stream_count(self) -> int:
        return self._loader.stream_count

    def step_count(self, stream: int) -> int:
        return self._loader.step_count(stream)

    def cache_token(self, stream: int, step: int) -> tuple:
        # Region references are deterministic per wrapped (stream, step);
        # there are no per-slot regions in the Python plane, so the
        # loader's token is already canonical.
        return self._loader.cache_token(stream, step)

    @staticmethod
    def _payload(t: PerfInferInput) -> bytes:
        from client_tpu_torch.utils import serialize_byte_tensor

        if t.datatype == "BYTES":
            return serialize_byte_tensor(t.data).tobytes()
        return np.ascontiguousarray(t.data).tobytes()

    async def setup(self) -> None:
        """Create, fill, and register one region per (stream, step, input)."""
        for stream in range(self._loader.stream_count):
            for step in range(self._loader.step_count(stream)):
                for t in self._loader.get_inputs(stream, step):
                    payload = self._payload(t)
                    name = f"{self._prefix}_s{stream}_t{step}_{t.name}"
                    if self._kind == "tpu":
                        from client_tpu_torch.utils import tpu_shared_memory as tpushm

                        handle = tpushm.create_shared_memory_region(
                            name, len(payload)
                        )
                        handle.buf(0, len(payload))[:] = payload
                        try:
                            await self._backend.register_tpu_shared_memory(
                                name,
                                tpushm.get_raw_handle(handle),
                                handle.device_id(),
                                len(payload),
                            )
                        except Exception:
                            # A failed registration must not leak the
                            # /dev/shm file (native twin does the same).
                            tpushm.destroy_shared_memory_region(handle)
                            raise
                    else:
                        from client_tpu_torch.utils import shared_memory as sysshm

                        handle = sysshm.create_shared_memory_region(
                            name, f"/{name}", len(payload)
                        )
                        handle.buf(0, len(payload))[:] = payload
                        try:
                            await self._backend.register_system_shared_memory(
                                name, f"/{name}", len(payload)
                            )
                        except Exception:
                            sysshm.destroy_shared_memory_region(handle)
                            raise
                    self._handles.append(handle)
                    self._registered.append(name)
                    self._refs[(stream, step, t.name)] = (name, len(payload))

    def get_inputs(self, stream: int = 0, step: int = 0) -> List[PerfInferInput]:
        inputs = self._loader.get_inputs(stream, step)
        s = stream % self._loader.stream_count
        t = step % self._loader.step_count(s)
        for inp in inputs:
            region, byte_size = self._refs[(s, t, inp.name)]
            inp.shm_region = region
            inp.shm_byte_size = byte_size
        return inputs

    def get_parameters(self, stream: int = 0, step: int = 0):
        return self._loader.get_parameters(stream, step)

    async def cleanup(self) -> None:
        """Unregister from the server and free the local mappings."""
        for name in self._registered:
            try:
                if self._kind == "tpu":
                    await self._backend.unregister_tpu_shared_memory(name)
                else:
                    await self._backend.unregister_system_shared_memory(name)
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        self._registered.clear()
        for handle in self._handles:
            try:
                if self._kind == "tpu":
                    from client_tpu_torch.utils import tpu_shared_memory as tpushm

                    tpushm.destroy_shared_memory_region(handle)
                else:
                    from client_tpu_torch.utils import shared_memory as sysshm

                    sysshm.destroy_shared_memory_region(handle)
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        self._handles.clear()
        self._refs.clear()

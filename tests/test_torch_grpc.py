"""The port's KServe v2 gRPC surface held to the JAX package's, on the CPU.

- ``_wire`` (the protobuf-free ModelInfer codec) and the server codec
  against the reference's, byte for byte, on seeded random corpora.
- The port's native front-end (``csrc/frontend``, built here with ``g++``
  once per run under its file lock) against the reference's grpcio
  clients, sync and aio: every RPC, unary and streaming inference, system
  and TPU shared memory, compression, deadlines and the errors with their
  status codes, each held to the same scenario on the reference's own
  grpc.aio server.
- The port's own clients (on its h2c transport) against the reference's
  grpc.aio server and its native server: each scenario's answer equals
  the reference client's answer on the same server.
- The tiny fp32 ``llm_engine`` streamed over the port's gRPC, weights
  through ``params_from_jax``: tokens equal ``llama.generate``, and a
  stream cancelled mid-way leaves no KV block in use.
- No head-of-line blocking: a request held on one model does not delay
  another model's answers.
- The transport's own pieces: HPACK (RFC 7541's examples, Huffman from
  the C++ tables), ``grpc-timeout``, the event records of the front-end.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

import client_tpu.grpc as ref_grpc
import client_tpu.grpc.aio as ref_grpc_aio
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
from client_tpu.grpc import _wire as ref_wire
from client_tpu.grpc._generated import grpc_service_pb2 as ref_pb
from client_tpu_torch.grpc import _h2
from client_tpu_torch.grpc import _wire as port_wire
from client_tpu_torch.grpc._generated import grpc_service_pb2 as port_pb
from client_tpu_torch.utils import shared_memory as shm
from client_tpu_torch.utils import tpu_shared_memory as tpushm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.float32, np.int32, np.int64, np.uint8, np.float64, np.int16]


# ---------------------------------------------------------------------------
# the wire codec, byte for byte
# ---------------------------------------------------------------------------


def _random_request(rng):
    params = {}
    for _ in range(int(rng.integers(0, 3))):
        params[f"k{int(rng.integers(10))}"] = [True, False, int(rng.integers(-5, 5)), 1.5,
                                               "v", -(2**40)][int(rng.integers(6))]
    tensors = []
    for i in range(int(rng.integers(1, 4))):
        dtype = DTYPES[int(rng.integers(len(DTYPES)))]
        shape = [int(s) for s in rng.integers(1, 5, size=int(rng.integers(1, 4)))]
        arr = (rng.normal(size=shape) * 100).astype(dtype)
        tensors.append((f"IN{i}", arr))
    rid = f"r{int(rng.integers(1000))}" if rng.integers(2) else ""
    return params, tensors, rid


@pytest.mark.parametrize("seed", range(6))
def test_wire_request_encode_matches_reference(seed):
    rng = np.random.default_rng(seed)
    from client_tpu_torch.utils import np_to_triton_dtype

    for _ in range(10):
        params, tensors, rid = _random_request(rng)
        meta = [(n, np_to_triton_dtype(a.dtype), list(a.shape)) for n, a in tensors]
        raws = [a.tobytes() for _, a in tensors]
        ours, theirs = bytearray(), bytearray()
        port_wire.encode_infer_request(ours, "m", "", rid, params, meta, raws)
        ref_wire.encode_infer_request(theirs, "m", "", rid, params, meta, raws)
        assert bytes(ours) == bytes(theirs)
        # and the message runtime agrees with both
        request = port_pb.ModelInferRequest.FromString(bytes(ours))
        assert request.SerializeToString() == bytes(ours)


@pytest.mark.parametrize("seed", range(4))
def test_wire_request_scan_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ours, theirs = port_wire.RequestScanner(), ref_wire.RequestScanner()
    from client_tpu_torch.utils import np_to_triton_dtype

    for _ in range(10):
        params, tensors, rid = _random_request(rng)
        request = ref_pb.ModelInferRequest(model_name="m", id=rid)
        for key, value in params.items():
            ref_grpc._utils.set_parameter(request.parameters, key, value)
        for name, arr in tensors:
            request.inputs.add(name=name, datatype=np_to_triton_dtype(arr.dtype),
                               shape=list(arr.shape))
            request.raw_input_contents.append(arr.tobytes())
        data = request.SerializeToString(deterministic=True)
        a, b = ours.scan(data), theirs.scan(data)
        assert (a is None) == (b is None)
        if a is None:
            continue
        ta, tb = a[0], b[0]
        assert (ta.model_name, ta.model_version, ta.inputs, ta.output_names, ta.parameters) == (
            tb.model_name, tb.model_version, tb.inputs, tb.output_names, tb.parameters)
        assert a[1:3] == b[1:3]
        assert [bytes(r) for r in a[3]] == [bytes(r) for r in b[3]]


@pytest.fixture(scope="module")
def cores():
    """A bare core of each package, for their codecs."""
    from client_tpu.server.core import ServerCore as RefCore
    from client_tpu.server.model_repository import ModelRepository as RefRepository
    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.model_repository import ModelRepository

    port, ref = ServerCore(ModelRepository(), device="cpu"), RefCore(RefRepository())
    yield port, ref
    port.close()
    ref.close()


def _responses(pkg_core, rng, kind):
    """The same random response built in one package's types."""
    core = pkg_core
    outputs = []
    for i in range(int(rng.integers(1, 3))):
        arr = rng.normal(size=[int(rng.integers(1, 6))]).astype(np.float32)
        outputs.append(core.CoreTensor(f"OUT{i}", "FP32", list(arr.shape), arr))
    shm_outputs = {}
    if kind == "bytes":
        outputs.append(core.CoreTensor("OUTB", "BYTES", [2],
                                       np.array([b"x", b"longer-value"], dtype=np.object_)))
    if kind == "shm":
        shm_outputs = {"OUT0": ("region", 4 * outputs[0].data.size, 16)}
    return core.CoreResponse(model_name="m", model_version="1" if rng.integers(2) else "",
                             id=f"r{int(rng.integers(100))}" if rng.integers(2) else "",
                             outputs=outputs, parameters={"p": 3} if rng.integers(2) else {},
                             shm_outputs=shm_outputs)


@pytest.mark.parametrize("kind", ["plain", "bytes", "shm", "stream", "stream_error"])
def test_codec_encode_matches_reference(kind, cores):
    from client_tpu.server import _grpc_codec as ref_codec
    from client_tpu.server import core as ref_core_mod
    from client_tpu_torch.server import _grpc_codec as port_codec
    from client_tpu_torch.server import core as port_core_mod

    ours = port_codec.FastInferCodec(cores[0])
    theirs = ref_codec.FastInferCodec(cores[1])
    for seed in range(8):
        a = _responses(port_core_mod, np.random.default_rng(seed), kind)
        b = _responses(ref_core_mod, np.random.default_rng(seed), kind)
        if kind == "stream":
            assert ours.encode_stream_response(a) == theirs.encode_stream_response(b)
        elif kind == "stream_error":
            assert ours.encode_stream_error("boom", a.id) == theirs.encode_stream_error(
                "boom", b.id)
        else:
            got = ours.encode_response(a)
            assert got == theirs.encode_response(b)
            assert got == port_codec.build_proto_response(a).SerializeToString()


def test_split_stream_frame_matches_reference(cores):
    from client_tpu_torch.server import _grpc_codec as port_codec
    from client_tpu_torch.server import core as port_core_mod

    codec = port_codec.FastInferCodec(cores[0])
    for seed in range(5):
        response = _responses(port_core_mod, np.random.default_rng(seed), "plain")
        frame = codec.encode_stream_response(response)
        assert port_wire.split_stream_frame(frame) == ref_wire.split_stream_frame(frame)
        error = codec.encode_stream_error("bad", "id7")
        assert port_wire.split_stream_frame(error) == ref_wire.split_stream_frame(error)


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------


class _Servers:
    def __init__(self):
        from client_tpu.server.native_frontend import native_available
        from client_tpu.testing import InProcessServer as RefServer
        from client_tpu_torch.testing import InProcessServer

        self.port = InProcessServer(device="cpu", grpc=True).start()
        self.ref_aio = RefServer(grpc="aio").start()
        self.ref_native = RefServer(grpc="native").start() if native_available() else None

    def url(self, which):
        server = getattr(self, which)
        if server is None:
            pytest.skip("the reference's native front-end is not built here")
        return server.grpc_url

    def stop(self):
        for server in (self.port, self.ref_aio, self.ref_native):
            if server is not None:
                server.stop()


@pytest.fixture(scope="module")
def servers():
    s = _Servers()
    yield s
    s.stop()


class _Aio:
    """Drives an aio client module synchronously on a loop of its own."""

    def __init__(self, module, url):
        self.module = module
        self.loop = asyncio.new_event_loop()
        self.client = self.loop.run_until_complete(self._make(url))

    async def _make(self, url):
        return self.module.InferenceServerClient(url)

    def __getattr__(self, name):
        attr = getattr(self.client, name)
        if asyncio.iscoroutinefunction(attr):
            return lambda *a, **k: self.loop.run_until_complete(attr(*a, **k))
        return attr

    def stream(self, requests, count):
        async def run():
            async def gen():
                for r in requests:
                    yield r
            out = []
            iterator = self.client.stream_infer(gen())
            async for result, error in iterator:
                out.append((result, error))
                if len(out) == count:
                    break
            iterator.cancel()
            return out

        return self.loop.run_until_complete(asyncio.wait_for(run(), 30))

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


class _Sync:
    def __init__(self, module, url):
        self.module = module
        self.client = module.InferenceServerClient(url)

    def __getattr__(self, name):
        return getattr(self.client, name)

    def stream(self, requests, count):
        out = []
        done = threading.Event()

        def callback(result, error):
            out.append((result, error))
            if len(out) >= count:
                done.set()

        self.client.start_stream(callback)
        for r in requests:
            self.client.async_stream_infer(**r)
        assert done.wait(30), out
        self.client.stop_stream()
        return out[:count]

    def close(self):
        self.client.close()


def _client(kind, package, url):
    module = {("sync", "ref"): ref_grpc, ("aio", "ref"): ref_grpc_aio,
              ("sync", "port"): port_grpc, ("aio", "port"): port_grpc_aio}[(kind, package)]
    return (_Sync if kind == "sync" else _Aio)(module, url)


def _inputs(client, pairs):
    tensors = []
    for name, arr, datatype in pairs:
        t = client.module.InferInput(name, list(arr.shape), datatype)
        t.set_data_from_numpy(arr)
        tensors.append(t)
    return tensors


def _status(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the answer
        status = e.status() if hasattr(e, "status") else type(e).__name__
        return ("error", str(status).rsplit(".", 1)[-1])
    return ("ok",)


def _norm(doc):
    """A json answer with what differs by package alone left out."""
    if isinstance(doc, dict):
        return {k: _norm(v) for k, v in doc.items()
                if k not in ("platform", "backend", "ns", "last_inference")}
    if isinstance(doc, list):
        return [_norm(v) for v in doc]
    return doc


SIMPLE_A = np.arange(16, dtype=np.int32)[None]
SIMPLE_B = np.full([1, 16], 3, dtype=np.int32)


def scenario_health(c, tag):
    return [c.is_server_live(), c.is_server_ready(), c.is_model_ready("simple"),
            c.is_model_ready("nope")]


def scenario_metadata(c, tag):
    return [_norm(c.get_model_metadata(m, as_json=True)) for m in ("simple", "identity_fp32")]


def scenario_config(c, tag):
    return [_norm(c.get_model_config(m, as_json=True))
            for m in ("simple", "identity_fp32", "repeat_int32", "add_sub_chain")]


def scenario_index(c, tag):
    entries = c.get_model_repository_index(as_json=True)["models"]
    wanted = {"simple", "identity_fp32", "identity_bytes", "repeat_int32"}
    return sorted((e["name"], e.get("state")) for e in entries if e["name"] in wanted)


def scenario_load_unload(c, tag):
    seen = []
    c.unload_model("identity_bytes")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        states = {e["name"]: (e.get("state"), e.get("reason"))
                  for e in c.get_model_repository_index(as_json=True)["models"]}
        if states["identity_bytes"][0] == "UNAVAILABLE":
            break
        time.sleep(0.05)
    seen.append(states["identity_bytes"])
    seen.append(c.is_model_ready("identity_bytes"))
    c.load_model("identity_bytes")
    seen.append(c.is_model_ready("identity_bytes"))
    return seen


def scenario_statistics(c, tag):
    for _ in range(2):
        c.infer("simple", _inputs(c, [("INPUT0", SIMPLE_A, "INT32"),
                                      ("INPUT1", SIMPLE_B, "INT32")]))
    doc = c.get_inference_statistics("simple", as_json=True)["model_stats"][0]
    return [sorted(doc), sorted(doc["inference_stats"]), int(doc["inference_count"]) >= 2]


def scenario_system_shm(c, tag):
    key = f"/grpc_sys_{uuid.uuid4().hex[:10]}"
    region = shm.create_shared_memory_region("sysregion", key, 64)
    try:
        c.register_system_shared_memory("sysregion", key, 64)
        status = c.get_system_shared_memory_status(as_json=True)
        status = {k: {f: (v if f != "key" else "KEY") for f, v in d.items()}
                  for k, d in status.get("regions", {}).items()}
        c.unregister_system_shared_memory("sysregion")
        return [status, c.get_system_shared_memory_status(as_json=True)]
    finally:
        shm.destroy_shared_memory_region(region)


def scenario_tpu_shm_infer(c, tag):
    """``identity_fp32`` at 1 MiB through TPU regions both ways, and the
    status of the regions."""
    x = np.random.default_rng(0).normal(size=[1, 1 << 18]).astype(np.float32)
    name_in, name_out = f"in_{uuid.uuid4().hex[:8]}", f"out_{uuid.uuid4().hex[:8]}"
    r_in = tpushm.create_shared_memory_region(name_in, x.nbytes)
    r_out = tpushm.create_shared_memory_region(name_out, x.nbytes)
    try:
        tpushm.set_shared_memory_region(r_in, [x])
        c.register_tpu_shared_memory(name_in, tpushm.get_raw_handle(r_in), 0, x.nbytes)
        c.register_tpu_shared_memory(name_out, tpushm.get_raw_handle(r_out), 0, x.nbytes)
        status = c.get_tpu_shared_memory_status(name_in, as_json=True)
        status = {k: {f: v for f, v in d.items() if f not in ("key", "name")}
                  for k, d in status.get("regions", {}).items()}
        inp = c.module.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_shared_memory(name_in, x.nbytes)
        out = c.module.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(name_out, x.nbytes)
        result = c.infer("identity_fp32", [inp], outputs=[out])
        got = tpushm.get_contents_as_numpy(r_out, "FP32", list(x.shape))
        answer = [len(status), result.as_numpy("OUTPUT0") is None,
                  bool(np.array_equal(got, x)),
                  sorted(_norm(result.get_output("OUTPUT0", as_json=True))["parameters"])]
        c.unregister_tpu_shared_memory(name_in)
        c.unregister_tpu_shared_memory(name_out)
        return answer + [c.get_tpu_shared_memory_status(as_json=True)]
    finally:
        tpushm.destroy_shared_memory_region(r_in)
        tpushm.destroy_shared_memory_region(r_out)


def scenario_cuda_shm(c, tag):
    return [c.get_cuda_shared_memory_status(as_json=True),
            _status(lambda: c.register_cuda_shared_memory("r", b"h", 0, 8))]


def scenario_trace_log(c, tag):
    updated = c.update_trace_settings(settings={"trace_rate": "7"}, as_json=True)
    cleared = c.update_trace_settings(settings={"trace_rate": None}, as_json=True)
    log = c.update_log_settings({"log_verbose_level": 0}, as_json=True)
    return [updated, cleared, log, c.get_log_settings(as_json=True)]


def scenario_infer(c, tag):
    result = c.infer("simple", _inputs(c, [("INPUT0", SIMPLE_A, "INT32"),
                                           ("INPUT1", SIMPLE_B, "INT32")]),
                     request_id="req-1")
    out = [result.as_numpy("OUTPUT0").tolist(), result.as_numpy("OUTPUT1").tolist(),
           _norm(result.get_response(as_json=True))["id"]]
    words = np.array([b"a", b"\x00bc", b""], dtype=np.object_)
    result = c.infer("identity_bytes", _inputs(c, [("INPUT0", words, "BYTES")]))
    out.append(result.as_numpy("OUTPUT0").tolist())
    x = np.random.default_rng(1).normal(size=[1, 1 << 20]).astype(np.float32)
    result = c.infer("identity_fp32", _inputs(c, [("INPUT0", x, "FP32")]))
    out.append(bool(np.array_equal(result.as_numpy("OUTPUT0"), x)))
    result = c.infer("identity_fp32", _inputs(c, [("INPUT0", x[:, :1000], "FP32")]),
                     compression_algorithm="gzip")
    out.append(bool(np.array_equal(result.as_numpy("OUTPUT0"), x[:, :1000])))
    result = c.infer("identity_fp32", _inputs(c, [("INPUT0", x[:, :1000], "FP32")]),
                     compression_algorithm="deflate")
    out.append(bool(np.array_equal(result.as_numpy("OUTPUT0"), x[:, :1000])))
    return out


def scenario_errors(c, tag):
    good = [("INPUT0", SIMPLE_A, "INT32"), ("INPUT1", SIMPLE_B, "INT32")]
    return [
        _status(lambda: c.infer("nope", _inputs(c, good))),
        _status(lambda: c.infer("simple", _inputs(c, good[:1]))),
        _status(lambda: c.infer("repeat_int32", _inputs(c, [
            ("IN", np.array([1], np.int32), "INT32")]))),
        _status(lambda: c.infer("identity_fp32", _inputs(c, [
            ("INPUT0", np.zeros([1, 2], np.float32), "FP32")]), outputs=[
                c.module.InferRequestedOutput("NOPE")])),
        _status(lambda: c.get_model_metadata("nope")),
        _status(lambda: c.get_model_config("nope")),
        _status(lambda: c.unregister_system_shared_memory("never-registered")),
    ]


def scenario_stream(c, tag):
    requests = [
        {"model_name": "repeat_int32",
         "inputs": _inputs(c, [("IN", np.array([5, 6, 7], np.int32), "INT32")])},
        {"model_name": "simple", "request_id": "s1",
         "inputs": _inputs(c, [("INPUT0", SIMPLE_A, "INT32"), ("INPUT1", SIMPLE_B, "INT32")])},
        {"model_name": "nope", "request_id": "bad",
         "inputs": _inputs(c, [("INPUT0", SIMPLE_A, "INT32")])},
    ]
    answers = []
    for result, error in c.stream(requests, 5):
        if error is not None:
            answers.append(("error", "not found" in str(error).lower()))
        else:
            response = result.get_response(as_json=True)
            answers.append(("ok", response.get("id", ""),
                            [result.as_numpy(o["name"]).tolist()
                             for o in response.get("outputs", [])],
                            response.get("parameters", {})))
    # the reference's grpc.aio server runs a stream's requests one after
    # another, its native front-end (and the port's) concurrently: the
    # requests' responses may interleave, each request's keep their order
    return sorted(answers, key=repr)


SERVER_SCENARIOS = {
    "health": scenario_health, "metadata": scenario_metadata, "config": scenario_config,
    "index": scenario_index, "load_unload": scenario_load_unload,
    "statistics": scenario_statistics, "system_shm": scenario_system_shm,
    "tpu_shm_infer": scenario_tpu_shm_infer, "cuda_shm": scenario_cuda_shm,
    "trace_log": scenario_trace_log, "infer": scenario_infer, "errors": scenario_errors,
    "stream": scenario_stream,
}


def _run(kind, package, url, name):
    client = _client(kind, package, url)
    try:
        return SERVER_SCENARIOS[name](client, package)
    finally:
        client.close()


# the reference's aio client has no trace, log or CUDA shared-memory methods
_AIO_LACKS = ("trace_log", "cuda_shm")
CLIENT_CASES = [(name, kind) for name in sorted(SERVER_SCENARIOS) for kind in ("sync", "aio")
                if not (kind == "aio" and name in _AIO_LACKS)]


@pytest.mark.parametrize("name,kind", CLIENT_CASES)
def test_reference_clients_against_the_port_front_end(name, kind, servers):
    """A reference grpcio client gets from the port's native front-end the
    answer it gets from the reference's grpc.aio server."""
    ours = _run(kind, "ref", servers.url("port"), name)
    theirs = _run(kind, "ref", servers.url("ref_aio"), name)
    assert ours == theirs


@pytest.mark.parametrize("server", ["ref_aio", "ref_native", "port"])
@pytest.mark.parametrize("name,kind", CLIENT_CASES)
def test_port_clients_against_each_server(name, kind, server, servers):
    """The port's client gets from a server the answer the reference's
    grpcio client gets from the same server."""
    url = servers.url(server)
    assert _run(kind, "port", url, name) == _run(kind, "ref", url, name)


@pytest.mark.parametrize("case", ["unknown_method", "malformed_message", "unknown_service"])
def test_front_end_refusals_match_the_reference(case, servers):
    """Raw calls the clients never make, answered as the reference's
    grpc.aio server answers them."""
    import grpc

    def call(url):
        with grpc.insecure_channel(url) as channel:
            path = {"unknown_method": "/inference.GRPCInferenceService/Nope",
                    "malformed_message": "/inference.GRPCInferenceService/ModelInfer",
                    "unknown_service": "/other.Service/ModelInfer"}[case]
            payload = b"\xff\xff\xff" if case == "malformed_message" else b""
            try:
                channel.unary_unary(path)(payload, timeout=10)
            except grpc.RpcError as e:
                return e.code()
            return grpc.StatusCode.OK

    ours, theirs = call(servers.url("port")), call(servers.url("ref_aio"))
    assert ours == theirs and ours != grpc.StatusCode.OK


def test_deadline_from_grpc_timeout(servers, tmp_path):
    """A call whose ``grpc-timeout`` passes while its request executes
    ends DEADLINE_EXCEEDED (client and server agree), and the server
    serves the next call."""
    from client_tpu_torch.server.models import IdentityModel

    class Slow(IdentityModel):
        def execute(self, inputs, parameters):
            time.sleep(0.6)
            return super().execute(inputs, parameters)

    servers.port.core.repository.add_model(Slow("slow_fp32", "FP32", device="cpu"))
    x = np.ones([1, 4], np.float32)
    for module in (ref_grpc, port_grpc):
        client = module.InferenceServerClient(servers.url("port"))
        try:
            inp = module.InferInput("INPUT0", [1, 4], "FP32")
            inp.set_data_from_numpy(x)
            with pytest.raises(Exception) as info:
                client.infer("slow_fp32", [inp], client_timeout=0.2)
            assert "DEADLINE_EXCEEDED" in str(info.value.status())
            assert np.array_equal(client.infer("slow_fp32", [inp]).as_numpy("OUTPUT0"), x)
        finally:
            client.close()


# ---------------------------------------------------------------------------
# no head-of-line blocking
# ---------------------------------------------------------------------------


def test_a_held_request_does_not_block_another_model(servers):
    """A request held 1.5 s on one model; meanwhile ``simple`` answers
    over gRPC, every answer well inside the hold (the reference's one
    pump thread would hold them all)."""
    from client_tpu_torch.server.models import IdentityModel

    class Hold(IdentityModel):
        def execute(self, inputs, parameters):
            time.sleep(float(parameters.get("hold_s", 0)))
            return super().execute(inputs, parameters)

    servers.port.core.repository.add_model(Hold("hold_fp32", "FP32", device="cpu"))
    url = servers.url("port")
    held = {}

    def hold():
        client = port_grpc.InferenceServerClient(url)
        inp = port_grpc.InferInput("INPUT0", [1, 4], "FP32")
        inp.set_data_from_numpy(np.ones([1, 4], np.float32))
        t0 = time.monotonic()
        client.infer("hold_fp32", [inp], parameters={"hold_s": 1.5})
        held["s"] = time.monotonic() - t0
        client.close()

    thread = threading.Thread(target=hold)
    thread.start()
    time.sleep(0.2)
    client = port_grpc.InferenceServerClient(url)
    latencies = []
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end:
        t0 = time.monotonic()
        a = port_grpc.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(SIMPLE_A)
        b = port_grpc.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(SIMPLE_B)
        result = client.infer("simple", [a, b])
        latencies.append(time.monotonic() - t0)
        assert np.array_equal(result.as_numpy("OUTPUT0"), SIMPLE_A + SIMPLE_B)
    client.close()
    thread.join()
    assert held["s"] >= 1.5
    assert len(latencies) >= 5 and max(latencies) < 0.5, latencies


# ---------------------------------------------------------------------------
# the LLM engine over the port's gRPC
# ---------------------------------------------------------------------------


def test_llm_engine_streams_over_grpc_and_a_cancel_frees_its_blocks():
    import jax
    import jax.numpy as jnp
    import torch

    from client_tpu.models import llama as jax_llama
    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.models import llama
    from client_tpu_torch.testing import InProcessServer

    jax_config = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, jax_config))(
        jax.random.PRNGKey(0))
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8]]
    tokens = 8
    expected = [np.asarray(jax_llama.generate(jax_params, np.array([p], dtype=np.int32),
                                              jax_config, tokens))[0].tolist()
                for p in prompts]
    model = LlmEngineModel(
        config=llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32),
        params=llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu"),
        engine_config=EngineConfig(block_size=8, num_blocks=1 + 8 * 8, max_active=8,
                                   max_queue=32, max_seq_len=64), device="cpu")
    server = InProcessServer(device="cpu", builtin_models=False, grpc=True)
    server.core.repository.add_model(model)
    server.start()

    async def run():
        client = port_grpc_aio.InferenceServerClient(server.grpc_url)

        async def stream(prompt, max_tokens, cancel_after=None):
            inp = port_grpc_aio.InferInput("INPUT_IDS", [len(prompt)], "INT32")
            inp.set_data_from_numpy(np.array(prompt, np.int32))

            async def gen():
                yield {"model_name": "llm_engine", "inputs": [inp],
                       "parameters": {"max_tokens": max_tokens}}

            out = []
            iterator = client.stream_infer(gen())
            async for result, error in iterator:
                assert error is None, error
                ids = result.as_numpy("OUTPUT_IDS")
                if ids is not None:
                    out.extend(int(v) for v in ids.reshape(-1))
                if cancel_after is not None and len(out) >= cancel_after:
                    iterator.cancel()
                    break
                if result.get_response().parameters.get("triton_final_response") is not None \
                        and result.get_response().parameters[
                            "triton_final_response"].bool_param:
                    break
            return out

        got = await asyncio.gather(*(stream(p, tokens) for p in prompts))
        cut = await stream(prompts[0], 40, cancel_after=2)
        await client.close()
        return got, cut

    try:
        got, cut = asyncio.run(run())
        engine = model.engine
        deadline = time.monotonic() + 10
        while engine.allocator.blocks_in_use and time.monotonic() < deadline:
            time.sleep(0.05)
        in_use = engine.allocator.blocks_in_use
    finally:
        server.stop()
    assert got == expected
    assert cut[:2] == expected[0][:2] and len(cut) < 40
    assert in_use == 0


# ---------------------------------------------------------------------------
# the server CLI, the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,needle,code", [
    (["--grpc-frontend", "aio"], "Not to port", 2),
    (["--grpc-tls-cert", "c.pem", "--grpc-tls-key", "k.pem"], "c.pem", 1),
])
def test_server_cli_refuses_unported_grpc_flags(flags, needle, code):
    """``--grpc-frontend aio`` is refused (the grpc.aio server is not to
    be ported); the TLS flags are served now, so a certificate that does
    not exist stops the server, its log naming the file."""
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.server", "--device", "cpu", "--grpc-port", "0",
         "--http-port", "0", *flags], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == code and needle in proc.stderr, proc.stderr


@pytest.mark.parametrize("shm_kind", ["none", "system", "shm_tpu"])
def test_perf_harness_over_grpc(shm_kind, servers, capsys):
    from client_tpu_torch.perf import cli

    url = servers.url("port")
    code = cli.main(["-m", "simple", "-u", url, "-i", "grpc", "--concurrency-range", "2",
                     "--shared-memory", shm_kind.replace("shm_", ""),
                     "--measurement-interval", "200", "--stability-percentage", "100",
                     "--max-trials", "2", "--json-summary"])
    out = capsys.readouterr().out
    assert code == 0, out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["errors"] == 0 and summary["count"] > 0
    assert servers.port.core.shm.status("system") == {}
    assert servers.port.core.shm.status("tpu") == {}


def test_server_cli_serves_grpc(tmp_path):
    """``python -m client_tpu_torch.server --grpc-port 0`` says where it
    serves gRPC in its ``server_started`` record (``grpc_frontend``
    ``native``), as the reference's does, and answers there."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--device", "cpu", "--http-port", "0",
         "--grpc-port", "0", "--host", "127.0.0.1"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            if '"server_started"' in line:
                started = json.loads(line)
                assert started["grpc_frontend"] == "native"
                port = started["grpc_port"]
                break
        assert port is not None
        client = port_grpc.InferenceServerClient(f"127.0.0.1:{port}")
        assert client.is_server_ready() and client.is_model_ready("simple")
        client.close()
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0


# ---------------------------------------------------------------------------
# the transport's pieces
# ---------------------------------------------------------------------------


def test_hpack_decodes_rfc7541_huffman_examples():
    """RFC 7541 C.4: three requests with Huffman strings through one
    decoder (its dynamic table carries over)."""
    decoder = _h2.HpackDecoder()
    blocks = [
        "828684418cf1e3c2e5f23a6ba0ab90f4ff",
        "828684be5886a8eb10649cbf",
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
    ]
    want = [
        [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com")],
        [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com"), ("cache-control", "no-cache")],
        [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         (":authority", "www.example.com"), ("custom-key", "custom-value")],
    ]
    for block, headers in zip(blocks, want):
        assert decoder.decode(bytes.fromhex(block)) == headers


def _huffman_encode(data: bytes) -> bytes:
    """RFC 7541 Huffman coding on the tables ``_h2`` read from the C++
    header, with EOS-prefix padding."""
    acc = bits = 0
    for b in data:
        acc = (acc << _h2._HUFFMAN_LENGTHS[b]) | _h2._HUFFMAN_CODES[b]
        bits += _h2._HUFFMAN_LENGTHS[b]
    pad = (-bits) % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((bits + pad) // 8, "big")


@pytest.mark.parametrize("text", [b"", b"a", b"www.example.com", bytes(range(256)),
                                  b"grpc-status", b"%\x00\xff~"])
def test_huffman_round_trips_on_the_cxx_tables(text):
    assert _h2.huffman_decode(_huffman_encode(text)) == text


def test_hpack_literals_decode_as_sent():
    headers = [(":path", "/inference.GRPCInferenceService/ModelInfer"),
               ("grpc-timeout", "200m"), ("x-long", "v" * 300)]
    assert _h2.HpackDecoder().decode(_h2.hpack_encode(headers)) == headers


@pytest.mark.parametrize("seconds,want", [(0.2, "200000u"), (1.5, "1500000u"),
                                          (150.0, "150000m"), (1e6, "1000000S")])
def test_grpc_timeout_header(seconds, want):
    assert _h2.grpc_timeout(seconds) == want


def test_front_end_builds_once_under_its_lock(tmp_path, monkeypatch):
    """Two processes reach the first build at once: one compiles, the
    other waits on the lock and loads the same library."""
    from client_tpu_torch import frontend_build

    script = (
        "import sys, pathlib\n"
        "from client_tpu_torch import frontend_build as fb\n"
        f"fb.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "print(fb.build())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    built = list(tmp_path.glob("grpc_frontend-*.so"))
    assert [str(p) for p in built] == list(paths)
    assert not list(tmp_path.glob("*.tmp"))
    assert frontend_build.library_path().name == built[0].name


# ---------------------------------------------------------------------------
# ServerCore.infer_direct against the reference's
# ---------------------------------------------------------------------------


def _direct_run(package):
    """The same mixed batch through one package's ``infer_direct``: four
    ``simple`` requests (one execution between them), an unbatched
    identity, an unknown model, a decoupled model, and a ``simple``
    request of another shape (neither package checks ``simple``'s
    declared shape: it runs as an execution of its own)."""
    if package == "port":
        from client_tpu_torch.server import _grpc_codec as codec
        from client_tpu_torch.server import core as core_mod
        from client_tpu_torch.server.model_repository import ModelRepository
        from client_tpu_torch.server.models import register_builtin_models

        repository = ModelRepository()
        register_builtin_models(repository, device="cpu")
        core = core_mod.ServerCore(repository, device="cpu")
    else:
        from client_tpu.server import _grpc_codec as codec
        from client_tpu.server import core as core_mod
        from client_tpu.server.model_repository import ModelRepository
        from client_tpu.server.models import register_builtin_models

        repository = ModelRepository()
        register_builtin_models(repository)
        core = core_mod.ServerCore(repository)
    T, R = core_mod.CoreTensor, core_mod.CoreRequest
    requests = []
    for i in range(4):
        a = np.full([1, 16], i, np.int32)
        requests.append(R("simple", id=f"s{i}", inputs=[T("INPUT0", "INT32", [1, 16], a),
                                                        T("INPUT1", "INT32", [1, 16], a)]))
    x = np.arange(6, dtype=np.float32)
    requests.append(R("identity_fp32", inputs=[T("INPUT0", "FP32", [6], x)]))
    requests.append(R("nope", inputs=[T("INPUT0", "FP32", [6], x)]))
    requests.append(R("repeat_int32", inputs=[T("IN", "INT32", [1], np.ones(1, np.int32))]))
    bad = np.zeros([1, 15], np.int32)
    requests.append(R("simple", inputs=[T("INPUT0", "INT32", [1, 15], bad),
                                        T("INPUT1", "INT32", [1, 15], bad)]))
    try:
        results = core.infer_direct(requests)
        answers = []
        for result in results:
            if isinstance(result, Exception):
                message = result.message() if hasattr(result, "message") else str(result)
                answers.append(("error", codec.status_code_for(message, exc=result)))
            else:
                answers.append(("ok", result.id, {t.name: np.asarray(t.data).tolist()
                                                  for t in result.outputs}))
        stats = {}
        for name in ("simple", "identity_fp32"):
            snap = core.statistics(name)["model_stats"][0]
            stats[name] = (snap["inference_count"], snap["execution_count"],
                           snap["inference_stats"]["success"]["count"],
                           snap["inference_stats"]["fail"]["count"])
        return answers, stats
    finally:
        core.close()


def test_infer_direct_matches_the_reference():
    ours, theirs = _direct_run("port"), _direct_run("ref")
    assert ours == theirs
    answers, stats = ours
    assert [a[0] for a in answers] == ["ok"] * 5 + ["error"] * 2 + ["ok"]
    assert stats["simple"][:2] == (5, 2)  # the four same-shape requests share one


def test_keepalive_pings_are_answered_and_a_silent_peer_is_dropped(servers):
    """``KeepAliveOptions``: PINGs every 50 ms on an idle connection are
    answered by the port's front-end, which goes on serving; a peer that
    never answers is dropped after ``keepalive_timeout_ms`` and the call
    on it fails UNAVAILABLE."""
    options = port_grpc.KeepAliveOptions(keepalive_time_ms=50, keepalive_timeout_ms=200,
                                         keepalive_permit_without_calls=True)
    url = servers.url("port")
    client = port_grpc.InferenceServerClient(url, keepalive_options=options)
    try:
        assert client.is_server_live()
        time.sleep(0.4)
        conn = client._aio_client._channels[url]._conn
        assert conn is not None and not conn.closed
        assert client.is_server_live()
    finally:
        client.close()

    async def silent_peer():
        held = []
        server = await asyncio.start_server(lambda r, w: held.append(w), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        channel = _h2.Channel(f"127.0.0.1:{port}", keepalive=options)
        try:
            with pytest.raises(port_grpc.RpcError) as info:
                await channel.unary_unary("/inference.GRPCInferenceService/ServerLive", b"",
                                          timeout=10)
            return info.value
        finally:
            await channel.close()
            server.close()

    error = asyncio.run(silent_peer())
    assert error.code() == port_grpc.StatusCode.UNAVAILABLE and "keepalive" in error.details()

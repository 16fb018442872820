"""The port's multiplexed persistent stream held to the JAX package's.

``stream_mode=True`` sends every unary infer over one ``ModelStreamInfer``
stream (``client_tpu_torch/grpc/_mux.py``, on the port's own h2c
transport). On the CPU, against the port's native front-end and the
reference's grpc.aio server:

- the port's clients, sync and aio, in stream mode give the answer they
  give unary, and the answer the reference's grpcio clients give in
  stream mode on the same server, for several models and request kinds;
- requests behind one held on the shared stream complete first (out of
  order), on both servers;
- ``_derive_status`` equals the reference's on each message pattern;
- a server stopped under the stream fails the requests in flight with a
  retryable status, never a hang, and the next request opens a new
  stream;
- a caller's ``request_id`` that collides with one in flight is refused;
- the server passes the ``multiplex`` parameter on to the model as the
  reference's native path does (its codec keeps it);
- the harness's ``-i grpc --stream-mode``.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

import client_tpu.grpc as ref_grpc
import client_tpu.grpc.aio as ref_grpc_aio
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
from client_tpu.grpc import _mux as ref_mux
from client_tpu_torch.grpc import _mux as port_mux
from client_tpu_torch.resilience.policy import exception_is_retryable
from client_tpu_torch.utils import InferenceServerException

PACKAGES = {"port": (port_grpc, port_grpc_aio), "ref": (ref_grpc, ref_grpc_aio)}
SIMPLE_A = np.arange(16, dtype=np.int32)[None]
SIMPLE_B = np.full([1, 16], 3, dtype=np.int32)
BIG = np.random.default_rng(11).normal(size=[1 << 20]).astype(np.float32)  # 4 MiB


@pytest.fixture(scope="module")
def servers():
    from client_tpu.testing import InProcessServer as RefServer
    from client_tpu_torch.testing import InProcessServer

    port = InProcessServer(device="cpu", grpc=True).start()
    ref = RefServer(grpc="aio").start()
    yield {"port": port, "ref_aio": ref}
    port.stop()
    ref.stop()


# ---------------------------------------------------------------------------
# one request of each kind, in either package's types
# ---------------------------------------------------------------------------


def _simple_inputs(mod):
    a = mod.InferInput("INPUT0", [1, 16], "INT32")
    a.set_data_from_numpy(SIMPLE_A)
    b = mod.InferInput("INPUT1", [1, 16], "INT32")
    b.set_data_from_numpy(SIMPLE_B)
    return [a, b]


def _case(mod, name):
    """(method, args, kwargs) of one request."""
    if name == "simple":
        return "infer", ("simple", _simple_inputs(mod)), {}
    if name == "simple_one_output":
        return "infer", ("simple", _simple_inputs(mod)), {
            "outputs": [mod.InferRequestedOutput("OUTPUT1")]}
    if name == "identity_fp32_4mib":
        x = mod.InferInput("INPUT0", list(BIG.shape), "FP32")
        x.set_data_from_numpy(BIG)
        return "infer", ("identity_fp32", [x]), {}
    if name == "identity_bytes":
        x = mod.InferInput("INPUT0", [3], "BYTES")
        x.set_data_from_numpy(np.array([b"a", b"", b"mux \x00 bytes"], dtype=np.object_))
        return "infer", ("identity_bytes", [x]), {}
    if name == "parameters":
        x = mod.InferInput("INPUT0", [4], "FP32")
        x.set_data_from_numpy(np.arange(4, dtype=np.float32))
        return "infer", ("identity_fp32", [x]), {"parameters": {"delay_ms": 1}}
    if name == "prepared":
        return "infer_prepared", (), {}
    raise KeyError(name)


def _answer(result):
    response = result.get_response()
    outputs = []
    for out in response.outputs:
        arr = result.as_numpy(out.name)
        data = ([bytes(v) for v in arr.reshape(-1)] if arr.dtype == np.object_
                else arr.tobytes())
        outputs.append((out.name, out.datatype, list(out.shape), data))
    return response.model_name, sorted(outputs)


def _run(package, kind, url, name, stream_mode):
    """The answer one client of ``package`` gets for request ``name``."""
    sync_mod, aio_mod = PACKAGES[package]
    if kind == "sync":
        client = sync_mod.InferenceServerClient(url, stream_mode=stream_mode)
        try:
            method, args, kwargs = _case(sync_mod, name)
            if method == "infer_prepared":
                request = client.prepare_request("simple", _simple_inputs(sync_mod))
                return _answer(client.infer_prepared(request))
            return _answer(getattr(client, method)(*args, **kwargs))
        finally:
            client.close()

    async def go():
        client = aio_mod.InferenceServerClient(url, stream_mode=stream_mode)
        try:
            method, args, kwargs = _case(aio_mod, name)
            if method == "infer_prepared":
                request = client.prepare_request("simple", _simple_inputs(aio_mod))
                return _answer(await client.infer_prepared(request))
            return _answer(await getattr(client, method)(*args, **kwargs))
        finally:
            await client.close()

    return asyncio.run(asyncio.wait_for(go(), 60))


REQUESTS = ["simple", "simple_one_output", "identity_fp32_4mib", "identity_bytes",
            "parameters", "prepared"]


@pytest.mark.parametrize("name", REQUESTS)
@pytest.mark.parametrize("kind", ["sync", "aio"])
@pytest.mark.parametrize("server", ["port", "ref_aio"])
def test_stream_mode_answers_equal_unary_and_the_reference(server, kind, name, servers):
    url = servers[server].grpc_url
    muxed = _run("port", kind, url, name, stream_mode=True)
    assert muxed == _run("port", kind, url, name, stream_mode=False)
    assert muxed == _run("ref", kind, url, name, stream_mode=True)


# ---------------------------------------------------------------------------
# out-of-order completion behind a held request
# ---------------------------------------------------------------------------


def _held_inputs(mod):
    x = mod.InferInput("INPUT0", [4], "FP32")
    x.set_data_from_numpy(np.ones([4], np.float32))
    return [x]


@pytest.mark.parametrize("package", ["port", "ref"])
@pytest.mark.parametrize("kind", ["sync", "aio"])
@pytest.mark.parametrize("server", ["port", "ref_aio"])
def test_requests_behind_a_held_one_complete_first(server, kind, package, servers):
    """One request held 1.5 s on the shared stream, then five ``simple``
    requests: the five answer first, exactly, each well inside the hold."""
    url = servers[server].grpc_url
    sync_mod, aio_mod = PACKAGES[package]
    done = []  # (label, seconds from its send)
    hold = {"parameters": {"delay_ms": 1500}}

    if kind == "sync":
        client = sync_mod.InferenceServerClient(url, stream_mode=True)
        client.infer("simple", _simple_inputs(sync_mod))  # the stream is open

        def one(label, model, inputs, kwargs):
            t0 = time.monotonic()
            result = client.infer(model, inputs, **kwargs)
            done.append((label, time.monotonic() - t0, result))

        threads = [threading.Thread(target=one, args=(
            "held", "identity_fp32", _held_inputs(sync_mod), hold))]
        threads[0].start()
        time.sleep(0.2)  # the held request is on the stream
        for i in range(5):
            threads.append(threading.Thread(target=one, args=(
                f"q{i}", "simple", _simple_inputs(sync_mod), {})))
            threads[-1].start()
        for thread in threads:
            thread.join(30)
        streams = 1 if _mux_of(client) is not None else 0
        client.close()
    else:
        async def go():
            client = aio_mod.InferenceServerClient(url, stream_mode=True)
            await client.infer("simple", _simple_inputs(aio_mod))

            async def one(label, model, inputs, kwargs):
                t0 = time.monotonic()
                result = await client.infer(model, inputs, **kwargs)
                done.append((label, time.monotonic() - t0, result))

            held = asyncio.ensure_future(one("held", "identity_fp32", _held_inputs(aio_mod),
                                             hold))
            await asyncio.sleep(0.2)
            await asyncio.gather(held, *(one(f"q{i}", "simple", _simple_inputs(aio_mod), {})
                                         for i in range(5)))
            opened = 1 if client._mux is not None else 0
            await client.close()
            return opened

        streams = asyncio.run(asyncio.wait_for(go(), 60))
    assert streams == 1
    assert [label for label, _, _ in done][-1] == "held"
    assert len(done) == 6
    for label, seconds, result in done:
        if label == "held":
            assert seconds >= 1.5
            continue
        assert seconds < 1.0, done
        assert np.array_equal(result.as_numpy("OUTPUT0"), SIMPLE_A + SIMPLE_B)


# ---------------------------------------------------------------------------
# in-band statuses, teardown, id collisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("message", [
    "inference request queue is full",
    "Request for unknown model: 'x' is not ready",
    "request timed out in queue",
    "server is draining and not accepting new inference requests",
    "model 'm' is UNAVAILABLE: unloaded",
    "Draining: retry elsewhere",
    "unexpected inference output",
    "",
])
def test_derive_status_is_the_references(message):
    assert port_mux._derive_status(message) == ref_mux._derive_status(message)


@pytest.mark.parametrize("kind", ["sync", "aio"])
def test_a_server_stopped_under_the_stream_fails_in_flight_requests_retryably(kind):
    """A request in flight when its server stops fails with a retryable
    status (not a hang, never silently replayed); the next request, to a
    server back on the same port, opens a new stream and succeeds."""
    from client_tpu_torch.testing import InProcessServer

    first = InProcessServer(device="cpu", grpc=True, drain_timeout_s=0.2).start()
    url, grpc_port = first.grpc_url, first.grpc_port
    outcome = {}

    def held(call):
        t0 = time.monotonic()
        try:
            call()
            outcome["error"] = None
        except InferenceServerException as e:
            outcome["error"] = e
        outcome["s"] = time.monotonic() - t0

    if kind == "sync":
        client = port_grpc.InferenceServerClient(url, stream_mode=True)
        client.infer("simple", _simple_inputs(port_grpc))
        thread = threading.Thread(target=held, args=(lambda: client.infer(
            "identity_fp32", _held_inputs(port_grpc), parameters={"delay_ms": 3000}),))
        thread.start()
        time.sleep(0.3)
        first.stop()
        thread.join(20)
        second = InProcessServer(device="cpu", grpc=True, grpc_port=grpc_port).start()
        try:
            again = client.infer("simple", _simple_inputs(port_grpc))
        finally:
            client.close()
            second.stop()
    else:
        loop = asyncio.new_event_loop()
        client = loop.run_until_complete(_make_aio(url))
        loop.run_until_complete(client.infer("simple", _simple_inputs(port_grpc_aio)))
        task = loop.create_task(client.infer(
            "identity_fp32", _held_inputs(port_grpc_aio), parameters={"delay_ms": 3000}))
        loop.run_until_complete(asyncio.sleep(0.3))
        t0 = time.monotonic()
        first.stop()
        try:
            loop.run_until_complete(asyncio.wait_for(task, 20))
            outcome["error"] = None
        except InferenceServerException as e:
            outcome["error"] = e
        outcome["s"] = time.monotonic() - t0
        second = InProcessServer(device="cpu", grpc=True, grpc_port=grpc_port).start()
        try:
            again = loop.run_until_complete(
                client.infer("simple", _simple_inputs(port_grpc_aio)))
        finally:
            loop.run_until_complete(client.close())
            loop.close()
            second.stop()
    error = outcome["error"]
    assert error is not None and outcome["s"] < 10
    assert exception_is_retryable(error), (error.status(), error.message())
    assert np.array_equal(again.as_numpy("OUTPUT0"), SIMPLE_A + SIMPLE_B)


async def _make_aio(url):
    return port_grpc_aio.InferenceServerClient(url, stream_mode=True)


def _mux_of(client):
    """The client's multiplexer: the port's blocking client runs its aio
    client's on its loop; the reference's sync client has its own."""
    return getattr(client, "_aio_client", client)._mux


def _in_flight(client, rid, timeout_s=10.0):
    """Until the client's multiplexer holds ``rid`` as in flight."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        mux = _mux_of(client)
        if mux is not None and rid in mux._pending:
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("kind", ["sync", "aio"])
def test_a_request_id_in_flight_is_refused(kind, servers):
    url = servers["port"].grpc_url
    hold = {"parameters": {"delay_ms": 800}, "request_id": "same"}
    if kind == "sync":
        client = port_grpc.InferenceServerClient(url, stream_mode=True)
        results = []
        thread = threading.Thread(target=lambda: results.append(client.infer(
            "identity_fp32", _held_inputs(port_grpc), **hold)))
        thread.start()
        assert _in_flight(client, "same")
        with pytest.raises(InferenceServerException, match="already in flight") as info:
            client.infer("simple", _simple_inputs(port_grpc), request_id="same")
        thread.join(20)
        client.close()
        assert results and results[0].get_response().id == "same"
    else:
        async def go():
            client = port_grpc_aio.InferenceServerClient(url, stream_mode=True)
            first = asyncio.ensure_future(client.infer(
                "identity_fp32", _held_inputs(port_grpc_aio), **hold))
            while client._mux is None or "same" not in client._mux._pending:
                await asyncio.sleep(0.01)
            try:
                with pytest.raises(InferenceServerException, match="already in flight") as e:
                    await client.infer("simple", _simple_inputs(port_grpc_aio),
                                       request_id="same")
                return e, await first
            finally:
                await client.close()

        info, result = asyncio.run(asyncio.wait_for(go(), 60))
        assert result.get_response().id == "same"
    assert info.value.status() == "StatusCode.INVALID_ARGUMENT"


def test_multiplex_reaches_the_model_as_on_the_reference_native_path():
    """The reference's native front-end hands a stream request's
    parameters on to the model as they are: only its grpc.aio servicer
    pops ``multiplex``. A request the mux built (byte-equal in both
    packages) decodes through the port's codec, which its front-end
    uses, to the parameters the reference's codec gives, ``multiplex``
    kept."""
    from client_tpu.server import _grpc_codec as ref_codec
    from client_tpu.server.core import ServerCore as RefCore
    from client_tpu.server.model_repository import ModelRepository as RefRepository
    from client_tpu_torch.server import _grpc_codec as port_codec
    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.model_repository import ModelRepository

    built = port_mux._FastRequestBuilder().build(
        "simple", _simple_inputs(port_grpc), "", "mx7", None,
        {"multiplex": True, "k": 3})
    assert built == ref_mux._FastRequestBuilder().build(
        "simple", _simple_inputs(ref_grpc), "", "mx7", None, {"multiplex": True, "k": 3})
    port_core, ref_core = ServerCore(ModelRepository(), device="cpu"), RefCore(RefRepository())
    try:
        ours = port_codec.FastInferCodec(port_core).decode_infer(built)
        theirs = ref_codec.FastInferCodec(ref_core).decode_request(built)
    finally:
        port_core.close()
        ref_core.close()
    assert ours.id == theirs.id == "mx7"
    assert ours.parameters == theirs.parameters == {"multiplex": True, "k": 3}


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["simple", "identity_fp32"])
def test_perf_harness_stream_mode(model, servers, capsys):
    from client_tpu_torch.perf import cli

    server = servers["port"]
    before = server.core.statistics(model)["model_stats"][0]["inference_stats"][
        "success"]["count"]
    args = ["-m", model, "-u", server.grpc_url, "-i", "grpc", "--stream-mode",
            "--concurrency-range", "4", "--measurement-interval", "200",
            "--stability-percentage", "100", "--max-trials", "2", "--json-summary"]
    if model == "identity_fp32":
        args += ["--shape", "INPUT0:64"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["errors"] == 0 and summary["count"] > 0
    after = server.core.statistics(model)["model_stats"][0]["inference_stats"][
        "success"]["count"]
    assert after - before >= summary["count"]


def test_stream_mode_needs_grpc(capsys):
    from client_tpu_torch.perf import cli

    assert cli.main(["-m", "simple", "-u", "127.0.0.1:9", "--stream-mode"]) == 2
    assert capsys.readouterr().err.strip() == (
        "error: --stream-mode needs the gRPC protocol (-i grpc)")

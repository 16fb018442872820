"""The port's router tier (``client_tpu_torch.router``) held to the reference's.

- The host-only pieces against ``client_tpu.router`` on the same inputs:
  the model table, ``classify``, admission and its shed error, the status
  snapshot and the ``tpu_router_*`` metric families.
- A live router over ``FleetRunner(2, grpc="native", device="cpu")``:
  gRPC unary with the client's own id restored, HTTP proxied, the control
  plane, ``/metrics`` and ``/v2/router/status``; the decoupled
  ``repeat_int32`` stream; a replica stopped under load with no client
  failure; overload shed with ``retry-after`` in the gRPC trailers and
  HTTP 429; the autoscaler's ramp and drain through ``on_scale_out`` and
  ``on_scale_in``; a router process SIGKILLed under clients holding two
  router urls; the tiny fp32 ``llm_engine`` streamed through the router,
  token for token the direct stream's and the reference's dense
  ``generate``.
- The cross pairs: the port's router in front of the reference's
  (grpc.aio) replicas and the reference's router in front of the port's
  (native) replicas give what the replicas give directly.
- A stream the client half-closes right after its request: the port's
  router delivers what the replica delivers directly, ``[7, 8, 9]``. The
  reference's router delivers nothing: its servicer stops reading at the
  half-close and unregisters the request before its frames arrive
  (``client_tpu/router/server.py``, ``ModelStreamInfer``), a recorded
  fault of the reference.
"""

import asyncio
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
import client_tpu_torch.http as port_http
from client_tpu.grpc._generated import grpc_service_pb2 as ref_pb
from client_tpu.grpc._utils import set_parameter
from client_tpu.router import core as ref_core
from client_tpu.utils import InferenceServerException as RefInferenceServerException
from client_tpu_torch.perf import fleet_runner as port_fleet_runner
from client_tpu_torch.router import core as port_core
from client_tpu_torch.utils import InferenceServerException

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_ENV = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def _request(model="simple", rid="", params=None, payload=b"\1\2\3\4"):
    request = ref_pb.ModelInferRequest(model_name=model, id=rid)
    request.inputs.add(name="INPUT0", datatype="INT32", shape=[4])
    request.raw_input_contents.append(payload)
    for key, value in (params or {}).items():
        set_parameter(request.parameters, key, value)
    return request.SerializeToString()


def _cores(**kwargs):
    backends = {"127.0.0.1:1": None, "127.0.0.1:2": "127.0.0.1:3"}
    clock = lambda: 100.0  # noqa: E731 - both cores read one fake clock
    return (port_core.RouterCore(backends, clock=clock, **kwargs),
            ref_core.RouterCore(backends, clock=clock, **kwargs))


# ---------------------------------------------------------------------------
# host-only pieces, function by function against the reference
# ---------------------------------------------------------------------------


def test_model_table_matches_the_reference():
    tables = port_core.ModelTable(), ref_core.ModelTable()
    steps = [
        ("urls_for", "simple"),
        ("set_backend_models", "a:1", ["simple", "other"]),
        ("set_backend_models", "b:2", ["simple"]),
        ("urls_for", "simple"), ("urls_for", "other"), ("urls_for", "never"),
        ("models",), ("snapshot",),
        ("drop_backend", "a:1"),
        ("urls_for", "other"), ("models",), ("snapshot",),
    ]
    for name, *args in steps:
        port, ref = (getattr(table, name)(*args) for table in tables)
        assert port == ref, (name, args)


@pytest.mark.parametrize("case", [
    ("plain", _request()),
    ("priority_and_sequence", _request(params={"priority": 3, "sequence_id": 9})),
    ("protected", _request(params={"priority": 1})),
    ("string_sequence", _request(params={"sequence_id": "s-1"})),
    ("keyed", _request(params={"session": "user-7"})),
    ("other_model", _request(model="identity_fp32", rid="x")),
    ("unparseable", b"\xff\xff\xff"),
    ("empty", b""),
], ids=lambda c: c[0])
@pytest.mark.parametrize("policy", [
    "least_outstanding",
    {"name": "consistent_hash", "key_parameter": "session"},
], ids=["least_outstanding", "consistent_hash"])
def test_classify_matches_the_reference(case, policy):
    from client_tpu.lifecycle.routing import ConsistentHashPolicy as RefHash

    from client_tpu_torch.lifecycle.routing import ConsistentHashPolicy as PortHash

    _name, data = case
    if isinstance(policy, dict):
        port = port_core.RouterCore({"a:1": None, "b:2": None},
                                    routing_policy=PortHash(key_parameter="session"))
        ref = ref_core.RouterCore({"a:1": None, "b:2": None},
                                  routing_policy=RefHash(key_parameter="session"))
    else:
        port, ref = _cores(routing_policy=policy)
    assert port.classify(data) == ref.classify(data)


def test_admission_and_its_shed_error_match_the_reference():
    port, ref = _cores(max_inflight=2, shed_retry_after_s=0.25)
    script = ["admit0", "admit0", "admit0", "admit1", "release", "release", "admit0",
              "admit0", "release", "release", "release", "release", "admit0"]
    for core in (port, ref):
        outcomes = []
        for step in script:
            if step == "release":
                core.release()
                outcomes.append(("release", core._inflight))
                continue
            try:
                core.admit(int(step[-1]))
                outcomes.append(("admitted", core._inflight))
            except (InferenceServerException, RefInferenceServerException) as e:
                outcomes.append(("shed", e.message(), e.status(), e.retry_after_s,
                                 core._inflight))
        core.outcomes = outcomes
    assert port.outcomes == ref.outcomes
    assert any(o[0] == "shed" and "queue full" in o[1] for o in port.outcomes)


def _families(text):
    return sorted(line.split()[2:4] for line in text.splitlines()
                  if line.startswith("# TYPE"))


def test_snapshot_and_metric_families_match_the_reference():
    port, ref = _cores(max_inflight=3)
    for core in (port, ref):
        core.table.set_backend_models("127.0.0.1:1", ["simple"])
        core.admit(0)
        core.m_requests.labels("grpc", "ok").inc()
        core.m_requests.labels("http", "shed").inc()
        core.m_proxy.observe(0.003)
        core.m_retries.inc()
        core.add_backend("127.0.0.1:9", "127.0.0.1:10")
        core.remove_backend("127.0.0.1:2")
    port_snap, ref_snap = port.snapshot(), ref.snapshot()
    assert port_snap.keys() == ref_snap.keys()
    for key in ("models", "inflight", "max_inflight", "backends"):
        assert port_snap[key] == ref_snap[key], key
    assert port_snap["pool"] == ref_snap["pool"]
    port_text, ref_text = port.metrics.render(), ref.metrics.render()
    assert _families(port_text) == _families(ref_text)
    assert {line for line in port_text.splitlines() if line.startswith("tpu_router")} == \
        {line for line in ref_text.splitlines() if line.startswith("tpu_router")}


def test_final_frames_are_read_as_the_server_marks_them():
    from client_tpu_torch.grpc import _wire

    final = ref_pb.ModelInferResponse(model_name="m", id="r1")
    final.parameters["triton_final_response"].bool_param = True
    final.parameters["other"].int64_param = 4
    plain = ref_pb.ModelInferResponse(model_name="m", id="r1")
    plain.raw_output_contents.append(b"\0" * 8)
    assert _wire.response_is_final(final.SerializeToString())
    assert not _wire.response_is_final(plain.SerializeToString())


# ---------------------------------------------------------------------------
# live routers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_fleet():
    with port_fleet_runner.FleetRunner(2, grpc="native", device="cpu") as fleet:
        yield fleet


@pytest.fixture(scope="module")
def ref_fleet():
    from client_tpu.perf.fleet_runner import FleetRunner

    with FleetRunner(2, grpc="aio", http=True) as fleet:
        yield fleet


def _port_router(fleet, **kwargs):
    from client_tpu_torch.router import RouterServer

    return RouterServer(dict(zip(fleet.grpc_urls, fleet.http_urls)),
                        probe_interval_s=0.1, **kwargs)


def _ref_router(fleet, **kwargs):
    from client_tpu.router import RouterServer

    return RouterServer(dict(zip(fleet.grpc_urls, fleet.http_urls)),
                        probe_interval_s=0.1, **kwargs)


@pytest.fixture(scope="module")
def port_router(port_fleet):
    with _port_router(port_fleet) as router:
        yield router


SIXTEEN = np.arange(16, dtype=np.int32).reshape(1, 16)


def _simple_inputs(module):
    a = module.InferInput("INPUT0", [1, 16], "INT32")
    a.set_data_from_numpy(SIXTEEN)
    b = module.InferInput("INPUT1", [1, 16], "INT32")
    b.set_data_from_numpy(SIXTEEN)
    return [a, b]


def _answers(grpc_url, http_url):
    """What one address answers to a fixed script: unary ``simple`` under
    the caller's ids, the decoupled ``repeat_int32`` stream, HTTP
    ``simple``, readiness and metadata."""
    out = {}
    with port_grpc.InferenceServerClient(grpc_url) as client:
        out["ready"] = client.is_server_ready()
        out["model_ready"] = client.is_model_ready("simple")
        out["metadata"] = client.get_model_metadata("simple", as_json=True)
        out["unary"] = []
        for i in range(4):
            result = client.infer("simple", _simple_inputs(port_grpc), request_id=f"my-id-{i}")
            out["unary"].append((result.get_response().id,
                                 result.as_numpy("OUTPUT0").tolist(),
                                 result.as_numpy("OUTPUT1").tolist()))
        frames = queue.Queue()
        client.start_stream(callback=lambda result, error: frames.put((result, error)))
        tensor = port_grpc.InferInput("IN", [3], "INT32")
        tensor.set_data_from_numpy(np.array([7, 8, 9], np.int32))
        client.async_stream_infer("repeat_int32", [tensor], request_id="stream-1")
        seen = []
        while True:
            result, error = frames.get(timeout=10)
            assert error is None, error
            response = result.get_response()
            seen.append((response.id, result.as_numpy("OUT").tolist()))
            final = response.parameters.get("triton_final_response")
            if final is not None and final.bool_param:
                break
        client.stop_stream()
        out["stream"] = seen
    with port_http.InferenceServerClient(http_url) as hc:
        result = hc.infer("simple", _simple_inputs(port_http))
        out["http"] = (result.as_numpy("OUTPUT0").tolist(), result.as_numpy("OUTPUT1").tolist())
    return out


def _direct(fleet):
    return _answers(fleet.grpc_urls[0], fleet.http_urls[0])


@pytest.mark.fleet
def test_router_unary_http_and_control_plane(port_fleet, port_router):
    """One router address in front of two replicas: gRPC unary with the
    client's own request id restored, HTTP inference proxied, and the
    control plane (readiness, metadata, /metrics, /v2/router/status)."""
    got = _answers(port_router.grpc_url, port_router.http_url)
    assert got == _direct(port_fleet)
    assert [u[0] for u in got["unary"]] == [f"my-id-{i}" for i in range(4)]
    assert got["unary"][0][1] == (SIXTEEN + SIXTEEN).tolist()
    base = f"http://{port_router.http_url}"
    status = json.load(urllib.request.urlopen(f"{base}/v2/router/status"))
    assert sorted(status) == ["backends", "inflight", "max_inflight", "models", "pool"]
    assert all("simple" in models for models in status["models"].values())
    assert len(status["pool"]["endpoints"]) == 2
    metrics = urllib.request.urlopen(f"{base}/metrics").read()
    assert b"tpu_router_proxy_seconds" in metrics
    assert b'tpu_router_requests_total{protocol="grpc",outcome="ok"}' in metrics
    assert b'tpu_router_requests_total{protocol="http",outcome="ok"}' in metrics
    assert urllib.request.urlopen(f"{base}/v2/health/live").status == 200
    assert urllib.request.urlopen(f"{base}/v2/health/ready").status == 200
    # a shared-memory RPC is host-local: refused with the reference's words
    with port_grpc.InferenceServerClient(port_router.grpc_url) as client:
        with pytest.raises(InferenceServerException, match="not supported by the router"):
            client.get_system_shared_memory_status()


@pytest.mark.fleet
def test_router_stream_decoupled_roundtrip(port_router):
    """Decoupled streaming through the router: every frame comes back
    with the client's own correlation id, on the one pinned backend."""
    got = _answers(port_router.grpc_url, port_router.http_url)["stream"]
    assert got == [("stream-1", [7]), ("stream-1", [8]), ("stream-1", [9])]


def _half_closed_stream(url):
    """``async_stream_infer`` then ``stop_stream()`` at once: the frames
    the call delivered before it ended. The model waits 100 ms before each
    frame, so the half-close reaches the far end before any frame."""
    frames = []
    with port_grpc.InferenceServerClient(url) as client:
        client.start_stream(callback=lambda result, error: frames.append((result, error)))
        tensor = port_grpc.InferInput("IN", [3], "INT32")
        tensor.set_data_from_numpy(np.array([7, 8, 9], np.int32))
        client.async_stream_infer("repeat_int32", [tensor], request_id="hc-1",
                                  parameters={"delay_us": 100_000})
        client.stop_stream()
    assert all(error is None for _, error in frames)
    return [int(result.as_numpy("OUT")[0]) for result, _ in frames
            if result.as_numpy("OUT") is not None]


@pytest.mark.fleet
@pytest.mark.parametrize("front", ["direct", "port_router", "ref_router"])
def test_a_half_closed_stream_gets_every_frame(front, port_fleet, port_router, ref_fleet):
    """The router is invisible to clients: a stream half-closed right
    after its request gets the frames the replica gives directly. The
    reference's router gives none (its recorded fault: the servicer's
    loop ends at the half-close and unregisters the open request)."""
    if front == "direct":
        assert _half_closed_stream(port_fleet.grpc_urls[0]) == [7, 8, 9]
        assert _half_closed_stream(ref_fleet.grpc_urls[0]) == [7, 8, 9]
    elif front == "port_router":
        assert _half_closed_stream(port_router.grpc_url) == [7, 8, 9]
    else:
        with _ref_router(ref_fleet, http=False) as router:
            assert _half_closed_stream(router.grpc_url) == []


def _stream_frames(url):
    """One ``repeat_int32`` request of ``[7, 8, 9]`` on a stream: its
    values up to the final frame, or the error that ended it."""
    frames = queue.Queue()
    with port_grpc.InferenceServerClient(url) as client:
        client.start_stream(callback=lambda result, error: frames.put((result, error)))
        tensor = port_grpc.InferInput("IN", [3], "INT32")
        tensor.set_data_from_numpy(np.array([7, 8, 9], np.int32))
        client.async_stream_infer("repeat_int32", [tensor], request_id="cfg-1")
        values = []
        while True:
            result, error = frames.get(timeout=10)
            if error is not None:
                client.stop_stream()
                return values, error
            values.append(int(result.as_numpy("OUT")[0]))
            final = result.get_response().parameters.get("triton_final_response")
            if final is not None and final.bool_param:
                client.stop_stream()
                return values, None


@pytest.mark.fleet
@pytest.mark.chaos
@pytest.mark.parametrize("fault", ["slow", "refused", "timed_out"])
def test_a_decoupled_stream_whose_config_lookup_fails(fault, port_fleet, monkeypatch):
    """The router learns whether a model is decoupled from its backends'
    ``ModelConfig``. While the lookup is slow, every frame still arrives;
    while the backend refuses it or lets it time out, the request fails
    with a retryable UNAVAILABLE rather than ending at its first frame,
    and it succeeds whole once the backend answers again."""
    from client_tpu_torch.grpc._mux import _derive_status
    from client_tpu_torch.grpc._utils import RpcError, StatusCode
    from client_tpu_torch.router import backends

    mode = {"now": None}
    real_stub = backends.GRPCInferenceServiceStub

    class FaultyConfigStub(real_stub):
        def __init__(self, channel):
            super().__init__(channel)
            model_config = self.ModelConfig

            async def faulty(request, timeout=None):
                if mode["now"] == "refused":
                    raise RpcError(StatusCode.UNAVAILABLE, "connection refused")
                if mode["now"] == "timed_out":
                    await asyncio.sleep(timeout)
                    raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
                if mode["now"] == "slow":
                    await asyncio.sleep(0.3)
                return await model_config(request, timeout=timeout)

            self.ModelConfig = faulty

    monkeypatch.setattr(backends, "GRPCInferenceServiceStub", FaultyConfigStub)
    monkeypatch.setattr(backends, "CONFIG_TIMEOUT_S", 0.2)
    with _port_router(port_fleet, http=False) as router:
        mode["now"] = fault
        router._loop.call_soon_threadsafe(router.router.decoupled.clear)
        time.sleep(0.05)
        values, error = _stream_frames(router.grpc_url)
        if fault == "slow":
            assert (values, error) == ([7, 8, 9], None)
        else:
            assert values == [] and error is not None
            # an in-band error: the client stack derives its status from
            # the words, as it derives RESOURCE_EXHAUSTED from "queue full"
            assert _derive_status(error.message()) == "StatusCode.UNAVAILABLE", error
            assert "repeat_int32" in error.message()
            mode["now"] = None
            assert _stream_frames(router.grpc_url) == ([7, 8, 9], None)
        assert router.router.decoupled.get("repeat_int32") is True


@pytest.mark.chaos
def test_a_replica_stopped_under_a_stream_fails_it_retryably(caplog):
    """A replica whose gRPC front-end stops under a running stream
    request: the client sees a retryable UNAVAILABLE (what a router or a
    client pool routes around), and the request's task is cancelled, not
    left pending when the server's loop closes."""
    import gc

    from client_tpu_torch.lifecycle.pool import status_is_unavailable
    from client_tpu_torch.testing import InProcessServer

    frames = queue.Queue()
    server = InProcessServer(grpc="native", device="cpu").start()
    with caplog.at_level("ERROR", logger="asyncio"):
        try:
            client = port_grpc.InferenceServerClient(server.grpc_url)
            client.start_stream(callback=lambda result, error: frames.put((result, error)))
            tensor = port_grpc.InferInput("IN", [3], "INT32")
            tensor.set_data_from_numpy(np.array([7, 8, 9], np.int32))
            client.async_stream_infer("repeat_int32", [tensor], request_id="stop-1",
                                      parameters={"delay_us": 2_000_000})
            time.sleep(0.3)
        finally:
            server.stop(drain_timeout_s=0.2)
        result, error = frames.get(timeout=10)
        assert result is None and status_is_unavailable(error.status()), error
        client.stop_stream()
        client.close()
        gc.collect()
    assert not [r for r in caplog.records if "destroyed but it is pending" in r.getMessage()]


def test_the_prober_forgets_a_model_that_leaves_or_joins_an_index():
    """A reload may change a model's transaction policy: the prober
    learns a model anew when it leaves or joins a backend's index."""
    from client_tpu_torch.router.backends import ReadinessProber

    core = port_core.RouterCore({"127.0.0.1:1": None})
    prober = ReadinessProber(core, {})
    asked = []

    class Link:
        async def model_decoupled(self, name):
            asked.append(name)
            return name == "stream"

    async def learn(models):
        await prober._learn_models("127.0.0.1:1", Link(), models)
        return dict(core.decoupled)

    assert asyncio.run(learn(["simple", "stream"])) == {"simple": False, "stream": True}
    assert asyncio.run(learn(["simple", "stream"])) == {"simple": False, "stream": True}
    assert asyncio.run(learn(["simple"])) == {"simple": False}
    assert asyncio.run(learn(["simple", "stream"])) == {"simple": False, "stream": True}
    assert asked == ["simple", "stream", "stream"]


@pytest.mark.fleet
@pytest.mark.parametrize("pair", ["port_router_ref_replicas", "ref_router_port_replicas"])
def test_cross_pairs_answer_as_the_replicas_do(pair, port_fleet, ref_fleet):
    """Either package's router in front of the other's replicas answers
    the script as those replicas answer it directly."""
    if pair == "port_router_ref_replicas":
        fleet, router = ref_fleet, _port_router(ref_fleet)
    else:
        fleet, router = port_fleet, _ref_router(port_fleet)
    with router:
        got = _answers(router.grpc_url, router.http_url)
        status = json.load(urllib.request.urlopen(f"http://{router.http_url}/v2/router/status"))
    assert got == _direct(fleet)
    assert all("simple" in models for models in status["models"].values())


def _device_sim_factory(step_s=0.004, max_batch_size=4, slo=None):
    def factory():
        return port_fleet_runner.DeviceBoundModel(
            step_s=step_s, max_batch_size=max_batch_size, slo=slo)

    return factory


def _sim_fleet(size, **kwargs):
    return port_fleet_runner.FleetRunner(
        size, grpc="native", device="cpu", builtin_models=False,
        model_factories=[_device_sim_factory(**kwargs)])


def _sim_tensor():
    tensor = port_grpc_aio.InferInput("INPUT0", [4], "INT32")
    tensor.set_data_from_numpy(np.ones([4], dtype=np.int32))
    return tensor


@pytest.mark.fleet
@pytest.mark.chaos
def test_router_backend_kill_zero_client_failures():
    """A replica dies mid-run behind the router; the router benches it
    (readiness probe + UNAVAILABLE retry) and every request succeeds."""
    with _sim_fleet(2) as fleet, _port_router(fleet, http=False) as router:

        async def drive():
            stats = {"ok": 0}
            stop = asyncio.Event()
            client = port_grpc_aio.InferenceServerClient(router.grpc_url)

            async def worker():
                while not stop.is_set():
                    await client.infer("device_sim", [_sim_tensor()], client_timeout=10.0)
                    stats["ok"] += 1

            tasks = [asyncio.create_task(worker()) for _ in range(8)]
            await asyncio.sleep(0.4)
            await asyncio.get_running_loop().run_in_executor(None, fleet.stop_replica, 1)
            await asyncio.sleep(0.8)
            stop.set()
            await asyncio.gather(*tasks)  # a failed request propagates
            await client.close()
            return stats

        stats = asyncio.run(drive())
        assert stats["ok"] > 20
        states = {e["url"]: e["state"] for e in router.router.snapshot()["pool"]["endpoints"]}
        assert "down" in states.values() or "ejected" in states.values()


def _post_infer(url, results):
    body = json.dumps({"inputs": [{"name": "INPUT0", "shape": [4], "datatype": "INT32",
                                   "data": [1, 1, 1, 1]}]}).encode()
    request = urllib.request.Request(f"http://{url}/v2/models/device_sim/infer", data=body,
                                     method="POST",
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=10) as response:
            results.append((response.status, None, response.read()))
    except urllib.error.HTTPError as e:
        results.append((e.code, e.headers.get("Retry-After"), e.read()))


@pytest.mark.fleet
@pytest.mark.chaos
@pytest.mark.scheduling
def test_router_overload_sheds_with_retry_after():
    """Past the admission limit the router sheds DEFAULT-priority traffic,
    RESOURCE_EXHAUSTED with ``retry-after`` in the gRPC trailers and 429
    with ``Retry-After`` over HTTP, while the protected tier succeeds."""
    with _sim_fleet(1, step_s=0.05, max_batch_size=1) as fleet, \
            _port_router(fleet, max_inflight=2, shed_retry_after_s=0.25) as router:

        async def drive():
            client = port_grpc_aio.InferenceServerClient(router.grpc_url)

            async def one(priority):
                try:
                    await client.infer("device_sim", [_sim_tensor()], priority=priority,
                                       client_timeout=10.0)
                    return ("ok", None)
                except InferenceServerException as e:
                    return ("shed", e)

            results = await asyncio.gather(*[one(0) for _ in range(8)],
                                           *[one(1) for _ in range(4)])
            await client.close()
            return results[:8], results[8:]

        low, high = asyncio.run(drive())
        assert all(outcome == "ok" for outcome, _ in high), \
            "protected-priority traffic must never be shed"
        shed = [e for outcome, e in low if outcome == "shed"]
        assert shed, "8 defaults against limit 2 must shed some"
        for error in shed:
            assert "RESOURCE_EXHAUSTED" in str(error.status())
            assert error.retry_after_s == 0.25  # from the call's trailers
            assert "queue full" in error.message()

        results = []
        threads = [threading.Thread(target=_post_infer, args=(router.http_url, results))
                   for _ in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=20)
        assert {status for status, _, _ in results} <= {200, 429}
        refused = [(after, body) for status, after, body in results if status == 429]
        assert refused and all(after == "0.25" for after, _ in refused)
        assert "queue full" in json.loads(refused[0][1])["error"]
        metrics = router.router.metrics.render()
        assert 'tpu_router_shed_total{priority="default"}' in metrics
        assert 'tpu_router_requests_total{protocol="http",outcome="shed"}' in metrics


@pytest.mark.fleet
@pytest.mark.chaos
def test_router_autoscale_ramp_and_drain():
    """A traffic ramp saturates one replica's SLO burn, the autoscaler
    grows the fleet (each new replica joins the router through
    ``on_scale_out``), and the light phase drains it back through
    ``on_scale_in``: no client-visible failure throughout."""
    with _sim_fleet(1, step_s=0.01, max_batch_size=1,
                    slo={"latency_target_ms": 35, "availability": 0.9,
                         "window_s": 2.0}) as fleet, \
            _port_router(fleet, http=False) as router:
        scaler = port_fleet_runner.Autoscaler(
            fleet, min_replicas=1, max_replicas=3, burn_high=1.0, burn_low=0.1,
            high_ticks=2, low_ticks=4, interval_s=0.2,
            on_scale_out=lambda server: router.add_backend(server.grpc_url),
            on_scale_in=lambda server: router.remove_backend(server.grpc_url))
        scaler.start()
        phase = {"drivers": 9}
        seen_urls = set()

        async def drive():
            client = port_grpc_aio.InferenceServerClient(router.grpc_url)
            stop = asyncio.Event()

            async def worker(index):
                while not stop.is_set():
                    if index >= phase["drivers"]:
                        await asyncio.sleep(0.05)
                        continue
                    await client.infer("device_sim", [_sim_tensor()], client_timeout=10.0)

            tasks = [asyncio.create_task(worker(i)) for i in range(9)]
            for _ in range(60):  # heavy phase: expect a scale-out
                await asyncio.sleep(0.25)
                seen_urls.update(router.router.pool.urls)
                if fleet.size >= 2:
                    break
            assert fleet.size >= 2, f"ramp never scaled out: {scaler.events}"
            phase["drivers"] = 1  # light phase: expect a drain
            for _ in range(80):
                await asyncio.sleep(0.25)
                if fleet.size <= 1:
                    break
            stop.set()
            await asyncio.gather(*tasks)  # any failure propagates
            await client.close()

        try:
            asyncio.run(drive())
        finally:
            scaler.stop()
        decisions = [event["decision"] for event in scaler.events]
        assert "scale_out" in decisions and "scale_in" in decisions, scaler.events
        assert len(seen_urls) >= 2  # the new replica joined the router's pool
        assert router.router.pool.urls == fleet.grpc_urls


@pytest.mark.fleet
@pytest.mark.chaos
def test_router_process_killed_clients_fail_over(tmp_path):
    """Two router processes (``python -m client_tpu_torch.router --serve``,
    one given ``--backends``, one the replicas' ports files) front one
    fleet; a SIGKILL of one is invisible to a client holding both urls,
    and the last one's death is a prompt error, not a hang."""
    with _sim_fleet(2) as fleet:
        replica_files = []
        for i, server in enumerate(fleet.replicas):
            path = str(tmp_path / f"replica{i}.json")
            port_fleet_runner.write_ports_file(
                path, {"http_port": server.http_port, "grpc_port": server.grpc_port})
            replica_files += ["--replica-ports-file", path]
        sources = [["--backends", ",".join(fleet.grpc_urls)], replica_files]
        paths = [str(tmp_path / f"router{i}.json") for i in (0, 1)]
        routers = [subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.router", "--serve", *source,
             "--ports-file", path, "--probe-interval", "0.1"],
            env=CHILD_ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            for source, path in zip(sources, paths)]
        try:
            urls = []
            for proc, path in zip(routers, paths):
                deadline = time.monotonic() + 60
                ports = None
                while ports is None and time.monotonic() < deadline:
                    assert proc.poll() is None, proc.stderr.read().decode()
                    ports = port_fleet_runner.read_ports_file(path)
                    time.sleep(0.05)
                assert ports is not None
                urls.append(f"127.0.0.1:{ports['grpc_port']}")

            async def drive():
                stats = {"ok": 0}
                stop = asyncio.Event()
                client = port_grpc_aio.InferenceServerClient(",".join(urls))

                async def worker():
                    while not stop.is_set():
                        await client.infer("device_sim", [_sim_tensor()], client_timeout=10.0)
                        stats["ok"] += 1

                tasks = [asyncio.create_task(worker()) for _ in range(6)]
                await asyncio.sleep(0.4)
                routers[0].send_signal(signal.SIGKILL)
                await asyncio.sleep(0.8)
                stop.set()
                await asyncio.gather(*tasks)  # failures propagate
                await client.close()
                routers[1].send_signal(signal.SIGKILL)
                routers[1].wait(timeout=10)
                solo = port_grpc_aio.InferenceServerClient(urls[1])
                with pytest.raises(InferenceServerException):
                    await asyncio.wait_for(
                        solo.infer("device_sim", [_sim_tensor()], client_timeout=3.0), 8.0)
                await solo.close()
                return stats

            assert asyncio.run(drive())["ok"] > 20
        finally:
            for proc in routers:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=10)
                proc.stderr.close()


@pytest.mark.fleet
@pytest.mark.llm
def test_llm_engine_streams_through_the_router():
    """The tiny fp32 ``llm_engine`` on two replicas: each greedy stream
    through the router equals the direct stream and the reference's
    dense ``generate`` token for token."""
    import jax
    import jax.numpy as jnp
    import torch

    from client_tpu.models import llama as jax_llama
    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.models import llama

    jax_config = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, jax_config))(
        jax.random.PRNGKey(0))
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [5, 5, 5]]
    tokens = 8
    expected = [np.asarray(jax_llama.generate(jax_params, np.array([p], dtype=np.int32),
                                              jax_config, tokens))[0].tolist()
                for p in prompts]
    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")

    def factory():
        return LlmEngineModel(config=config, params=params, device="cpu",
                              engine_config=EngineConfig(block_size=8, num_blocks=1 + 8 * 8,
                                                         max_active=8, max_queue=32,
                                                         max_seq_len=64))

    async def streams(url):
        client = port_grpc_aio.InferenceServerClient(url)

        async def one(prompt):
            inp = port_grpc_aio.InferInput("INPUT_IDS", [len(prompt)], "INT32")
            inp.set_data_from_numpy(np.array(prompt, np.int32))

            async def gen():
                yield {"model_name": "llm_engine", "inputs": [inp],
                       "parameters": {"max_tokens": tokens}}

            out = []
            async for result, error in client.stream_infer(gen()):
                assert error is None, error
                ids = result.as_numpy("OUTPUT_IDS")
                if ids is not None:
                    out.extend(int(v) for v in ids.reshape(-1))
                final = result.get_response().parameters.get("triton_final_response")
                if final is not None and final.bool_param:
                    break
            return out

        got = await asyncio.gather(*(one(p) for p in prompts))
        await client.close()
        return got

    with port_fleet_runner.FleetRunner(2, grpc="native", device="cpu", builtin_models=False,
                                       model_factories=[factory]) as fleet, \
            _port_router(fleet, http=False) as router:
        assert router.router.decoupled == {"llm_engine": True}
        through = asyncio.run(streams(router.grpc_url))
        direct = asyncio.run(streams(fleet.grpc_urls[0]))
    assert through == direct == expected

"""The port's engine recovery held against the JAX package's.

- Units: the ``recovery`` request parameter and ``EngineRecoveringError``'s
  wire faces (HTTP 503 with ``Retry-After``, gRPC UNAVAILABLE) equal the
  reference's.
- ``EngineRecovery`` on fakes (fake clock, fake sleep, fake engine), the
  reference's scenarios run against both controllers: bounded retries
  then success; exhaustion failing the parked survivors.
- The tiny fp32 engine (the reference's ``_tiny_model`` sizing, the JAX
  weights carried across by ``params_from_jax``): a quarantine mid-stream
  reloads it in the background and both streams resume token for token
  equal to the reference engine's uninterrupted streams and to the dense
  oracle; the ``recovery: fail`` opt-out; submits while recovering; 503
  with ``Retry-After`` over HTTP, the ``tpu_server_state`` overlay and the
  recovery counters; the error over the port's gRPC client on the native
  front-end; exhaustion leaving the model FAILED with every block back.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.llm import recovery as ref_recovery
from client_tpu.llm.engine import EngineConfig as RefEngineConfig
from client_tpu.llm.engine import EngineRecoveringError as RefRecoveringError
from client_tpu.llm.engine import _recovery_param as ref_recovery_param
from client_tpu.llm.serving import LlmEngineModel as RefLlmEngineModel
from client_tpu.models import llama as jax_llama
from client_tpu_torch.llm import recovery
from client_tpu_torch.llm.engine import EngineConfig, EngineRecoveringError, _recovery_param
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
SIZING = dict(block_size=8, num_blocks=33, max_active=8, max_queue=16, max_seq_len=64)
PROMPTS = [[5, 9, 17, 3], [1, 2, 3, 4], [7, 8, 9, 10]]
TOKENS = 12


# -- units --------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "resume", "Resume", " fail ", "fail",
                                   "sometimes", 1])
def test_recovery_param_equals_the_references(value):
    try:
        theirs = ref_recovery_param(value)
    except Exception as e:  # noqa: BLE001 - compared below
        with pytest.raises(InferenceServerException, match="'resume' or 'fail'"):
            _recovery_param(value)
        assert "'resume' or 'fail'" in str(e)
        return
    assert _recovery_param(value) is theirs


def test_engine_recovering_error_wire_faces_equal_the_references():
    from client_tpu.server import _grpc_codec as ref_codec
    from client_tpu.server.http_server import _map_exception
    from client_tpu_torch.resilience.policy import exception_is_retryable
    from client_tpu_torch.server import _grpc_codec as codec
    from client_tpu_torch.server.http_server import error_response
    from client_tpu_torch.server.openai_frontend import _mapped_error

    ours, theirs = EngineRecoveringError("llm_x", 2.5), RefRecoveringError("llm_x", 2.5)
    assert (ours.http_status, ours.grpc_code, ours.reason, ours.retry_after_s) == (
        theirs.http_status, theirs.grpc_code, theirs.reason, theirs.retry_after_s) == (
        503, "UNAVAILABLE", "recovering", 2.5)
    assert ours.message() == theirs.message() and "recovering" in ours.message()
    assert exception_is_retryable(ours) is True
    for response in (error_response(ours), _mapped_error(ours)):
        assert response.status == _map_exception(theirs).status == 503
        assert response.headers["Retry-After"] == _map_exception(theirs).headers[
            "Retry-After"] == "2"
    assert json.loads(_mapped_error(ours).body) == {"error": {"message": ours.message()}}
    assert codec.status_code_for(ours.message(), exc=ours) == ref_codec.status_code_for(
        theirs.message(), exc=theirs) == codec.GRPC_UNAVAILABLE


# -- EngineRecovery on fakes ----------------------------------------------------


class _Seq:
    def __init__(self):
        self.error = None

    def fail(self, e):
        self.error = e


class _Metrics:
    def __init__(self):
        self.recoveries = []

    def observe_recovery(self, tier, outcome, seconds):
        self.recoveries.append((tier, outcome, seconds))


class _FakeEngine:
    def __init__(self, survivors, metrics):
        self._survivors = list(survivors)
        self.metrics = metrics
        self.logger = None
        self.recovering = True
        self.on_fatal = None
        self.retry_after_s = None

    def detach_survivors(self):
        out, self._survivors = self._survivors, []
        return out


class _FakeModel:
    name = "fake_llm"

    def __init__(self, engine, fail_attempts):
        self.engine = engine
        self._core = None
        self.reloads = 0
        self._fail_attempts = fail_attempts

    def reload(self):
        self.reloads += 1
        if self.reloads <= self._fail_attempts:
            raise RuntimeError(f"reload attempt {self.reloads} refused")
        self.engine = _FakeEngine([], self.engine.metrics)


def _fake_clock(times):
    state = {"i": 0}

    def clock():
        i = min(state["i"], len(times) - 1)
        state["i"] += 1
        return times[i]

    return clock


CONTROLLERS = {"port": recovery.EngineRecovery, "ref": ref_recovery.EngineRecovery}


def _fake_run(package, fail_attempts, survivors, clock_times):
    controller_type = CONTROLLERS[package]
    metrics = _Metrics()
    engine = _FakeEngine(survivors, metrics)
    model = _FakeModel(engine, fail_attempts)
    sleeps = []
    controller = controller_type(model, max_attempts=3, backoff_s=0.1, retry_after_s=2.0,
                                 clock=_fake_clock(clock_times), sleep=sleeps.append)
    controller.attach(engine)
    assert engine.on_fatal == controller._on_fatal and engine.retry_after_s == 2.0
    engine.on_fatal(RuntimeError("device lost"))
    controller.join()
    return {
        "state": controller.state,
        "describe": {k: v for k, v in controller.describe().items() if k != "last_error"},
        "last_error": controller.describe()["last_error"],
        "reloads": model.reloads,
        "sleeps": sleeps,
        "recoveries": metrics.recoveries,
        "old_engine_recovering": engine.recovering,
        "replaced": model.engine is not engine,
        "reattached": model.engine.on_fatal == controller._on_fatal,
        "survivor_errors": [str(s.error) if s.error else None for s in survivors],
    }


def test_retries_then_succeeds_on_fakes_as_the_reference_does():
    ours = _fake_run("port", 1, [_Seq()], [100.0, 107.5])
    theirs = _fake_run("ref", 1, [_Seq()], [100.0, 107.5])
    assert ours == theirs
    assert ours["state"] == recovery.READY and ours["describe"]["recoveries"] == 1
    assert ours["reloads"] == 2 and ours["sleeps"] == pytest.approx([0.1])
    assert ours["replaced"] and ours["reattached"]
    # no serving loop existed: the parked survivor fails retryable
    assert "serving loop is gone" in ours["survivor_errors"][0]
    assert ours["recoveries"] == [("engine", "success", pytest.approx(7.5))]


def test_exhaustion_fails_the_survivors_on_fakes_as_the_reference_does():
    ours = _fake_run("port", 99, [_Seq(), _Seq()], [5.0, 9.0])
    theirs = _fake_run("ref", 99, [_Seq(), _Seq()], [5.0, 9.0])
    assert ours == theirs
    assert ours["state"] == recovery.FAILED and ours["describe"]["failures"] == 1
    assert ours["reloads"] == 3 and ours["sleeps"] == pytest.approx([0.1, 0.2, 0.3])
    assert ours["old_engine_recovering"] is False
    assert all("after 3 attempts" in e for e in ours["survivor_errors"])
    assert ours["recoveries"] == [("engine", "failed", pytest.approx(4.0))]


# -- the tiny fp32 engine ---------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))(
        jax.random.PRNGKey(0))
    return jax_params, llama.params_from_jax(jax.tree.map(np.asarray, jax_params),
                                             device="cpu")


@pytest.fixture(scope="module")
def references(weights):
    """The dense oracle (JAX ``llama.generate``) and the reference engine's
    uninterrupted streams, for PROMPTS."""
    jax_params, _ = weights
    dense = np.asarray(jax.jit(lambda p, t: jax_llama.generate(p, t, JAX_CONFIG, TOKENS))(
        jax_params, np.array(PROMPTS, dtype=np.int32))).tolist()
    model = RefLlmEngineModel("llm_ref", config=JAX_CONFIG, params=jax_params,
                              engine_config=RefEngineConfig(**SIZING))
    model.warmup()
    try:
        async def run():
            return await asyncio.gather(*(_generate(model, p) for p in PROMPTS))

        streams = asyncio.run(run())
    finally:
        model.shutdown()
    assert streams == dense
    return dense


def _tiny_model(weights, name="llm_heal", **attrs):
    _, params = weights
    model = LlmEngineModel(name, config=llama.LlamaConfig.tiny(max_seq_len=64,
                                                               dtype=torch.float32),
                           params=params, engine_config=EngineConfig(**SIZING), device="cpu")
    for key, value in attrs.items():  # auto_recovery / recovery_options
        setattr(model, key, value)
    model.warmup()
    return model


async def _generate(model, prompt, parameters=None, got=None):
    out = [] if got is None else got
    params = {"max_tokens": TOKENS, **(parameters or {})}
    async for item in model.execute_decoupled(
            {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, params):
        out.append(int(item["OUTPUT_IDS"][0]))
        if item["__final__"]:
            break
    return out


def test_a_quarantine_mid_stream_resumes_token_identical(weights, references):
    """Both streams see a few tokens, the engine is quarantined, the
    controller reloads it in the background and both resume: the clients
    see no error, and every token equals the reference engine's
    uninterrupted stream and the dense oracle."""
    model = _tiny_model(weights, recovery_options={"backoff_s": 0.01})
    try:
        first_engine = model.engine

        async def run():
            streams = [[], []]
            tasks = [asyncio.ensure_future(_generate(model, p, got=streams[i]))
                     for i, p in enumerate(PROMPTS[:2])]
            while min(len(s) for s in streams) < 3:
                await asyncio.sleep(0.005)
            first_engine.quarantine("induced device failure (chaos)")
            return await asyncio.gather(*tasks)

        assert asyncio.run(run()) == references[:2]
        controller = model._recovery
        controller.join()
        assert controller.describe()["state"] == recovery.READY
        assert controller.recoveries == 1 and controller.failures == 0
        assert model.engine is not first_engine
        assert model.engine.on_fatal == controller._on_fatal
        stats = model.engine.stats()
        assert stats["recovering"] is False and stats["kv_blocks_in_use"] == 0
        assert first_engine.allocator.blocks_in_use == 0
        # the recovered engine serves fresh requests too
        assert asyncio.run(_generate(model, PROMPTS[0])) == references[0]
    finally:
        model.shutdown()


def test_the_fail_opt_out_gets_the_error_while_resume_survives(weights, references):
    model = _tiny_model(weights, "llm_optout", recovery_options={"backoff_s": 0.01})
    try:
        first_engine = model.engine

        async def run():
            resumed, failing = [], []
            resume = asyncio.ensure_future(_generate(model, PROMPTS[2], got=resumed))
            fail = asyncio.ensure_future(_generate(model, PROMPTS[1], {"recovery": "fail"},
                                                   got=failing))
            while len(resumed) < 2 or len(failing) < 2:
                await asyncio.sleep(0.005)
            first_engine.quarantine("induced device failure (chaos)")
            tokens = await resume
            with pytest.raises(InferenceServerException) as info:
                await fail
            return tokens, failing, info.value

        tokens, failing, error = asyncio.run(run())
        assert tokens == references[2]
        assert error.status() == "UNAVAILABLE" and "induced device failure" in str(error)
        assert failing == references[1][:len(failing)]
        model._recovery.join()
        assert model._recovery.state == recovery.READY
    finally:
        model.shutdown()


def test_a_quarantined_engine_refuses_submits_with_the_recovering_error(weights):
    """A fatal hook that never reloads parks the engine recovering:
    submits raise the 503 with ``Retry-After``; once the survivors fail
    it reports plainly closed. With no hook at all a quarantine fails
    everything (auto_recovery off)."""
    model = _tiny_model(weights, "llm_gate", auto_recovery=False)
    try:
        engine = model.engine
        assert model._recovery is None and engine.on_fatal is None
        engine.on_fatal = lambda exc: None
        engine.retry_after_s = 3.0
        engine.quarantine("induced")
        assert engine.recovering is True
        with pytest.raises(EngineRecoveringError) as info:
            engine.submit([1, 2, 3], max_tokens=4)
        assert info.value.retry_after_s == 3.0 and info.value.http_status == 503
        assert engine.stats()["recovering"] is True
        engine.fail_survivors(InferenceServerException("gone"))
        assert engine.recovering is False
        with pytest.raises(InferenceServerException, match="closed"):
            engine.submit([1, 2, 3], max_tokens=4)
    finally:
        model.shutdown()


def _gate_reload(model):
    gate = threading.Event()
    original = model.reload

    def gated():
        assert gate.wait(timeout=60), "the test never released the reload"
        original()

    model.reload = gated
    return gate


def _post(port, path, payload):
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=30) as response:
        return response.status, json.loads(response.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as response:
        return response.status, response.read().decode()


def test_http_answers_503_with_retry_after_while_recovering(weights):
    """While the reload is held: the OpenAI route answers 503 with
    ``Retry-After`` and the error body, ``tpu_server_state`` reads 3,
    readiness stays 200, and the debug state carries the recovery
    document. After it: 200 again, the state 0, and the counters exact."""
    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.model_repository import ModelRepository
    from client_tpu_torch.testing import InProcessServer

    model = _tiny_model(weights, "llm_wire",
                        recovery_options={"backoff_s": 0.01, "retry_after_s": 2.0})
    repository = ModelRepository()
    core = ServerCore(repository, device="cpu")
    repository.add_model(model)
    gate = _gate_reload(model)
    payload = {"model": "llm_wire", "messages": [{"role": "user", "content": "hi"}],
               "max_tokens": 4}
    with InProcessServer(core=core, builtin_models=False, device="cpu") as server:
        port = server.http_port
        assert _post(port, "/v1/chat/completions", payload)[0] == 200
        first_engine = model.engine
        first_engine.quarantine("induced device failure (chaos)")
        deadline = time.monotonic() + 10
        while not core.recovering and time.monotonic() < deadline:
            time.sleep(0.01)
        assert core.recovering is True
        with pytest.raises(EngineRecoveringError):
            first_engine.submit([1, 2, 3], max_tokens=4)
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(port, "/v1/chat/completions", payload)
        assert info.value.code == 503
        assert info.value.headers["Retry-After"] == "2"
        assert json.loads(info.value.read()) == {
            "error": {"message": EngineRecoveringError("llm_wire").message()}}
        assert "tpu_server_state 3" in _get(port, "/metrics")[1]
        assert _get(port, "/v2/health/ready")[0] == 200
        doc = json.loads(_get(port, "/v2/debug/state")[1])
        assert doc["server"]["recovering"] is True
        assert doc["llm"]["llm_wire"]["recovery"]["state"] == "recovering"
        gate.set()
        model._recovery.join()
        assert model._recovery.state == recovery.READY
        status, doc = _post(port, "/v1/chat/completions", payload)
        assert status == 200 and doc["choices"][0]["message"]["content"]
        metrics = _get(port, "/metrics")[1]
        assert "tpu_server_state 0" in metrics
        assert 'tpu_recovery_total{tier="engine",outcome="success"} 1' in metrics
        assert 'tpu_recovery_seconds_count{tier="engine"} 1' in metrics
        state = json.loads(_get(port, "/v2/debug/state")[1])
        assert state["server"]["recovering"] is False
        assert state["llm"]["llm_wire"]["recovery"]["recoveries"] == 1
    model.shutdown()


def test_grpc_streams_get_the_recovering_error_and_then_resume(weights, references):
    """Over the native front-end and the port's gRPC client: a stream
    request sent while the reload is held gets the recovering error
    in-band (the server maps it to UNAVAILABLE); a stream in flight across
    the quarantine resumes equal to the reference."""
    import client_tpu_torch.grpc.aio as grpc_aio
    from client_tpu_torch.testing import InProcessServer

    model = _tiny_model(weights, "llm_grpc", recovery_options={"backoff_s": 0.01})
    gate = _gate_reload(model)
    server = InProcessServer(device="cpu", builtin_models=False, grpc=True)
    server.core.repository.add_model(model)
    server.start()

    async def run():
        client = grpc_aio.InferenceServerClient(server.grpc_url)

        async def stream(prompt, got):
            inp = grpc_aio.InferInput("INPUT_IDS", [len(prompt)], "INT32")
            inp.set_data_from_numpy(np.array(prompt, np.int32))

            async def gen():
                yield {"model_name": "llm_grpc", "inputs": [inp],
                       "parameters": {"max_tokens": TOKENS}}

            async for result, error in client.stream_infer(gen()):
                if error is not None:
                    return error
                ids = result.as_numpy("OUTPUT_IDS")
                if ids is not None:
                    got.extend(int(v) for v in ids.reshape(-1))
                final = result.get_response().parameters.get("triton_final_response")
                if final is not None and final.bool_param:
                    return None

        resumed = []
        task = asyncio.ensure_future(stream(PROMPTS[0], resumed))
        while len(resumed) < 3:
            await asyncio.sleep(0.005)
        first = model.engine
        first.quarantine("induced device failure (chaos)")
        while not first.recovering:
            await asyncio.sleep(0.005)
        refused = await stream(PROMPTS[1], [])
        gate.set()
        resumed_error = await task
        await client.close()
        return refused, resumed_error, resumed

    try:
        refused, resumed_error, resumed = asyncio.run(run())
        model._recovery.join()
    finally:
        server.stop()
    assert isinstance(refused, InferenceServerException)
    assert refused.message() == EngineRecoveringError("llm_grpc").message()
    assert resumed_error is None and resumed == references[0]
    assert model._recovery.recoveries == 1


def test_exhaustion_leaves_the_model_failed_with_every_block_back(weights, references):
    """Every reload raises: after ``max_attempts`` the survivors fail
    UNAVAILABLE naming the attempts, the controller reads FAILED, the
    counter books one failure, the quarantined engine holds no block and
    answers plainly closed — nothing falls back."""
    from client_tpu_torch.server.metrics import ServerMetrics

    model = _tiny_model(weights, "llm_doomed",
                        recovery_options={"backoff_s": 0.0, "max_attempts": 2})
    calls = []

    def broken_reload():
        calls.append(1)
        raise RuntimeError("CUDA error: device-side assert triggered")

    model.reload = broken_reload
    first = model.engine

    class _Core:
        metrics = None

    try:
        async def run():
            first.metrics = metrics
            streams = [[], []]
            tasks = [asyncio.ensure_future(_generate(model, p, got=streams[i]))
                     for i, p in enumerate(PROMPTS[:2])]
            while min(len(s) for s in streams) < 2:
                await asyncio.sleep(0.005)
            first.quarantine("induced device failure (chaos)")
            results = await asyncio.gather(*tasks, return_exceptions=True)
            return streams, results

        metrics = ServerMetrics(_Core())
        streams, results = asyncio.run(run())
        model._recovery.join()
    finally:
        model.shutdown()
    for got, result, want in zip(streams, results, references):
        assert isinstance(result, InferenceServerException)
        assert result.status() == "UNAVAILABLE"
        assert "failed to recover after 2 attempts" in result.message()
        assert "device-side assert" in result.message()
        assert got == want[:len(got)]
    doc = model._recovery.describe()
    assert doc["state"] == recovery.FAILED and doc["failures"] == 1
    assert doc["max_attempts"] == 2 and len(calls) == 2
    assert model.recovering is False and model.engine is first
    assert first.allocator.blocks_in_use == 0 and first.recovering is False
    with pytest.raises(InferenceServerException, match="closed"):
        first.submit([1, 2, 3], max_tokens=4)
    assert metrics.recovery_total.labels("engine", "failed").get() == 1

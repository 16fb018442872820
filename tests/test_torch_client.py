"""The port's HTTP client (``client_tpu_torch.http``, on stdlib asyncio)
against the JAX package's (``client_tpu.http``, on aiohttp), on the CPU.

- Cross-wire, four ways: the port's client and the JAX client each send
  the same seeded requests to the port's server
  (``client_tpu_torch.testing.InProcessServer``, ``device="cpu"``) and to
  the JAX server (``client_tpu.testing.InProcessServer``); the JAX client
  against the JAX server is the oracle. Over inline binary, JSON, system
  shm, TPU shm and the slot ring: ``simple`` and the identities answer
  identically, a tiny fp32 ``text_encoder`` and a tiny fp32
  ``image_classifier`` (the same seed-0 weights on both servers) within
  1e-5 of the oracle's largest value. Each error (unknown model, bad
  shape, a full queue, a stale ring slot, a ring region the server does
  not know, inline inputs beside a ring) gives the same status and
  exception type all four ways.
- Resilience: on scripted loopback servers (answers, dropped connections
  and silences from a script), the port's client with a ``RetryPolicy``
  (no jitter), a ``CircuitBreaker`` and an ``EndpointPool`` of two
  endpoints makes the same attempts in the same order, with the same
  outcomes, as the JAX client; a full queue's ``Retry-After`` floors the
  retry backoff on both.
- Transport: keep-alive reuse, the connection cap, ``Connection: close``,
  a timeout as ``CONNECTION_ERROR``, torch tensors in and out.
- The server's repairs: the OpenAI routes answer a core error in the
  OpenAI body shape with the JAX server's status and message;
  ``ServerCore.infer_decoupled`` gives a non-decoupled model's one
  response with the JAX core's statistics; a chunked request body
  answers as the same body with a ``Content-Length``, a malformed chunk
  is a 400, and a body over the 1 GiB limit a 413 before it is read.

Every region name carries a ``uuid``: test files run in parallel
processes that share ``/dev/shm``.
"""

import asyncio
import http.client
import json
import socket
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
from client_tpu.models import bert as jax_bert
from client_tpu.models import resnet as jax_resnet
from client_tpu.models.serving import ImageClassifierModel as JaxImageClassifierModel
from client_tpu.models.serving import TextEncoderModel as JaxTextEncoderModel
from client_tpu.resilience import CircuitBreaker as JaxCircuitBreaker
from client_tpu.resilience import RetryPolicy as JaxRetryPolicy
from client_tpu.server import core as jax_core
from client_tpu.server import models as jax_models
from client_tpu.server.model_repository import Model as JaxModel
from client_tpu.server.model_repository import ModelRepository as JaxModelRepository
from client_tpu.testing import InProcessServer as JaxInProcessServer
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu.utils import shared_memory as jax_shm
from client_tpu.utils import tpu_shared_memory as jax_tpushm
from client_tpu.utils.tpu_shared_memory.ring import ShmRing as JaxShmRing
import client_tpu_torch.http as port_http
import client_tpu_torch.http.aio as port_aio
from client_tpu_torch.models import bert, resnet
from client_tpu_torch.models.serving import ImageClassifierModel, TextEncoderModel
from client_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from client_tpu_torch.server import core as port_core
from client_tpu_torch.server import models as port_models
from client_tpu_torch.server.model_repository import Model, ModelRepository
from client_tpu_torch.testing import InProcessServer
from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils import shared_memory as port_shm
from client_tpu_torch.utils import tpu_shared_memory as port_tpushm
from client_tpu_torch.utils.tpu_shared_memory.ring import ShmRing

torch.set_num_threads(1)

IMAGE_SIZE = 32
TOL = 1e-5
PACKAGES = {
    "port": (port_http, port_shm, port_tpushm, ShmRing, InferenceServerException),
    "jax": (jax_http, jax_shm, jax_tpushm, JaxShmRing, JaxError),
}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]


class _PortSlow(Model):
    """Batchable, 0.4 s an execution, one request may wait."""

    name = "slow"
    max_batch_size = 4
    queue_policy = {"max_queue_size": 1}
    inputs = [{"name": "X", "datatype": "FP32", "shape": [2]}]
    outputs = [{"name": "Y", "datatype": "FP32", "shape": [2]}]

    def execute(self, inputs, parameters):
        time.sleep(0.4)
        return {"Y": inputs["X"]}


class _JaxSlow(JaxModel):
    name = "slow"
    max_batch_size = 4
    queue_policy = {"max_queue_size": 1}
    inputs = [{"name": "X", "datatype": "FP32", "shape": [2]}]
    outputs = [{"name": "Y", "datatype": "FP32", "shape": [2]}]

    def execute(self, inputs, parameters):
        time.sleep(0.4)
        return {"Y": np.asarray(inputs["X"])}


class _SeededJaxClassifier(JaxImageClassifierModel):
    """The JAX ``image_classifier`` in fp32 on the given variables."""

    def __init__(self, variables):
        super().__init__("image_classifier", image_size=IMAGE_SIZE, small=True)
        self._given = variables

    def warmup(self):
        self._variables = self._given
        self._apply = jax_resnet.make_apply_fn(
            jax_resnet.ResNet18Thin(1000, dtype=jnp.float32))


@pytest.fixture(scope="module")
def servers():
    bert_config = jax_bert.BertConfig.tiny(dtype=jnp.float32)
    bert_params = jax.tree.map(np.asarray,
                               jax_bert.init_params(jax.random.PRNGKey(0), bert_config))
    net = jax_resnet.ResNet18Thin(1000, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3), jnp.float32)))
    reference = JaxInProcessServer(grpc=False).start()
    for model in (JaxTextEncoderModel(config=bert_config, params=bert_params),
                  _SeededJaxClassifier(variables), _JaxSlow()):
        reference.core.repository.add_model(model)
    port = InProcessServer(device="cpu").start()
    config = bert.BertConfig.tiny(dtype=torch.float32)
    classifier = resnet.resnet18_thin(dtype=torch.float32)
    for model in (
        TextEncoderModel(config=config, params=bert.params_from_jax(bert_params, config, "cpu"),
                         device="cpu"),
        ImageClassifierModel(image_size=IMAGE_SIZE, config=classifier,
                             params=resnet.params_from_jax(variables, classifier, "cpu"),
                             device="cpu"),
        _PortSlow(),
    ):
        port.core.repository.add_model(model)
    urls = {"jax": reference.http_url, "port": port.http_url}
    clients = {(c, s): PACKAGES[c][0].InferenceServerClient(urls[s]) for c, s in PAIRS}
    yield {"urls": urls, "clients": clients, "port": port, "jax": reference}
    for client in clients.values():
        client.close()
    port.stop()
    reference.stop()


# ---------------------------------------------------------------------------
# cross-wire: two clients x two servers x five routes
# ---------------------------------------------------------------------------

def _requests():
    rng = np.random.default_rng(0)
    fp32 = rng.normal(size=[5000]).astype(np.float32)
    fp32[:3] = [np.inf, -0.0, np.nan]
    return {
        "simple": [("INPUT0", rng.integers(-2**20, 2**20, [1, 16], dtype=np.int32)),
                   ("INPUT1", rng.integers(-2**20, 2**20, [1, 16], dtype=np.int32))],
        "identity_fp32": [("INPUT0", fp32)],
        "identity_bf16": [("INPUT0", rng.normal(size=[64]).astype(ml_dtypes.bfloat16))],
        "identity_bytes": [("INPUT0", np.array([b"alpha", b"", "\xe9t\xe9".encode()],
                                               dtype=object))],
        "text_encoder": [("INPUT_IDS", rng.integers(1, 100, [1, 20], dtype=np.int32))],
        "image_classifier": [("INPUT", rng.normal(
            size=[1, IMAGE_SIZE, IMAGE_SIZE, 3]).astype(np.float32))],
    }


REQUESTS = _requests()
OUTPUTS = {  # name, dtype, shape
    "simple": [("OUTPUT0", np.int32, [1, 16]), ("OUTPUT1", np.int32, [1, 16])],
    "identity_fp32": [("OUTPUT0", np.float32, [5000])],
    "identity_bf16": [("OUTPUT0", ml_dtypes.bfloat16, [64])],
    "identity_bytes": [("OUTPUT0", object, [3])],
    "text_encoder": [("EMBEDDING", np.float32, [1, bert.BertConfig.tiny().d_model])],
    "image_classifier": [("OUTPUT", np.float32, [1, 1000])],
}
DATATYPES = {np.dtype(np.int32): "INT32", np.dtype(np.float32): "FP32",
             np.dtype(ml_dtypes.bfloat16): "BF16", np.dtype(object): "BYTES"}
CROSS_CASES = [(m, r) for m in REQUESTS for r in ("binary", "json", "system", "tpu", "ring")
               if not (m == "identity_bf16" and r == "json")  # BF16 has no JSON form
               and not (m == "identity_bytes" and r in ("system", "tpu"))]


def _infer(side, client, model, route):
    """{output name: array} of one request of ``model`` over ``route``
    through ``client`` of package ``side``."""
    http, shm, tpushm, ring_type, _ = PACKAGES[side]
    inputs = REQUESTS[model]
    if route == "ring":
        ring = ring_type(n_slots=2, slot_size=1 << 16, name=f"ring_{uuid.uuid4().hex}")
        ring.register(client)
        try:
            return ring.infer(client, model, inputs)
        finally:
            client.unregister_tpu_shared_memory(ring.region_name)
            ring.close()
    tensors = [http.InferInput(name, list(a.shape), DATATYPES[a.dtype]) for name, a in inputs]
    if route in ("binary", "json"):
        for tensor, (_, array) in zip(tensors, inputs):
            tensor.set_data_from_numpy(array, binary_data=route == "binary")
        outputs = [http.InferRequestedOutput(name, binary_data=route == "binary")
                   for name, _, _ in OUTPUTS[model]]
        result = client.infer(model, tensors, outputs=outputs)
        return {name: result.as_numpy(name) for name, _, _ in OUTPUTS[model]}
    tag = uuid.uuid4().hex
    module = shm if route == "system" else tpushm
    in_bytes = sum(a.nbytes for _, a in inputs)
    out_sizes = [int(np.prod(s)) * np.dtype(d).itemsize for _, d, s in OUTPUTS[model]]
    if route == "system":
        regions = [shm.create_shared_memory_region(f"{r}_{tag}", f"ctc_{r}_{tag}", size)
                   for r, size in (("in", in_bytes), ("out", sum(out_sizes)))]
        for region in regions:
            client.register_system_shared_memory(region.name(), f"ctc_{region.name()}",
                                                 region.byte_size())
    else:
        regions = [tpushm.create_shared_memory_region(f"{r}_{tag}", size)
                   for r, size in (("in", in_bytes), ("out", sum(out_sizes)))]
        for region in regions:
            client.register_tpu_shared_memory(region.name(), tpushm.get_raw_handle(region), 0,
                                              region.byte_size())
    try:
        module.set_shared_memory_region(regions[0], [a for _, a in inputs])
        offset = 0
        for tensor, (_, array) in zip(tensors, inputs):
            tensor.set_shared_memory(regions[0].name(), array.nbytes, offset)
            offset += array.nbytes
        outputs, offset = [], 0
        for (name, _, _), size in zip(OUTPUTS[model], out_sizes):
            outputs.append(http.InferRequestedOutput(name).set_shared_memory(
                regions[1].name(), size, offset))
            offset += size
        client.infer(model, tensors, outputs=outputs)
        answers, offset = {}, 0
        for (name, dtype, shape), size in zip(OUTPUTS[model], out_sizes):
            answers[name] = module.get_contents_as_numpy(regions[1], np.dtype(dtype), shape,
                                                         offset).copy()
            offset += size
        return answers
    finally:
        for region in regions:
            getattr(client, f"unregister_{route}_shared_memory")(region.name())
            module.destroy_shared_memory_region(region)


@pytest.mark.parametrize("model,route", CROSS_CASES)
def test_cross_wire_answers_equal_the_jax_oracle(servers, model, route):
    answers = {pair: _infer(pair[0], client, model, route)
               for pair, client in servers["clients"].items()}
    oracle = answers[("jax", "jax")]
    for pair, answer in answers.items():
        assert set(answer) >= {name for name, _, _ in OUTPUTS[model]}, pair
        for name, dtype, shape in OUTPUTS[model]:
            got, want = answer[name], oracle[name]
            assert got.dtype == np.dtype(dtype) and list(got.shape) == shape, (pair, name)
            if model in ("text_encoder", "image_classifier"):
                scale = float(np.abs(want).max())
                assert np.abs(got - want).max() <= TOL * max(1.0, scale), (pair, name)
            elif dtype is object:
                assert list(got) == list(want), (pair, name)
            else:
                assert got.tobytes() == want.tobytes(), (pair, name)


def _ring_request(side, client, edit):
    """A ``simple`` ring request whose parameters ``edit`` spoils; returns
    the raised exception."""
    _, _, _, ring_type, error = PACKAGES[side]
    ring = ring_type(n_slots=2, slot_size=2048, name=f"ring_{uuid.uuid4().hex}")
    ring.register(client)
    try:
        ticket = ring.stage(REQUESTS["simple"])
        parameters, inputs = edit(dict(ticket.parameters), ring, client)
        with pytest.raises(error) as err:
            client.infer("simple", inputs, parameters=parameters)
        ring.release(ticket)
        return err.value
    finally:
        client.unregister_tpu_shared_memory(ring.region_name)
        ring.close()


def _unknown_model(side, client):
    http, *_, error = PACKAGES[side]
    tensor = http.InferInput("X", [1], "FP32").set_data_from_numpy(np.ones(1, np.float32))
    with pytest.raises(error) as err:
        client.infer("nope", [tensor])
    return err.value


def _bad_shape(side, client):
    """A shape that the tensor's bytes do not fill."""
    http, *_, error = PACKAGES[side]
    tensors = [http.InferInput(n, [1, 8], "INT32").set_data_from_numpy(np.ones([1, 8], np.int32))
               for n in ("INPUT0", "INPUT1")]
    for tensor in tensors:
        tensor.set_shape([1, 16])
    with pytest.raises(error) as err:
        client.infer("simple", tensors)
    return err.value


def _stale_seq(params, ring, client):
    params["shm_ring_seq"] += 1
    return params, []


def _region_gone(params, ring, client):
    client.unregister_tpu_shared_memory(ring.region_name)
    return params, []


def _slot_out_of_range(params, ring, client):
    params["shm_ring_slot"] = 99
    return params, []


def _inline_beside_ring(params, ring, client):
    http = port_http if isinstance(ring, ShmRing) else jax_http
    array = REQUESTS["simple"][0][1]
    return params, [http.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(array)]


ERRORS = {
    "unknown model": (_unknown_model, "unknown model"),
    "bad shape": (_bad_shape, "unexpected shape"),
    "stale ring seq": (lambda s, c: _ring_request(s, c, _stale_seq), "stale or torn"),
    "ring region gone": (lambda s, c: _ring_request(s, c, _region_gone), "unavailable"),
    "ring slot out of range": (lambda s, c: _ring_request(s, c, _slot_out_of_range),
                               "out of range"),
    "inline inputs beside a ring": (lambda s, c: _ring_request(s, c, _inline_beside_ring),
                                    "must not also carry inline"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_have_the_same_status_and_type_all_four_ways(servers, case):
    make, words = ERRORS[case]
    errors = {pair: make(pair[0], client) for pair, client in servers["clients"].items()}
    statuses = {pair: e.status() for pair, e in errors.items()}
    assert len(set(statuses.values())) == 1, statuses
    assert statuses[("jax", "jax")] in ("400", "404"), statuses
    for pair, e in errors.items():
        assert isinstance(e, PACKAGES[pair[0]][4])
        if case == "bad shape":
            continue  # the servers word a shape refusal differently
        assert words in e.message().lower() or words in e.message(), (pair, e.message())


def test_a_full_queue_is_a_429_whose_retry_after_floors_the_backoff(servers):
    """Six concurrent requests to a model with a one-request waiting room:
    each side sees 200s and 429s. The client's retry policy backs off 1 ms
    on its own, so each backoff slept after a 429 is the server's
    Retry-After."""
    results = {}
    for pair in PAIRS:
        client_side, server_side = pair
        http = PACKAGES[client_side][0]
        policy_type = RetryPolicy if client_side == "port" else JaxRetryPolicy
        slept = []

        async def record(seconds, slept=slept):
            slept.append(seconds)

        policy = policy_type(max_attempts=2, initial_backoff_s=0.001, jitter=False,
                             async_sleep=record, sleep=slept.append)
        client = http.InferenceServerClient(servers["urls"][server_side], retry_policy=policy)
        outcomes = []
        start = threading.Barrier(6)

        def send():
            tensor = http.InferInput("X", [1, 2], "FP32")
            tensor.set_data_from_numpy(np.ones([1, 2], np.float32))
            start.wait(30)
            try:
                client.infer("slow", [tensor])
                outcomes.append("200")
            except (InferenceServerException, JaxError) as e:
                outcomes.append(e.status())

        threads = [threading.Thread(target=send) for _ in range(6)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
        client.close()
        assert not any(thread.is_alive() for thread in threads)
        results[pair] = (sorted(set(outcomes)), slept)
    for pair, (statuses, slept) in results.items():
        assert statuses == ["200", "429"], (pair, statuses)
        assert slept and all(s >= 1.0 for s in slept), (pair, slept)


# ---------------------------------------------------------------------------
# resilience on scripted servers
# ---------------------------------------------------------------------------

class ScriptedServers:
    """Loopback HTTP servers that answer from per-endpoint scripts and log
    every request as (endpoint, method, path). An action is a status (a
    JSON body; 200s carry ``{}``), ``"drop"`` (close without answering),
    ``"hang"`` (never answer), ``"close"`` (a 200 with ``Connection:
    close``, then close) or ``("slow", s)`` (a 200 after s seconds).
    The last action of a script repeats."""

    def __init__(self, scripts):
        self.scripts = {name: list(actions) for name, actions in scripts.items()}
        self.log, self.connections, self.open_now, self.open_max = [], 0, 0, 0
        self._loop = asyncio.new_event_loop()
        self._servers, self.ports = {}, {}
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self._loop)
            for name in self.scripts:
                server = self._loop.run_until_complete(asyncio.start_server(
                    lambda r, w, name=name: self._serve(name, r, w), "127.0.0.1", 0))
                self._servers[name] = server
                self.ports[name] = server.sockets[0].getsockname()[1]
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        assert started.wait(10)

    def url(self, name):
        return f"127.0.0.1:{self.ports[name]}"

    async def _serve(self, name, reader, writer):
        self.connections += 1
        self.open_now += 1
        self.open_max = max(self.open_max, self.open_now)
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                lines = head.decode("latin-1").split("\r\n")
                method, path, _ = lines[0].split(" ")
                headers = {k.strip().lower(): v.strip() for k, _, v in
                           (line.partition(":") for line in lines[1:] if line)}
                await reader.readexactly(int(headers.get("content-length", "0")))
                self.log.append((name, method, path.split("?")[0]))
                script = self.scripts[name]
                action = script.pop(0) if len(script) > 1 else script[0]
                if action == "drop":
                    return
                if action == "hang":
                    await asyncio.sleep(3600)
                extra = ""
                if isinstance(action, tuple):
                    await asyncio.sleep(action[1])
                    action = 200
                if action == "close":
                    action, extra = 200, "Connection: close\r\n"
                body = b"{}" if action == 200 else json.dumps(
                    {"error": f"scripted {action}"}).encode()
                writer.write(f"HTTP/1.1 {action} X\r\nContent-Type: application/json\r\n"
                             f"Content-Length: {len(body)}\r\n{extra}\r\n".encode() + body)
                await writer.drain()
                if extra:
                    return
        finally:
            self.open_now -= 1
            writer.close()

    def close(self):
        async def stop():
            for server in self._servers.values():
                server.close()
            for task in asyncio.all_tasks():
                if task is not asyncio.current_task():
                    task.cancel()

        asyncio.run_coroutine_threadsafe(stop(), self._loop).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)
        assert not self._thread.is_alive()
        self._loop.close()


def _drive(side, scripts, calls, **client_kwargs):
    """Run ``calls`` (callables of a sync client) against fresh scripted
    servers; returns (the servers' request log, each call's outcome)."""
    servers = ScriptedServers(scripts)
    http = PACKAGES[side][0]
    retry = RetryPolicy if side == "port" else JaxRetryPolicy
    breaker = CircuitBreaker if side == "port" else JaxCircuitBreaker
    kwargs = dict(client_kwargs)
    if "retry" in kwargs:
        kwargs["retry_policy"] = retry(**kwargs.pop("retry"))
    if "breaker" in kwargs:
        kwargs["circuit_breaker"] = breaker(**kwargs.pop("breaker"))
    client = http.InferenceServerClient(
        urls=[servers.url(name) for name in scripts], **kwargs)
    outcomes = []
    try:
        for call in calls:
            try:
                outcomes.append(("ok", json.dumps(call(client, http), sort_keys=True)))
            except (InferenceServerException, JaxError) as e:
                outcomes.append(("error", e.status()))
    finally:
        client.close()
        servers.close()
    return servers.log, outcomes


def _metadata(client, http):
    return client.get_model_metadata("m")


def _infer_m(client, http):
    tensor = http.InferInput("X", [2], "FP32").set_data_from_numpy(np.ones(2, np.float32))
    return client.infer("m", [tensor]).get_response()


RESILIENCE = {
    "failover and retries": (
        {"a": ["drop", 503, 200], "b": [503, 429, 200]},
        [_metadata, _metadata, _infer_m, _infer_m, _metadata],
        dict(retry=dict(max_attempts=4, initial_backoff_s=0.001, jitter=False),
             breaker=dict(failure_threshold=3, cooldown_s=60), endpoint_cooldown_s=60),
    ),
    "breaker trips": (
        {"a": [503], "b": [502]},
        [_metadata, _metadata, _infer_m],
        dict(retry=dict(max_attempts=3, initial_backoff_s=0.001, jitter=False),
             breaker=dict(failure_threshold=2, cooldown_s=60), endpoint_cooldown_s=60),
    ),
    "dropped POSTs": (
        {"a": ["drop"], "b": ["drop", 200]},
        [_infer_m, _infer_m],
        dict(retry=dict(max_attempts=3, initial_backoff_s=0.001, jitter=False),
             endpoint_cooldown_s=60),
    ),
}


@pytest.mark.parametrize("case", list(RESILIENCE))
def test_resilience_makes_the_jax_clients_attempts(case):
    scripts, calls, kwargs = RESILIENCE[case]
    ours = _drive("port", scripts, calls, **kwargs)
    theirs = _drive("jax", scripts, calls, **kwargs)
    assert ours == theirs
    assert len({name for name, _, _ in ours[0]}) == len(scripts)  # both endpoints tried


def test_a_timeout_is_a_connection_error_retried_like_the_jax_clients():
    calls = [lambda c, h: c.infer("m", [h.InferInput("X", [2], "FP32").set_data_from_numpy(
        np.ones(2, np.float32))], client_timeout=0.2)]
    kwargs = dict(retry=dict(max_attempts=2, initial_backoff_s=0.001, jitter=False))
    ours = _drive("port", {"a": ["hang"]}, calls, **kwargs)
    assert ours == _drive("jax", {"a": ["hang"]}, calls, **kwargs)
    assert ours[1] == [("error", "CONNECTION_ERROR")]


def test_connections_are_kept_alive_capped_and_closed_when_the_server_says_so():
    async def requests(url, concurrency, burst, then):
        async with port_aio.InferenceServerClient(url, concurrency=concurrency) as client:
            await asyncio.gather(*(client.get_server_metadata() for _ in range(burst)))
            for _ in range(then):
                await client.get_server_metadata()

    busy = ScriptedServers({"a": [("slow", 0.05)]})
    try:
        asyncio.run(requests(busy.url("a"), 2, 8, 1))
        assert len(busy.log) == 9
        assert busy.open_max == 2  # the pool's cap
        assert busy.connections == 2  # kept alive, reused
    finally:
        busy.close()
    closing = ScriptedServers({"a": ["close", 200]})
    try:
        asyncio.run(requests(closing.url("a"), 1, 1, 2))
        assert len(closing.log) == 3
        assert closing.connections == 2  # a new one after the close, then reused
    finally:
        closing.close()


def test_torch_tensors_in_and_out(servers):
    client = servers["clients"][("port", "port")]
    values = torch.randn(64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    tensor = port_http.InferInput("INPUT0", [64], "BF16").set_data_from_torch(values)
    result = client.infer("identity_bf16", [tensor])
    assert result.get_output("OUTPUT0")["datatype"] == "BF16"
    back = result.as_torch("OUTPUT0", device="cpu")
    assert back.dtype == torch.bfloat16 and torch.equal(back, values)
    with pytest.raises(InferenceServerException, match="BYTES"):
        tensor = port_http.InferInput("INPUT0", [1], "BYTES")
        tensor.set_data_from_numpy(np.array([b"x"], dtype=object))
        client.infer("identity_bytes", [tensor]).as_torch("OUTPUT0", device="cpu")


def test_async_infer_and_its_callback(servers):
    client = servers["clients"][("port", "port")]
    done = threading.Event()
    seen = []
    tensor = port_http.InferInput("INPUT0", [3], "FP32").set_data_from_numpy(
        np.arange(3, dtype=np.float32))
    handle = client.async_infer("identity_fp32", [tensor],
                                callback=lambda r, e: (seen.append((r, e)), done.set()))
    assert handle.get_result(timeout=30).as_numpy("OUTPUT0").tolist() == [0.0, 1.0, 2.0]
    assert done.wait(30) and seen[0][1] is None


# ---------------------------------------------------------------------------
# the server's repairs, held to the JAX server
# ---------------------------------------------------------------------------

def _raw(url, method, path, body=b"", headers=None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        response = conn.getresponse()
        return response.status, dict(response.getheaders()), response.read()
    finally:
        conn.close()


@pytest.mark.parametrize("stream", [False, True])
def test_openai_errors_take_the_openai_body_shape(servers, stream):
    body = json.dumps({"model": "simple", "messages": [{"content": "hi"}],
                       "stream": stream}).encode()
    answers = {side: _raw(servers["urls"][side], "POST", "/v1/chat/completions", body,
                          {"Content-Type": "application/json"}) for side in ("port", "jax")}
    (status, headers, payload), (ref_status, ref_headers, ref_payload) = \
        answers["port"], answers["jax"]
    assert status == ref_status == 400
    assert json.loads(payload) == json.loads(ref_payload) == {"error": {"message": (
        "unexpected inference input 'INPUT_IDS' for model 'simple'")}}
    assert ("Retry-After" in headers) == ("Retry-After" in ref_headers)


def test_infer_decoupled_gives_a_non_decoupled_models_one_response():
    """The same ``simple`` request, and one it refuses, through each core's
    streaming entry: one response equal to ``infer``'s, and the same
    statistics counts."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    results = {}
    for side, core_module, register in (
            ("port", port_core, lambda r: port_models.register_builtin_models(r, device="cpu")),
            ("jax", jax_core, jax_models.register_builtin_models)):
        repository = ModelRepository() if side == "port" else JaxModelRepository()
        register(repository)
        core = core_module.ServerCore(repository)

        def request(name="INPUT0", core_module=core_module):
            tensors = [core_module.CoreTensor(n, "INT32", [1, 16], a) for n in (name, "INPUT1")]
            return core_module.CoreRequest(model_name="simple", inputs=tensors)

        async def run(core=core, request=request):
            responses = [r async for r in core.infer_decoupled(request())]
            with pytest.raises(Exception) as err:
                [r async for r in core.infer_decoupled(request("BOGUS"))]
            return responses, err.value

        try:
            responses, error = asyncio.run(run())
            stats = core.statistics("simple")["model_stats"][0]
        finally:
            core.close()
        results[side] = (
            [(r.model_name, r.parameters, [(t.name, t.datatype, t.shape, t.data.tobytes())
                                           for t in r.outputs]) for r in responses],
            error.message(),
            (stats["inference_count"], stats["execution_count"],
             {k: v["count"] for k, v in stats["inference_stats"].items()}),
        )
    assert results["port"] == results["jax"]
    assert len(results["port"][0]) == 1


def _chunked(body, sizes):
    out, pos = [], 0
    for size in sizes:
        piece = body[pos:pos + size]
        out.append(b"%x;ext=1\r\n%s\r\n" % (len(piece), piece))
        pos += size
    out.append(b"%x\r\n%s\r\n" % (len(body) - pos, body[pos:]) if pos < len(body) else b"")
    return b"".join(out) + b"0\r\nX-Trailer: 1\r\n\r\n"


def _socket_exchange(url, head, body):
    host, port = url.split(":")
    with socket.create_connection((host, int(port)), timeout=30) as sock:
        sock.sendall(head + body)
        received = b""
        while True:
            data = sock.recv(1 << 16)
            if not data:
                break
            received += data
    head_end = received.index(b"\r\n\r\n")
    return int(received.split(b" ", 2)[1]), received[head_end + 4:]


def test_a_chunked_body_answers_as_its_content_length_twin(servers):
    values = np.random.default_rng(5).normal(size=[3000]).astype(np.float32)
    header = json.dumps({"inputs": [{"name": "INPUT0", "shape": [3000], "datatype": "FP32",
                                     "parameters": {"binary_data_size": values.nbytes}}],
                         "outputs": [{"name": "OUTPUT0",
                                      "parameters": {"binary_data": True}}]}).encode()
    body = header + values.tobytes()
    common = (b"POST /v2/models/identity_fp32/infer HTTP/1.1\r\nHost: x\r\n"
              b"Connection: close\r\nInference-Header-Content-Length: %d\r\n" % len(header))
    answers = {}
    for side in ("port", "jax"):
        url = servers["urls"][side]
        sized = _socket_exchange(url, common + b"Content-Length: %d\r\n\r\n" % len(body), body)
        chunked = _socket_exchange(url, common + b"Transfer-Encoding: chunked\r\n\r\n",
                                   _chunked(body, [1, 100, 7000, 5]))
        assert sized[0] == chunked[0] == 200
        assert chunked[1] == sized[1] and values.tobytes() in sized[1]
        answers[side] = sized[1]
    assert answers["port"].endswith(values.tobytes()) and answers["jax"].endswith(
        values.tobytes())


@pytest.mark.parametrize("bad", [b"zz\r\nab\r\n0\r\n\r\n", b"4\r\nabcdXY0\r\n\r\n",
                                 b"10\r\nshort"])
def test_a_malformed_chunked_body_is_a_400(servers, bad):
    head = (b"POST /v2/models/identity_fp32/infer HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n")
    host, port = servers["urls"]["port"].split(":")
    with socket.create_connection((host, int(port)), timeout=30) as sock:
        sock.sendall(head + bad)
        sock.shutdown(socket.SHUT_WR)
        received = b""
        while data := sock.recv(1 << 16):
            received += data
    assert received.startswith(b"HTTP/1.1 400"), received[:80]


def test_a_body_over_one_gib_is_refused_before_it_is_read(servers):
    from client_tpu_torch.server.http_server import MAX_BODY_BYTES

    assert MAX_BODY_BYTES == 1 << 30
    head = (b"POST /v2/models/identity_fp32/infer HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % (MAX_BODY_BYTES + 1))
    status, _ = _socket_exchange(servers["urls"]["port"], head, b"")
    assert status == 413

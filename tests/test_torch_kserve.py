"""The port's KServe v2 infer route against the JAX server.

Two servers run in this process, each on its own event-loop thread: the
JAX package's (``client_tpu.testing.InProcessServer``, built-in models
plus a tiny fp32 ``text_encoder``) and the port's (its built-ins and the
same ``text_encoder`` on the same weights, through
``bert.params_from_jax``, all on ``device="cpu"``). The repo's own client,
``client_tpu.http.InferenceServerClient``, sends both the same requests in
JSON and in binary. Answers must be equal (``text_encoder``: within 1e-5,
fp32), the metadata, config and statistics documents must carry the JAX
server's keys, and the same malformed requests must get the same HTTP
statuses. The wire helpers are held to ``client_tpu.utils`` on the same
arrays.
"""

import asyncio
import gzip
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.http as httpclient
from client_tpu import utils as jax_utils
from client_tpu.models import bert as jax_bert
from client_tpu.models.serving import TextEncoderModel as JaxTextEncoderModel
from client_tpu.testing import InProcessServer
from client_tpu_torch import utils
from client_tpu_torch.models import bert
from client_tpu_torch.models.serving import TextEncoderModel
from client_tpu_torch.server.core import ServerCore
from client_tpu_torch.server.http_server import serve_http
from client_tpu_torch.server.model_repository import Model, ModelRepository
from client_tpu_torch.server.models import register_builtin_models

torch.set_num_threads(1)

TOL = 1e-5
JAX_CONFIG = jax_bert.BertConfig.tiny(dtype=jnp.float32)
CONFIG = bert.BertConfig.tiny(dtype=torch.float32)


class _RepeatModel(Model):
    """A decoupled model under the name the JAX server's built-in has."""

    name = "repeat_int32"
    decoupled = True
    inputs = [{"name": "IN", "datatype": "INT32", "shape": [-1]}]
    outputs = [{"name": "OUT", "datatype": "INT32", "shape": [1]}]

    async def execute_decoupled(self, inputs, parameters):
        for value in inputs["IN"].reshape(-1):
            yield {"OUT": np.array([value], dtype=np.int32)}


class _BrokenModel(Model):
    name = "broken"
    inputs = [{"name": "X", "datatype": "FP32", "shape": [-1]}]

    def warmup(self):
        raise RuntimeError("no weights")


class _SlowModel(Model):
    """A batchable model with a one-request waiting room."""

    name = "slow"
    max_batch_size = 4
    queue_policy = {"max_queue_size": 1}
    inputs = [{"name": "X", "datatype": "FP32", "shape": [2]}]
    outputs = [{"name": "Y", "datatype": "FP32", "shape": [2]}]

    def execute(self, inputs, parameters):
        time.sleep(0.4)
        return {"Y": inputs["X"]}


class PortServer:
    """The port's ``ServerCore`` + HTTP front-end on a loopback port."""

    def __init__(self, repository):
        self.core = ServerCore(repository, max_workers=4, device="cpu")
        self._loop = asyncio.new_event_loop()
        self._box = {}
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self._loop)
            self._box["http"] = self._loop.run_until_complete(
                serve_http(self.core, "127.0.0.1", 0))
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        assert started.wait(30)
        self.port = self._box["http"].port

    def close(self):
        async def stop():
            await self._box["http"].close()
            self.core.close()

        asyncio.run_coroutine_threadsafe(stop(), self._loop).result(30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(30)
        assert not self._thread.is_alive()
        self._loop.close()


@pytest.fixture(scope="module")
def servers():
    jax_params = jax.tree.map(
        np.asarray, jax_bert.init_params(jax.random.PRNGKey(0), JAX_CONFIG))
    reference = InProcessServer(grpc=False).start()
    reference.core.repository.add_model(
        JaxTextEncoderModel(config=JAX_CONFIG, params=jax_params))
    repository = ModelRepository()
    register_builtin_models(repository, device="cpu")
    repository.add_model(TextEncoderModel(
        config=CONFIG, params=bert.params_from_jax(jax_params, CONFIG, "cpu"), device="cpu"))
    for model in (_RepeatModel(), _BrokenModel(), _SlowModel()):
        repository.add_model(model)
    port = PortServer(repository)
    clients = {
        "jax": httpclient.InferenceServerClient(reference.http_url),
        "torch": httpclient.InferenceServerClient(f"127.0.0.1:{port.port}"),
    }
    yield {"jax": reference.http_port, "torch": port.port, "clients": clients,
           "port_core": port.core}
    for client in clients.values():
        client.close()
    port.close()
    reference.stop()


def _raw(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        response = conn.getresponse()
        return response.status, dict(response.getheaders()), response.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------

WIRE_CASES = {
    "fp32": np.random.default_rng(0).normal(size=[3, 5]).astype(np.float32),
    "int32": np.random.default_rng(1).integers(-2**31, 2**31 - 1, [4, 4], dtype=np.int32),
    "bf16": np.random.default_rng(2).normal(size=[7]).astype(ml_dtypes.bfloat16),
    "bf16_from_fp32": np.random.default_rng(3).normal(size=[2, 9]).astype(np.float32),
    "bytes": np.array([b"a", b"", "héllo".encode(), b"\x00\xff"], dtype=object),
    "str": np.array(["x", "yz"], dtype=np.str_),
    "empty_fp32": np.zeros([0, 3], dtype=np.float32),
    "empty_bytes": np.array([], dtype=object),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_helpers_match_client_tpu(case):
    array = WIRE_CASES[case]
    if case.startswith("bf16"):
        ours = utils.serialize_bf16_tensor(array)
        theirs = jax_utils.serialize_bf16_tensor(array)
        assert ours.dtype == np.uint8 and ours.tobytes() == theirs.tobytes()
        back = utils.deserialize_bf16_tensor(ours.tobytes())
        assert back.dtype == utils.bfloat16
        assert back.tobytes() == jax_utils.deserialize_bf16_tensor(theirs).tobytes()
        assert utils.deserialize_bf16_tensor(ours).tobytes() == ours.tobytes()
    elif array.dtype.kind in ("O", "U"):
        ours = utils.serialize_byte_tensor(array)
        theirs = jax_utils.serialize_byte_tensor(array)
        assert ours.dtype == np.uint8 and ours.tobytes() == theirs.tobytes()
        back = utils.deserialize_bytes_tensor(ours.tobytes())
        assert back.dtype == object
        assert list(back) == list(jax_utils.deserialize_bytes_tensor(theirs.tobytes()))
    datatype = utils.np_to_triton_dtype(array.dtype)
    assert datatype == jax_utils.np_to_triton_dtype(array.dtype)
    assert utils.triton_to_np_dtype(datatype) == jax_utils.triton_to_np_dtype(datatype)
    assert utils.triton_dtype_byte_size(datatype) == jax_utils.triton_dtype_byte_size(datatype)
    assert utils.num_elements(array.shape) == jax_utils.num_elements(array.shape)


def test_wire_helpers_refuse_what_client_tpu_refuses():
    for helper in ("deserialize_bytes_tensor",):
        for bad in (b"\x05\x00\x00\x00ab", b"\x01\x00"):
            with pytest.raises(utils.InferenceServerException):
                getattr(utils, helper)(bad)
            with pytest.raises(jax_utils.InferenceServerException):
                getattr(jax_utils, helper)(bad)
    with pytest.raises(utils.InferenceServerException):
        utils.serialize_byte_tensor(np.ones(3, np.float32))
    with pytest.raises(utils.InferenceServerException):
        utils.serialize_bf16_tensor(np.ones(3, np.int32))
    with pytest.raises(utils.InferenceServerException):
        utils.deserialize_bf16_tensor(b"\x01\x02\x03")
    with pytest.raises(utils.InferenceServerException):
        utils.triton_dtype_byte_size("FP8")
    for datatype in ("BOOL", "INT8", "UINT64", "FP16", "FP64", "BF16", "BYTES", "NOPE"):
        assert utils.triton_to_np_dtype(datatype) == jax_utils.triton_to_np_dtype(datatype)


# ---------------------------------------------------------------------------
# the infer route against the JAX server
# ---------------------------------------------------------------------------


def _inputs(model, binary, seed):
    rng = np.random.default_rng(seed)
    if model == "simple":
        a = rng.integers(-1000, 1000, [3, 16], dtype=np.int32)
        b = rng.integers(-1000, 1000, [3, 16], dtype=np.int32)
        arrays = [("INPUT0", a, "INT32"), ("INPUT1", b, "INT32")]
    elif model == "identity_fp32":
        arrays = [("INPUT0", rng.normal(size=[11]).astype(np.float32), "FP32")]
    elif model == "identity_bf16":
        arrays = [("INPUT0", rng.normal(size=[6]).astype(ml_dtypes.bfloat16), "BF16")]
    elif model == "identity_bytes":
        arrays = [("INPUT0", np.array([b"one", b"", b"three"], dtype=object), "BYTES")]
    else:
        ids = rng.integers(1, CONFIG.vocab_size, [2, 13], dtype=np.int32)
        arrays = [("INPUT_IDS", ids, "INT32")]
    inputs = []
    for name, array, datatype in arrays:
        tensor = httpclient.InferInput(name, list(array.shape), datatype)
        # BF16 has no JSON form: the client sends it binary either way
        tensor.set_data_from_numpy(array, binary_data=binary or datatype == "BF16")
        inputs.append(tensor)
    return inputs


OUTPUTS = {
    "simple": ["OUTPUT0", "OUTPUT1"],
    "identity_fp32": ["OUTPUT0"],
    "identity_bf16": ["OUTPUT0"],
    "identity_bytes": ["OUTPUT0"],
    "text_encoder": ["EMBEDDING"],
}


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
@pytest.mark.parametrize("model", sorted(OUTPUTS))
def test_infer_answers_as_the_jax_server(servers, model, binary):
    answers = {}
    for side, client in servers["clients"].items():
        outputs = [httpclient.InferRequestedOutput(name, binary_data=binary)
                   for name in OUTPUTS[model]]
        result = client.infer(model, _inputs(model, binary, seed=7), outputs=outputs,
                              request_id="r-1")
        response = result.get_response()
        assert response["model_name"] == model and response["id"] == "r-1"
        answers[side] = {o["name"]: (o["datatype"], o["shape"], result.as_numpy(o["name"]))
                         for o in response["outputs"]}
    assert answers["torch"].keys() == answers["jax"].keys()
    for name, (datatype, shape, array) in answers["jax"].items():
        ours = answers["torch"][name]
        assert ours[:2] == (datatype, shape)
        if model == "text_encoder":
            np.testing.assert_allclose(ours[2], array, rtol=0, atol=TOL)
        elif datatype == "BYTES":
            assert list(ours[2]) == list(array)
        else:
            assert ours[2].tobytes() == array.tobytes()


def test_simple_is_exact(servers):
    client = servers["clients"]["torch"]
    a = np.arange(32, dtype=np.int32).reshape(2, 16) - 7
    b = np.full([2, 16], 3, dtype=np.int32)
    for binary in (False, True):
        inputs = []
        for name, array in (("INPUT0", a), ("INPUT1", b)):
            tensor = httpclient.InferInput(name, [2, 16], "INT32")
            tensor.set_data_from_numpy(array, binary_data=binary)
            inputs.append(tensor)
        result = client.infer("simple", inputs)
        assert np.array_equal(result.as_numpy("OUTPUT0"), a + b)
        assert np.array_equal(result.as_numpy("OUTPUT1"), a - b)


def test_classification_answers_as_the_jax_server(servers):
    answers = []
    for client in servers["clients"].values():
        outputs = [httpclient.InferRequestedOutput("OUTPUT0", class_count=3)]
        result = client.infer("identity_fp32", _inputs("identity_fp32", True, 3),
                              outputs=outputs)
        answers.append(list(result.as_numpy("OUTPUT0")))
    assert answers[0] == answers[1] and len(answers[0]) == 3


def test_metadata_config_and_stats_have_the_jax_keys(servers):
    docs = {}
    for side, client in servers["clients"].items():
        client.infer("simple", _inputs("simple", True, 1))
        docs[side] = {
            "server": client.get_server_metadata(),
            "simple": client.get_model_metadata("simple"),
            "simple_v1": client.get_model_metadata("simple", "1"),
            "config": client.get_model_config("simple"),
            "encoder_config": client.get_model_config("text_encoder"),
            "stats": client.get_inference_statistics("simple"),
            "all_stats": client.get_inference_statistics(),
        }
    ours, theirs = docs["torch"], docs["jax"]
    assert {"name", "version", "extensions"} <= ours["server"].keys() <= theirs["server"].keys()
    assert set(ours["server"]["extensions"]) <= set(theirs["server"]["extensions"])
    for key in ("simple", "simple_v1"):
        assert ours[key].keys() == theirs[key].keys()
        for field in ("name", "versions", "inputs", "outputs"):
            assert ours[key][field] == theirs[key][field]
    for key in ("config", "encoder_config"):
        assert ours[key].keys() == theirs[key].keys()
        for field in ("max_batch_size", "input", "output", "dynamic_batching",
                      "model_transaction_policy"):
            assert ours[key][field] == theirs[key][field]
    snap, ref = ours["stats"]["model_stats"][0], theirs["stats"]["model_stats"][0]
    # the port adds one key, its stage ledger, beside the reference's
    assert snap.keys() - ref.keys() == {"stage_stats"} and ref.keys() <= snap.keys()
    assert snap["inference_stats"].keys() == ref["inference_stats"].keys()
    assert snap["name"] == "simple" and snap["inference_count"] >= 3
    assert snap["inference_stats"]["success"]["count"] >= 1
    names = {s["name"] for s in ours["all_stats"]["model_stats"]}
    assert {"simple", "text_encoder", "identity_bytes"} <= names
    assert "broken" not in names  # an unavailable model has no statistics


def _infer_body(inputs, binary_tail=b""):
    header = json.dumps({"inputs": inputs}).encode()
    headers = {"Content-Type": "application/octet-stream"}
    if binary_tail:
        headers["Inference-Header-Content-Length"] = str(len(header))
    return header + binary_tail, headers


def _row(n):
    return list(range(n))


MALFORMED = {
    "unknown_model": ("nope", [{"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
                                "data": _row(16)}]),
    "unexpected_input": ("simple", [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16], "data": _row(16)},
        {"name": "INPUT9", "datatype": "INT32", "shape": [1, 16], "data": _row(16)}]),
    "batch_over_max": ("simple", [
        {"name": n, "datatype": "INT32", "shape": [65, 16], "data": _row(65 * 16)}
        for n in ("INPUT0", "INPUT1")]),
    "mismatched_batch_dims": ("simple", [
        {"name": "INPUT0", "datatype": "INT32", "shape": [2, 16], "data": _row(32)},
        {"name": "INPUT1", "datatype": "INT32", "shape": [3, 16], "data": _row(48)}]),
    "truncated_binary": ("simple", [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}}]),
    "decoupled_model": ("repeat_int32", [
        {"name": "IN", "datatype": "INT32", "shape": [3], "data": [1, 2, 3]}]),
    "bad_datatype": ("identity_fp32", [
        {"name": "INPUT0", "datatype": "FP8", "shape": [1], "data": [1]}]),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_requests_get_the_jax_statuses(servers, case):
    model, inputs = MALFORMED[case]
    tail = b"\x00" * 100 if case == "truncated_binary" else b""
    body, headers = _infer_body(inputs, tail)
    statuses = {}
    for side in ("jax", "torch"):
        status, _, payload = _raw(servers[side], "POST", f"/v2/models/{model}/infer", body,
                                  headers)
        statuses[side] = status
        assert "error" in json.loads(payload)
    assert statuses["torch"] == statuses["jax"] == 400


@pytest.mark.parametrize("body,headers", [
    (b"{not json", {}),
    (b"[1, 2]", {}),
    (b'{"inputs": 5}', {}),
    (b'{"inputs": []}', {"Inference-Header-Content-Length": "x"}),
    (b'{"inputs": []}', {"Inference-Header-Content-Length": "99"}),
    (b"\x1f\x8b\x00garbage", {"Content-Encoding": "gzip"}),
    (b"{}", {"Content-Encoding": "br"}),
])
def test_undecodable_requests_are_a_400(servers, body, headers):
    status, _, payload = _raw(servers["torch"], "POST", "/v2/models/simple/infer", body,
                              headers)
    assert status == 400 and "error" in json.loads(payload)


def test_an_unavailable_model_is_a_503(servers):
    body, headers = _infer_body([{"name": "X", "datatype": "FP32", "shape": [1],
                                  "data": [1.0]}])
    status, _, payload = _raw(servers["torch"], "POST", "/v2/models/broken/infer", body,
                              headers)
    assert status == 503 and "not ready" in json.loads(payload)["error"]
    assert _raw(servers["torch"], "GET", "/v2/models/broken/ready")[0] == 400
    assert _raw(servers["torch"], "GET", "/v2/models/simple/ready")[0] == 200


def test_a_full_queue_is_a_429_with_retry_after(servers):
    body, headers = _infer_body([{"name": "X", "datatype": "FP32", "shape": [1, 2],
                                  "data": [1.0, 2.0]}])
    results = []
    start = threading.Barrier(6)

    def send():
        start.wait(30)  # all six arrive while the first executes
        results.append(_raw(servers["torch"], "POST", "/v2/models/slow/infer", body,
                            headers))

    threads = [threading.Thread(target=send) for _ in range(6)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(30)
    assert not any(thread.is_alive() for thread in threads)
    statuses = sorted(status for status, _, _ in results)
    assert 200 in statuses and 429 in statuses, statuses
    assert set(statuses) <= {200, 429}
    for status, response_headers, _ in results:
        if status == 429:
            assert int(response_headers["Retry-After"]) >= 1


def test_compressed_bodies_both_ways(servers):
    body, headers = _infer_body([
        {"name": n, "datatype": "INT32", "shape": [1, 16], "data": _row(16)}
        for n in ("INPUT0", "INPUT1")])
    headers.update({"Content-Encoding": "gzip", "Accept-Encoding": "gzip"})
    status, response_headers, payload = _raw(servers["torch"], "POST",
                                             "/v2/models/simple/infer",
                                             gzip.compress(body), headers)
    assert status == 200 and response_headers["Content-Encoding"] == "gzip"
    doc = json.loads(gzip.decompress(payload))
    assert doc["outputs"][0]["data"] == [2 * i for i in range(16)]


def test_concurrent_text_encoder_requests_share_executions(servers):
    """16 client threads over HTTP: every answer equals the single-request
    answer, and the statistics show fewer executions than requests."""
    port, core = servers["torch"], servers["port_core"]
    rng = np.random.default_rng(5)
    lengths = rng.integers(3, 200, 48)
    seqs = [rng.integers(1, CONFIG.vocab_size, n, dtype=np.int32) for n in lengths]
    model = core.repository.get("text_encoder")
    alone = [model.execute({"INPUT_IDS": s[None]}, {})["EMBEDDING"][0] for s in seqs]
    before = core.statistics("text_encoder")["model_stats"][0]
    answers = [None] * len(seqs)
    start = threading.Barrier(16)

    def send(worker):
        client = httpclient.InferenceServerClient(f"127.0.0.1:{port}")
        try:
            start.wait(30)
            for i in range(worker, len(seqs), 16):
                tensor = httpclient.InferInput("INPUT_IDS", [1, len(seqs[i])], "INT32")
                tensor.set_data_from_numpy(seqs[i][None])
                answers[i] = client.infer("text_encoder", [tensor]).as_numpy("EMBEDDING")[0]
        finally:
            client.close()

    threads = [threading.Thread(target=send, args=(w,)) for w in range(16)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(60)
    assert not any(thread.is_alive() for thread in threads)
    for got, want in zip(answers, alone):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    after = core.statistics("text_encoder")["model_stats"][0]
    requests = after["inference_count"] - before["inference_count"]
    executions = after["execution_count"] - before["execution_count"]
    assert requests == len(seqs)
    assert executions < requests

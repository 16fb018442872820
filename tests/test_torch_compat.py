"""The port's TFS and TorchServe front-ends and embedded runner, held to
``client_tpu``.

Twins of ``tests/test_compat_frontends.py``: the same requests go to the
JAX package's in-process server and the port's (``device="cpu"``), and
both must answer with the same status codes and the same JSON — TorchServe
``/ping`` and ``/predictions/<m>`` (raw and JSON bodies), TFS status,
metadata, ``:predict`` in row and column format with b64 string tensors,
a bad verb, an unloaded model — while the OpenAI ``GET /v1/models`` list
keeps answering beside them. The port's perf harness drives
``--service-kind tfserving`` and ``torchserve`` against both servers. The
port's ``EmbeddedRunner`` answers ``simple`` with the reference's bytes
on its binary wire (status, header length, body).
"""

import base64
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

from client_tpu.testing import InProcessServer as JaxInProcessServer
from client_tpu_torch.perf import cli
from client_tpu_torch.testing import InProcessServer

PACKAGES = ("port", "jax")


@pytest.fixture(scope="module")
def servers():
    with InProcessServer(device="cpu") as port, JaxInProcessServer(grpc=False) as jax_server:
        yield {"port": port, "jax": jax_server}


def _call(server, path, body=None, content_type="application/json"):
    request = urllib.request.Request(f"http://{server.http_url}{path}", data=body,
                                     headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(request, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _both(servers, path, body=None, content_type="application/json"):
    got = {which: _call(servers[which], path, body, content_type) for which in PACKAGES}
    assert got["port"] == got["jax"], path
    return got["port"]


def test_torchserve_ping_and_predict(servers):
    assert _both(servers, "/ping") == (200, {"status": "Healthy"})
    data = np.arange(6, dtype=np.float32)
    status, out = _both(servers, "/predictions/identity_fp32", data.tobytes(),
                        "application/octet-stream")
    assert status == 200 and np.allclose(np.asarray(out).reshape(-1), data)
    status, out = _both(servers, "/predictions/identity_fp32", json.dumps([1.5, 2.5]).encode())
    assert status == 200 and np.allclose(np.asarray(out).reshape(-1), [1.5, 2.5])
    # a batchable model gains its batch dim; a two-input one is refused
    assert _both(servers, "/predictions/simple", np.ones(16, np.int32).tobytes(),
                 "application/octet-stream")[0] == 400
    assert _both(servers, "/predictions/nope", b"\x00" * 4, "application/octet-stream")[0] == 400


def test_tfs_status_and_metadata(servers):
    status, doc = _both(servers, "/v1/models/simple")
    assert status == 200 and doc["model_version_status"][0]["state"] == "AVAILABLE"
    status, meta = _both(servers, "/v1/models/simple/metadata")
    sig = meta["metadata"]["signature_def"]["signature_def"]["serving_default"]
    assert sig["inputs"]["INPUT0"]["dtype"] == "DT_INT32"
    assert [d["size"] for d in sig["inputs"]["INPUT0"]["tensor_shape"]["dim"]] == ["-1", "16"]
    # the OpenAI model list still answers beside the TFS routes
    for which in PACKAGES:
        status, models = _call(servers[which], "/v1/models")
        assert status == 200 and models["object"] == "list", which


@pytest.mark.parametrize("body,check", [
    ({"instances": [{"INPUT0": list(range(16)), "INPUT1": [1] * 16},
                    {"INPUT0": [5] * 16, "INPUT1": [2] * 16}]},
     lambda doc: (np.asarray(doc["predictions"]["OUTPUT0"])[:, [3, 0]].tolist()
                  == [[4, 1], [7, 7]])),
    ({"inputs": {"INPUT0": [[1] * 16], "INPUT1": [[9] * 16]}},
     lambda doc: np.asarray(doc["predictions"]["OUTPUT1"])[0][0] == -8),
], ids=["rows", "columns"])
def test_tfs_predict_formats(servers, body, check):
    status, doc = _both(servers, "/v1/models/simple:predict", json.dumps(body).encode())
    assert status == 200 and check(doc)


def test_tfs_string_tensor_b64_and_errors(servers):
    body = {"instances": [{"b64": base64.b64encode(b"hello tfs").decode("ascii")}]}
    status, doc = _both(servers, "/v1/models/identity_bytes:predict",
                        json.dumps(body).encode())
    assert status == 200 and base64.b64decode(doc["predictions"][0]["b64"]) == b"hello tfs"
    for path, payload in (("/v1/models/simple:explain", b"{}"),
                          ("/v1/models/simple:predict", b"{}"),
                          ("/v1/models/simple:predict", b'{"instances": []}')):
        status, doc = _both(servers, path, payload)
        assert status == 400 and "error" in doc, path


def test_compat_routes_answer_an_unloaded_model_with_503(servers):
    for which in PACKAGES:
        servers[which].core.unload_model("identity_fp32")
    try:
        status, doc = _both(servers, "/v1/models/identity_fp32:predict",
                            json.dumps({"instances": [1.0]}).encode())
        assert status == 503 and "not ready" in doc["error"]
        assert _both(servers, "/predictions/identity_fp32", json.dumps([1.0]).encode())[0] == 503
    finally:
        for which in PACKAGES:
            servers[which].core.load_model("identity_fp32")


def _summary(capsys):
    out = capsys.readouterr().out
    return json.loads([line for line in out.splitlines() if line.strip().startswith("{")][-1])


WINDOWS = ["--concurrency-range", "2", "--measurement-interval", "300",
           "--stability-percentage", "80", "--max-trials", "2", "--json-summary"]


@pytest.mark.parametrize("which", PACKAGES)
def test_port_harness_tfserving(servers, which, capsys):
    code = cli.main(["-m", "simple", "-u", servers[which].http_url, "--service-kind",
                     "tfserving", "--shape", "INPUT0:1,16", "--shape", "INPUT1:1,16"] + WINDOWS)
    assert code == 0
    summary = _summary(capsys)
    assert summary["errors"] == 0 and summary["throughput"] > 0


@pytest.mark.parametrize("which", PACKAGES)
def test_port_harness_torchserve(servers, which, tmp_path, capsys):
    # the fabricated contract is one BYTES input named 'data'; the server
    # reads the posted body with the model's dtype
    (tmp_path / "data").write_bytes(np.asarray([1.5, 2.5], dtype=np.float32).tobytes())
    code = cli.main(["-m", "identity_fp32", "-u", servers[which].http_url, "--service-kind",
                     "torchserve", "--input-data", str(tmp_path)] + WINDOWS)
    assert code == 0
    summary = _summary(capsys)
    assert summary["errors"] == 0 and summary["throughput"] > 0


def test_rest_kinds_refuse_what_they_cannot_do(capsys):
    # unreachable: a clean exit 1; shared memory or a rolling restart: exit 2
    assert cli.main(["-m", "simple", "-u", "127.0.0.1:1", "--service-kind", "torchserve",
                     "--concurrency-range", "1", "--max-trials", "1"]) == 1
    assert cli.main(["-m", "simple", "-u", "127.0.0.1:1", "--service-kind", "tfserving",
                     "--shared-memory", "system"]) == 2
    assert cli.main(["-m", "simple", "-u", "127.0.0.1:1", "--service-kind", "tfserving",
                     "--rolling-restart", "1"]) == 2
    err = capsys.readouterr().err
    assert "--shared-memory is not supported by the tfserving service kind" in err
    assert "--rolling-restart needs the kserve http client" in err


def test_embedded_runner_wire_matches_client_tpu():
    from client_tpu.server import embedded as jax_embedded
    from client_tpu_torch.server import embedded

    header = {"inputs": [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
         "data": [1] * 16}],
        "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}},
                    {"name": "OUTPUT1"}]}
    head = json.dumps(header).encode()
    body = head + np.arange(16, dtype=np.int32).tobytes()
    runners = {"port": embedded.EmbeddedRunner(device="cpu"),
               "jax": jax_embedded.EmbeddedRunner()}
    try:
        answers = {}
        for which, runner in runners.items():
            ok = runner.infer("simple", body, len(head))
            bad = runner.infer("nope", body, len(head))
            answers[which] = (ok, struct.unpack("<IQ", bad[:12])[0], json.loads(bad[12:]),
                              json.loads(runner.model_metadata_json("simple"))["inputs"])
        assert answers["port"][1:] == answers["jax"][1:]
        for which, (ok, *_rest) in answers.items():
            status, header_len = struct.unpack("<IQ", ok[:12])
            doc = json.loads(ok[12:12 + header_len])
            outputs = {o["name"]: o for o in doc["outputs"]}
            summed = np.frombuffer(ok[12 + header_len:], dtype=np.int32)
            assert status == 0, which
            assert (summed == np.arange(16) + 1).all(), which
            assert outputs["OUTPUT1"]["data"] == [i - 1 for i in range(16)], which
        assert answers["port"][0] == answers["jax"][0]
    finally:
        runners["port"].shutdown()
        runners["jax"].shutdown()


def test_tfs_backend_builds_a_corpus_entry_once(servers):
    """The port's TFS backend resends a corpus entry's prepared JSON body
    (the reference's rebuilds it each time); the server answers both."""
    import asyncio

    from client_tpu_torch.perf.backend import PerfInferInput, TfsPerfBackend

    backend = TfsPerfBackend(servers["port"].http_url)
    builds = []
    body = backend._body

    def counting_body(inputs):
        builds.append(len(inputs))
        return body(inputs)

    backend._body = counting_body
    inputs = [PerfInferInput("INPUT0", [1, 16], "INT32", np.ones([1, 16], np.int32)),
              PerfInferInput("INPUT1", [1, 16], "INT32", np.ones([1, 16], np.int32))]

    async def run():
        try:
            await backend.infer("simple", inputs, cache_token="entry-0")
            assert backend.has_prepared("entry-0")
            await backend.infer("simple", (), cache_token="entry-0")
            await backend.infer("simple", inputs)
        finally:
            await backend.close()

    asyncio.run(run())
    assert builds == [2, 2]

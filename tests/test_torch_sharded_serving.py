"""The port's sharded serving models and the server's mesh surfaces.

``text_encoder_tp`` (dp2 x tp2) and ``llama_ring`` (sp2) on ``[cpu] * n``
meshes, with the JAX package's weights, against the JAX package's
unsharded ``TextEncoderModel`` and dense ``llama.forward``:

- ``text_encoder_tp`` within 1e-5 on all four ``ServerCore`` paths (the
  dynamic batcher, a single execution, ``infer_direct``, a stream);
- ``llama_ring`` within 1e-4 of the dense prefill's last position, and
  its refusals;
- the topology block of server metadata and ``debug_state()``, the model
  config's ``mesh`` parameter and the per-device busy counter (a device a
  mesh repeats is credited once);
- oversized and malformed meshes as load failures, the first leaving
  readiness alone; the zoo on a one-device host;
- the same surfaces over HTTP through the port's client.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import bert as jax_bert
from client_tpu.models import llama as jax_llama
from client_tpu.models.serving import TextEncoderModel as JaxTextEncoderModel
from client_tpu_torch.models import bert, llama
from client_tpu_torch.models.serving import (
    RingPrefillLlamaModel,
    ShardedTextEncoderModel,
    register_zoo_models,
)
from client_tpu_torch.observability.metrics import gauge_values, parse_exposition
from client_tpu_torch.parallel import sharding
from client_tpu_torch.server.core import CoreRequest, CoreTensor, ServerCore
from client_tpu_torch.server.model_repository import (
    Model,
    ModelRepository,
    ModelUnavailableError,
)
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

CPU = torch.device("cpu")
JAX_BERT = jax_bert.BertConfig.tiny(dtype=jnp.float32)
BERT = bert.BertConfig.tiny(dtype=torch.float32)
JAX_LLAMA = jax_llama.LlamaConfig.tiny(max_seq_len=256, dtype=jnp.float32)
LLAMA = llama.LlamaConfig.tiny(max_seq_len=256, dtype=torch.float32)


@pytest.fixture(scope="module")
def encoders():
    tree = jax.tree.map(np.asarray, jax_bert.init_params(jax.random.PRNGKey(6), JAX_BERT))
    reference = JaxTextEncoderModel(config=JAX_BERT, params=tree)
    reference.warmup()
    model = ShardedTextEncoderModel(config=BERT, params=bert.params_from_jax(tree, BERT, "cpu"),
                                    devices=[CPU] * 4)
    return reference, model


@pytest.fixture(scope="module")
def ring():
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(7), JAX_LLAMA))
    model = RingPrefillLlamaModel(config=LLAMA, params=llama.params_from_jax(tree, "cpu"),
                                  devices=[CPU, CPU])
    return tree, model


@pytest.fixture(scope="module")
def core(encoders, ring):
    repository = ModelRepository()
    repository.add_model(encoders[1])
    repository.add_model(ring[1])
    core = ServerCore(repository, max_workers=2, device="cpu")
    yield core
    core.close()


def _ids(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, BERT.vocab_size, n).astype(np.int32) for n in lengths]


def _request(model, array):
    return CoreRequest(model_name=model, inputs=[
        CoreTensor("INPUT_IDS", "INT32", list(array.shape), array)])


def _run_path(core, path, requests):
    """EMBEDDING of each request through one ServerCore path."""
    if path == "direct":
        responses = core.infer_direct(requests)
    else:
        async def one(request):
            if path == "stream":
                return [r async for r in core.infer_decoupled(request)][-1]
            return await core.infer(request)

        async def run():
            return await asyncio.gather(*(one(r) for r in requests))

        responses = asyncio.run(run())
    for response in responses:
        if isinstance(response, Exception):
            raise response
    return [np.asarray(r.outputs[0].data).reshape(-1, BERT.d_model) for r in responses]


@pytest.mark.parametrize("path", ["batched", "single", "direct", "stream"])
def test_text_encoder_tp_matches_jax_on_every_core_path(core, encoders, path):
    reference, _ = encoders
    seqs = _ids(len(path), [5, 17, 33, 64, 9])
    if path == "single":  # the unbatched form: [L], executed alone
        requests = [_request("text_encoder_tp", s) for s in seqs]
    else:
        requests = [_request("text_encoder_tp", s[None]) for s in seqs]
    before = core.statistics("text_encoder_tp")["model_stats"][0]["execution_count"]
    got = _run_path(core, path, requests)
    executions = core.statistics("text_encoder_tp")["model_stats"][0]["execution_count"]
    for seq, embedding in zip(seqs, got):
        want = np.asarray(reference.execute({"INPUT_IDS": seq[None]}, {})["EMBEDDING"])
        assert embedding.shape == want.shape == (1, BERT.d_model)
        assert np.abs(embedding - want).max() <= 1e-5
    if path in ("batched", "direct"):
        assert executions - before < len(seqs)  # the requests shared executions


def test_text_encoder_tp_splits_rows_over_dp(encoders):
    reference, model = encoders
    seqs = _ids(3, [7, 12, 3])
    ids = np.zeros([3, 12], dtype=np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    before = model._executor.snapshot()["executions"]
    out = model.execute({"INPUT_IDS": ids}, {})["EMBEDDING"]
    want = np.asarray(reference.execute({"INPUT_IDS": ids}, {})["EMBEDDING"])
    assert out.shape == (3, BERT.d_model) and np.abs(out - want).max() <= 1e-5
    assert model._executor.snapshot()["executions"] == before + 1
    with pytest.raises(InferenceServerException, match="exceeds max"):
        model.execute({"INPUT_IDS": np.ones([1, BERT.max_seq_len + 1], np.int32)}, {})
    with pytest.raises(InferenceServerException, match="token ids must lie"):
        model.execute({"INPUT_IDS": np.full([1, 4], BERT.vocab_size, np.int32)}, {})


def test_llama_ring_matches_the_dense_prefill(ring):
    tree, model = ring
    model.warmup()
    rng = np.random.default_rng(8)
    for length in (37, 100, 256):
        ids = rng.integers(0, LLAMA.vocab_size, [2, length]).astype(np.int32)
        got = model.execute({"INPUT_IDS": ids}, {})["LOGITS"]
        want = np.asarray(jax_llama.forward(tree, ids, JAX_LLAMA))[:, -1]
        assert got.shape == (2, LLAMA.vocab_size)
        assert np.abs(got - want).max() <= 1e-4
    with pytest.raises(InferenceServerException, match="non-empty prompt"):
        model.execute({"INPUT_IDS": np.zeros([1, 0], np.int32)}, {})
    with pytest.raises(InferenceServerException, match="exceeds max"):
        model.execute({"INPUT_IDS": np.zeros([1, 257], np.int32)}, {})
    with pytest.raises(InferenceServerException, match="token ids must lie"):
        model.execute({"INPUT_IDS": np.full([1, 4], LLAMA.vocab_size, np.int32)}, {})


def test_topology_config_and_debug_state_carry_the_meshes(core):
    _run_path(core, "batched", [_request("text_encoder_tp", _ids(1, [6])[0][None])])
    topology = core.device_topology()
    assert topology["platform"] == "cpu"
    encoder, ring = topology["models"]["text_encoder_tp"], topology["models"]["llama_ring"]
    assert encoder["axes"] == {"dp": 2, "tp": 2} and encoder["devices"] == ["cpu"] * 4
    assert encoder["inputs"] == {"INPUT_IDS": ["dp", None]}
    assert encoder["executor"]["executions"] >= 2 and encoder["executor"]["compute_ns"] > 0
    assert ring["axes"] == {"dp": 1, "tp": 1, "sp": 2}
    assert core.debug_state()["devices"]["models"]["text_encoder_tp"]["axes"] == encoder["axes"]
    model = core.repository.get("text_encoder_tp")
    mesh = json.loads(model.config()["parameters"]["mesh"]["string_value"])
    assert mesh["axes"] == {"dp": 2, "tp": 2} and mesh["device_count"] == 4


class _Declared(Model):
    inputs = [{"name": "X", "datatype": "FP32", "shape": [-1]}]
    outputs = [{"name": "X", "datatype": "FP32", "shape": [-1]}]

    def __init__(self, name, mesh, devices=None):
        self.name, self.mesh, self.device, self.devices = name, mesh, CPU, devices

    def warmup(self):
        self.mesh_plan = sharding.plan_for_model(self, self.devices)


def test_busy_ns_credits_each_distinct_card_of_a_mesh_once():
    repository = ModelRepository()
    cards = [torch.device("cuda", 0), torch.device("cuda", 0), torch.device("cuda", 1)]
    model = _Declared("sharded", {"axes": {"tp": 3}}, cards)
    repository.add_model(model)
    core = ServerCore(repository, max_workers=1, device="cpu")
    try:
        core.add_busy_ns(model, 100)
        core.add_busy_ns(_Declared("on_cpu", {"axes": {"tp": 2}}, [CPU, CPU]), 50)
        assert core.device_busy_by_device() == {"cuda:0": 100, "cuda:1": 100}
        assert core.device_busy_ns_total == 100
        family = parse_exposition(core.metrics.render())["tpu_device_compute_ns_total"]
        assert gauge_values(family, {"device": "cuda:0"}) == [100.0]
        assert gauge_values(family, {"device": "cuda:1"}) == [100.0]
        assert core.device_topology()["models"]["sharded"]["devices"] == [
            "cuda:0", "cuda:0", "cuda:1"]
    finally:
        core.close()


def test_oversized_and_malformed_meshes_are_load_failures():
    repository = ModelRepository()
    repository.add_model(_Declared("oversized", {"axes": {"dp": 16}}))
    core = ServerCore(repository, max_workers=1, device="cpu")
    try:
        (entry,) = repository.index()
        assert entry["state"] == "UNAVAILABLE"
        assert entry["reason"] == "load failed: mesh requires 16 devices, host has 1"
        assert not repository.degraded()  # the host lacks devices; nothing is broken
        with pytest.raises(ModelUnavailableError):
            repository.get("oversized")
        assert isinstance(core.infer_direct([CoreRequest("oversized")])[0],
                          ModelUnavailableError)
        assert core.device_topology()["models"]["oversized"] == {
            "axes": {"dp": 16}, "resolved": False,
            "reason": "load failed: mesh requires 16 devices, host has 1"}
        config = repository.peek("oversized").config()
        assert json.loads(config["parameters"]["mesh"]["string_value"]) == {
            "axes": {"dp": 16}, "resolved": False}
        repository.add_model(_Declared("malformed", {"axes": {"dp": "two"}}))
        reasons = {e["name"]: e["reason"] for e in repository.index()}
        assert reasons["malformed"] == (
            "load failed: mesh axis 'dp' size must be a positive int, got 'two'")
        assert repository.degraded()  # a broken declaration is a broken model
        # the same name loading again with devices recovers it
        repository.peek("oversized").devices = [CPU] * 16
        repository.load("oversized")
        assert repository.is_ready("oversized")
    finally:
        core.close()


def test_the_zoo_on_one_device_registers_the_meshes_unavailable():
    repository = ModelRepository()
    register_zoo_models(repository, device="cpu")
    entries = {e["name"]: e for e in repository.index()}
    assert entries["text_encoder_tp"]["reason"] == (
        "load failed: mesh requires 4 devices, host has 1")
    assert entries["llama_ring"]["reason"] == "load failed: mesh requires 2 devices, host has 1"
    others = [e["state"] for name, e in entries.items()
              if name not in ("text_encoder_tp", "llama_ring")]
    assert others == ["READY"] * 4
    assert not repository.degraded()
    core = ServerCore(repository, max_workers=1, device="cpu")
    try:
        models = core.device_topology()["models"]
        assert models["llama_ring"]["resolved"] is False
        assert models["text_encoder_tp"]["axes"] == {"dp": 2, "tp": 2}
    finally:
        core.close()


def test_the_meshes_over_http(encoders, ring):
    import client_tpu_torch.http as client_http
    from client_tpu_torch.testing import InProcessServer

    reference, model = encoders
    server = InProcessServer(device="cpu", builtin_models=False)
    server.core.repository.add_model(model)
    server.core.repository.add_model(RingPrefillLlamaModel(config=LLAMA, device="cpu"))
    with server, client_http.InferenceServerClient(server.http_url) as client:
        assert client.is_server_ready()
        assert [m["state"] for m in client.get_model_repository_index()] == [
            "READY", "UNAVAILABLE"]
        seq = _ids(4, [21])[0][None]
        tensor = client_http.InferInput("INPUT_IDS", list(seq.shape), "INT32")
        tensor.set_data_from_numpy(seq)
        got = client.infer("text_encoder_tp", [tensor]).as_numpy("EMBEDDING")
        want = np.asarray(reference.execute({"INPUT_IDS": seq}, {})["EMBEDDING"])
        assert np.abs(got - want).max() <= 1e-5
        metadata = client.get_server_metadata()
        assert metadata["devices"]["models"]["text_encoder_tp"]["axes"] == {"dp": 2, "tp": 2}
        assert metadata["devices"]["models"]["llama_ring"]["reason"] == (
            "load failed: mesh requires 2 devices, host has 1")
        config = client.get_model_config("text_encoder_tp")
        assert json.loads(config["parameters"]["mesh"]["string_value"])["axes"] == {
            "dp": 2, "tp": 2}
        with pytest.raises(Exception, match="not ready|unavailable|503"):
            client.infer("llama_ring", [tensor])

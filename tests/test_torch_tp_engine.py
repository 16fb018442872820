"""The port's tensor-parallel engine against the JAX package's unsharded one.

The same weights (the JAX pytree through ``params_from_jax``) and token
ids (numpy seeds) go through the JAX package's unsharded paged functions
and the port's at tp 2 and 4, every shard on the CPU (``[cpu] * tp``):

- prefill, suffix prefill, decode steps (the JAX side's attention is
  ``paged_attention_fused_xla``) and a verify step within 1e-5 of the JAX
  logits, with the same argmax; shard i's pools equal KV-head slice i of
  the JAX pool;
- ``LlmEngineModel(tp=N, devices=[cpu] * N)`` streams equal JAX
  ``llama.generate`` token for token, with speculation off and on, and
  after a reload;
- the load failures: a tp that does not divide the heads (the reference's
  reason, word for word) and too few devices.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.llm.serving import LlmEngineModel as JaxLlmEngineModel
from client_tpu.models import llama as jax_llama
from client_tpu.models import paged_attention as jax_pa
from client_tpu_torch.llm.engine import EngineConfig
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama
from client_tpu_torch.models import paged_attention as pa
from client_tpu_torch.parallel import sharding
from client_tpu_torch.server.model_repository import ModelRepository
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

TOL = 1e-5
MAX_TOKENS = 10
JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CONFIG = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
CPU = torch.device("cpu")
BLOCKS, BLOCK_SIZE = 17, 8


@pytest.fixture(scope="module")
def weights():
    jax_params = jax_llama.init_params(jax.random.PRNGKey(1), JAX_CONFIG)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    return jax_params, params


def _plan(tp):
    return sharding.resolve(sharding.MeshSpec.parse({"axes": {"tp": tp}}), [CPU] * tp)


def _steps():
    """The host inputs of one scenario: a prefill of 20 tokens, a suffix
    prefill sharing its first 2 blocks, 3 decode steps of both lanes and a
    verify step of 5 rows (lane 1's last 2 are padding)."""
    rng = np.random.default_rng(5)
    tokens = np.zeros([1, 32], dtype=np.int32)
    tokens[0, :20] = rng.integers(0, CONFIG.vocab_size, 20)
    table_a = np.zeros([8], dtype=np.int32)
    table_a[:4] = [1, 2, 3, 4]
    suffix = np.zeros([1, 16], dtype=np.int32)
    suffix[0, :6] = rng.integers(0, CONFIG.vocab_size, 6)
    table_b = np.zeros([8], dtype=np.int32)
    table_b[:4] = [1, 2, 5, 6]
    tables = np.stack([table_a, table_b])[:, :4]
    steps = [("prefill", (tokens, table_a, 19, 0)), ("suffix", (suffix, table_b, 5, 16))]
    for i in range(3):
        steps.append(("decode", (rng.integers(0, CONFIG.vocab_size, 2).astype(np.int32),
                                 np.array([20 + i, 22 + i], dtype=np.int32), tables)))
    rows = np.array([23, 25], dtype=np.int32)[:, None] + np.arange(5, dtype=np.int32)
    steps.append(("verify", (rng.integers(0, CONFIG.vocab_size, [2, 5]).astype(np.int32),
                             rows, np.array([5, 3], dtype=np.int32), tables)))
    return steps


def _run_jax(jax_params):
    pages = jax_llama.init_kv_pages(JAX_CONFIG, BLOCKS, BLOCK_SIZE)
    out = []
    for kind, args in _steps():
        if kind == "prefill":
            tokens, table, last, _ = args
            logits, pages = jax_llama.prefill_into_pages(jax_params, tokens, table, pages,
                                                         last, JAX_CONFIG)
        elif kind == "suffix":
            tokens, table, last, start = args
            logits, pages = jax_llama.prefill_suffix_into_pages(
                jax_params, tokens, table, pages, last, start, 2, JAX_CONFIG)
        elif kind == "decode":
            logits, pages = jax_llama.decode_step_paged_attn(
                jax_params, *args, pages, JAX_CONFIG, jax_pa.paged_attention_fused_xla)
        else:
            logits, pages = jax_llama.decode_step_paged_multi(
                jax_params, *args, pages, JAX_CONFIG, jax_pa.paged_attention_fused_xla_mq)
        out.append((kind, np.asarray(logits)))
    return out, [(np.asarray(k), np.asarray(v)) for k, v in pages]


def _run_port(params, tp):
    """The scenario through the port's paged functions over ``tp``
    shards, as the engine's tp warmup builds them."""
    plan = _plan(tp)
    shards = llama.shard_params(params, CONFIG, plan)
    kv = CONFIG.n_kv_heads // tp
    pages = [[(torch.zeros(BLOCKS, BLOCK_SIZE, kv, CONFIG.head_dim),
               torch.zeros(BLOCKS, BLOCK_SIZE, kv, CONFIG.head_dim))
              for _ in range(CONFIG.n_layers)] for _ in range(tp)]
    attn = pa.make_tp_attention(pa.paged_attention_cuda, plan)
    attn_mq = pa.make_tp_attention(pa.paged_attention_cuda_mq, plan, multi_query=True)
    out = []
    with torch.inference_mode():
        for kind, args in _steps():
            t = [torch.from_numpy(a) for a in args if isinstance(a, np.ndarray)]
            if kind == "prefill":
                logits, pages = llama.prefill_into_pages(shards, t[0], t[1], pages,
                                                         args[2], CONFIG)
            elif kind == "suffix":
                logits, pages = llama.prefill_suffix_into_pages(
                    shards, t[0], t[1], pages, args[2], args[3], 2, CONFIG)
            elif kind == "decode":
                logits, pages = llama.decode_step_paged_attn(shards, *t, pages, CONFIG, attn)
            else:
                logits, pages = llama.decode_step_paged_multi(shards, *t, pages, CONFIG,
                                                              attn_mq)
            out.append((kind, logits.numpy()))
    return out, pages


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_device_functions_match_the_unsharded_jax_functions(weights, tp):
    jax_params, params = weights
    want, jax_pages = _run_jax(jax_params)
    got, shard_pages = _run_port(params, tp)
    for (kind, a), (_, b) in zip(want, got):
        assert a.shape == b.shape, kind
        assert np.abs(a - b).max() <= TOL, kind
        assert np.array_equal(a.argmax(-1), b.argmax(-1)), kind
    kv = CONFIG.n_kv_heads // tp
    for i, pools in enumerate(shard_pages):
        for (jk, jv), (k, v) in zip(jax_pages, pools):
            assert k.is_contiguous() and tuple(k.shape) == (BLOCKS, BLOCK_SIZE, kv,
                                                            CONFIG.head_dim)
            # every slot but the trash block's (which padding overwrites in
            # either order) holds KV-head slice i of the reference pool
            for ours, theirs in ((k, jk), (v, jv)):
                want_slice = theirs[1:, :, i * kv:(i + 1) * kv]
                assert np.abs(ours[1:].numpy() - want_slice).max() <= TOL
                assert np.count_nonzero(want_slice) > 0


def test_make_tp_attention_runs_each_head_slice_on_its_pool():
    rng = np.random.default_rng(2)
    b, h, kv, d, bs = 2, 8, 4, 16, 4
    q = torch.from_numpy(rng.normal(size=[b, h, d]).astype(np.float32))
    k_pages, v_pages = (torch.from_numpy(rng.normal(size=[6, bs, kv, d]).astype(np.float32))
                        for _ in range(2))
    tables = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    positions = torch.tensor([9, 5], dtype=torch.int32)
    want = pa.paged_attention_standin(q, k_pages, v_pages, tables, positions)
    for tp in (2, 4):
        plan = _plan(tp)
        wrapped = pa.make_tp_attention(pa.paged_attention_cuda, plan)
        pools = [p.chunk(tp, dim=2) for p in (k_pages, v_pages)]
        outs = wrapped(q, [t.contiguous() for t in pools[0]],
                       [t.contiguous() for t in pools[1]], tables, positions)
        assert len(outs) == tp
        assert np.abs(torch.cat(outs, dim=1).numpy() - want.numpy()).max() <= TOL
        # the head-sharded form: the list of blocks
        blocks = list(q.chunk(tp, dim=1))
        assert all(torch.equal(x, y) for x, y in zip(
            wrapped(blocks, [t.contiguous() for t in pools[0]],
                    [t.contiguous() for t in pools[1]], tables, positions), outs))
        multi = pa.make_tp_attention(pa.paged_attention_cuda_mq, plan, multi_query=True)
        with pytest.raises(ValueError, match="rank 4"):
            multi(q, pools[0], pools[1], tables, positions)


def _engine(params, tp, speculation=None):
    return LlmEngineModel(
        config=CONFIG, params=params, tp=tp, devices=[CPU] * tp, speculation=speculation,
        engine_config=EngineConfig(block_size=BLOCK_SIZE, num_blocks=1 + 8 * 8,
                                   max_active=8, max_queue=32, max_seq_len=64))


async def _generate(model, prompt):
    out = []
    async for item in model.execute_decoupled(
        {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, {"max_tokens": MAX_TOKENS}
    ):
        out.append(int(item["OUTPUT_IDS"][0]))
    return out


def _streams(model, prompts):
    async def run():
        return await asyncio.gather(*(_generate(model, p) for p in prompts))

    return asyncio.run(run())


def _prompts():
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, CONFIG.vocab_size, 16).tolist()
    return [prefix + rng.integers(0, CONFIG.vocab_size, 4).tolist() for _ in range(4)]


def _jax_streams(jax_params, prompts):
    generate = jax.jit(lambda p, t: jax_llama.generate(p, t, JAX_CONFIG, MAX_TOKENS))
    return np.asarray(generate(jax_params, np.array(prompts, dtype=np.int32))).tolist()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("speculation", [None, {"mode": "ngram", "k": 3, "ngram": 1},
                                         {"mode": "draft", "draft": "self", "k": 2}],
                         ids=["off", "ngram", "self_draft"])
def test_tp_engine_streams_equal_jax_generate(weights, tp, speculation):
    jax_params, params = weights
    prompts = _prompts()
    model = _engine(params, tp, speculation)
    model.warmup()
    try:
        assert model.mesh_plan.describe()["axes"] == {"tp": tp}
        assert model.decode_kernel == "fused"
        assert model.config()["parameters"]["tp"]["string_value"] == str(tp)
        assert _streams(model, prompts) == _jax_streams(jax_params, prompts)
        stats = model.engine.stats()
        assert stats["kv_blocks_in_use"] == 0 and stats["prefix_cache_hits"] >= 1
        if speculation is not None and speculation["mode"] == "draft":
            assert stats["spec_steps"] >= 1
    finally:
        model.shutdown()


def test_tp_reload_rebuilds_the_sharded_engine(weights):
    jax_params, params = weights
    prompts = _prompts()
    model = _engine(params, 2)
    model.warmup()
    try:
        first = model.engine
        model.reload()
        assert model.engine is not first and model.mesh_plan.devices == (CPU, CPU)
        assert _streams(model, prompts) == _jax_streams(jax_params, prompts)
    finally:
        model.shutdown()


def test_a_tp_that_does_not_divide_the_heads_fails_with_the_reference_reason(weights):
    jax_params, params = weights
    with pytest.raises(Exception) as theirs:
        JaxLlmEngineModel(config=JAX_CONFIG, params=jax_params, tp=3).warmup()
    repository = ModelRepository()
    repository.add_model(_engine(params, 3))
    (entry,) = repository.index()
    assert entry["state"] == "UNAVAILABLE"
    assert entry["reason"] == f"load failed: {theirs.value}"
    assert str(theirs.value) == "tp=3 must divide n_heads=4 and n_kv_heads=4"
    # a failed tp load degrades readiness: the model is broken, not the host
    assert repository.degraded()


def test_tp_without_devices_resolves_against_the_host(weights):
    _, params = weights
    model = LlmEngineModel(config=CONFIG, params=params, tp=2, device="cpu")
    with pytest.raises(InferenceServerException, match="^mesh requires 2 devices, host has 1$"):
        model.warmup()
    assert model.engine is None and model.mesh_plan is None
    repository = ModelRepository()
    repository.add_model(model)
    assert repository.index()[0]["reason"] == "load failed: mesh requires 2 devices, host has 1"
    # a host without the devices is no broken model: readiness holds
    assert not repository.degraded()

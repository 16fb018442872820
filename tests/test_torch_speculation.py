"""The port's speculative decoding against the JAX package.

- The multi-query attention twins (``paged_attention_standin_mq``,
  ``paged_attention_fused_mq`` and the K2 wrapper ``paged_attention_cuda_mq``,
  which on CPU tensors takes its plain version) within 1e-5 of the JAX
  stand-in, of the Pallas kernel under the interpreter, and of T
  sequential single-query calls: T in {1, 2, 3, 5}, groups 1, 2 and 4,
  block sizes 8 and 16, ragged contexts, padding rows and a padding lane.
- ``decode_step_paged_multi`` against the JAX step on the same weights
  (logits within 1e-4; the pools written at the same slots, every other
  byte identical) and against T sequential port ``decode_step_paged``
  calls (1e-5); padding rows never touch a live slot.
- The proposers give the JAX proposers' proposals on the same inputs and
  weights; ``build_proposer`` refuses what it cannot build.
- The engine model with speculation on: greedy streams equal JAX
  ``generate`` for both proposers at K in {1, 2, 4}, the per-request
  switch, seeded sampled streams equal to spec-off, and the counters in
  ``config()``.

Inputs are made with numpy from seeds and handed to both sides; the
kernel itself is held to its plain version on the card in
``test_torch_cuda.py``.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.llm import speculation as jax_spec
from client_tpu.models import llama as jax_llama
from client_tpu.models import paged_attention as jax_pa
from client_tpu_torch.llm import DraftModelProposer, NgramProposer, build_proposer
from client_tpu_torch.llm.engine import EngineConfig
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama
from client_tpu_torch.models import paged_attention as pa
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

ATTN_TOL = 1e-5
LOGITS_TOL = 1e-4
BS = 8
JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CONFIG = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)

_jax_standin_mq = jax.jit(jax_pa.paged_attention_standin_mq)


@pytest.fixture(scope="module")
def weights():
    init = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))
    jax_params = init(jax.random.PRNGKey(0))
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    return jax_params, params


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the multi-query attention twins
# ---------------------------------------------------------------------------


def _ragged_mq_case(seed, b, nb, bs, g, t, kv=2, d=16):
    """Random pages and a ragged verify layout: lane i holds a random
    context and ``lengths[i]`` real rows at consecutive positions after
    it, its padding rows clamped to the last real one (as the engine
    sends them); the last lane (when b > 1) is a padding lane: all-zero
    table, positions 0."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + b * nb
    k_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    tables = np.zeros((b, nb), dtype=np.int32)
    positions = np.zeros((b, t), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for i in range(b - 1 if b > 1 else b):
        n_ctx = int(rng.integers(0, nb * bs - t + 1))  # slots before row 0
        length = int(rng.integers(1, t + 1))
        positions[i] = n_ctx + np.minimum(np.arange(t), length - 1)
        for j in range((n_ctx + length + bs - 1) // bs):
            tables[i, j] = free.pop()
    q = rng.normal(size=(b, t, kv * g, d)).astype(np.float32)
    return q, k_pages, v_pages, tables, positions


PORT_MQ = ("standin", "fused", "cuda")


@pytest.mark.parametrize("t", [1, 2, 3, 5])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16])
def test_mq_attention_matches_jax_and_sequential_decode(t, g, bs):
    """Every port twin against the JAX stand-in, and each verify row
    against a single-query call at that row's position."""
    case = _ragged_mq_case(t * 100 + g * 10 + bs, 4, 4, bs, g, t)
    ref = np.asarray(_jax_standin_mq(*case))
    q, k, v, tables, positions = _torch(case)
    sequential = torch.stack(
        [pa.paged_attention_fused(q[:, r].contiguous(), k, v, tables, positions[:, r])
         for r in range(t)], dim=1,
    ).numpy()
    assert np.abs(sequential - ref).max() <= ATTN_TOL
    for name in PORT_MQ:
        out = pa.get_attention_impl_mq(name)(q, k, v, tables, positions).numpy()
        assert out.shape == ref.shape and np.isfinite(out).all(), name
        assert np.abs(out - ref).max() <= ATTN_TOL, name
        assert np.abs(out - sequential).max() <= ATTN_TOL, name


# the interpreter is slow: one case per layout, covering both block sizes,
# every group size and a T that is not a power of two
@pytest.mark.parametrize(
    "b,nb,bs,g,t", [(1, 2, 8, 1, 2), (3, 4, 16, 2, 3), (4, 4, 8, 4, 5), (4, 2, 16, 1, 5)]
)
def test_mq_attention_matches_jax_pallas_interpret(b, nb, bs, g, t):
    case = _ragged_mq_case(b * 1000 + nb * 100 + bs * 10 + g + t, b, nb, bs, g, t)
    ref = np.asarray(jax_pa.paged_attention_pallas_interpret_mq(*case))
    for name in PORT_MQ:
        out = pa.get_attention_impl_mq(name)(*_torch(case)).numpy()
        assert np.abs(out - ref).max() <= ATTN_TOL, name


def test_a_row_past_a_whole_chunk_of_later_rows_stays_finite():
    """Row 0 sits at position 0 and the later rows far past it, so whole
    stretches of the walk are visible to later rows only: every row
    still equals its own single-query call (no NaN from an empty row)."""
    q, k, v, tables, _ = _ragged_mq_case(3, 2, 4, 8, 2, 3)
    positions = np.array([[0, 20, 31], [5, 5, 5]], dtype=np.int32)
    tables[0] = [1, 2, 3, 4]
    q, k, v, tables, positions = _torch((q, k, v, tables, positions))
    out = pa.paged_attention_cuda_mq(q, k, v, tables, positions)
    assert torch.isfinite(out).all()
    for r in range(3):
        row = pa.paged_attention_standin(q[:, r].contiguous(), k, v, tables, positions[:, r])
        assert (out[:, r] - row).abs().max() <= ATTN_TOL


def test_mq_wrapper_on_cpu_takes_the_plain_version_without_counting():
    case = _torch(_ragged_mq_case(5, 3, 2, 8, 2, 3))
    before = pa.paged_attention_cuda_mq.launches
    out = pa.paged_attention_cuda_mq(*case)
    assert torch.equal(out, pa.paged_attention_fused_mq(*case))
    assert pa.paged_attention_cuda_mq.launches == before


def test_mq_wrapper_checks_and_resolution():
    q, k, v, tables, positions = _torch(_ragged_mq_case(9, 2, 2, 8, 2, 3))
    with pytest.raises(ValueError, match="positions must be"):
        pa._check_cuda_args(q, k, v, tables, positions[:, 0], multi_query=True)
    with pytest.raises(ValueError, match=r"\[B, T, H, D\]"):
        pa._check_cuda_args(q[:, 0], k, v, tables, positions, multi_query=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_attention_cuda_mq(*(x.to("meta") for x in (q, k, v, tables, positions)))
    pa._check_cuda_args(q, k, v, tables, positions, multi_query=True)  # takes it
    assert pa.resolve_verify_attention(torch.device("cuda")) == ("cuda", pa.paged_attention_cuda_mq)
    assert pa.resolve_verify_attention(torch.device("cpu")) == ("fused", pa.paged_attention_fused_mq)
    assert pa.get_attention_impl_mq("standin") is pa.paged_attention_standin_mq
    with pytest.raises(ValueError, match="unknown paged-attention kernel"):
        pa.get_attention_impl_mq("pallas")


# ---------------------------------------------------------------------------
# decode_step_paged_multi
# ---------------------------------------------------------------------------

CONTEXTS = [[5, 9, 17, 3, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [7]]
LAST = np.array([11, 12, 13], dtype=np.int32)
DRAFTS = np.array([[3, 7], [9, 1], [2, 4]], dtype=np.int32)
T = 3

_jax_prefill = jax.jit(
    lambda p, t, tbl, pages, last: jax_llama.prefill_into_pages(p, t, tbl, pages, last, JAX_CONFIG)
)
_jax_multi = jax.jit(
    lambda p, t, pos, lens, tbl, pages: jax_llama.decode_step_paged_multi(
        p, t, pos, lens, tbl, pages, JAX_CONFIG, jax_pa.paged_attention_pallas_interpret_mq)
)


@pytest.fixture(scope="module")
def verify_state(weights):
    """Three contexts prefilled into a JAX pool, with room for T more
    positions each."""
    jax_params, _ = weights
    tables = np.zeros((len(CONTEXTS), 8), dtype=np.int32)
    next_free = 1
    pages = jax_llama.init_kv_pages(JAX_CONFIG, 33, BS)
    for i, context in enumerate(CONTEXTS):
        n_blocks = (len(context) + T + BS - 1) // BS
        tables[i, :n_blocks] = range(next_free, next_free + n_blocks)
        next_free += n_blocks
        tokens = np.zeros([1, 16], dtype=np.int32)
        tokens[0, : len(context)] = context
        _, pages = _jax_prefill(jax_params, tokens, tables[i], pages, len(context) - 1)
    before = [(np.asarray(k), np.asarray(v)) for k, v in pages]
    tokens = np.concatenate([LAST[:, None], DRAFTS], axis=1)
    pos0 = np.array([len(c) for c in CONTEXTS], dtype=np.int32)
    return tables, before, tokens, pos0


def _torch_pages(pages):
    return [(torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))) for k, v in pages]


def _assert_pools_match(before, jax_pages, torch_pages):
    """Same slots written, other bytes identical, written slots close
    (the trash block, garbage by contract, is left out)."""
    for (k0, v0), (jk, jv), (tk, tv) in zip(before, jax_pages, torch_pages):
        for start, ref, out in ((k0, jk, tk), (v0, jv, tv)):
            start, ref, out = start[1:], np.asarray(ref)[1:], out.numpy()[1:]
            written_ref = (ref != start).any(axis=(-1, -2))
            written_out = (out != start).any(axis=(-1, -2))
            assert np.array_equal(written_ref, written_out)
            assert np.array_equal(ref[~written_ref], out[~written_ref])
            assert np.abs(ref - out).max() <= ATTN_TOL


@pytest.mark.parametrize("impl", PORT_MQ)
@pytest.mark.parametrize("width,lengths", [(8, [3, 3, 3]), (2, [3, 2, 1])],
                         ids=["full-width", "ragged-padding-rows"])
def test_decode_step_paged_multi_matches_jax(weights, verify_state, impl, width, lengths):
    """Port vs JAX (the Pallas verify kernel under the interpreter) on the
    same weights, at the full table width and at the engine's ragged
    width with per-lane lengths (padding rows clamped, as the engine
    sends them)."""
    jax_params, params = weights
    tables, before, tokens, pos0 = verify_state
    tables = tables[:, :width]
    lengths = np.array(lengths, dtype=np.int32)
    positions = (pos0[:, None] + np.minimum(np.arange(T)[None, :], (lengths - 1)[:, None])
                 ).astype(np.int32)
    ref_logits, ref_pages = _jax_multi(jax_params, tokens, positions, lengths, tables, before)
    logits, pages = llama.decode_step_paged_multi(
        params, *_torch((tokens, positions, lengths, tables)), _torch_pages(before),
        CONFIG, pa.get_attention_impl_mq(impl),
    )
    assert logits.dtype == torch.float32 and logits.shape == (3, T, CONFIG.vocab_size)
    ref_logits = np.asarray(ref_logits)
    for i, n in enumerate(lengths):
        assert np.abs(logits.numpy()[i, :n] - ref_logits[i, :n]).max() <= LOGITS_TOL
    _assert_pools_match(before, ref_pages, pages)


def test_decode_step_paged_multi_equals_sequential_decode(weights, verify_state):
    """One verify call's T logits rows equal T sequential port decode
    steps feeding the same tokens."""
    _, params = weights
    tables, before, tokens, pos0 = verify_state
    pages = _torch_pages(before)
    rows = []
    for r in range(T):
        logits, pages = llama.decode_step_paged(
            params, torch.from_numpy(tokens[:, r].copy()), torch.from_numpy(pos0 + r),
            torch.from_numpy(tables), pages, CONFIG,
        )
        rows.append(logits)
    sequential = torch.stack(rows, dim=1)
    positions = (pos0[:, None] + np.arange(T)[None, :]).astype(np.int32)
    lengths = np.full([3], T, dtype=np.int32)
    multi, _ = llama.decode_step_paged_multi(
        params, *_torch((tokens, positions, lengths, tables)), _torch_pages(before),
        CONFIG, pa.paged_attention_cuda_mq,
    )
    assert (multi - sequential).abs().max() <= ATTN_TOL


def test_padding_rows_never_clobber_live_pages(weights):
    """Rows past a lane's length write only the trash slot: the live pool
    is bit-identical whether a lane verifies with padding rows or with
    none, and bit-identical to the pre-verify pool outside the one slot a
    verify of length 1 writes."""
    _, params = weights
    pages = llama.init_kv_pages(CONFIG, 9, BS, device="cpu")
    table = torch.zeros(4, dtype=torch.int32)
    table[:2] = torch.tensor([1, 2])
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    tokens[0, :5] = torch.tensor([5, 9, 17, 3, 8])
    _, pages = llama.prefill_into_pages(params, tokens, table, pages, 4, CONFIG)
    before = [(k.clone(), v.clone()) for k, v in pages]

    def verify(t):
        pool = [(k.clone(), v.clone()) for k, v in before]
        _, pool = llama.decode_step_paged_multi(
            params, torch.tensor([[11, 0, 0][:t]], dtype=torch.int32),
            torch.full((1, t), 5, dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
            table[None], pool, CONFIG, pa.paged_attention_fused_mq,
        )
        return pool

    wide, narrow = verify(3), verify(1)
    for (wk, wv), (nk, nv), (pk, pv) in zip(wide, narrow, before):
        for w, n, p in ((wk, nk, pk), (wv, nv, pv)):
            mask = torch.ones(w.shape[:2], dtype=torch.bool)
            mask[1, 5] = False
            assert torch.equal(w[1:3][mask[1:3]], n[1:3][mask[1:3]])
            assert torch.equal(w[1:3][mask[1:3]], p[1:3][mask[1:3]])
            assert (w[1, 5] - n[1, 5]).abs().max() <= ATTN_TOL


# ---------------------------------------------------------------------------
# proposers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "k,ngram,context,proposal_k",
    [
        (4, 2, [1, 2, 3, 4, 5, 1, 2], 4),
        (4, 2, [1, 2, 3, 4, 5, 1, 2], 2),
        (4, 2, [5, 9, 9], 3),
        (4, 2, [1, 2, 3], 4),
        (4, 2, [7], 4),
        (2, 3, [1, 2, 3, 9, 1, 2, 3, 8, 7, 1, 2, 3], 2),
    ],
)
def test_ngram_proposer_matches_jax_on_the_reference_cases(k, ngram, context, proposal_k):
    ours = NgramProposer(k=k, ngram=ngram).propose(context, proposal_k)
    assert ours == jax_spec.NgramProposer(k=k, ngram=ngram).propose(context, proposal_k)


def test_ngram_proposer_matches_jax_on_random_contexts():
    rng = np.random.default_rng(0)
    for _ in range(200):
        context = rng.integers(0, 6, size=int(rng.integers(1, 40))).tolist()
        k, ngram = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        min_ngram = int(rng.integers(1, ngram + 1))
        ours = NgramProposer(k, ngram, min_ngram).propose(context, k)
        assert ours == jax_spec.NgramProposer(k, ngram, min_ngram).propose(context, k)
    with pytest.raises(ValueError):
        NgramProposer(k=0)
    with pytest.raises(ValueError):
        NgramProposer(k=2, ngram=1, min_ngram=2)


def test_draft_proposer_matches_jax_on_the_same_weights(weights):
    """Contexts in two padding buckets (8 and 16), and one so close to
    the draft's limit that the proposal shrinks."""
    jax_params, params = weights
    ours = DraftModelProposer(params, CONFIG, k=3)
    theirs = jax_spec.DraftModelProposer(jax_params, JAX_CONFIG, k=3)
    rng = np.random.default_rng(1)
    for n in (5, 13):
        context = rng.integers(2, 256, size=n).tolist()
        proposal = ours.propose(context, 3)
        assert len(proposal) == 3
        assert proposal == theirs.propose(context, 3)
    assert ours.propose(list(range(2, 64)), 3) == theirs.propose(list(range(2, 64)), 3)
    assert len(ours.propose(list(range(2, 64)), 3)) == 2
    assert ours.propose([], 3) == [] and ours.propose([5], 0) == []


def test_build_proposer_builds_and_refuses():
    ngram = build_proposer({"mode": "ngram", "k": 3, "ngram": 2})
    assert isinstance(ngram, NgramProposer) and (ngram.k, ngram.ngram) == (3, 2)
    draft = build_proposer({"mode": "draft", "k": 2}, target_config=CONFIG, device="cpu")
    assert isinstance(draft, DraftModelProposer)
    assert draft._config.n_layers == CONFIG.n_layers // 2
    # the unnamed draft is seeded: two builds hold the same weights
    again = build_proposer({"mode": "draft", "k": 2}, target_config=CONFIG, device="cpu")
    assert torch.equal(draft._params["embed"], again._params["embed"])
    with pytest.raises(ValueError, match="unknown speculation mode"):
        build_proposer({"mode": "medusa"})
    with pytest.raises(ValueError, match="k must be >= 1"):
        build_proposer({"mode": "ngram", "k": 0})
    with pytest.raises(ValueError, match="k must be >= 1"):
        build_proposer({"mode": "draft", "k": 0}, draft_params={}, draft_config=CONFIG)
    with pytest.raises(ValueError, match="vocabulary"):
        build_proposer({"mode": "draft"}, target_config=CONFIG,
                       draft_config=llama.LlamaConfig.tiny(vocab_size=128), device="cpu")
    with pytest.raises(ValueError, match="without draft_config"):
        build_proposer({"mode": "draft"}, target_config=CONFIG, draft_params={})


# ---------------------------------------------------------------------------
# the engine model with speculation
# ---------------------------------------------------------------------------

PROMPTS = [
    [9, 3, 7, 1, 5, 2, 8, 4, 6, 1, 2, 3, 10],
    [5, 9, 17, 3, 8],
    [1, 2, 3, 1, 2, 3, 1, 2],
    [7],
]
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def jax_streams(weights):
    jax_params, _ = weights
    generate = jax.jit(lambda p, t: jax_llama.generate(p, t, JAX_CONFIG, MAX_TOKENS))
    return [np.asarray(generate(jax_params, np.array([p], dtype=np.int32)))[0].tolist()
            for p in PROMPTS]


def _spec_model(params, speculation):
    model = LlmEngineModel(
        config=CONFIG, params=params, speculation=speculation, device="cpu",
        engine_config=EngineConfig(block_size=8, num_blocks=1 + 8 * 8, max_active=8,
                                   max_queue=32, max_seq_len=64),
    )
    model.warmup()
    return model


async def _generate(model, prompt, max_tokens=MAX_TOKENS, parameters=None):
    out = []
    async for item in model.execute_decoupled(
        {"INPUT_IDS": np.array(prompt, dtype=np.int32)},
        {"max_tokens": max_tokens, **(parameters or {})},
    ):
        out.append(int(item["OUTPUT_IDS"][0]))
    return out


def _run_all(model, prompts, parameters=None):
    async def run():
        return await asyncio.gather(*(_generate(model, p, parameters=parameters)
                                      for p in prompts))

    return asyncio.run(run())


@pytest.mark.parametrize("mode", ["self-draft", "ngram"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_spec_on_equals_jax_generate(weights, jax_streams, mode, k):
    """Four concurrent greedy streams with speculation on equal JAX
    ``generate`` token for token; every KV block comes back."""
    spec = {"mode": "draft", "draft": "self", "k": k} if mode == "self-draft" else {
        "mode": "ngram", "k": k, "ngram": 2}
    model = _spec_model(weights[1], spec)
    try:
        assert _run_all(model, PROMPTS) == jax_streams
        stats = model.engine.stats()
        assert stats["speculative"] is True and stats["spec_steps"] > 0
        assert stats["kv_blocks_in_use"] == 0
        if mode == "self-draft":
            assert stats["tokens_per_step"] > 1.0
    finally:
        model.shutdown()


def test_per_request_speculation_switch(weights, jax_streams):
    """``speculation: off`` decodes a request on the plain path with the
    same output; a malformed value is refused."""
    model = _spec_model(weights[1], {"mode": "draft", "draft": "self", "k": 3})
    try:
        steps = model.engine.spec_steps
        assert _run_all(model, PROMPTS[:1], {"speculation": "off"}) == jax_streams[:1]
        assert model.engine.spec_steps == steps
        assert _run_all(model, PROMPTS[:1], {"speculation": "on"}) == jax_streams[:1]
        assert model.engine.spec_steps > steps
        with pytest.raises(InferenceServerException, match="speculation"):
            model.engine.submit([1, 2], max_tokens=2, parameters={"speculation": "maybe"})
    finally:
        model.shutdown()


def test_seeded_sampled_streams_equal_spec_off(weights):
    """Seeded temperature sampling draws each token from the target's
    logits with the same per-token key, so speculation changes nothing."""
    sampled = {"temperature": 1.0, "seed": 42, "top_k": 8}
    streams = []
    for spec in (None, {"mode": "draft", "draft": "self", "k": 3}):
        model = _spec_model(weights[1], spec)
        try:
            streams.append(_run_all(model, PROMPTS, sampled))
            if spec is not None:
                assert model.engine.spec_steps > 0
        finally:
            model.shutdown()
    assert streams[0] == streams[1]


def test_config_carries_speculation_and_its_stats(weights):
    spec = {"mode": "ngram", "k": 2, "ngram": 2}
    model = _spec_model(weights[1], spec)
    try:
        _run_all(model, PROMPTS[2:3])
        parameters = model.config()["parameters"]
        assert json.loads(parameters["speculation"]["string_value"]) == spec
        stats = json.loads(parameters["speculation_stats"]["string_value"])
        assert set(stats) == {"steps", "lane_steps", "step_tokens", "spec_steps",
                              "spec_proposed", "spec_accepted"}
        assert stats["spec_steps"] == model.engine.spec_steps > 0
        assert model.engine_config.spec_k == 2
    finally:
        model.shutdown()
    plain = _spec_model(weights[1], None)
    try:
        parameters = plain.config()["parameters"]
        assert parameters["speculation"]["string_value"] == "off"
        assert "speculation_stats" not in parameters
    finally:
        plain.shutdown()

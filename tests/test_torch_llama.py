"""The port's Llama functions against the JAX package on the same weights.

The JAX parameters (tiny fp32 config, ``PRNGKey(0)``) are carried across
with ``params_from_jax``; inputs are made with numpy from a seed and fed
to both. Logits agree within 1e-4. Page pools start from the same bytes,
and after the writes the two pools have changed exactly the same slots,
left every other byte identical, and agree within 1e-5 on the written
slots (the K/V values come out of matrix products that XLA and PyTorch
sum in different orders, so their last bits differ). The trash block,
whose content is garbage by contract, is left out of the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import llama as jax_llama
from client_tpu.models import paged_attention as jax_pa
from client_tpu_torch.models import llama
from client_tpu_torch.models import paged_attention as pa

torch.set_num_threads(1)

LOGITS_TOL = 1e-4
POOL_TOL = 1e-5
BS = 8


JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)

# the JAX side jitted as its serving path jits it: one compile per shape
# instead of one per op and shape
_jax_prefill = jax.jit(
    lambda p, t, tbl, pages, last: jax_llama.prefill_into_pages(
        p, t, tbl, pages, last, JAX_CONFIG)
)
_jax_decode = jax.jit(
    lambda p, t, pos, tbl, pages: jax_llama.decode_step_paged(
        p, t, pos, tbl, pages, JAX_CONFIG)
)
_jax_decode_attn = jax.jit(
    lambda p, t, pos, tbl, pages: jax_llama.decode_step_paged_attn(
        p, t, pos, tbl, pages, JAX_CONFIG, jax_pa.paged_attention_pallas_interpret)
)
_jax_suffix = jax.jit(
    lambda p, t, tbl, pages, last, start, prefix_blocks: (
        jax_llama.prefill_suffix_into_pages(
            p, t, tbl, pages, last, start, prefix_blocks, JAX_CONFIG)
    ),
    static_argnums=(6,),
)


@pytest.fixture(scope="module")
def models():
    init = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))
    jax_params = init(jax.random.PRNGKey(0))
    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    return JAX_CONFIG, jax_params, config, params


@pytest.fixture(scope="module")
def decode_state(models):
    """Three contexts prefilled into a JAX pool through the JAX prefill."""
    _, jax_params, _, _ = models
    tables = _tables(CONTEXTS)
    pages = jax_llama.init_kv_pages(JAX_CONFIG, 33, BS)
    for context, table in zip(CONTEXTS, tables):
        tokens = np.zeros([1, 16], dtype=np.int32)
        tokens[0, : len(context)] = context
        _, pages = _jax_prefill(jax_params, tokens, table, pages, len(context) - 1)
    before = [(np.asarray(k), np.asarray(v)) for k, v in pages]
    tokens = np.array([11, 12, 13], dtype=np.int32)
    positions = np.array([len(c) for c in CONTEXTS], dtype=np.int32)
    return tables, before, tokens, positions


def _to_torch_pages(jax_pages):
    return [
        (torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v)))
        for k, v in jax_pages
    ]


def _assert_pools_match(before, jax_pages, torch_pages):
    """Same slots written, other bytes identical, written slots close."""
    for (k0, v0), (jk, jv), (tk, tv) in zip(before, jax_pages, torch_pages):
        for start, ref, out in ((k0, jk, tk), (v0, jv, tv)):
            start, ref, out = start[1:], np.asarray(ref)[1:], out.numpy()[1:]
            written_ref = (ref != start).any(axis=(-1, -2))
            written_out = (out != start).any(axis=(-1, -2))
            assert np.array_equal(written_ref, written_out)
            assert np.array_equal(ref[~written_ref], out[~written_ref])
            assert np.abs(ref - out).max() <= POOL_TOL


CONTEXTS = [[5, 9, 17, 3, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [7]]


def _tables(contexts, width=8):
    tables = np.zeros((len(contexts), width), dtype=np.int32)
    next_free = 1
    for i, context in enumerate(contexts):
        n_blocks = (len(context) + 1 + BS - 1) // BS
        tables[i, :n_blocks] = range(next_free, next_free + n_blocks)
        next_free += n_blocks
    return tables


def _leaf_pairs(ref, out):
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(out)
        for key in ref:
            yield from _leaf_pairs(ref[key], out[key])
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(out)
        for a, b in zip(ref, out):
            yield from _leaf_pairs(a, b)
    else:
        yield ref, out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_round_trips_exactly(dtype):
    config = jax_llama.LlamaConfig.tiny(n_layers=1, dtype=dtype)
    init = jax.jit(lambda key: jax_llama.init_params(key, config))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3)))
    params = llama.params_from_jax(tree, device="cpu")
    want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pairs = list(_leaf_pairs(tree, params))
    assert len(pairs) == 3 + 9 * config.n_layers
    for ref, out in pairs:
        assert out.dtype == want and out.device.type == "cpu"
        assert tuple(out.shape) == ref.shape
        # bit for bit: bf16 crosses as its 16-bit pattern
        raw = out.view(torch.int16) if out.dtype == torch.bfloat16 else out
        assert raw.numpy().tobytes() == ref.tobytes()


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    weight = rng.normal(size=(16,)).astype(np.float32)
    positions = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    ref = np.asarray(jax_llama.rms_norm(x, weight, 1e-5))
    out = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(weight), 1e-5)
    assert np.abs(out.numpy() - ref).max() <= 1e-6
    ref = np.asarray(jax_llama._rope(x, positions, 10000.0))
    out = llama._rope(torch.from_numpy(x), torch.from_numpy(positions), 10000.0)
    # angles up to 4096 rad: sin/cos of large arguments round differently
    assert np.abs(out.numpy() - ref).max() <= 1e-4
    ref = np.asarray(jax_llama._rope(x, positions % 64, 10000.0))
    out = llama._rope(torch.from_numpy(x), torch.from_numpy(positions % 64), 10000.0)
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_rms_norm_casts_before_the_weight_in_bf16():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(torch.bfloat16)
    weight = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).to(torch.bfloat16)
    var = x.float().square().mean(-1, keepdim=True)
    normed = (x.float() * torch.rsqrt(var + 1e-5)).to(torch.bfloat16)
    assert torch.equal(llama.rms_norm(x, weight, 1e-5), normed * weight)


def test_prefill_into_pages_matches(models):
    jax_config, jax_params, config, params = models
    table = np.zeros([8], dtype=np.int32)
    table[:2] = [3, 5]
    tokens = np.zeros([1, 16], dtype=np.int32)
    tokens[0, :12] = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    before = jax_llama.init_kv_pages(jax_config, 9, BS)
    ref_logits, ref_pages = _jax_prefill(jax_params, tokens, table, before, 11)
    pages = _to_torch_pages(before)
    logits, pages = llama.prefill_into_pages(
        params, torch.from_numpy(tokens), torch.from_numpy(table), pages, 11, config
    )
    assert np.abs(logits.numpy() - np.asarray(ref_logits)).max() <= LOGITS_TOL
    _assert_pools_match([(np.asarray(k), np.asarray(v)) for k, v in before],
                        ref_pages, pages)


def test_decode_step_paged_matches(models, decode_state):
    _, jax_params, config, params = models
    tables, before, tokens, positions = decode_state
    ref_logits, ref_pages = _jax_decode(jax_params, tokens, positions, tables, before)
    logits, pages = llama.decode_step_paged(
        params, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), _to_torch_pages(before), config,
    )
    assert np.abs(logits.numpy() - np.asarray(ref_logits)).max() <= LOGITS_TOL
    _assert_pools_match(before, ref_pages, pages)


@pytest.mark.parametrize("impl", ["standin", "fused", "cuda"])
@pytest.mark.parametrize("width", [8, 2])
def test_decode_step_paged_attn_matches(models, decode_state, impl, width):
    """Every port implementation, at the full table width and at the
    engine's ragged width (2 blocks cover the longest context), against
    the JAX step through the Pallas kernel under the interpreter."""
    _, jax_params, config, params = models
    tables, before, tokens, positions = decode_state
    tables = tables[:, :width]
    ref_logits, ref_pages = _jax_decode_attn(jax_params, tokens, positions, tables, before)
    logits, pages = llama.decode_step_paged_attn(
        params, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), _to_torch_pages(before), config,
        pa.get_attention_impl(impl),
    )
    assert np.abs(logits.numpy() - np.asarray(ref_logits)).max() <= LOGITS_TOL
    _assert_pools_match(before, ref_pages, pages)


@pytest.mark.parametrize("prefix_blocks", [1, 2])
def test_prefill_suffix_into_pages_matches(models, prefix_blocks):
    """Suffix prefill over a shared 8-token prefix, at the exact and at a
    bucket-padded static prefix width."""
    jax_config, jax_params, config, params = models
    context = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    table = np.zeros([8], dtype=np.int32)
    table[:2] = [1, 2]
    prefix = np.zeros([1, 8], dtype=np.int32)
    prefix[0, :8] = context[:8]
    _, before = _jax_prefill(
        jax_params, prefix, table, jax_llama.init_kv_pages(jax_config, 9, BS), 7
    )
    suffix = np.zeros([1, 8], dtype=np.int32)
    suffix[0, :4] = context[8:]
    ref_logits, ref_pages = _jax_suffix(jax_params, suffix, table, before, 3, 8,
                                        prefix_blocks)
    logits, pages = llama.prefill_suffix_into_pages(
        params, torch.from_numpy(suffix), torch.from_numpy(table),
        _to_torch_pages(before), 3, 8, prefix_blocks, config,
    )
    assert np.abs(logits.numpy() - np.asarray(ref_logits)).max() <= LOGITS_TOL
    _assert_pools_match([(np.asarray(k), np.asarray(v)) for k, v in before],
                        ref_pages, pages)


def test_greedy_generate_matches_jax(models):
    jax_config, jax_params, config, params = models
    prompt = np.array([[5, 9, 17, 3, 8, 1, 2]], dtype=np.int32)
    generate = jax.jit(lambda p, t: jax_llama.generate(p, t, jax_config, 16))
    ref = np.asarray(generate(jax_params, prompt))
    out = llama.generate(params, torch.from_numpy(prompt), config, 16)
    assert out.shape == (1, 16)
    assert out.numpy().tolist() == ref.tolist()

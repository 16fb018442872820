"""The port's BERT encoder and ``text_encoder`` model against the JAX package.

The same weights (the JAX pytree through ``bert.params_from_jax``) and the
same token ids (from a numpy seed) go through ``client_tpu.models.bert``
and the port, on the CPU. Tolerances:

- fp32: hidden states and pooled embeddings within 1e-5 (absolute);
- bf16: pooled embeddings within 2 % of the largest absolute value (the
  two frameworks round bf16 products at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import bert as jax_bert
from client_tpu.models.serving import TextEncoderModel as JaxTextEncoderModel
from client_tpu_torch.models import bert
from client_tpu_torch.models.serving import TextEncoderModel
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

TOL = 1e-5
JAX_CONFIG = jax_bert.BertConfig.tiny(dtype=jnp.float32)
CONFIG = bert.BertConfig.tiny(dtype=torch.float32)


def _jax_params(config, seed=0):
    """JAX's init plus random layer-norm scales and embedding bias from a
    numpy seed: the reference's all-ones scales would hide a scale
    applied in the wrong place."""
    params = jax.tree.map(np.asarray, jax_bert.init_params(jax.random.PRNGKey(seed), config))
    rng = np.random.default_rng(seed)
    d = config.d_model
    params["emb_ln_scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    params["emb_ln_bias"] = rng.normal(0, 0.1, d).astype(np.float32)
    for layer in params["layers"]:
        layer["ln1_scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
        layer["ln2_scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    jax_params = _jax_params(JAX_CONFIG)
    return jax_params, bert.params_from_jax(jax_params, CONFIG, device="cpu")


def _ragged_ids(seed, lengths, width, vocab):
    """Rows of the given lengths (ids 1..vocab-1), padded with 0 to
    ``width``; a length of 0 makes a row that is all padding."""
    rng = np.random.default_rng(seed)
    ids = np.zeros([len(lengths), width], dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, vocab, n)
    return ids


@pytest.mark.parametrize("lengths,width", [
    ([5, 16, 1, 0], 16),  # ragged, with an all-padding row
    ([37, 12, 64, 0, 3, 50, 0, 8], 64),
    ([256], 256),  # max_seq_len
])
def test_forward_matches_jax_fp32(weights, lengths, width):
    jax_params, params = weights
    ids = _ragged_ids(len(lengths) * width, lengths, width, CONFIG.vocab_size)
    ref_hidden, ref_pooled = jax.jit(
        lambda p, x: jax_bert.forward(p, x, JAX_CONFIG))(jax_params, ids)
    hidden, pooled = bert.forward(params, torch.from_numpy(ids), CONFIG)
    assert hidden.dtype == torch.float32 and pooled.dtype == torch.float32
    assert tuple(hidden.shape) == (len(lengths), width, CONFIG.d_model)
    assert tuple(pooled.shape) == (len(lengths), CONFIG.d_model)
    assert torch.isfinite(hidden).all() and torch.isfinite(pooled).all()
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), rtol=0, atol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), rtol=0, atol=TOL)
    # an all-padding row pools to zero, finitely
    for i, n in enumerate(lengths):
        if n == 0:
            assert not pooled[i].any()


def test_forward_matches_jax_bf16():
    jax_config = jax_bert.BertConfig.tiny()
    config = bert.BertConfig.tiny()
    jax_params = _jax_params(jax_config, seed=1)
    params = bert.params_from_jax(jax_params, config, device="cpu")
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    # bf16 crosses through a 16-bit view: every bit kept
    assert np.array_equal(params["tok_emb"].view(torch.int16).numpy(),
                          np.asarray(jax_params["tok_emb"]).view(np.int16))
    ids = _ragged_ids(2, [40, 7, 128, 0], 128, config.vocab_size)
    _, ref = jax.jit(lambda p, x: jax_bert.forward(p, x, jax_config))(jax_params, ids)
    _, pooled = bert.forward(params, torch.from_numpy(ids), config)
    ref = np.asarray(ref)
    assert pooled.dtype == torch.float32 and torch.isfinite(pooled).all()
    err = np.abs(pooled.numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), err


def test_params_from_jax_refuses_another_config(weights):
    jax_params, _ = weights
    with pytest.raises(ValueError, match="layers"):
        bert.params_from_jax(jax_params, dataclasses.replace(CONFIG, n_layers=3), "cpu")
    with pytest.raises(ValueError, match="tok_emb"):
        bert.params_from_jax(jax_params, dataclasses.replace(CONFIG, vocab_size=99), "cpu")


def test_init_params_has_the_reference_layout():
    params = bert.init_params(torch.Generator().manual_seed(0), CONFIG, "cpu")
    ref = jax_bert.init_params(jax.random.PRNGKey(0), JAX_CONFIG)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    ours = jax.tree.map(lambda t: tuple(t.shape), params)
    assert ours == shapes
    assert params["emb_ln_scale"].dtype == torch.float32
    assert params["layers"][0]["w1"].dtype == torch.float32


@pytest.mark.parametrize("rows,length", [(1, 5), (3, 19), (5, 8), (16, 200)])
def test_text_encoder_execute_matches_jax(weights, rows, length):
    jax_params, params = weights
    ids = _ragged_ids(rows * length, [length] * rows, length, CONFIG.vocab_size)
    jax_model = JaxTextEncoderModel(config=JAX_CONFIG, params=jax_params)
    jax_model.warmup()
    model = TextEncoderModel(config=CONFIG, params=params, device="cpu")
    model.warmup()
    ref = jax_model.execute({"INPUT_IDS": ids}, {})["EMBEDDING"]
    out = model.execute({"INPUT_IDS": ids}, {})["EMBEDDING"]
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert out.shape == (rows, CONFIG.d_model)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_text_encoder_padding_changes_no_result(weights):
    """A sequence alone equals itself inside a larger padded batch: the
    row and length buckets, and the batcher's ragged padding, are masked."""
    _, params = weights
    model = TextEncoderModel(config=CONFIG, params=params, device="cpu")
    ids = _ragged_ids(9, [11], 11, CONFIG.vocab_size)
    alone = model.execute({"INPUT_IDS": ids}, {})["EMBEDDING"]
    batch = np.zeros([5, 100], dtype=np.int32)
    batch[2, :11] = ids[0]
    batch[0, :100] = _ragged_ids(10, [100], 100, CONFIG.vocab_size)[0]
    inside = model.execute({"INPUT_IDS": batch}, {})["EMBEDDING"]
    np.testing.assert_allclose(inside[2], alone[0], rtol=0, atol=TOL)
    assert not inside[1].any() and np.isfinite(inside).all()


def test_text_encoder_refuses_what_it_cannot_encode(weights):
    _, params = weights
    model = TextEncoderModel(config=CONFIG, params=params, device="cpu")
    with pytest.raises(InferenceServerException, match="exceeds max"):
        model.execute({"INPUT_IDS": np.ones([1, 257], np.int32)}, {})
    with pytest.raises(InferenceServerException, match="token ids"):
        model.execute({"INPUT_IDS": np.full([1, 4], CONFIG.vocab_size, np.int32)}, {})
    with pytest.raises(InferenceServerException, match="token ids"):
        model.execute({"INPUT_IDS": np.full([1, 4], -1, np.int32)}, {})
    with pytest.raises(InferenceServerException, match="expects input"):
        model.execute({"IDS": np.ones([1, 4], np.int32)}, {})


def test_text_encoder_dtype_and_warmup_weights():
    model = TextEncoderModel(device="cpu", dtype=torch.float32)
    assert model.outputs[0]["shape"] == [bert.BertConfig.tiny().d_model]
    assert model.ragged_dim_cap == 256 and model.max_batch_size == 16
    model.warmup()  # seed-0 random weights in the asked dtype
    assert model._params["tok_emb"].dtype == torch.float32
    out = model.execute({"INPUT_IDS": np.array([3, 4, 5], np.int32)}, {})["EMBEDDING"]
    assert out.shape == (1, 64) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# the attention's two routes: the plain version here, the kernel on a card
# ---------------------------------------------------------------------------


def _inline_attention(q, k, v, key_mask, config):
    """The attention as ``forward`` computed it inline before it had a
    kernel: the pad bias built once per forward, then the score chain."""
    B, L, _, hd = q.shape
    zero = torch.zeros((), dtype=torch.float32)
    neg = torch.full((), -1e9, dtype=torch.float32)
    bias = torch.where(key_mask[:, None, None, :], zero, neg)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / np.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(config.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_plain_is_the_inline_arithmetic_bit_for_bit(dtype):
    config = bert.BertConfig.tiny(dtype=dtype)
    rng = np.random.default_rng(5)
    shape = (4, 24, config.n_heads, config.head_dim)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
               for _ in range(3))
    key_mask = torch.ones(4, 24, dtype=torch.bool)
    key_mask[0, 9:] = False  # trailing pads
    key_mask[1, 5:15] = False  # pads in the middle
    key_mask[2] = False  # all pad: the uniform softmax
    ctx = bert.encoder_attention_plain(q, k, v, key_mask, config)
    assert ctx.dtype == dtype and tuple(ctx.shape) == (4, 24, config.d_model)
    assert torch.equal(ctx, _inline_attention(q, k, v, key_mask, config))
    assert torch.isfinite(ctx).all()


def test_a_cpu_forward_never_loads_the_kernel(weights, monkeypatch):
    from client_tpu_torch import kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU forward reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    _, params = weights
    before = bert.encoder_attention_cuda.launches
    ids = _ragged_ids(6, [10, 0, 31], 32, CONFIG.vocab_size)
    _, pooled = bert.forward(params, torch.from_numpy(ids), CONFIG)
    assert torch.isfinite(pooled).all()
    assert bert.encoder_attention_cuda.launches == before


def test_the_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="one CUDA device"):
        bert.encoder_attention_cuda(q, q, q, torch.ones(1, 8, dtype=torch.bool))


def _encoder_core(model):
    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.model_repository import ModelRepository

    repository = ModelRepository()
    repository.add_model(model)
    return ServerCore(repository, max_workers=1)


def test_text_encoder_stats_carry_the_attention_kernel_launches(weights, monkeypatch):
    _, params = weights
    model = TextEncoderModel(config=CONFIG, params=params, device="cpu")
    core = _encoder_core(model)
    try:
        model.execute({"INPUT_IDS": np.ones([2, 8], np.int32)}, {})
        entry = core.statistics("text_encoder")["model_stats"][0]
        # the CPU takes the plain version: no launch
        assert entry["kernel_launches"] == {"encoder_attention": 0}
        assert "stage_stats" in entry and entry["name"] == "text_encoder"

        # a forward that launches the kernel once a layer, as a card's does
        plain_forward = bert.forward

        def launching_forward(*args, **kwargs):
            bert.encoder_attention_cuda.launches += CONFIG.n_layers
            return plain_forward(*args, **kwargs)

        monkeypatch.setattr(bert, "forward", launching_forward)
        for _ in range(3):
            model.execute({"INPUT_IDS": np.ones([1, 8], np.int32)}, {})
        entry = core.statistics("text_encoder")["model_stats"][0]
        assert entry["kernel_launches"] == {"encoder_attention": 3 * CONFIG.n_layers}
    finally:
        core.close()

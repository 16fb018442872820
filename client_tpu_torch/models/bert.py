"""Bidirectional transformer encoder (BERT family) in PyTorch.

The port of ``client_tpu/models/bert.py``: the encoder behind the
``text_encoder`` model (:class:`client_tpu_torch.models.serving.TextEncoderModel`).
Parameters are a plain dict of tensors in the JAX package's layouts, so
every product is ``x @ W`` with ``W [in, out]``, as there:

- ``tok_emb [V, d]``, ``pos_emb [max_seq_len, d]``, ``emb_ln_scale`` and
  ``emb_ln_bias [d]`` (fp32);
- per layer ``wq``/``wk``/``wv``/``wo [d, d]``, ``w1 [d, d_ff]``,
  ``w2 [d_ff, d]``, ``ln1_scale``/``ln2_scale [d]`` (fp32).

Numerics follow the reference: layer norms compute in fp32 and cast back
to the input dtype (no bias is applied: the reference's forward reads
``emb_ln_bias`` nowhere); attention scores and softmax are fp32 with a
finite ``-1e9`` bias on pad keys, the probabilities cast back to the
model dtype; GELU is the tanh approximation (``jax.nn.gelu``'s default).
Token id ``pad_token_id`` is padding wherever it appears. The big
products are ``torch.matmul``/``einsum``: the JAX package computes them
outside any Pallas kernel, so this path has no kernel of its own.
"""

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.utils import numpy_to_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-large's published widths by default."""

    vocab_size: int = 30522
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 512
    pad_token_id: int = 0
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**overrides) -> "BertConfig":
        """A tiny config for tests."""
        base = dict(
            vocab_size=1024,
            d_model=64,
            n_layers=2,
            n_heads=4,
            d_ff=128,
            max_seq_len=256,
        )
        base.update(overrides)
        return BertConfig(**base)


def init_params(generator: torch.Generator, config: BertConfig,
                device=None) -> Dict[str, Any]:
    """Random parameters (the reference's scaled-normal init) drawn from
    ``generator``, which must live on ``device``."""
    device = resolve_device(device)
    d, f = config.d_model, config.d_ff

    def dense(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        sample = torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32)
        return sample.mul_(scale).to(config.dtype)

    def ones():
        return torch.ones(d, device=device, dtype=torch.float32)

    params: Dict[str, Any] = {
        "tok_emb": dense((config.vocab_size, d), 0.02),
        "pos_emb": dense((config.max_seq_len, d), 0.02),
        "emb_ln_scale": ones(),
        "emb_ln_bias": torch.zeros(d, device=device, dtype=torch.float32),
        "layers": [],
    }
    for _ in range(config.n_layers):
        params["layers"].append({
            "wq": dense((d, d)),
            "wk": dense((d, d)),
            "wv": dense((d, d)),
            "wo": dense((d, d)),
            "w1": dense((d, f)),
            "w2": dense((f, d)),
            "ln1_scale": ones(),
            "ln2_scale": ones(),
        })
    return params


def params_from_jax(tree: Dict[str, Any], config: BertConfig,
                    device=None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as torch tensors on ``device``
    with every layout and bit kept (bf16 through a 16-bit view). Raises
    when the tree does not have ``config``'s shapes."""
    device = resolve_device(device)
    expected = {"tok_emb": (config.vocab_size, config.d_model),
                "pos_emb": (config.max_seq_len, config.d_model)}
    for name, shape in expected.items():
        if tuple(np.shape(tree[name])) != shape:
            raise ValueError(f"{name} has shape {np.shape(tree[name])}, the config "
                             f"asks for {shape}")
    if len(tree["layers"]) != config.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, the config asks for "
                         f"{config.n_layers}")

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(value) for value in node]
        return numpy_to_tensor(np.asarray(node), device)

    return convert(tree)


def _layernorm(x, scale, eps):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale).to(x.dtype)


def forward(params, input_ids: torch.Tensor,
            config: BertConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``input_ids`` [B, L] -> (hidden [B, L, D], pooled [B, D] fp32).

    Padding positions (== pad_token_id) are masked out of attention and of
    the mean-pool, so bucket padding never changes the result; a row that
    is all padding gets a uniform softmax (finite) and a zero pool.
    """
    B, L = input_ids.shape
    H, hd = config.n_heads, config.head_dim
    mask = input_ids != config.pad_token_id  # [B, L]
    h = params["tok_emb"][input_ids] + params["pos_emb"][:L][None, :, :]
    h = _layernorm(h, params["emb_ln_scale"], config.norm_eps)

    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=h.device)
    attn_bias = torch.where(mask[:, None, None, :], zero, neg)  # [B, 1, 1, L]

    for layer in params["layers"]:
        x = _layernorm(h, layer["ln1_scale"], config.norm_eps)
        q = (x @ layer["wq"]).reshape(B, L, H, hd)
        k = (x @ layer["wk"]).reshape(B, L, H, hd)
        v = (x @ layer["wv"]).reshape(B, L, H, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        scores = scores / math.sqrt(hd) + attn_bias
        probs = torch.softmax(scores, dim=-1).to(config.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, -1)
        h = h + ctx @ layer["wo"]
        x = _layernorm(h, layer["ln2_scale"], config.norm_eps)
        h = h + F.gelu(x @ layer["w1"], approximate="tanh") @ layer["w2"]

    denom = mask.sum(-1, keepdim=True).clamp(min=1).float()
    pooled = (h.float() * mask[:, :, None]).sum(1) / denom
    return h, pooled

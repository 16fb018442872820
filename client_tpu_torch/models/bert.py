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
products are ``torch.matmul``: the JAX package computes them outside any
Pallas kernel. The attention is :func:`encoder_attention_plain` on the
CPU and, on a card, :func:`encoder_attention_cuda`, the hand-written
fused kernel ``csrc/bert_attention.cu`` (K3), which never writes the
``[B, H, L, L]`` scores to device memory.

Tensor parallelism (``param_specs``, Megatron-style): :func:`shard_params`
cuts the parameters over a plan's devices, and :func:`forward` takes a tp
group's per-shard dicts: heads and the FFN hidden split over the shards,
one all-reduce after ``wo`` and one after ``w2``, the token embedding
sharded by vocabulary rows.
"""

import dataclasses
import math
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.parallel import TP_AXIS, collectives, sharding
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


def param_specs(config: BertConfig) -> Dict[str, Any]:
    """The spec twin of the parameter dict (Megatron-style tp)."""
    layer = {
        "wq": (None, TP_AXIS),
        "wk": (None, TP_AXIS),
        "wv": (None, TP_AXIS),
        "wo": (TP_AXIS, None),
        "w1": (None, TP_AXIS),
        "w2": (TP_AXIS, None),
        "ln1_scale": (None,),
        "ln2_scale": (None,),
    }
    return {
        "tok_emb": (TP_AXIS, None),
        "pos_emb": (None, None),
        "emb_ln_scale": (None,),
        "emb_ln_bias": (None,),
        "layers": [dict(layer) for _ in range(config.n_layers)],
    }


def shard_params(params: Dict[str, Any], config: BertConfig, plan) -> List[Dict[str, Any]]:
    """``params`` cut per :func:`param_specs` over ``plan``'s devices: one
    parameter dict per device (replicated over ``dp``)."""
    return sharding.shard_tree(params, param_specs(config), plan)


# compiled instances of K3 (``csrc/bert_attention.cu``)
CUDA_HEAD_DIMS = (16, 64, 128)
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# key tiles of 64 a row may have in K3: L <= 16384
CUDA_MAX_LENGTH = 256 * 64


def encoder_attention_plain(q, k, v, key_mask, config: BertConfig) -> torch.Tensor:
    """Bidirectional attention of ``q``, ``k``, ``v`` [B, L, H, hd] over
    the keys ``key_mask`` [B, L] (bool) marks real -> ``ctx`` [B, L, H*hd]
    in ``config.dtype``: fp32 scores over sqrt(hd) with a finite ``-1e9``
    bias on pad keys, an fp32 softmax, the probabilities cast to the model
    dtype before the second product. A row whose keys are all pad gets a
    uniform softmax."""
    B, L, _, hd = q.shape
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=q.device)
    bias = torch.where(key_mask[:, None, None, :], zero, neg)  # [B, 1, 1, L]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(config.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, -1)


def _check_cuda_args(q, k, v, key_mask) -> None:
    """Raise on anything K3 does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v [B, L, H, hd] alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, length, heads, hd = q.shape
    if tuple(key_mask.shape) != (b, length) or key_mask.dtype != torch.bool:
        raise ValueError(f"key_mask must be bool [{b}, {length}], got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    if q.dtype not in _CUDA_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in CUDA_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not compiled (have {CUDA_HEAD_DIMS})")
    if not (0 < length <= CUDA_MAX_LENGTH and 0 < b <= 65535 and 0 < heads <= 65535):
        raise ValueError(f"B {b}, L {length}, H {heads} out of the kernel's range "
                         f"(L <= {CUDA_MAX_LENGTH}, B and H <= 65535)")
    tensors = (q, k, v, key_mask)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and key_mask must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors only")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")


def encoder_attention_cuda(q, k, v, key_mask) -> torch.Tensor:
    """:func:`encoder_attention_plain`'s function by the Hopper kernel K3
    (``csrc/bert_attention.cu``) on CUDA tensors, or raise: q, k, v
    contiguous [B, L, H, hd] (hd in :data:`CUDA_HEAD_DIMS`, fp32 or bf16),
    ``key_mask`` bool [B, L], all on one card. The result is in q's
    dtype. Each launch adds one to ``encoder_attention_cuda.launches``."""
    _check_cuda_args(q, k, v, key_mask)
    from client_tpu_torch import kernels

    lib = kernels.load("bert_attention.cu")
    b, length, heads, hd = q.shape
    ctx = torch.empty((b, length, heads * hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.bat_encoder_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), ctx.data_ptr(),
            b, length, heads, hd, _CUDA_DTYPES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"encoder-attention kernel launch failed: "
                           f"{lib.bat_error_string(code).decode()} (cudaError {code})")
    encoder_attention_cuda.launches += 1
    return ctx


encoder_attention_cuda.launches = 0


def _layernorm(x, scale, eps):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale).to(x.dtype)


def forward(params: Union[Dict[str, Any], List[Dict[str, Any]]],
            input_ids: torch.Tensor,
            config: BertConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``input_ids`` [B, L] -> (hidden [B, L, D], pooled [B, D] fp32).

    Padding positions (== pad_token_id) are masked out of attention and of
    the mean-pool, so bucket padding never changes the result; a row that
    is all padding gets a uniform softmax (finite) and a zero pool.

    ``params`` is one dict, or a tp group's per-shard dicts
    (:func:`shard_params`): each shard then computes its ``H/tp`` heads
    and ``d_ff/tp`` hidden units, the partials are all-reduced after
    ``wo`` and ``w2``, and the result is the first shard's.
    """
    shards = params if isinstance(params, list) else [params]
    devices = [shard["pos_emb"].device for shard in shards]
    B, L = input_ids.shape
    H, hd = config.n_heads // len(shards), config.head_dim
    ids = [input_ids.to(device) for device in devices]
    mask = [i != config.pad_token_id for i in ids]  # [B, L]
    tok = collectives.vocab_parallel_embedding([s["tok_emb"] for s in shards], input_ids)
    h = [_layernorm(t + s["pos_emb"][:L][None, :, :], s["emb_ln_scale"], config.norm_eps)
         for t, s in zip(tok, shards)]

    def residual(h, partials):
        return [hi + r for hi, r in zip(h, collectives.all_reduce(partials, devices))]

    for index in range(config.n_layers):
        layers = [shard["layers"][index] for shard in shards]
        partials = []
        for layer, hi, m in zip(layers, h, mask):
            x = _layernorm(hi, layer["ln1_scale"], config.norm_eps)
            q = (x @ layer["wq"]).reshape(B, L, H, hd)
            k = (x @ layer["wk"]).reshape(B, L, H, hd)
            v = (x @ layer["wv"]).reshape(B, L, H, hd)
            # the kernel on a card, the plain version on the CPU
            ctx = (encoder_attention_cuda(q, k, v, m) if q.is_cuda
                   else encoder_attention_plain(q, k, v, m, config))
            partials.append(ctx @ layer["wo"])
        h = residual(h, partials)
        h = residual(h, [
            F.gelu(_layernorm(hi, layer["ln2_scale"], config.norm_eps) @ layer["w1"],
                   approximate="tanh") @ layer["w2"]
            for layer, hi in zip(layers, h)
        ])

    denom = mask[0].sum(-1, keepdim=True).clamp(min=1).float()
    pooled = (h[0].float() * mask[0][:, :, None]).sum(1) / denom
    return h[0], pooled

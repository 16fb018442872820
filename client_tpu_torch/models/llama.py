"""Decoder-only transformer (Llama-family architecture) in PyTorch.

The port of ``client_tpu/models/llama.py``: the dense
KV-cache oracle (``prefill_with_cache`` / ``decode_step`` / ``generate``)
and the paged-pool functions the continuous-batching engine drives
(``prefill_into_pages``, ``decode_step_paged``, ``decode_step_paged_attn``,
``decode_step_paged_multi``, ``prefill_suffix_into_pages``).

Parameters are a plain dict of tensors in the JAX package's layouts, so
each of its einsums ports one for one:

- ``wq [d, h, hd]``, ``wk``/``wv [d, kv, hd]``, ``wo [h, hd, d]``;
- ``w_gate``/``w_up [d, f]``, ``w_down [f, d]``;
- ``embed [V, d]``, ``lm_head [d, V]``;
- KV pages ``[num_blocks, block_size, kv, hd]`` per layer.

Numerics follow the reference: attention scores and softmax in fp32,
``rms_norm`` casts to the input dtype before the weight, RoPE rotates
interleaved pairs, logits come back as fp32.

Tensor parallelism (``param_specs``, Megatron-style, as the reference's):
a tp plan's model is a list of per-shard parameter dicts
(:func:`shard_params`) and a list of per-shard pools, each shard on its
own device. The paged functions take either form. Per layer each shard
computes its heads' q/k/v from its slice of ``wq``/``wk``/``wv``, writes
and reads its KV-head slice of the pool, multiplies by its rows of
``wo``; the partials are all-reduced (fp32, cast once) and added to the
residual; the MLP runs on its columns of ``w_gate``/``w_up`` and rows of
``w_down``, all-reduced likewise. The embedding is sharded by vocabulary
rows, the LM head by columns, whose outputs are all-gathered. The dense
:func:`forward` runs under a full ``dp x sp x tp`` plan: batch blocks
over dp, the same tp shards, and sequence blocks over sp with attention
as ring attention (``parallel/ring_attention.py``).

The training half: :func:`loss_fn` (mean next-token NLL) and
:func:`make_train_step` (autograd through the shard loop and the
collectives, then optax's AdamW, :class:`AdamW`), unsharded or under a
plan in one process.

JAX updated the page pool through buffer donation (``llm/serving.py``
warmup); here every page write is an in-place ``index_put_`` on the pool
tensors, and the functions still return ``(logits, pages)`` so the
engine's contract is unchanged. Physical block 0 is the trash block:
padding lanes and padded prompt tails write there, and the validity mask
hides it from attention.
"""

import dataclasses
from typing import Any, ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.parallel import DP_AXIS, SP_AXIS, TP_AXIS, collectives, sharding
from client_tpu_torch.parallel.ring_attention import _local_ring_attention, reference_attention
from client_tpu_torch.utils import numpy_to_tensor, resolve_device

NEG_INF = -1e30

Pages = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-7B's published widths by default."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """A tiny config for tests."""
        base = dict(
            vocab_size=256,
            d_model=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=4,
            d_ff=128,
            max_seq_len=128,
        )
        base.update(overrides)
        return LlamaConfig(**base)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, config: LlamaConfig,
                device=None) -> Dict[str, Any]:
    """Random parameters (scaled-normal init, the reference's scales)
    drawn from ``generator``, which must live on ``device``."""
    device = resolve_device(device)
    d, h, hd, f = config.d_model, config.n_heads, config.head_dim, config.d_ff
    kv = config.n_kv_heads

    def normal(shape, scale):
        sample = torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )
        return sample.mul_(scale).to(config.dtype)

    def ones():
        return torch.ones(d, device=device, dtype=config.dtype)

    scale = 1.0 / np.sqrt(d)
    layers = []
    for _ in range(config.n_layers):
        layers.append(
            {
                "wq": normal((d, h, hd), scale),
                "wk": normal((d, kv, hd), scale),
                "wv": normal((d, kv, hd), scale),
                "wo": normal((h, hd, d), scale / np.sqrt(2 * config.n_layers)),
                "w_gate": normal((d, f), scale),
                "w_up": normal((d, f), scale),
                "w_down": normal((f, d), 1.0 / np.sqrt(f)),
                "attn_norm": ones(),
                "mlp_norm": ones(),
            }
        )
    return {
        "embed": normal((config.vocab_size, d), 1.0),
        "final_norm": ones(),
        "lm_head": normal((d, config.vocab_size), scale),
        "layers": layers,
    }


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as torch tensors on ``device``
    with every layout and bit kept."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(value) for value in node]
        return numpy_to_tensor(np.asarray(node), device)

    return convert(tree)


def param_specs(config: LlamaConfig) -> Dict[str, Any]:
    """The spec twin of :func:`init_params` (tp = tensor parallel): heads
    and the MLP hidden over ``tp``, the embedding over vocabulary rows,
    the LM head over vocabulary columns."""
    layer = {
        "wq": (None, TP_AXIS, None),
        "wk": (None, TP_AXIS, None),
        "wv": (None, TP_AXIS, None),
        "wo": (TP_AXIS, None, None),
        "w_gate": (None, TP_AXIS),
        "w_up": (None, TP_AXIS),
        "w_down": (TP_AXIS, None),
        "attn_norm": (),
        "mlp_norm": (),
    }
    return {
        "embed": (TP_AXIS, None),
        "final_norm": (),
        "lm_head": (None, TP_AXIS),
        "layers": [layer] * config.n_layers,
    }


def shard_params(params: Dict[str, Any], config: LlamaConfig, plan) -> List[Dict[str, Any]]:
    """``params`` cut per :func:`param_specs` over ``plan``'s devices: one
    parameter dict per device, each tensor its contiguous block on that
    device (:func:`~client_tpu_torch.parallel.sharding.shard_tree`)."""
    return sharding.shard_tree(params, param_specs(config), plan)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


def _rope(x, positions, theta):
    """Rotary position embedding on interleaved pairs; x: [..., L, H, D],
    positions: [..., L]."""
    head_dim = x.shape[-1]
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=x.device) / head_dim
    freqs = 1.0 / (theta ** exponents)
    angles = positions[..., None].float() * freqs  # [..., L, D/2]
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _repeat_kv(x, n_rep: int):
    """[B, L, KV, D] -> [B, L, KV*n_rep, D]: query head k*n_rep + r reads
    KV head k (grouped-query attention)."""
    if n_rep == 1:
        return x
    b, l, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, l, kv, n_rep, d).reshape(b, l, kv * n_rep, d)


def _heads(x, w):
    """``einsum("bld,dhk->blhk", x, w)`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _merge_heads(out, wo):
    """``einsum("...hk,hkd->...d", out, wo)`` as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


def _qkv(layer, normed, positions, config: LlamaConfig):
    q = _rope(_heads(normed, layer["wq"]), positions, config.rope_theta)
    k = _rope(_heads(normed, layer["wk"]), positions, config.rope_theta)
    v = _heads(normed, layer["wv"])
    return q, k, v


def _mlp_block(layer, x):
    gate = F.silu(x @ layer["w_gate"])
    up = x @ layer["w_up"]
    return (gate * up) @ layer["w_down"]


def _logits(params, x, config: LlamaConfig):
    """Final norm and LM head over rows ``x [..., d]``; fp32 logits."""
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return (x @ params["lm_head"]).float()


def _masked_attention(q, k_ctx, v_ctx, valid, n_rep: int):
    """Single-query attention of ``q [B, 1, H, D]`` over a gathered
    ``[B, S, KV, D]`` context under ``valid [B, S]``; ``[B, 1, H, D]``."""
    qh = q.transpose(1, 2)  # [B, H, 1, D]
    kh = _repeat_kv(k_ctx, n_rep).transpose(1, 2)  # [B, H, S, D]
    vh = _repeat_kv(v_ctx, n_rep).transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) / np.sqrt(q.shape[-1])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vh.float())
    return out.to(q.dtype).transpose(1, 2)


# ---------------------------------------------------------------------------
# dense KV-cache decode (the oracle)
# ---------------------------------------------------------------------------


def init_kv_cache(config: LlamaConfig, batch: int, max_len: Optional[int] = None,
                  device=None):
    """Zeroed dense cache: one (k, v) pair of ``[B, S, KV, D]`` per layer."""
    device = resolve_device(device)
    max_len = max_len or config.max_seq_len
    shape = (batch, max_len, config.n_kv_heads, config.head_dim)
    return [
        (
            torch.zeros(shape, dtype=config.dtype, device=device),
            torch.zeros(shape, dtype=config.dtype, device=device),
        )
        for _ in range(config.n_layers)
    ]


def prefill_with_cache(params, tokens, cache, config: LlamaConfig,
                       last_index: Optional[int] = None):
    """Run the prompt ``tokens [B, L]`` through the model, writing its
    K/V into ``cache`` (in place). Returns (logits of position
    ``last_index`` — the last by default — ``[B, V]``, cache)."""
    b, l = tokens.shape
    positions = torch.arange(l, device=tokens.device)[None, :].expand(b, l)
    x = params["embed"][tokens.long()].to(config.dtype)
    n_rep = config.n_heads // config.n_kv_heads
    for layer, (cache_k, cache_v) in zip(params["layers"], cache):
        normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = _qkv(layer, normed, positions, config)
        cache_k[:, :l] = k
        cache_v[:, :l] = v
        qh = q.transpose(1, 2)
        kh = _repeat_kv(k, n_rep).transpose(1, 2)
        vh = _repeat_kv(v, n_rep).transpose(1, 2)
        out = reference_attention(qh, kh, vh, causal=True).transpose(1, 2)
        x = x + _merge_heads(out, layer["wo"])
        x = x + _mlp_block(layer, rms_norm(x, layer["mlp_norm"], config.norm_eps))
    last = x[:, -1] if last_index is None else x[:, int(last_index)]
    return _logits(params, last, config), cache


def decode_step(params, token, position: int, cache, config: LlamaConfig):
    """One dense decode step: ``token [B]`` at the shared scalar
    ``position``; writes the cache in place. Returns (logits [B, V], cache)."""
    b = token.shape[0]
    device = token.device
    positions = torch.full((b, 1), int(position), dtype=torch.int32, device=device)
    x = params["embed"][token.long()][:, None, :].to(config.dtype)
    n_rep = config.n_heads // config.n_kv_heads
    for layer, (cache_k, cache_v) in zip(params["layers"], cache):
        normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = _qkv(layer, normed, positions, config)
        cache_k[:, position] = k[:, 0]
        cache_v[:, position] = v[:, 0]
        valid = torch.arange(cache_k.shape[1], device=device) <= position
        out = _masked_attention(q, cache_k, cache_v, valid[None].expand(b, -1), n_rep)
        x = x + _merge_heads(out, layer["wo"])
        x = x + _mlp_block(layer, rms_norm(x, layer["mlp_norm"], config.norm_eps))
    return _logits(params, x[:, 0], config), cache


def generate(params, prompt_tokens, config: LlamaConfig, max_new_tokens: int):
    """Greedy generation: ``[B, max_new_tokens]`` token ids."""
    b, prompt_len = prompt_tokens.shape
    cache = init_kv_cache(config, b, prompt_len + max_new_tokens,
                          device=prompt_tokens.device)
    logits, cache = prefill_with_cache(params, prompt_tokens, cache, config)
    token = logits.argmax(dim=-1).to(torch.int32)
    out = [token]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(params, token, prompt_len + i, cache, config)
        token = logits.argmax(dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# paged KV cache (block-pool layout for the continuous-batching engine)
# ---------------------------------------------------------------------------


def init_kv_pages(config: LlamaConfig, num_blocks: int, block_size: int,
                  device=None) -> Pages:
    """Zeroed block pool: one (k_pages, v_pages) pair per layer."""
    device = resolve_device(device)
    shape = (num_blocks, block_size, config.n_kv_heads, config.head_dim)
    return [
        (
            torch.zeros(shape, dtype=config.dtype, device=device),
            torch.zeros(shape, dtype=config.dtype, device=device),
        )
        for _ in range(config.n_layers)
    ]


def _table_lookup(page_table, logical_blocks):
    """``page_table[..., logical_blocks]`` along the table's last axis
    (one table ``[NB]``, or one per lane ``[B, NB]`` with
    ``logical_blocks [B, T]``), with XLA's clamp on an index past the
    table's end (the masked positions that produce one go to the trash
    block anyway)."""
    index = logical_blocks.clamp(max=page_table.shape[-1] - 1).long()
    return torch.take_along_dim(page_table, index, dim=-1).long()


# ---------------------------------------------------------------------------
# the layer stack over shards (one shard: the unsharded model)
# ---------------------------------------------------------------------------


def _as_shards(params, pages):
    """(per-shard params, per-shard pools): a list of shard dicts is a tp
    plan's model (:func:`shard_params`) with a list of per-shard pools;
    a dict is the unsharded model, one shard."""
    if isinstance(params, list):
        return params, pages
    return [params], [pages]


def _devices(shards) -> List[torch.device]:
    return [shard["final_norm"].device for shard in shards]


def _embed(shards, tokens, config: LlamaConfig) -> List[torch.Tensor]:
    """The token embeddings on every shard (the table sharded by
    vocabulary rows under tp)."""
    return [e.to(config.dtype) for e in collectives.vocab_parallel_embedding(
        [shard["embed"] for shard in shards], tokens, collectives.group_of(shards))]


def _tp_residual(x, partials, group=None) -> List[torch.Tensor]:
    """``x + sum(partials)`` on every shard: the partials all-reduced (no
    reduction for one shard of a mesh in one process), over ``group``'s
    processes too when the mesh spans a pod."""
    reduced = collectives.all_reduce(partials, [t.device for t in x], group)
    return [xi + r for xi, r in zip(x, reduced)]


def _layers(shards, x, positions, config: LlamaConfig, attend,
            residual=None) -> List[torch.Tensor]:
    """The layer stack over the shards' activations ``x`` (one tensor per
    shard) at ``positions`` (likewise). ``attend(layer_index, [(q, k, v)
    per shard]) -> [out per shard]`` is each path's attention on the
    shard's own heads (it writes the shard's pool); ``residual(x,
    partials)`` adds the shards' attention and MLP partials — all-reduced
    over tp shards (and the pod's processes) by default."""
    if residual is None:
        group = collectives.group_of(shards)

        def residual(x, partials):
            return _tp_residual(x, partials, group)

    eps = config.norm_eps
    for index in range(config.n_layers):
        layers = [shard["layers"][index] for shard in shards]
        qkv = [_qkv(layer, rms_norm(xi, layer["attn_norm"], eps), pos, config)
               for layer, xi, pos in zip(layers, x, positions)]
        outs = attend(index, qkv)
        x = residual(x, [_merge_heads(out, layer["wo"]) for out, layer in zip(outs, layers)])
        x = residual(x, [_mlp_block(layer, rms_norm(xi, layer["mlp_norm"], eps))
                         for layer, xi in zip(layers, x)])
    return x


def _shard_logits(shards, rows, config: LlamaConfig) -> torch.Tensor:
    """Final norm and LM head over each shard's ``rows [..., d]``; the
    shards' vocabulary columns are all-gathered; fp32."""
    parts = [_logits(shard, r, config) for shard, r in zip(shards, rows)]
    return collectives.all_gather(parts, [p.device for p in parts], dim=-1,
                                  group=collectives.group_of(shards))[0]


def _on(tensor, devices) -> List[torch.Tensor]:
    """A replicated host-side input (tokens, tables, positions) on every
    shard's device; no copy where it already lives."""
    return [tensor.to(d) for d in devices]


def _block(tensor, row: int, rows: int, col: int, cols: int):
    """Block ``(row, col)`` of a ``[B, L]`` tensor cut into ``rows`` x
    ``cols`` blocks along its first dims; a first dim of 1 broadcasts."""
    if tensor.shape[0] > 1:
        tensor = tensor.chunk(rows, dim=0)[row]
    return tensor.chunk(cols, dim=1)[col]


def forward(params, tokens, config: LlamaConfig, mesh=None, positions=None):
    """Full-sequence forward (prefill): ``tokens [B, L]`` -> fp32 logits
    ``[B, L, V]``, without a KV cache; differentiable, for
    :func:`loss_fn`.

    Under a plan (``mesh``) in one process, batch blocks go over ``dp``,
    heads, the MLP hidden and the vocabulary over ``tp`` (``param_specs``)
    and sequence blocks over ``sp``, the reference's ``P(dp, tp, sp,
    None)``: the device at coordinates ``(dp=a, sp=s, tp=t)`` holds token
    block ``(a, s)`` and tp shard ``t`` of the weights. Each tp group
    all-reduces its partials, each (dp, tp) shard's sp group runs ring
    attention, and each tp group all-gathers its vocabulary columns.
    ``params`` is one dict, cut here by :func:`shard_params` on the
    autograd graph, or the per-device trees in the plan's device order.
    ``tokens`` may also be one block per plan device on that device; the
    logits then come back as such a list. A plan that spans processes (a
    pod) is refused: its collectives are not differentiable."""
    if mesh is not None and mesh.spans_processes or collectives.group_of(params) is not None:
        raise ValueError("forward runs a plan in one process only: the collectives "
                         "between a pod's processes are not differentiable")
    blocks = list(tokens) if isinstance(tokens, (list, tuple)) else None
    plan = mesh or sharding.MeshPlan(sharding.MeshSpec.parse({"axes": {DP_AXIS: 1}}),
                                     ((blocks or [tokens])[0].device,))
    devices = list(plan.devices)
    n = len(devices)
    dp, sp = plan.axis_size(DP_AXIS), plan.axis_size(SP_AXIS)
    coords = [(c.get(DP_AXIS, 0), c.get(SP_AXIS, 0)) for c in map(plan.coords, range(n))]
    if isinstance(params, list):
        shards = params
    else:
        shards = [params] if mesh is None else shard_params(params, config, plan)
    if len(shards) != n:
        raise ValueError(f"{len(shards)} parameter shards for a plan of {n} devices")
    if blocks is None:
        if tokens.shape[0] % dp or tokens.shape[1] % sp:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not split over dp={dp}, sp={sp}")
        blocks = [_block(tokens, a, dp, s, sp).to(d) for (a, s), d in zip(coords, devices)]
    elif len(blocks) != n:
        raise ValueError(f"{len(blocks)} token blocks for a plan of {n} devices")
    b, lb = blocks[0].shape
    if positions is None:
        positions = torch.arange(lb * sp, device=devices[0])[None, :].expand(b * dp, -1)
    pos_blocks = [_block(positions, a, dp, s, sp).to(d) for (a, s), d in zip(coords, devices)]
    tp_groups, sp_groups = plan.groups(TP_AXIS), plan.groups(SP_AXIS)

    def per_group(groups, fn, parts):
        """``fn`` over each group's parts, the results put back in device order."""
        out = [None] * n
        for group in groups:
            for j, result in zip(group, fn([parts[j] for j in group], group)):
                out[j] = result
        return out

    x = per_group(tp_groups, lambda tables, group: collectives.vocab_parallel_embedding(
        tables, blocks[group[0]]), [shard["embed"] for shard in shards])
    x = [xi.to(config.dtype) for xi in x]

    def attend_group(qkv, group):
        n_rep = qkv[0][0].shape[2] // qkv[0][1].shape[2]
        qh = [q.transpose(1, 2) for q, _, _ in qkv]
        kh = [_repeat_kv(k, n_rep).transpose(1, 2) for _, k, _ in qkv]
        vh = [_repeat_kv(v, n_rep).transpose(1, 2) for _, _, v in qkv]
        if len(group) == 1:
            outs = [reference_attention(qh[0], kh[0], vh[0], causal=True)]
        else:
            outs = _local_ring_attention(qh, kh, vh, causal=True,
                                         scale=1.0 / (qh[0].shape[-1] ** 0.5))
        return [out.transpose(1, 2) for out in outs]

    def residual(x, partials):
        reduced = per_group(tp_groups, lambda parts, group: collectives.all_reduce(
            parts, [devices[j] for j in group]), partials)
        return [xi + r for xi, r in zip(x, reduced)]

    x = _layers(shards, x, pos_blocks, config,
                lambda index, qkv: per_group(sp_groups, attend_group, qkv), residual)
    logits = per_group(tp_groups, lambda parts, group: collectives.all_gather(
        parts, [devices[j] for j in group], dim=-1),
        [_logits(shard, xi, config) for shard, xi in zip(shards, x)])
    if isinstance(tokens, (list, tuple)):
        return logits
    # one device of each (dp, sp) block, in grid order
    first = {}
    for j, key in enumerate(coords):
        first.setdefault(key, j)
    home = tokens.device
    rows = [[logits[first[(a, s)]].to(home) for s in range(sp)] for a in range(dp)]
    if dp == sp == 1:
        return rows[0][0]
    return torch.cat([torch.cat(row, dim=1) for row in rows], dim=0)


def loss_fn(params, tokens, config: LlamaConfig, mesh=None):
    """Next-token cross-entropy over ``tokens [B, L]``: :func:`forward` on
    the whole sequence (so that L still splits over a plan's sp), the last
    position dropped, the mean NLL over every row of the batch. Under dp
    that is the global mean, so autograd averages the dp blocks'
    gradients with no collective of its own."""
    logits = forward(params, tokens, config, mesh)[:, :-1]
    targets = tokens[:, 1:].to(logits.device).long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in _leaves(value)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its tensors taken in order from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {key: _rebuild(value, leaves) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(value, leaves) for value in tree]
    return next(leaves)


@dataclasses.dataclass
class AdamWState:
    """The step count and the two moments, one tensor per parameter, in
    the parameters' dtype (optax's ``ScaleByAdamState``)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate)`` with optax 0.2.6's defaults (b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0, weight decay 1e-4, no mask, moments in
    the parameter dtype) as a functional pair: :meth:`init` and
    :meth:`update`. One step is ``p - lr * (mu_hat / (sqrt(nu_hat) + eps)
    + wd * p)`` with ``mu_hat = mu / (1 - b1^t)`` and ``nu_hat = nu / (1 -
    b2^t)``, computed a tensor at a time, so its temporaries stay the size
    of the largest parameter."""

    learning_rate: float = 1e-3
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8
    weight_decay: ClassVar[float] = 1e-4

    def init(self, params) -> AdamWState:
        leaves = _leaves(params)
        return AdamWState(0, [torch.zeros_like(p) for p in leaves],
                          [torch.zeros_like(p) for p in leaves])

    @torch.no_grad()
    def update(self, params, grads: List[torch.Tensor], state: AdamWState) -> AdamWState:
        """Apply one step to ``params``' tensors in place, given their
        ``grads`` in :func:`_leaves` order; the moments move in place too."""
        count = state.count + 1
        b1, b2, lr = self.b1, self.b2, self.learning_rate
        correction1, correction2 = 1 - b1 ** count, 1 - b2 ** count
        for p, g, mu, nu in zip(_leaves(params), grads, state.mu, state.nu):
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (nu / correction2).sqrt_().add_(self.eps)
            p.mul_(1 - lr * self.weight_decay).addcdiv_(mu, denom, value=-lr / correction1)
        return AdamWState(count, state.mu, state.nu)


def make_train_step(config: LlamaConfig, mesh, learning_rate=1e-3):
    """``(train_step, optimizer)``: ``train_step(params, opt_state,
    tokens) -> (params, opt_state, loss)`` runs :func:`loss_fn` under
    ``mesh`` (None, or a plan in one process), its gradients by autograd
    through the shard loop and the collectives, and one :class:`AdamW`
    step; ``opt_state = optimizer.init(params)``. ``params`` is the
    unsharded tree, as the reference's train step takes it; it and the
    optimizer's moments are updated in place and returned, so the step
    holds no second copy of the weights."""
    if mesh is not None and mesh.spans_processes:
        raise ValueError("make_train_step runs a plan in one process only: the "
                         "collectives between a pod's processes are not differentiable")
    optimizer = AdamW(learning_rate)

    def train_step(params, opt_state: AdamWState, tokens):
        watched = [leaf.detach().requires_grad_() for leaf in _leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_rebuild(params, iter(watched)), tokens, config, mesh)
            grads = torch.autograd.grad(loss, watched)
        opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return train_step, optimizer


def prefill_into_pages(params, tokens, page_table, pages, last_index: int,
                       config: LlamaConfig):
    """Prefill one prompt ``tokens [1, L]`` (L = padded bucket length),
    writing positions ``0..last_index`` into the pool through ``page_table
    [max_blocks]``; the padded tail goes to the trash block. Causal
    attention reads the prompt's own K/V, never the pool. Returns (logits
    of ``last_index`` [1, V], pages). ``params``/``pages`` are one model
    and pool, or a tp plan's per-shard lists."""
    shards, shard_pages = _as_shards(params, pages)
    devices = _devices(shards)
    b, l = tokens.shape
    block_size = shard_pages[0][0][0].shape[1]
    pos = torch.arange(l, device=tokens.device)
    valid = pos <= last_index
    phys = torch.where(valid, _table_lookup(page_table, pos // block_size), 0)
    off = torch.where(valid, pos % block_size, 0)
    writes = list(zip(_on(phys, devices), _on(off, devices)))

    def attend(index, qkv):
        outs = []
        for (q, k, v), layer_pages, (p, o) in zip(qkv, shard_pages, writes):
            k_pages, v_pages = layer_pages[index]
            k_pages.index_put_((p, o), k[0])
            v_pages.index_put_((p, o), v[0])
            n_rep = q.shape[2] // k.shape[2]
            out = reference_attention(q.transpose(1, 2), _repeat_kv(k, n_rep).transpose(1, 2),
                                      _repeat_kv(v, n_rep).transpose(1, 2), causal=True)
            outs.append(out.transpose(1, 2))
        return outs

    x = _layers(shards, _embed(shards, tokens, config),
                _on(pos[None, :].expand(b, l), devices), config, attend)
    return _shard_logits(shards, [xi[:, int(last_index)] for xi in x], config), pages


def _write_positions(page_tables, positions, block_size):
    """(physical block, offset) that each lane's token at ``positions``
    writes to."""
    lanes = torch.arange(page_tables.shape[0], device=page_tables.device)
    phys = page_tables[lanes, (positions // block_size).long()].long()
    return phys, (positions % block_size).long()


def decode_step_paged(params, tokens, positions, page_tables, pages: Pages,
                      config: LlamaConfig):
    """One continuous-batching decode step over the pool with the
    attention inline (gather + repeat + full-width masked softmax).

    ``tokens [B]`` each sequence's latest token, ``positions [B]`` its
    context position, ``page_tables [B, max_blocks]``. Writes each
    token's K/V into its current block, then attends under the
    per-sequence validity mask (slot <= position). Padding lanes (table
    all zeros, position 0) write to the trash block and give logits the
    caller discards. Returns (logits [B, V], pages)."""
    b = tokens.shape[0]
    block_size = pages[0][0].shape[1]
    s = page_tables.shape[1] * block_size
    n_rep = config.n_heads // config.n_kv_heads
    pos2 = positions[:, None]  # [B, 1]
    phys, off = _write_positions(page_tables, positions, block_size)
    valid = torch.arange(s, device=tokens.device)[None, :] <= pos2  # [B, S]
    tables = page_tables.long()

    def attend(index, qkv):
        ((q, k, v),) = qkv
        k_pages, v_pages = pages[index]
        # scatter this step's K/V, THEN gather: the current position's
        # entry must be visible to its own attention
        k_pages.index_put_((phys, off), k[:, 0])
        v_pages.index_put_((phys, off), v[:, 0])
        k_ctx = k_pages[tables].reshape(b, s, config.n_kv_heads, config.head_dim)
        v_ctx = v_pages[tables].reshape(b, s, config.n_kv_heads, config.head_dim)
        return [_masked_attention(q, k_ctx, v_ctx, valid, n_rep)]

    (x,) = _layers([params], [params["embed"][tokens.long()][:, None, :].to(config.dtype)],
                   [pos2], config, attend)
    return _logits(params, x[:, 0], config), pages


def _paged_attend(shards, shard_pages, writes, page_tables, positions, attn, rows):
    """The attention of the kernel paths: each shard writes its step's
    K/V (``rows`` = the rows of one lane written, ``k[:, 0]`` for decode,
    ``k`` for verify), THEN ``attn`` reads the pool on the same stream.
    One shard calls ``attn`` as it is; a tp plan's ``attn`` is
    :func:`~client_tpu_torch.models.paged_attention.make_tp_attention`'s
    wrapper, given every (local) shard's query block and pools."""

    def attend(index, qkv):
        pools = [layer_pages[index] for layer_pages in shard_pages]
        for (_, k, v), (k_pages, v_pages), (p, o) in zip(qkv, pools, writes):
            k_pages.index_put_((p, o), rows(k))
            v_pages.index_put_((p, o), rows(v))
        queries = [rows(q) for q, _, _ in qkv]
        if len(shards) == 1 and collectives.group_of(shards) is None:
            outs = [attn(queries[0].contiguous(), pools[0][0], pools[0][1],
                         page_tables, positions)]
        else:
            outs = attn(queries, [k for k, _ in pools], [v for _, v in pools],
                        page_tables, positions)
        return outs

    return attend


def decode_step_paged_attn(params, tokens, positions, page_tables, pages,
                           config: LlamaConfig, attn):
    """:func:`decode_step_paged` with the attention read delegated to a
    ragged paged-attention implementation
    (``models/paged_attention.py``): ``attn(q[B, H, D], k_pages, v_pages,
    page_tables, positions) -> [B, H, D]``. The table width may be any
    bucket the caller picks; the engine slices it to the live batch's
    longest sequence. The step's K/V is written on the same stream
    before ``attn`` reads the pool. Under a tp plan (per-shard ``params``
    and ``pages``) ``attn`` is the per-shard wrapper, and each shard's
    call sees its ``H/tp`` heads and its pool of ``KV/tp``."""
    shards, shard_pages = _as_shards(params, pages)
    devices = _devices(shards)
    block_size = shard_pages[0][0][0].shape[1]
    pos2 = positions[:, None]  # [B, 1]
    phys, off = _write_positions(page_tables, positions, block_size)
    writes = list(zip(_on(phys, devices), _on(off, devices)))
    attend = _paged_attend(shards, shard_pages, writes, page_tables, positions, attn,
                           lambda t: t[:, 0])

    def attend_rows(index, qkv):
        return [out[:, None] for out in attend(index, qkv)]

    x = _layers(shards, _embed(shards, tokens[:, None], config), _on(pos2, devices),
                config, attend_rows)
    return _shard_logits(shards, [xi[:, 0] for xi in x], config), pages


def decode_step_paged_multi(params, tokens, positions, lengths, page_tables,
                            pages, config: LlamaConfig, attn_mq):
    """The speculative verify step: T query positions per sequence in one
    multi-query ragged paged-attention call per layer (per shard under a
    tp plan).

    ``tokens [B, T]`` (row 0 each lane's last real token, rows ``1..``
    its draft tokens), ``positions [B, T]`` every row's absolute context
    position, ``lengths [B]`` how many leading rows of each lane are real:
    rows at ``t >= lengths[b]`` are padding, write their K/V to the trash
    slot (block 0, offset 0) and give logits the caller discards. All T
    rows' K/V are written on the same stream before ``attn_mq(q[B, T, H,
    D], k_pages, v_pages, page_tables, positions) -> [B, T, H, D]`` reads
    the pool, and its per-row mask (slot <= positions[b, t]) gives row t
    exactly its own speculative prefix, so the T logits rows equal T
    sequential :func:`decode_step_paged` calls feeding the draft tokens
    one at a time. Returns (logits [B, T, V] fp32, pages)."""
    shards, shard_pages = _as_shards(params, pages)
    devices = _devices(shards)
    t = tokens.shape[1]
    block_size = shard_pages[0][0][0].shape[1]
    row_valid = torch.arange(t, device=tokens.device)[None, :] < lengths[:, None]
    phys = torch.where(row_valid, _table_lookup(page_tables, positions // block_size), 0)
    off = torch.where(row_valid, positions % block_size, 0).long()
    writes = list(zip(_on(phys, devices), _on(off, devices)))
    # write every verify row's K/V, THEN attend: row t's prefix rows
    # 0..t-1 must be visible to it (the per-row mask hides t+1..)
    attend = _paged_attend(shards, shard_pages, writes, page_tables, positions, attn_mq,
                           lambda x: x)
    x = _layers(shards, _embed(shards, tokens, config), _on(positions, devices), config,
                attend)
    return _shard_logits(shards, x, config), pages


def prefill_suffix_into_pages(params, tokens, page_table, pages, last_index: int,
                              start_index: int, prefix_blocks: int,
                              config: LlamaConfig):
    """Prefill only a prompt's unshared suffix, attending to its shared
    prefix through the pool (the compute half of copy-on-write prefix
    sharing: matched blocks are read, never recomputed, never written).

    ``tokens [1, L]`` holds ``context[start_index:]`` padded to the
    bucket length; ``last_index`` is the suffix-local index of the real
    last token; ``start_index`` (block-aligned) the absolute position of
    ``tokens[0, 0]``. ``prefix_blocks`` is a power-of-two bucket
    ``>= start_index // block_size`` that fixes the prefix gather width;
    slack slots are masked by absolute position. Only blocks at index
    ``>= start_index // block_size`` are written. Returns (logits of
    ``last_index`` [1, V], pages); per-shard ``params``/``pages`` as for
    :func:`prefill_into_pages`."""
    shards, shard_pages = _as_shards(params, pages)
    devices = _devices(shards)
    b, l = tokens.shape
    device = tokens.device
    block_size = shard_pages[0][0][0].shape[1]
    pos = torch.arange(l, device=device)
    abs_pos = start_index + pos  # [L]
    valid_w = pos <= last_index
    phys_w = torch.where(valid_w, _table_lookup(page_table, abs_pos // block_size), 0)
    off_w = torch.where(valid_w, abs_pos % block_size, 0)
    s0 = prefix_blocks * block_size
    # key validity: prefix slot s is real iff s < start_index; suffix key
    # j needs causality within the suffix and j <= last_index
    prefix_valid = (torch.arange(s0, device=device) < start_index)[None, :]  # [1, s0]
    suffix_valid = (pos[:, None] >= pos[None, :]) & (pos[None, :] <= last_index)
    mask = torch.cat([prefix_valid.expand(l, s0), suffix_valid], dim=1)  # [L, s0+L]
    prefix_table = page_table[:prefix_blocks].long()
    per_shard = list(zip(_on(phys_w, devices), _on(off_w, devices),
                         _on(prefix_table, devices), _on(mask, devices)))

    def attend(index, qkv):
        outs = []
        for (q, k, v), layer_pages, (p, o, table, m) in zip(qkv, shard_pages, per_shard):
            k_pages, v_pages = layer_pages[index]
            kv_heads, hd = k.shape[2], k.shape[3]
            g = q.shape[2] // kv_heads
            k_pages.index_put_((p, o), k[0])
            v_pages.index_put_((p, o), v[0])
            k_pref = k_pages[table].reshape(1, s0, kv_heads, hd)
            v_pref = v_pages[table].reshape(1, s0, kv_heads, hd)
            k_all = torch.cat([k_pref.to(k.dtype), k], dim=1)
            v_all = torch.cat([v_pref.to(v.dtype), v], dim=1)
            qg = q.reshape(b, l, kv_heads, g, hd)
            scores = torch.einsum("blkgd,bskd->bkgls", qg.float(), k_all.float()) / np.sqrt(hd)
            scores = torch.where(m[None, None, None], scores, NEG_INF)
            weights = torch.softmax(scores, dim=-1)
            out = torch.einsum("bkgls,bskd->blkgd", weights, v_all.float())
            outs.append(out.reshape(b, l, q.shape[2], hd).to(q.dtype))
        return outs

    x = _layers(shards, _embed(shards, tokens, config),
                _on(abs_pos[None, :], devices), config, attend)
    return _shard_logits(shards, [xi[:, int(last_index)] for xi in x], config), pages

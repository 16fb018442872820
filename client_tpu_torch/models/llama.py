"""Decoder-only transformer (Llama-family architecture) in PyTorch.

The port of ``client_tpu/models/llama.py``'s serving half: the dense
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

JAX updated the page pool through buffer donation (``llm/serving.py``
warmup); here every page write is an in-place ``index_put_`` on the pool
tensors, and the functions still return ``(logits, pages)`` so the
engine's contract is unchanged. Physical block 0 is the trash block:
padding lanes and padded prompt tails write there, and the validity mask
hides it from attention.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def reference_attention(q, k, v, causal: bool = True, scale=None):
    """Exact attention over ``[B, H, L, D]`` (the port's own copy of
    ``client_tpu/parallel/ring_attention.py::reference_attention``)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_len, k_len = q.shape[2], k.shape[2]
        rows = torch.arange(q_len, device=q.device)[:, None]
        cols = torch.arange(k_len, device=q.device)[None, :]
        scores = torch.where((rows >= cols)[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v.float()).to(q.dtype)


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


def prefill_into_pages(params, tokens, page_table, pages: Pages,
                       last_index: int, config: LlamaConfig):
    """Prefill one prompt ``tokens [1, L]`` (L = padded bucket length)
    on a dense scratch cache, then scatter positions ``0..last_index``
    into the pool through ``page_table [max_blocks]``; the padded tail
    goes to the trash block. Returns (logits of ``last_index`` [1, V],
    pages)."""
    b, l = tokens.shape
    block_size = pages[0][0].shape[1]
    scratch = init_kv_cache(config, b, l, device=tokens.device)
    logits, dense = prefill_with_cache(params, tokens, scratch, config,
                                       last_index=last_index)
    pos = torch.arange(l, device=tokens.device)
    valid = pos <= last_index
    phys = torch.where(valid, _table_lookup(page_table, pos // block_size), 0)
    off = torch.where(valid, pos % block_size, 0)
    for (k_pages, v_pages), (dense_k, dense_v) in zip(pages, dense):
        k_pages.index_put_((phys, off), dense_k[0])
        v_pages.index_put_((phys, off), dense_v[0])
    return logits, pages


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
    x = params["embed"][tokens.long()][:, None, :].to(config.dtype)
    for layer, (k_pages, v_pages) in zip(params["layers"], pages):
        normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = _qkv(layer, normed, pos2, config)
        # scatter this step's K/V, THEN gather: the current position's
        # entry must be visible to its own attention
        k_pages.index_put_((phys, off), k[:, 0])
        v_pages.index_put_((phys, off), v[:, 0])
        k_ctx = k_pages[tables].reshape(b, s, config.n_kv_heads, config.head_dim)
        v_ctx = v_pages[tables].reshape(b, s, config.n_kv_heads, config.head_dim)
        out = _masked_attention(q, k_ctx, v_ctx, valid, n_rep)
        x = x + _merge_heads(out, layer["wo"])
        x = x + _mlp_block(layer, rms_norm(x, layer["mlp_norm"], config.norm_eps))
    return _logits(params, x[:, 0], config), pages


def decode_step_paged_attn(params, tokens, positions, page_tables,
                           pages: Pages, config: LlamaConfig, attn):
    """:func:`decode_step_paged` with the attention read delegated to a
    ragged paged-attention implementation
    (``models/paged_attention.py``): ``attn(q[B, H, D], k_pages, v_pages,
    page_tables, positions) -> [B, H, D]``. The table width may be any
    bucket the caller picks; the engine slices it to the live batch's
    longest sequence. The step's K/V is written on the same stream
    before ``attn`` reads the pool."""
    block_size = pages[0][0].shape[1]
    pos2 = positions[:, None]  # [B, 1]
    phys, off = _write_positions(page_tables, positions, block_size)
    x = params["embed"][tokens.long()][:, None, :].to(config.dtype)
    for layer, (k_pages, v_pages) in zip(params["layers"], pages):
        normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = _qkv(layer, normed, pos2, config)
        # scatter this step's K/V, THEN attend: the current position's
        # entry must be visible to its own attention
        k_pages.index_put_((phys, off), k[:, 0])
        v_pages.index_put_((phys, off), v[:, 0])
        out = attn(q[:, 0].contiguous(), k_pages, v_pages, page_tables, positions)
        x = x + _merge_heads(out, layer["wo"])[:, None, :]
        x = x + _mlp_block(layer, rms_norm(x, layer["mlp_norm"], config.norm_eps))
    return _logits(params, x[:, 0], config), pages


def decode_step_paged_multi(params, tokens, positions, lengths, page_tables,
                            pages: Pages, config: LlamaConfig, attn_mq):
    """The speculative verify step: T query positions per sequence in one
    multi-query ragged paged-attention call per layer.

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
    t = tokens.shape[1]
    block_size = pages[0][0].shape[1]
    row_valid = torch.arange(t, device=tokens.device)[None, :] < lengths[:, None]
    phys = torch.where(row_valid, _table_lookup(page_tables, positions // block_size), 0)
    off = torch.where(row_valid, positions % block_size, 0).long()
    x = params["embed"][tokens.long()].to(config.dtype)  # [B, T, d]
    for layer, (k_pages, v_pages) in zip(params["layers"], pages):
        normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = _qkv(layer, normed, positions, config)
        # write every verify row's K/V, THEN attend: row t's prefix rows
        # 0..t-1 must be visible to it (the per-row mask hides t+1..)
        k_pages.index_put_((phys, off), k)
        v_pages.index_put_((phys, off), v)
        out = attn_mq(q.contiguous(), k_pages, v_pages, page_tables, positions)
        x = x + _merge_heads(out, layer["wo"])
        x = x + _mlp_block(layer, rms_norm(x, layer["mlp_norm"], config.norm_eps))
    return _logits(params, x, config), pages


def prefill_suffix_into_pages(params, tokens, page_table, pages: Pages,
                              last_index: int, start_index: int,
                              prefix_blocks: int, config: LlamaConfig):
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
    ``last_index`` [1, V], pages)."""
    b, l = tokens.shape
    device = tokens.device
    block_size = pages[0][0].shape[1]
    kv_heads = config.n_kv_heads
    hd = config.head_dim
    g = config.n_heads // kv_heads
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
    x = params["embed"][tokens.long()].to(config.dtype)
    for layer, (k_pages, v_pages) in zip(params["layers"], pages):
        normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = _qkv(layer, normed, abs_pos[None, :], config)
        k_pages.index_put_((phys_w, off_w), k[0])
        v_pages.index_put_((phys_w, off_w), v[0])
        k_pref = k_pages[prefix_table].reshape(1, s0, kv_heads, hd)
        v_pref = v_pages[prefix_table].reshape(1, s0, kv_heads, hd)
        k_all = torch.cat([k_pref.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_pref.to(v.dtype), v], dim=1)
        qg = q.reshape(b, l, kv_heads, g, hd)
        scores = torch.einsum("blkgd,bskd->bkgls", qg.float(), k_all.float()) / np.sqrt(hd)
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgls,bskd->blkgd", weights, v_all.float())
        out = out.reshape(b, l, config.n_heads, hd).to(x.dtype)
        x = x + _merge_heads(out, layer["wo"])
        x = x + _mlp_block(layer, rms_norm(x, layer["mlp_norm"], config.norm_eps))
    return _logits(params, x[:, int(last_index)], config), pages

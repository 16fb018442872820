"""Ragged paged-attention decode: plain PyTorch versions and the CUDA kernel.

Every implementation shares one contract::

    attn(q[B, H, D], k_pages[N, bs, KV, D], v_pages[N, bs, KV, D],
         page_tables[B, NB], positions[B]) -> out[B, H, D]

with slot validity ``block*bs + offset <= positions[b]`` (the token just
scattered attends to itself), query head ``k*g + r`` reading KV head ``k``
(``g = H / KV``), and physical block 0 the trash block whose slots the
validity rule always masks. ``page_tables`` and ``positions`` are int32.

- :func:`paged_attention_standin`: gather + materialised head repeat +
  full-width masked softmax. The dumbest version, the oracle.
- :func:`paged_attention_fused`: grouped-query einsums over the gathered
  pages with no head repeat. The plain version the CPU path serves with.
- :func:`paged_attention_cuda`: the hand-written Hopper kernel
  (``csrc/paged_attention.cu``), which splits each sequence's context into
  partitions of P slots, walks each partition's pages up to the position
  with an fp32 online softmax, merges the partitions, and never gathers.
- :func:`paged_attention_split`: that partition-and-merge algorithm in
  plain PyTorch, with P an argument; only the tests use it.

Speculative decoding's verify step asks for logits at T positions per
sequence in one call, so each implementation has a multi-query twin::

    attn_mq(q[B, T, H, D], k_pages, v_pages, page_tables[B, NB],
            positions[B, T]) -> out[B, T, H, D]

where slot ``s`` is valid for row ``t`` iff ``s <= positions[b, t]``: row
``t`` sees exactly its own speculative prefix (rows ``0..t`` were written
before the read), so the T rows equal T sequential decode steps. Padding
rows give finite output the caller discards. The twins are
:func:`paged_attention_standin_mq` (the oracle),
:func:`paged_attention_fused_mq` (the CPU path),
:func:`paged_attention_cuda_mq` (``csrc/paged_attention_mq.cu``, which
reads each page once for all T rows) and
:func:`paged_attention_split_mq`.
"""

import math
from typing import Callable, Dict, Optional, Tuple

import torch

NEG_INF = -1e30

# compiled instances of the kernels: both take the group size (and K2 the
# verify rows) at run time; K1 keeps the group sizes of its contract
CUDA_HEAD_DIMS = (16, 32, 64, 128, 256)
CUDA_GROUPS = (1, 2, 4, 8)
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Split-KV: the kernels give each thread block a partition of at most this
# many context slots, and merge a sequence's partitions inside the launch.
PARTITION_SLOTS = 256
# mirror csrc/paged_attention_split.cuh: the partitions a launch may have,
# and the packed query rows one block holds (more are split over the grid)
MAX_PARTS = 256
MAX_ROWS = 8


def paged_attention_standin(q, k_pages, v_pages, page_tables, positions):
    """Gather every sequence's pages into ``[B, S, KV, D]``, repeat the
    KV heads out to ``H``, and softmax over the full padded width."""
    b, h, d = q.shape
    _, bs, kv, _ = k_pages.shape
    n_rep = h // kv
    s = page_tables.shape[1] * bs
    tables = page_tables.long()
    k_ctx = k_pages[tables].reshape(b, s, kv, d)
    v_ctx = v_pages[tables].reshape(b, s, kv, d)
    k_rep = k_ctx[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(b, s, h, d)
    v_rep = v_ctx[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(b, s, h, d)
    qh = q[:, None, :, :].transpose(1, 2)  # [B, H, 1, D]
    kh = k_rep.transpose(1, 2)  # [B, H, S, D]
    vh = v_rep.transpose(1, 2)
    # scores in fp32 (bf16 products are exact in fp32)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) / (d ** 0.5)
    slots = torch.arange(s, device=q.device)
    valid = slots[None, :] <= positions[:, None]  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vh.float())
    return out[:, :, 0, :].to(q.dtype)


def paged_attention_standin_mq(q, k_pages, v_pages, page_tables, positions):
    """Multi-query stand-in: gather + materialised head repeat + a
    ``[B, T, S]`` mask over the full padded width."""
    b, t, h, d = q.shape
    _, bs, kv, _ = k_pages.shape
    n_rep = h // kv
    s = page_tables.shape[1] * bs
    tables = page_tables.long()
    k_ctx = k_pages[tables].reshape(b, s, kv, d)
    v_ctx = v_pages[tables].reshape(b, s, kv, d)
    k_rep = k_ctx[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(b, s, h, d)
    v_rep = v_ctx[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(b, s, h, d)
    qh = q.transpose(1, 2)  # [B, H, T, D]
    kh = k_rep.transpose(1, 2)  # [B, H, S, D]
    vh = v_rep.transpose(1, 2)
    scores = torch.einsum("bhtd,bhkd->bhtk", qh.float(), kh.float()) / (d ** 0.5)
    # per-row validity: query row t sees slot s iff s <= positions[b, t]
    slots = torch.arange(s, device=q.device)
    valid = slots[None, None, :] <= positions[:, :, None]  # [B, T, S]
    scores = torch.where(valid[:, None, :, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhtk,bhkd->bhtd", weights, vh.float())
    return out.transpose(1, 2).to(q.dtype)


def paged_attention_fused(q, k_pages, v_pages, page_tables, positions):
    """Grouped-query einsums over the gathered pages: queries regrouped
    to ``[B, KV, g, D]`` contract against the un-repeated context, so the
    ``[B, S, H, D]`` repeat never exists, and ``S`` is whatever width the
    caller's page table has."""
    b, h, d = q.shape
    _, bs, kv, _ = k_pages.shape
    g = h // kv
    s = page_tables.shape[1] * bs
    tables = page_tables.long()
    k_ctx = k_pages[tables].reshape(b, s, kv, d).transpose(1, 2)  # [B, KV, S, D]
    v_ctx = v_pages[tables].reshape(b, s, kv, d).transpose(1, 2)
    qg = q.reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_ctx.float()) / (d ** 0.5)
    slots = torch.arange(s, device=q.device)
    valid = slots[None, :] <= positions[:, None]  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", weights, v_ctx.float())
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_fused_mq(q, k_pages, v_pages, page_tables, positions):
    """Multi-query grouped-query einsums: the T verify rows ride along
    both contractions, so one gather serves all of them."""
    b, t, h, d = q.shape
    _, bs, kv, _ = k_pages.shape
    g = h // kv
    s = page_tables.shape[1] * bs
    tables = page_tables.long()
    k_ctx = k_pages[tables].reshape(b, s, kv, d).transpose(1, 2)  # [B, KV, S, D]
    v_ctx = v_pages[tables].reshape(b, s, kv, d).transpose(1, 2)
    qg = q.reshape(b, t, kv, g, d)
    scores = torch.einsum("btkgd,bksd->bkgts", qg.float(), k_ctx.float()) / (d ** 0.5)
    slots = torch.arange(s, device=q.device)
    valid = slots[None, None, :] <= positions[:, :, None]  # [B, T, S]
    scores = torch.where(valid[:, None, None, :, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->btkgd", weights, v_ctx.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def paged_attention_split_mq(q, k_pages, v_pages, page_tables, positions,
                             partition: int):
    """The kernels' split-KV algorithm in plain PyTorch: the context is cut
    into partitions of ``partition`` slots, each gives a partial
    ``(m, l, acc)`` in fp32 (running max, denominator, unnormalised
    output), and the partials merge as ``sum_p acc_p e^(m_p - M) / sum_p
    l_p e^(m_p - M)``. A row that sees no slot of a partition has ``m_p =
    -inf`` and weighs exactly zero; a row that sees no slot at all gives
    zeros. Only the tests use it."""
    b, t, h, d = q.shape
    _, bs, kv, _ = k_pages.shape
    g = h // kv
    span = page_tables.shape[1] * bs
    tables = page_tables.long()
    k_ctx = k_pages[tables].reshape(b, span, kv, d).transpose(1, 2).float()  # [B, KV, S, D]
    v_ctx = v_pages[tables].reshape(b, span, kv, d).transpose(1, 2).float()
    qg = q.reshape(b, t, kv, g, d).float()
    limit = torch.clamp(positions.long() + 1, max=span)  # row t sees slots < limit[b, t]
    partials = []
    for lo in range(0, span, partition):
        hi = min(lo + partition, span)
        scores = torch.einsum("btkgd,bksd->bkgts", qg, k_ctx[:, :, lo:hi]) / (d ** 0.5)
        seen = torch.arange(lo, hi, device=q.device)[None, None, :] < limit[:, :, None]
        seen = seen[:, None, None]  # [B, 1, 1, T, S_p]
        m = torch.where(seen, scores, -math.inf).amax(dim=-1)  # -inf: nothing seen
        probs = torch.where(seen, torch.exp(scores - torch.where(
            torch.isinf(m), 0.0, m)[..., None]), 0.0)
        partials.append((m, probs.sum(dim=-1),
                         torch.einsum("bkgts,bksd->bkgtd", probs, v_ctx[:, :, lo:hi])))
    m_all = torch.stack([m for m, _, _ in partials])  # [P, B, KV, g, T]
    big = m_all.amax(dim=0)
    weights = torch.where(torch.isinf(m_all), 0.0,
                          torch.exp(m_all - torch.where(torch.isinf(big), 0.0, big)))
    num = sum(w[..., None] * acc for w, (_, _, acc) in zip(weights, partials))
    den = sum(w * l for w, (_, l, _) in zip(weights, partials))
    out = torch.where(den[..., None] > 0, num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def paged_attention_split(q, k_pages, v_pages, page_tables, positions, partition: int):
    """Single-query :func:`paged_attention_split_mq` (T = 1)."""
    return paged_attention_split_mq(q[:, None], k_pages, v_pages, page_tables,
                                    positions[:, None], partition)[:, 0]


def _check_cuda_args(q, k_pages, v_pages, page_tables, positions,
                     multi_query: bool = False) -> None:
    """Raise on anything the kernel (K2 when ``multi_query``) does not
    take."""
    q_rank, q_layout = (4, "[B, T, H, D]") if multi_query else (3, "[B, H, D]")
    if q.dim() != q_rank or k_pages.dim() != 4:
        raise ValueError(
            f"expected q {q_layout} and pages [N, bs, KV, D], got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}"
        )
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, _, kv, d_pages = k_pages.shape
    if v_pages.shape != k_pages.shape or d_pages != d:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)} "
            f"and q {tuple(q.shape)} disagree"
        )
    if page_tables.dim() != 2 or page_tables.shape[0] != b or page_tables.shape[1] < 1:
        raise ValueError(f"page_tables must be [{b}, NB>=1], got {tuple(page_tables.shape)}")
    if tuple(positions.shape) != tuple(q.shape[:-2]):
        raise ValueError(
            f"positions must be {list(q.shape[:-2])}, got {list(positions.shape)}"
        )
    if q.dtype not in _CUDA_DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"the kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}"
        )
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if d not in CUDA_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled (have {CUDA_HEAD_DIMS})")
    if h % kv or h // kv not in CUDA_GROUPS:
        raise ValueError(
            f"heads {h} / kv_heads {kv} must be a group size in {CUDA_GROUPS}"
        )
    tensors = (q, k_pages, v_pages, page_tables, positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all tensors must be on one CUDA device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and the page pools must be 16-byte aligned")


# per device: the split-KV workspace (fp32 partials) and the merge
# counters, which every launch leaves at zero. Both are reused across
# launches, with no allocation or memset per call: launches on one stream
# run in order, so one launch has merged before the next writes partials.
# The kernels assume that one stream (the serving engine's).
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def partition_slots(span: int) -> int:
    """The partition the kernels take for a table of ``span`` slots: the
    fewest partitions of at most :data:`PARTITION_SLOTS` slots (at most
    :data:`MAX_PARTS` of them), evened out and rounded up to the kernels'
    32-slot tiles: a 384-slot table splits into 2 x 192, not 256 + 128."""
    parts = min(-(-span // PARTITION_SLOTS), MAX_PARTS)
    if parts == 1:
        return PARTITION_SLOTS
    per_part = -(-span // parts)
    return (per_part + 31) // 32 * 32


def _split_args(q, k_pages, page_tables, rows: int, partition: Optional[int]) -> tuple:
    """The split-KV arguments of a launch: (partition, workspace pointer,
    its floats, counters pointer, their count). The workspace and the
    counters grow on the first launch that needs more; the table width
    alone sizes them, so nothing is read back from the card."""
    d = q.shape[-1]
    _, bs, kv, _ = k_pages.shape
    span = page_tables.shape[1] * bs
    partition = partition_slots(span) if partition is None else int(partition)
    parts = -(-span // partition) if partition > 0 else 0
    if not 1 <= parts <= MAX_PARTS:
        raise ValueError(
            f"partition {partition} splits {span} slots into {parts} "
            f"parts (the kernels take 1..{MAX_PARTS})")
    if parts == 1:
        return partition, 0, 0, 0, 0
    packed = rows * (q.shape[-2] // kv)
    units = q.shape[0] * kv * (-(-packed // MAX_ROWS))
    floats = units * parts * min(packed, MAX_ROWS) * (d + 2)
    workspace, counters = _scratch.get(q.device, (None, None))
    if workspace is None or workspace.numel() < floats:
        workspace = torch.empty(floats, dtype=torch.float32, device=q.device)
    if counters is None or counters.numel() < units:
        counters = torch.zeros(max(units, 1024), dtype=torch.int32, device=q.device)
    _scratch[q.device] = workspace, counters
    return (partition, workspace.data_ptr(), workspace.numel(),
            counters.data_ptr(), counters.numel())


def paged_attention_cuda(q, k_pages, v_pages, page_tables, positions,
                         partition: Optional[int] = None):
    """Launch the Hopper decode kernel (K1) on CUDA tensors (or raise).

    A CPU tensor takes the plain version, :func:`paged_attention_fused`;
    that is the only case that does not launch. ``partition`` (slots a
    block walks; :func:`partition_slots` of the table by default) is for
    tests. Each launch adds one to ``paged_attention_cuda.launches``."""
    if q.device.type == "cpu":
        return paged_attention_fused(q, k_pages, v_pages, page_tables, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda takes cuda or cpu tensors, not {q.device}")
    _check_cuda_args(q, k_pages, v_pages, page_tables, positions)
    from client_tpu_torch import kernels

    lib = kernels.load()
    b, h, d = q.shape
    n, bs, kv, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        split = _split_args(q, k_pages, page_tables, 1, partition)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rpa_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, h, kv, d, n, bs, page_tables.shape[1],
            _CUDA_DTYPES[q.dtype], 1.0 / (d ** 0.5), stream, *split,
        )
    if code != 0:
        raise RuntimeError(
            f"paged-attention kernel launch failed: "
            f"{lib.rpa_error_string(code).decode()} (cudaError {code})"
        )
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention_cuda_mq(q, k_pages, v_pages, page_tables, positions,
                            partition: Optional[int] = None):
    """Launch the Hopper verify kernel (K2) on CUDA tensors (or raise).

    A CPU tensor takes the plain version, :func:`paged_attention_fused_mq`;
    that is the only case that does not launch. ``partition`` as for
    :func:`paged_attention_cuda`. Each launch adds one to
    ``paged_attention_cuda_mq.launches``."""
    if q.device.type == "cpu":
        return paged_attention_fused_mq(q, k_pages, v_pages, page_tables, positions)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attention_cuda_mq takes cuda or cpu tensors, not {q.device}"
        )
    _check_cuda_args(q, k_pages, v_pages, page_tables, positions, multi_query=True)
    from client_tpu_torch import kernels

    lib = kernels.load("paged_attention_mq.cu")
    b, t, h, d = q.shape
    n, bs, kv, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        split = _split_args(q, k_pages, page_tables, t, partition)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rpa_decode_mq(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, t, h, kv, d, n, bs, page_tables.shape[1],
            _CUDA_DTYPES[q.dtype], 1.0 / (d ** 0.5), stream, *split,
        )
    if code != 0:
        raise RuntimeError(
            f"multi-query paged-attention kernel launch failed: "
            f"{lib.rpa_mq_error_string(code).decode()} (cudaError {code})"
        )
    paged_attention_cuda_mq.launches += 1
    return out


paged_attention_cuda_mq.launches = 0

_IMPLS = {
    "cuda": paged_attention_cuda,
    "fused": paged_attention_fused,
    "standin": paged_attention_standin,
}

# every name has a multi-query twin, so the speculative verify rides the
# implementation chosen for plain decode
_IMPLS_MQ = {
    "cuda": paged_attention_cuda_mq,
    "fused": paged_attention_fused_mq,
    "standin": paged_attention_standin_mq,
}


def get_attention_impl(name: str) -> Callable:
    try:
        return _IMPLS[name]
    except KeyError:
        raise ValueError(
            f"unknown paged-attention kernel '{name}' "
            f"(choose from {', '.join(_IMPLS)})"
        ) from None


def get_attention_impl_mq(name: str) -> Callable:
    """The multi-query (speculative verify) twin of ``name``."""
    try:
        return _IMPLS_MQ[name]
    except KeyError:
        raise ValueError(
            f"unknown paged-attention kernel '{name}' "
            f"(choose from {', '.join(_IMPLS_MQ)})"
        ) from None


def make_tp_attention(attn: Callable, plan, multi_query: bool = False) -> Callable:
    """Wrap an attention implementation so it runs per shard under
    ``plan``'s ``tp`` axis.

    Tensor-parallel paged decode shards both q (on the query-head axis)
    and the K/V pools (on the kv-head axis). Every implementation's math
    is self-contained per kv-head group, and an even head split keeps
    the group size ``H/KV``, so the per-shard call needs no collective:
    shard ``i`` computes the output of its own heads against its own
    pool, and the output stays head-sharded for the row-sharded ``wo``.

    The wrapper takes ``q`` as the whole ``[B, (T,) H, D]`` query, of
    which shard ``i`` takes the head slice ``q[..., i*H/tp:(i+1)*H/tp,
    :]``, or as the list of those blocks; ``k_pages``/``v_pages`` as the
    list of per-shard pools ``[N, bs, KV/tp, D]``, each its own
    contiguous tensor; ``page_tables`` and ``positions`` replicated. It
    returns the per-shard outputs. Each shard's block is made contiguous
    and the shards run in turn on their devices' current streams: shards
    on one card share its kernel workspace (``_scratch``), which is safe
    only while their launches run in order on one stream."""
    devices = [plan.devices[i] for i in plan.groups("tp")[0]]
    rank = 4 if multi_query else 3

    def tp_attention(q, k_pages, v_pages, page_tables, positions):
        if torch.is_tensor(q):
            heads = q.shape[-2] // len(devices)
            q = [q[..., i * heads:(i + 1) * heads, :] for i in range(len(devices))]
        if len(q) != len(devices) or any(block.dim() != rank for block in q):
            raise ValueError(
                f"expected {len(devices)} query blocks of rank {rank}, got "
                f"{[tuple(block.shape) for block in q]}"
            )
        return [
            attn(block.to(device).contiguous(), k, v, page_tables.to(device),
                 positions.to(device))
            for block, k, v, device in zip(q, k_pages, v_pages, devices)
        ]

    return tp_attention


def resolve_decode_attention(device: torch.device) -> Tuple[str, Callable]:
    """The decode attention for ``device``: the CUDA kernel on a card,
    the fused plain version on the CPU."""
    if torch.device(device).type == "cuda":
        return "cuda", paged_attention_cuda
    return "fused", paged_attention_fused


def resolve_verify_attention(device: torch.device) -> Tuple[str, Callable]:
    """The verify step's attention for ``device``: the multi-query twin of
    what :func:`resolve_decode_attention` picks (K2 on a card)."""
    name, _ = resolve_decode_attention(device)
    return name, get_attention_impl_mq(name)

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
  (``csrc/paged_attention.cu``), which walks each sequence's pages up to
  its position with an fp32 online softmax and never gathers.

Speculative decoding's verify step asks for logits at T positions per
sequence in one call, so each implementation has a multi-query twin::

    attn_mq(q[B, T, H, D], k_pages, v_pages, page_tables[B, NB],
            positions[B, T]) -> out[B, T, H, D]

where slot ``s`` is valid for row ``t`` iff ``s <= positions[b, t]``: row
``t`` sees exactly its own speculative prefix (rows ``0..t`` were written
before the read), so the T rows equal T sequential decode steps. Padding
rows give finite output the caller discards. The twins are
:func:`paged_attention_standin_mq` (the oracle),
:func:`paged_attention_fused_mq` (the CPU path) and
:func:`paged_attention_cuda_mq` (``csrc/paged_attention_mq.cu``, which
reads each page once for all T rows).
"""

from typing import Callable, Tuple

import torch

NEG_INF = -1e30

# compiled instances of the kernels (csrc/paged_attention.cu; K2 in
# csrc/paged_attention_mq.cu compiles the same head dims and takes the
# group size at run time)
CUDA_HEAD_DIMS = (16, 32, 64, 128, 256)
CUDA_GROUPS = (1, 2, 4, 8)
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def paged_attention_cuda(q, k_pages, v_pages, page_tables, positions):
    """Launch the Hopper decode kernel on CUDA tensors (or raise).

    A CPU tensor takes the plain version, :func:`paged_attention_fused`;
    that is the only case that does not launch. Each launch adds one to
    ``paged_attention_cuda.launches``."""
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
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rpa_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, h, kv, d, n, bs, page_tables.shape[1],
            _CUDA_DTYPES[q.dtype], 1.0 / (d ** 0.5), stream,
        )
    if code != 0:
        raise RuntimeError(
            f"paged-attention kernel launch failed: "
            f"{lib.rpa_error_string(code).decode()} (cudaError {code})"
        )
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention_cuda_mq(q, k_pages, v_pages, page_tables, positions):
    """Launch the Hopper verify kernel (K2) on CUDA tensors (or raise).

    A CPU tensor takes the plain version, :func:`paged_attention_fused_mq`;
    that is the only case that does not launch. Each launch adds one to
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
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rpa_decode_mq(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, t, h, kv, d, n, bs, page_tables.shape[1],
            _CUDA_DTYPES[q.dtype], 1.0 / (d ** 0.5), stream,
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

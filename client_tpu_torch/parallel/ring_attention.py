"""Ring attention: exact attention over a sequence-parallel axis of shards.

Long-context prefill for the serving runtime: Q/K/V are split along the
sequence over the ``sp`` shards of a mesh, each shard holding its
``[B, H, L/sp, D]`` block. Each shard runs an online softmax in fp32
against the K/V block it currently holds, then the K/V blocks rotate one
hop around the ring (:func:`~client_tpu_torch.parallel.collectives.ppermute`)
until every query block has seen every key block (blockwise ring
attention, Liu et al., 2023). The reference expresses the same loop with
``shard_map``, ``lax.scan`` and XLA's ``ppermute``
(``client_tpu/parallel/ring_attention.py``); it reaches no Pallas
kernel, and neither does this port: the block products are PyTorch
matrix products.

The shards run in turn on their devices' current streams.
"""

from typing import List, Optional, Sequence, Union

import torch

from client_tpu_torch.parallel.collectives import ppermute

NEG_INF = -1e30


def _local_ring_attention(qs, ks, vs, *, causal: bool, scale: float) -> List[torch.Tensor]:
    """The reference's per-shard body over every shard: ``qs``/``ks``/``vs``
    are the sp blocks ``[B, H, L_blk, D]``, each on its shard's device."""
    sp = len(qs)
    devices = [q.device for q in qs]
    batch, heads, q_len, head_dim = qs[0].shape
    k_len = ks[0].shape[2]
    o = [torch.zeros((batch, heads, q_len, head_dim), dtype=torch.float32, device=d)
         for d in devices]
    m = [torch.full((batch, heads, q_len), NEG_INF, dtype=torch.float32, device=d)
         for d in devices]
    l = [torch.zeros((batch, heads, q_len), dtype=torch.float32, device=d)
         for d in devices]
    k_cur, v_cur = list(ks), list(vs)
    for step in range(sp):
        for i in range(sp):
            # blocks rotate forwards around the ring, so after ``step``
            # hops shard i holds the block that started on (i - step) % sp
            src_block = (i - step) % sp
            scores = torch.einsum(
                "bhqd,bhkd->bhqk", qs[i].float(), k_cur[i].float()) * scale
            if causal:
                q_pos = i * q_len + torch.arange(q_len, device=devices[i])
                k_pos = src_block * k_len + torch.arange(k_len, device=devices[i])
                mask = q_pos[:, None] >= k_pos[None, :]
                scores = torch.where(mask[None, None], scores, NEG_INF)
            m_new = torch.maximum(m[i], scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            correction = torch.exp(m[i] - m_new)
            l[i] = l[i] * correction + p.sum(dim=-1)
            o[i] = o[i] * correction[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v_cur[i].float())
            m[i] = m_new
        if step + 1 < sp:
            k_cur = ppermute(k_cur, devices, 1)
            v_cur = ppermute(v_cur, devices, 1)
    # fully-masked rows cannot occur in causal self-attention; guard the
    # division as the reference does
    return [(o_i / torch.where(l_i == 0.0, 1.0, l_i)[..., None]).to(q.dtype)
            for o_i, l_i, q in zip(o, l, qs)]


def ring_attention(
    q: Union[torch.Tensor, Sequence[torch.Tensor]],
    k: Union[torch.Tensor, Sequence[torch.Tensor]],
    v: Union[torch.Tensor, Sequence[torch.Tensor]],
    plan,
    causal: bool = True,
    scale: Optional[float] = None,
    sp_axis: str = "sp",
):
    """Exact multi-head attention with sequence-parallel ring
    communication over ``plan``'s ``sp_axis``.

    ``q``, ``k``, ``v`` are either the sp blocks ``[B, H, L/sp, D]`` (a
    list, block j on the j-th device along the axis), and the result is
    the list of output blocks on the same devices; or whole ``[B, H, L,
    D]`` tensors, which are split over those devices, and the result is
    one ``[B, H, L, D]`` tensor on ``q``'s device. ``causal`` masks on
    *global* sequence positions."""
    sp = plan.axis_size(sp_axis)
    devices = [plan.devices[i] for i in plan.groups(sp_axis)[0]]
    whole = torch.is_tensor(q)
    if whole:
        home = q.device
        q, k, v = ([b.to(d) for b, d in zip(t.chunk(sp, dim=2), devices)]
                   for t in (q, k, v))
    if not len(q) == len(k) == len(v) == sp:
        raise ValueError(f"ring attention over sp={sp} got {len(q)}, {len(k)}, "
                         f"{len(v)} blocks")
    if scale is None:
        scale = 1.0 / (q[0].shape[-1] ** 0.5)
    out = _local_ring_attention(q, k, v, causal=causal, scale=scale)
    if whole:
        return torch.cat([o.to(home) for o in out], dim=2)
    return out


def reference_attention(q, k, v, causal: bool = True, scale=None):
    """Single-device exact attention over ``[B, H, L, D]``, for testing
    :func:`ring_attention`."""
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

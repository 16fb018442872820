"""Plain PyTorch forward of a grouped-query decoder (Mistral-7B's block).

Follows Mistral-7B's published layer: RMSNorm before attention and
before the MLP, rotary position embedding over interleaved pairs of each
head (the form of Mistral's own reference code), grouped-query attention
(each key/value head serves ``heads / kv_heads`` query heads), causal
softmax, a SwiGLU MLP, a final RMSNorm and an untied output head.
Departures: no sliding window (v0.3 has none), no biases (it has none).

The weights are the benchmark's own (``harness/weights.py``), in these
layouts: ``embed [V, d]``, ``lm_head [d, V]``, per layer ``wq [d, h,
hd]``, ``wk``/``wv [d, kv, hd]``, ``wo [h, hd, d]``, ``w_gate``/``w_up
[d, f]``, ``w_down [f, d]``, ``attn_norm``/``mlp_norm [d]``, and
``final_norm [d]``. Everything is computed in float32, one layer's
weights upcast at a time. Nothing here imports the program.
"""

import math
from typing import Callable, Dict, List, Sequence

import torch

from reference import linear as linear_mod


def _rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def _rope(x, positions, theta):
    """Rotate interleaved pairs of ``x [L, H, D]`` by ``positions [L]``."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    angles = positions[:, None].float() * freqs  # [L, D/2]
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).reshape(x.shape)


def _attention(q, k, v):
    """Causal attention of ``q [L, H, D]`` over ``k``/``v [L, KV, D]``."""
    length, heads, d = q.shape
    group = heads // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    causal = torch.ones(length, length, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)


@torch.no_grad()
def logits(weights: Dict, sizes: Dict, sequences: Sequence[Sequence[int]],
           rows: Sequence[Sequence[int]],
           linear: Callable = linear_mod.exact) -> List[torch.Tensor]:
    """Float32 logits ``[len(rows[i]), V]`` of each sequence at the
    positions ``rows[i]`` (the logits at position p predict token p + 1).
    ``linear(x, w)`` computes every linear layer (the control passes a
    lower precision)."""
    device = weights["embed"].device
    eps, theta = float(sizes["rms_norm_eps"]), float(sizes["rope_theta"])
    hs = [weights["embed"][torch.as_tensor(list(s), device=device)].float()
          for s in sequences]
    for layer in weights["layers"]:
        w = {name: t.float() for name, t in layer.items()}
        d = w["wq"].shape[0]
        wq, wk, wv = (w[n].reshape(d, -1) for n in ("wq", "wk", "wv"))
        wo = w["wo"].reshape(-1, d)
        for i, x in enumerate(hs):
            positions = torch.arange(x.shape[0], device=device)
            normed = _rms_norm(x, w["attn_norm"], eps)
            q = _rope(linear(normed, wq).unflatten(-1, w["wq"].shape[1:]), positions, theta)
            k = _rope(linear(normed, wk).unflatten(-1, w["wk"].shape[1:]), positions, theta)
            v = linear(normed, wv).unflatten(-1, w["wv"].shape[1:])
            x = x + linear(_attention(q, k, v).flatten(-2), wo)
            normed = _rms_norm(x, w["mlp_norm"], eps)
            gated = torch.nn.functional.silu(linear(normed, w["w_gate"])) * linear(normed, w["w_up"])
            hs[i] = x + linear(gated, w["w_down"])
        del w, wq, wk, wv, wo
    final_norm, head = weights["final_norm"].float(), weights["lm_head"].float()
    out = []
    for x, wanted in zip(hs, rows):
        picked = x[torch.as_tensor(list(wanted), device=device)]
        out.append(linear(_rms_norm(picked, final_norm, eps), head))
    return out

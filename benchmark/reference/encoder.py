"""Plain PyTorch forward of the BERT-large encoder as the port serves it.

BERT-large's widths (24 layers, hidden 1024, 16 heads, FFN 4096, 512
positions, LayerNorm eps 1e-12) in the block the served encoder uses,
whose departures from the published BERT are listed under ``assumed`` in
``configs/bert_large.json``: LayerNorm before attention and before the
FFN (pre-LN, where BERT normalises after the residual add), no biases,
no token-type embedding, a LayerNorm of the embeddings with scale and no
bias, GELU in its tanh form, and the answer is the mean of the last
hidden states over the request's tokens (no pooler).

One request at a time at its own length: no padding and no batch, in
float32. The weights are the benchmark's own (``harness/weights.py``):
``tok_emb [V, d]``, ``pos_emb [P, d]``, ``emb_ln_scale [d]``, per layer
``wq``/``wk``/``wv``/``wo [d, d]``, ``w1 [d, f]``, ``w2 [f, d]``,
``ln1_scale``/``ln2_scale [d]``. Nothing here imports the program.
"""

import math
from typing import Callable, Dict, List, Sequence

import torch

from reference import linear as linear_mod


def _layer_norm(x, scale, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale


@torch.no_grad()
def embeddings(weights: Dict, sizes: Dict, requests: Sequence[Sequence[int]],
               linear: Callable = linear_mod.exact) -> List[torch.Tensor]:
    """The float32 answer ``[d]`` of each request (its token ids)."""
    device = weights["tok_emb"].device
    eps = float(sizes["layer_norm_eps"])
    heads = int(sizes["num_attention_heads"])
    w = {name: t.float() for name, t in weights.items() if name != "layers"}
    hs = []
    for ids in requests:
        ids = torch.as_tensor(list(ids), device=device)
        x = w["tok_emb"][ids] + w["pos_emb"][: ids.shape[0]]
        hs.append(_layer_norm(x, w["emb_ln_scale"], eps))
    for layer in weights["layers"]:
        lw = {name: t.float() for name, t in layer.items()}
        for i, x in enumerate(hs):
            length, d = x.shape
            normed = _layer_norm(x, lw["ln1_scale"], eps)
            q, k, v = (linear(normed, lw[n]).reshape(length, heads, -1)
                       for n in ("wq", "wk", "wv"))
            scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d // heads)
            ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
            x = x + linear(ctx.reshape(length, d), lw["wo"])
            hidden = torch.nn.functional.gelu(
                linear(_layer_norm(x, lw["ln2_scale"], eps), lw["w1"]), approximate="tanh")
            hs[i] = x + linear(hidden, lw["w2"])
    return [x.mean(0) for x in hs]

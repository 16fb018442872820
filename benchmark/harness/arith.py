"""The yardstick's arithmetic: percentiles, the card's peaks, the model
FLOPs behind each ``mfu.*`` metric and the bytes behind each kernel's
roofline. Pure functions of sizes, so the tests check them by hand.
"""

import math
from typing import Dict, Sequence

# NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of every value."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def decoder_flops(sizes: Dict, position: int, with_head: bool) -> float:
    """Model FLOPs of one token of a grouped-query decoder at
    ``position`` (0-based): two for each weight of every layer's
    products, attention's q.k and p.v over the ``position + 1`` visible
    keys of every head, and the output head where the token's logits
    are needed."""
    d = sizes["hidden_size"]
    heads, kv = sizes["num_attention_heads"], sizes["num_key_value_heads"]
    hd = sizes["head_dim"]
    f, layers = sizes["intermediate_size"], sizes["num_hidden_layers"]
    per_layer = 2 * (d * heads * hd * 2 + d * kv * hd * 2 + 3 * d * f)
    attention = 4 * (position + 1) * heads * hd
    head = 2 * d * sizes["vocab_size"] if with_head else 0
    return layers * (per_layer + attention) + head


def decoder_prompt_flops(sizes: Dict, length: int) -> float:
    """A prompt's prefill: every position through the layers, the head
    on the last only."""
    d = sizes["hidden_size"]
    heads, kv = sizes["num_attention_heads"], sizes["num_key_value_heads"]
    hd = sizes["head_dim"]
    f, layers = sizes["intermediate_size"], sizes["num_hidden_layers"]
    per_token = 2 * (d * heads * hd * 2 + d * kv * hd * 2 + 3 * d * f)
    attention = 4 * heads * hd * length * (length + 1) / 2
    return layers * (length * per_token + attention) + 2 * d * sizes["vocab_size"]


def encoder_flops(sizes: Dict, length: int) -> float:
    """Model FLOPs of one encoder request of ``length`` tokens, unpadded:
    the four attention products and the FFN's two at every token, and
    q.k and p.v over all ``length`` keys."""
    d, f = sizes["hidden_size"], sizes["intermediate_size"]
    layers = sizes["num_hidden_layers"]
    return layers * (length * 2 * (4 * d * d + 2 * d * f) + 4 * length * length * d)


def k1_bytes(contexts: Sequence[int], heads: int, kv_heads: int, head_dim: int,
             table_width: int, element_size: int = 2) -> float:
    """The least one decode-attention launch moves: every visible key and
    value row read once (``contexts`` holds each lane's visible slots,
    padding lanes included), the queries read and the outputs written,
    the page tables and positions read."""
    lanes = len(contexts)
    row = kv_heads * head_dim * element_size
    return (2 * sum(contexts) * row + 2 * lanes * heads * head_dim * element_size
            + lanes * table_width * 4 + lanes * 4)


def k1_flops(contexts: Sequence[int], heads: int, head_dim: int) -> float:
    """q.k and p.v of every query head over its lane's visible slots."""
    return 4 * sum(contexts) * heads * head_dim

"""Random weights from the seed, made on the card in a few large calls.

Each family's weights are drawn as a handful of stacked tensors (all
layers' query projections in one ``randn``, and so on) in the dtype they
are served in, from one ``torch.Generator`` on the device; each layer's
tensor is a slice of its stack. Scales follow the port's own
initialisation, so activations and logits keep the ranges its tests
know. Both the program and the reference are handed these tensors.
"""

from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _draw(generator, device, dtype):
    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return t.mul_(scale)
    return normal


def decoder(sizes: Dict, seed: int, device) -> Dict[str, Any]:
    """A grouped-query decoder's weights (``reference/decoder.py``'s
    layouts)."""
    dtype = DTYPES[sizes["torch_dtype"]]
    generator = torch.Generator(device=device).manual_seed(int(seed))
    normal = _draw(generator, device, dtype)
    n, d = sizes["num_hidden_layers"], sizes["hidden_size"]
    h, kv, hd = sizes["num_attention_heads"], sizes["num_key_value_heads"], sizes["head_dim"]
    f, vocab = sizes["intermediate_size"], sizes["vocab_size"]
    scale = d ** -0.5
    stacks = {
        "wq": normal((n, d, h, hd), scale),
        "wk": normal((n, d, kv, hd), scale),
        "wv": normal((n, d, kv, hd), scale),
        "wo": normal((n, h, hd, d), scale / (2 * n) ** 0.5),
        "w_gate": normal((n, d, f), scale),
        "w_up": normal((n, d, f), scale),
        "w_down": normal((n, f, d), f ** -0.5),
        "attn_norm": torch.ones((n, d), device=device, dtype=dtype),
        "mlp_norm": torch.ones((n, d), device=device, dtype=dtype),
    }
    return {
        "embed": normal((vocab, d), 1.0),
        "final_norm": torch.ones(d, device=device, dtype=dtype),
        "lm_head": normal((d, vocab), scale),
        "layers": [{name: stack[i] for name, stack in stacks.items()} for i in range(n)],
    }


def encoder(sizes: Dict, seed: int, device) -> Dict[str, Any]:
    """A BERT-family encoder's weights (``reference/encoder.py``'s
    layouts); the norms' scales are float32, as the port keeps them."""
    dtype = DTYPES[sizes["torch_dtype"]]
    generator = torch.Generator(device=device).manual_seed(int(seed))
    normal = _draw(generator, device, dtype)
    n, d = sizes["num_hidden_layers"], sizes["hidden_size"]
    f = sizes["intermediate_size"]
    attention = normal((4, n, d, d), d ** -0.5)
    w1, w2 = normal((n, d, f), d ** -0.5), normal((n, f, d), f ** -0.5)
    norms = torch.ones((2, n, d), device=device, dtype=torch.float32)
    return {
        "tok_emb": normal((sizes["vocab_size"], d), 0.02),
        "pos_emb": normal((sizes["max_position_embeddings"], d), 0.02),
        "emb_ln_scale": torch.ones(d, device=device, dtype=torch.float32),
        "emb_ln_bias": torch.zeros(d, device=device, dtype=torch.float32),
        "layers": [
            {"wq": attention[0, i], "wk": attention[1, i], "wv": attention[2, i],
             "wo": attention[3, i], "w1": w1[i], "w2": w2[i],
             "ln1_scale": norms[0, i], "ln2_scale": norms[1, i]}
            for i in range(n)
        ],
    }

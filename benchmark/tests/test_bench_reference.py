"""The plain references against the port's own forwards at tiny sizes
(float32 on the CPU), and the control's arithmetic."""

import torch

from harness import weights
from reference import decoder, encoder, linear, tokenizer

DECODER = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 96,
           "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 2,
           "head_dim": 8, "rope_theta": 1e6, "rms_norm_eps": 1e-5, "torch_dtype": "float32"}
ENCODER = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 96,
           "num_hidden_layers": 2, "num_attention_heads": 4, "max_position_embeddings": 64,
           "layer_norm_eps": 1e-12, "torch_dtype": "float32"}


def test_the_decoder_reference_matches_the_ports_forward():
    from client_tpu_torch.models import llama

    w = weights.decoder(DECODER, 5, "cpu")
    config = llama.LlamaConfig(vocab_size=300, d_model=64, n_layers=2, n_heads=8,
                               n_kv_heads=2, d_ff=96, max_seq_len=64, rope_theta=1e6,
                               dtype=torch.float32)
    tokens = torch.randint(0, 300, (1, 23), generator=torch.Generator().manual_seed(1))
    port = llama.forward(w, tokens, config)[0]
    (ref,) = decoder.logits(w, DECODER, [tokens[0].tolist()], [range(23)])
    assert torch.allclose(ref, port, atol=1e-4, rtol=1e-4)


def test_the_encoder_reference_matches_the_ports_forward():
    from client_tpu_torch.models import bert

    w = weights.encoder(ENCODER, 6, "cpu")
    config = bert.BertConfig(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=96,
                             max_seq_len=64, dtype=torch.float32)
    ids = torch.randint(1, 300, (1, 19), generator=torch.Generator().manual_seed(2))
    _, pooled = bert.forward(w, ids, config)
    (ref,) = encoder.embeddings(w, ENCODER, [ids[0].tolist()])
    assert torch.allclose(ref, pooled[0], atol=1e-5, rtol=1e-4)


def test_fp8_rounds_each_input_of_a_product():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(3))
    w = torch.randn(32, 8, generator=torch.Generator().manual_seed(4))
    exact, low = linear.exact(x, w), linear.fp8(x, w)
    error = ((low - exact).abs().max() / exact.abs().max()).item()
    assert 1e-3 < error < 0.2


def test_the_tokenizer_copy_agrees_with_the_route():
    from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer

    text = "w1a2b w77 hello tok3 x"
    assert tokenizer.encode(text, 32768) == SyntheticTokenizer(32768).encode(text)
    assert tokenizer.decode_ids(SyntheticTokenizer(32768).decode([5, 6])) == [5, 6]

"""The yardstick's arithmetic against hand-worked values."""

import pytest

from harness import arith

MISTRAL = {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
           "head_dim": 128, "intermediate_size": 14336, "num_hidden_layers": 32,
           "vocab_size": 32768}
BERT = {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24}


def test_percentile_is_nearest_rank_over_every_value():
    values = list(range(1, 101))
    assert arith.percentile(values, 95) == 95
    assert arith.percentile(values, 50) == 50
    assert arith.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert arith.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        arith.percentile([], 95)


def test_decoder_flops_by_hand():
    # per layer: 2 * (4096*4096*2 + 4096*1024*2 + 3*4096*14336) = 436,207,616
    per_layer = 2 * (33554432 + 8388608 + 176160768)
    assert per_layer == 436207616
    # a token at position 99 sees 100 keys: 4 * 100 * 32 * 128 = 1,638,400 a layer
    expected = 32 * (per_layer + 1638400) + 2 * 4096 * 32768
    assert arith.decoder_flops(MISTRAL, 99, with_head=True) == expected
    assert arith.decoder_flops(MISTRAL, 99, with_head=False) == expected - 2 * 4096 * 32768


def test_a_prompt_is_its_positions_with_one_head():
    length = 7
    by_token = sum(arith.decoder_flops(MISTRAL, p, with_head=False) for p in range(length))
    assert arith.decoder_prompt_flops(MISTRAL, length) == pytest.approx(
        by_token + 2 * 4096 * 32768)


def test_encoder_flops_by_hand():
    # 24 * (128 * 2 * (4*1024^2 + 2*1024*4096) + 4 * 128^2 * 1024)
    assert arith.encoder_flops(BERT, 128) == 24 * (128 * 2 * 12582912 + 67108864)


def test_k1_bytes_by_hand():
    # two lanes seeing 10 and 1 slots; 8 KV heads of 128 in bf16: 2048 bytes a row
    # K and V: 2 * 11 * 2048; q and out: 2 * 2 * 32 * 128 * 2; tables 2 * 3 * 4; positions 8
    assert arith.k1_bytes([10, 1], 32, 8, 128, 3) == 45056 + 32768 + 24 + 8
    assert arith.k1_flops([10, 1], 32, 128) == 4 * 11 * 32 * 128

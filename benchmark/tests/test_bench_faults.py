"""A whole run with the timed path broken underneath it reads
``correct`` false: once for each fault a cell can have. (Both cells run
on one card, so no exchange between cards can be left out.)"""

import numpy as np
import pytest

import bench_tiny


def _token_altered(monkeypatch):
    from client_tpu_torch.llm import engine

    sample = engine.LlmEngine._sample_rows
    calls = {"n": 0}

    def altered(self, items):
        picks = sample(self, items)
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            picks[0] = (picks[0] + 1) % len(items[0][1])
        return picks

    monkeypatch.setattr(engine.LlmEngine, "_sample_rows", altered)


def _state_unchanged(monkeypatch):
    from client_tpu_torch.models import llama

    def no_writes(shards, shard_pages, writes, page_tables, positions, attn, rows):
        def attend(index, qkv):
            pools = [layer_pages[index] for layer_pages in shard_pages]
            queries = [rows(q) for q, _, _ in qkv]
            return [attn(queries[0].contiguous(), pools[0][0], pools[0][1], page_tables,
                         positions)]
        return attend

    monkeypatch.setattr(llama, "_paged_attend", no_writes)


def _half_batch_decode(monkeypatch):
    from client_tpu_torch.llm.serving import LlmEngineModel

    build = LlmEngineModel._build_device_fns

    def half(self, *args):
        prefill, decode, decode_multi = build(self, *args)

        def decode_half(tokens, positions, page_tables, pages):
            logits, pages = decode(tokens, positions, page_tables, pages)
            half = logits.shape[0] // 2
            if half:
                logits = logits.copy()
                logits[half:] = logits[:half].mean(0)
            return logits, pages

        return prefill, decode_half, decode_multi

    monkeypatch.setattr(LlmEngineModel, "_build_device_fns", half)


def _half_batch_encode(monkeypatch):
    from client_tpu_torch.models.serving import TextEncoderModel

    encode = TextEncoderModel._encode

    def half(self, ids, rows):
        out = np.array(encode(self, ids, rows))
        if rows > 1:
            out[rows // 2:rows] = out[:rows // 2].mean(0)
        return out

    monkeypatch.setattr(TextEncoderModel, "_encode", half)


def _answer_altered(monkeypatch):
    from client_tpu_torch.models.serving import TextEncoderModel

    encode = TextEncoderModel._encode

    def altered(self, ids, rows):
        out = np.array(encode(self, ids, rows))
        out[0, 0] += 0.1 * np.abs(out[0]).max()
        return out

    monkeypatch.setattr(TextEncoderModel, "_encode", altered)


FAULTS = {
    ("mistral7b.chat", "token altered"): _token_altered,
    ("mistral7b.chat", "state unchanged"): _state_unchanged,
    ("mistral7b.chat", "half the batch left out"): _half_batch_decode,
    ("bert_large.ragged", "half the batch left out"): _half_batch_encode,
    ("bert_large.ragged", "answer altered"): _answer_altered,
}


@pytest.mark.parametrize("cell,fault", list(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[(cell, fault)](monkeypatch)
    _, line = bench_tiny.run(cell)
    assert not line["correct"], line["checks"]


def test_the_sound_path_is_correct():
    for cell in ("mistral7b.chat", "bert_large.ragged"):
        _, line = bench_tiny.run(cell)
        assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["mistral7b.chat", "bert_large.ragged"])
def test_the_control_is_not_correct(cell):
    """The control, the reference in fp8 in the program's place, judged
    by the cell's own comparison and limits, reads ``correct`` false."""
    from control import readings

    sides = readings.readings(bench_tiny.cell(cell), bench_tiny.SEED, 3.0, device="cpu")
    assert sides["program"]["correct"], sides
    assert not sides["control"]["correct"], sides

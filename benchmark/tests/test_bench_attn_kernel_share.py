"""The reader of the attention kernel's launches (``kernel_launches`` of
the statistics document) on runs made by hand: it reads the window's
launches over its executions times the model's layers, and finds nothing
where the count, the window's closing or an execution is missing."""

import json
from types import SimpleNamespace

import pytest

from harness import main


def _document(executions, launches=None):
    doc = {"inference_count": executions, "execution_count": executions}
    if launches is not None:
        doc["kernel_launches"] = {"encoder_attention": launches}
    return doc


def _run(opened, closed, system="text_encoder"):
    counters = {"open": opened}
    if closed is not None:
        counters["close"] = closed
    return SimpleNamespace(system=system, counters=counters, sizes={"num_hidden_layers": 24})


@pytest.mark.parametrize("launched,want", [(24, 100.0), (12, 50.0)])
def test_the_attention_kernel_share_reads_launches_over_executions_and_layers(launched, want):
    read = main.reader("attn_kernel_share.bert").read
    # 10 executions of a 24-layer model in the window
    run = _run(_document(5, 1000), _document(15, 1000 + 10 * launched))
    assert read(run) == pytest.approx(want)


@pytest.mark.parametrize("run", [
    _run(_document(5), _document(15)),  # a program without the count
    _run(_document(5, 0), None),  # the window never closed
    _run(_document(5, 0), _document(5, 0)),  # no execution in the window
    _run(_document(5, 0), _document(15, 240), system="llm_engine"),
], ids=["no_count", "not_closed", "no_execution", "other_system"])
def test_the_attention_kernel_share_finds_nothing_without_the_count(run):
    assert main.reader("attn_kernel_share.bert").read(run) is None


def test_the_attention_kernel_share_has_its_entry():
    doc = json.loads((main.BENCH.parent / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in doc["per_layer"]}["attn_kernel_share.bert"]
    assert entry["workloads"] == ["bert_large.ragged"]
    assert (entry["unit"], entry["better"], entry["moves"], entry["source"], entry["layer"]) == (
        "%", "higher", "infer_per_s", "program_counter",
        "BERT model (models/serving.py, models/bert.py)")

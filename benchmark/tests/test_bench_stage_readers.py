"""The readers of the program's stage ledger (``stage_stats`` of the
statistics document) on runs made by hand: each reads the window's
difference of its stages' ns over its bookings, and finds nothing where
the ledger, the stage or the window's closing is missing."""

import json
from types import SimpleNamespace

import pytest

from harness import main

# reader -> (its stages, the stage whose bookings it divides by)
READERS = {
    "assembly_ms.bert": ("batch_assembly",),
    "handoff_ms.bert": ("handoff",),
    "package_ms.bert": ("package",),
    "put_ms.bert": ("device_put",),
    "issue_ms.bert": ("compute",),
    "readback_ms.bert": ("readback",),
    "device_ms.bert": ("device",),
    "device_gap_ms.bert": ("device_gap",),
    "frontend_ms.bert": ("frontend_decode", "encode"),
}
STAGES = [s for stages in READERS.values() for s in stages]


def _document(count, ns, stages=STAGES):
    return {"inference_count": count, "execution_count": count,
            "inference_stats": {"success": {"count": count, "ns": ns}},
            "stage_stats": {s: {"count": count, "ns": ns * (i + 1)}
                            for i, s in enumerate(stages)}}


def _run(opened, closed, system="text_encoder"):
    counters = {"open": opened}
    if closed is not None:
        counters["close"] = closed
    return SimpleNamespace(system=system, counters=counters)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_takes_the_window_s_difference(name):
    stages = READERS[name]
    # 10 bookings in the window; stage i books (i + 1) x 3 ms a booking
    value = main.reader(name).read(_run(_document(5, 15_000_000), _document(15, 45_000_000)))
    want = sum(3.0 * (STAGES.index(s) + 1) for s in stages)
    assert value == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_without_the_ledger(name):
    read = main.reader(name).read
    plain_open, plain_close = _document(5, 10), _document(15, 30)
    del plain_open["stage_stats"], plain_close["stage_stats"]
    assert read(_run(plain_open, plain_close)) is None  # a program without the ledger
    missing = [s for s in STAGES if s not in READERS[name]]
    assert read(_run(_document(5, 10, missing), _document(15, 30, missing))) is None
    assert read(_run(_document(5, 10), None)) is None  # the window never closed
    assert read(_run(_document(5, 10), _document(5, 10))) is None  # nothing booked
    engine = {"steps": 5, "lane_steps": 40}  # an engine's counters hold no ledger
    assert read(_run(engine, dict(engine, steps=15), system="llm_engine")) is None


def test_a_stage_first_booked_inside_the_window_counts_from_zero():
    opened = _document(0, 0)
    del opened["stage_stats"]["device_gap"]
    closed = _document(4, 8_000_000)
    value = main.reader("device_gap_ms.bert").read(_run(opened, closed))
    assert value == pytest.approx(8.0 * (STAGES.index("device_gap") + 1) / 4)


def test_every_reader_has_its_entry():
    doc = json.loads((main.BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in doc["per_layer"]}
    for name in READERS:
        entry = entries[name]
        assert entry["workloads"] == ["bert_large.ragged"]
        assert (entry["unit"], entry["moves"], entry["source"]) == (
            "ms", "infer_per_s", "program_counter")


def test_a_traced_tiny_bert_run_reads_the_host_s_stages():
    import bench_tiny

    _, traced = bench_tiny.run("bert_large.ragged", trace=True)
    on_card = {"device_ms.bert", "device_gap_ms.bert"}
    assert set(READERS) - on_card <= set(traced["metrics"])
    assert not on_card & set(traced["metrics"])  # a model on the CPU books no device time
    assert all(traced["metrics"][name]["value"] >= 0 for name in set(READERS) - on_card)

"""A model type is a file, ``systems/<system>.py``, that the harness
finds by the configuration's ``serve.system``: one added as files runs
without an edit, an unknown one fails naming the file it looked for,
every one defines what the harness calls, and the stage ledger's
readers follow the counters, not the system's name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import bench_tiny
from harness import main, stages, systems
from harness import weights as drawn

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# a model type added as a file: the port's TextEncoderModel served under
# a name of its own, with its own check
ENCODER_COPY = '''
"""The port's text encoder under another name."""

from harness import check
from harness import weights as drawn

INFER_TENSORS = ("INPUT_IDS", "EMBEDDING")


def weights(sizes, seed, device):
    return drawn.encoder(sizes, seed, device)


def build(config, sizes, weights, device, spans):
    import torch

    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import TextEncoderModel

    model_config = bert.BertConfig(
        vocab_size=sizes["vocab_size"], d_model=sizes["hidden_size"],
        n_layers=sizes["num_hidden_layers"], n_heads=sizes["num_attention_heads"],
        d_ff=sizes["intermediate_size"], max_seq_len=sizes["max_position_embeddings"],
        pad_token_id=sizes["pad_token_id"], norm_eps=float(sizes["layer_norm_eps"]),
        dtype=torch.float32)
    model = TextEncoderModel(name="encoder_copy", config=model_config, params=weights,
                             device=device)
    model.max_batch_size = 4
    return model


def warm(config, model, mix):
    pass


def counters(model, server):
    return server.statistics()


def compare(run, weights, control=False):
    sample = check.encoder_sample(run)
    value = check.answer_error(weights, run.sizes, sample, control) if sample else None
    return {"answer_error": {"value": value, "limit": 0.01},
            "checked_answers": {"value": len(sample), "limit": 4}}


def tiny(config, mix):
    pass
'''


def _files(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_system_added_as_files_runs_without_an_edit(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(copy / "benchmark")
    assert before == _files(BENCH)
    tiny = bench_tiny.cell("bert_large.ragged")
    config = dict(tiny["config_doc"], name="encoder_tiny")
    config["serve"] = dict(config["serve"], system="encoder_copy")
    (copy / "benchmark" / "systems" / "encoder_copy.py").write_text(ENCODER_COPY)
    (copy / "benchmark" / "configs" / "encoder_tiny.json").write_text(json.dumps(config))
    (copy / "benchmark" / "traffic" / "ragged_tiny.json").write_text(json.dumps(tiny["mix"]))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "encoder_tiny", "source": "https://example.org/tiny",
                           "file": "benchmark/configs/encoder_tiny.json", "reduced": [],
                           "why": "tiny"})
    doc["workloads"].append({"name": "encoder_tiny.ragged", "config": "encoder_tiny",
                             "traffic": "ragged_tiny", "chips": 1, "why": "tiny"})
    for metric in doc["end_to_end"]:
        if metric["name"] == "infer_per_s":
            metric["workloads"].append("encoder_tiny.ragged")
    (copy / "BENCHMARK.json").write_text(json.dumps(doc))
    script = f"""
import json, sys, time
sys.path[:0] = [{str(copy / 'benchmark')!r}, {str(ROOT)!r}]
from harness import main
cell = main.load_cell(main.BENCH.parent, "encoder_tiny.ragged")
run, _, checks = main.run_cell(cell, 2**33 + 5, 2.0, False, time.monotonic_ns(), device="cpu")
print(json.dumps(dict(main.result_line(run, checks), served=run.counters["close"]["name"])))
"""
    # the client process finds the port's client where the program is
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=copy, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["served"] == "encoder_copy"
    assert line["checks"]["checked_answers"]["value"] >= 4
    assert line["metrics"]["infer_per_s"]["value"] > 0
    after = _files(copy / "benchmark")
    assert {path: after[path] for path in before} == before


def test_an_unknown_system_fails_before_any_weights_and_names_its_file(monkeypatch):
    def draw(*args):
        raise AssertionError("weights drawn for an unknown system")

    monkeypatch.setattr(drawn, "encoder", draw)
    monkeypatch.setattr(drawn, "decoder", draw)
    cell = main.load_cell(ROOT, "bert_large.ragged")
    cell["config_doc"]["serve"]["system"] = "no_such_system"
    with pytest.raises(FileNotFoundError, match=r"systems/no_such_system\.py"):
        main.run_cell(cell, 1, 1.0, False, time.monotonic_ns(), device="cpu")


def test_a_system_file_without_a_name_of_the_table_fails(tmp_path, monkeypatch):
    (tmp_path / "systems").mkdir()
    source = (BENCH / "systems" / "text_encoder.py").read_text()
    (tmp_path / "systems" / "partial.py").write_text(source.replace("def tiny(", "def _tiny("))
    monkeypatch.setattr(systems, "BENCH", tmp_path)
    with pytest.raises(AttributeError, match=r"partial\.py does not define tiny"):
        systems.load("partial")


@pytest.mark.parametrize("system", ["llm_engine", "text_encoder"])
def test_a_system_file_defines_every_name_the_harness_calls(system):
    module = systems.load(system)
    for name in systems.NAMES:
        if name == "INFER_TENSORS":
            tensors = module.INFER_TENSORS
            assert isinstance(tensors, tuple) and len(tensors) == 2
            assert all(isinstance(t, str) and t for t in tensors)
        else:
            assert callable(getattr(module, name)), name


def test_every_configuration_names_a_system_file():
    for path in sorted((BENCH / "configs").glob("*.json")):
        systems.load(json.loads(path.read_text())["serve"]["system"])


def _ledger(count, ns):
    return {"stage_stats": {"batch_assembly": {"count": count, "ns": ns}}}


@pytest.mark.parametrize("system", ["text_encoder", "llm_engine", "a_new_type"])
def test_the_stage_ledger_is_read_wherever_the_counters_hold_it(system):
    run = SimpleNamespace(system=system, counters={"open": _ledger(2, 4_000_000),
                                                   "close": _ledger(6, 16_000_000)})
    assert stages.mean_ms(run, "batch_assembly") == pytest.approx(3.0)
    engine = {"steps": 2, "lane_steps": 8}
    run = SimpleNamespace(system=system, counters={"open": engine,
                                                   "close": dict(engine, steps=6)})
    assert stages.mean_ms(run, "batch_assembly") is None

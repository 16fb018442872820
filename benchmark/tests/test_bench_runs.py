"""Whole runs of the tiny cells on the CPU: the harness's path from the
weights to the result line, a cell added as files, and the refusal
without a card."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import bench_tiny
from harness import main

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_the_chat_cell_runs_and_checks(tmp_path):
    run, line = bench_tiny.run("mistral7b.chat")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"output_tokens_per_s", "itl_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"


def test_the_traced_chat_run_reads_the_host_side_metrics():
    _, line = bench_tiny.run("mistral7b.chat", trace=True)
    # the card's readers find nothing on the CPU and stay silent
    assert {"decode_batch", "prefill_ms", "ttft_p95_ms.client", "decode_step_ms",
            "mfu.llm"} <= set(line["metrics"])
    assert "k1_roofline" not in line["metrics"] and "idle_share.llm" not in line["metrics"]
    assert 1 <= line["metrics"]["decode_batch"]["value"] <= 4


def test_the_bert_cell_runs_and_checks():
    _, line = bench_tiny.run("bert_large.ragged")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"infer_per_s", "setup_s"}
    _, traced = bench_tiny.run("bert_large.ragged", trace=True)
    assert {"rows_per_exec.bert", "queue_ms.bert", "wire_ms.bert", "exec_ms.bert",
            "mfu.bert"} <= set(traced["metrics"])


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((BENCH / "traffic" / "chat.json").read_text())
    mix.update(concurrency=4, ramp_s=1)
    mix["prompt_tokens"].update(median=16, min=8, max=32)
    mix["output_tokens"].update(min=4, max=8)
    (copy / "benchmark" / "traffic" / "chat_tiny.json").write_text(json.dumps(mix))
    config = bench_tiny.cell("mistral7b.chat")["config_doc"]
    config["name"] = "mistral_tiny"
    (copy / "benchmark" / "configs" / "mistral_tiny.json").write_text(json.dumps(config))
    doc["configs"].append({"name": "mistral_tiny", "source": "https://example.org/tiny",
                           "file": "benchmark/configs/mistral_tiny.json", "reduced": [],
                           "why": "tiny"})
    doc["workloads"].append({"name": "mistral_tiny.chat", "config": "mistral_tiny",
                             "traffic": "chat_tiny", "chips": 1, "why": "tiny"})
    if "itl_p95_ms" not in {m["name"] for m in doc["end_to_end"]}:
        # the chat cell is parked: its metric's entry comes back as an entry
        parked = json.loads((BENCH / "parked.json").read_text())
        itl = next(m for m in parked["end_to_end"] if m["name"] == "itl_p95_ms")
        doc["end_to_end"].append(dict(itl, workloads=[]))
    for metric in doc["end_to_end"]:
        if metric["name"] == "itl_p95_ms":
            metric["workloads"].append("mistral_tiny.chat")
    (copy / "BENCHMARK.json").write_text(json.dumps(doc))
    script = f"""
import json, sys, time
sys.path[:0] = [{str(copy / 'benchmark')!r}, {str(ROOT)!r}]
from harness import main
cell = main.load_cell(main.BENCH.parent, "mistral_tiny.chat")
run, _, checks = main.run_cell(cell, 77, 2.0, False, time.monotonic_ns(), device="cpu")
print(json.dumps(main.result_line(run, checks)))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=copy, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert "itl_p95_ms" in line["metrics"]


def test_no_card_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "bert_large.ragged", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bert_large.ragged",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""

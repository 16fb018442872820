"""The port's genai-perf (``client_tpu_torch.genai_perf``) against the JAX
package's (``client_tpu.genai_perf``).

- Byte equality with the reference for the same inputs and seed: the
  ``create_llm_inputs`` documents (every output format, with the
  synthetic tokenizer and the bundled BPE), the tokenizers' ids, the
  statistics, the console table and the CSV/JSON metric files.
- Each package parses the other's profile export to the same metrics.
- The units of ``tests/test_genai_perf.py``: datasets, the offline guard
  of the hub fetch, logging, plots and ``compare``.
- ``genai-perf --service-kind openai --streaming`` against the port's
  server holding the tiny fp32 ``llm_engine`` on the CPU (weights from
  ``params_from_jax``): every request's token events equal its
  ``max_tokens``, and the server books every stream.
- The ``kserve*`` endpoint types, which ride gRPC in the reference, exit 2.
"""

import io
import json
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import client_tpu.genai_perf.inputs as jax_inputs
import client_tpu.genai_perf.main as jax_main
import client_tpu.genai_perf.metrics as jax_metrics
import client_tpu.genai_perf.tokenizer as jax_tokenizer
from client_tpu.models import llama as jax_llama
from client_tpu_torch.genai_perf import inputs, main, metrics, tokenizer
from client_tpu_torch.genai_perf.logging import getLogger, init_logging
from client_tpu_torch.http import InferenceServerClient
from client_tpu_torch.llm.engine import EngineConfig
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama
from client_tpu_torch.perf import cli as perf_cli
from client_tpu_torch.perf import report
from client_tpu_torch.testing import InProcessServer

torch.set_num_threads(1)
MS = 1_000_000


def _export(scale=1, failures=True):
    return {"experiments": [{
        "experiment": {"mode": "concurrency", "value": 1},
        "requests": [
            {"timestamp": i * MS,
             "response_timestamps": [(i + 3 * scale + k * (1 + i % 3)) * MS
                                     for k in range(1 + i % 4)],
             "success": not (failures and i == 5)}
            for i in range(12)
        ] + ([{"timestamp": 0, "response_timestamps": [], "success": False}]
             if failures else []),
    }]}


# ---------------------------------------------------------------------------
# tokenizers and statistics
# ---------------------------------------------------------------------------


def test_synthetic_tokenizer_is_the_references():
    rng = np.random.default_rng(0)
    words = ["the", "été", "x", "tok9", "", "quick", "Ünïcödé", "42"]
    for vocab in (32000, 1000, 97):
        port = tokenizer.SyntheticTokenizer(vocab)
        ref = jax_tokenizer.SyntheticTokenizer(vocab)
        for _ in range(20):
            text = " ".join(rng.choice(words, size=int(rng.integers(0, 30))))
            assert port.encode(text) == ref.encode(text)
            assert port(text) == ref(text)
            ids = port.encode(text)
            assert port.decode(ids) == ref.decode(ids)
    ids = tokenizer.get_tokenizer("synthetic").encode("hello world hello")
    assert len(ids) == 3 and ids[0] == ids[2]


def test_bundled_bpe_is_the_references():
    pytest.importorskip("tokenizers")
    port = tokenizer.get_tokenizer(None)
    ref = jax_tokenizer.get_tokenizer(None)
    assert isinstance(port, tokenizer.BundledBPETokenizer)
    assert tokenizer.tokenizer_provenance(port) == "bundled-bpe8k"
    frozen = {
        "the quick brown fox jumps over the lazy dog": 16,
        "measuring inference latency and throughput on tensor hardware": 9,
        "The server returned an error: connection refused (111).": 12,
        "streaming tokens per second": 4,
        "hello world": 4,
    }
    for text, count in frozen.items():
        assert port.encode(text) == ref.encode(text)
        assert len(port.encode(text)) == count
    text = "the quick brown fox jumps over the lazy dog"
    assert port.decode(port.encode(text)).strip() == text
    # a tokenizer that cannot be loaded falls back to the bundled BPE
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(sys.modules, "transformers", None)  # and skips its slow import
        assert isinstance(tokenizer.get_tokenizer("definitely/not-a-local-model"),
                          tokenizer.BundledBPETokenizer)
    assert tokenizer.tokenizer_provenance(tokenizer.get_tokenizer("synthetic")) == (
        "synthetic-word-hash")


@pytest.mark.parametrize("n", [0, 1, 5, 64])
def test_statistics_are_the_references(n):
    samples = np.random.default_rng(n).normal(10, 3, size=n).tolist()
    assert (metrics.Statistics.from_samples(samples).__dict__
            == jax_metrics.Statistics.from_samples(samples).__dict__)
    s = metrics.Statistics.from_samples([1.0, 2.0, 3.0, 4.0, 5.0])
    assert (s.avg, s.min, s.max, s.p50, s.count) == (3.0, 1.0, 5.0, 3.0, 5)


# ---------------------------------------------------------------------------
# input corpora: byte-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["kserve-ids", "kserve-text", "openai-chat",
                                 "openai-completions"])
@pytest.mark.parametrize("tok", ["synthetic", "bpe"])
@pytest.mark.parametrize("extras", [
    {},
    {"input_tokens_stddev": 4.0, "output_tokens_stddev": 3.0, "seed": 9},
    {"shared_prefix_tokens": 16, "speculation": "off", "streaming": True,
     "model": "llm_engine"},
], ids=["plain", "stddev", "prefix"])
def test_create_llm_inputs_is_byte_equal_to_the_references(tmp_path, fmt, tok, extras):
    if tok == "bpe":
        pytest.importorskip("tokenizers")
    kwargs = dict(num_prompts=12, input_tokens_mean=20, output_tokens_mean=6,
                  output_format=fmt, input_name="PROMPT" if fmt == "kserve-text"
                  else "INPUT_IDS", **extras)
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    doc = inputs.create_llm_inputs(str(port_path), tokenizer=tokenizer.get_tokenizer(tok),
                                   **kwargs)
    jax_inputs.create_llm_inputs(str(ref_path), tokenizer=jax_tokenizer.get_tokenizer(tok),
                                 **kwargs)
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert json.loads(port_path.read_text()) == doc
    assert len(doc["data"]) == 12


def test_create_llm_inputs_shapes():
    doc = inputs.create_llm_inputs("", num_prompts=10, input_tokens_mean=16)
    entry = doc["data"][0]["INPUT_IDS"]
    assert entry["shape"] == [len(entry["content"])]
    assert all(isinstance(i, int) for i in entry["content"])
    doc = inputs.create_llm_inputs("", num_prompts=3, input_tokens_mean=8,
                                   output_format="kserve-text", input_name="PROMPT")
    assert len(doc["data"][0]["PROMPT"]["content"][0].split()) == 8
    with pytest.raises(ValueError, match="unknown output format"):
        inputs.create_llm_inputs("", num_prompts=1, output_format="nope")


def test_dataset_file_inputs_are_the_references(tmp_path):
    orca = tmp_path / "orca.jsonl"
    orca.write_text("\n".join(json.dumps({"system_prompt": "You are concise.",
                                          "question": f"Q{i}?"}) for i in range(3)))
    cnn = tmp_path / "cnn.json"
    cnn.write_text(json.dumps([{"article": "A long news article."}]))
    plain = tmp_path / "plain.jsonl"
    plain.write_text("﻿" + json.dumps({"prompt": "write a haiku"}))
    for path, fmt in ((orca, "auto"), (orca, "openorca"), (cnn, "cnn_dailymail"),
                      (plain, "plain"), (plain, "auto")):
        assert inputs.load_dataset_prompts(str(path), fmt) == \
            jax_inputs.load_dataset_prompts(str(path), fmt)
    assert inputs.load_dataset_prompts(str(orca), limit=2) == [
        "You are concise. Q0?", "You are concise. Q1?"]
    doc = inputs.create_llm_inputs(None, num_prompts=5, dataset_path=str(orca),
                                   output_format="kserve-text", input_name="PROMPT")
    texts = [e["PROMPT"]["content"][0] for e in doc["data"]]
    assert texts[0] == texts[3] == "You are concise. Q0?"  # cycled
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"unrelated": 1}]))
    with pytest.raises(ValueError, match="no prompts"):
        inputs.load_dataset_prompts(str(bad))


def test_hub_fetch_offline_mode_and_parsing(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="offline"):
        inputs.fetch_hub_prompts("openorca")
    monkeypatch.delenv("HF_HUB_OFFLINE")
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="offline"):
        inputs.fetch_hub_prompts("cnn_dailymail")
    monkeypatch.delenv("HF_DATASETS_OFFLINE")
    with pytest.raises(ValueError, match="unknown hosted dataset"):
        inputs.fetch_hub_prompts("not_a_dataset")
    captured = {}

    def fake_urlopen(url, timeout=0):
        captured["url"] = url
        body = io.BytesIO(json.dumps({"rows": [
            {"row": {"system_prompt": "sys", "question": "q1"}},
            {"row": {"question": "q2"}},
            {"row": {"irrelevant": True}},
        ]}).encode())
        body.__enter__ = lambda *a: body
        body.__exit__ = lambda *a: False
        return body

    # nothing leaves the machine: the fetch is answered here
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    assert inputs.fetch_hub_prompts("openorca", starting_index=5, length=2) == ["sys q1", "q2"]
    assert "offset=5" in captured["url"] and "length=2" in captured["url"]
    assert inputs.HUB_DATASET_URLS == jax_inputs.HUB_DATASET_URLS


# ---------------------------------------------------------------------------
# metrics from profile exports
# ---------------------------------------------------------------------------


def test_profile_parser_math():
    doc = {"experiments": [{"experiment": {"mode": "concurrency", "value": 1}, "requests": [
        {"timestamp": 0, "response_timestamps": [10 * MS, 12 * MS, 14 * MS], "success": True},
        {"timestamp": 5 * MS, "response_timestamps": [20 * MS, 21 * MS], "success": True},
        {"timestamp": 0, "response_timestamps": [], "success": False},
    ]}]}
    path = io.StringIO()
    json.dump(doc, path)
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        f.write(path.getvalue())
        f.flush()
        m = metrics.LLMProfileDataParser(f.name).parse()
    assert m.request_count == 2
    assert m.time_to_first_tokens == [10 * MS, 15 * MS]
    assert m.output_token_counts == [3, 2]
    assert m.inter_token_latencies == [2 * MS, 2 * MS, 1 * MS]
    assert m.benchmark_duration_ns == 21 * MS
    assert m.output_token_throughput == pytest.approx(5 / 0.021)
    assert m.request_throughput == pytest.approx(2 / 0.021)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_parses_the_others_export(tmp_path, writer):
    """One export, written by either package's harness writer, parsed by
    both: the same metrics, table and metric files byte for byte."""
    import client_tpu.perf.profiler as jax_profiler
    import client_tpu.perf.records as jax_records
    import client_tpu.perf.report as jax_report
    from client_tpu_torch.perf import profiler, records

    doc = _export()["experiments"][0]
    mods = {"port": (records, profiler, report), "jax": (jax_records, jax_profiler, jax_report)}
    recs, prof, rep = mods[writer]
    experiment = prof.ProfileExperiment(
        mode="concurrency", value=1, status=recs.PerfStatus(),
        records=[recs.RequestRecord(start_ns=r["timestamp"],
                                    response_ns=r["response_timestamps"],
                                    success=r["success"]) for r in doc["requests"]])
    path = tmp_path / "profile_export.json"
    rep.export_profile([experiment], str(path))
    port = metrics.LLMProfileDataParser(str(path)).parse()
    ref = jax_metrics.LLMProfileDataParser(str(path)).parse()
    assert port.__dict__ == ref.__dict__
    assert port.request_count == 11
    assert metrics.console_table(port) == jax_metrics.console_table(ref)
    for export in ("export_csv", "export_json"):
        getattr(metrics, export)(port, str(tmp_path / f"port_{export}"))
        getattr(jax_metrics, export)(ref, str(tmp_path / f"ref_{export}"))
        assert (tmp_path / f"port_{export}").read_bytes() == (
            tmp_path / f"ref_{export}").read_bytes()
    metrics.export_json(port, str(tmp_path / "tok.json"), tokenizer="bundled-bpe8k")
    assert json.loads((tmp_path / "tok.json").read_text())["tokenizer"] == "bundled-bpe8k"
    assert main.json_summary_line(port) == jax_main.json_summary_line(ref)
    assert main.json_summary_line(port, {"step_tokens": 30, "lane_steps": 10,
                                         "spec_accepted": 4, "spec_proposed": 8}) == \
        jax_main.json_summary_line(ref, {"step_tokens": 30, "lane_steps": 10,
                                         "spec_accepted": 4, "spec_proposed": 8})
    assert main.spec_stats_delta({"a": 1}, {"a": 3}) == {"a": 2}
    assert main.spec_stats_delta({"a": 3}, {"a": 1}) is None
    assert main.fetch_spec_stats("127.0.0.1:9", "m") is None


def test_structured_logging():
    stream = io.StringIO()
    init_logging(verbose=True, stream=stream)
    log = getLogger("client_tpu_torch.genai_perf.main")
    assert log.name == "genai_perf.main"
    log.info("structured %s", "message")
    assert "[INFO] genai_perf.main - structured message" in stream.getvalue()


def test_plots_and_compare(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from client_tpu_torch.genai_perf.plots import generate_plots

    (tmp_path / "run_a.json").write_text(json.dumps(_export(1, failures=False)))
    (tmp_path / "run_b.json").write_text(json.dumps(_export(2, failures=False)))
    generate_plots(str(tmp_path / "run_a.json"), str(tmp_path))
    for name in ("ttft_distribution.png", "token_timeline.png", "itl_distribution.png",
                 "itl_by_position.png", "output_tokens.png", "throughput_over_time.png"):
        assert (tmp_path / name).exists(), name
    out_dir = tmp_path / "artifacts"
    code = main.main(["compare", "--files", str(tmp_path / "run_a.json"),
                      str(tmp_path / "run_b.json"), "--names", "baseline", "candidate",
                      "--artifact-dir", str(out_dir), "--generate-plots"])
    assert code == 0
    out = capsys.readouterr().out
    assert "baseline" in out and "time to first token avg (ms)" in out
    doc = json.loads((out_dir / "compare.json").read_text())
    assert doc["runs"] == ["baseline", "candidate"]
    assert (out_dir / "compare.csv").exists() and (out_dir / "compare_ttft_box.png").exists()
    ref_dir = tmp_path / "ref"
    assert jax_main.main(["compare", "--files", str(tmp_path / "run_a.json"),
                          str(tmp_path / "run_b.json"), "--names", "baseline", "candidate",
                          "--artifact-dir", str(ref_dir)]) == 0
    for name in ("compare.json", "compare.csv"):
        assert (out_dir / name).read_bytes() == (ref_dir / name).read_bytes()
    assert main.main(["compare", "--files", "a.json", "--names", "x", "y"]) == 1


# ---------------------------------------------------------------------------
# end to end: genai-perf over the OpenAI route, against the tiny engine
# ---------------------------------------------------------------------------

JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)


@pytest.fixture(scope="module")
def llm_server():
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))(
        jax.random.PRNGKey(0))
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    model = LlmEngineModel(
        config=llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32), params=params,
        engine_config=EngineConfig(block_size=8, num_blocks=1 + 8 * 8, max_active=8,
                                   max_queue=32, max_seq_len=64),
        device="cpu",
    )
    server = InProcessServer(builtin_models=False, device="cpu")
    server.core.repository.add_model(model)
    server.start()
    yield server
    server.stop()


def test_genai_perf_streams_through_the_ports_openai_route(llm_server, tmp_path, capsys):
    with InferenceServerClient(llm_server.http_url) as client:
        before = client.get_inference_statistics("llm_engine")["model_stats"][0]
    code = main.main([
        "-m", "llm_engine", "-u", llm_server.http_url, "--service-kind", "openai",
        "--endpoint-type", "openai-chat", "--streaming", "--tokenizer", "synthetic",
        "--num-prompts", "8", "--synthetic-input-tokens-mean", "12",
        "--output-tokens-mean", "6", "--concurrency", "2",
        "--measurement-interval", "400", "--stability-percentage", "100",
        "--max-trials", "3", "--artifact-dir", str(tmp_path), "--json-summary",
    ])
    out = capsys.readouterr().out
    assert code == 0
    summary = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
    assert set(summary) == {"ttft_avg_ms", "ttft_p99_ms", "itl_avg_ms", "itl_p99_ms",
                            "tokens_per_sec", "requests_per_sec", "request_count",
                            "output_tokens_avg"}
    assert summary["output_tokens_avg"] == 6.0 and summary["request_count"] > 0
    requests = json.loads((tmp_path / "profile_export.json").read_text())[
        "experiments"][0]["requests"]
    # every request's token events equal its max_tokens
    corpus = json.loads((tmp_path / "llm_inputs.json").read_text())["data"]
    assert {json.loads(e["payload"]["content"][0])["max_tokens"] for e in corpus} == {6}
    assert requests and all(r["success"] and len(r["response_timestamps"]) == 6
                            for r in requests)
    report_doc = json.loads((tmp_path / "llm_metrics.json").read_text())
    assert report_doc["tokenizer"] == "synthetic-word-hash"
    assert report_doc["inter_token_latency"]["count"] > 0
    with InferenceServerClient(llm_server.http_url) as client:
        after = client.get_inference_statistics("llm_engine")["model_stats"][0]
    booked = after["inference_stats"]["success"]["count"] - before["inference_stats"][
        "success"]["count"]
    assert booked >= len(requests)
    assert after["inference_stats"]["compute_infer"]["ns"] > before["inference_stats"][
        "compute_infer"]["ns"]


def test_the_harness_times_an_openai_stream_event_by_event(llm_server, tmp_path, capsys):
    """The perf CLI itself, --service-kind openai --streaming: each
    stream's token events count as separate responses and the run has no
    error."""
    data = tmp_path / "inputs.json"
    inputs.create_llm_inputs(str(data), num_prompts=4, input_tokens_mean=10,
                             output_tokens_mean=5, output_format="openai-chat",
                             model="llm_engine", streaming=True)
    export = tmp_path / "export.json"
    code = perf_cli.main(["-m", "llm_engine", "-u", llm_server.http_url,
                          "--service-kind", "openai", "--streaming", "--input-data", str(data),
                          "--concurrency-range", "2", "--measurement-interval", "300",
                          "--stability-percentage", "100", "--max-trials", "3",
                          "--profile-export-file", str(export), "--json-summary"])
    assert code == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["errors"] == 0 and "routing_policy" not in summary
    requests = json.loads(export.read_text())["experiments"][0]["requests"]
    assert requests and all(len(r["response_timestamps"]) == 5 for r in requests)


@pytest.mark.parametrize("flags", [
    [],
    ["--service-kind", "triton"],
    ["--endpoint-type", "kserve-ids"],
    ["--endpoint-type", "kserve-text"],
])
def test_kserve_endpoint_types_are_refused(flags, capsys):
    assert main.main(["-m", "llm_decode", "-u", "127.0.0.1:9"] + flags) == 2
    err = capsys.readouterr().err
    assert "ROADMAP Queue 1 item 4" in err and "--service-kind openai" in err

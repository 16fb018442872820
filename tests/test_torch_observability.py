"""The port's observability surface against the JAX package's.

- The Prometheus registry (``observability/metrics.py``) renders the
  same bytes as the reference's for the same observations, exemplars
  included, and ``parse_exposition`` round-trips them.
- The rolling windows and the SLO tracker (``observability/window.py``,
  ``slo.py``) give the reference's outputs under an injected clock, and
  so do the flight recorder and the wall-stack sampler.
- Two in-process servers (the JAX package's and the port's on
  ``device="cpu"``) take the same deterministic traffic; their
  ``/metrics`` show the same families with the same label names, and
  each model's ``tpu_inference_request_duration`` ``_count`` equals its
  statistics' ``success.count``.
- The trace manager: a sampled ``traceparent`` from the port's client
  forces a trace with the client's id and five stamps; ``trace_rate``
  samples. The logging settings refuse the same bad updates with 400 on
  both sides; the profiling toggle and the on-demand sampler answer as
  the reference's, and a CPU-only ``torch.profiler`` capture writes a
  Chrome trace inside the temp directory and nowhere else.
- ``tools/metric_lint.py`` and ``tools/clock_lint.py`` find nothing in
  the port's ``server/metrics.py`` and ``observability/`` (the clock lint
  nothing in ``grpc/_mux.py`` either), ``tools/log_lint.py`` nothing in
  its ``server/`` and ``observability/``, and ``tools/lint.py``'s
  unused-import check nothing in ``client_tpu_torch/``.
"""

import ast
import http.client
import json
import os
import pathlib
import sys
import tempfile
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import client_tpu.http as httpclient
from client_tpu.observability import metrics as jax_metrics
from client_tpu.observability import profiling as jax_profiling
from client_tpu.observability import recorder as jax_recorder
from client_tpu.observability import slo as jax_slo
from client_tpu.observability import window as jax_window
from client_tpu.testing import InProcessServer as JaxInProcessServer
from client_tpu_torch import http as port_http
from client_tpu_torch.observability import InMemoryExporter, Tracer
from client_tpu_torch.observability import metrics, profiling, recorder, slo, window
from client_tpu_torch.testing import InProcessServer

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import clock_lint  # noqa: E402
import lint  # noqa: E402
import log_lint  # noqa: E402
import metric_lint  # noqa: E402

torch.set_num_threads(1)
SIDES = ("jax", "torch")


class FakeClock:
    def __init__(self, start_ns=1_000_000_000):
        self.now = start_ns

    def __call__(self):
        return self.now

    def advance_s(self, seconds):
        self.now += int(seconds * 1e9)


def _fill_registry(module):
    registry = module.MetricsRegistry()
    counter = module.Counter("tpu_demo_total", 'Requests "with" \\ escapes\nand lines.',
                             ("model", "code"), registry=registry)
    gauge = module.Gauge("tpu_demo_gauge", "A gauge.", registry=registry)
    hist = module.Histogram("tpu_demo_seconds", "A histogram.", ("model",),
                            buckets=(0.001, 0.01, 0.1, 1.0), registry=registry)
    rng = np.random.default_rng(0)
    for i in range(40):
        model = ["a", 'b"q', "c\\d\ne"][i % 3]
        counter.labels(model, str(200 + i % 2)).inc(float(rng.integers(1, 5)))
        hist.labels(model).observe(float(rng.exponential(0.05)),
                                   exemplar=({"trace_id": f"{i:032x}"}, 0.5) if i % 7 == 0
                                   else None)
    gauge.set(-3.25)
    gauge.dec(0.5)
    counter.labels("gone", "500").inc()
    counter.remove("gone", "500")
    return registry


def test_registry_renders_the_reference_bytes_and_round_trips():
    ours, theirs = _fill_registry(metrics), _fill_registry(jax_metrics)
    for exemplars in (False, True):
        text = ours.render(exemplars=exemplars)
        assert text == theirs.render(exemplars=exemplars)
    parsed = metrics.parse_exposition(ours.render(exemplars=True))
    reference = jax_metrics.parse_exposition(theirs.render(exemplars=True))
    assert sorted(parsed) == sorted(reference) == [
        "tpu_demo_gauge", "tpu_demo_seconds", "tpu_demo_total"]
    for name, family in parsed.items():
        assert [(s.name, s.labels, s.value) for s in family.samples] == [
            (s.name, s.labels, s.value) for s in reference[name].samples]
    hist = metrics.histogram_totals(parsed["tpu_demo_seconds"], {"model": 'b"q'})
    assert hist["count"] == 13 and hist["buckets"][-1][0] == float("inf")
    assert metrics.gauge_values(parsed["tpu_demo_gauge"]) == [-3.75]
    assert metrics.counter_total(parsed["tpu_demo_total"]) == metrics.counter_total(
        reference["tpu_demo_total"])


def _drive_windows(module, clock):
    hist = module.WindowedHistogram((0.001, 0.01, 0.1, 1.0), horizon_s=30.0,
                                    subwindows=6, clock_ns=clock)
    counter = module.WindowedCounter(horizon_s=60.0, subwindows=6, clock_ns=clock)
    rng = np.random.default_rng(1)
    out = []
    for step in range(50):
        hist.observe(float(rng.exponential(0.02)), count=int(rng.integers(1, 4)))
        counter.add(good=int(rng.integers(0, 5)), bad=int(rng.integers(0, 2)))
        clock.advance_s(float(rng.uniform(0.1, 3.0)))
        snap = hist.snapshot()
        out.append((snap.count, [snap.quantile(q) for q in (0.5, 0.95, 0.99)],
                    counter.totals()))
    return out


def test_windows_and_slo_equal_the_reference_under_an_injected_clock():
    assert _drive_windows(window, FakeClock()) == _drive_windows(jax_window, FakeClock())

    def run(module):
        clock = FakeClock()
        declared = SimpleNamespace(slo={"latency_target_ms": 20, "availability": 0.99,
                                        "window_s": 60})
        objectives = {"slow": module.SloObjective.from_model(declared)}
        telemetry = module.LiveTelemetry(buckets=(0.001, 0.01, 0.1, 1.0), clock_ns=clock,
                                         objective_resolver=objectives.get)
        rng = np.random.default_rng(2)
        for _ in range(200):
            model = "slow" if rng.random() < 0.5 else "plain"
            telemetry.record(model, float(rng.exponential(0.015)), ok=rng.random() > 0.05)
            clock.advance_s(float(rng.uniform(0.0, 0.5)))
        return telemetry.snapshot(), telemetry.summary()

    assert run(slo) == run(jax_slo)


def test_flight_recorder_equals_the_reference():
    def run(module):
        clock = FakeClock()
        rec = module.FlightRecorder(capacity=8, error_capacity=4, slow_capacity=3,
                                    clock=lambda: clock() / 1e9)
        rng = np.random.default_rng(3)
        for i in range(30):
            clock.advance_s(0.01)
            rec.record(["m", "n"][i % 2], request_id=str(i),
                       status=["ok", "error", "rejected"][int(rng.integers(0, 3))],
                       error="boom" if i % 5 == 0 else "", path="single",
                       queue_us=float(rng.uniform(0, 100)),
                       compute_us=float(rng.uniform(0, 1000)),
                       package_us=float(rng.uniform(0, 10)),
                       total_us=float(rng.uniform(0, 2000)), rows=int(i % 3) + 1)
        return rec.snapshot(), rec.snapshot(model="n", limit=2), rec.stats()

    assert run(recorder) == run(jax_recorder)


def test_wall_profiler_equals_the_reference_on_fake_frames():
    def frame(name, back=None):
        return SimpleNamespace(f_code=SimpleNamespace(co_filename=f"/x/{name}.py",
                                                      co_name=name), f_back=back)

    stacks = [frame("leaf", frame("mid", frame("root"))), frame("other", frame("root"))]

    def run(module):
        clock = FakeClock()
        calls = iter(range(10_000))

        def frames():
            i = next(calls)
            clock.advance_s(0.0001)
            return {1: stacks[i % 2], 2: stacks[(i + 1) % 2]}

        profiler = module.WallProfiler(hz=100, clock_ns=clock,
                                       sleep=clock.advance_s, frames=frames)
        result = profiler.run(0.5)
        return result.collapsed(), result.speedscope(), result.sample_count

    assert run(profiling) == run(jax_profiling)


# -- the two servers -------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    reference = JaxInProcessServer(grpc=False).start()
    port = InProcessServer(device="cpu").start()
    port.core.trace_manager.exporter = InMemoryExporter()
    yield {"jax": reference, "torch": port}
    port.stop()
    reference.stop()


def _raw(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"} if data else {})
    response = conn.getresponse()
    payload = response.read()
    headers = dict(response.getheaders())
    conn.close()
    return response.status, payload, headers


def _traffic(url):
    """The same deterministic requests: batched, single, a failure."""
    rng = np.random.default_rng(4)
    client = httpclient.InferenceServerClient(url)
    try:
        for rows in (1, 2, 4):
            inputs = [httpclient.InferInput(n, [rows, 16], "INT32") for n in ("INPUT0", "INPUT1")]
            for inp in inputs:
                inp.set_data_from_numpy(rng.integers(0, 100, [rows, 16], dtype=np.int32))
            client.infer("simple", inputs)
            client.infer("add_sub_chain", inputs)
        inp = httpclient.InferInput("INPUT0", [8], "FP32")
        inp.set_data_from_numpy(rng.normal(size=8).astype(np.float32))
        client.infer("identity_fp32", [inp])
        with pytest.raises(Exception):
            client.infer("simple", [inp])  # wrong inputs: a failure
    finally:
        client.close()


def test_metrics_families_and_counts_match_the_jax_server(servers):
    parsed, stats = {}, {}
    for side in SIDES:
        server = servers[side]
        _traffic(server.http_url)
        status, body, headers = _raw(server.http_port, "GET", "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        parsed[side] = metrics.parse_exposition(body.decode())
        stats[side] = {s["name"]: s for s in json.loads(
            _raw(server.http_port, "GET", "/v2/models/stats")[1])["model_stats"]}
    ours, theirs = parsed["torch"], parsed["jax"]
    assert set(ours) == set(theirs)

    def label_names(family):
        return {tuple(sorted(k for k in s.labels if k != "le")) for s in family.samples}

    for name, family in theirs.items():
        if family.samples and ours[name].samples:
            assert label_names(ours[name]) == label_names(family), name
    for side, fams in parsed.items():
        for model in ("simple", "add_sub_chain", "identity_fp32"):
            hist = metrics.histogram_totals(fams["tpu_inference_request_duration"],
                                            {"model": model})
            assert hist["count"] == stats[side][model]["inference_stats"]["success"]["count"]
            assert hist["count"] > 0
        fail = metrics.counter_total(fams["tpu_inference_request_failure"],
                                     {"model": "simple"})
        assert fail == stats[side]["simple"]["inference_stats"]["fail"]["count"] >= 1
    # a server on the CPU books no device time
    assert metrics.gauge_values(ours["tpu_device_compute_ns_total"]) == [0.0]
    assert [s.labels for s in ours["tpu_device_memory_bytes"].samples] == [{"device": "cpu"}]
    status, body, _ = _raw(servers["torch"].http_port, "GET", "/v2")
    assert json.loads(body)["devices"]["platform"] == "cpu"


def test_debug_routes_answer_as_the_reference(servers):
    _traffic(servers["torch"].http_url)
    for side in SIDES:
        port = servers[side].http_port
        status, body, _ = _raw(port, "GET", "/v2/debug/requests?model=simple&limit=3")
        doc = json.loads(body)
        assert status == 200 and 0 < len(doc["slowest"]) <= 3
        assert {"total_us", "stages", "model", "path"} <= doc["slowest"][0].keys()
        assert _raw(port, "GET", "/v2/debug/requests?limit=x")[0] == 400
        state = json.loads(_raw(port, "GET", "/v2/debug/state")[1])
        assert {"server", "queues", "trace", "profiling", "flight_recorder", "slo",
                "devices"} <= state.keys()
        assert "simple" in json.loads(_raw(port, "GET", "/v2/debug/slo")[1])["models"]


BAD_LOG_UPDATES = [{"log_info": "yes"}, {"log_verbose_level": -1}, {"nope": 1},
                   {"log_format": "xml"}]


@pytest.mark.parametrize("update", BAD_LOG_UPDATES, ids=["info", "verbose", "unknown", "format"])
def test_logging_validation_refuses_as_the_reference(servers, update):
    answers = {}
    for side in SIDES:
        status, body, _ = _raw(servers[side].http_port, "POST", "/v2/logging", update)
        answers[side] = (status, json.loads(body)["error"])
    assert answers["jax"] == answers["torch"]
    assert answers["torch"][0] == 400


def test_logging_and_trace_settings_round_trip(servers):
    for side in SIDES:
        port = servers[side].http_port
        settings = {}
        for path in ("/v2/logging", "/v2/models/simple/logging"):
            status, body, _ = _raw(port, "POST", path, {"log_verbose_level": 2})
            assert status == 200
            settings[path] = json.loads(body)
            _raw(port, "POST", path, {"log_verbose_level": None})
        assert settings["/v2/logging"]["log_verbose_level"] == 2
        status, body, _ = _raw(port, "GET", "/v2/models/simple/trace/setting")
        assert status == 200 and json.loads(body)["trace_level"] == ["OFF"]
        assert _raw(port, "POST", "/v2/trace/setting", {"trace_rate": 0})[0] == 400
    assert (json.loads(_raw(servers["torch"].http_port, "GET", "/v2/logging")[1])
            == json.loads(_raw(servers["jax"].http_port, "GET", "/v2/logging")[1]))


def test_a_port_client_traceparent_forces_a_five_stamp_trace(servers):
    server = servers["torch"]
    exporter = server.core.trace_manager.exporter
    port = server.http_port
    # tracing on, but sampling one request in a million: only the
    # propagated sampled context can make a trace
    _raw(port, "POST", "/v2/models/identity_fp32/trace/setting",
         {"trace_level": ["TIMESTAMPS"], "trace_rate": "1000000", "log_frequency": "1"})
    client_spans = InMemoryExporter()
    client = port_http.InferenceServerClient(server.http_url, tracer=Tracer(client_spans))
    try:
        inp = port_http.InferInput("INPUT0", [4], "FP32")
        inp.set_data_from_numpy(np.arange(4, dtype=np.float32))
        exporter.items.clear()
        client.infer("identity_fp32", [inp])  # forced by the traceparent
        client.infer("identity_fp32", [inp])  # forced again
        plain = httpclient.InferenceServerClient(server.http_url)
        plain.infer("identity_fp32", [_jax_input()])  # untraced client: count 1 -> sampled
        plain.infer("identity_fp32", [_jax_input()])  # count 2: not sampled
        plain.close()
    finally:
        client.close()
        _raw(port, "POST", "/v2/models/identity_fp32/trace/setting",
             {"trace_level": None, "trace_rate": None, "log_frequency": None})
    records = exporter.items
    assert len(records) == 3
    client_ids = client_spans.trace_ids()
    assert [r["id"] for r in records[:2]] == client_ids[:2]
    for record in records:
        assert [t["name"] for t in record["timestamps"]] == [
            "REQUEST_START", "QUEUE_START", "COMPUTE_START", "COMPUTE_END", "REQUEST_END"]
        stamps = [t["ns"] for t in record["timestamps"]]
        assert stamps == sorted(stamps)
    assert records[2]["id"] not in client_ids


def _jax_input():
    inp = httpclient.InferInput("INPUT0", [4], "FP32")
    inp.set_data_from_numpy(np.arange(4, dtype=np.float32))
    return inp


def test_profiling_toggle_and_sampler_answer_as_the_reference(servers):
    for side in SIDES:
        port = servers[side].http_port
        status, body, _ = _raw(port, "POST", "/v2/debug/profiling", {"stage_cpu": True})
        assert status == 200 and json.loads(body)["stage_cpu"] is True
        _traffic(servers[side].http_url)
        assert json.loads(_raw(port, "GET", "/v2/debug/profiling")[1])["stage_cpu"] is True
        assert _raw(port, "POST", "/v2/debug/profiling", {"stage_cpu": "on"})[0] == 400
        assert _raw(port, "POST", "/v2/debug/profiling", {"other": 1})[0] == 400
        _raw(port, "POST", "/v2/debug/profiling", {"stage_cpu": False})
        stages = metrics.parse_exposition(_raw(port, "GET", "/metrics")[1].decode())
        booked = {s.labels["stage"] for s in stages["tpu_request_cpu_seconds"].samples
                  if s.name.endswith("_count") and s.value > 0}
        assert {"frontend_decode", "compute", "readback", "package", "encode"} <= booked
        status, body, headers = _raw(port, "GET", "/v2/debug/profile?duration_s=0.2&hz=50")
        assert status == 200 and int(headers["X-Profile-Samples"]) > 0
        assert all(line.rsplit(" ", 1)[1].isdigit() for line in body.decode().splitlines())
        status, body, _ = _raw(port, "GET", "/v2/debug/profile?duration_s=0.1&format=speedscope")
        assert status == 200 and json.loads(body)["profiles"][0]["type"] == "sampled"
        for bad in ("duration_s=0", "hz=5000", "format=svg", "jax_trace_dir=/"):
            assert _raw(port, "GET", f"/v2/debug/profile?{bad}")[0] == 400, (side, bad)
    booked_device_put = [s for s in stages["tpu_request_cpu_seconds"].samples
                         if s.labels.get("stage") == "device_put" and s.name.endswith("_count")]
    assert booked_device_put and booked_device_put[0].value > 0  # the port's H2D copies


def test_torch_profiler_capture_writes_a_chrome_trace_in_the_temp_dir(servers):
    port = servers["torch"].http_port
    trace_dir = os.path.join(tempfile.gettempdir(), f"ctt_trace_{uuid.uuid4().hex}")
    box = {}

    def profile():
        box["answer"] = _raw(port, "GET", f"/v2/debug/profile?duration_s=1.0&jax_trace_dir={trace_dir}")

    thread = threading.Thread(target=profile)
    thread.start()
    try:
        time.sleep(0.3)  # the 1 s run has started
        _traffic(servers["torch"].http_url)
        assert _raw(port, "GET", "/v2/debug/profile?duration_s=0.1")[0] == 409
    finally:
        thread.join(60)
    status, _, headers = box["answer"]
    assert status == 200
    path = headers["X-Device-Trace"]
    assert os.path.dirname(path) == os.path.realpath(trace_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events  # CPU activity (the card adds CUDA kernel events)
    for name in os.listdir(trace_dir):
        os.remove(os.path.join(trace_dir, name))
    os.rmdir(trace_dir)


def test_lints_find_nothing_in_the_port():
    source = (ROOT / "client_tpu_torch" / "server" / "metrics.py").read_text()
    assert metric_lint.check_source(source, "server/metrics.py") == []
    files = sorted((ROOT / "client_tpu_torch" / "observability").glob("*.py"))
    assert {f.name for f in files} >= {"metrics.py", "window.py", "slo.py", "recorder.py",
                                       "logging.py", "server.py", "profiling.py", "trace.py"}
    # the reference's clock lint pins its multiplexer too (TARGET_FILES),
    # and covers the engine, its recovery, the resilience layer, the
    # sharded executor, the pod and the router (TARGET_DIRS llm/,
    # resilience/, parallel/, pod/ and router/)
    engine_and_resilience = sorted((ROOT / "client_tpu_torch" / "llm").glob("*.py")) + sorted(
        (ROOT / "client_tpu_torch" / "resilience").glob("*.py")) + sorted(
        (ROOT / "client_tpu_torch" / "parallel").glob("*.py")) + sorted(
        (ROOT / "client_tpu_torch" / "pod").glob("*.py")) + sorted(
        (ROOT / "client_tpu_torch" / "router").glob("*.py"))
    assert {f.name for f in engine_and_resilience} >= {"recovery.py", "chaos.py", "engine.py",
                                                       "executor.py", "worker.py", "bus.py",
                                                       "core.py", "backends.py"}
    for path in files + engine_and_resilience + [
            ROOT / "client_tpu_torch" / "perf" / "metrics_collector.py",
            ROOT / "client_tpu_torch" / "grpc" / "_mux.py"]:
        assert clock_lint.check_source(path.read_text(), str(path)) == [], path.name
    # the structured-logging lint over the directories the reference's
    # covers in its own package: no bare print(), no stdlib logging
    for directory in ("server", "observability", "llm"):
        for path in sorted((ROOT / "client_tpu_torch" / directory).glob("*.py")):
            assert log_lint.check_source(path.read_text(), str(path)) == [], path.name
    # and the unused-import check over the whole port
    unused = []
    for path in sorted((ROOT / "client_tpu_torch").rglob("*.py")):
        if "_generated" in path.parts:
            continue
        source = path.read_text()
        unused += [(path.name, name, line) for name, line in
                   lint.unused_imports(ast.parse(source, filename=str(path)), source)]
    assert unused == []

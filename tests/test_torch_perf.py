"""The port's perf harness (``client_tpu_torch.perf``) against the JAX
package's (``client_tpu.perf``).

- The units, as ``tests/test_perf.py`` holds the reference's: records,
  the data loader, the sequence manager, the load managers and the
  profiler on the mock backend, the report writers, the prepared-request
  cache and the shared-memory data plane.
- Byte equality with the reference on the same inputs and seed: the
  loader's tensors, the CSV, the console and detailed reports and the
  profile export; the rate schedule and the random context draws.
- The CLI end to end, four ways: every pairing of harness and server
  (the port's and the JAX package's), ``simple`` over ``--shared-memory none``,
  ``system`` and ``tpu``: 0 errors, the same ``--json-summary`` keys,
  non-zero server compute time, no region left registered.
- ``LocalPerfBackend`` on the port's ``ServerCore``, and the OpenAI
  backend's stdlib SSE reader on scripted servers: keep-alive, chunked
  and connection-delimited bodies, one timestamp per event, ``[DONE]``.
- The observability flags (``--collect-metrics``, ``--metrics-url``,
  ``--metrics-interval``, ``--profile-server``, ``--stage-breakdown``,
  ``--trace-export-file``, ``--flamegraph-out``, ``--profile-hz``,
  ``--dump-slow-requests``, ``--log-file``) against the port's server
  print their report sections and write their files, and each
  package's harness reads the other's server.
- Every flag the port does not serve yet exits 2 and names its ROADMAP
  item.

Timing tests use a simulated clock or bounds no loaded host can miss.
"""

import asyncio
import base64
import csv
import json
import os
import re
import urllib.request

import numpy as np
import pytest

import client_tpu.perf.backend as jax_backend
import client_tpu.perf.cli as jax_cli
import client_tpu.perf.data as jax_data
import client_tpu.perf.load_manager as jax_lm
import client_tpu.perf.profiler as jax_profiler
import client_tpu.perf.records as jax_records
import client_tpu.perf.report as jax_report
import client_tpu.perf.sequence as jax_sequence
from client_tpu.testing import InProcessServer as JaxInProcessServer
from client_tpu_torch.http import InferenceServerClient
from client_tpu_torch.perf import backend, cli, data, profiler, records, report
from client_tpu_torch.perf.backend import LocalPerfBackend, MockPerfBackend
from client_tpu_torch.perf.data import DataLoader, ShmDataPlane
from client_tpu_torch.perf.load_manager import (
    ConcurrencyManager,
    PeriodicConcurrencyManager,
    RequestRateManager,
)
from client_tpu_torch.perf.profiler import InferenceProfiler
from client_tpu_torch.perf.sequence import SequenceManager
from client_tpu_torch.testing import InProcessServer
from client_tpu_torch.utils import InferenceServerException

META = {
    "name": "mock",
    "inputs": [{"name": "IN", "datatype": "FP32", "shape": [8]}],
    "outputs": [{"name": "OUT", "datatype": "FP32", "shape": [8]}],
}
# the reference's --json-summary keys for a KServe HTTP run
SUMMARY_KEYS = {
    "throughput", "p50_us", "p99_us", "count", "errors", "mode", "value",
    "rejected", "timeouts", "shed_rate", "goodput", "dropped_unavailable",
    "rerouted", "routing_policy", "hedges", "hedge_wins", "ejections",
}


def make_loader():
    loader = DataLoader(META)
    loader.generate_synthetic()
    return loader


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 10, 101])
def test_percentile_is_the_references_nearest_rank(n):
    values = sorted(np.random.default_rng(n).normal(size=n).tolist())
    for q in (0, 1, 25, 50, 90, 95, 99, 100):
        assert records.percentile(values, q) == jax_records.percentile(values, q)
    assert records.percentile([], 50) == 0.0


def _record_pairs(rng):
    """The same request records built in both packages: successes,
    failures with status tokens, retries, priorities and stages."""
    tokens = [None, "429", "StatusCode.RESOURCE_EXHAUSTED", "504", "503",
              "CONNECTION_ERROR", "400"]
    port, ref = [], []
    for i in range(60):
        start = int(rng.integers(0, 10**9))
        kwargs = dict(
            start_ns=start,
            end_ns=start + int(rng.integers(1, 5 * 10**7)),
            response_ns=[start + 1000 * k for k in range(int(rng.integers(1, 4)))],
            success=bool(i % 5),
            error_status=tokens[i % len(tokens)] if i % 5 == 0 else None,
            priority=int(i % 3),
            retries=int(i % 4 == 0),
            stages={"serialize": 1000 + i, "transport": 5000, "deserialize": 700}
            if i % 2 else None,
        )
        port.append(records.RequestRecord(**kwargs))
        ref.append(jax_records.RequestRecord(**kwargs))
    return port, ref


def test_compute_window_status_equals_the_references():
    port, ref = _record_pairs(np.random.default_rng(0))
    for window in ((0, 2 * 10**9), (2 * 10**8, 6 * 10**8), (0, 10)):
        got = records.compute_window_status(port, *window, (50, 90, 99))
        want = jax_records.compute_window_status(ref, *window, (50, 90, 99))
        assert got.__dict__ == want.__dict__
    # the reference test's case
    small = [
        records.RequestRecord(start_ns=0, end_ns=1_000_000, response_ns=[1_000_000]),
        records.RequestRecord(start_ns=0, end_ns=2_000_000, response_ns=[2_000_000]),
        records.RequestRecord(start_ns=0, end_ns=3_000_000, success=False),
    ]
    status = records.compute_window_status(small, 0, 1_000_000_000)
    assert status.request_count == 2 and status.error_count == 1
    assert status.throughput == pytest.approx(2.0)
    assert status.avg_latency_us == pytest.approx(1500.0)


# ---------------------------------------------------------------------------
# data loader: the reference's cases, tensors byte-equal to the reference's
# ---------------------------------------------------------------------------


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def _loader_cases(tmp_path):
    payload = np.arange(8, dtype=np.float32)
    (tmp_path / "dir").mkdir()
    (tmp_path / "dir" / "IN").write_bytes(payload.tobytes())
    (tmp_path / "bytes").mkdir()
    (tmp_path / "bytes" / "TEXT").write_bytes(b"hello world")
    mixed = {
        "name": "m",
        "inputs": [
            {"name": "A", "datatype": "FP32", "shape": [-1, 3]},
            {"name": "B", "datatype": "INT32", "shape": [-1, 4]},
            {"name": "C", "datatype": "UINT8", "shape": [-1, 2]},
            {"name": "D", "datatype": "BOOL", "shape": [-1, 5]},
            {"name": "E", "datatype": "BYTES", "shape": [-1, 2]},
            {"name": "F", "datatype": "FP16", "shape": [-1, -1]},
        ],
    }
    return {
        "synthetic": (META, {}, None),
        "synthetic_zero": (META, {}, "zero"),
        "synthetic_batched_mixed": (
            mixed, dict(batch_size=4, batched=True, shape_overrides={"F": [4, 6]},
                        seed=3), None),
        "shape_override": ({"name": "m", "inputs": [
            {"name": "IN", "datatype": "FP32", "shape": [-1]}]},
            dict(shape_overrides={"IN": [32]}), None),
        "json": (META, {}, _write(tmp_path, "a.json", {"data": [
            {"IN": [1.0] * 8}, {"IN": {"content": [2.0] * 8, "shape": [8]}}]})),
        "json_parameters": (META, {}, _write(tmp_path, "b.json", {"data": [
            {"IN": [1.0] * 8, "parameters": {"max_tokens": 7}}, {"IN": [2.0] * 8}]})),
        "json_multistream": (META, {}, _write(tmp_path, "c.json", {"data": [
            [{"IN": [1.0] * 8}, {"IN": [2.0] * 8}], [{"IN": [3.0] * 8}]]})),
        "json_b64": (META, {}, _write(tmp_path, "d.json", {"data": [{"IN": {
            "b64": base64.b64encode(payload.tobytes()).decode(), "shape": [8]}}]})),
        "json_bytes": ({"name": "m", "inputs": [
            {"name": "T", "datatype": "BYTES", "shape": [-1]}]}, {},
            _write(tmp_path, "e.json", {"data": [{"T": ["été", "b"]}, {"T": {
                "content": ["x"], "shape": [1]}}]})),
        "directory": (META, {}, str(tmp_path / "dir")),
        "directory_bytes": ({"name": "m", "inputs": [
            {"name": "TEXT", "datatype": "BYTES", "shape": [1]}]}, {},
            str(tmp_path / "bytes")),
    }


def _load(module, metadata, kwargs, source):
    loader = module.DataLoader(metadata, **kwargs)
    if source is None:
        loader.generate_synthetic()
    elif source == "zero":
        loader.generate_synthetic(zero_data=True)
    elif os.path.isdir(source):
        loader.read_from_dir(source)
    else:
        loader.read_from_json(source)
    return loader


@pytest.mark.parametrize("case", [
    "synthetic", "synthetic_zero", "synthetic_batched_mixed", "shape_override", "json",
    "json_parameters", "json_multistream", "json_b64", "json_bytes", "directory",
    "directory_bytes",
])
def test_dataloader_tensors_are_byte_equal_to_the_references(tmp_path, case):
    metadata, kwargs, source = _loader_cases(tmp_path)[case]
    port = _load(data, metadata, kwargs, source)
    ref = _load(jax_data, metadata, kwargs, source)
    assert port.stream_count == ref.stream_count
    for stream in range(port.stream_count):
        assert port.step_count(stream) == ref.step_count(stream)
        for step in range(port.step_count(stream)):
            assert port.cache_token(stream, step) == ref.cache_token(stream, step)
            assert port.get_parameters(stream, step) == ref.get_parameters(stream, step)
            got, want = port.get_inputs(stream, step), ref.get_inputs(stream, step)
            assert [(t.name, t.shape, t.datatype) for t in got] == [
                (t.name, t.shape, t.datatype) for t in want]
            for a, b in zip(got, want):
                assert a.data.dtype == b.data.dtype
                if a.datatype == "BYTES":
                    assert a.data.tolist() == b.data.tolist()
                else:
                    assert a.data.tobytes() == b.data.tobytes()


def test_dataloader_refuses_as_the_reference_does(tmp_path):
    dynamic = {"name": "m", "inputs": [{"name": "IN", "datatype": "FP32", "shape": [-1]}]}
    with pytest.raises(InferenceServerException, match="dynamic shape"):
        DataLoader(dynamic).generate_synthetic()
    (tmp_path / "IN").write_bytes(np.arange(8, dtype=np.float32).tobytes()[:-4])
    with pytest.raises(InferenceServerException, match="28 bytes"):
        DataLoader(META).read_from_dir(str(tmp_path))
    missing = {"name": "m", "inputs": [{"name": "MISSING", "datatype": "FP32", "shape": [1]}]}
    with pytest.raises(InferenceServerException, match="MISSING"):
        DataLoader(missing).read_from_dir(str(tmp_path))
    path = _write(tmp_path, "x.json", {"nodata": []})
    with pytest.raises(InferenceServerException, match="missing top-level 'data'"):
        DataLoader(META).read_from_json(path)
    path = _write(tmp_path, "y.json", {"data": [{"OTHER": [1.0]}]})
    with pytest.raises(InferenceServerException, match="unknown input 'OTHER'"):
        DataLoader(META).read_from_json(path)
    with pytest.raises(InferenceServerException, match="no input data loaded"):
        DataLoader(META).get_inputs()


def test_step_parameters_merge_into_the_issued_request(tmp_path):
    path = _write(tmp_path, "p.json", {"data": [
        {"IN": [1.0] * 8, "parameters": {"max_tokens": 7}}, {"IN": [2.0] * 8}]})
    loader = make_loader()
    loader.read_from_json(path)
    mock = MockPerfBackend()
    manager = ConcurrencyManager(mock, "mock", loader, parameters={"max_tokens": 1, "top_k": 3})

    async def run():
        await manager.issue_one(0, 0)
        await manager.issue_one(0, 1)

    asyncio.run(run())
    assert mock.requests[0]["parameters"] == {"max_tokens": 7, "top_k": 3}
    assert mock.requests[1]["parameters"] == {"max_tokens": 1, "top_k": 3}


# ---------------------------------------------------------------------------
# sequence manager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mean,variation,seed", [(3, 0, 0), (20, 20.0, 1), (5, 50.0, 9)])
def test_sequence_manager_steps_equal_the_references(mean, variation, seed):
    port = SequenceManager(length_mean=mean, length_variation_pct=variation, seed=seed)
    ref = jax_sequence.SequenceManager(length_mean=mean, length_variation_pct=variation,
                                       seed=seed)
    for i in range(200):
        slot = (i * 7) % 5
        assert port.next_step(slot) == ref.next_step(slot)
        assert port.rotate_stream(slot) == ref.rotate_stream(slot)
    assert port.active_sequences() == ref.active_sequences()


def test_sequence_manager_flags_and_unique_ids():
    manager = SequenceManager(length_mean=3, length_variation_pct=0)
    first = manager.next_step(0)
    assert first["sequence_start"] and not first["sequence_end"]
    mid = manager.next_step(0)
    assert not mid["sequence_start"] and not mid["sequence_end"]
    assert manager.next_step(0)["sequence_end"]
    fresh = manager.next_step(0)
    assert fresh["sequence_start"] and fresh["sequence_id"] != first["sequence_id"]
    manager = SequenceManager(length_mean=2, length_variation_pct=0)
    assert len({manager.next_step(slot)["sequence_id"] for slot in range(8)}) == 8


# ---------------------------------------------------------------------------
# load managers on the mock backend
# ---------------------------------------------------------------------------


def test_concurrency_manager_maintains_inflight_and_shrinks():
    async def run():
        mock = MockPerfBackend(latency_s=0.02)
        manager = ConcurrencyManager(mock, "mock", make_loader())
        await manager.change_concurrency(8)
        while mock.request_count < 16:
            await asyncio.sleep(0.01)
        full = mock.max_inflight
        await manager.change_concurrency(1)
        mock.max_inflight = 0
        start = mock.request_count
        while mock.request_count < start + 4:
            await asyncio.sleep(0.01)
        await manager.stop()
        return full, mock.max_inflight

    full, shrunk = asyncio.run(run())
    assert full == 8
    assert shrunk == 1


def test_errors_are_recorded_and_the_error_rate_aborts():
    async def run(max_error_rate):
        mock = MockPerfBackend(latency_s=0.001, error_every=3)
        manager = ConcurrencyManager(mock, "mock", make_loader(),
                                     max_error_rate=max_error_rate, min_error_sample=6)
        await manager.change_concurrency(2)
        while manager.issued_total < 12:
            await asyncio.sleep(0.005)
        try:
            manager.check_health()
            return manager, None
        except InferenceServerException as e:
            return manager, e
        finally:
            await manager.stop()

    manager, error = asyncio.run(run(None))
    failed = [r for r in manager.records if not r.success]
    assert failed and "mock injected failure" in failed[0].error and error is None
    _, error = asyncio.run(run(0.1))
    assert error is not None and "exceeds the configured threshold" in str(error)


def test_streaming_records_every_response():
    async def run():
        mock = MockPerfBackend(latency_s=0.01, responses_per_request=5)
        manager = ConcurrencyManager(mock, "mock", make_loader(), streaming=True)
        await manager.change_concurrency(1)
        while not any(r.success for r in manager.records):
            await asyncio.sleep(0.005)
        await manager.stop()
        return manager

    done = [r for r in asyncio.run(run()).records if r.success]
    assert len(done[0].response_ns) == 5
    assert done[0].response_ns == sorted(done[0].response_ns)


def test_periodic_concurrency_ramp():
    async def run():
        mock = MockPerfBackend(latency_s=0.005)
        manager = PeriodicConcurrencyManager(mock, "mock", make_loader(), start=1, end=4,
                                             step=1, request_period=5)
        await manager.run()
        return mock, manager

    mock, manager = asyncio.run(run())
    assert mock.max_inflight >= 3
    assert len(manager.records) >= 20  # 4 periods of >= 5 requests


class _SimulatedClock:
    """A clock that jumps to where the rate schedule sleeps to."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    async def sleep(self, delay):
        self.now += delay
        await asyncio.sleep(0)


def _run_schedule(manager, rate, seconds):
    clock = _SimulatedClock()
    manager.clock, manager.sleep = clock, clock.sleep

    async def run():
        await manager.change_rate(rate)
        while clock.now < seconds:
            await asyncio.sleep(0)
        await manager.stop()

    asyncio.run(run())
    return sorted(manager.records, key=lambda r: r.start_ns)


def test_constant_rate_fires_on_schedule():
    manager = RequestRateManager(MockPerfBackend(latency_s=0.0), "mock", make_loader())
    fired = _run_schedule(manager, 200.0, 1.0)
    assert 200 <= len(fired) <= 202
    assert manager.schedule_slip_ns == 0


def test_poisson_schedule_is_the_references():
    """The same seed draws the same exponential intervals as the
    reference; the dispatches in one simulated second are exactly the
    reference's intervals that fit in it."""
    manager = RequestRateManager(MockPerfBackend(latency_s=0.0), "mock", make_loader(),
                                 distribution="poisson", seed=5)
    ref = jax_lm.RequestRateManager(jax_backend.MockPerfBackend(), "mock",
                                    jax_data.DataLoader(META), distribution="poisson", seed=5)
    ref_intervals = ref._intervals(300.0)
    port_intervals = RequestRateManager(MockPerfBackend(), "mock", make_loader(),
                                        distribution="poisson", seed=5)._intervals(300.0)
    gaps = [next(ref_intervals) for _ in range(2000)]
    assert [next(port_intervals) for _ in range(2000)] == gaps
    assert np.std(gaps) > 0.5 * np.mean(gaps)  # exponential, not constant
    fired = _run_schedule(manager, 300.0, 1.0)
    due = int(np.sum(np.cumsum([0.0] + gaps) <= 1.0))
    assert due <= len(fired) <= due + 1


def test_rate_mode_draws_contexts_as_the_reference():
    manager = RequestRateManager(MockPerfBackend(latency_s=0.0), "mock", make_loader(),
                                 seed=7, num_sequence_slots=4)
    fired = _run_schedule(manager, 2000.0, 0.5)
    # request ids count up in dispatch order
    seen = [r.ctx_id for r in sorted(fired, key=lambda r: int(r.request_id))]
    ref = jax_lm.RequestRateManager(jax_backend.MockPerfBackend(), "mock",
                                    jax_data.DataLoader(META), seed=7, num_sequence_slots=4)
    want = [int(ref._ctx_rng.integers(4)) for _ in range(len(seen))]
    assert len(seen) > 900
    assert seen == want
    assert set(seen) == {0, 1, 2, 3}


def test_custom_intervals_replay_and_stop():
    async def run():
        mock = MockPerfBackend(latency_s=0.0)
        manager = RequestRateManager(mock, "mock", make_loader())
        prof = InferenceProfiler(manager, measurement_interval_s=0.05, stability_pct=100.0,
                                 max_trials=3)
        return await prof.profile_custom_intervals([0.002, 0.004])

    (experiment,) = asyncio.run(run())
    assert experiment.mode == "custom_intervals"
    assert experiment.value == pytest.approx(1 / 0.003)


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------


def test_profiler_stability_and_sweep():
    async def run():
        manager = ConcurrencyManager(MockPerfBackend(latency_s=0.002), "mock", make_loader())
        prof = InferenceProfiler(manager, measurement_interval_s=0.15, stability_pct=100.0,
                                 max_trials=4)
        return await prof.profile_concurrency_range(1, 2, 1)

    experiments = asyncio.run(run())
    assert [e.status.concurrency for e in experiments] == [1, 2]
    assert experiments[0].status.request_count > 0
    assert 50 in experiments[0].status.latency_percentiles_us
    assert all(r.success for e in experiments for r in e.records)


def test_profiler_latency_threshold_stops_sweep():
    async def run():
        manager = ConcurrencyManager(MockPerfBackend(latency_s=0.02), "mock", make_loader())
        prof = InferenceProfiler(manager, measurement_interval_s=0.1, stability_pct=100.0,
                                 max_trials=3, latency_threshold_us=1000.0)
        return await prof.profile_concurrency_range(1, 8, 1)

    assert len(asyncio.run(run())) == 1  # 20 ms > 1 ms: stopped after the first point


def test_profiler_stability_rule_is_the_references():
    """_is_stable and _merge on the same windows give the reference's
    verdicts and merged numbers."""
    port_prof = InferenceProfiler(None, stability_pct=10.0, latency_threshold_us=5000.0,
                                  stability_percentile=99)
    ref_prof = jax_profiler.InferenceProfiler(None, stability_pct=10.0,
                                              latency_threshold_us=5000.0,
                                              stability_percentile=99)
    rng = np.random.default_rng(3)
    for trial in range(40):
        spread = 0.02 if trial % 2 else 0.4
        windows = []
        for _ in range(3):
            kwargs = dict(
                request_count=int(rng.integers(0 if trial == 7 else 1, 100)),
                throughput=100 * (1 + spread * rng.normal()),
                avg_latency_us=3000 * (1 + spread * rng.normal()),
                latency_percentiles_us={50: 2900.0, 99: 4000 * (1 + spread * rng.normal())},
                server_queue_us=float(rng.random()),
                traced_count=int(rng.integers(0, 3)),
                client_transport_us=float(rng.random()),
            )
            windows.append((records.PerfStatus(**kwargs), jax_records.PerfStatus(**kwargs)))
        assert port_prof._is_stable([w[0] for w in windows]) == ref_prof._is_stable(
            [w[1] for w in windows])
        assert port_prof._merge([w[0] for w in windows]).__dict__ == ref_prof._merge(
            [w[1] for w in windows]).__dict__


def test_profiler_count_windows_end_at_the_request_count():
    async def run():
        manager = ConcurrencyManager(MockPerfBackend(latency_s=0.001), "mock", make_loader())
        await manager.change_concurrency(4)
        prof = InferenceProfiler(manager, measurement_interval_s=60.0, count_windows=True,
                                 measurement_request_count=40, stability_pct=100.0,
                                 max_trials=3)
        status, _ = await prof.profile_point()
        await manager.stop()
        return status

    assert asyncio.run(run()).request_count >= 40  # far inside the 3 x 60 s cap


def test_profiler_binary_search_converges():
    async def run(threshold_us):
        manager = ConcurrencyManager(MockPerfBackend(latency_s=0.002), "mock", make_loader())
        prof = InferenceProfiler(manager, measurement_interval_s=0.03, stability_pct=100.0,
                                 max_trials=3, latency_threshold_us=threshold_us)
        await prof.profile_concurrency_binary(1, 8)
        await manager.stop()
        return prof.experiments, prof.binary_search_answer()

    experiments, answer = asyncio.run(run(1e9))
    assert len(experiments) >= 2 and answer is not None and answer.value == 8
    _, answer = asyncio.run(run(1.0))
    assert answer is None


def test_profiler_request_rate_binary():
    async def run():
        manager = RequestRateManager(MockPerfBackend(latency_s=0.001), "mock", make_loader())
        prof = InferenceProfiler(manager, measurement_interval_s=0.03, stability_pct=100.0,
                                 max_trials=3, latency_threshold_us=1e9)
        probes = await prof.profile_request_rate_binary(1, 64)
        return probes, prof.binary_search_answer()

    probes, answer = asyncio.run(run())
    assert probes and all(p.mode == "request_rate" for p in probes)
    assert answer is not None and answer.value == 64


# ---------------------------------------------------------------------------
# reports: byte-equal to the reference's
# ---------------------------------------------------------------------------


def _experiments(module_records, module_profiler, mode):
    rng = np.random.default_rng(11)
    out = []
    for i, value in enumerate((1, 4, 16)):
        status = module_records.PerfStatus(
            concurrency=value, request_count=100 + i, error_count=i, retry_count=i,
            throughput=1234.5678 / (i + 1), response_throughput=2000.25,
            avg_latency_us=812.75 * (i + 1), std_latency_us=33.3,
            latency_percentiles_us={50: 700.4, 90: 900.6, 95: 950.5, 99: 1200.49 + i},
            server_queue_us=12.6, server_compute_infer_us=400.4 + i,
            server_compute_input_us=3.5, server_compute_output_us=7.49,
            traced_count=i, client_serialize_us=5.5, client_transport_us=650.25,
            client_deserialize_us=4.75, rejected_count=i, timeout_count=1,
            shed_rate=0.01 * i, unavailable_count=i, rerouted_count=1,
            per_priority_latency_us={1: {"count": 3, "avg": 500.0, 50: 480.0, 99: 700.0}}
            if i == 2 else {},
            window_start_ns=10**9 * i, window_end_ns=10**9 * (i + 1),
        )
        reqs = [module_records.RequestRecord(
            start_ns=int(s), end_ns=int(s) + 5000, response_ns=[int(s) + 4000, int(s) + 5000],
            sequence_id=k % 3, success=bool(k % 4)) for k, s in
            enumerate(rng.integers(0, 10**9, 5))]
        out.append(module_profiler.ProfileExperiment(mode=mode, value=value, status=status,
                                                     records=reqs))
    return out


@pytest.mark.parametrize("mode", ["concurrency", "request_rate"])
def test_report_writers_are_byte_equal_to_the_references(tmp_path, mode):
    port = _experiments(records, profiler, mode)
    ref = _experiments(jax_records, jax_profiler, mode)
    assert report.console_report(port) == jax_report.console_report(ref)
    for a, b in zip(port, ref):
        assert report.detailed_report(a) == jax_report.detailed_report(b)
        assert report.format_scheduling(a.status) == jax_report.format_scheduling(b.status)
        assert report.format_lifecycle(a.status) == jax_report.format_lifecycle(b.status)
    report.write_csv(port, str(tmp_path / "port.csv"))
    jax_report.write_csv(ref, str(tmp_path / "ref.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    header = (tmp_path / "port.csv").read_text().splitlines()[0]
    assert header.startswith("Concurrency," if mode == "concurrency" else "Request Rate,")
    report.export_profile(port, str(tmp_path / "port.json"), endpoint="h:1")
    jax_report.export_profile(ref, str(tmp_path / "ref.json"), endpoint="h:1")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert report.format_shm_delta(900, 1000, 4096) == jax_report.format_shm_delta(900, 1000,
                                                                                  4096)
    snapshot = {"request_count": 5, "error_count": 1, "retry_count": 2,
                "avg_latency_us": 10.0, "latency_histogram_us": [
                    {"le_us": 100, "count": 3}, {"le_us": "inf", "count": 5}]}
    pool = {"policy": "p2c", "primary": "a", "endpoints": [
        {"url": "a:1", "outstanding": 1, "ewma_latency_us": 5.0, "successes": 4,
         "errors": 0, "reroutes": 0}], "hedges": 1}
    assert report.format_client_metrics(snapshot, pool) == jax_report.format_client_metrics(
        snapshot, pool)
    assert report.format_client_metrics(None) == jax_report.format_client_metrics(None)


# ---------------------------------------------------------------------------
# prepared-request reuse
# ---------------------------------------------------------------------------


class _PreparedMockBackend(MockPerfBackend):
    supports_prepared = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.tokens = []
        self.prepared = set()
        self.empty_input_hits = 0

    def has_prepared(self, cache_token):
        return cache_token in self.prepared

    async def infer(self, model_name, inputs, cache_token=None, **kwargs):
        if cache_token is not None:
            self.tokens.append(cache_token)
            if cache_token in self.prepared and len(inputs) == 0:
                self.empty_input_hits += 1
            self.prepared.add(cache_token)
        return await super().infer(model_name, inputs, **kwargs)


@pytest.mark.parametrize("case", ["reuse", "sequences", "kill_switch"])
def test_prepared_cache(case, monkeypatch):
    if case == "kill_switch":
        monkeypatch.setenv("CTPU_PERF_NO_PREPARED_CACHE", "1")

    async def run():
        mock = _PreparedMockBackend(latency_s=0.001)
        sequences = SequenceManager(length_mean=3) if case == "sequences" else None
        manager = ConcurrencyManager(mock, "mock", make_loader(), sequence_manager=sequences)
        await manager.change_concurrency(4)
        while mock.request_count < 24:
            await asyncio.sleep(0.005)
        await manager.stop()
        return mock

    mock = asyncio.run(run())
    if case == "reuse":
        assert len(set(mock.tokens)) == 1  # one corpus coordinate
        assert mock.empty_input_hits == len(mock.tokens) - 1
    else:
        assert mock.tokens == []


# ---------------------------------------------------------------------------
# shared-memory data plane
# ---------------------------------------------------------------------------


# ids avoid the bare word "tpu": tests/conftest.py skips items with that
# keyword unless a TPU is present
@pytest.mark.parametrize("kind", ["system", "tpu"], ids=["system_regions", "tpu_regions"])
def test_shm_data_plane_stages_registers_and_cleans_up(kind):
    mock = MockPerfBackend()

    async def run():
        loader = DataLoader(await mock.get_model_metadata("mock"))
        loader.generate_synthetic()
        planes = [ShmDataPlane(loader, mock, kind=kind) for _ in range(2)]
        await planes[0].setup()
        (reg,) = mock.shm_registrations
        assert reg["kind"] == kind and reg["byte_size"] == 32  # FP32[8]
        # names carry the pid and a uuid: /dev/shm is shared by every run
        assert re.fullmatch(rf"ctpu_pyperf_{os.getpid()}_[0-9a-f]{{8}}_s0_t0_IN",
                            reg["name"])
        assert planes[0]._prefix != planes[1]._prefix
        if kind == "tpu":
            handle = json.loads(bytes(reg["raw_handle"]).decode())
            assert handle["kind"] == "tpu-host-pinned"
            assert handle["byte_size"] == 32
        else:
            assert reg["key"] == f"/{reg['name']}"
        (inp,) = planes[0].get_inputs(0, 0)
        assert inp.shm_region == reg["name"] and inp.shm_byte_size == 32
        await planes[0].cleanup()
        assert mock.shm_unregistrations == [reg["name"]]

    asyncio.run(run())
    with pytest.raises(InferenceServerException, match="unsupported shared-memory kind"):
        ShmDataPlane(make_loader(), mock, kind="cuda")


# ---------------------------------------------------------------------------
# the CLI end to end: every pairing of harness and server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxInProcessServer(grpc=False).start()
    port_server = InProcessServer(device="cpu").start()
    yield {"jax": jax_server, "port": port_server}
    port_server.stop()
    jax_server.stop()


HARNESSES = {"port": cli.main, "jax": jax_cli.main}


@pytest.mark.parametrize("shm", ["none", "system", "tpu"],
                         ids=["shm_none", "shm_system", "shm_tpu"])
@pytest.mark.parametrize("harness,server", [("port", "port"), ("port", "jax"),
                                            ("jax", "port"), ("jax", "jax")])
def test_cli_end_to_end(servers, harness, server, shm, tmp_path, capsys):
    url = servers[server].http_url
    csv_path, export_path = tmp_path / "out.csv", tmp_path / "profile.json"
    code = HARNESSES[harness]([
        "-m", "simple", "-u", url, "--concurrency-range", "2",
        "--measurement-interval", "150", "--stability-percentage", "100",
        "--max-trials", "3", "--shared-memory", shm, "-f", str(csv_path),
        "--profile-export-file", str(export_path), "--json-summary",
    ])
    out = capsys.readouterr().out
    assert code == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert set(summary) == SUMMARY_KEYS
    assert summary["errors"] == 0 and summary["count"] > 0
    (row,) = list(csv.DictReader(csv_path.open()))
    assert float(row["Server Compute Infer"]) > 0
    requests = json.loads(export_path.read_text())["experiments"][0]["requests"]
    assert requests and all(r["success"] for r in requests)
    with InferenceServerClient(url) as client:
        assert client.get_system_shared_memory_status() == []
        assert client.get_tpu_shared_memory_status() == []


def test_cli_request_rate_and_csv_parse_across_packages(servers, tmp_path, capsys):
    """An open-load run: the port's CSV and export read back through the
    reference's own row and profile formats."""
    path = tmp_path / "rate.csv"
    code = cli.main(["-m", "simple", "-u", servers["port"].http_url,
                     "--request-rate-range", "100", "--request-distribution", "poisson",
                     "--measurement-interval", "200", "--stability-percentage", "100",
                     "--max-trials", "3", "-f", str(path), "--json-summary"])
    assert code == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mode"] == "request_rate" and summary["value"] == 100
    assert summary["errors"] == 0
    assert path.read_text().startswith("Request Rate,Inferences/Second,Client Send/Recv")


# ---------------------------------------------------------------------------
# the in-process backend
# ---------------------------------------------------------------------------


def test_local_backend_profiles_the_ports_core(servers):
    server = servers["port"]

    async def run():
        local = LocalPerfBackend(server.core)
        config = await local.get_model_config("simple")
        loader = DataLoader(await local.get_model_metadata("simple"),
                            batched=config["max_batch_size"] > 0)
        loader.generate_synthetic()
        manager = ConcurrencyManager(local, "simple", loader)
        prof = InferenceProfiler(manager, measurement_interval_s=0.1, stability_pct=100.0,
                                 max_trials=3)
        (experiment,) = await prof.profile_concurrency_range(2, 2)
        errors = []
        for call in (local.unload_model, local.load_model):
            with pytest.raises(InferenceServerException, match="item 3c") as info:
                await call("simple")
            errors.append(str(info.value))
        return experiment, errors

    future = asyncio.run_coroutine_threadsafe(run(), server._loop)
    experiment, _ = future.result(60)
    assert experiment.status.request_count > 0 and experiment.status.error_count == 0
    # the profiler read the port's statistics schema: non-zero deltas
    assert experiment.status.server_compute_infer_us > 0
    assert experiment.status.server_queue_us > 0


# ---------------------------------------------------------------------------
# the OpenAI backend's stdlib reader, on scripted servers
# ---------------------------------------------------------------------------


def _sse(doc):
    return b"data: " + json.dumps(doc).encode() + b"\n\n"


TOKEN = {"choices": [{"delta": {"content": "w"}, "finish_reason": None}]}
FINISH = {"choices": [{"delta": {}, "finish_reason": "stop"}]}


async def _scripted(handler):
    """A loopback server whose every connection runs ``handler``; returns
    (server, port, connection count list)."""
    accepted = []

    async def on_connect(reader, writer):
        accepted.append(writer)
        try:
            await handler(reader, writer)
        finally:
            writer.close()

    server = await asyncio.start_server(on_connect, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], accepted


async def _read_request(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    length = int(re.search(rb"Content-Length: (\d+)", head).group(1))
    return head, await reader.readexactly(length)


def _payload_input(max_tokens=3):
    body = json.dumps({"model": "m", "messages": [{"role": "user", "content": "hi"}],
                       "max_tokens": max_tokens})
    return [backend.PerfInferInput("payload", [1], "BYTES",
                                   np.array([body.encode()], dtype=object))]


@pytest.mark.parametrize("framing", ["chunked", "length", "close"])
def test_openai_stream_is_read_event_by_event(framing):
    """Three token events, a finish chunk and [DONE]. The server writes
    the next token event only after the backend has counted the one
    before, so a reader that waited for the end of the body would stall
    it; keep-alive connections are reused, closed ones are not."""
    events = [_sse(TOKEN)] * 3 + [_sse(FINISH), b"data: [DONE]\n\n"]

    async def run():
        counted = asyncio.Queue()

        async def handler(reader, writer):
            while True:
                try:
                    _, body = await _read_request(reader)
                except asyncio.IncompleteReadError:
                    return
                assert json.loads(body)["stream"] is True
                head = b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                if framing == "chunked":
                    writer.write(head + b"Transfer-Encoding: chunked\r\n\r\n")
                elif framing == "length":
                    writer.write(head + b"Content-Length: %d\r\n\r\n" % sum(map(len, events)))
                else:
                    writer.write(head + b"Connection: close\r\n\r\n")
                for event in events:
                    if framing == "chunked":
                        event = b"%x\r\n%s\r\n" % (len(event), event)
                    writer.write(event)
                    await writer.drain()
                    if event.find(b'"content"') >= 0:
                        await asyncio.wait_for(counted.get(), 10)
                if framing == "chunked":
                    writer.write(b"0\r\n\r\n")
                await writer.drain()
                if framing == "close":
                    return

        server, port, accepted = await _scripted(handler)
        client = backend.OpenAiPerfBackend(f"127.0.0.1:{port}")
        counts = []
        try:
            for _ in range(2):
                counts.append([])
                await client.stream_infer("m", _payload_input(),
                                          lambda c=counts[-1]: (c.append(1),
                                                                counted.put_nowait(1)))
        finally:
            await client.close()
            server.close()
            await server.wait_closed()
        return counts, len(accepted)

    counts, connections = asyncio.run(run())
    assert [len(c) for c in counts] == [3, 3]
    assert connections == (2 if framing == "close" else 1)


@pytest.mark.parametrize("script,match", [
    ([_sse(TOKEN), _sse(FINISH)], "without 'data: \\[DONE\\]'"),
    ([_sse(TOKEN), _sse({"error": {"message": "boom"}}), b"data: [DONE]\n\n"],
     "openai stream error: boom"),
])
def test_openai_stream_faults_fail_the_request(script, match):
    async def handler(reader, writer):
        await _read_request(reader)
        writer.write(b"HTTP/1.1 200 OK\r\nConnection: close\r\n\r\n" + b"".join(script))
        await writer.drain()

    async def run():
        server, port, _ = await _scripted(handler)
        client = backend.OpenAiPerfBackend(f"127.0.0.1:{port}")
        try:
            await client.stream_infer("m", _payload_input(), lambda: None)
        finally:
            await client.close()
            server.close()
            await server.wait_closed()

    with pytest.raises(InferenceServerException, match=match):
        asyncio.run(run())


def test_openai_transport_errors_are_inference_server_exceptions():
    async def cut(reader, writer):
        await _read_request(reader)
        writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n5\r\nda")
        await writer.drain()

    async def status_500(reader, writer):
        await _read_request(reader)
        writer.write(b"HTTP/1.1 500 Oops\r\nContent-Length: 4\r\n\r\nbad!")
        await writer.drain()

    async def run(handler, call):
        server, port, _ = await _scripted(handler)
        client = backend.OpenAiPerfBackend(f"127.0.0.1:{port}")
        try:
            await call(client)
        finally:
            await client.close()
            server.close()
            await server.wait_closed()

    for handler, match in ((cut, "failed"), (status_500, "HTTP 500")):
        for call in (lambda c: c.infer("m", _payload_input()),
                     lambda c: c.stream_infer("m", _payload_input(), lambda: None)):
            with pytest.raises(InferenceServerException, match=match):
                asyncio.run(run(handler, call))
    assert backend.OpenAiPerfBackend.sse_event_is_token(b'{"choices": [{"text": "a"}]}')
    assert not backend.OpenAiPerfBackend.sse_event_is_token(json.dumps(FINISH).encode())
    assert backend.OpenAiPerfBackend.sse_event_is_token(b"not json")


# ---------------------------------------------------------------------------
# refused flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,item", [
    (["-i", "grpc"], "item 4"),
    (["--stream-mode"], "item 4"),
    (["--service-kind", "tfserving"], "item 3d"),
    (["--service-kind", "torchserve"], "item 3d"),
    (["--metrics-url", "localhost:8000,localhost:8001"], "item 7"),
    (["--fleet", "2"], "items 3c and 7"),
    (["--rolling-restart", "1"], "items 3c and 7"),
    (["--world-size", "2"], "item 7"),
])
def test_unported_flags_are_refused(flags, item, capsys):
    assert cli.main(["-m", "simple", "-u", "127.0.0.1:9"] + flags) == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1
    assert err.startswith("error: ") and f"ROADMAP Queue 1 {item}" in err
    assert cli.build_parser().parse_args(["-m", "x"] + flags)  # parsed, then refused


# ---------------------------------------------------------------------------
# the observability flags, served by the port's server
# ---------------------------------------------------------------------------


def _run_observed(harness, url, flags, capsys):
    code = harness(["-m", "simple", "-u", url, "--concurrency-range", "2",
                    "--measurement-interval", "150", "--stability-percentage", "100",
                    "--max-trials", "3", "--json-summary"] + flags)
    out = capsys.readouterr().out
    assert code == 0, out
    return out, json.loads(out.strip().splitlines()[-1])


def _file_check(kind):
    def check(path, out, summary):
        text = path.read_text()
        if kind == "spans":
            assert all(json.loads(line)["trace_id"] for line in text.splitlines())
        elif kind == "collapsed":
            lines = text.splitlines()
            assert lines and all(line.rsplit(" ", 1)[1].isdigit() for line in lines)
        else:
            events = [json.loads(line)["event"] for line in text.splitlines()]
            assert events[0] == "run_started" and events[-1] == "run_finished"
            assert "slow_request" in events
    return check


@pytest.mark.parametrize("flags,section,file_kind", [
    (["--collect-metrics"], "Server metrics (", None),
    (["--metrics-url", "{url}"], "Server metrics (", None),
    (["--collect-metrics", "--metrics-interval", "0.05"], "Server metrics (", None),
    (["--profile-server"], "Wire-gap attribution", None),
    (["--stage-breakdown"], "Client metrics", None),
    (["--trace-export-file", "{path}"], "Client metrics", "spans"),
    (["--flamegraph-out", "{path}"], "wrote server flamegraph", "collapsed"),
    (["--flamegraph-out", "{path}", "--profile-hz", "50"], "wrote server flamegraph",
     "collapsed"),
    (["--dump-slow-requests", "3"], "Slowest requests (server flight recorder):", None),
    (["--log-file", "{path}", "--dump-slow-requests", "2"], "Slowest requests", "log"),
], ids=["collect", "metrics_url", "interval", "profile_server", "stage_breakdown",
        "trace_export", "flamegraph", "profile_hz", "slow_requests", "log_file"])
def test_observability_flags_against_the_ports_server(servers, flags, section, file_kind,
                                                       tmp_path, capsys):
    url = servers["port"].http_url
    path = tmp_path / "out.txt"
    flags = [f.format(url=url, path=path) for f in flags]
    out, summary = _run_observed(cli.main, url, flags, capsys)
    assert section in out
    if "Server metrics (" in out:
        block = out.split("Server metrics (", 1)[1]
        assert "Requests: " in block and " 0 failed" in block
        assert "server_duty_avg" in summary and summary["server_batch_avg"] >= 1
    if "--profile-server" in flags or "--flamegraph-out" in flags:
        assert {"frontend_decode", "compute", "encode"} <= summary["server_stage_cpu_us"].keys()
        with urllib.request.urlopen(f"http://{url}/v2/debug/profiling") as answer:
            assert json.load(answer)["stage_cpu"] is False  # the toggle was restored
    if file_kind is not None:
        _file_check(file_kind)(path, out, summary)


@pytest.mark.parametrize("harness,server", [("jax", "port"), ("port", "jax")])
def test_observability_flags_cross_the_packages(servers, harness, server, capsys):
    """Each package's harness reads the other's /metrics, debug and
    profiling routes."""
    out, summary = _run_observed(HARNESSES[harness], servers[server].http_url,
                                 ["--profile-server", "--dump-slow-requests", "2"], capsys)
    for section in ("Server metrics (", "Wire-gap attribution", "Slowest requests"):
        assert section in out
    assert summary["server_batch_avg"] >= 1 and summary["server_stage_cpu_us"]["compute"] > 0


def test_every_reference_flag_is_parsed():
    port_flags = {o for a in cli.build_parser()._actions for o in a.option_strings}
    ref_flags = {o for a in jax_cli.build_parser()._actions for o in a.option_strings}
    assert port_flags == ref_flags


def test_world_size_from_the_environment_is_refused(monkeypatch, capsys):
    monkeypatch.setenv("CTPU_WORLD_SIZE", "4")
    assert cli.main(["-m", "simple"]) == 2
    assert "item 7" in capsys.readouterr().err


def test_create_backend_kinds():
    assert isinstance(backend.create_backend("mock"), MockPerfBackend)
    assert isinstance(backend.create_backend("openai", "h:1"), backend.OpenAiPerfBackend)
    with pytest.raises(InferenceServerException, match="requires an in-process ServerCore"):
        backend.create_backend("local")
    for kind in ("grpc", "tfserving", "torchserve", "nope"):
        with pytest.raises(InferenceServerException, match="unknown backend kind"):
            backend.create_backend(kind, "h:1")

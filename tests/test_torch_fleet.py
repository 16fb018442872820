"""The port's fleet tier against the JAX package's.

- ``observability/fleet.py``: ``merge_families``, ``bucket_delta``,
  ``replica_stats``, ``fleet_skew``, ``summarize_fleet`` and the report's
  ``format_fleet`` on the same scraped text, field for field;
  ``FleetCollector`` over injected scrapes;
- ``perf/fleet_runner.py``: ``Autoscaler``'s hysteresis and liveness
  replacement decision for decision, the ports file, ``DeviceBoundModel``,
  and a real ``FleetRunner`` on the CPU (restart at the same ports,
  replace at new ones, grow and shrink, a rolling restart under load with
  zero client failures, ``--serve`` as a subprocess);
- ``perf/distributed.py``: the rendezvous bytes against the reference's
  driver on either side, its refusals, ``topology_from_env``;
- the harness: ``--fleet 2`` with ``--rolling-restart`` end to end, and a
  2-rank ``--world-size 2`` run against one server.
"""

import asyncio
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from client_tpu.observability import fleet as jax_fleet
from client_tpu.observability.metrics import parse_exposition as jax_parse
from client_tpu.perf import distributed as jax_distributed
from client_tpu.perf import fleet_runner as jax_fleet_runner
from client_tpu.perf import metrics_collector as jax_collector
from client_tpu.perf import report as jax_report
from client_tpu_torch.observability import fleet
from client_tpu_torch.observability.metrics import parse_exposition
from client_tpu_torch.perf import distributed, fleet_runner, metrics_collector, report

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _scrape(success, failure, durations, busy, rolling=None, model="m"):
    """One replica's ``/metrics`` text: request counters, the duration
    histogram (cumulative counts at 1, 5, 25 ms and +Inf), the per-device
    busy counter and, optionally, the rolling p99 gauge."""
    bounds = ("0.001", "0.005", "0.025", "+Inf")
    lines = [
        "# HELP tpu_inference_request_success successes",
        "# TYPE tpu_inference_request_success counter",
        f'tpu_inference_request_success{{model="{model}",version="1"}} {success}',
        "# HELP tpu_inference_request_failure failures",
        "# TYPE tpu_inference_request_failure counter",
        f'tpu_inference_request_failure{{model="{model}",version="1"}} {failure}',
        "# HELP tpu_inference_request_duration request seconds",
        "# TYPE tpu_inference_request_duration histogram",
    ]
    for le, count in zip(bounds, durations[0]):
        lines.append(f'tpu_inference_request_duration_bucket{{model="{model}",le="{le}"}} {count}')
    lines.append(f'tpu_inference_request_duration_sum{{model="{model}"}} {durations[1]}')
    lines.append(f'tpu_inference_request_duration_count{{model="{model}"}} {durations[0][-1]}')
    lines += ["# HELP tpu_device_compute_ns_total busy ns",
              "# TYPE tpu_device_compute_ns_total gauge"]
    for device, ns in busy.items():
        lines.append(f'tpu_device_compute_ns_total{{device="{device}"}} {ns}')
    lines += ["# HELP tpu_memory_used_bytes memory", "# TYPE tpu_memory_used_bytes gauge",
              f"tpu_memory_used_bytes {success * 1000}"]
    if rolling is not None:
        lines += ["# HELP tpu_rolling_latency_seconds rolling",
                  "# TYPE tpu_rolling_latency_seconds gauge",
                  f'tpu_rolling_latency_seconds{{model="{model}",window="30s",'
                  f'quantile="0.99"}} {rolling}']
    return "\n".join(lines) + "\n"


REPLICAS = {
    "a:1": (_scrape(10, 0, ((2, 8, 10, 10), 0.02), {"cuda:0": 1e9}),
            _scrape(110, 2, ((20, 90, 110, 112), 0.5), {"cuda:0": 3e9}, rolling=0.004)),
    "b:2": (_scrape(5, 1, ((1, 4, 6, 6), 0.03), {"cuda:0": 0, "cuda:1": 0}),
            _scrape(45, 3, ((3, 10, 40, 48), 0.9), {"cuda:0": 2e9, "cuda:1": 4e9},
                    rolling=0.012)),
    "c:3": (_scrape(0, 0, ((0, 0, 0, 0), 0.0), {}),
            _scrape(30, 0, ((1, 2, 29, 30), 0.6), {"cuda:0": 1e9})),
}


def _families(doc):
    return sorted(
        (name, family.kind, sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                                   for s in family.samples))
        for name, family in doc.items())


def _parsed(parse):
    return {url: (parse(first), parse(last)) for url, (first, last) in REPLICAS.items()}


def test_merge_families_matches_the_reference():
    docs = [last for _, last in _parsed(parse_exposition).values()]
    want = jax_fleet.merge_families([last for _, last in _parsed(jax_parse).values()])
    got = fleet.merge_families(docs)
    assert _families(got) == _families(want)
    memory = got["tpu_memory_used_bytes"].samples[0].value
    assert memory == 110 * 1000  # gauges keep the max, counters sum
    success = got["tpu_inference_request_success"].samples[0].value
    assert success == 110 + 45 + 30


@pytest.mark.parametrize("before,after", [
    ([(0.001, 2), (0.005, 8), (float("inf"), 10)], [(0.001, 20), (0.005, 90), (float("inf"), 112)]),
    ([], [(1.0, 3), (2.0, 3), (float("inf"), 7)]),
])
def test_bucket_delta_matches_the_reference(before, after):
    assert fleet.bucket_delta(before, after) == jax_fleet.bucket_delta(before, after)
    assert metrics_collector.bucket_delta is fleet.bucket_delta


@pytest.mark.parametrize("url", sorted(REPLICAS))
@pytest.mark.parametrize("model", ["", "m", "other"])
def test_replica_stats_match_the_reference(url, model):
    first, last = _parsed(parse_exposition)[url]
    jfirst, jlast = _parsed(jax_parse)[url]
    got = fleet.replica_stats(url, first, last, window_s=2.0, model=model)
    want = jax_fleet.replica_stats(url, jfirst, jlast, window_s=2.0, model=model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("p99s", [
    [("rolling", 0.004), ("rolling", 0.012)],
    [("rolling", 0.004), ("histogram", 0.025), ("histogram", 0.005)],
    [("histogram", 0.01)],
    [("rolling", 0.01), ("rolling", 0.011), ("", 0.0)],
])
def test_fleet_skew_matches_the_reference(p99s):
    def rows(cls):
        return [cls(url=f"r{i}:1", p99_s=p99, p99_source=source)
                for i, (source, p99) in enumerate(p99s)]

    assert fleet.fleet_skew(rows(fleet.ReplicaStats)) == \
        jax_fleet.fleet_skew(rows(jax_fleet.ReplicaStats))


def _summaries(window_s=2.0, model="m"):
    port = _parsed(parse_exposition)
    ref = _parsed(jax_parse)
    entries = [(url, *port[url], 1.5 if url == "c:3" else window_s) for url in sorted(port)]
    jentries = [(url, *ref[url], 1.5 if url == "c:3" else window_s) for url in sorted(ref)]
    return (fleet.summarize_fleet(entries, window_s=window_s, model=model),
            jax_fleet.summarize_fleet(jentries, window_s=window_s, model=model))


def test_summarize_fleet_and_its_report_match_the_reference():
    got, want = _summaries()
    assert [dataclasses.asdict(r) for r in got.replicas] == \
        [dataclasses.asdict(r) for r in want.replicas]
    assert (got.total_requests, got.total_failures, got.window_s, got.skew) == \
        (want.total_requests, want.total_failures, want.window_s, want.skew)
    assert _families(got.merged) == _families(want.merged)
    assert report.format_fleet(got) == jax_report.format_fleet(want)
    assert "Fleet (3 replicas): 170 requests (4 failures)" in report.format_fleet(got)


def test_fleet_collector_reduces_injected_scrapes_as_the_reference():
    """Both packages' collectors over the same two scrapes a replica (an
    injected fetch and clock): the same fleet summary and the primary."""

    def fetcher(queue):
        async def fetch():
            return queue.pop(0)
        return fetch

    def clock():
        ticks = iter(range(0, 10**12, 10**9))
        return lambda: next(ticks)

    async def drive(module):
        pending = {url: list(texts) for url, texts in REPLICAS.items()}
        collector = module.FleetCollector(
            sorted(REPLICAS), interval_s=60, model_name="m",
            fetches=[fetcher(pending[url]) for url in sorted(REPLICAS)], clock_ns=clock())
        for c in collector.collectors:
            assert await c.scrape_now() and await c.scrape_now()
        return collector

    got = asyncio.run(drive(metrics_collector))
    want = asyncio.run(drive(jax_collector))
    assert got.size == want.size == 3 and got.primary is got.collectors[0]
    a, b = got.fleet_summary(), want.fleet_summary()
    assert [dataclasses.asdict(r) for r in a.replicas] == \
        [dataclasses.asdict(r) for r in b.replicas]
    assert a.skew == b.skew and a.window_s == b.window_s
    with pytest.raises(ValueError, match="at least one url"):
        metrics_collector.FleetCollector([])
    with pytest.raises(ValueError, match="one-to-one"):
        metrics_collector.FleetCollector(["a:1"], fetches=[])


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------


class _FakeFleet:
    def __init__(self, size):
        self.replicas = [object() for _ in range(size)]
        self.size = size
        self.replaced = []

    def add_replica(self):
        server = object()
        self.replicas.append(server)
        self.size = len(self.replicas)
        return server

    def remove_replica(self, index=-1):
        server = self.replicas.pop(index)
        self.size = len(self.replicas)
        return server

    def replace_replica(self, index):
        class Replacement:
            class core:
                class metrics:
                    booked = []

                    @classmethod
                    def observe_recovery(cls, *args):
                        cls.booked.append(args[:2])
        self.replicas[index] = Replacement()
        self.replaced.append(index)
        return self.replicas[index]


BURNS = [0.5, 1.2, 1.5, 1.1, 2.0, 3.0, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05,
         0.5, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(high_ticks=1, low_ticks=2, max_replicas=2),
    dict(burn_high=2.0, burn_low=0.5, min_replicas=2, max_replicas=3),
])
def test_autoscaler_hysteresis_matches_the_reference(knobs):
    def decisions(module):
        scaler = module.Autoscaler(_FakeFleet(knobs.get("min_replicas", 1)), **knobs)
        out = []
        for burn in BURNS:
            decision = scaler.observe(burn)
            if decision == "scale_out":
                scaler.fleet.add_replica()
            elif decision == "scale_in":
                scaler.fleet.remove_replica()
            out.append((decision, scaler.fleet.size))
        return out

    assert decisions(fleet_runner) == decisions(jax_fleet_runner)
    with pytest.raises(ValueError, match="min_replicas"):
        fleet_runner.Autoscaler(_FakeFleet(1), min_replicas=3, max_replicas=2)


def test_autoscaler_liveness_replacement_matches_the_reference():
    """A replica down ``dead_ticks`` ticks in a row is replaced (routing
    out first, the replacement announced, the MTTR booked on it); a short
    drain is not."""
    pattern = [[True, True], [True, False], [True, False], [True, True], [True, False],
               [True, False], [True, False], [True, False], [True, True]]

    def run(module):
        fake = _FakeFleet(2)
        seen = []
        samples = iter(pattern)
        scaler = module.Autoscaler(fake, liveness_signal=lambda: next(samples),
                                   burn_signal=lambda: 0.5, dead_ticks=3,
                                   on_scale_in=lambda s: seen.append("out_of_routing"),
                                   on_scale_out=lambda s: seen.append("announced"))
        decisions = [scaler.tick() for _ in pattern]
        return decisions, fake.replaced, seen, [e["decision"] for e in scaler.events]

    assert run(fleet_runner) == run(jax_fleet_runner)
    decisions = run(fleet_runner)[0]
    assert decisions.count("replace") == 1 and decisions[6] == "replace"


# ---------------------------------------------------------------------------
# the ports file and the device-bound model
# ---------------------------------------------------------------------------


def test_ports_file_round_trips_across_packages(tmp_path):
    path = str(tmp_path / "ports.json")
    assert fleet_runner.read_ports_file(path) is None
    fleet_runner.write_ports_file(path, {"http_port": 1, "epoch": 2})
    assert jax_fleet_runner.read_ports_file(path) == {"http_port": 1, "epoch": 2}
    jax_fleet_runner.write_ports_file(path, {"grpc_port": None})
    assert fleet_runner.read_ports_file(path) == {"grpc_port": None}
    (tmp_path / "torn.json").write_text("{")
    assert fleet_runner.read_ports_file(str(tmp_path / "torn.json")) is None
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_device_bound_model_waits_a_step_an_execution():
    slept = []
    model = fleet_runner.DeviceBoundModel(step_s=0.25, max_batch_size=8, sleep=slept.append,
                                          slo={"latency_target_ms": 60})
    ref = jax_fleet_runner.DeviceBoundModel()
    assert (model.inputs, model.outputs, model.device) == (ref.inputs, ref.outputs, ref.device)
    out = model.execute({"INPUT0": np.arange(8, dtype=np.int32).reshape(2, 4)}, {})
    np.testing.assert_array_equal(out["OUTPUT0"], np.arange(8).reshape(2, 4))
    assert slept == [0.25] and model.slo == {"latency_target_ms": 60}
    with pytest.raises(ValueError, match="expects INPUT0"):
        model.execute({}, {})


# ---------------------------------------------------------------------------
# a real fleet on the CPU
# ---------------------------------------------------------------------------


def _sim():
    return fleet_runner.DeviceBoundModel(step_s=0.004, max_batch_size=4)


def _infer(urls):
    import client_tpu_torch.http as http

    with http.InferenceServerClient(",".join(urls)) as client:
        tensor = http.InferInput("INPUT0", [1, 4], "INT32")
        tensor.set_data_from_numpy(np.ones([1, 4], np.int32))
        return client.infer("device_sim", [tensor]).as_numpy("OUTPUT0").tolist()


def test_fleet_runner_restarts_replaces_grows_and_shrinks():
    with fleet_runner.FleetRunner(2, builtin_models=False, model_factories=[_sim],
                                  device="cpu") as runner:
        before = runner.http_urls
        assert runner.metrics_urls == before == runner.urls("http")
        runner.restart_replica(0)
        assert runner.http_urls == before and runner.restarts == 1
        assert _infer(runner.http_urls) == [[1, 1, 1, 1]]
        replacement = runner.replace_replica(1)
        assert runner.replicas[1] is replacement and runner.replacements == 1
        assert runner.http_urls[1] != before[1]
        added = runner.add_replica()
        assert runner.size == 3 and runner.replicas[-1] is added
        assert _infer([added.http_url]) == [[1, 1, 1, 1]]
        assert runner.remove_replica() is added and runner.size == 2
        runner.remove_replica()
        with pytest.raises(ValueError, match="last replica"):
            runner.remove_replica()
    with pytest.raises(RuntimeError, match="stopped"):
        runner.add_replica()
    with pytest.raises(ValueError, match=">= 1"):
        fleet_runner.FleetRunner(0, device="cpu")


def test_fleet_rolling_restart_driver_zero_failures():
    """FleetRestartDriver cycles replicas through the real drain() path
    under load: zero client-observed failures, at least one cycle, the
    same addresses throughout."""
    import client_tpu_torch.http.aio as aio

    with fleet_runner.FleetRunner(3, builtin_models=False, model_factories=[_sim],
                                  drain_timeout_s=3.0, device="cpu") as runner:
        urls_before = runner.http_urls
        failures, successes = [], [0]

        async def drive():
            driver = fleet_runner.FleetRestartDriver(runner, period_s=0.5)
            async with aio.InferenceServerClient(
                    ",".join(urls_before), routing_policy="least_outstanding",
                    endpoint_cooldown_s=0.3) as client:
                driver.start()
                stop_at = time.monotonic() + 2.0

                async def worker():
                    tensor = aio.InferInput("INPUT0", [1, 4], "INT32")
                    tensor.set_data_from_numpy(np.ones([1, 4], np.int32))
                    while time.monotonic() < stop_at:
                        try:
                            await client.infer("device_sim", [tensor])
                            successes[0] += 1
                        except Exception as e:  # noqa: BLE001 - recorded
                            failures.append(repr(e))

                await asyncio.gather(*[worker() for _ in range(6)])
                await driver.stop()
                return driver.cycles

        cycles = asyncio.run(drive())
        assert failures == []
        assert cycles >= 1 and successes[0] > 30
        assert runner.http_urls == urls_before


def test_fleet_runner_serve_subprocess(tmp_path):
    ports_file = tmp_path / "ports.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.perf.fleet_runner", "--serve",
         "--device", "cpu", "--device-sim", "2:4", "--ports-file", str(ports_file)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        ports = None
        while ports is None and time.monotonic() < deadline and proc.poll() is None:
            ports = fleet_runner.read_ports_file(str(ports_file))
            time.sleep(0.05)
        assert ports is not None, proc.stderr.read() if proc.poll() is not None else ""
        # the reference's replica serves gRPC too: its ports file names a
        # port that answers ServerReady (the router's --replica-ports-file
        # refuses a replica without one)
        assert isinstance(ports["grpc_port"], int) and ports["grpc_port"] > 0
        import client_tpu_torch.grpc as port_grpc

        with port_grpc.InferenceServerClient(f"127.0.0.1:{ports['grpc_port']}") as client:
            assert client.is_server_ready()
        assert _infer([f"127.0.0.1:{ports['http_port']}"]) == [[1, 1, 1, 1]]
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0
    assert json.loads(out.strip().splitlines()[0]) == ports


# ---------------------------------------------------------------------------
# the rendezvous
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank0,rank1", [
    ("port", "port"), ("port", "reference"), ("reference", "port")],
    ids=["port_port", "port_ref", "ref_port"])
def test_rendezvous_interoperates_with_the_reference(rank0, rank1):
    """The same bytes on the wire: a world of either package's drivers
    forms and passes two barriers."""
    modules = {"port": distributed, "reference": jax_distributed}
    port = fleet_runner_free_port()
    coordinator = f"127.0.0.1:{port}"
    worlds, errors = {}, []

    def join(rank, module):
        try:
            world = module.DistributedDriver(3, rank, coordinator)
            world.barrier()
            world.barrier()
            worlds[rank] = world
        except Exception as e:  # noqa: BLE001 - recorded
            errors.append(repr(e))

    threads = [threading.Thread(target=join, args=(0, modules[rank0]))]
    threads += [threading.Thread(target=join, args=(r, modules[rank1])) for r in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errors == [] and sorted(worlds) == [0, 1, 2]
    assert all(w.is_distributed for w in worlds.values())
    for world in worlds.values():
        world.close()


def fleet_runner_free_port():
    from client_tpu_torch.pod.launcher import _free_port

    return _free_port()


@pytest.mark.parametrize("args", [(0, 0), (2, 2), (2, -1), (128, 0)])
def test_rendezvous_refusals_match_the_reference(args):
    with pytest.raises(ValueError) as want:
        jax_distributed.DistributedDriver(*args)
    with pytest.raises(ValueError) as got:
        distributed.DistributedDriver(*args)
    assert str(got.value) == str(want.value)


def test_single_rank_is_a_no_op_and_topology_reads_the_environment(monkeypatch):
    world = distributed.DistributedDriver()
    assert not world.is_distributed
    world.barrier()
    world.close()
    assert distributed.MAX_WORLD_SIZE == jax_distributed.MAX_WORLD_SIZE
    assert distributed.topology_from_env() == jax_distributed.topology_from_env()
    monkeypatch.setenv("CTPU_WORLD_SIZE", "3")
    monkeypatch.setenv("CTPU_RANK", "2")
    monkeypatch.setenv("CTPU_COORDINATOR", "10.0.0.1:1234")
    assert distributed.topology_from_env() == (3, 2, "10.0.0.1:1234")
    assert distributed.topology_from_env() == jax_distributed.topology_from_env()


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def test_perf_cli_fleet_rolling_restart_e2e(capsys):
    """``--fleet 2`` end to end on the CPU: the harness launches the
    replicas, wires the fleet view, cycles replicas through drain()
    while it measures, and the summary carries a row per replica and no
    failed request."""
    from client_tpu_torch.perf import cli

    rc = cli.main(["-m", "simple", "--fleet", "2", "--fleet-device", "cpu",
                   "--routing-policy", "least-outstanding", "--rolling-restart", "0.4",
                   "--concurrency-range", "4", "--measurement-interval", "500",
                   "--max-trials", "2", "--stability-percentage", "100", "--json-summary"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Fleet (2 replicas)" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["errors"] == 0 and summary["routing_policy"] == "least_outstanding"
    assert len(summary["fleet"]["replicas"]) == 2
    assert summary["rolling_restart_cycles"] >= 1


def test_perf_cli_two_ranks_against_one_server(tmp_path):
    """``--world-size 2``: two harness processes meet at the coordinator,
    measure together and both finish."""
    from client_tpu_torch.testing import InProcessServer

    with InProcessServer(device="cpu") as server:
        coordinator = f"127.0.0.1:{fleet_runner_free_port()}"
        env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.perf", "-m", "simple", "-u",
             server.http_url, "--concurrency-range", "2", "--measurement-interval", "300",
             "--max-trials", "2", "--stability-percentage", "100", "--world-size", "2",
             "--rank", str(rank), "--coordinator", coordinator, "--json-summary", "-v"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in (0, 1)]
        outs = [p.communicate(timeout=90) for p in procs]
    for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, err
        assert f"rank {rank}/2 ready" in out
        assert json.loads(out.strip().splitlines()[-1])["errors"] == 0

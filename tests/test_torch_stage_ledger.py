"""The port's stage ledger: wall ns by stage, always on, booked per model
in the statistics document (``stage_stats``), with ``torch.profiler``
ranges while a capture records and the forward timed on the device's own
clock (CUDA events).

- Behind the dynamic batcher the per-execution stages (``batch_assembly``,
  ``handoff``, ``device_put``, ``compute``, ``readback``, ``package``)
  book once an execution, and their sum stays within ``compute_infer``;
  the unbatched and direct paths book theirs; the HTTP front-end books
  ``frontend_decode`` and ``encode`` once an answered request.
- With no capture no range is entered; under one, the stages' ranges
  appear, the transfers nested under their execution.
- A model on the CPU books no ``device`` and no ``device_gap`` and leaves
  ``tpu_device_compute_ns_total`` at 0; an injected event source books
  both, ``device_gap`` on the serial path only, and an event not yet
  complete books nothing and is never waited on.
- The thread-CPU accounting, when turned on, still feeds
  ``tpu_request_cpu_seconds{stage}``.

The file imports nothing of JAX. Its one ``cuda`` test books ``device``
and ``device_gap`` on the card:

    python -m pytest tests/test_torch_stage_ledger.py -q -m cuda --noconftest
"""

import asyncio
import http.client
import json
import os
import tempfile
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from client_tpu_torch import http as port_http
from client_tpu_torch.models import bert
from client_tpu_torch.models.serving import TextEncoderModel
from client_tpu_torch.observability import metrics, profiling
from client_tpu_torch.observability.profiling import DeviceClock, execution_scope
from client_tpu_torch.server.core import CoreRequest, CoreTensor, ServerCore
from client_tpu_torch.server.model_repository import Model, ModelRepository
from client_tpu_torch.testing import InProcessServer

torch.set_num_threads(1)

NAME = "text_encoder"
PER_EXECUTION = ("batch_assembly", "handoff", "device_put", "compute", "readback", "package")
# the five that split compute_infer's span of a batched execution
EXECUTION_SPLIT = ("batch_assembly", "handoff", "device_put", "compute", "readback")


def _encoder(device="cpu"):
    config = bert.BertConfig.tiny(dtype=torch.float32)
    params = bert.init_params(torch.Generator(device=device).manual_seed(3), config, device)
    return TextEncoderModel(name=NAME, config=config, params=params, device=device)


def _core(model=None):
    repository = ModelRepository()
    repository.add_model(model or _encoder())
    return ServerCore(repository, max_workers=2, device="cpu")


def _request(length, seed, batched=True, model=NAME):
    ids = np.random.default_rng(seed).integers(1, 64, length).astype(np.int32)
    if batched:
        ids = ids[None]
    return CoreRequest(model_name=model,
                       inputs=[CoreTensor("INPUT_IDS", "INT32", list(ids.shape), ids)])


def _snapshot(core, model=NAME):
    return core.statistics(model)["model_stats"][0]


def _delta(before, after):
    """stage -> (count, ns) booked between two snapshots."""
    out = {}
    for stage, entry in after["stage_stats"].items():
        was = before["stage_stats"].get(stage, {"count": 0, "ns": 0})
        if entry["count"] != was["count"]:
            out[stage] = (entry["count"] - was["count"], entry["ns"] - was["ns"])
    return out


def _infer_concurrently(core, n, batched=True):
    async def run():
        lead = asyncio.ensure_future(core.infer(_request(9, 0, batched)))
        await asyncio.sleep(0)
        rest = [core.infer(_request(3 + 7 * i, i + 1, batched)) for i in range(n - 1)]
        return await asyncio.gather(lead, *rest)

    return asyncio.run(run())


def _infer_one_at_a_time(core, n, batched=True, model=NAME):
    async def run():
        for i in range(n):
            await core.infer(_request(5 + i, i, batched, model))

    asyncio.run(run())


@pytest.mark.parametrize("n", [1, 5, 12])
def test_batcher_books_each_per_execution_stage_once_an_execution(n):
    core = _core()
    try:
        _infer_concurrently(core, 1)  # the first execution learns the model's marks
        before = _snapshot(core)
        _infer_concurrently(core, n)
        after = _snapshot(core)
        executions = after["execution_count"] - before["execution_count"]
        assert 1 <= executions <= n
        booked = _delta(before, after)
        assert set(booked) == set(PER_EXECUTION)
        for stage in PER_EXECUTION:
            count, ns = booked[stage]
            assert count == executions, stage
            assert ns >= 0, stage
        assert booked["compute"][1] > 0 and booked["device_put"][1] > 0
        assert all(set(e) == {"count", "ns"} for e in after["stage_stats"].values())
    finally:
        core.close()


@pytest.mark.parametrize("n", [1, 8])
def test_stage_sum_never_exceeds_compute_infer(n):
    core = _core()
    try:
        before = _snapshot(core)
        for _ in range(3):
            _infer_concurrently(core, n)
        after = _snapshot(core)
        booked = _delta(before, after)
        infer_ns = (after["inference_stats"]["compute_infer"]["ns"]
                    - before["inference_stats"]["compute_infer"]["ns"])
        split = sum(booked[stage][1] for stage in EXECUTION_SPLIT)
        assert 0 < split <= infer_ns
    finally:
        core.close()


@pytest.mark.parametrize("batched", [True, False], ids=["batcher", "unbatched"])
def test_handoff_is_booked_on_the_batcher_path_only(batched):
    core = _core()
    try:
        before = _snapshot(core)
        _infer_one_at_a_time(core, 3, batched)
        booked = _delta(before, _snapshot(core))
        assert booked["compute"][0] == booked["readback"][0] == booked["package"][0] == 3
        if batched:
            assert booked["handoff"][0] == booked["batch_assembly"][0] == 3
            assert booked["handoff"][1] > 0
        else:
            assert "handoff" not in booked and "batch_assembly" not in booked
    finally:
        core.close()


def test_direct_path_books_assembly_and_package_once_a_chunk():
    core = _core()
    try:
        before = _snapshot(core)
        results = core.infer_direct([_request(4 + i, i) for i in range(4)])
        assert not any(isinstance(r, Exception) for r in results)
        after = _snapshot(core)
        executions = after["execution_count"] - before["execution_count"]
        booked = _delta(before, after)
        assert set(booked) == {"batch_assembly", "device_put", "compute", "readback", "package"}
        assert all(count == executions for count, _ns in booked.values())
    finally:
        core.close()


def test_failed_execution_books_no_stage():
    class Broken(Model):
        name = "broken_encoder"
        max_batch_size = 4
        inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]
        outputs = [{"name": "EMBEDDING", "datatype": "FP32", "shape": [4]}]

        def execute(self, inputs, parameters):
            raise RuntimeError("no forward today")

    core = _core(Broken())
    try:
        with pytest.raises(RuntimeError):
            _infer_one_at_a_time(core, 1, model="broken_encoder")
        assert _snapshot(core, "broken_encoder")["stage_stats"] == {}
    finally:
        core.close()


@pytest.fixture(scope="module")
def server():
    core = _core()
    srv = InProcessServer(core=core, builtin_models=False, device="cpu").start()
    yield srv
    srv.stop()


def _http_infer(srv, n, seed=0):
    client = port_http.InferenceServerClient(f"127.0.0.1:{srv.http_port}")
    try:
        rng = np.random.default_rng(seed)
        for i in range(n):
            ids = rng.integers(1, 64, [1, 6 + i]).astype(np.int32)
            inp = port_http.InferInput("INPUT_IDS", list(ids.shape), "INT32")
            inp.set_data_from_numpy(ids, binary_data=True)
            client.infer(NAME, [inp])
    finally:
        client.close()


def _raw(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.http_port, timeout=60)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"} if data else {})
    response = conn.getresponse()
    payload = response.read()
    headers = dict(response.getheaders())
    conn.close()
    return response.status, payload, headers


def test_http_front_end_books_decode_and_encode_once_a_request(server):
    before = _snapshot(server.core)
    _http_infer(server, 5)
    after = json.loads(_raw(server, "GET", f"/v2/models/{NAME}/stats")[1])["model_stats"][0]
    booked = _delta(before, after)
    assert booked["frontend_decode"][0] == booked["encode"][0] == 5
    assert booked["frontend_decode"][1] > 0 and booked["encode"][1] > 0
    success = after["inference_stats"]["success"]["count"] - before["inference_stats"][
        "success"]["count"]
    assert success == 5


def test_refused_request_books_no_front_end_stage(server):
    before = _snapshot(server.core)
    body = json.dumps({"inputs": [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [1, 2],
                                   "data": [1, 200000]}]})
    conn = http.client.HTTPConnection("127.0.0.1", server.http_port, timeout=60)
    conn.request("POST", f"/v2/models/{NAME}/infer", body=body.encode(),
                 headers={"Content-Type": "application/json"})
    assert conn.getresponse().status == 400  # a token outside the vocabulary
    conn.close()
    booked = _delta(before, _snapshot(server.core))
    assert "frontend_decode" not in booked and "encode" not in booked


def test_no_range_is_entered_without_a_capture(server, monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name))
    assert profiling.stage_range("compute") is profiling.stage_range("encode")
    _http_infer(server, 4)
    core = _core()
    try:
        _infer_concurrently(core, 6)
        _infer_one_at_a_time(core, 2, batched=False)
    finally:
        core.close()
    assert entered == []


def _ranges(events):
    """(name, tid, start, end) of the complete events named after stages."""
    names = set(PER_EXECUTION) | {"execution", "frontend_decode", "encode"}
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name") in names]


def _assert_transfers_nest(ranges):
    executions = [r for r in ranges if r[0] == "execution"]
    transfers = [r for r in ranges if r[0] in ("device_put", "readback")]
    assert executions and transfers
    for name, tid, start, end in transfers:
        assert any(t == tid and s <= start and end <= e for _n, t, s, e in executions), name


def test_stage_ranges_nest_under_the_execution_in_a_capture_on_this_thread():
    core = _core()
    model = core.repository.get(NAME)
    inputs = {"INPUT_IDS": np.ones([2, 8], dtype=np.int32)}
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            core._execute_measured(model, inputs, {}, False)
        path = os.path.join(tempfile.gettempdir(), f"ctt_ledger_{uuid.uuid4().hex}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        ranges = _ranges(events)
        assert {r[0] for r in ranges} == {"execution", "device_put", "readback"}
        _assert_transfers_nest(ranges)
    finally:
        core.close()


def test_profile_route_capture_shows_every_thread_s_stage_ranges(server):
    trace_dir = os.path.join(tempfile.gettempdir(), f"ctt_ledger_{uuid.uuid4().hex}")
    box = {}

    def capture():
        box["answer"] = _raw(server, "GET",
                             f"/v2/debug/profile?duration_s=4&jax_trace_dir={trace_dir}")

    thread = threading.Thread(target=capture)
    thread.start()
    try:
        # a process's first capture takes a second or two to start
        deadline = time.monotonic() + 20
        while (profiling.stage_range("probe") is profiling.stage_range("probe")
               and time.monotonic() < deadline):
            time.sleep(0.05)
        _http_infer(server, 6)
    finally:
        thread.join(60)
    assert not thread.is_alive()
    status, _, headers = box["answer"]
    assert status == 200
    with open(headers["X-Device-Trace"]) as f:
        events = json.load(f)["traceEvents"]
    for name in os.listdir(trace_dir):
        os.remove(os.path.join(trace_dir, name))
    os.rmdir(trace_dir)
    ranges = _ranges(events)
    assert {"execution", "device_put", "readback", "batch_assembly", "package",
            "frontend_decode", "encode"} <= {r[0] for r in ranges}
    _assert_transfers_nest(ranges)


def test_cpu_model_books_no_device_time(server):
    _http_infer(server, 3)
    stages = _snapshot(server.core)["stage_stats"]
    assert "device" not in stages and "device_gap" not in stages
    assert server.core.device_busy_ns_total == 0
    parsed = metrics.parse_exposition(_raw(server, "GET", "/metrics")[1].decode())
    assert metrics.gauge_values(parsed["tpu_device_compute_ns_total"]) == [0.0]


class _FakeClock:
    """A device clock that advances 1,000 ns at each event recorded."""

    def __init__(self, done=True):
        self.now = 0
        self.done = done
        self.events = 0
        self.waits = 0

    def event(self):
        self.events += 1
        return _FakeEvent(self)


class _FakeEvent:
    def __init__(self, clock):
        self.clock = clock
        self.t = None

    def record(self, stream):
        self.clock.now += 1000
        self.t = self.clock.now

    def query(self):
        return self.clock.done

    def synchronize(self):
        self.clock.waits += 1

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


@pytest.mark.parametrize("batched", [True, False], ids=["batcher", "unbatched"])
def test_device_and_gap_come_from_the_injected_event_source(batched):
    core = _core()
    fake = _FakeClock()
    core.device_clock_factory = lambda model: DeviceClock(fake.event, lambda: "stream 0")
    try:
        _infer_one_at_a_time(core, 5, batched)
        stages = _snapshot(core)["stage_stats"]
        # one recording where the forward starts, one where its read back
        # opens: 1,000 ns apart, and 1,000 ns between two forwards
        assert stages["device"] == {"count": 5, "ns": 5000}
        if batched:
            assert stages["device_gap"] == {"count": 4, "ns": 4000}
        else:
            assert "device_gap" not in stages
        assert fake.events <= 4  # pairs are reused
        assert fake.waits == 0
        assert core.device_busy_ns_total == 0  # a model on the CPU credits no card
    finally:
        core.close()


def test_an_incomplete_event_books_no_device_time_and_is_never_waited_on():
    core = _core()
    fake = _FakeClock(done=False)
    core.device_clock_factory = lambda model: DeviceClock(fake.event, lambda: "stream 0")
    try:
        _infer_one_at_a_time(core, 3)
        stages = _snapshot(core)["stage_stats"]
        assert "device" not in stages and "device_gap" not in stages
        assert stages["compute"]["count"] == 3
        assert fake.waits == 0 and fake.events == 2
    finally:
        core.close()


def test_device_gap_needs_the_same_stream():
    fake = _FakeClock()
    streams = iter(["a", "b", "b"])
    clock = DeviceClock(fake.event, lambda: next(streams))
    accounting = profiling.StageCpuAccounting()
    booked = []
    for _ in range(3):
        with execution_scope(accounting, clock=clock, serial=True) as execution:
            with profiling.transfer_scope("readback"):
                pass
        booked.append(execution.stages)
    assert [("device" in s, "device_gap" in s) for s in booked] == [
        (True, False), (True, False), (True, True)]


def test_text_encoder_marks_its_transfers():
    model = _encoder()
    accounting = profiling.StageCpuAccounting()
    with execution_scope(accounting) as execution:
        model.execute({"INPUT_IDS": np.ones([3, 20], dtype=np.int32)}, {})
    stages = execution.stages
    assert set(stages) == {"device_put", "compute", "readback"}
    assert stages["device_put"] > 0 and stages["readback"] > 0 and stages["compute"] > 0


def test_cpu_accounting_still_feeds_the_stage_cpu_histogram():
    core = _core()
    srv = InProcessServer(core=core, builtin_models=False, device="cpu").start()
    try:
        status, body, _ = _raw(srv, "POST", "/v2/debug/profiling", {"stage_cpu": True})
        assert status == 200 and json.loads(body)["stage_cpu"] is True
        _http_infer(srv, 6)
        _raw(srv, "POST", "/v2/debug/profiling", {"stage_cpu": False})
        parsed = metrics.parse_exposition(_raw(srv, "GET", "/metrics")[1].decode())
        counts = {s.labels["stage"]: s.value for s in parsed["tpu_request_cpu_seconds"].samples
                  if s.name.endswith("_count")}
        for stage in ("frontend_decode", "queue_wait", "batch_assembly", "device_put",
                      "compute", "readback", "package", "encode"):
            assert counts[stage] > 0, stage  # a sample stride may skip brackets
        assert "handoff" not in counts  # wall only
    finally:
        srv.stop()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA events time the device's own clock")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_and_gap_are_booked_on_the_card(card):
    model = _encoder(card)
    model.warmup()
    repository = ModelRepository()
    repository.add_model(model)
    core = ServerCore(repository, max_workers=2, device=card)
    try:
        _infer_one_at_a_time(core, 1)
        before = _snapshot(core)
        busy_before = core.device_busy_ns_total
        _infer_one_at_a_time(core, 6)
        after = _snapshot(core)
        booked = _delta(before, after)
        assert booked["device"][0] == 6 and booked["device_gap"][0] == 6
        assert booked["device"][1] > 0 and booked["device_gap"][1] > 0
        # the forward's span lies within the host's span of the execution
        host = booked["device_put"][1] + booked["compute"][1] + booked["readback"][1]
        assert booked["device"][1] < host
        assert core.device_busy_ns_total - busy_before == booked["device"][1]
    finally:
        core.close()

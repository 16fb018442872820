"""The port's on-demand profile route, ``GET /v2/debug/profile``, and its
``torch.profiler`` device trace (``observability/profiling.py``,
``server/http_server.py``), on the CPU.

- Sixteen captures in turn, each into its own directory, while client
  threads keep an ``InProcessServer`` busy: every one answers 200 and
  names a Chrome trace with events in its directory, and no thread
  outlives the server.
- Captures asked for from several client threads all take the route's
  one path: one at a time, each started and stopped on one thread of the
  serving loop's executor, never on the asking client's thread.
- One run at a time (409); a trace directory outside the temp directory
  and the reference's bad parameters get 400 from both servers.
- A capture that fails answers an error, never 200, and the route takes
  the next request; a server stopped and built again captures.
- With a card, a capture whose host side recorded kernel launches and
  whose records hold nothing on the card raises, and the route answers
  500 (faked here: Kineto's events without CUPTI's).
- The temp directory itself is a valid trace directory; captures into
  one directory write one trace each; no directory traces nothing; a
  speedscope answer names its trace too.
"""

import http.client
import json
import os
import tempfile
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from client_tpu.testing import InProcessServer as JaxInProcessServer
from client_tpu_torch import http as port_http
from client_tpu_torch.observability import profiling
from client_tpu_torch.testing import InProcessServer

torch.set_num_threads(1)
WINDOW_S = 0.05


@pytest.fixture(scope="module")
def server():
    server = InProcessServer(device="cpu").start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def reference():
    server = JaxInProcessServer(grpc=False).start()
    yield server
    server.stop()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        response = conn.getresponse()
        return response.status, response.read(), dict(response.getheaders())
    finally:
        conn.close()


def _trace_dir():
    return os.path.join(tempfile.gettempdir(), f"ctt_profile_{uuid.uuid4().hex}")


def _capture(port, trace_dir, duration_s=WINDOW_S):
    return _get(port, f"/v2/debug/profile?duration_s={duration_s}&jax_trace_dir={trace_dir}")


def _remove(trace_dir):
    if os.path.isdir(trace_dir):
        for name in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, name))
        os.rmdir(trace_dir)


class _Load:
    """Client threads sending ``simple`` requests until the block ends."""

    def __init__(self, url, clients=3):
        self.url, self.clients = url, clients
        self.done = threading.Event()
        self.served = 0
        self.errors = []
        self._lock = threading.Lock()
        self._threads = []

    def _run(self):
        client = port_http.InferenceServerClient(self.url)
        rng = np.random.default_rng(threading.get_ident() % 2**32)
        try:
            while not self.done.is_set():
                inputs = [port_http.InferInput(n, [1, 16], "INT32") for n in ("INPUT0", "INPUT1")]
                for inp in inputs:
                    inp.set_data_from_numpy(rng.integers(0, 100, [1, 16], dtype=np.int32))
                client.infer("simple", inputs)
                with self._lock:
                    self.served += 1
        except Exception as e:  # noqa: BLE001 - reported by the test
            self.errors.append(e)
        finally:
            client.close()

    def __enter__(self):
        self._threads = [threading.Thread(target=self._run) for _ in range(self.clients)]
        for thread in self._threads:
            thread.start()
        deadline = time.monotonic() + 30
        while self.served < self.clients and time.monotonic() < deadline:
            time.sleep(0.01)
        return self

    def __exit__(self, *exc):
        self.done.set()
        for thread in self._threads:
            thread.join(30)


def _alive_after(threads, timeout_s=10.0):
    """Those of ``threads`` still alive once all have ended or the
    deadline has passed."""
    deadline = time.monotonic() + timeout_s
    while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
        time.sleep(0.05)
    return [t.name for t in threads if t.is_alive()]


def test_sixteen_captures_in_turn_under_load_each_write_a_trace():
    before = set(threading.enumerate())
    server = InProcessServer(device="cpu").start()
    dirs = [_trace_dir() for _ in range(16)]
    try:
        with _Load(server.http_url) as load:
            served = []
            for trace_dir in dirs:
                start = load.served
                status, body, headers = _capture(server.http_port, trace_dir)
                assert status == 200, body[:300]
                path = headers["X-Device-Trace"]
                assert os.path.dirname(path) == os.path.realpath(trace_dir)
                with open(path) as f:
                    assert json.load(f)["traceEvents"]
                served.append(load.served - start)
        assert not load.errors
        assert sum(served) > 0  # the captures ran under load
        server_threads = set(threading.enumerate()) - before
    finally:
        server.stop()
        for trace_dir in dirs:
            _remove(trace_dir)
    assert server_threads  # the server ran threads of its own ...
    assert not _alive_after(server_threads)  # ... and none outlives it


def test_a_request_during_a_capture_gets_409(server):
    trace_dir = _trace_dir()
    box = {}
    thread = threading.Thread(target=lambda: box.update(answer=_capture(
        server.http_port, trace_dir, duration_s=2.0)))
    thread.start()
    try:
        time.sleep(0.5)  # the 2 s run has started
        assert _capture(server.http_port, _trace_dir())[0] == 409
        assert _get(server.http_port, "/v2/debug/profile?duration_s=0.1")[0] == 409
    finally:
        thread.join(60)
        _remove(trace_dir)
    assert box["answer"][0] == 200
    assert _get(server.http_port, "/v2/debug/profile?duration_s=0.05")[0] == 200


@pytest.mark.parametrize("query", [
    "duration_s=0", "duration_s=121", "duration_s=abc", "hz=0", "hz=5000", "format=svg",
    "jax_trace_dir=/", "jax_trace_dir=/etc/ctt_profile",
])
def test_bad_profile_requests_get_400_as_on_the_reference(server, reference, query):
    assert _get(reference.http_port, f"/v2/debug/profile?{query}")[0] == 400
    status, body, _ = _get(server.http_port, f"/v2/debug/profile?{query}")
    assert status == 400, body[:300]


def test_a_trace_dir_that_escapes_the_temp_dir_gets_400(server):
    escape = os.path.join(tempfile.gettempdir(), "..", f"ctt_profile_{uuid.uuid4().hex}")
    status, body, _ = _capture(server.http_port, escape)
    assert status == 400 and b"temp directory" in body
    assert not os.path.exists(escape)


def test_a_capture_whose_export_fails_answers_an_error_and_frees_the_route(
        server, monkeypatch):
    def broken(self, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", broken)
    trace_dir = _trace_dir()
    try:
        status, body, headers = _capture(server.http_port, trace_dir)
        assert status == 500 and b"disk full" in body
        assert "X-Device-Trace" not in headers
        monkeypatch.undo()
        status, _, headers = _capture(server.http_port, trace_dir)
        assert status == 200 and os.path.exists(headers["X-Device-Trace"])
    finally:
        _remove(trace_dir)


def test_captures_from_several_client_threads_take_one_path(server, monkeypatch):
    seen = []
    real = torch.profiler.profile

    class Recording(real):
        def __enter__(self):
            seen.append(("start", threading.current_thread().name))
            return super().__enter__()

        def __exit__(self, *exc):
            seen.append(("stop", threading.current_thread().name))
            return super().__exit__(*exc)

    monkeypatch.setattr(torch.profiler, "profile", Recording)
    answers, dirs = [], []
    lock = threading.Lock()

    def client():
        for _ in range(2):
            trace_dir = _trace_dir()
            with lock:
                dirs.append(trace_dir)
            while True:
                status, _, headers = _capture(server.http_port, trace_dir)
                if status != 409:
                    break
                time.sleep(0.01)
            with lock:
                answers.append((status, headers.get("X-Device-Trace")))

    threads = [threading.Thread(target=client, name=f"ctt-client-{i}") for i in range(4)]
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
        assert [status for status, _ in answers] == [200] * 8
        assert all(os.path.exists(path) for _, path in answers)
    finally:
        for trace_dir in dirs:
            _remove(trace_dir)
    # one capture at a time, each started and stopped on one thread of the
    # serving loop's executor: never the asking client's, never the loop's
    assert [kind for kind, _ in seen] == ["start", "stop"] * 8
    assert all(seen[i][1] == seen[i + 1][1] for i in range(0, 16, 2))
    assert all(name.startswith("asyncio_") for _, name in seen)


def test_a_server_stopped_and_built_again_still_captures():
    for _ in range(2):
        server = InProcessServer(device="cpu").start()
        trace_dir = _trace_dir()
        try:
            status, _, headers = _capture(server.http_port, trace_dir)
            assert status == 200
            with open(headers["X-Device-Trace"]) as f:
                assert json.load(f)["traceEvents"]
        finally:
            server.stop()
            _remove(trace_dir)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the trace path without a card")
def test_the_trace_path_records_the_cpu_activity_only_without_a_card(monkeypatch):
    seen = []
    real = torch.profiler.profile

    class Recording(real):
        def __init__(self, *args, **kwargs):
            seen.append(sorted(a.name for a in kwargs["activities"]))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "profile", Recording)
    trace_dir = _trace_dir()
    try:
        with profiling.maybe_torch_trace(trace_dir) as trace:
            torch.ones(4).sum()
        assert os.path.exists(trace["path"])
    finally:
        _remove(trace_dir)
    assert seen == [["CPU"]]


def test_a_trace_dir_equal_to_the_temp_dir_is_accepted(server):
    temp_root = os.path.realpath(tempfile.gettempdir())
    status, body, headers = _capture(server.http_port, temp_root)
    assert status == 200, body[:300]
    path = headers["X-Device-Trace"]
    try:
        assert os.path.dirname(path) == temp_root
        with open(path) as f:
            assert json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def test_two_captures_into_one_dir_write_two_traces(server):
    trace_dir = _trace_dir()
    try:
        paths = [_capture(server.http_port, trace_dir)[2]["X-Device-Trace"] for _ in range(2)]
        assert len(set(paths)) == 2
        assert sorted(os.listdir(trace_dir)) == sorted(os.path.basename(p) for p in paths)
    finally:
        _remove(trace_dir)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_no_trace_dir_traces_nothing(log_dir, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler started without a trace dir")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with profiling.maybe_torch_trace(log_dir) as trace:
        torch.ones(4).sum()
    assert trace == {}


def test_a_speedscope_answer_carries_the_trace_header(server):
    trace_dir = _trace_dir()
    try:
        status, body, headers = _get(
            server.http_port,
            f"/v2/debug/profile?duration_s={WINDOW_S}&format=speedscope&jax_trace_dir={trace_dir}")
        assert status == 200
        assert json.loads(body)["profiles"][0]["type"] == "sampled"
        assert int(headers["X-Profile-Samples"]) > 0
        assert os.path.dirname(headers["X-Device-Trace"]) == os.path.realpath(trace_dir)
    finally:
        _remove(trace_dir)


class _Event:
    """One of Kineto's events, as ``require_kernel_records`` reads it."""

    def __init__(self, name, on_card=False):
        self._name, self._on_card = name, on_card

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._on_card else torch.autograd.DeviceType.CPU


def _card_capture(monkeypatch, events):
    """``torch.profiler`` as on a card whose capture recorded ``events``."""

    class Profile:
        def __init__(self, activities, **kwargs):
            assert torch.profiler.ProfilerActivity.CUDA in activities
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [{"name": e.name()} for e in events]}, f)

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


_LAUNCHES_ONLY = [_Event("aten::mm"), _Event("cudaLaunchKernel"), _Event("cudaLaunchKernel"),
                  _Event("cuLaunchKernelEx"), _Event("cudaStreamSynchronize")]
_WINDOWS = {
    "launches_and_no_record": (_LAUNCHES_ONLY, 3),
    "launches_and_kernels": (_LAUNCHES_ONLY + [_Event("ampere_sgemm", True)] * 3, 0),
    "a_kernel_record_alone": (_LAUNCHES_ONLY + [_Event("cutlass_gemm", True)], 0),
    "no_launch": ([_Event("aten::add"), _Event("cudaMemcpyAsync"),
                   _Event("Memcpy HtoD", True)], 0),
    "idle": ([], 0),
}


@pytest.mark.parametrize("window", sorted(_WINDOWS))
def test_a_card_capture_needs_a_record_on_the_card_for_its_launches(window, monkeypatch):
    events, missing = _WINDOWS[window]
    _card_capture(monkeypatch, events)
    trace_dir = _trace_dir()
    try:
        if missing:
            with pytest.raises(RuntimeError, match=f"recorded {missing} kernel launches and no "
                                                   "activity on the card"):
                with profiling.maybe_torch_trace(trace_dir):
                    pass
            assert not os.listdir(trace_dir)  # nothing written
        else:
            with profiling.maybe_torch_trace(trace_dir) as trace:
                pass
            with open(trace["path"]) as f:
                assert len(json.load(f)["traceEvents"]) == len(events)
    finally:
        _remove(trace_dir)


def test_a_card_capture_with_launches_and_no_record_answers_500(server, monkeypatch):
    _card_capture(monkeypatch, _LAUNCHES_ONLY)
    trace_dir = _trace_dir()
    try:
        status, body, headers = _capture(server.http_port, trace_dir)
        assert status == 500 and b"no activity on the card" in body
        assert "X-Device-Trace" not in headers and not os.listdir(trace_dir)
        monkeypatch.undo()
        status, _, headers = _capture(server.http_port, trace_dir)
        assert status == 200 and os.path.exists(headers["X-Device-Trace"])
    finally:
        _remove(trace_dir)

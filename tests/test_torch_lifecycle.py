"""The port's lifecycle and repository control, held to ``client_tpu``.

Twins of ``tests/test_lifecycle.py`` without gRPC: each scripted sequence
runs against the JAX package and the port (``device="cpu"``) and the
test compares what both report — status codes and ``Retry-After``
headers, repository index entries (state, reason), error messages, the
structured log's event names — and holds both to the reference's
expected values. Covers the drain controller on a fake clock, the
repository's LOADING / UNLOADING states, the directory reload's atomic
swap, an unload superseded by a load, readiness through a drain and a
degraded repository, the drain-aware stop, unload / load of a directory
model under traffic with no wrong answers, a rolling restart over an
endpoint pool, and the perf harness's ``--rolling-restart``.

Also the repair of ``LlmEngineModel.warmup``'s order: a reload whose
probe fails leaves the old engine serving, in both packages.
"""

import asyncio
import contextlib
import io
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import client_tpu_torch.http as httpclient
from client_tpu_torch.resilience import RetryPolicy
from client_tpu_torch.utils import InferenceServerException

pytestmark = pytest.mark.lifecycle

logging.getLogger("aiohttp.server").setLevel(logging.CRITICAL)

PACKAGES = ("port", "jax")


class FakeClock:
    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def time(self) -> float:
        return self.now

    async def async_sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += seconds


class _Twin:
    """One package's lifecycle surface, under common names."""

    def __init__(self, which: str):
        self.which = which
        if which == "jax":
            from client_tpu import lifecycle
            from client_tpu.perf import cli
            from client_tpu.server import core, model_repository
            from client_tpu.testing import InProcessServer
        else:
            from client_tpu_torch import lifecycle
            from client_tpu_torch.perf import cli
            from client_tpu_torch.server import core, model_repository
            from client_tpu_torch.testing import InProcessServer
        self.lifecycle = lifecycle
        self.cli = cli
        self.core = core
        self.repo_mod = model_repository
        self.Model = model_repository.Model
        self._server_cls = InProcessServer
        self.package = "client_tpu" if which == "jax" else "client_tpu_torch"

    def repository(self, path=None):
        return self.repo_mod.ModelRepository(path)

    def make_core(self, repository=None):
        repository = repository if repository is not None else self.repository()
        if self.which == "jax":
            return self.core.ServerCore(repository)
        return self.core.ServerCore(repository, device="cpu")

    def server(self, core=None, builtin_models=True, **kwargs):
        if self.which == "jax":
            return self._server_cls(core=core, grpc=False, builtin_models=builtin_models,
                                    **kwargs)
        return self._server_cls(core=core, builtin_models=builtin_models, device="cpu",
                                **kwargs)

    def counting_model(self):
        class CountingModel(self.Model):
            name = "counting"
            max_batch_size = 0
            inputs = [{"name": "INPUT0", "datatype": "FP32", "shape": [-1]}]
            outputs = [{"name": "OUTPUT0", "datatype": "FP32", "shape": [-1]}]

            def __init__(self):
                self.warmups = 0
                self.fail_warmup = False

            def warmup(self):
                if self.fail_warmup:
                    raise RuntimeError("warmup exploded")
                self.warmups += 1

            def execute(self, inputs, parameters):
                return {"OUTPUT0": inputs["INPUT0"]}

        return CountingModel()

    def slow_model(self, delay_s):
        class SlowModel(self.Model):
            name = "slow"
            max_batch_size = 0
            inputs = [{"name": "INPUT0", "datatype": "FP32", "shape": [-1]}]
            outputs = [{"name": "OUTPUT0", "datatype": "FP32", "shape": [-1]}]

            def execute(self, inputs, parameters):
                time.sleep(delay_s)
                return {"OUTPUT0": inputs["INPUT0"]}

        return SlowModel()

    def write_model_py(self, path, marker: float, fail_warmup: bool = False):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"""
import numpy as np
from {self.package}.server.model_repository import Model


class MarkerModel(Model):
    name = "swap"
    max_batch_size = 0
    inputs = [{{"name": "INPUT0", "datatype": "FP32", "shape": [-1]}}]
    outputs = [{{"name": "OUTPUT0", "datatype": "FP32", "shape": [-1]}}]

    def warmup(self):
        if {fail_warmup!r}:
            raise RuntimeError("bad weights")

    def execute(self, inputs, parameters):
        return {{"OUTPUT0": inputs["INPUT0"] + np.float32({marker!r})}}


def create_model():
    return MarkerModel()
""")


@pytest.fixture(scope="module")
def twins():
    return {which: _Twin(which) for which in PACKAGES}


def _both(twins, scenario):
    return {which: scenario(twins[which]) for which in PACKAGES}


def _entry(repository, name):
    entry = {m["name"]: m for m in repository.index()}[name]
    return entry["state"], entry["reason"]


def _identity_infer(client, value=3.0, model="identity_fp32"):
    x = np.array([value], dtype=np.float32)
    inp = httpclient.InferInput("INPUT0", [1], "FP32")
    inp.set_data_from_numpy(x)
    return client.infer(model, [inp]).as_numpy("OUTPUT0")


def _raw(url, path, method="GET", body=None):
    request = urllib.request.Request(f"http://{url}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(request, timeout=30) as r:
            return r.status, r.headers.get("Retry-After"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), e.read()


# ---------------------------------------------------------------------------
# the drain controller and the repository state machine
# ---------------------------------------------------------------------------


def test_drain_controller_state_machine(twins):
    def scenario(twin):
        lc = twin.lifecycle
        ctl = lc.DrainController(retry_after_s=3.0)
        seen = [ctl.state, ctl.accepting]
        ctl.admit("m")
        seen.append((ctl.inflight(), ctl.inflight("m")))
        ctl.begin_drain()
        seen.append((ctl.state, ctl.accepting))
        with pytest.raises(lc.ServerDrainingError) as info:
            ctl.admit("m")
        e = info.value
        seen.append((e.http_status, e.grpc_code, e.retry_after_s, e.message(),
                     ctl.rejected_total))
        ctl.finish("m")
        seen.append(ctl.inflight())
        ctl.resume()
        seen.append(ctl.accepting)
        ctl.mark_stopped()
        ctl.resume()
        seen.append(ctl.state)
        with pytest.raises(lc.ServerDrainingError) as info:
            ctl.check()
        seen.append((info.value.message(), ctl.snapshot()))
        return seen

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][4][:3] == (503, "UNAVAILABLE", 3.0)
    assert got["port"][7] == "stopped"


def test_drain_wait_idle_fake_clock_deadline(twins):
    def scenario(twin):
        clock = FakeClock()
        ctl = twin.lifecycle.DrainController(clock=clock.time, async_sleep=clock.async_sleep)
        ctl.admit("m")

        async def run():
            out = [await ctl.wait_idle(timeout_s=0.5, poll_s=0.1)]
            ctl.finish("m")
            out.append(await ctl.wait_idle(timeout_s=0.5))
            ctl.admit("a")
            out.append(await ctl.wait_idle(timeout_s=0.2, model_name="b"))
            out.append(await ctl.wait_idle(timeout_s=0.2, model_name="a"))
            return out

        return asyncio.run(run()), len(clock.sleeps) > 0

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == ([False, True, True, False], True)


def test_unload_reasons_and_programmatic_reload(twins):
    def scenario(twin):
        repo = twin.repository()
        model = twin.counting_model()
        repo.add_model(model)
        core = twin.make_core(repo)
        seen = [core.unload_model("counting")]  # no loop: finalizes at once
        seen.append(_entry(repo, "counting"))
        with pytest.raises(twin.repo_mod.ModelUnavailableError) as info:
            repo.get("counting")
        seen.append((info.value.http_status, info.value.status(), info.value.message()))
        seen.append((repo.degraded(), core.ready, model.warmups))
        repo.load("counting")
        seen.append((model.warmups, repo.is_ready("counting")))
        epoch = repo.unload("counting")
        seen.append(_entry(repo, "counting"))
        repo.finish_unload("counting", epoch)
        model.fail_warmup = True
        with pytest.raises(InferenceServerException if twin.which == "port"
                           else Exception) as info:
            repo.load("counting")
        seen.append((info.value.message(), _entry(repo, "counting"), repo.degraded(),
                     core.ready))
        core.close()
        return seen

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    seen = got["port"]
    assert seen[1] == ("UNAVAILABLE", "unloaded")
    assert seen[2][:2] == (503, "UNAVAILABLE")
    assert seen[3] == (False, True, 1)  # an unload does not degrade readiness
    assert seen[4] == (2, True)  # a real re-warm, not a silent ready flip
    assert seen[5] == ("UNLOADING", "unloading")
    assert seen[6][1] == ("UNAVAILABLE", "load failed: warmup exploded")
    assert seen[6][2:] == (True, False)


def test_directory_reload_is_atomic_swap(twins, tmp_path):
    def scenario(twin):
        root = tmp_path / twin.which
        model_py = root / "swap" / "model.py"
        twin.write_model_py(model_py, marker=1.0)
        repo = twin.repository(str(root))
        repo.scan()
        v1 = repo.get("swap")
        x = np.zeros(4, dtype=np.float32)
        seen = [float(v1.execute({"INPUT0": x}, {})["OUTPUT0"][0])]
        # a load whose warmup fails leaves v1 serving and readiness intact
        twin.write_model_py(model_py, marker=2.0, fail_warmup=True)
        with pytest.raises(Exception) as info:
            repo.load("swap")
        seen.append((type(info.value).__name__, info.value.message()))
        seen.append((repo.get("swap") is v1, _entry(repo, "swap"), repo.degraded()))
        twin.write_model_py(model_py, marker=3.0)
        repo.load("swap")
        v3 = repo.get("swap")
        seen.append((v3 is not v1, float(v3.execute({"INPUT0": x}, {})["OUTPUT0"][0])))
        # a never-loaded name whose load fails leaves no entry
        twin.write_model_py(root / "fresh" / "model.py", 1.0, fail_warmup=True)
        with pytest.raises(Exception):
            repo.load("fresh")
        seen.append((repo.is_ready("fresh"), [m["name"] for m in repo.index()],
                     repo.degraded()))
        with pytest.raises(Exception) as info:
            repo.load("nowhere")
        seen.append(info.value.message().replace(str(root), "<repo>"))
        return seen

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    seen = got["port"]
    assert seen[0] == 1.0
    assert seen[1] == ("InferenceServerException", "failed to load 'swap': bad weights")
    assert seen[2] == (True, ("READY", ""), False)
    assert seen[3] == (True, 3.0)
    assert seen[4] == (False, ["swap"], False)


def test_a_replaced_model_is_freed_without_the_cycle_collector(twins, tmp_path):
    """Reload a directory model under traffic with the cycle collector
    off: the port frees each replaced model as soon as the new one has
    served (its admission state lives in the core, per name); the
    reference caches it on the model, a cycle that keeps every replaced
    model, and its device memory, until a collection."""
    import gc
    import weakref

    def scenario(twin):
        root = tmp_path / twin.which
        twin.write_model_py(root / "swap" / "model.py", marker=1.0)
        repo = twin.repository(str(root))
        repo.scan()
        core = twin.make_core(repo)
        x = np.zeros(4, dtype=np.float32)

        def request():
            return twin.core.CoreRequest("swap", inputs=[
                twin.core.CoreTensor("INPUT0", "FP32", [4], x)], parameters={"timeout": 10**9})

        async def run():
            refs = []
            for _ in range(3):
                refs.append(weakref.ref(repo.get("swap")))
                await core.infer(request())
                await core.unload_model("swap")
                repo.load("swap")
                await core.infer(request())
            return [ref() is not None for ref in refs]

        gc.collect()
        gc.disable()
        try:
            alive = asyncio.run(run())
        finally:
            gc.enable()
            core.close()
        return alive

    got = _both(twins, scenario)
    assert got["port"] == [False, False, False]
    assert got["jax"] == [True, True, True]


def test_directory_model_gets_the_server_device(tmp_path):
    """The port's ``create_model`` may declare ``device``: the repository
    hands it the server's."""
    from client_tpu_torch.server.model_repository import build_repository

    model_py = tmp_path / "dev" / "model.py"
    model_py.parent.mkdir()
    model_py.write_text("""
from client_tpu_torch.server.models import IdentityModel


def create_model(device):
    model = IdentityModel("ignored", "FP32", device=device)
    model.created_on = str(device)
    return model
""")
    repo = build_repository(str(tmp_path), builtin=False, device="cpu")
    assert repo.get("dev").created_on == "cpu" and repo.get("dev").name == "dev"


# ---------------------------------------------------------------------------
# the core: fail_pending, a superseding load, the drain deadline
# ---------------------------------------------------------------------------


def test_fail_pending_converts_queue_to_clean_503(twins):
    def scenario(twin):
        async def run():
            core = twin.make_core()
            if twin.which == "jax":
                from client_tpu.server.models import register_builtin_models

                register_builtin_models(core.repository)
            else:
                from client_tpu_torch.server.models import register_builtin_models

                register_builtin_models(core.repository, device="cpu")
            data = np.zeros((1, 16), dtype=np.int32)

            def request():
                return twin.core.CoreRequest(model_name="simple", inputs=[
                    twin.core.CoreTensor("INPUT0", "INT32", [1, 16], data),
                    twin.core.CoreTensor("INPUT1", "INT32", [1, 16], data)])

            futures = [asyncio.ensure_future(core.infer(request())) for _ in range(4)]
            await asyncio.sleep(0)  # every request submitted; none executed yet
            core.lifecycle.begin_drain()
            failed = core.fail_pending()
            results = await asyncio.gather(*futures, return_exceptions=True)
            state = core.debug_state()["lifecycle"]
            core.close()
            return failed, [type(r).__name__ for r in results], state["inflight_total"]

        return asyncio.run(run())

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == (4, ["ServerDrainingError"] * 4, 0)


def test_unload_finalize_skipped_when_load_supersedes(twins):
    def scenario(twin):
        async def run():
            repo = twin.repository()
            repo.add_model(twin.counting_model())
            core = twin.make_core(repo)
            core.lifecycle.admit("counting")  # a stuck request: the drain expires
            task = core.unload_model("counting", drain_timeout_s=0.05)
            repo.load("counting")  # supersedes the unload
            failed = []
            core.fail_pending = lambda name=None: failed.append(name) or 0
            await task
            core.lifecycle.finish("counting")
            entry = _entry(repo, "counting")
            core.close()
            return repo.is_ready("counting"), failed, entry

        return asyncio.run(run())

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == (True, [], ("READY", ""))


def test_drain_reports_expired_deadline_and_logs(twins):
    def scenario(twin):
        async def run():
            core = twin.make_core()
            stream = io.StringIO()
            core.logger._stream = stream
            core.lifecycle.admit("stuck")  # never finishes
            drained = await core.drain(timeout_s=0.05)
            events = [json.loads(line)["event"] for line in stream.getvalue().splitlines()]
            state = core.lifecycle.state
            core.close()
            return drained, events, state

        return asyncio.run(run())

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == (False, ["drain_started", "drain_deadline_expired",
                                   "drain_completed"], "stopped")


# ---------------------------------------------------------------------------
# readiness and drain over HTTP
# ---------------------------------------------------------------------------


def test_ready_flips_during_drain(twins):
    def scenario(twin):
        with twin.server() as server:
            url = server.http_url
            client = httpclient.InferenceServerClient(url)
            try:
                seen = [client.is_server_ready()]
                server.core.lifecycle.begin_drain()
                server.core.lifecycle.retry_after_s = 2.0
                ready = _raw(url, "/v2/health/ready")
                seen.append((ready[0], ready[1], client.is_server_ready(),
                             client.is_server_live()))
                with pytest.raises(InferenceServerException) as info:
                    _identity_infer(client)
                seen.append((info.value.status(), info.value.message()))
                status, retry_after, body = _raw(url, "/v2/models/identity_fp32/infer",
                                                 "POST", b"{}")
                seen.append((status, retry_after, json.loads(body)))
                metrics = _raw(url, "/metrics")[2].decode()
                seen.append(("tpu_server_state 1" in metrics,
                             'tpu_drain_rejected_total{model="identity_fp32"} 2' in metrics))
                state = json.loads(_raw(url, "/v2/debug/state")[2])
                seen.append((state["server"]["ready"], state["lifecycle"]["state"],
                             state["lifecycle"]["rejected_total"]))
                server.core.lifecycle.resume()
                seen.append((client.is_server_ready(), float(_identity_infer(client)[0])))
            finally:
                client.close()
        return seen

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    seen = got["port"]
    assert seen[0] is True
    assert seen[1] == (503, "2", False, True)
    assert seen[2][0] == "503"
    assert seen[3][:2] == (503, "2")
    assert seen[4] == (True, True)
    assert seen[5] == (False, "draining", 2)
    assert seen[6] == (True, 3.0)


def test_degraded_repository_and_unload_through_client(twins):
    def scenario(twin):
        with twin.server() as server:
            client = httpclient.InferenceServerClient(server.http_url)
            repository = server.core.repository
            try:
                model = repository.peek("identity_fp32")
                client.unload_model("identity_fp32")
                seen = [client.is_model_ready("identity_fp32"), client.is_server_ready()]
                with pytest.raises(InferenceServerException) as info:
                    _identity_infer(client)
                seen.append(info.value.status())
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline:
                    entry = {m["name"]: m for m in client.get_model_repository_index()}
                    if entry["identity_fp32"]["reason"] == "unloaded":
                        break
                    time.sleep(0.01)
                seen.append((entry["identity_fp32"]["state"],
                             entry["identity_fp32"]["reason"]))
                # a failed reload degrades readiness
                original = type(model).warmup

                def boom(self):
                    raise RuntimeError("bad reload")

                type(model).warmup = boom
                try:
                    with pytest.raises(InferenceServerException) as info:
                        client.load_model("identity_fp32")
                    seen.append((info.value.message(), client.is_server_ready(),
                                 _entry(repository, "identity_fp32")))
                finally:
                    type(model).warmup = original
                client.load_model("identity_fp32")
                seen.append((client.is_server_ready(), client.is_model_ready("identity_fp32"),
                             float(_identity_infer(client, 5.0)[0])))
                with pytest.raises(InferenceServerException) as info:
                    client.unload_model("nope")
                seen.append(info.value.message())
            finally:
                client.close()
        return seen

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    seen = got["port"]
    assert seen[:3] == [False, True, "503"]
    assert seen[3] == ("UNAVAILABLE", "unloaded")
    assert seen[4][1:] == (False, ("UNAVAILABLE", "load failed: bad reload"))
    assert seen[5] == (True, True, 5.0)


def test_openai_route_answers_an_unloaded_model_with_503(twins):
    """The OpenAI route on a model that exists but is not serving: the
    port answers the retryable 503 of the core's error in the OpenAI body,
    where the reference answers 404 as for a model that never existed;
    an unknown model is a 404 in both."""

    def scenario(twin):
        with twin.server() as server:
            url = server.http_url
            server.core.unload_model("identity_fp32")
            body = json.dumps({"model": "identity_fp32", "stream": True,
                               "messages": [{"role": "user", "content": "hi"}]}).encode()
            unloaded = _raw(url, "/v1/chat/completions", "POST", body)
            unknown = _raw(url, "/v1/chat/completions", "POST",
                           body.replace(b"identity_fp32", b"nope"))
            return ((unloaded[0], json.loads(unloaded[2])),
                    (unknown[0], json.loads(unknown[2])))

    got = _both(twins, scenario)
    message = "Request for unavailable model: 'identity_fp32' is not ready"
    assert got["port"][0] == (503, {"error": {"message": message}})
    assert got["jax"][0] == (404, {"error": {"message": message}})
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1][0] == 404


def test_drain_aware_stop_completes_inflight_work(twins):
    def scenario(twin):
        core = twin.make_core()
        core.repository.add_model(twin.slow_model(0.4))
        server = twin.server(core=core, builtin_models=False, drain_timeout_s=5.0).start()
        client = httpclient.InferenceServerClient(server.http_url)
        results = []

        def one_request():
            try:
                results.append(("ok", float(_identity_infer(client, 1.5, "slow")[0])))
            except Exception as e:  # noqa: BLE001 - recorded for the assertion
                results.append(("error", str(e)))

        thread = threading.Thread(target=one_request)
        thread.start()
        time.sleep(0.15)  # the request is in flight on the server
        server.stop()  # drains: in-flight work completes
        thread.join(timeout=10)
        client.close()
        return results, core.lifecycle.state

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == ([("ok", 1.5)], "stopped")


# ---------------------------------------------------------------------------
# under traffic
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_unload_load_under_traffic_no_drops_no_wrong_results(twins, tmp_path):
    def scenario(twin):
        root = tmp_path / twin.which
        twin.write_model_py(root / "swap" / "model.py", marker=1.0)
        repo = twin.repository(str(root))
        repo.scan()
        server = twin.server(core=twin.make_core(repo), builtin_models=False).start()
        client = httpclient.InferenceServerClient(
            server.http_url,
            retry_policy=RetryPolicy(max_attempts=12, initial_backoff_s=0.01,
                                     max_backoff_s=0.1))
        stop_event = threading.Event()
        failures, results = [], []

        def hammer():
            x = np.zeros(4, dtype=np.float32)
            inp = httpclient.InferInput("INPUT0", [4], "FP32")
            inp.set_data_from_numpy(x)
            while not stop_event.is_set():
                try:
                    results.append(float(client.infer("swap", [inp]).as_numpy("OUTPUT0")[0]))
                except Exception as e:  # noqa: BLE001 - recorded
                    failures.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)
            for _ in range(3):
                client.unload_model("swap")
                time.sleep(0.05)
                client.load_model("swap")
                time.sleep(0.15)
        finally:
            stop_event.set()
            for t in threads:
                t.join(timeout=10)
            client.close()
            server.stop()
        return failures, len(results) > 20, set(results)

    got = _both(twins, scenario)
    # the marker is constant across reloads: a partial swap would show
    assert got["port"] == got["jax"] == ([], True, {1.0})


@pytest.mark.chaos
def test_rolling_restart_over_an_endpoint_pool_drops_nothing(twins):
    """Two servers behind the port's client with ``urls=[...]``: the
    primary's drain-aware stop and restart at the same address costs no
    client-visible failure."""

    def scenario(twin):
        a = twin.server().start()
        b = twin.server().start()
        a_port = a.http_port
        client = httpclient.InferenceServerClient(urls=[a.http_url, b.http_url],
                                                  endpoint_cooldown_s=0.2)
        stop_event = threading.Event()
        failures, successes = [], []

        def hammer():
            while not stop_event.is_set():
                try:
                    out = _identity_infer(client, 2.0)
                    (successes if out[0] == 2.0 else failures).append(float(out[0]))
                except Exception as e:  # noqa: BLE001 - recorded
                    failures.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        restarted = None
        try:
            time.sleep(0.3)
            a.stop()
            time.sleep(0.4)
            restarted = twin.server(http_port=a_port).start()
            time.sleep(0.6)
        finally:
            stop_event.set()
            for t in threads:
                t.join(timeout=10)
            client.close()
            if restarted is not None:
                restarted.stop()
            b.stop()
        return failures, len(successes) > 20

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == ([], True)


@pytest.mark.chaos
def test_perf_cli_rolling_restart_reports_cycles(twins, capsys):
    """``--rolling-restart`` end to end, the port's harness against each
    server and the JAX harness against the port's: the run completes, the
    report carries the cycles, and every failed request of the window
    carries a 503."""

    def run(harness, server):
        rc = harness.main(["-m", "identity_fp32", "-u", server.http_url, "--shape", "INPUT0:4",
                           "--concurrency-range", "2", "--measurement-interval", "400",
                           "--max-trials", "1", "--rolling-restart", "0.15",
                           "--json-summary"])
        out = capsys.readouterr().out
        summary = json.loads(out.strip().splitlines()[-1])
        return rc, "Rolling restart:" in out, summary

    results = {}
    for which in PACKAGES:
        with twins[which].server() as server:
            results[which] = run(twins["port"].cli, server)
            if which == "port":
                results["jax-harness"] = run(twins["jax"].cli, server)
    for key, (rc, printed, summary) in results.items():
        assert rc == 0 and printed, key
        assert summary["rolling_restart_cycles"] >= 1, key
        assert summary["errors"] == summary["dropped_unavailable"], key
        assert "rerouted" in summary, key


# ---------------------------------------------------------------------------
# the warmup-order repair
# ---------------------------------------------------------------------------


MAX_TOKENS = 8


def test_failed_reload_probe_leaves_the_old_engine_serving():
    """One stream, then a reload whose decode probe fails, then a second
    stream: in both packages the reload raises, the model stays READY,
    and the second stream still equals ``llama.generate``."""
    import jax
    import jax.numpy as jnp
    import torch

    from client_tpu.llm.engine import EngineConfig as JaxEngineConfig
    from client_tpu.llm.serving import LlmEngineModel as JaxLlmEngineModel
    from client_tpu.models import llama as jax_llama
    from client_tpu.server.model_repository import ModelRepository as JaxRepository
    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.models import llama
    from client_tpu_torch.server.model_repository import ModelRepository

    jax_config = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, jax_config))(
        jax.random.PRNGKey(0))
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    expected = np.asarray(jax_llama.generate(
        jax_params, np.array([prompt], dtype=np.int32), jax_config, MAX_TOKENS))[0].tolist()
    sizing = dict(block_size=8, num_blocks=1 + 8 * 8, max_active=8, max_queue=32,
                  max_seq_len=64)
    models = {
        "port": (LlmEngineModel(
            config=llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32),
            params=llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu"),
            engine_config=EngineConfig(**sizing), device="cpu"), ModelRepository(), llama,
            ("decode_step_paged_attn",)),
        "jax": (JaxLlmEngineModel(config=jax_config, params=jax_params,
                                  engine_config=JaxEngineConfig(**sizing)),
                JaxRepository(), jax_llama, ("decode_step_paged_attn", "decode_step_paged")),
    }

    async def stream(model):
        out = []
        async for item in model.execute_decoupled(
                {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, {"max_tokens": MAX_TOKENS}):
            out.append(int(item["OUTPUT_IDS"][0]))
        return out

    def failing_probe(*args, **kwargs):
        raise RuntimeError("probe failed")

    results = {}
    for which, (model, repository, module, probed) in models.items():
        repository.add_model(model)

        async def run():
            first = await stream(model)
            engine = model.engine
            with contextlib.ExitStack() as stack:
                for name in probed:
                    original = getattr(module, name)
                    setattr(module, name, failing_probe)
                    stack.callback(setattr, module, name, original)
                with pytest.raises(Exception) as info:
                    repository.load("llm_engine")
            kept = model.engine is engine
            second = await stream(model)
            model.shutdown()
            return (first, "probe failed" in info.value.message(), kept,
                    _entry(repository, "llm_engine"), second)

        results[which] = asyncio.run(run())
    assert results["port"] == results["jax"]
    assert results["port"] == (expected, True, True, ("READY", ""), expected)


def test_server_cli_drains_on_sigterm(tmp_path):
    """``python -m client_tpu_torch.server`` with a directory model:
    SIGTERM drains (ready 503, live 200), logs ``drain_started`` and
    ``drain_completed``, and exits 0."""
    import os
    import signal
    import subprocess
    import sys

    model_py = tmp_path / "echo" / "model.py"
    model_py.parent.mkdir()
    model_py.write_text(
        "import time\n"
        "from client_tpu_torch.server.models import IdentityModel\n"
        "class Slow(IdentityModel):\n"
        "    def execute(self, inputs, parameters):\n"
        "        time.sleep(0.5)\n"
        "        return super().execute(inputs, parameters)\n"
        "def create_model(device):\n"
        "    return Slow(device=device)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--device", "cpu",
         "--no-builtin-models", "--model-repository", str(tmp_path), "--http-port", "0",
         "--host", "127.0.0.1", "--drain-timeout", "5"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            if '"server_started"' in line:
                port = json.loads(line)["http_port"]
                break
        assert port is not None
        url = f"127.0.0.1:{port}"
        assert _raw(url, "/v2/health/ready")[0] == 200
        client = httpclient.InferenceServerClient(url)
        results = []
        thread = threading.Thread(
            target=lambda: results.append(float(_identity_infer(client, 4.0, "echo")[0])))
        thread.start()
        time.sleep(0.2)  # in flight
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.1)
        during = (_raw(url, "/v2/health/ready")[:2], _raw(url, "/v2/health/live")[0])
        thread.join(10)
        client.close()
        assert proc.wait(30) == 0
        events = [json.loads(line) for line in proc.stderr.read().splitlines()
                  if line.startswith("{")]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert results == [4.0]
    assert during == ((503, "1"), 200)
    names = [e["event"] for e in events]
    assert names.index("drain_started") < names.index("drain_completed")
    assert next(e for e in events if e["event"] == "drain_completed")["drained"] is True

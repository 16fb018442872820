"""The port's scheduling and admission control, held to ``client_tpu``.

Twins of ``tests/test_scheduling.py`` without gRPC or ``infer_direct``:
each scripted sequence runs against the JAX package's ``ServerCore`` and
the port's (``device="cpu"``), and the test compares what both report —
the order the batcher granted priorities, the error types, statuses and
messages, the reject counters — and holds both to the reference's
expected values. Covers the priority queue's DELAY ("continue")
demotion, the rate limiter's priority order and its blocking twin, the
admission gate, deadlines checked again after the rate limiter's wait,
decoupled streams shed while parked on a pool, the 64-request burst, and
429 / 504 on the wire through the port's HTTP client. Deadlines are
explicit "now" values or milliseconds of wall time.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.scheduling

PACKAGES = ("port", "jax")


class _Twin:
    """One package's scheduling surface, under common names."""

    def __init__(self, which: str):
        self.which = which
        if which == "jax":
            import client_tpu.scheduling as scheduling
            from client_tpu.server import core
            from client_tpu.server.model_repository import Model, ModelRepository
            from client_tpu.testing import InProcessServer
        else:
            import client_tpu_torch.scheduling as scheduling
            from client_tpu_torch.server import core
            from client_tpu_torch.server.model_repository import Model, ModelRepository
            from client_tpu_torch.testing import InProcessServer
        self.scheduling = scheduling
        self.core = core
        self.Model = Model
        self.ModelRepository = ModelRepository
        self._server_cls = InProcessServer

    def make_core(self, *models):
        repository = self.ModelRepository()
        for model in models:
            repository.add_model(model)
        if self.which == "jax":
            return self.core.ServerCore(repository)
        return self.core.ServerCore(repository, device="cpu")

    def server(self, core):
        if self.which == "jax":
            return self._server_cls(core=core, grpc=False, builtin_models=False)
        return self._server_cls(core=core, builtin_models=False)

    def sched_model(self, name="sched", delay_s=0.0, **overrides):
        """A batchable model whose execute() blocks on ``gate`` and
        records each execution's first-column values."""

        class SchedModel(self.Model):
            inputs = [{"name": "X", "datatype": "FP32", "shape": [2]}]
            outputs = [{"name": "Y", "datatype": "FP32", "shape": [2]}]

            def __init__(self):
                self.name = name
                self.delay_s = delay_s
                for key, value in overrides.items():
                    setattr(self, key, value)
                self.gate = threading.Event()
                self.gate.set()
                self.executed = []
                self.seen_parameters = []

            def execute(self, inputs, parameters):
                self.gate.wait(timeout=10)
                if self.delay_s:
                    time.sleep(self.delay_s)
                self.seen_parameters.append(dict(parameters))
                rows = np.atleast_2d(inputs["X"])
                self.executed.append(sorted(float(v) for v in rows[:, 0]))
                return {"Y": inputs["X"] + 1.0}

        return SchedModel()

    def request(self, model_name, value, rows=2, priority=None, timeout_us=None,
                extra=None):
        data = np.full([rows, 2], value, dtype=np.float32)
        parameters = dict(extra or {})
        if priority is not None:
            parameters["priority"] = priority
        if timeout_us is not None:
            parameters["timeout"] = timeout_us
        return self.core.CoreRequest(
            model_name=model_name,
            inputs=[self.core.CoreTensor("X", "FP32", list(data.shape), data)],
            parameters=parameters,
        )


@pytest.fixture(scope="module")
def twins():
    return {which: _Twin(which) for which in PACKAGES}


def _both(twins, scenario):
    """``scenario(twin)`` on each package; returns {which: result}."""
    return {which: scenario(twins[which]) for which in PACKAGES}


def _metric(text, name, **labels):
    for line in text.splitlines():
        if line.startswith(name) and all(f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _error_face(e):
    return (type(e).__name__, e.status(), getattr(e, "http_status", None), e.message())


# ---------------------------------------------------------------------------
# the priority queue, the rate limiter and the admission gate
# ---------------------------------------------------------------------------


def test_priority_queue_orders_levels_and_demotes_as_client_tpu(twins):
    def scenario(twin):
        q = twin.scheduling.PriorityQueue(levels=2)
        q.push("low-a", level=2)
        q.push("high-a", level=1)
        q.push("low-b", level=2)
        q.push("high-b", level=1)
        order = [i.value for i in q.scan()]
        items = q.scan()
        q.remove([items[0], items[2]])
        after_remove = ([i.value for i in q.scan()], len(q))
        d = twin.scheduling.PriorityQueue(levels=2)
        d.push("keeps", level=1, deadline_ns=1_000)
        d.push("rejects", level=1, deadline_ns=100, timeout_action="reject")
        d.push("demotes", level=1, deadline_ns=100, timeout_action="continue")
        rejected = [i.value for i in d.expire(now_ns=500)]
        lanes = [i.value for i in d.scan()]
        late = [i.value for i in d.expire(now_ns=2_000_000)]
        clamp = twin.scheduling.PriorityQueue(levels=2)
        clamp.push("a", level=99)
        clamp.push("b", level=0)
        return (order, after_remove, rejected, lanes, late, [i.value for i in d.scan()],
                d.depths(), [i.level for i in clamp.scan()])

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == (
        ["high-a", "high-b", "low-a", "low-b"], (["high-b", "low-b"], 2),
        ["rejects"], ["keeps", "demotes"], ["keeps"], ["demotes"], {1: 1, 2: 0}, [1, 2])


def test_rate_limiter_grants_by_priority_as_client_tpu(twins):
    def scenario(twin):
        limiter = twin.scheduling.RateLimiter()
        limiter.register({"slot": 1})
        order = []

        async def run():
            await limiter.acquire({"slot": 1})

            async def waiter(tag, priority):
                await limiter.acquire({"slot": 1}, priority=priority)
                order.append(tag)
                limiter.release({"slot": 1})

            tasks = []
            for tag, priority in (("low", 3), ("mid", 2), ("high", 1)):
                tasks.append(asyncio.ensure_future(waiter(tag, priority)))
                await asyncio.sleep(0)
            snapshot = limiter.snapshot()
            limiter.release({"slot": 1})
            await asyncio.gather(*tasks)
            return snapshot

        snapshot = asyncio.run(run())
        return order, snapshot, limiter.snapshot()

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    order, parked, after = got["port"]
    assert order == ["high", "mid", "low"]
    assert parked == {"slot": {"capacity": 1, "used": 1, "waiters": 3}}
    assert after == {"slot": {"capacity": 1, "used": 0, "waiters": 0}}


def test_rate_limiter_blocking_and_async_share_one_pool(twins):
    """``acquire_blocking`` (executor threads) and ``acquire`` (the loop)
    draw on the same pool; a blocking waiter that gives up returns its
    place, so the next grant goes to the async waiter behind it."""

    def scenario(twin):
        limiter = twin.scheduling.RateLimiter()
        limiter.register({"slot": 1})
        events = [limiter.acquire_blocking({"slot": 1}, timeout_s=0.5),
                  limiter.acquire_blocking({"slot": 1}, timeout_s=0.01),
                  limiter.snapshot()["slot"]["waiters"]]

        async def run():
            waiter = asyncio.ensure_future(limiter.acquire({"slot": 1}, priority=5))
            await asyncio.sleep(0.01)
            events.append(limiter.snapshot()["slot"]["waiters"])
            limiter.release({"slot": 1})
            await asyncio.wait_for(waiter, 5)
            events.append(limiter.available("slot"))
            limiter.release({"slot": 1})

        asyncio.run(run())
        events.append(limiter.available("slot"))
        limiter.register({"slot": 3})
        events.append(limiter.available("slot"))
        return events

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == [True, False, 0, 1, 0, 1, 3]


def test_admission_gate_bounds_waiting_room_as_client_tpu(twins):
    def scenario(twin):
        gate = twin.scheduling.AdmissionGate(twin.scheduling.QueuePolicy(max_queue_size=1))
        ticket = gate.enter("m")
        with pytest.raises(twin.scheduling.QueueFullError) as info:
            gate.enter("m")
        ticket.started()
        ticket.started()  # idempotent
        second = gate.enter("m")
        second.close()
        return _error_face(info.value), gate.waiting

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0][1:3] == ("RESOURCE_EXHAUSTED", 429) and got["port"][1] == 0


def test_queue_policy_rate_resources_and_config_as_client_tpu(twins):
    declared = dict(max_batch_size=4, priority_levels=2,
                    queue_policy={"max_queue_size": 3, "timeout_action": "continue",
                                  "default_timeout_us": 7},
                    rate_limiter={"resources": [{"name": "card", "count": 2}],
                                  "priority": 1})

    def scenario(twin):
        model = twin.sched_model(**declared)
        policy = twin.scheduling.QueuePolicy.from_model(model)
        config = model.config()
        return (policy.rate_resources, policy.rate_priority, policy.timeout_action,
                policy.enabled, config["dynamic_batching"], config["rate_limiter"])

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"card": 2}
    assert got["port"][4]["default_queue_policy"]["timeout_action"] == "DELAY"


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def _run_core(core, coroutine):
    try:
        return asyncio.run(coroutine)
    finally:
        core.close()


def test_priority_order_and_scheduling_params_share_a_batch(twins):
    def scenario(twin):
        model = twin.sched_model(max_batch_size=2, priority_levels=2)
        core = twin.make_core(model)
        model.gate.clear()

        async def run():
            blocker = asyncio.ensure_future(core.infer(twin.request("sched", 0.0)))
            await asyncio.sleep(0.05)
            lows = [asyncio.ensure_future(core.infer(twin.request("sched", 10.0 + i,
                                                                  priority=2)))
                    for i in range(2)]
            await asyncio.sleep(0.01)
            high = asyncio.ensure_future(core.infer(twin.request("sched", 20.0, priority=1)))
            await asyncio.sleep(0.01)
            # rows of one differing only in scheduling params share a batch
            a = asyncio.ensure_future(core.infer(twin.request("sched", 30.0, rows=1,
                                                              priority=1)))
            b = asyncio.ensure_future(core.infer(twin.request("sched", 31.0, rows=1,
                                                              priority=1, timeout_us=10**9)))
            await asyncio.sleep(0.01)
            model.gate.set()
            await asyncio.gather(blocker, high, a, b, *lows)

        _run_core(core, run())
        return model.executed

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == [
        [0.0, 0.0], [20.0, 20.0], [30.0, 31.0], [10.0, 10.0], [11.0, 11.0]]


def test_queue_full_and_queue_timeout_are_booked_as_client_tpu(twins):
    def scenario(twin):
        model = twin.sched_model(max_batch_size=2, queue_policy={"max_queue_size": 2})
        core = twin.make_core(model)
        model.gate.clear()
        errors = []

        async def run():
            blocker = asyncio.ensure_future(core.infer(twin.request("sched", 0.0)))
            await asyncio.sleep(0.05)
            queued = [asyncio.ensure_future(core.infer(twin.request("sched", 1.0)))]
            doomed = asyncio.ensure_future(core.infer(twin.request("sched", 2.0,
                                                                   timeout_us=1000)))
            await asyncio.sleep(0.05)
            try:
                await core.infer(twin.request("sched", 9.0))
            except twin.scheduling.QueueFullError as e:
                errors.append(_error_face(e))
            model.gate.set()
            await asyncio.gather(blocker, *queued)
            try:
                await doomed
            except twin.scheduling.QueueTimeoutError as e:
                errors.append(_error_face(e))

        _run_core(core, run())
        text = core.metrics.render()
        stats = core.statistics("sched")["model_stats"][0]["inference_stats"]
        return (errors, model.executed,
                _metric(text, "tpu_queue_rejected_total", model="sched", reason="queue_full"),
                _metric(text, "tpu_queue_rejected_total", model="sched", reason="timeout"),
                stats["fail"]["count"], stats["success"]["count"])

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    errors, executed, full, timeout, fails, successes = got["port"]
    assert [e[1:3] for e in errors] == [("RESOURCE_EXHAUSTED", 429), ("DEADLINE_EXCEEDED", 504)]
    assert executed == [[0.0, 0.0], [1.0, 1.0]]  # the timed-out one never ran
    assert (full, timeout, fails, successes) == (1, 1, 2, 2)


def test_queue_timeout_continue_demotes_instead_of_rejecting(twins):
    def scenario(twin):
        model = twin.sched_model(max_batch_size=2, queue_policy={"timeout_action": "continue"})
        core = twin.make_core(model)
        model.gate.clear()

        async def run():
            blocker = asyncio.ensure_future(core.infer(twin.request("sched", 0.0)))
            await asyncio.sleep(0.05)
            late = asyncio.ensure_future(core.infer(twin.request("sched", 1.0,
                                                                 timeout_us=1000)))
            await asyncio.sleep(0.05)  # past its deadline: demoted, not shed
            fresh = asyncio.ensure_future(core.infer(twin.request("sched", 2.0)))
            await asyncio.sleep(0.01)
            model.gate.set()
            responses = await asyncio.gather(blocker, late, fresh)
            return [type(r).__name__ for r in responses]

        kinds = _run_core(core, run())
        return kinds, model.executed

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    # the demoted (timed-out) request executed after the fresh one
    assert got["port"] == (["CoreResponse"] * 3, [[0.0, 0.0], [2.0, 2.0], [1.0, 1.0]])


def test_batcher_rechecks_deadlines_after_rate_limit_wait(twins):
    def scenario(twin):
        model = twin.sched_model(max_batch_size=2,
                                 rate_limiter={"resources": [{"name": "pool", "count": 1}]})
        core = twin.make_core(model)
        core.rate_limiter.register({"pool": 1})
        faces = []

        async def run():
            await core.rate_limiter.acquire({"pool": 1})  # starve the pool
            doomed = asyncio.ensure_future(core.infer(twin.request("sched", 1.0,
                                                                   timeout_us=1000)))
            await asyncio.sleep(0.05)  # the grant wait outlives the deadline
            core.rate_limiter.release({"pool": 1})
            try:
                await doomed
            except twin.scheduling.QueueTimeoutError as e:
                faces.append(_error_face(e))
            ok = await core.infer(twin.request("sched", 2.0))
            faces.append(type(ok).__name__)

        _run_core(core, run())
        return faces, model.executed, core.rate_limiter.snapshot()

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    faces, executed, pools = got["port"]
    assert faces[0][1] == "DEADLINE_EXCEEDED" and faces[1] == "CoreResponse"
    assert executed == [[2.0, 2.0]]
    assert pools == {"pool": {"capacity": 1, "used": 0, "waiters": 0}}


def test_rate_limiter_serializes_models_sharing_a_pool(twins):
    def scenario(twin):
        shared = {"resources": [{"name": "device", "count": 1}]}
        a = twin.sched_model(name="ratelim_a", rate_limiter=shared)
        b = twin.sched_model(name="ratelim_b", rate_limiter=shared)
        core = twin.make_core(a, b)
        a.gate.clear()
        seen = []

        async def run():
            fut_a = asyncio.ensure_future(core.infer(twin.request("ratelim_a", 1.0)))
            await asyncio.sleep(0.1)
            fut_b = asyncio.ensure_future(core.infer(twin.request("ratelim_b", 2.0)))
            await asyncio.sleep(0.1)
            seen.append(list(b.executed))  # parked on the pool, not executing
            a.gate.set()
            await asyncio.gather(fut_a, fut_b)

        _run_core(core, run())
        return seen, a.executed, b.executed

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == ([[]], [[1.0, 1.0]], [[2.0, 2.0]])


def test_decoupled_streams_shed_while_parked_on_the_pool(twins):
    def scenario(twin):
        class StreamModel(twin.Model):
            name = "streamer"
            decoupled = True
            max_batch_size = 0
            queue_policy = {"max_queue_size": 1}
            rate_limiter = {"resources": [{"name": "pool", "count": 1}]}
            inputs = [{"name": "X", "datatype": "FP32", "shape": [2]}]
            outputs = [{"name": "Y", "datatype": "FP32", "shape": [2]}]

            async def execute_decoupled(self, inputs, parameters):
                yield {"Y": inputs["X"] + 1.0}

        core = twin.make_core(StreamModel())
        core.rate_limiter.register({"pool": 1})
        out = []

        async def consume(value):
            return [r async for r in core.infer_decoupled(twin.request("streamer", value))]

        async def run():
            await core.rate_limiter.acquire({"pool": 1})  # starve the pool
            waiting = asyncio.ensure_future(consume(1.0))
            await asyncio.sleep(0.05)  # parked in acquire, still "waiting"
            try:
                await asyncio.wait_for(consume(2.0), timeout=5)
            except twin.scheduling.QueueFullError as e:
                out.append(_error_face(e))
            out.append(core.lifecycle.inflight("streamer"))
            core.rate_limiter.release({"pool": 1})
            responses = await asyncio.wait_for(waiting, timeout=5)
            out.append(len(responses))
            out.append(core.lifecycle.inflight("streamer"))

        _run_core(core, run())
        return out

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0][1:3] == ("RESOURCE_EXHAUSTED", 429)
    assert got["port"][1:] == [1, 1, 0]


def test_burst_64_resolves_everything_and_counts_match(twins):
    def scenario(twin):
        model = twin.sched_model(max_batch_size=4, priority_levels=2,
                                 queue_policy={"max_queue_size": 8}, delay_s=0.002)
        core = twin.make_core(model)

        async def run():
            tasks = [asyncio.ensure_future(core.infer(twin.request(
                "sched", float(i), rows=1, priority=1 if i % 2 else 2,
                timeout_us=2_000_000))) for i in range(64)]
            return await asyncio.gather(*tasks, return_exceptions=True)

        results = _run_core(core, run())
        sched = twin.scheduling
        outcome = {
            "ok": sum(isinstance(r, twin.core.CoreResponse) for r in results),
            "full": sum(isinstance(r, sched.QueueFullError) for r in results),
            "timeout": sum(isinstance(r, sched.QueueTimeoutError) for r in results),
        }
        text = core.metrics.render()
        booked = (_metric(text, "tpu_queue_rejected_total", model="sched", reason="queue_full")
                  + _metric(text, "tpu_queue_rejected_total", model="sched",
                            reason="timeout"))
        return outcome, booked

    for which, (outcome, booked) in _both(twins, scenario).items():
        # every request resolved as one of the three outcomes, overload shed,
        # and the counter equals the rejections the callers saw
        assert sum(outcome.values()) == 64, which
        assert outcome["ok"] and outcome["full"], which
        assert booked == outcome["full"] + outcome["timeout"], which


# ---------------------------------------------------------------------------
# the wire, through the port's HTTP client
# ---------------------------------------------------------------------------


def _infer_body(value=1.0):
    return json.dumps({"inputs": [{"name": "X", "datatype": "FP32", "shape": [2, 2],
                                   "data": [value] * 4}]}).encode()


def test_http_queue_full_is_429_and_queue_timeout_504(twins):
    from client_tpu_torch.http import aio as httpclient
    from client_tpu_torch.utils import InferenceServerException

    def scenario(twin):
        model = twin.sched_model(max_batch_size=2, queue_policy={"max_queue_size": 1})
        core = twin.make_core(model)
        model.gate.clear()
        with twin.server(core) as server:
            url = server.http_url

            async def run():
                async with httpclient.InferenceServerClient(url) as client:
                    def build():
                        x = httpclient.InferInput("X", [2, 2], "FP32")
                        x.set_data_from_numpy(np.ones([2, 2], dtype=np.float32))
                        return [x]

                    inflight = [asyncio.ensure_future(client.infer("sched", build()))]
                    await asyncio.sleep(0.2)
                    # a 1 ms queue timeout: expires while the first executes
                    doomed = asyncio.ensure_future(client.infer("sched", build(),
                                                                timeout=1000))
                    await asyncio.sleep(0.2)

                    def raw_post():
                        request = urllib.request.Request(
                            f"http://{url}/v2/models/sched/infer", data=_infer_body(),
                            headers={"Content-Type": "application/json"})
                        try:
                            urllib.request.urlopen(request, timeout=10)
                            return None, None
                        except urllib.error.HTTPError as e:
                            return e.code, e.headers.get("Retry-After")

                    full = await asyncio.to_thread(raw_post)
                    model.gate.set()
                    await asyncio.gather(*inflight)
                    try:
                        await doomed
                    except InferenceServerException as e:
                        return full, (e.status(), e.message())
                    return full, None

            return asyncio.run(run())

    got = _both(twins, scenario)
    assert got["port"] == got["jax"]
    (status, retry_after), (token, message) = got["port"]
    assert status == 429 and int(retry_after) >= 1
    assert token == "504" and "timed out in queue" in message


def test_http_client_sends_priority_and_timeout_parameters(twins):
    from client_tpu_torch.http import aio as httpclient
    from client_tpu_torch.utils import InferenceServerException

    def scenario(twin):
        model = twin.sched_model(max_batch_size=0)
        core = twin.make_core(model)
        with twin.server(core) as server:
            async def run():
                async with httpclient.InferenceServerClient(server.http_url) as client:
                    x = httpclient.InferInput("X", [2], "FP32")
                    x.set_data_from_numpy(np.ones([2], dtype=np.float32))
                    await client.infer("sched", [x], priority=2, timeout=5_000_000)
                    with pytest.raises(InferenceServerException) as info:
                        await client.infer("sched", [x], timeout=2.0)
                    return "MICROSECONDS" in info.value.message()

            loud = asyncio.run(run())
        return loud, model.seen_parameters[0]

    got = _both(twins, scenario)
    assert got["port"] == got["jax"] == (True, {"priority": 2, "timeout": 5_000_000})

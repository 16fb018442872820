"""The port's fault injection held against the JAX package's.

- ``ChaosPolicy``: the same seed and rates give the reference's fate
  sequence draw for draw, the same scope decisions and the same refusals.
- Chaos over HTTP: the port's server and client against the reference's
  server and client with the same seed and retry policy — equal
  ``injected`` counters over 100 sequential ``simple`` requests, resets and
  truncated bodies retried to success with a policy and failing without
  one, the added latency, and chaos refused beside the gRPC front-end.
"""

import asyncio
import time
import urllib.request

import numpy as np
import pytest

import client_tpu.http as ref_http
import client_tpu_torch.http as port_http
from client_tpu.resilience import ChaosPolicy as RefChaosPolicy
from client_tpu.resilience import RetryPolicy as RefRetryPolicy
from client_tpu.testing import InProcessServer as RefServer
from client_tpu.utils import InferenceServerException as RefError
from client_tpu_torch.resilience import ChaosPolicy, RetryPolicy
from client_tpu_torch.testing import InProcessServer
from client_tpu_torch.utils import InferenceServerException

RATE_MIXES = {
    "none": {},
    "errors": {"error_rate": 0.3},
    "mixed": {"error_rate": 0.2, "reset_rate": 0.15, "truncate_rate": 0.15},
    "all_error": {"error_rate": 1.0},
    "all_reset": {"reset_rate": 1.0},
    "all_truncate": {"truncate_rate": 1.0},
    "sum_one": {"error_rate": 0.5, "reset_rate": 0.25, "truncate_rate": 0.25},
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mix", sorted(RATE_MIXES))
def test_fate_sequences_equal_the_references(mix, seed):
    port = ChaosPolicy(seed=seed, **RATE_MIXES[mix])
    ref = RefChaosPolicy(seed=seed, **RATE_MIXES[mix])
    fates = [port.draw() for _ in range(2000)]
    assert fates == [ref.draw() for _ in range(2000)]
    # drawing counts nothing; record does, per fate
    assert not port.injected
    for fate in fates:
        if fate is not None:
            port.record(fate)
            ref.record(fate)
    assert port.injected == ref.injected
    if mix == "none":
        assert set(fates) == {None}
    if mix.startswith("all_"):
        assert set(fates) == {mix[len("all_"):]}


TARGETS = ["/v2/models/simple/infer", "/v2/models/simple/versions/2/infer",
           "/v2/models/simple/infer/", "ModelInfer",
           "/inference.GRPCInferenceService/ModelStreamInfer",
           "/v2/models/inference_v2", "/v2/health/live", "/v2/models/simple",
           "/v1/chat/completions", "/metrics", "infer", ""]


@pytest.mark.parametrize("scope", ["infer", "all"])
def test_applies_to_matches_the_references(scope):
    port, ref = ChaosPolicy(scope=scope), RefChaosPolicy(scope=scope)
    assert [port.applies_to(t) for t in TARGETS] == [ref.applies_to(t) for t in TARGETS]
    if scope == "infer":
        assert port.applies_to("/v2/models/simple/versions/2/infer")
        assert not port.applies_to("/v2/models/inference_v2")
        assert not port.applies_to("/v2/health/live")


@pytest.mark.parametrize("kwargs", [
    {"error_rate": -0.1}, {"reset_rate": 1.5}, {"truncate_rate": 2.0},
    {"error_rate": 0.6, "reset_rate": 0.3, "truncate_rate": 0.2},
    {"scope": "everything"},
], ids=["negative", "reset_over_one", "truncate_over_one", "sum_over_one", "scope"])
def test_bad_arguments_are_refused_with_the_references_messages(kwargs):
    with pytest.raises(ValueError) as theirs:
        RefChaosPolicy(**kwargs)
    with pytest.raises(ValueError) as ours:
        ChaosPolicy(**kwargs)
    assert str(ours.value) == str(theirs.value)


# -- over HTTP --------------------------------------------------------------


def _inputs(module):
    data = np.arange(16, dtype=np.int32).reshape(1, 16)
    a = module.InferInput("INPUT0", [1, 16], "INT32")
    a.set_data_from_numpy(data)
    b = module.InferInput("INPUT1", [1, 16], "INT32")
    b.set_data_from_numpy(data)
    return [a, b]


def _retry(policy_type):
    # the reference's chaos policy: enough attempts for every request to
    # converge, no wall time spent sleeping
    return policy_type(max_attempts=10, initial_backoff_s=0.001, max_backoff_s=0.002,
                       async_sleep=lambda s: asyncio.sleep(0))


def _run_port(chaos, requests, retry=True):
    with InProcessServer(device="cpu", chaos=chaos) as server:
        policy = _retry(RetryPolicy) if retry else None
        with port_http.InferenceServerClient(server.http_url, retry_policy=policy) as client:
            for _ in range(requests):
                result = client.infer("simple", _inputs(port_http))
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"),
                                              2 * np.arange(16).reshape(1, 16))


def _run_ref(chaos, requests, retry=True):
    with RefServer(grpc=False, chaos=chaos) as server:
        policy = _retry(RefRetryPolicy) if retry else None
        with ref_http.InferenceServerClient(server.http_url, retry_policy=policy) as client:
            for _ in range(requests):
                client.infer("simple", _inputs(ref_http))


def test_error_chaos_converges_with_the_references_injected_counts():
    """100 sequential ``simple`` requests at a 30 % injected error rate
    with the same seed and retry policy: every answer exact, and the
    same faults fired on the port's server as on the reference's."""
    ours, theirs = ChaosPolicy(error_rate=0.3, seed=7), RefChaosPolicy(error_rate=0.3, seed=7)
    _run_port(ours, 100)
    _run_ref(theirs, 100)
    assert ours.injected["error"] > 0
    assert ours.injected == theirs.injected


def test_without_a_retry_policy_the_same_run_fails_with_503():
    chaos = ChaosPolicy(error_rate=0.3, seed=7)
    with pytest.raises(InferenceServerException) as info:
        _run_port(chaos, 100, retry=False)
    assert info.value.status() == "503"
    assert "chaos: injected unavailability" in info.value.message()
    with pytest.raises(RefError) as theirs:
        _run_ref(RefChaosPolicy(error_rate=0.3, seed=7), 100, retry=False)
    assert theirs.value.status() == info.value.status()


def test_resets_and_truncated_bodies_are_retried_to_success():
    """Resets (the connection aborted before a byte is written) and
    truncated bodies (the full Content-Length declared, half the body
    written): with a policy all 40 requests answer exactly, on both
    packages with the same faults fired; without one the run fails."""
    ours = ChaosPolicy(reset_rate=0.15, truncate_rate=0.15, seed=5)
    theirs = RefChaosPolicy(reset_rate=0.15, truncate_rate=0.15, seed=5)
    _run_port(ours, 40)
    _run_ref(theirs, 40)
    assert ours.injected["reset"] > 0 and ours.injected["truncate"] > 0
    assert ours.injected == theirs.injected
    with pytest.raises(InferenceServerException):
        _run_port(ChaosPolicy(reset_rate=0.15, truncate_rate=0.15, seed=5), 40,
                  retry=False)


def test_a_truncated_body_declares_its_full_length():
    """On the raw wire: the status line and the full Content-Length
    arrive, then half the body, then the connection ends."""
    import http.client

    with InProcessServer(device="cpu", chaos=ChaosPolicy(truncate_rate=1.0)) as server:
        conn = http.client.HTTPConnection("127.0.0.1", server.http_port, timeout=30)
        body = (b'{"inputs": [{"name": "INPUT0", "shape": [1, 16], "datatype": "INT32", '
                b'"data": [' + b", ".join(b"1" for _ in range(16)) + b']}, '
                b'{"name": "INPUT1", "shape": [1, 16], "datatype": "INT32", "data": ['
                + b", ".join(b"2" for _ in range(16)) + b"]}]}")
        conn.request("POST", "/v2/models/simple/infer", body=body,
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        assert response.status == 200
        declared = int(response.getheader("Content-Length"))
        with pytest.raises(http.client.IncompleteRead) as info:
            response.read()
        assert len(info.value.partial) == declared // 2
        conn.close()
        assert server.chaos.injected == {"truncate": 1}
        # paths out of scope are never touched
        with urllib.request.urlopen(f"http://{server.http_url}/v2/health/live",
                                    timeout=30) as live:
            assert live.status == 200
        assert server.chaos.injected == {"truncate": 1}


def test_added_latency_shows_on_matched_paths_only():
    with InProcessServer(device="cpu", chaos=ChaosPolicy(latency_s=0.3)) as server:
        with port_http.InferenceServerClient(server.http_url) as client:
            client.infer("simple", _inputs(port_http))  # warm the connection
            t0 = time.monotonic()
            client.infer("simple", _inputs(port_http))
            infer_s = time.monotonic() - t0
            t0 = time.monotonic()
            assert client.is_server_live()
            live_s = time.monotonic() - t0
        assert server.chaos.injected == {}
    assert infer_s >= 0.3
    assert live_s < 0.3


@pytest.mark.parametrize("grpc", [True, "native"])
def test_chaos_is_refused_beside_the_grpc_front_end(grpc):
    with pytest.raises(ValueError, match="chaos injection is not supported by the native gRPC"):
        InProcessServer(device="cpu", grpc=grpc, chaos=ChaosPolicy(error_rate=0.1))
    # the reference refuses its native front-end in the same words
    with pytest.raises(ValueError, match="chaos injection is not supported by the native gRPC"):
        RefServer(grpc="native", chaos=RefChaosPolicy(error_rate=0.1))

"""The port's shared-memory slot ring against the JAX package's, on the CPU.

- Framing: for seeded inputs of every wire dtype (BF16 and BYTES among
  them, a 0-d and empty tensors), the port's ``pack_tensors`` writes the
  JAX package's bytes, each ``unpack_tensors`` reads the other's slot,
  and a torch tensor packs as its host array.
- Ring semantics, twins of ``tests/test_shm_ring.py``'s cases on the
  port's server (``client_tpu_torch.testing.InProcessServer``,
  ``device="cpu"``) and client: header validation, a slot too small,
  wraparound, once-only tickets and a stale completion dropped, a
  response too large, torn and stale slots, inline inputs refused, a
  restarted server and re-registration, the registry pruning an
  unregistered ring, concurrent producers, and concurrent stage and
  release keeping every slot to one ticket.
- Batching: ring requests to a batchable model share executions exactly
  as inline requests do (their ring parameters leave the request before
  the batch signature), and each request's rows come back in its own
  slot.

Every region name carries a ``uuid`` (test files run in parallel
processes that share ``/dev/shm``).
"""

import asyncio
import struct
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from client_tpu.utils.tpu_shared_memory import ring as jax_ringfmt
import client_tpu_torch.http as httpclient
import client_tpu_torch.http.aio as aioclient
from client_tpu_torch.server.core import CoreResponse, CoreTensor
from client_tpu_torch.server.model_repository import Model
from client_tpu_torch.server.shm_ring import RingTicket
from client_tpu_torch.testing import InProcessServer
from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils.tpu_shared_memory import ring as ringfmt
from client_tpu_torch.utils.tpu_shared_memory.ring import ShmRing, ShmRingError

torch.set_num_threads(1)

ONES = np.ones((1, 16), dtype=np.int32)


def _case(kind):
    rng = np.random.default_rng(sum(kind.encode()))
    if kind == "BYTES":
        return np.array([b"alpha", b"", "été".encode()], dtype=object).reshape(3, 1)
    if kind == "BYTES empty":
        return np.empty([0], dtype=object)
    if kind == "FP32 0-d":
        return np.array(rng.normal(), dtype=np.float32)
    if kind == "INT32 empty":
        return np.zeros([0, 3], dtype=np.int32)
    if kind == "BF16":
        return rng.normal(size=[2, 5]).astype(ml_dtypes.bfloat16)
    if kind == "BOOL":
        return rng.integers(0, 2, size=[7]).astype(np.bool_)
    dtype = np.dtype({"INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
                      "INT64": np.int64, "UINT8": np.uint8, "UINT16": np.uint16,
                      "UINT32": np.uint32, "UINT64": np.uint64, "FP16": np.float16,
                      "FP32": np.float32, "FP64": np.float64}[kind])
    if dtype.kind == "f":
        return rng.normal(size=[3, 4]).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=[3, 4], dtype=dtype, endpoint=True)


WIRE_CASES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
              "UINT64", "FP16", "FP32", "FP64", "BF16", "BYTES", "FP32 0-d", "INT32 empty",
              "BYTES empty"]


def _same_tensor(got, want):
    if want.dtype == np.dtype(object):
        return got.shape == want.shape and list(got.reshape(-1)) == list(want.reshape(-1))
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", WIRE_CASES)
def test_pack_tensors_is_byte_identical_to_client_tpu(kind):
    tensors = [("IN_" + kind.replace(" ", "_"), _case(kind)), ("SECOND", _case("FP32"))]
    ours, theirs = bytearray(4096), bytearray(4096)
    n = ringfmt.pack_tensors(memoryview(ours), tensors)
    assert n == jax_ringfmt.pack_tensors(memoryview(theirs), tensors)
    assert ours[:n] == theirs[:n]
    for unpack, view in ((ringfmt, ringfmt), (jax_ringfmt, jax_ringfmt)):
        for buf in (ours, theirs):  # each side reads the other's slot
            got = unpack.unpack_tensors(memoryview(buf), n)
            assert [(name, list(shape)) for name, _, shape, _ in got] == \
                [(name, list(a.shape)) for name, a in tensors]
            for (_, datatype, shape, data), (_, want) in zip(got, tensors):
                assert _same_tensor(view.view_as_numpy(datatype, shape, data), want)


def test_torch_tensors_pack_as_their_host_arrays():
    host = [("A", _case("BF16")), ("B", _case("INT64")), ("C", _case("FP32 0-d"))]
    tensors = [("A", torch.from_numpy(host[0][1].view(np.int16)).view(torch.bfloat16)),
               ("B", torch.from_numpy(host[1][1])), ("C", torch.tensor(float(host[2][1])))]
    ours, theirs = bytearray(1024), bytearray(1024)
    n = ringfmt.pack_tensors(memoryview(ours), tensors)
    assert n == jax_ringfmt.pack_tensors(memoryview(theirs), host)
    assert ours[:n] == theirs[:n]


def test_ring_header_validation():
    buf = memoryview(bytearray(4096))
    with pytest.raises(ShmRingError, match="no TPURING1 header"):
        ringfmt.read_region_header(buf)
    ringfmt.write_region_header(buf, slot_size=256, n_slots=4)
    assert ringfmt.read_region_header(buf) == (256, 4)
    other = memoryview(bytearray(4096))
    jax_ringfmt.write_region_header(other, slot_size=256, n_slots=4)
    assert bytes(buf[:ringfmt.HEADER_SIZE]) == bytes(other[:ringfmt.HEADER_SIZE])
    ringfmt.write_region_header(buf, slot_size=4096, n_slots=400)
    with pytest.raises(ShmRingError, match="holds only"):
        ringfmt.read_region_header(buf)


def test_ring_slot_too_small():
    ring = ShmRing(n_slots=2, slot_size=128)
    try:
        with pytest.raises(ShmRingError, match="slot too small"):
            ring.stage([("BIG", np.zeros(1024, dtype=np.float32))])
        ticket = ring.stage([("OK", np.zeros(4, dtype=np.float32))])  # the slot came back
        ring.release(ticket)
    finally:
        ring.close()


def test_ring_slot_wraparound():
    """More requests than slots: slots recycle, seqs advance, no live
    slot is handed out twice."""
    ring = ShmRing(n_slots=2, slot_size=1024)
    try:
        seen = []
        for i in range(11):
            ticket = ring.stage([("X", np.full(4, i, dtype=np.int32))])
            seen.append((ticket.slot, ticket.seq))
            view = ring._slot_view(ticket.slot)
            _, _, payload_len, _ = struct.unpack_from("<IIII", view, 0)
            tensors = ringfmt.unpack_tensors(view[ringfmt.SLOT_HEADER_SIZE:], payload_len)
            np.testing.assert_array_equal(ringfmt.view_as_numpy(*tensors[0][1:]),
                                          np.full(4, i, dtype=np.int32))
            ring.release(ticket)
        assert ring.staged_total == 11
        for slot in {s for s, _ in seen}:
            seqs = [q for s, q in seen if s == slot]
            assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        t_a = ring.stage([("A", np.zeros(2, np.int32))])
        t_b = ring.stage([("B", np.zeros(2, np.int32))])
        assert t_a.slot != t_b.slot
        ring.release(t_a)
        ring.release(t_b)
    finally:
        ring.close()


def test_concurrent_stage_and_release_keep_each_slot_to_one_ticket():
    """More threads than slots and cores stage, check and release: no two
    live tickets ever share a slot and each slot holds its ticket's bytes
    until released."""
    ring = ShmRing(n_slots=3, slot_size=256, acquire_timeout_s=30)
    live, lock, errors = {}, threading.Lock(), []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(worker):
        try:
            for i in range(40):
                value = worker * 1000 + i
                ticket = ring.stage([("X", np.full(8, value, dtype=np.int64))])
                with lock:
                    if ticket.slot in live:
                        errors.append(f"slot {ticket.slot} handed out twice")
                    live[ticket.slot] = value
                view = ring._slot_view(ticket.slot)
                _, seq, n, _ = struct.unpack_from("<IIII", view, 0)
                (_, datatype, shape, data), = ringfmt.unpack_tensors(
                    view[ringfmt.SLOT_HEADER_SIZE:], n)
                if seq != ticket.seq or ringfmt.view_as_numpy(datatype, shape, data)[0] != value:
                    errors.append(f"slot {ticket.slot} lost worker {worker}'s bytes")
                with lock:
                    del live[ticket.slot]
                ring.release(ticket)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(w,)) for w in range(8)]
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
    finally:
        sys.setswitchinterval(interval)
        ring.close()
    assert not any(thread.is_alive() for thread in threads)
    assert errors == []
    assert ring.staged_total == 8 * 40


# ---------------------------------------------------------------------------
# the ring through the port's server and client
# ---------------------------------------------------------------------------


class _SlowAdd(Model):
    """A batchable AddSub that holds each execution 0.3 s, so requests
    that arrive meanwhile queue and merge into the next batch."""

    name = "slow_add"
    max_batch_size = 8
    inputs = [{"name": "INPUT0", "datatype": "INT32", "shape": [16]},
              {"name": "INPUT1", "datatype": "INT32", "shape": [16]}]
    outputs = [{"name": "OUTPUT0", "datatype": "INT32", "shape": [16]},
               {"name": "OUTPUT1", "datatype": "INT32", "shape": [16]}]

    def execute(self, inputs, parameters):
        time.sleep(0.3)
        a, b = inputs["INPUT0"], inputs["INPUT1"]
        return {"OUTPUT0": a + b, "OUTPUT1": a - b}


@pytest.fixture(scope="module")
def server():
    with InProcessServer(device="cpu") as srv:
        srv.core.repository.add_model(_SlowAdd())
        yield srv


@pytest.fixture
def client(server):
    client = httpclient.InferenceServerClient(server.http_url)
    yield client
    client.close()


@pytest.fixture
def ring(client):
    ring = ShmRing(n_slots=4, slot_size=2048)
    ring.register(client)
    yield ring
    client.unregister_tpu_shared_memory(ring.region_name)
    ring.close()


def _simple_response(arr):
    return CoreResponse(model_name="simple", model_version="", id="",
                        outputs=[CoreTensor("OUTPUT0", "INT32", [1, 16], arr)])


def test_ring_ticket_once_only_and_stale_completion(server, ring):
    server_ring = server.core.shm_rings.get(ring.region_name)
    arr = np.arange(16, dtype=np.int32).reshape(1, 16)

    staged = ring.stage([("INPUT0", arr), ("INPUT1", ONES)])  # double fail: one decrement
    server_ring.read_request(staged.slot, staged.seq)
    assert server_ring._in_use == 1
    ticket = RingTicket(server_ring, staged.slot, staged.seq)
    ticket.fail()
    ticket.fail()
    assert server_ring._in_use == 0
    ring.release(staged)

    staged = ring.stage([("INPUT0", arr), ("INPUT1", ONES)])  # fail after complete: no-op
    server_ring.read_request(staged.slot, staged.seq)
    ticket = RingTicket(server_ring, staged.slot, staged.seq)
    slim = ticket.complete(_simple_response(arr))
    ticket.fail()
    np.testing.assert_array_equal(ring.take_response(staged)["OUTPUT0"], arr)
    assert server_ring._in_use == 0 and slim.outputs == []
    assert slim.parameters["shm_ring_slot"] == staged.slot
    with pytest.raises(InferenceServerException, match="already completed"):
        ticket.complete(_simple_response(arr))
    ring.release(staged)

    # the client gave up and re-staged the slot: the old ticket's
    # completion must not touch the new request's bytes
    first = ring.stage([("INPUT0", arr), ("INPUT1", ONES)])
    server_ring.read_request(first.slot, first.seq)
    old_ticket = RingTicket(server_ring, first.slot, first.seq)
    ring.release(first)
    second = ring.stage([("INPUT0", arr * 2), ("INPUT1", ONES)])
    assert second.slot == first.slot
    with pytest.raises(InferenceServerException, match="stale completion dropped"):
        old_ticket.complete(_simple_response(arr))
    assert server_ring._in_use == 0
    tensors = server_ring.read_request(second.slot, second.seq)
    np.testing.assert_array_equal(tensors[0].data, arr * 2)
    RingTicket(server_ring, second.slot, second.seq).fail()
    ring.release(second)


def test_ring_response_too_large_is_a_clean_error(server, client):
    # the response's "OUTPUT0" is one byte longer than the request's
    # "INPUT0": a slot sized exactly for the request cannot hold it
    needed = 4 + (2 + 6) + (1 + 4) + (1 + 8) + (4 + 64)
    ring = ShmRing(n_slots=1, slot_size=ringfmt.SLOT_HEADER_SIZE + needed)
    try:
        ring.register(client)
        with pytest.raises(InferenceServerException) as err:
            ring.infer(client, "identity_fp32", [("INPUT0", np.arange(16, dtype=np.float32))])
        assert "slot too small" in err.value.message().lower()
        assert server.core.shm_rings.get(ring.region_name)._in_use == 0
    finally:
        client.unregister_tpu_shared_memory(ring.region_name)
        ring.close()


def test_ring_torn_write_and_stale_seq(client, ring):
    arr = np.arange(16, dtype=np.int32).reshape(1, 16)
    ticket = ring.stage([("INPUT0", arr), ("INPUT1", ONES)])
    params = dict(ticket.parameters, shm_ring_seq=ticket.seq + 1)
    with pytest.raises(InferenceServerException, match="stale or torn"):
        client.infer("simple", [], parameters=params)
    ring.release(ticket)

    ticket = ring.stage([("INPUT0", arr), ("INPUT1", ONES)])
    struct.pack_into("<I", ring._slot_view(ticket.slot), 0, ringfmt.STATE_FREE)
    with pytest.raises(InferenceServerException, match="not in the request-ready"):
        client.infer("simple", [], parameters=dict(ticket.parameters))
    ring.release(ticket)

    with pytest.raises(InferenceServerException, match="out of range"):
        client.infer("simple", [], parameters={"shm_ring_region": ring.region_name,
                                               "shm_ring_slot": 99, "shm_ring_seq": 1})
    outs = ring.infer(client, "simple", [("INPUT0", arr), ("INPUT1", ONES)])
    np.testing.assert_array_equal(outs["OUTPUT0"], arr + ONES)


def test_ring_inline_inputs_are_refused(client, ring):
    ticket = ring.stage([("INPUT0", np.zeros((1, 16), np.int32)), ("INPUT1", ONES)])
    inline = httpclient.InferInput("INPUT0", [1, 16], "INT32")
    inline.set_data_from_numpy(np.zeros((1, 16), np.int32))
    with pytest.raises(InferenceServerException, match="must not also carry inline"):
        client.infer("simple", [inline], parameters=dict(ticket.parameters))
    ring.release(ticket)


def test_ring_after_a_server_restart_is_refused_then_reregistered():
    """A live client ring against a restarted server (empty region
    table): a clean error naming the region unavailable, no corruption;
    re-registering restores service."""
    ring = ShmRing(n_slots=4, slot_size=2048)
    arr = np.arange(16, dtype=np.int32).reshape(1, 16)
    try:
        with InProcessServer(device="cpu") as first:
            client = httpclient.InferenceServerClient(first.http_url)
            ring.register(client)
            outs = ring.infer(client, "simple", [("INPUT0", arr), ("INPUT1", ONES)])
            np.testing.assert_array_equal(outs["OUTPUT0"], arr + ONES)
            client.close()
        with InProcessServer(device="cpu") as second:
            client = httpclient.InferenceServerClient(second.http_url)
            try:
                with pytest.raises(InferenceServerException) as err:
                    ring.infer(client, "simple", [("INPUT0", arr), ("INPUT1", ONES)])
                assert "unavailable" in err.value.message().lower()
                assert err.value.status() == "400"  # the JAX server's HTTP status
                ring.register(client)
                outs = ring.infer(client, "simple", [("INPUT0", arr), ("INPUT1", ONES)])
                np.testing.assert_array_equal(outs["OUTPUT0"], arr + ONES)
                np.testing.assert_array_equal(outs["OUTPUT1"], arr - ONES)
                client.unregister_tpu_shared_memory(ring.region_name)
            finally:
                client.close()
    finally:
        ring.close()


def test_ring_registry_prunes_an_unregistered_ring(server, client):
    ring = ShmRing(n_slots=2, slot_size=2048)
    try:
        ring.register(client)
        arr = np.arange(16, dtype=np.int32).reshape(1, 16)
        ring.infer(client, "simple", [("INPUT0", arr), ("INPUT1", ONES)])
        registry = server.core.shm_rings
        assert ring.region_name in registry._rings
        client.unregister_tpu_shared_memory(ring.region_name)
        registry.prune()
        assert ring.region_name not in registry._rings
    finally:
        ring.close()


def test_ring_concurrent_producers(client):
    """Six threads share one ring: every answer matches its own inputs."""
    ring = ShmRing(n_slots=16, slot_size=4096)
    errors = []
    try:
        ring.register(client)

        def work(worker):
            try:
                for i in range(15):
                    arr = np.full((1, 16), worker * 1000 + i, dtype=np.int32)
                    outs = ring.infer(client, "simple", [("INPUT0", arr), ("INPUT1", ONES)])
                    np.testing.assert_array_equal(outs["OUTPUT0"], arr + ONES)
                    np.testing.assert_array_equal(outs["OUTPUT1"], arr - ONES)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(w,)) for w in range(6)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
        assert not any(thread.is_alive() for thread in threads)
        assert not errors, errors
    finally:
        client.unregister_tpu_shared_memory(ring.region_name)
        ring.close()


def _executions(client, model):
    stats = client.get_inference_statistics(model)["model_stats"][0]
    return stats["inference_count"], stats["execution_count"]


def test_ring_requests_share_batches_as_inline_requests(server, client):
    """8 concurrent ring requests to a batchable model merge into as few
    executions as 8 inline ones (the first executes alone, the other 7
    queue behind it and run as one batch), each answer in its own slot."""
    ring = ShmRing(n_slots=8, slot_size=2048)
    arrays = [np.full((1, 16), 10 * k, dtype=np.int32) for k in range(8)]
    try:
        ring.register(client)

        async def burst(route):
            async with aioclient.InferenceServerClient(server.http_url) as aio:
                async def one(arr):
                    if route == "ring":
                        return await ring.ainfer(aio, "slow_add",
                                                 [("INPUT0", arr), ("INPUT1", ONES)])
                    inputs = [aioclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                              for n, a in (("INPUT0", arr), ("INPUT1", ONES))]
                    result = await aio.infer("slow_add", inputs)
                    return {o: result.as_numpy(o) for o in ("OUTPUT0", "OUTPUT1")}

                return await asyncio.gather(*(one(arr) for arr in arrays))

        counts = {}
        for route in ("inline", "ring"):
            rows0, runs0 = _executions(client, "slow_add")
            answers = asyncio.run(burst(route))
            rows1, runs1 = _executions(client, "slow_add")
            counts[route] = (rows1 - rows0, runs1 - runs0)
            for arr, out in zip(arrays, answers):
                np.testing.assert_array_equal(out["OUTPUT0"], arr + ONES)
                np.testing.assert_array_equal(out["OUTPUT1"], arr - ONES)
        # without the ring parameters popped, each slot number would be a
        # batch signature of its own: 8 executions
        assert all(rows == 8 and runs <= 2 for rows, runs in counts.values()), counts
        assert server.core.shm_rings.get(ring.region_name)._in_use == 0
    finally:
        client.unregister_tpu_shared_memory(ring.region_name)
        ring.close()

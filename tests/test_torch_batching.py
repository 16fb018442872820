"""Dynamic and ragged batching in the port's ``ServerCore``.

Twins of ``tests/test_dynamic_batching.py`` and
``tests/test_ragged_batching.py`` against ``client_tpu_torch``: concurrent
requests to a batchable model share executions (inference_count counts
rows, execution_count executions, as Triton's statistics extension does),
respect ``max_batch_size``, batch apart when their signatures or
parameters differ, fail alone when malformed, and skip the batcher in
their unbatched form. Ragged requests (``allow_ragged_batch``) of
different lengths share one execution, padded to a shared bucket, and
the tiny fp32 ``text_encoder`` gives each the answer it gives alone
(within 1e-5, on the CPU).
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from client_tpu_torch.models import bert
from client_tpu_torch.models.serving import TextEncoderModel
from client_tpu_torch.scheduling import QueueTimeoutError
from client_tpu_torch.server.core import CoreRequest, CoreTensor, ServerCore
from client_tpu_torch.server.model_repository import Model, ModelRepository
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

TOL = 1e-5


class _CountingBatchModel(Model):
    """Batchable add-one model that records every execute() batch size;
    it answers with a torch tensor, which the core reads back."""

    name = "batch_counter"
    max_batch_size = 16
    inputs = [{"name": "X", "datatype": "FP32", "shape": [4]}]
    outputs = [{"name": "Y", "datatype": "FP32", "shape": [4]}]

    def __init__(self):
        self.batch_sizes = []
        self.parameters = []

    def execute(self, inputs, parameters):
        x = inputs["X"]
        self.batch_sizes.append(x.shape[0])
        self.parameters.append(dict(parameters))
        return {"Y": torch.from_numpy(x.copy()) + 1.0}


class _RecordingEncoder(Model):
    """Ragged-batchable model that records every executed batch shape."""

    name = "rec_encoder"
    max_batch_size = 8
    allow_ragged_batch = True
    ragged_pad_value = 0
    inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]
    outputs = [{"name": "SUM", "datatype": "INT32", "shape": [1]}]

    def __init__(self, cap=None):
        self.batches = []
        self.ragged_dim_cap = cap

    def execute(self, inputs, parameters):
        ids = inputs["INPUT_IDS"]
        self.batches.append(tuple(ids.shape))
        # padding is zeros, so a row sum is length-independent
        return {"SUM": ids.sum(axis=1, keepdims=True).astype(np.int32)}


def _request(value: float, rows: int = 1, cols: int = 4, name: str = "X",
             model: str = "batch_counter"):
    data = np.full([rows, cols], value, dtype=np.float32)
    return CoreRequest(model_name=model,
                       inputs=[CoreTensor(name, "FP32", list(data.shape), data)])


def _ids_request(values, model="rec_encoder"):
    arr = np.asarray([values], dtype=np.int32)
    return CoreRequest(model_name=model,
                       inputs=[CoreTensor("INPUT_IDS", "INT32", list(arr.shape), arr)])


@pytest.fixture()
def core():
    repository = ModelRepository()
    model = _CountingBatchModel()
    repository.add_model(model)
    core = ServerCore(repository, max_workers=2)
    yield core, model
    core.close()


def _gather(core, requests, **kwargs):
    async def run():
        return await asyncio.gather(*(core.infer(r) for r in requests), **kwargs)

    return asyncio.run(run())


def test_concurrent_requests_share_executions(core):
    core_obj, model = core
    responses = _gather(core_obj, [_request(float(i)) for i in range(12)])
    for i, resp in enumerate(responses):
        assert resp.outputs[0].datatype == "FP32"
        np.testing.assert_allclose(resp.outputs[0].data, float(i) + 1.0)
    assert len(model.batch_sizes) < 12
    assert sum(model.batch_sizes) == 12
    stats = core_obj.statistics("batch_counter")["model_stats"][0]
    assert stats["inference_count"] == 12
    assert stats["execution_count"] == len(model.batch_sizes)
    assert stats["inference_stats"]["success"]["count"] == 12


@pytest.mark.parametrize("rows,requests", [(3, 10), (16, 3), (5, 7)])
def test_batch_respects_max_batch_size(core, rows, requests):
    core_obj, model = core
    responses = _gather(core_obj, [_request(1.0, rows=rows) for _ in range(requests)])
    assert len(responses) == requests
    assert all(r.outputs[0].shape == [rows, 4] for r in responses)
    assert all(b <= model.max_batch_size for b in model.batch_sizes)
    assert sum(model.batch_sizes) == rows * requests


def test_varying_rows_share_batches(core):
    core_obj, model = core
    responses = _gather(core_obj, [_request(1.0) for _ in range(4)]
                        + [_request(2.0, rows=2) for _ in range(2)])
    assert [r.outputs[0].shape[0] for r in responses] == [1, 1, 1, 1, 2, 2]
    assert sum(model.batch_sizes) == 8
    assert len(model.batch_sizes) < 6


@pytest.mark.parametrize("split", ["cols", "parameters"])
def test_incompatible_requests_batch_apart(core, split):
    """Different non-batch dims, or different execution parameters, are
    never merged; scheduling parameters alone do not split a batch."""
    core_obj, model = core
    first = [_request(1.0) for _ in range(3)]
    if split == "cols":
        second = [_request(2.0, cols=5) for _ in range(3)]
    else:
        second = [_request(2.0) for _ in range(3)]
        for r in second:
            r.parameters = {"mode": "other"}
        for r in first:
            r.parameters = {"priority": 1, "timeout": 10_000_000}
    results = _gather(core_obj, first + second, return_exceptions=True)
    assert not any(isinstance(r, Exception) for r in results)
    assert len(model.batch_sizes) >= 2
    assert sum(model.batch_sizes) == 6
    for resp, expect in zip(results, [2.0] * 3 + [3.0] * 3):
        np.testing.assert_allclose(resp.outputs[0].data, expect)
    if split == "parameters":
        # the mode="other" requests ran in executions of their own
        assert {"mode": "other"} in model.parameters
        assert all(p.get("mode") == "other" or "mode" not in p for p in model.parameters)


@pytest.mark.parametrize("bad", ["unexpected_input", "over_max_batch", "mismatched_dims",
                                 "out_of_vocabulary", "over_ragged_cap"])
def test_bad_request_fails_alone(core, bad):
    core_obj, model = core
    name = "batch_counter"
    good = [_request(float(i)) for i in range(3)]
    if bad == "unexpected_input":
        broken = _request(9.0, name="WRONG")
        message = "unexpected inference input"
    elif bad == "over_max_batch":
        broken = _request(9.0, rows=model.max_batch_size + 1)
        message = "batch-size must be"
    elif bad == "mismatched_dims":
        broken = _request(9.0, rows=2)
        broken.inputs.append(CoreTensor("X2", "FP32", [3, 4], np.zeros([3, 4], np.float32)))
        model.inputs = model.inputs + [{"name": "X2", "datatype": "FP32", "shape": [4]}]
        message = "share the batch dimension"
    else:
        # the ragged text_encoder: what it refuses must be refused before
        # the request is merged with good ones
        name = "text_encoder"
        config = bert.BertConfig.tiny(dtype=torch.float32)
        core_obj.repository.add_model(TextEncoderModel(config=config, device="cpu"))
        good = [_ids_request([5] * n, name) for n in (3, 9, 17)]
        if bad == "out_of_vocabulary":
            broken = _ids_request([4, config.vocab_size, 2], name)
            message = "token ids must lie in"
        else:
            broken = _ids_request([1] * (config.max_seq_len + 1), name)
            message = "exceeds max"
    results = _gather(core_obj, good + [broken], return_exceptions=True)
    assert all(not isinstance(r, Exception) for r in results[:3])
    assert isinstance(results[3], InferenceServerException)
    assert message in results[3].message()
    stats = core_obj.statistics(name)["model_stats"][0]
    assert stats["inference_stats"]["fail"]["count"] == 1
    assert stats["inference_count"] == 3
    assert stats["execution_count"] == 1


def test_single_request_sees_no_batching(core):
    core_obj, model = core
    resp = asyncio.run(core_obj.infer(_request(5.0)))
    np.testing.assert_allclose(resp.outputs[0].data, 6.0)
    assert model.batch_sizes == [1]


def test_unbatched_form_bypasses_batcher():
    class _FlexModel(Model):
        name = "flex"
        max_batch_size = 8
        inputs = [{"name": "X", "datatype": "FP32", "shape": [4, 4, 3]}]
        outputs = [{"name": "Y", "datatype": "FP32", "shape": [4, 4, 3]}]

        def execute(self, inputs, parameters):
            x = inputs["X"]
            if x.ndim == 3:
                x = x[None]
            return {"Y": x + 1.0}

    repository = ModelRepository()
    repository.add_model(_FlexModel())
    core_obj = ServerCore(repository, max_workers=1)
    try:
        data = np.zeros([4, 4, 3], dtype=np.float32)
        req = CoreRequest(model_name="flex", inputs=[CoreTensor("X", "FP32", [4, 4, 3], data)])
        resp = asyncio.run(core_obj.infer(req))
        assert resp.outputs[0].shape == [1, 4, 4, 3]
        assert core_obj._batchers == {}
        stats = core_obj.statistics("flex")["model_stats"][0]
        assert stats["inference_count"] == 1 and stats["execution_count"] == 1
    finally:
        core_obj.close()


def test_queue_deadline_fails_before_execution():
    class _Slow(_CountingBatchModel):
        def execute(self, inputs, parameters):
            time.sleep(0.2)
            return super().execute(inputs, parameters)

    repository = ModelRepository()
    model = _Slow()
    repository.add_model(model)
    core_obj = ServerCore(repository, max_workers=1)
    try:
        late = _request(2.0)
        late.parameters = {"timeout": 1000, "mode": "x"}  # 1 ms, its own signature
        results = _gather(core_obj, [_request(1.0), late], return_exceptions=True)
        assert not isinstance(results[0], Exception)
        assert isinstance(results[1], QueueTimeoutError)
        assert sum(model.batch_sizes) == 1
    finally:
        core_obj.close()


# ---------------------------------------------------------------------------
# ragged batching
# ---------------------------------------------------------------------------


def _ragged_core(model):
    repository = ModelRepository()
    repository.add_model(model)
    return ServerCore(repository, max_workers=2)


@pytest.mark.parametrize("cap,bucket", [(None, 8), (6, 6)])
def test_mixed_lengths_share_one_execution(cap, bucket):
    model = _RecordingEncoder(cap)
    core = _ragged_core(model)

    async def run():
        # one lead request occupies the first execution while three of
        # different lengths pile up; the drain must merge them
        lead = asyncio.ensure_future(core.infer(_ids_request([1, 2, 3])))
        await asyncio.sleep(0)
        followers = [core.infer(_ids_request([10] * 2)), core.infer(_ids_request([7] * 5)),
                     core.infer(_ids_request([1] * 4))]
        return await asyncio.gather(lead, *followers)

    try:
        results = asyncio.run(run())
        assert [int(r.outputs[0].data[0, 0]) for r in results] == [6, 20, 35, 4]
        stats = core.statistics("rec_encoder")["model_stats"][0]
        assert stats["inference_count"] == 4
        assert stats["execution_count"] < stats["inference_count"]
        merged = [b for b in model.batches if b[0] > 1]
        # lengths 2/5/4 padded to the shared bucket (clamped to the cap)
        assert merged and merged[0] == (3, bucket)
    finally:
        core.close()


def test_ragged_signature_keeps_ranks_and_fixed_dims_apart():
    class Fixed(Model):
        name = "fixed"
        max_batch_size = 8
        inputs = [{"name": "X", "datatype": "INT32", "shape": [3]}]
        outputs = [{"name": "Y", "datatype": "INT32", "shape": [3]}]

        def __init__(self):
            self.batches = []

        def execute(self, inputs, parameters):
            self.batches.append(tuple(inputs["X"].shape))
            return {"Y": inputs["X"]}

    model = Fixed()
    core = _ragged_core(model)

    async def run():
        req_a = CoreRequest("fixed", inputs=[CoreTensor("X", "INT32", [1, 3],
                                                        np.zeros([1, 3], np.int32))])
        req_b = CoreRequest("fixed", inputs=[CoreTensor("X", "INT32", [1, 4],
                                                        np.zeros([1, 4], np.int32))])
        lead = asyncio.ensure_future(core.infer(req_a))
        await asyncio.sleep(0)
        return await asyncio.gather(lead, core.infer(req_b))

    try:
        asyncio.run(run())
        assert sorted(model.batches) == [(1, 3), (1, 4)]
    finally:
        core.close()


def test_text_encoder_mixed_lengths_share_an_execution_and_keep_their_answers():
    config = bert.BertConfig.tiny(dtype=torch.float32)
    params = bert.init_params(torch.Generator().manual_seed(3), config, "cpu")
    model = TextEncoderModel(config=config, params=params, device="cpu")
    core = _ragged_core(model)
    rng = np.random.default_rng(11)
    seqs = [rng.integers(1, config.vocab_size, n).tolist() for n in (9, 3, 37, 120, 1)]
    alone = [model.execute({"INPUT_IDS": np.array([s], np.int32)}, {})["EMBEDDING"][0]
             for s in seqs]

    async def run():
        lead = asyncio.ensure_future(core.infer(_ids_request(seqs[0], "text_encoder")))
        await asyncio.sleep(0)
        rest = [core.infer(_ids_request(s, "text_encoder")) for s in seqs[1:]]
        return await asyncio.gather(lead, *rest)

    try:
        results = asyncio.run(run())
        for response, want in zip(results, alone):
            assert response.outputs[0].shape == [1, config.d_model]
            np.testing.assert_allclose(response.outputs[0].data[0], want, rtol=0, atol=TOL)
        stats = core.statistics("text_encoder")["model_stats"][0]
        assert stats["inference_count"] == len(seqs)
        assert stats["execution_count"] == 2  # the lead alone, then the other four
    finally:
        core.close()


# ---------------------------------------------------------------------------
# admission: queue policy and priorities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("declared", [
    {},
    {"priority_levels": 3},
    {"priority_levels": 3, "default_priority_level": 2},
    {"priority_levels": 2, "queue_policy": {"default_timeout_us": 500,
                                            "allow_timeout_override": False}},
    {"queue_policy": {"max_queue_size": 4, "default_timeout_us": 70}},
])
def test_queue_policy_resolves_as_client_tpu(declared):
    from client_tpu.scheduling import QueuePolicy as JaxQueuePolicy
    from client_tpu_torch.scheduling import QueuePolicy

    model = type("Declared", (Model,), dict(declared))()
    ours, theirs = QueuePolicy.from_model(model), JaxQueuePolicy.from_model(model)
    assert (ours.levels, ours.max_queue_size) == (theirs.levels, theirs.max_queue_size)
    for parameters in ({}, {"priority": 1}, {"priority": 9}, {"priority": "x"},
                       {"timeout": 250}, {"timeout_us": "40"}, {"timeout": -1},
                       {"priority": 2, "timeout": 10}):
        assert ours.priority_of(parameters) == theirs.priority_of(parameters)
        assert ours.timeout_us_of(parameters) == theirs.timeout_us_of(parameters)
        assert ours.deadline_ns(parameters, 1000) == theirs.deadline_ns(parameters, 1000)
    # "continue" (DELAY) is accepted as the reference accepts it; an
    # action neither package knows is refused by both
    assert QueuePolicy(timeout_action="continue").timeout_action == "continue"
    JaxQueuePolicy(timeout_action="continue")
    for policy_cls in (QueuePolicy, JaxQueuePolicy):
        with pytest.raises(ValueError):
            policy_cls(timeout_action="drop")


def test_higher_priority_executes_first():
    class _Prioritized(_CountingBatchModel):
        priority_levels = 2

        def execute(self, inputs, parameters):
            time.sleep(0.2)
            return super().execute(inputs, parameters)

    repository = ModelRepository()
    model = _Prioritized()
    repository.add_model(model)
    core_obj = ServerCore(repository, max_workers=1)

    async def run():
        lead = asyncio.ensure_future(core_obj.infer(_request(0.0)))
        await asyncio.sleep(0.01)  # the lead is executing
        low, high = _request(1.0), _request(2.0)
        low.parameters = {"priority": 2, "mode": "low"}
        high.parameters = {"priority": 1, "mode": "high"}
        return await asyncio.gather(lead, core_obj.infer(low), core_obj.infer(high))

    try:
        asyncio.run(run())
        modes = [p.get("mode") for p in model.parameters]
        assert modes == [None, "high", "low"]
    finally:
        core_obj.close()

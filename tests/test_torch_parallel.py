"""The port's ``parallel/`` package against the JAX package's.

- ``MeshSpec.parse`` normalises every declaration as the JAX copy does,
  and refuses every malformed one with the same message;
- ``resolve`` gives the reference's too-few reason, and takes an explicit
  device list that repeats a device; ``describe()`` has the reference's
  keys;
- ``shard_slices`` and ``shard_tree`` cut tensors per spec;
- the collectives reduce in fp32 and cast once, gather and rotate;
- ``ShardedExecutor`` pads, places, gathers and trims, on a fake clock;
- ring attention over sp 2 and 4 shards, causal and not, within 1e-5 of
  the JAX ``reference_attention`` on the same inputs;
- the port's ``llama.forward`` with sp=2 and with tp=2 within 1e-4 of
  the JAX ``forward(mesh=None)``.

Every mesh here is ``[cpu] * n``: the port's counterpart of the reference
tests' virtual CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import llama as jax_llama
from client_tpu.parallel.ring_attention import reference_attention as jax_reference_attention
from client_tpu.parallel import sharding as jax_sharding
from client_tpu_torch.models import llama
from client_tpu_torch.parallel import (
    ShardedExecutor,
    collectives,
    create_mesh,
    plan_for_model,
    ring_attention,
    sharding,
)
from client_tpu_torch.parallel.ring_attention import reference_attention
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

CPU = torch.device("cpu")

GOOD = [
    {"axes": {"dp": 2, "tp": 2}, "inputs": {"X": ["dp", None]}, "outputs": {"Y": ["dp"]}},
    {"axes": {"sp": 4}, "inputs": {"X": [None, "sp"]}},
    {"axes": {"dp": 2, "tp": 2}, "inputs": {"X": [["dp", "tp"], None]}},
    {"axes": {"dp": 1, "tp": 1, "sp": 2}, "inputs": {"INPUT_IDS": [None, "sp"]},
     "outputs": {"LOGITS": [None, None]}},
    {"axes": {"tp": 8}},
]

BAD = [
    "not a dict",
    {},
    {"axes": {}},
    {"axes": {"dp": 0}},
    {"axes": {"dp": True}},
    {"axes": {"dp": 2.0}},
    {"axes": {"": 2}},
    {"axes": {3: 2}},
    {"axes": {"dp": 2}, "shardings": {}},
    {"axes": {"dp": 2}, "inputs": {"X": "dp"}},
    {"axes": {"dp": 2}, "inputs": {"X": ["tp"]}},
    {"axes": {"dp": 2}, "outputs": {"Y": [None, ["dp", "sp"]]}},
    {"axes": {"dp": 2}, "inputs": {"X": [7]}},
]


@pytest.mark.parametrize("declaration", GOOD, ids=[f"good{i}" for i in range(len(GOOD))])
def test_mesh_spec_parse_matches_the_reference(declaration):
    ours = sharding.MeshSpec.parse(declaration)
    theirs = jax_sharding.MeshSpec.parse(declaration)
    assert ours.axes == theirs.axes
    assert ours.inputs == theirs.inputs and ours.outputs == theirs.outputs
    assert ours.device_count == theirs.device_count
    assert ours.axis_sizes == theirs.axis_sizes


@pytest.mark.parametrize("declaration", BAD, ids=[f"bad{i}" for i in range(len(BAD))])
def test_mesh_spec_refusals_match_the_reference(declaration):
    with pytest.raises(jax_sharding.MeshDeclarationError) as theirs:
        jax_sharding.MeshSpec.parse(declaration)
    with pytest.raises(sharding.MeshDeclarationError) as ours:
        sharding.MeshSpec.parse(declaration)
    assert str(ours.value) == str(theirs.value)


def test_resolve_too_few_gives_the_reference_reason():
    spec = {"axes": {"dp": 2, "tp": 2}, "inputs": {"X": ["dp", None]}}
    with pytest.raises(jax_sharding.MeshUnavailableError) as theirs:
        jax_sharding.resolve(jax_sharding.MeshSpec.parse(spec), jax.devices()[:1])
    with pytest.raises(sharding.MeshUnavailableError) as ours:
        sharding.resolve(sharding.MeshSpec.parse(spec), device="cpu")
    assert str(ours.value) == str(theirs.value) == "mesh requires 4 devices, host has 1"


def test_resolve_takes_a_repeated_device_list_and_describes_like_the_reference():
    declaration = {"axes": {"dp": 2, "tp": 2}, "inputs": {"X": ["dp", None]},
                   "outputs": {"Y": [["dp", "tp"]]}}
    plan = sharding.resolve(sharding.MeshSpec.parse(declaration), [CPU] * 5)
    theirs = jax_sharding.resolve(jax_sharding.MeshSpec.parse(declaration),
                                  jax.devices()[:1] * 4)
    ours_doc, theirs_doc = plan.describe(), theirs.describe()
    assert set(ours_doc) == set(theirs_doc)
    for key in ("axes", "device_count", "process_count", "local_device_count",
                "spans_processes", "inputs", "outputs"):
        assert ours_doc[key] == theirs_doc[key], key
    assert ours_doc["devices"] == ["cpu"] * 4
    assert plan.devices == (CPU,) * 4 and plan.device_labels == ("cpu",) * 4
    assert plan.batch_multiple("X") == theirs.batch_multiple("X") == 2
    assert plan.batch_multiple("unknown") == 1
    assert plan.groups("tp") == [[0, 1], [2, 3]] and plan.groups("dp") == [[0, 2], [1, 3]]
    assert plan.groups("sp") == [[0], [1], [2], [3]]


def test_shard_slices_and_shard_tree():
    plan = sharding.resolve(sharding.MeshSpec.parse({"axes": {"dp": 2, "tp": 2}}), [CPU] * 4)
    assert plan.shard_slices(("tp", None), [6, 3]) == [
        (slice(0, 3), slice(None)), (slice(3, 6), slice(None)),
        (slice(0, 3), slice(None)), (slice(3, 6), slice(None))]
    assert plan.shard_slices(((("dp", "tp")),), [8])[3] == (slice(6, 8),)
    assert plan.blocks_per_dim((None, ("dp", "tp")), 2) == [1, 4]
    with pytest.raises(ValueError, match="does not split"):
        plan.shard_slices(("tp",), [5])
    tree = {"w": torch.arange(12.0).reshape(4, 3), "b": [torch.ones(3)]}
    shards = sharding.shard_tree(tree, {"w": ("tp", None), "b": [()]}, plan)
    assert len(shards) == 4
    assert torch.equal(shards[1]["w"], tree["w"][2:]) and shards[1]["w"].is_contiguous()
    # the same block on the same device is one tensor; a replicated
    # tensor keeps its storage
    assert shards[0]["w"] is shards[2]["w"]
    assert shards[3]["b"][0].data_ptr() == tree["b"][0].data_ptr()


def test_plan_for_model_raises_load_failures():
    class Declares:
        device = "cpu"
        mesh = {"axes": {"sp": 2}}

    with pytest.raises(InferenceServerException, match="mesh requires 2 devices, host has 1"):
        plan_for_model(Declares())
    assert plan_for_model(Declares(), [CPU, CPU]).spec.axis_sizes == {"sp": 2}
    Declares.mesh = {"axes": {"sp": 0}}
    with pytest.raises(InferenceServerException, match="size must be a positive int"):
        plan_for_model(Declares(), [CPU] * 4)

    class Plain:
        pass

    assert plan_for_model(Plain()) is None


def test_create_mesh_puts_tp_innermost():
    devices = [torch.device("cpu", i) for i in range(8)]
    grid = create_mesh(dp=2, tp=2, sp=2, devices=devices)
    assert grid.shape == (2, 2, 2)
    assert [d.index for d in grid[1, 0, :]] == [4, 5]
    with pytest.raises(ValueError, match="does not match device count 8"):
        create_mesh(dp=3, devices=devices)


def test_collectives():
    devices = [CPU] * 3
    parts = [torch.tensor([value], dtype=torch.bfloat16) for value in (1.0, 2.0 ** -8, 2.0 ** -8)]
    (total, *_) = collectives.all_reduce(parts, devices)
    # summed in fp32 and cast once: 1 + 2^-7 is a bf16 value; a bf16
    # running sum rounds each 1 + 2^-8 back to 1
    assert total.dtype == torch.bfloat16 and total.item() == 1.0 + 2.0 ** -7
    assert (parts[0] + parts[1] + parts[2]).item() == 1.0
    reduced = collectives.all_reduce(parts, devices)
    assert reduced[0] is reduced[1] is reduced[2]  # one tensor on a repeated device
    single = torch.ones(2)
    assert collectives.all_reduce([single], [CPU])[0] is single
    gathered = collectives.all_gather([torch.zeros(2, 1), torch.ones(2, 2)], [CPU, CPU], dim=-1)
    assert gathered[0].tolist() == [[0.0, 1.0, 1.0]] * 2
    blocks = [torch.tensor([float(i)]) for i in range(4)]
    assert [b.item() for b in collectives.ppermute(blocks, [CPU] * 4, 1)] == [3.0, 0.0, 1.0, 2.0]
    table = [torch.arange(6.0).reshape(3, 2), torch.arange(6.0, 12.0).reshape(3, 2)]
    rows = collectives.vocab_parallel_embedding(table, torch.tensor([[4, 0, 2]]))
    assert rows[0].tolist() == [[[8.0, 9.0], [0.0, 1.0], [4.0, 5.0]]]


class _FakeClock:
    def __init__(self):
        self.now = 0

    def __call__(self):
        self.now += 1000
        return self.now


def test_executor_pads_places_and_trims_on_a_fake_clock():
    declaration = {"axes": {"dp": 2, "tp": 2}, "inputs": {"X": ["dp", None]},
                   "outputs": {"Y": ["dp", None], "Z": [None, "tp"]}}
    plan = sharding.resolve(sharding.MeshSpec.parse(declaration), [CPU] * 4)
    seen = {}

    def fn(arrays):
        seen.update(arrays)
        x = arrays["X"]
        return {
            "Y": [block * 2 for block in x],
            "Z": [torch.full((1, 2), float(plan.coords(i)["tp"])) for i in range(4)],
            "S": arrays["S"][0] + 1,
        }

    clock = _FakeClock()
    executor = ShardedExecutor(plan, fn, clock_ns=clock)
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    out = executor({"X": x, "S": np.int32(4)}, rows=5)
    # 5 rows pad to 6: each dp block has 3 rows, shared by its tp pair
    assert [tuple(b.shape) for b in seen["X"]] == [(3, 3)] * 4
    assert seen["X"][0] is seen["X"][1] and seen["X"][2] is not seen["X"][0]
    assert seen["X"][2][2].tolist() == [0.0, 0.0, 0.0]  # the padding row
    assert seen["S"][0].shape == () and int(seen["S"][0]) == 4
    assert np.array_equal(out["Y"], 2 * x)  # gathered over dp, trimmed to 5
    assert out["Z"].tolist() == [[0.0, 0.0, 1.0, 1.0]]  # gathered over tp
    assert int(out["S"]) == 5
    snapshot = executor.snapshot()
    assert snapshot == {"executions": 1, "device_put_ns": 1000, "compute_ns": 1000,
                        "gather_ns": 1000}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_the_reference(sp, causal):
    rng = np.random.default_rng(sp + 10 * causal)
    q, k, v = (rng.normal(size=[2, 3, 16, 8]).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_reference_attention(q, k, v, causal=causal))
    plan = sharding.resolve(sharding.MeshSpec.parse({"axes": {"sp": sp}}), [CPU] * sp)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ring_attention(tq, tk, tv, plan, causal=causal)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert np.abs(reference_attention(tq, tk, tv, causal=causal).numpy() - want).max() <= 1e-5
    blocks = ring_attention(list(tq.chunk(sp, dim=2)), list(tk.chunk(sp, dim=2)),
                            list(tv.chunk(sp, dim=2)), plan, causal=causal)
    assert len(blocks) == sp
    assert torch.equal(torch.cat(blocks, dim=2), got)


def test_forward_with_sp_matches_jax_forward():
    jax_config = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    config = llama.LlamaConfig.tiny(dtype=torch.float32)
    jax_params = jax_llama.init_params(jax.random.PRNGKey(3), jax_config)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    tokens = np.random.default_rng(3).integers(0, config.vocab_size, [2, 24]).astype(np.int32)
    want = np.asarray(jax_llama.forward(jax_params, tokens, jax_config, mesh=None))
    dense = llama.forward(params, torch.from_numpy(tokens), config)
    plan = sharding.resolve(sharding.MeshSpec.parse({"axes": {"dp": 1, "tp": 1, "sp": 2}}),
                            [CPU, CPU])
    ring = llama.forward(params, torch.from_numpy(tokens), config, mesh=plan)
    assert ring.shape == dense.shape == want.shape == (2, 24, config.vocab_size)
    assert np.abs(dense.numpy() - want).max() <= 1e-4
    assert np.abs(ring.numpy() - want).max() <= 1e-4
    blocks = llama.forward(params, list(torch.from_numpy(tokens).chunk(2, dim=1)), config,
                           mesh=plan)
    assert torch.equal(torch.cat(blocks, dim=1), ring)
    # a tp plan: heads, the MLP hidden and the vocabulary over two shards
    tp_plan = sharding.resolve(sharding.MeshSpec.parse({"axes": {"tp": 2}}), [CPU, CPU])
    sharded = llama.forward(params, torch.from_numpy(tokens), config, mesh=tp_plan)
    assert sharded.shape == want.shape
    assert np.abs(sharded.numpy() - want).max() <= 1e-4

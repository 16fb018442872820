"""The kernels' split-KV algorithm, in plain PyTorch, against the JAX package.

``paged_attention_split`` and ``paged_attention_split_mq`` cut each
context into partitions of P slots, give each a partial (running max,
denominator, unnormalised output) and merge the partials, as K1 and K2 do
on the card. They are held within 1e-5 (fp32) of the JAX stand-ins and of
the Pallas kernels under the interpreter, on the same numpy inputs, with
P in {bs, 2 bs, 4 bs}, bs in {8, 16} and g in {1, 2, 4}, on the layouts
that straddle partitions: contexts of P - 1, P, P + 1 and 2P + 1 slots, a
1-slot context, a padding lane, and verify rows whose earliest rows see
nothing of the last partition. The kernels are held to these versions on
the card in ``test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from client_tpu.models import paged_attention as jax_pa
from client_tpu_torch.models import paged_attention as pa

torch.set_num_threads(1)

TOL = 1e-5

_jax_standin = jax.jit(jax_pa.paged_attention_standin)
_jax_standin_mq = jax.jit(jax_pa.paged_attention_standin_mq)


def edge_contexts(partition):
    """Context lengths that straddle partition edges, a 1-slot context
    and (0) a padding lane."""
    return [partition - 1, partition, partition + 1, 2 * partition + 1, 1, 0]


def _layout(rng, contexts, bs, t):
    """Pages, tables and verify positions for ``contexts``: lane i's T rows
    are the last T slots of its context (padding rows repeat the last one
    when the context is shorter than T); a context of 0 is a padding lane
    (all-zero table, positions 0). Tables are one block wider than the
    longest context needs."""
    nb = max(-(-c // bs) for c in contexts) + 1
    num_blocks = 1 + sum(-(-c // bs) for c in contexts)
    tables = np.zeros((len(contexts), nb), dtype=np.int32)
    positions = np.zeros((len(contexts), t), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for i, n_ctx in enumerate(contexts):
        for j in range(-(-n_ctx // bs)):
            tables[i, j] = free.pop()
        if n_ctx:
            positions[i] = max(n_ctx - t, 0) + np.minimum(np.arange(t), n_ctx - 1)
    return num_blocks, tables, positions


def _case(seed, contexts, bs, g, t=None, kv=2, d=16):
    """Random fp32 q and pages over :func:`_layout`; ``t`` None gives the
    single-query shapes (q [B, H, D], positions [B])."""
    rng = np.random.default_rng(seed)
    num_blocks, tables, positions = _layout(rng, contexts, bs, t or 1)
    k_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    if t is None:
        q = rng.normal(size=(len(contexts), kv * g, d)).astype(np.float32)
        return q, k_pages, v_pages, tables, positions[:, 0].copy()
    q = rng.normal(size=(len(contexts), t, kv * g, d)).astype(np.float32)
    return q, k_pages, v_pages, tables, positions


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("per", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16])
def test_split_matches_jax_standin_at_partition_edges(bs, g, per):
    partition = per * bs
    case = _case(bs * 100 + g * 10 + per, edge_contexts(partition), bs, g)
    ref = np.asarray(_jax_standin(*case))
    out = pa.paged_attention_split(*_torch(case), partition).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("per", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16])
def test_split_mq_matches_jax_standin_at_partition_edges(bs, g, per):
    """T = 4 verify rows per lane, plus a lane whose rows sit at P - 2 ..
    P + 1, so its rows 0 and 1 see nothing of the partition the later
    rows reach into."""
    partition = per * bs
    contexts = edge_contexts(partition) + [partition + 2]
    case = _case(bs * 100 + g * 10 + per + 1, contexts, bs, g, t=4)
    positions = case[4]
    assert (positions[-1] == [partition - 2, partition - 1, partition, partition + 1]).all()
    ref = np.asarray(_jax_standin_mq(*case))
    out = pa.paged_attention_split_mq(*_torch(case), partition).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= TOL


# the interpreter is slow: one layout each for the single- and multi-query
# kernels, both block sizes between them
@pytest.mark.parametrize("bs,g,per", [(8, 2, 1), (16, 1, 2)])
def test_split_matches_jax_pallas_interpret(bs, g, per):
    partition = per * bs
    case = _case(bs + g + per, edge_contexts(partition), bs, g)
    ref = np.asarray(jax_pa.paged_attention_pallas_interpret(*case))
    out = pa.paged_attention_split(*_torch(case), partition).numpy()
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("bs,g,per", [(16, 2, 1), (8, 4, 2)])
def test_split_mq_matches_jax_pallas_interpret(bs, g, per):
    partition = per * bs
    case = _case(bs + g + per + 7, edge_contexts(partition) + [partition + 2], bs, g, t=4)
    ref = np.asarray(jax_pa.paged_attention_pallas_interpret_mq(*case))
    out = pa.paged_attention_split_mq(*_torch(case), partition).numpy()
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("partition", [1, 3, 8, 1000])
def test_every_partition_size_gives_the_unsplit_result(partition):
    """P that cuts pages (1, 3), one page (8) or spans the whole table
    (1000, a single partition): the same output as the fused version."""
    case = _torch(_case(partition, [5, 17, 24, 1, 0], 8, 2, t=3))
    out = pa.paged_attention_split_mq(*case, partition)
    assert torch.isfinite(out).all()
    assert (out - pa.paged_attention_fused_mq(*case)).abs().max() <= TOL


def test_a_row_that_sees_nothing_gives_zeros_not_nan():
    """A position below 0 (which the engine never sends) leaves a row with
    no visible slot: zeros, as the kernels write, not NaN."""
    q, k, v, tables, positions = _torch(_case(3, [9, 4], 8, 1, t=2))
    positions[1] = -1
    out = pa.paged_attention_split_mq(q, k, v, tables, positions, 8)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isfinite(out).all()


def test_split_args_size_the_scratch_from_the_table_alone():
    """The wrapper's split-KV arguments: none for a table within one
    partition; else a workspace of units x parts x rows x (D + 2) floats
    and zeroed counters, grown once and reused; too many parts raise."""
    q, k, v, tables, _ = _torch(_case(5, [40, 7, 0], 8, 2, t=3))  # KV 2, g 2, D 16
    try:
        assert pa._split_args(q, k, tables, 3, 1000)[1:] == (0, 0, 0, 0)
        partition, ws_ptr, ws_floats, cnt_ptr, cnt_n = pa._split_args(q, k, tables, 3, 8)
        parts = -(-tables.shape[1] * 8 // 8)
        units = 3 * 2 * 1  # B x KV x one slice of 6 packed rows
        assert partition == 8 and ws_floats == units * parts * 6 * (16 + 2)
        workspace, counters = pa._scratch[q.device]
        assert workspace.data_ptr() == ws_ptr and counters.data_ptr() == cnt_ptr
        assert cnt_n >= units and not counters.any()
        again = pa._split_args(q, k, tables, 3, 16)
        assert again[1] == ws_ptr and again[3] == cnt_ptr  # reused, not reallocated
        with pytest.raises(ValueError, match="parts"):
            pa._split_args(q, k, tables, 3, 0)
        wide = torch.zeros((3, 8 * pa.MAX_PARTS + 8), dtype=torch.int32)
        with pytest.raises(ValueError, match="parts"):
            pa._split_args(q, k, wide, 3, 1)
    finally:
        pa._scratch.pop(q.device, None)


@pytest.mark.parametrize("span,expected", [(16, 256), (256, 256), (257, 160), (384, 192),
                                           (512, 256), (4096, 256), (4100, 256),
                                           (256 * 300, 320)])
def test_partition_slots_evens_out_the_partitions(span, expected):
    """The default partition: the fewest parts of at most 256 slots (256
    parts at most), evened out to 32-slot tiles."""
    partition = pa.partition_slots(span)
    assert partition == expected
    assert partition % 32 == 0 and -(-span // partition) <= pa.MAX_PARTS

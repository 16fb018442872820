"""The port's ragged paged-attention decode against the JAX package.

The port's plain versions (``paged_attention_standin``,
``paged_attention_fused``) and the kernel wrapper ``paged_attention_cuda``
— which on CPU tensors takes its plain version — are held within 1e-5 of
the JAX stand-in and of the Pallas kernel run under the Pallas
interpreter (as the JAX package's own tests run it), on the same numpy
inputs: random ragged layouts, block sizes 8 and 16, GQA groups 1, 2 and
4, and an all-zero padding lane. The kernel itself is compared with its
plain version on the card in ``test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from client_tpu.models import paged_attention as jax_pa
from client_tpu_torch.models import paged_attention as pa

torch.set_num_threads(1)

TOL = 1e-5

# one compile per shape instead of one per op and shape
_jax_standin = jax.jit(jax_pa.paged_attention_standin)


def _ragged_case(seed, b, nb, bs, g, kv=2, d=16, padding_lane=True):
    """Random pages and a ragged layout; with ``padding_lane`` the last
    lane (when b > 1) is an engine padding lane: all-zero table,
    position 0."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + b * nb
    k_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    tables = np.zeros((b, nb), dtype=np.int32)
    positions = np.zeros((b,), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    live = b - 1 if (padding_lane and b > 1) else b
    for i in range(live):
        n_ctx = int(rng.integers(1, nb * bs + 1))
        positions[i] = n_ctx - 1
        for j in range((n_ctx + bs - 1) // bs):
            tables[i, j] = free.pop()
    q = rng.normal(size=(b, kv * g, d)).astype(np.float32)
    return q, k_pages, v_pages, tables, positions


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


PORT_IMPLS = ("standin", "fused", "cuda")


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("b,nb", [(1, 2), (3, 4), (8, 4)])
def test_port_attention_matches_jax_standin(b, nb, bs, g):
    case = _ragged_case(b * 1000 + nb * 100 + bs * 10 + g, b, nb, bs, g)
    ref = np.asarray(_jax_standin(*case))
    for name in PORT_IMPLS:
        out = pa.get_attention_impl(name)(*_torch(case)).numpy()
        assert np.isfinite(out).all(), name
        assert np.abs(out - ref).max() <= TOL, name


# the interpreter is slow, so one case per layout, covering both block
# sizes and every group size between them
@pytest.mark.parametrize(
    "b,nb,bs,g", [(1, 2, 8, 1), (3, 4, 16, 2), (8, 4, 8, 4), (8, 4, 16, 1)]
)
def test_port_attention_matches_jax_pallas_interpret(b, nb, bs, g):
    case = _ragged_case(b * 1000 + nb * 100 + bs * 10 + g, b, nb, bs, g)
    ref = np.asarray(jax_pa.paged_attention_pallas_interpret(*case))
    for name in PORT_IMPLS:
        out = pa.get_attention_impl(name)(*_torch(case)).numpy()
        assert np.abs(out - ref).max() <= TOL, name


def test_padding_lane_reads_only_slot_zero_of_the_trash_block():
    """A padding lane (all-zero table, position 0) attends to exactly one
    slot: slot 0 of block 0, so its output is that slot's V row."""
    q, k_pages, v_pages, tables, positions = _ragged_case(7, 3, 4, 8, 2)
    out = pa.paged_attention_fused(*_torch((q, k_pages, v_pages, tables, positions)))
    expected = np.repeat(v_pages[0, 0], 2, axis=0)  # KV head k feeds heads 2k, 2k+1
    assert np.abs(out[-1].numpy() - expected).max() <= TOL


def test_table_width_beyond_the_context_changes_nothing():
    """The engine slices the table to a bucket of the longest context;
    extra (zero) columns past a sequence's position add exactly zero."""
    q, k_pages, v_pages, tables, positions = _ragged_case(11, 3, 4, 8, 1)
    wide = np.concatenate([tables, np.zeros((3, 4), dtype=np.int32)], axis=1)
    narrow_out = pa.paged_attention_fused(*_torch((q, k_pages, v_pages, tables, positions)))
    wide_out = pa.paged_attention_fused(*_torch((q, k_pages, v_pages, wide, positions)))
    assert torch.equal(narrow_out, wide_out)


def test_bf16_plain_versions_round_once_from_fp32():
    """With bf16 inputs the plain versions score and accumulate in fp32
    and round once: equal to the fp32 computation on the same (bf16)
    values, cast to bf16."""
    case = _torch(_ragged_case(3, 4, 4, 16, 2))
    q, k, v = (t.to(torch.bfloat16) for t in case[:3])
    fp32 = pa.paged_attention_standin(q.float(), k.float(), v.float(), *case[3:])
    for impl in (pa.paged_attention_standin, pa.paged_attention_fused):
        out = impl(q, k, v, *case[3:])
        assert out.dtype == torch.bfloat16
        assert (out.float() - fp32.to(torch.bfloat16).float()).abs().max() <= 2 ** -7


def test_resolve_and_lookup():
    assert pa.resolve_decode_attention(torch.device("cuda"))[0] == "cuda"
    assert pa.resolve_decode_attention(torch.device("cpu")) == (
        "fused", pa.paged_attention_fused
    )
    assert pa.get_attention_impl("cuda") is pa.paged_attention_cuda
    with pytest.raises(ValueError, match="unknown paged-attention kernel"):
        pa.get_attention_impl("pallas")


def test_wrapper_on_cpu_tensors_takes_the_plain_version_without_counting():
    case = _torch(_ragged_case(5, 3, 2, 8, 2))
    before = pa.paged_attention_cuda.launches
    out = pa.paged_attention_cuda(*case)
    assert torch.equal(out, pa.paged_attention_fused(*case))
    assert pa.paged_attention_cuda.launches == before


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    q, k, v, tables, positions = (t.to("meta") for t in _torch(_ragged_case(5, 1, 2, 8, 1)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_attention_cuda(q, k, v, tables, positions)


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda a: {**a, "q": a["q"].half(), "k": a["k"].half(), "v": a["v"].half()}, TypeError),
        (lambda a: {**a, "tables": a["tables"].long()}, TypeError),
        (lambda a: {**a, "q": a["q"][:, :3]}, ValueError),  # heads not a multiple of KV
        (lambda a: {**a, "q": a["q"][..., :8], "k": a["k"][..., :8].contiguous(),
                    "v": a["v"][..., :8].contiguous()}, ValueError),  # D=8 not compiled
        (lambda a: {**a, "k": a["k"].transpose(1, 2)}, ValueError),  # shape mismatch
        (lambda a: {**a, "positions": a["positions"][:1]}, ValueError),
        (lambda a: {**a, "q": a["q"].transpose(0, 1).contiguous().transpose(0, 1)}, ValueError),
    ],
    ids=["fp16", "int64-tables", "bad-group", "head-dim-8", "pages-shape", "positions-shape",
         "non-contiguous"],
)
def test_kernel_argument_checks(mutate, error):
    """What the kernel does not take raises before any launch."""
    q, k, v, tables, positions = _torch(_ragged_case(9, 2, 2, 8, 2))
    args = mutate({"q": q, "k": k, "v": v, "tables": tables, "positions": positions})
    with pytest.raises(error):
        pa._check_cuda_args(args["q"], args["k"], args["v"], args["tables"], args["positions"])

"""The port's kernels on the card, against their plain PyTorch versions:
K1 (decode) and K2 (the speculative verify) on random ragged layouts and
on layouts that straddle their split-KV partitions (held to the plain
split-and-merge version), and the tiny engine through both against the
dense oracle. K3, the BERT encoder's fused attention, against its plain
version over trailing, inner and all-pad key masks. Then the KServe v2
path's models on the card: the tiny fp32 text encoder against its CPU
run, BERT-large widths batched against unbatched in bf16 (and K3's
launches a forward), and ``run_bucketed``'s host arrays; the image
classifier (fp32 against its CPU run, bf16 against the card's fp32) and
the TPU shared-memory staging of CUDA tensors (one device-to-host read).

Every test here carries the ``cuda`` marker and skips without a card: a
CUDA kernel has no CPU or interpret mode. The file imports nothing of JAX,
so it runs on the machine with the card, where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest pins JAX to the CPU.)
"""

import asyncio

import numpy as np
import pytest
import torch

from client_tpu_torch.llm.engine import EngineConfig
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama
from client_tpu_torch.models import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU or interpret mode")
    # full-precision fp32 matmuls and convolutions in the plain versions the
    # kernel (and the fp32 models) are held to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ragged_case(seed, b, nb, bs, g, kv, d, device):
    """Random pages, a ragged layout and an all-zero padding lane last."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + b * nb
    k_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    tables = np.zeros((b, nb), dtype=np.int32)
    positions = np.zeros((b,), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for i in range(b - 1):
        n_ctx = int(rng.integers(1, nb * bs + 1))
        positions[i] = n_ctx - 1
        for j in range((n_ctx + bs - 1) // bs):
            tables[i, j] = free.pop()
    q = rng.normal(size=(b, kv * g, d)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, k_pages, v_pages, tables, positions)]


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16])
def test_kernel_matches_plain_version_fp32(cuda, bs, g, d):
    q, k, v, tables, positions = _ragged_case(bs * 100 + g * 10 + d, 8, 4, bs, g, 2, d, cuda)
    before = pa.paged_attention_cuda.launches
    out = pa.paged_attention_cuda(q, k, v, tables, positions)
    ref = pa.paged_attention_standin(q, k, v, tables, positions)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    assert (out - ref).abs().max().item() <= TOL


def test_kernel_matches_plain_version_bf16(cuda):
    case = _ragged_case(1, 8, 16, 16, 1, 32, 128, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in case[:3])
    out = pa.paged_attention_cuda(q, k, v, *case[3:])
    ref = pa.paged_attention_standin(q, k, v, *case[3:])
    torch.cuda.synchronize()
    # both round an fp32 result once to bf16: at most one bf16 ulp apart
    tol = 2.0 ** -7 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v, tables, positions = _ragged_case(2, 2, 2, 8, 1, 2, 128, cuda)
    with pytest.raises(TypeError):
        pa.paged_attention_cuda(q.half(), k.half(), v.half(), tables, positions)
    with pytest.raises(ValueError, match="one CUDA device"):
        pa.paged_attention_cuda(q, k.cpu(), v, tables, positions)


def test_engine_on_the_card_equals_the_dense_oracle(cuda):
    """The tiny fp32 Llama through the engine (prefill, shared-prefix
    suffix prefill, K1 decode at head_dim 16) gives the dense oracle's
    greedy streams token for token, and K1 launches once per layer and
    decode step."""
    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    params = llama.init_params(torch.Generator(device=cuda).manual_seed(0), config, cuda)
    model = LlmEngineModel(
        config=config, params=params, device=cuda,
        engine_config=EngineConfig(block_size=8, num_blocks=65, max_seq_len=64),
    )
    model.warmup()
    assert model.decode_kernel == "cuda"
    prefix = [9, 3, 7, 1, 5, 2, 8, 4, 6, 1, 2, 3, 4, 5, 6, 7]
    prompts = [prefix + [10 + i, 20 + i] for i in range(3)] + [[5, 9, 17]]

    async def generate(prompt):
        out = []
        async for item in model.execute_decoupled(
            {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, {"max_tokens": 12}
        ):
            out.append(int(item["OUTPUT_IDS"][0]))
        return out

    async def run_all():
        return await asyncio.gather(*(generate(p) for p in prompts))

    launches, steps = pa.paged_attention_cuda.launches, model.engine.steps
    streams = asyncio.run(run_all())
    assert pa.paged_attention_cuda.launches - launches == (
        config.n_layers * (model.engine.steps - steps)
    )
    assert model.engine.allocator.prefix_hits >= 2
    model.shutdown()
    for prompt, stream in zip(prompts, streams):
        dense = llama.generate(params, torch.tensor([prompt], device=cuda), config, 12)
        assert stream == dense[0].tolist()


def _ragged_mq_case(seed, b, nb, bs, g, t, kv, d, device):
    """Random pages, a ragged verify layout (each lane a random context
    and a random number of real rows, its padding rows clamped to the
    last real one) and an all-zero padding lane last."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + b * nb
    k_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    tables = np.zeros((b, nb), dtype=np.int32)
    positions = np.zeros((b, t), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for i in range(b - 1):
        n_ctx = int(rng.integers(0, nb * bs - t + 1))
        length = int(rng.integers(1, t + 1))
        positions[i] = n_ctx + np.minimum(np.arange(t), length - 1)
        for j in range((n_ctx + length + bs - 1) // bs):
            tables[i, j] = free.pop()
    q = rng.normal(size=(b, t, kv * g, d)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, k_pages, v_pages, tables, positions)]


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("t", [1, 2, 3, 5])
def test_verify_kernel_matches_plain_version_fp32(cuda, t, g, d):
    """K2 within 1e-5 of the multi-query stand-in, including row counts
    T*g past one block's rows (split over the grid's third axis)."""
    q, k, v, tables, positions = _ragged_mq_case(t * 100 + g * 10 + d, 6, 4, 8, g, t, 2, d, cuda)
    before = pa.paged_attention_cuda_mq.launches
    out = pa.paged_attention_cuda_mq(q, k, v, tables, positions)
    ref = pa.paged_attention_standin_mq(q, k, v, tables, positions)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda_mq.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL


def test_engine_with_speculation_on_the_card_equals_the_dense_oracle(cuda):
    """The tiny fp32 Llama with self-draft speculation: verify steps go
    through K2 (once per layer and verify step), and the greedy streams
    equal the dense oracle's token for token."""
    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    params = llama.init_params(torch.Generator(device=cuda).manual_seed(0), config, cuda)
    model = LlmEngineModel(
        config=config, params=params, device=cuda,
        speculation={"mode": "draft", "draft": "self", "k": 3},
        engine_config=EngineConfig(block_size=8, num_blocks=65, max_seq_len=64),
    )
    model.warmup()
    prompts = [[9, 3, 7, 1, 5, 2, 8, 4, 6, 1, 2, 3, 10], [5, 9, 17, 3, 8], [7]]

    async def generate(prompt):
        out = []
        async for item in model.execute_decoupled(
            {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, {"max_tokens": 12}
        ):
            out.append(int(item["OUTPUT_IDS"][0]))
        return out

    async def run_all():
        return await asyncio.gather(*(generate(p) for p in prompts))

    launches, spec_steps = pa.paged_attention_cuda_mq.launches, model.engine.spec_steps
    streams = asyncio.run(run_all())
    verify_steps = model.engine.spec_steps - spec_steps
    assert verify_steps > 0
    assert pa.paged_attention_cuda_mq.launches - launches == config.n_layers * verify_steps
    assert model.engine.allocator.blocks_in_use == 0
    model.shutdown()
    for prompt, stream in zip(prompts, streams):
        dense = llama.generate(params, torch.tensor([prompt], device=cuda), config, 12)
        assert stream == dense[0].tolist()


def _edge_case(seed, partition, bs, g, t, kv, d, device):
    """Contexts of P - 1, P, P + 1 and 2P + 1 slots, a 1-slot context, a
    lane whose T verify rows sit at P - 2 .. (rows 0 and 1 see nothing of
    the second partition) and a padding lane; each lane's rows are the
    last T slots of its context. ``t`` None gives K1's shapes."""
    rows = t or 1
    contexts = [partition - 1, partition, partition + 1, 2 * partition + 1, 1,
                partition - 2 + rows, 0]
    rng = np.random.default_rng(seed)
    nb = max(-(-c // bs) for c in contexts) + 1
    num_blocks = 1 + sum(-(-c // bs) for c in contexts)
    tables = np.zeros((len(contexts), nb), dtype=np.int32)
    positions = np.zeros((len(contexts), rows), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for i, n_ctx in enumerate(contexts):
        for j in range(-(-n_ctx // bs)):
            tables[i, j] = free.pop()
        if n_ctx:
            positions[i] = max(n_ctx - rows, 0) + np.minimum(np.arange(rows), n_ctx - 1)
    k_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_blocks, bs, kv, d)).astype(np.float32)
    q = rng.normal(size=(len(contexts), rows, kv * g, d)).astype(np.float32)
    if t is None:
        q, positions = q[:, 0], positions[:, 0]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (q, k_pages, v_pages, tables, positions)]


def _split_reference(kernel, case, partition):
    """The kernel's output and the plain split version's at the same
    partition, after a sync."""
    span = case[3].shape[1] * case[1].shape[1]
    p = pa.partition_slots(span) if partition is None else partition
    if kernel is pa.paged_attention_cuda:
        ref = pa.paged_attention_split(*case, p)
    else:
        ref = pa.paged_attention_split_mq(*case, p)
    out = kernel(*case, partition=partition)
    torch.cuda.synchronize()
    return out, ref


@pytest.mark.parametrize("partition", [None, 32, 16])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("t", [None, 5])
def test_kernels_match_the_split_version_at_partition_edges_fp32(cuda, t, g, d, partition):
    """K1 (t None) and K2 (T = 5) within 1e-5 of the plain split version
    at the default partition and at small ones (many partials to merge);
    every merge leaves its counter at zero for the next launch."""
    kernel = pa.paged_attention_cuda if t is None else pa.paged_attention_cuda_mq
    case = _edge_case(d + g + (t or 0), partition or pa.PARTITION_SLOTS, 8, g, t, 2, d, cuda)
    out, ref = _split_reference(kernel, case, partition)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL
    assert (out - pa.paged_attention_standin(*case) if t is None else
            out - pa.paged_attention_standin_mq(*case)).abs().max().item() <= TOL
    assert not pa._scratch[case[0].device][1].any()


@pytest.mark.parametrize("partition", [None, 32])
@pytest.mark.parametrize("t", [None, 5])
def test_kernels_match_the_split_version_at_partition_edges_bf16(cuda, t, partition):
    """bf16 at D = 128 (the tensor-core scores) within one bf16 ulp of the
    largest output."""
    kernel = pa.paged_attention_cuda if t is None else pa.paged_attention_cuda_mq
    case = _edge_case(7, partition or pa.PARTITION_SLOTS, 16, 1, t, 4, 128, cuda)
    case[:3] = [x.to(torch.bfloat16) for x in case[:3]]
    out, ref = _split_reference(kernel, case, partition)
    tol = 2.0 ** -7 * ref.float().abs().max().item()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# K3: the BERT encoder's fused attention
# ---------------------------------------------------------------------------


def _encoder_mask(kind, b, length, rng):
    """A [b, length] key mask (True: a real key) of one kind: ``none``
    (no pad), ``trailing`` (each row a random length, the last row all
    pad), ``inner`` (a random run of pads inside each row) or ``mixed``
    (the rows cycle through those, one row all pad)."""
    mask = np.ones((b, length), dtype=bool)
    for row in range(b):
        pick = kind if kind != "mixed" else ("none", "trailing", "inner", "all")[row % 4]
        if pick == "trailing":
            mask[row, int(rng.integers(1, length + 1)):] = False
        elif pick == "inner":
            start = int(rng.integers(0, length))
            mask[row, start:int(rng.integers(start, length + 1))] = False
        elif pick == "all":
            mask[row] = False
    if kind == "trailing":
        mask[-1] = False
    return mask


def _encoder_case(seed, b, length, heads, hd, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, length, heads, hd)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    return q, k, v, rng


def _bf16_attention_errors(q, k, v, key_mask, out):
    """Largest distance of the kernel's and of the plain version's bf16
    result from the fp32 attention of the same bf16 inputs, and the
    largest |value| of that attention."""
    from client_tpu_torch.models import bert

    config = bert.BertConfig.tiny(dtype=torch.bfloat16)
    exact = bert.encoder_attention_plain(q.float(), k.float(), v.float(), key_mask,
                                         bert.BertConfig.tiny(dtype=torch.float32))
    plain = bert.encoder_attention_plain(q, k, v, key_mask, config)
    return ((out.float() - exact).abs().max().item(),
            (plain.float() - exact).abs().max().item(), exact.abs().max().item())


@pytest.mark.parametrize("b,heads", [(1, 4), (2, 8), (16, 16)])
@pytest.mark.parametrize("length", [8, 64, 200, 256, 512])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_kernel_matches_plain_version(cuda, dtype, hd, length, b, heads):
    """Every mask kind: fp32 within 1e-5 of the plain version. bf16: the
    plain version rounds the scores to bf16 (its first product's dtype)
    before its fp32 softmax, the kernel keeps them in fp32, so each is
    held to the fp32 attention of the same bf16 inputs and the kernel may
    be no further from it than the plain version, plus 2^-8 of its
    largest value (the two round the probabilities at other scales)."""
    from client_tpu_torch.models import bert

    q, k, v, rng = _encoder_case(hd * 1000 + length * 10 + b, b, length, heads, hd, dtype, cuda)
    config = bert.BertConfig.tiny(dtype=dtype)
    for kind in ("none", "trailing", "inner", "mixed"):
        key_mask = torch.from_numpy(_encoder_mask(kind, b, length, rng)).to(cuda)
        before = bert.encoder_attention_cuda.launches
        out = bert.encoder_attention_cuda(q, k, v, key_mask)
        torch.cuda.synchronize()
        assert bert.encoder_attention_cuda.launches == before + 1
        assert out.dtype == dtype and tuple(out.shape) == (b, length, heads * hd)
        assert torch.isfinite(out).all(), kind
        if dtype == torch.float32:
            ref = bert.encoder_attention_plain(q, k, v, key_mask, config)
            assert (out - ref).abs().max().item() <= TOL, kind
        else:
            kernel_err, plain_err, scale = _bf16_attention_errors(q, k, v, key_mask, out)
            assert kernel_err <= plain_err + 2.0 ** -8 * scale, (kind, kernel_err, plain_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_kernel_skips_an_all_pad_tile_between_valid_ones(cuda, dtype):
    """Keys [0, 64) and [128, 200) real in row 0, with the 64-key tile
    between them all pad; row 1 real only in its last, partial tile; row
    2 all pad, whose result is the mean of V over all its keys."""
    from client_tpu_torch.models import bert

    q, k, v, _ = _encoder_case(7, 3, 320, 4, 64, dtype, cuda)
    key_mask = torch.zeros(3, 320, dtype=torch.bool, device=cuda)
    key_mask[0, :64] = True
    key_mask[0, 128:200] = True
    key_mask[1, 300:] = True
    out = bert.encoder_attention_cuda(q, k, v, key_mask)
    mean_v = v[2].float().mean(0).reshape(-1)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        ref = bert.encoder_attention_plain(q, k, v, key_mask, bert.BertConfig.tiny(dtype=dtype))
        assert (out - ref).abs().max().item() <= TOL
        assert (out[2] - mean_v).abs().max().item() <= TOL
    else:
        kernel_err, plain_err, scale = _bf16_attention_errors(q, k, v, key_mask, out)
        assert kernel_err <= plain_err + 2.0 ** -8 * scale
        # the mean in fp32 (summed in another order), rounded once to bf16
        err = (out[2].float() - mean_v).abs()
        assert (err <= 2.0 ** -8 * mean_v.abs() + 1e-5).all()


def test_encoder_attention_kernel_raises_on_what_it_does_not_take(cuda):
    from client_tpu_torch.models import bert

    q, k, v, _ = _encoder_case(3, 2, 64, 4, 64, torch.float32, cuda)
    key_mask = torch.ones(2, 64, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        bert.encoder_attention_cuda(q.half(), k.half(), v.half(), key_mask)
    with pytest.raises(TypeError):
        bert.encoder_attention_cuda(q, k.to(torch.bfloat16), v, key_mask)
    with pytest.raises(ValueError, match="one CUDA device"):
        bert.encoder_attention_cuda(q, k.cpu(), v, key_mask)
    with pytest.raises(ValueError, match="one CUDA device"):
        bert.encoder_attention_cuda(q, k, v, key_mask.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        bert.encoder_attention_cuda(*(t.reshape(2, 64, 8, 32) for t in (q, k, v)), key_mask)
    with pytest.raises(ValueError, match="contiguous"):
        bert.encoder_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                                    key_mask)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        bert.encoder_attention_cuda(shifted, k, v, key_mask)
    with pytest.raises(ValueError, match="key_mask"):
        bert.encoder_attention_cuda(q, k, v, key_mask.int())
    with pytest.raises(ValueError, match="key_mask"):
        bert.encoder_attention_cuda(q, k, v, key_mask[:, :32])
    with pytest.raises(ValueError, match="alike"):
        bert.encoder_attention_cuda(q, k[:, :32], v, key_mask)


def test_bert_large_forward_launches_the_kernel_once_a_layer(cuda):
    from client_tpu_torch.models import bert

    config = bert.BertConfig()
    params = bert.init_params(torch.Generator(device=cuda).manual_seed(0), config, cuda)
    ids = _random_ids(4, [64, 17], config.vocab_size)
    before = bert.encoder_attention_cuda.launches
    with torch.inference_mode():
        _, pooled = bert.forward(params, torch.from_numpy(ids).to(cuda), config)
    torch.cuda.synchronize()
    assert torch.isfinite(pooled).all()
    assert bert.encoder_attention_cuda.launches - before == config.n_layers


# ---------------------------------------------------------------------------
# the KServe v2 path: text encoder and built-ins on the card
# ---------------------------------------------------------------------------


def _random_ids(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    width = max(lengths)
    ids = np.zeros([len(lengths), width], dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, vocab, n)
    return ids


def test_tiny_text_encoder_on_the_card_equals_its_cpu_run(cuda):
    """fp32 (TF32 off) within 1e-5 of the same weights on the CPU."""
    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import TextEncoderModel

    config = bert.BertConfig.tiny(dtype=torch.float32)
    params = bert.init_params(torch.Generator().manual_seed(0), config, "cpu")
    on_card = {k: v for k, v in params.items() if k != "layers"}
    on_card = {k: v.to(cuda) for k, v in on_card.items()}
    on_card["layers"] = [{k: v.to(cuda) for k, v in layer.items()} for layer in params["layers"]]
    card_model = TextEncoderModel(config=config, params=on_card, device=cuda)
    cpu_model = TextEncoderModel(config=config, params=params, device="cpu")
    ids = _random_ids(1, [3, 200, 17, 64, 1], config.vocab_size)
    got = card_model.execute({"INPUT_IDS": ids}, {})["EMBEDDING"]
    want = cpu_model.execute({"INPUT_IDS": ids}, {})["EMBEDDING"]
    assert isinstance(got, np.ndarray) and got.shape == (5, config.d_model)
    assert np.abs(got - want).max() <= TOL


def test_bert_large_bf16_batched_equals_unbatched(cuda):
    """BERT-large widths (2 of 24 layers, bf16, random weights): a ragged
    batch is finite, and each row is within 2 % of its largest absolute
    value of the same sequence run alone (other M, other cuBLAS tiles)."""
    import dataclasses

    from client_tpu_torch.models import bert

    config = dataclasses.replace(bert.BertConfig(), n_layers=2)
    params = bert.init_params(torch.Generator(device=cuda).manual_seed(0), config, cuda)
    ids = _random_ids(2, [512, 16, 300, 77], config.vocab_size)
    with torch.inference_mode():
        _, batched = bert.forward(params, torch.from_numpy(ids).to(cuda), config)
        assert torch.isfinite(batched).all()
        for row, n in enumerate([512, 16, 300, 77]):
            alone = bert.forward(params, torch.from_numpy(ids[row:row + 1, :n]).to(cuda),
                                 config)[1][0]
            err = (batched[row] - alone).abs().max().item()
            assert err <= 2e-2 * alone.abs().max().item(), (row, err)


def test_run_bucketed_on_the_card_returns_host_arrays_of_the_true_rows(cuda):
    from client_tpu_torch.server import models

    a = np.arange(5 * 16, dtype=np.int32).reshape(5, 16)
    b = np.ones([5, 16], dtype=np.int32)
    seen = []

    def fn(x, y):
        seen.append((x.device.type, tuple(x.shape)))
        return x + y, (x - y).float()

    out0, out1 = models.run_bucketed(fn, a, b, device=cuda)
    assert seen == [("cuda", (8, 16))]
    assert isinstance(out0, np.ndarray) and out0.shape == (5, 16)
    assert np.array_equal(out0, a + b)
    assert out1.dtype == np.float32 and np.array_equal(out1, (a - b).astype(np.float32))
    model = models.AddSubModel(device=cuda)
    model.warmup()
    result = model.execute({"INPUT0": a, "INPUT1": b}, {})
    assert np.array_equal(result["OUTPUT0"], a + b)
    assert np.array_equal(result["OUTPUT1"], a - b)


# ---------------------------------------------------------------------------
# the image classifier and the TPU shared-memory staging on the card
# ---------------------------------------------------------------------------


def _perturbed_resnet(config, seed, device):
    """Thin-ResNet parameters with every norm perturbed (the default init
    zeroes each block's last norm scale, which hides the residual
    branches)."""
    from client_tpu_torch.models import resnet

    generator = torch.Generator().manual_seed(seed)
    params = resnet.init_params(generator, config, "cpu")
    norms = [params["bn_init"]] + [block[k] for block in params["blocks"]
                                   for k in ("norm0", "norm1", "norm2", "norm_proj")
                                   if k in block]
    for norm in norms:
        c = norm["scale"].shape
        norm["scale"] = torch.rand(c, generator=generator) + 0.5
        norm["bias"] = 0.1 * torch.randn(c, generator=generator)
        norm["mean"] = 0.1 * torch.randn(c, generator=generator)
        norm["var"] = torch.rand(c, generator=generator) + 0.5

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v) for v in tree]
        return tree.to(device)

    return params, move(params)


def test_tiny_classifier_on_the_card_equals_its_cpu_run(cuda):
    """fp32 (TF32 off) logits within 1e-4 of the largest |logit| of the
    same weights on the CPU, through the served model's execute."""
    from client_tpu_torch.models import resnet
    from client_tpu_torch.models.serving import ImageClassifierModel

    config = resnet.ResNetConfig((2, 1, 1, 1), 100, 16, torch.float32)
    cpu_params, card_params = _perturbed_resnet(config, 0, cuda)
    images = np.random.default_rng(1).normal(size=[3, 64, 64, 3]).astype(np.float32)
    got = ImageClassifierModel(image_size=64, config=config, params=card_params,
                               device=cuda).execute({"INPUT": images}, {})["OUTPUT"]
    want = ImageClassifierModel(image_size=64, config=config, params=cpu_params,
                                device="cpu").execute({"INPUT": images}, {})["OUTPUT"]
    assert isinstance(got, np.ndarray) and got.shape == (3, 100)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_bf16_classifier_on_the_card_is_within_2_percent_of_its_fp32_forward(cuda):
    """The same weights in bf16 (convolutions on the tensor cores, norms
    in fp32): finite logits within 2 % of the largest |logit| of the
    card's fp32 forward."""
    import dataclasses

    from client_tpu_torch.models import resnet

    config = resnet.ResNetConfig((2, 1, 1, 1), 100, 16, torch.float32)
    _, params = _perturbed_resnet(config, 2, cuda)
    bf16 = dataclasses.replace(config, dtype=torch.bfloat16)
    params_bf16 = {**params, "conv_init": params["conv_init"].to(torch.bfloat16),
                   "blocks": [{k: v.to(torch.bfloat16) if k.startswith("conv") else v
                               for k, v in block.items()} for block in params["blocks"]]}
    images = torch.from_numpy(
        np.random.default_rng(3).normal(size=[4, 64, 64, 3]).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        want = resnet.forward(params, images, config)
        got = resnet.forward(params_bf16, images, bf16)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_set_shared_memory_region_from_torch_reads_the_card_once(cuda):
    """Several CUDA tensors (and one host tensor) staged into a TPU region:
    the bytes land back to back, and the CUDA ones come back in ONE
    device-to-host copy; ``as_torch_tensor`` brings a slice back to the
    card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.utils import tpu_shared_memory as tpushm

    tensors = [torch.arange(10, dtype=torch.float32, device=cuda),
               torch.randn(3, 4, device=cuda).to(torch.bfloat16),
               torch.tensor([True, False, True], device=cuda),
               torch.arange(6, dtype=torch.int64).reshape(2, 3),  # a host tensor
               torch.full((5,), -7, dtype=torch.int32, device=cuda)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    region = tpushm.create_shared_memory_region(f"cuda_stage_{id(tensors)}", nbytes + 8)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tpushm.set_shared_memory_region_from_torch(region, tensors, offset=8)
        copies = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "dtoh" in e.key.lower()]
        assert sum(e.count for e in copies) == 1, [(e.key, e.count) for e in copies]
        want = b"".join(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()
                        if t.dtype == torch.bfloat16 else t.cpu().numpy().tobytes()
                        for t in tensors)
        assert bytes(region.buf(8, nbytes)) == want
        back = tpushm.as_torch_tensor(region, "FP32", [10], offset=8, device=cuda)
        assert back.device.type == "cuda" and torch.equal(back, tensors[0])
    finally:
        tpushm.destroy_shared_memory_region(region)

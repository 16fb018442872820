"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. build every kernel under ``client_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together);
2. hold K1 (decode attention) against its plain PyTorch version on the
   card, and time kernel, plain version, bound and library yardstick at
   the main path's shapes (Llama-7B decode: B=8, H=KV=32, D=128, bs=16,
   ragged contexts up to 4096);
2b. the same for K2 (the speculative verify's multi-query attention):
   fp32 ragged layouts with padding rows, then bf16 at the 7B verify
   shapes (T=5 rows per sequence), timed beside its plain versions,
   gather + SDPA with a per-row mask, and T sequential K1 launches;
3. run the tiny fp32 Llama through the engine on the card and check its
   greedy streams token for token against the dense oracle;
3b. the same with speculative decoding on (self-draft at K = 1, 2, 4 and
   n-gram at K = 4): the streams still equal the dense oracle;
4. serve: ``ServerCore`` + the HTTP front-end on a loopback port, the
   ``llm_engine`` model at Llama-7B widths (all 32 layers, bf16, random
   weights from seed 0), 8 concurrent streaming chat completions, two of
   them sharing a 128-token prefix; kernel launch counters are zeroed just
   before and read just after;
5. serve the same 8 prompts again from a second model on the same weights
   with n-gram speculation (K = 4), 128 tokens a stream: its verify steps
   run K2, whose launch counter is zeroed just before and read just after.

The last two lines are the card's name and power limit and the result
object; the line before them lists every kernel with its numbers.
"""

import contextlib
import gc
import http.client
import json
import math
import subprocess
import sys
import threading
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

from client_tpu_torch import kernels  # noqa: E402
from client_tpu_torch.models import llama  # noqa: E402
from client_tpu_torch.models import paged_attention as pa  # noqa: E402

DEVICE = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# the kernel's bf16 result is acc / l rounded once to bf16, like the
# plain version's: two fp32 values a few ulps apart can round to
# neighbouring bf16 values, so the two may differ by one bf16 ulp
# (2^-7 relative) of the largest output
BF16_ULP = 2.0 ** -7


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after a warm-up,
    from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_layout(gen, contexts, bs, table_width, num_blocks):
    """Page tables giving each sequence its context in distinct random
    blocks (block 0 stays the trash block); a context of 0 makes a
    padding lane (all-zero table, position 0)."""
    perm = torch.randperm(num_blocks - 1, generator=gen) + 1
    tables = torch.zeros(len(contexts), table_width, dtype=torch.int32)
    used = 0
    for i, n_ctx in enumerate(contexts):
        n = (n_ctx + bs - 1) // bs
        tables[i, :n] = perm[used:used + n]
        used += n
    positions = torch.tensor([max(c - 1, 0) for c in contexts], dtype=torch.int32)
    return tables.to(DEVICE), positions.to(DEVICE)


# ---------------------------------------------------------------------------
# phases 1-2: build, hold against the plain version, time
# ---------------------------------------------------------------------------


def build() -> None:
    t0 = time.perf_counter()
    paths = kernels.build_all()
    print(f"build: {len(paths)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for source, log in kernels.build_logs.items():
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        heavy = [s for s in spills if not s.startswith("0 bytes stack frame, 0 bytes spill")]
        print(f"build: {source}: {len(spills)} instances, {len(heavy)} with spills", flush=True)


def check_fp32() -> float:
    """fp32 random ragged layouts, bs in {8, 16}, g in {1, 2, 4}, with a
    padding lane: the kernel within 1e-5 of the stand-in."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for bs in (8, 16):
        for g in (1, 2, 4):
            kv, d, b, nb = 4, 128, 6, 8
            num_blocks = 1 + b * nb
            contexts = [int(torch.randint(1, nb * bs + 1, (1,), generator=gen))
                        for _ in range(b - 1)] + [0]
            tables, positions = ragged_layout(gen, contexts, bs, nb, num_blocks)
            k = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE)
            v = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE)
            q = torch.randn(b, kv * g, d, generator=gen).to(DEVICE)
            out = pa.paged_attention_cuda(q, k, v, tables, positions)
            ref = pa.paged_attention_standin(q, k, v, tables, positions)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            print(f"k1 fp32 bs={bs} g={g}: max_abs_err {err:.3g}", flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"K1 fp32 bs={bs} g={g}: {err} > 1e-5")
            worst = max(worst, err)
    return worst


def measure_7b() -> dict:
    """bf16 at Llama-7B decode shapes: hold the kernel against the
    stand-in, then time kernel, stand-in and gather + SDPA."""
    gen = torch.Generator().manual_seed(2)
    b, kv, d, bs, nb = 8, 32, 128, 16, 256
    contexts = [4096, 3001, 2048, 1500, 1024, 700, 333, 100]
    num_blocks = 1 + b * nb
    tables, positions = ragged_layout(gen, contexts, bs, nb, num_blocks)
    k = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE, torch.bfloat16)
    v = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE, torch.bfloat16)
    q = torch.randn(b, kv, d, generator=gen).to(DEVICE, torch.bfloat16)
    args = (q, k, v, tables, positions)

    out = pa.paged_attention_cuda(*args)
    ref = pa.paged_attention_standin(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ULP * ref.float().abs().max().item()
    print(f"k1 bf16 7B shapes: max_abs_err {err:.3g} (tolerance {tol:.3g}: one bf16 ulp "
          f"of the largest output)", flush=True)
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"K1 bf16 at 7B shapes: {err} > {tol}")

    s = nb * bs
    slots = torch.arange(s, device=DEVICE)
    mask = (slots[None, :] <= positions[:, None])[:, None, None, :]  # [B, 1, 1, S]

    def library():
        k_ctx = k[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
        v_ctx = v[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k_ctx, v_ctx, attn_mask=mask
        )[:, :, 0, :]

    lib_err = (library().float() - ref.float()).abs().max().item()
    times = {
        "ms": cuda_ms(lambda: pa.paged_attention_cuda(*args)),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_standin(*args)),
        "fused_ms": cuda_ms(lambda: pa.paged_attention_fused(*args)),
        "library_ms": cuda_ms(library),
    }
    # the least the card could take: every valid K/V row read once, q
    # read, out written, tables and positions read; 4 flops per element
    # of a valid row (q.k and p.v) against the bf16 peak
    valid_rows = sum(contexts)
    row_bytes = kv * d * 2
    moved = (2 * valid_rows * row_bytes + 2 * q.numel() * 2
             + tables.numel() * 4 + positions.numel() * 4)
    flops = 4 * valid_rows * kv * d
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOPS * 1e3
    times["bound_ms"] = max(bytes_ms, flops_ms)
    times["bound_by"] = "bytes" if bytes_ms >= flops_ms else "operations"
    times["max_abs_err"] = err
    print(f"k1 bf16 7B shapes: kernel {times['ms']:.4f} ms, stand-in {times['plain_ms']:.4f} ms, "
          f"fused {times['fused_ms']:.4f} ms, gather+sdpa {times['library_ms']:.4f} ms "
          f"(err {lib_err:.3g}), bound {times['bound_ms']:.4f} ms ({moved} bytes, "
          f"{times['bound_by']}), {times['bound_ms'] / times['ms']:.1%} of bound "
          f"[{card()}]", flush=True)
    return times


def verify_layout(gen, contexts, t, bs, table_width, num_blocks, lengths=None):
    """Page tables for ``contexts`` (as :func:`ragged_layout`) and the
    verify positions of T rows per lane: the last ``lengths[i]`` slots
    of context i are its real rows, and its padding rows repeat the last
    real position, as the engine sends them. A context of 0 makes a
    padding lane."""
    tables, _ = ragged_layout(gen, contexts, bs, table_width, num_blocks)
    positions = torch.zeros(len(contexts), t, dtype=torch.int32)
    for i, n_ctx in enumerate(contexts):
        n = t if lengths is None else lengths[i]
        if n_ctx:
            positions[i] = n_ctx - n + torch.clamp(torch.arange(t), max=n - 1)
    return tables, positions.to(DEVICE)


def check_verify_fp32() -> float:
    """K2, fp32, random ragged layouts, bs in {8, 16}, g in {1, 2, 4}, T
    in {2, 3, 5}, with padding rows and a padding lane: within 1e-5 of
    the multi-query stand-in."""
    gen = torch.Generator().manual_seed(3)
    worst = 0.0
    for bs in (8, 16):
        for g in (1, 2, 4):
            for t in (2, 3, 5):
                kv, d, b, nb = 4, 128, 6, 8
                num_blocks = 1 + b * nb
                contexts = [int(torch.randint(t, nb * bs + 1, (1,), generator=gen))
                            for _ in range(b - 1)] + [0]
                lengths = [int(torch.randint(1, t + 1, (1,), generator=gen)) for _ in range(b)]
                tables, positions = verify_layout(gen, contexts, t, bs, nb, num_blocks, lengths)
                k = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE)
                v = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE)
                q = torch.randn(b, t, kv * g, d, generator=gen).to(DEVICE)
                out = pa.paged_attention_cuda_mq(q, k, v, tables, positions)
                ref = pa.paged_attention_standin_mq(q, k, v, tables, positions)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"K2 fp32 bs={bs} g={g} T={t}: {err} > 1e-5")
                worst = max(worst, err)
    print(f"k2 fp32 (bs 8/16 x g 1/2/4 x T 2/3/5, padding rows and lane): worst "
          f"max_abs_err {worst:.3g}", flush=True)
    return worst


def measure_verify_7b() -> dict:
    """bf16 at Llama-7B verify shapes (B=8, T=5, K1's contexts, the last
    5 slots of each the verify rows): hold K2 against the stand-in, then
    time K2, stand-in, fused plain version, gather + SDPA with a
    ``[B, 1, T, S]`` mask, and T sequential K1 launches."""
    gen = torch.Generator().manual_seed(4)
    b, t, kv, d, bs, nb = 8, 5, 32, 128, 16, 256
    contexts = [4096, 3001, 2048, 1500, 1024, 700, 333, 100]
    num_blocks = 1 + b * nb
    tables, positions = verify_layout(gen, contexts, t, bs, nb, num_blocks)
    k = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE, torch.bfloat16)
    v = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE, torch.bfloat16)
    q = torch.randn(b, t, kv, d, generator=gen).to(DEVICE, torch.bfloat16)
    args = (q, k, v, tables, positions)

    out = pa.paged_attention_cuda_mq(*args)
    ref = pa.paged_attention_standin_mq(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ULP * ref.float().abs().max().item()
    print(f"k2 bf16 7B verify shapes: max_abs_err {err:.3g} (tolerance {tol:.3g}: one bf16 "
          f"ulp of the largest output)", flush=True)
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"K2 bf16 at 7B verify shapes: {err} > {tol}")

    s = nb * bs
    slots = torch.arange(s, device=DEVICE)
    mask = (slots[None, None, :] <= positions[:, :, None])[:, None]  # [B, 1, T, S]
    rows = [(q[:, r].contiguous(), positions[:, r].contiguous()) for r in range(t)]

    def library():
        k_ctx = k[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
        v_ctx = v[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k_ctx, v_ctx, attn_mask=mask
        ).transpose(1, 2)

    def sequential_k1():
        for q_row, pos_row in rows:
            pa.paged_attention_cuda(q_row, k, v, tables, pos_row)

    lib_err = (library().float() - ref.float()).abs().max().item()
    times = {
        "ms": cuda_ms(lambda: pa.paged_attention_cuda_mq(*args)),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_standin_mq(*args)),
        "fused_ms": cuda_ms(lambda: pa.paged_attention_fused_mq(*args)),
        "library_ms": cuda_ms(library),
        "k1_x_t_ms": cuda_ms(sequential_k1),
    }
    # the least the card could take: the valid K/V rows up to each
    # sequence's last verify position read once, q read, out written,
    # tables and positions read; 4 flops per element of every row's
    # visible slots (q.k and p.v) against the bf16 peak
    valid_rows = sum(contexts)
    row_bytes = kv * d * 2
    moved = (2 * valid_rows * row_bytes + 2 * q.numel() * 2
             + tables.numel() * 4 + positions.numel() * 4)
    visible = int((positions.long() + 1).sum())
    flops = 4 * visible * kv * d
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOPS * 1e3
    times["bound_ms"] = max(bytes_ms, flops_ms)
    times["bound_by"] = "bytes" if bytes_ms >= flops_ms else "operations"
    times["max_abs_err"] = err
    print(f"k2 bf16 7B verify shapes: kernel {times['ms']:.4f} ms, stand-in "
          f"{times['plain_ms']:.4f} ms, fused {times['fused_ms']:.4f} ms, gather+sdpa "
          f"{times['library_ms']:.4f} ms (err {lib_err:.3g}), {t} sequential K1 "
          f"{times['k1_x_t_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms ({moved} bytes, "
          f"{times['bound_by']}), {times['bound_ms'] / times['ms']:.1%} of bound "
          f"[{card()}]", flush=True)
    return times


# ---------------------------------------------------------------------------
# phases 3-5: the engine on the card, then serving over HTTP
# ---------------------------------------------------------------------------


def _tiny_streams(speculation=None):
    """The tiny fp32 Llama through the engine on the card, four concurrent
    greedy streams of 12 tokens, each held to the dense oracle. Returns
    the engine's stats."""
    import asyncio

    import numpy as np

    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = llama.init_params(gen, config, DEVICE)
    model = LlmEngineModel(
        config=config, params=params, device=DEVICE, speculation=speculation,
        engine_config=EngineConfig(block_size=8, num_blocks=65, max_active=8,
                                   max_seq_len=64),
    )
    model.warmup()
    prefix = [9, 3, 7, 1, 5, 2, 8, 4, 6, 1, 2, 3, 4, 5, 6, 7]
    prompts = [prefix + [10 + i, 20 + i] for i in range(3)] + [[5, 9, 17]]

    async def run(prompt):
        out = []
        async for item in model.execute_decoupled(
            {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, {"max_tokens": 12}
        ):
            out.append(int(item["OUTPUT_IDS"][0]))
        return out

    async def run_all():
        return await asyncio.gather(*(run(p) for p in prompts))

    streams = asyncio.run(run_all())
    stats = model.engine.stats()
    model.shutdown()
    for prompt, stream in zip(prompts, streams):
        dense = llama.generate(params, torch.tensor([prompt], device=DEVICE), config, 12)
        if stream != dense[0].tolist():
            raise AssertionError(f"engine ({speculation}) {stream} != dense {dense[0].tolist()}")
    if stats["kv_blocks_in_use"] != 0:
        raise AssertionError(f"{stats['kv_blocks_in_use']} KV blocks leaked ({speculation})")
    return stats


def check_tiny_engine() -> None:
    """The tiny fp32 Llama through the engine (prefill, suffix prefill,
    K1 decode at head_dim 16) against the dense oracle on the card."""
    stats = _tiny_streams()
    if stats["prefix_cache_hits"] < 1:
        raise AssertionError("the shared prefix was never matched")
    print(f"tiny fp32 engine on the card: 4 greedy streams equal the dense oracle, "
          f"{stats['prefix_cache_hits']} prefix blocks shared", flush=True)


def check_tiny_engine_speculation() -> None:
    """The tiny fp32 Llama with speculation on (self-draft K = 1, 2, 4;
    n-gram K = 4): K2 verifies at head_dim 16, and the streams still
    equal the dense oracle token for token."""
    for spec in ({"mode": "draft", "draft": "self", "k": 1},
                 {"mode": "draft", "draft": "self", "k": 2},
                 {"mode": "draft", "draft": "self", "k": 4},
                 {"mode": "ngram", "k": 4, "ngram": 2}):
        stats = _tiny_streams(spec)
        if stats["spec_steps"] < 1:
            raise AssertionError(f"{spec}: no verify step ran")
        if spec["mode"] == "draft" and not stats["tokens_per_step"] > 1.0:
            raise AssertionError(f"{spec}: tokens/step {stats['tokens_per_step']}")
        print(f"tiny fp32 engine, speculation {json.dumps(spec)}: 4 greedy streams equal the "
              f"dense oracle; {stats['spec_steps']} verify steps, acceptance "
              f"{stats['spec_acceptance_rate']:.3f}, tokens/step "
              f"{stats['tokens_per_step']:.3f}", flush=True)


def _prompts(vocab_words: int = 400):
    """Eight prompts of a few hundred words (one token each); prompts 0
    and 1 share their first 128 words."""
    import random

    rnd = random.Random(7)

    def words(n):
        return " ".join(f"w{rnd.randrange(vocab_words)}" for _ in range(n))

    shared = words(128)
    prompts = [shared + " " + words(120), shared + " " + words(200)]
    prompts += [words(150 + 40 * i) for i in range(6)]
    return prompts


def _stream_one(port: int, prompt: str, max_tokens: int, record: dict) -> None:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps({
            "model": "llm_engine", "stream": True, "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": prompt}],
        })
        t0 = time.perf_counter()
        conn.request("POST", "/v1/chat/completions", body=body,
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        record["status"] = response.status
        stamps, tokens, done = [], [], False
        while True:
            line = response.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                continue
            event = json.loads(payload)
            if "error" in event:
                raise AssertionError(f"in-band error: {event['error']}")
            content = event["choices"][0].get("delta", {}).get("content")
            if content:
                stamps.append(time.perf_counter())
                tokens.extend(int(t[3:]) for t in content.split())
        record.update(start=t0, stamps=stamps, tokens=tokens, done=done)
    finally:
        conn.close()


def profile_step(engine, contexts, rows: int = 1) -> dict:
    """Where one engine step's time goes at batch 8: host wall time per
    step (the engine's device callable, device-to-host logits included)
    and, from ``torch.profiler``, the device time of its kernels by kind.
    ``rows`` = 1 is a plain decode step; ``rows`` = T is a verify step of
    T rows per lane (``decode_multi``). The step writes into free pool
    blocks; nothing is being served."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.llm.engine import block_bucket

    bs = engine.config.block_size
    widths = [(c + rows - 1 + bs) // bs for c in contexts]  # blocks up to the last row
    nb = block_bucket(max(widths))
    tables = np.zeros([len(contexts), nb], dtype=np.int32)
    next_block = 1
    for i, n in enumerate(widths):
        tables[i, :n] = range(next_block, next_block + n)
        next_block += n
    if rows == 1:
        tokens = np.full([len(contexts)], 7, dtype=np.int32)
        positions = np.array(contexts, dtype=np.int32)

        def step():
            engine._decode(tokens, positions, tables, engine._pages)
    else:
        tokens = np.full([len(contexts), rows], 7, dtype=np.int32)
        positions = (np.array(contexts)[:, None] + np.arange(rows)[None, :]).astype(np.int32)
        lengths = np.full([len(contexts)], rows, dtype=np.int32)

        def step():
            engine._decode_multi(tokens, positions, lengths, tables, engine._pages)

    for _ in range(3):
        step()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            step()
    kinds = {"attention (K1)": 0.0, "attention (K2)": 0.0, "matmul": 0.0, "other": 0.0}
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.key.lower()
        if "rpa_decode_kernel" in name:
            kind = "attention (K1)"
        elif "rpa_decode_mq_kernel" in name:
            kind = "attention (K2)"
        elif any(tag in name for tag in ("gemm", "gemv", "cutlass", "nvjet", "xmma")):
            kind = "matmul"
        else:
            kind = "other"
        kinds[kind] += event.self_device_time_total / 1e3 / iters
    device_ms = sum(kinds.values())
    measured = device_ms > 0  # the profiler may see no device activity
    result = {
        "batch": len(contexts),
        "rows": rows,
        "table_width": nb,
        "host_ms_per_step": host_ms,
        "device_ms_per_step": device_ms if measured else "not measured",
        "device_ms_by_kind": kinds if measured else "not measured",
        "device_idle_share": 1.0 - device_ms / host_ms if measured else "not measured",
    }
    label = "step" if rows == 1 else "verify step"
    print(f"{label}: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@contextlib.contextmanager
def http_server(model):
    """``ServerCore`` + the HTTP front-end on a loopback port serving
    ``model`` (loaded here); yields the port, and stops the server, the
    engine and the event loop on the way out."""
    import asyncio

    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.http_server import serve_http
    from client_tpu_torch.server.model_repository import ModelRepository

    repository = ModelRepository()
    repository.add_model(model)
    torch.cuda.synchronize()
    entry = repository.index()[0]
    if entry["state"] != "READY":
        raise AssertionError(f"{model.name} did not load: {entry['reason']}")
    core = ServerCore(repository, max_workers=4)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    box = {}

    def run_loop():
        asyncio.set_event_loop(loop)
        try:
            box["server"] = loop.run_until_complete(serve_http(core, "127.0.0.1", 0))
        finally:
            started.set()
        loop.run_forever()

    loop_thread = threading.Thread(target=run_loop, daemon=True)
    loop_thread.start()
    started.wait(60)
    try:
        if "server" not in box:
            raise AssertionError("the HTTP front-end did not start")
        yield box["server"].port
    finally:
        async def stop():
            if "server" in box:
                await box["server"].close()
            core.close()
            # let the cancelled engine step loop unwind before the loop stops
            others = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            await asyncio.gather(*others, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(60)


def model_config(port: int) -> dict:
    """The served ``llm_engine``'s config parameters, after a readiness
    check."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/v2/health/ready")
    ready = conn.getresponse()
    ready.read()
    conn.request("GET", "/v2/models/llm_engine/config")
    doc = json.loads(conn.getresponse().read())
    conn.close()
    if ready.status != 200:
        raise AssertionError(f"/v2/health/ready answered {ready.status}")
    kernel = doc["parameters"]["decode_kernel"]["string_value"]
    if kernel != "cuda":
        raise AssertionError(f"decode_kernel is {kernel!r}, not 'cuda'")
    return doc["parameters"]


def stream_all(port: int, max_tokens: int, vocab_size: int) -> tuple:
    """The 8 prompts as concurrent streaming chat completions; checks that
    every stream delivered ``max_tokens`` in-vocabulary tokens and
    ``[DONE]``. Returns (records, wall seconds)."""
    records = [dict() for _ in range(8)]
    threads = [
        threading.Thread(target=_stream_one, args=(port, p, max_tokens, r))
        for p, r in zip(_prompts(), records)
    ]
    t_start = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(900)
    wall = time.perf_counter() - t_start
    for i, record in enumerate(records):
        if record.get("status") != 200 or not record.get("done"):
            raise AssertionError(f"stream {i} failed: {record}")
        if len(record["tokens"]) != max_tokens:
            raise AssertionError(
                f"stream {i} delivered {len(record['tokens'])} tokens, not {max_tokens}")
        if not all(0 <= t < vocab_size for t in record["tokens"]):
            raise AssertionError(f"stream {i} has out-of-vocabulary ids")
    return records, wall


def latency(records, wall) -> dict:
    ttft = [r["stamps"][0] - r["start"] for r in records]
    gaps = sorted(b - a for r in records for a, b in zip(r["stamps"], r["stamps"][1:]))
    tokens = sum(len(r["tokens"]) for r in records)
    return {
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
        "ttft_ms_max": 1e3 * max(ttft),
        "itl_ms_mean": 1e3 * sum(gaps) / len(gaps),
        "itl_ms_p50": 1e3 * gaps[len(gaps) // 2],
        "itl_ms_p99": 1e3 * gaps[min(len(gaps) - 1, math.ceil(0.99 * len(gaps)) - 1)],
    }


SERVE_TOKENS = 32
# random weights rarely repeat a token of the context within 32 tokens, so
# an n-gram proposal is rare that early; 128 tokens a stream make verify
# steps all but certain (a stream's greedy tokens fall into cycles)
SPEC_SERVE_TOKENS = 128


def serve_7b() -> tuple:
    """Phase 4: serve 8 concurrent streams at Llama-7B widths over HTTP.
    Returns (result, the served weights, the 8 token streams)."""
    import numpy as np

    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig()  # Llama-7B widths, bf16, max_seq_len 4096
    t0 = time.perf_counter()
    model = LlmEngineModel(config=config, device=DEVICE)
    with http_server(model) as port:
        pool = model.engine_config
        print(f"serve: llm_engine loaded in {time.perf_counter() - t0:.1f} s "
              f"({pool.num_blocks} blocks x {pool.block_size} tokens, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)", flush=True)
        model_config(port)
        engine = model.engine
        steps0 = engine.steps
        # -- the main path: counters zeroed just before, read just after --
        pa.paged_attention_cuda.launches = 0
        pa.paged_attention_cuda_mq.launches = 0
        records, wall = stream_all(port, SERVE_TOKENS, config.vocab_size)
        launches = pa.paged_attention_cuda.launches
        # -------------------------------------------------------------------
        decode_steps = engine.steps - steps0
        prefix_hits = engine.allocator.prefix_hits
        if launches < config.n_layers * decode_steps:
            raise AssertionError(
                f"K1 launched {launches} times for {decode_steps} decode steps "
                f"x {config.n_layers} layers")
        if prefix_hits < 1:
            raise AssertionError("the shared prefix was never matched: "
                                 "prefill_suffix_into_pages did not run")
        if engine.allocator.blocks_in_use != 0:
            raise AssertionError(f"{engine.allocator.blocks_in_use} KV blocks leaked")

        # the served weights give finite logits of the right shape
        probe = np.zeros([1, 16], dtype=np.int32)
        probe[0, :5] = [1, 2, 3, 4, 5]
        table = np.zeros([pool.max_blocks_per_seq], dtype=np.int32)
        logits, _ = engine._prefill(probe, table, engine._pages, 4, 0)
        if logits.shape != (1, config.vocab_size) or not np.isfinite(logits).all():
            raise AssertionError(f"7B prefill logits: shape {logits.shape}, finite "
                                 f"{np.isfinite(logits).all()}")
        profile_step(engine, [len(p.split()) + SERVE_TOKENS for p in _prompts()])

    result = latency(records, wall)
    result.update(decode_steps=decode_steps, k1_launches=launches,
                  prefix_blocks_shared=prefix_hits)
    print("serve: " + json.dumps(result) + f" [{card()}]", flush=True)
    params = model._params
    # only one 17 GB pool at a time: drop this engine and its pool
    model.engine = None
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return result, params, [r["tokens"] for r in records]


def serve_7b_speculative(params, plain_streams) -> dict:
    """Phase 5: the same 8 prompts from a second model on phase 4's
    weights with n-gram speculation (K = 4): the verify steps run K2.
    Each stream is compared with phase 4's spec-off stream over the
    latter's length."""
    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig()
    spec = {"mode": "ngram", "k": 4}
    t0 = time.perf_counter()
    model = LlmEngineModel(config=config, params=params, device=DEVICE, speculation=spec)
    with http_server(model) as port:
        print(f"serve-spec: llm_engine ({json.dumps(spec)}) loaded in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card", flush=True)
        parameters = model_config(port)
        if json.loads(parameters["speculation"]["string_value"]) != spec:
            raise AssertionError(f"config reports speculation {parameters['speculation']}")
        engine = model.engine
        before = engine.stats()
        # -- the main path: counters zeroed just before, read just after --
        pa.paged_attention_cuda.launches = 0
        pa.paged_attention_cuda_mq.launches = 0
        records, wall = stream_all(port, SPEC_SERVE_TOKENS, config.vocab_size)
        k2_launches = pa.paged_attention_cuda_mq.launches
        k1_launches = pa.paged_attention_cuda.launches
        # -------------------------------------------------------------------
        after = engine.stats()
        delta = {key: after[key] - before[key]
                 for key in ("steps", "spec_steps", "spec_proposed", "spec_accepted",
                             "step_tokens", "lane_steps")}
        if delta["spec_steps"] < 1:
            raise AssertionError("no speculative verify step ran")
        if k2_launches < config.n_layers * delta["spec_steps"]:
            raise AssertionError(
                f"K2 launched {k2_launches} times for {delta['spec_steps']} verify steps "
                f"x {config.n_layers} layers")
        if engine.allocator.blocks_in_use != 0:
            raise AssertionError(f"{engine.allocator.blocks_in_use} KV blocks leaked")
        profile_step(engine, [len(p.split()) + SERVE_TOKENS for p in _prompts()],
                     rows=spec["k"] + 1)

    streams = [r["tokens"][:len(b)] for r, b in zip(records, plain_streams)]
    same = [a == b for a, b in zip(streams, plain_streams)]
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                  for a, b in zip(streams, plain_streams)]
    result = latency(records, wall)
    result.update(
        decode_steps=delta["steps"],
        spec_steps=delta["spec_steps"],
        acceptance_rate=delta["spec_accepted"] / max(1, delta["spec_proposed"]),
        tokens_per_step=delta["step_tokens"] / max(1, delta["lane_steps"]),
        k1_launches=k1_launches,
        k2_launches=k2_launches,
        streams_equal_to_spec_off=sum(same),
        first_differing_index=first_diff,
    )
    print("serve-spec: " + json.dumps(result) + f" [{card()}]", flush=True)
    model.engine = None
    return result


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card()}", flush=True)
    build()
    fp32_err = check_fp32()
    k1 = measure_7b()
    check_verify_fp32()
    k2 = measure_verify_7b()
    check_tiny_engine()
    check_tiny_engine_speculation()
    served, params, plain_streams = serve_7b()
    served_spec = serve_7b_speculative(params, plain_streams)
    line = {
        "kernels": [
            {
                "name": "paged_attention_decode",
                "route": "cuda",
                "source": "client_tpu_torch/csrc/paged_attention.cu",
                "replaces": "client_tpu/models/paged_attention.py:205",
                "launches": served["k1_launches"],
                "max_abs_err": k1["max_abs_err"],
                "ms": k1["ms"],
                "plain_ms": k1["plain_ms"],
                "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"],
                "library_ms": k1["library_ms"],
            },
            {
                "name": "paged_attention_decode_mq",
                "route": "cuda",
                "source": "client_tpu_torch/csrc/paged_attention_mq.cu",
                "replaces": "client_tpu/models/paged_attention.py:310",
                "launches": served_spec["k2_launches"],
                "max_abs_err": k2["max_abs_err"],
                "ms": k2["ms"],
                "plain_ms": k2["plain_ms"],
                "bound_ms": k2["bound_ms"],
                "bound_by": k2["bound_by"],
                "library_ms": k2["library_ms"],
            },
        ]
    }
    print(f"k1 fp32 worst max_abs_err {fp32_err:.3g}", flush=True)
    print(json.dumps(line), flush=True)
    print(card(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

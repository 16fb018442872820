"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. build every kernel under ``client_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together) and print each instance's
   registers, spills, shared memory and resident blocks an SM;
2. hold K1 (decode attention) against its plain PyTorch versions on the
   card (fp32 within 1e-5 on random ragged layouts and on layouts that
   straddle its split-KV partitions, bf16 within one bf16 ulp), and time
   kernel, plain versions, bound and library yardstick at the main path's
   shapes (``attention_bench.py``: Llama-7B decode, B=8, H=KV=32, D=128,
   bs=16, ragged contexts up to 4096) and at the serve contexts phase 4
   decodes;
2b. the same for K2 (the speculative verify's multi-query attention, T=5
   rows per sequence at the 7B shapes), with padding rows, verify rows
   that see nothing of the last partition, and T sequential K1 launches;
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
   run K2, whose launch counter is zeroed just before and read just after;
6. the KServe v2 infer route (``POST /v2/models/<m>/infer``) through the
   dynamic batcher: (a) ``simple``, the identities and a tiny fp32
   ``text_encoder`` from one ``ServerCore`` — AddSub exact and the
   identities bit for bit in JSON and binary, 16 concurrent encoder
   requests within 1e-5 of the plain forward on the CPU and merged into
   fewer executions; (b) ``text_encoder`` at BERT-large's widths (24
   layers, bf16, random weights from seed 0): 128 binary requests from 16
   client threads, lengths 16-512, each held to the model's unbatched
   forward on the card (2 % of the answer's largest value), the
   ``kserve:`` line (requests/s, latency p50/p99, rows per execution,
   load and warmup), and one 16 x 512 execution profiled against its
   FLOP bound (``kserve execution:``). This path has no TPU kernel.
7. the image classifier and the shared-memory data plane: (a) a tiny fp32
   ResNet (stage_sizes (2, 1, 1, 1), 16 filters, 64 x 64, every norm
   perturbed) within 1e-4 of the largest |logit| of its CPU forward, one
   image byte-identical over inline binary, system shm and TPU shm, top-3
   classification over shm, ``identity_fp32`` bit-exact through both
   region kinds, the shm routes' semantics (``image tiny:``); (b)
   ``image_classifier`` at ResNet-50's widths (224 x 224, 1000 classes,
   bf16, random weights from seed 0): 128 one-image requests from 8
   clients over inline binary, system shm and TPU shm, each answer within
   2 % of its unbatched forward (``image:`` images/s, latency, rows per
   execution), one 8-image execution profiled against its FLOP bound
   (``image execution:``); (c) ``identity_fp32`` at 4 MiB a request, 4
   clients, 64 requests, per route (``data plane:`` MiB/s, p99). This path
   has no TPU kernel either.

The last two lines are the card's name and power limit and the result
object; the line before them lists every kernel with its numbers.
"""

import contextlib
import gc
import http.client
import json
import math
import re
import sys
import threading
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

import attention_bench as bench  # noqa: E402
from attention_bench import BF16_ULP, card, cuda_ms  # noqa: E402
from client_tpu_torch import kernels  # noqa: E402
from client_tpu_torch.llm.engine import block_bucket  # noqa: E402
from client_tpu_torch.models import llama  # noqa: E402
from client_tpu_torch.models import paged_attention as pa  # noqa: E402

DEVICE = torch.device("cuda")


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
    """Build both kernels; print each instance's registers and spills (from
    ptxas) and its dynamic shared memory and resident blocks an SM at the
    default partition (from the runtime)."""
    import ctypes

    t0 = time.perf_counter()
    paths = kernels.build_all()
    print(f"build: {len(paths)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    describe = {"paged_attention.cu": "rpa_describe", "paged_attention_mq.cu": "rpa_mq_describe"}
    for source, log in kernels.build_logs.items():
        instances = {}
        name = None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = entry.group(1)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and name:
                instances.setdefault(name, {})["spills"] = int(spill.group(1)) + int(spill.group(2))
            regs = re.search(r"Used (\d+) registers", line)
            if regs and name:
                instances.setdefault(name, {})["registers"] = int(regs.group(1))
        lib = kernels.load(source)
        for mangled, info in sorted(instances.items()):
            shape = re.search(r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
            dtype, d, rows = ("fp32" if shape.group(1) == "f" else "bf16"), int(shape.group(2)), \
                int(shape.group(3))
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            code = getattr(lib, describe[source])(0 if dtype == "fp32" else 1, d, rows,
                                                  pa.PARTITION_SLOTS, ctypes.byref(smem),
                                                  ctypes.byref(blocks))
            if code != 0:
                raise AssertionError(f"{source} {dtype} D={d} rows={rows}: describe failed "
                                     f"({code})")
            print(f"build: {source} {dtype} D={d} rows={rows}: {info.get('registers')} registers, "
                  f"{info.get('spills')} bytes spilled, {smem.value} bytes shared memory, "
                  f"{blocks.value} blocks ({4 * blocks.value} warps) an SM", flush=True)
        heavy = [n for n, info in instances.items() if info.get("spills")]
        print(f"build: {source}: {len(instances)} instances, {len(heavy)} with spills", flush=True)


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


def check_edges(rows=None) -> float:
    """K1 (``rows`` None) or K2 (T = ``rows``) on layouts that straddle
    the split-KV partitions, at the default partition P and at P = 32:
    contexts of P - 1, P, P + 1 and 2P + 1 slots, a 1-slot context, a lane
    whose verify rows start at P - 2 (its first rows see nothing of the
    second partition) and a padding lane. fp32 (g 1 and 4) within 1e-5 of
    the stand-in and of the plain split version; bf16 (D = 128, the
    tensor-core scores) within one bf16 ulp of the largest output."""
    gen = torch.Generator().manual_seed(6)
    kernel = pa.paged_attention_cuda if rows is None else pa.paged_attention_cuda_mq
    standin = pa.paged_attention_standin if rows is None else pa.paged_attention_standin_mq
    split = pa.paged_attention_split if rows is None else pa.paged_attention_split_mq
    label = "k1" if rows is None else f"k2 T={rows}"
    worst = 0.0
    for partition in (pa.PARTITION_SLOTS, 32):
        bs, kv, d = 16, 4, 128
        contexts = [partition - 1, partition, partition + 1, 2 * partition + 1, 1,
                    partition - 2 + (rows or 1), 0]
        nb = max(-(-c // bs) for c in contexts) + 1
        num_blocks = 1 + sum(-(-c // bs) for c in contexts)
        if rows is None:
            tables, positions = ragged_layout(gen, contexts, bs, nb, num_blocks)
        else:
            tables, positions = verify_layout(gen, contexts, rows, bs, nb, num_blocks,
                                              [min(c, rows) for c in contexts])
        k = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE)
        v = torch.randn(num_blocks, bs, kv, d, generator=gen).to(DEVICE)
        for g in (1, 4):
            q_shape = (len(contexts), kv * g, d) if rows is None else (len(contexts), rows, kv * g, d)
            q = torch.randn(*q_shape, generator=gen).to(DEVICE)
            args = (q, k, v, tables, positions)
            out = kernel(*args, partition=partition)
            err = max((out - standin(*args)).abs().max().item(),
                      (out - split(*args, partition)).abs().max().item())
            torch.cuda.synchronize()
            if not (err <= 1e-5 and torch.isfinite(out).all()):
                raise AssertionError(f"{label} fp32 edges P={partition} g={g}: {err} > 1e-5")
            worst = max(worst, err)
        q = torch.randn(*q_shape[:-2], kv, d, generator=gen).to(DEVICE, torch.bfloat16)
        args = (q, k.to(torch.bfloat16), v.to(torch.bfloat16), tables, positions)
        out = kernel(*args, partition=partition)
        ref = standin(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_ULP * ref.float().abs().max().item()
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"{label} bf16 edges P={partition}: {err} > {tol}")
        print(f"{label} edges P={partition} (contexts {contexts}): bf16 max_abs_err {err:.3g} "
              f"(tolerance {tol:.3g})", flush=True)
    print(f"{label} fp32 edges: worst max_abs_err {worst:.3g} (limit 1e-5)", flush=True)
    return worst


def measure_kernel(rows=None) -> dict:
    """K1 (``rows`` None) or K2 (T = ``rows``) in bf16 at the long Llama-7B
    shapes and at the serve contexts (``attention_bench.py``): held to the
    stand-in, timed beside its stand-in and fused plain versions, its
    bound and gather + SDPA; K2 also beside T sequential K1 launches."""
    label = "k1" if rows is None else "k2"
    standin = pa.paged_attention_standin if rows is None else pa.paged_attention_standin_mq
    fused = pa.paged_attention_fused if rows is None else pa.paged_attention_fused_mq
    times, cases = bench.measure(pa, rows, bench.LONG_CONTEXTS, bench.LONG_TABLE_WIDTH, seed=1)
    q, k, v, tables, positions = cases[0]
    times["plain_ms"] = cuda_ms(lambda: standin(*cases[0]))
    times["fused_ms"] = cuda_ms(lambda: fused(*cases[0]))
    extra = ""
    if rows is not None:
        split = [(q[:, r].contiguous(), positions[:, r].contiguous()) for r in range(rows)]

        def sequential_k1():
            for q_row, pos_row in split:
                pa.paged_attention_cuda(q_row, k, v, tables, pos_row)

        times["k1_x_t_ms"] = cuda_ms(sequential_k1)
        extra = f", {rows} sequential K1 {times['k1_x_t_ms']:.4f} ms"
    print(f"{label} bf16 7B shapes: max_abs_err {times['max_abs_err']:.3g} (tolerance "
          f"{times['tolerance']:.3g}: one bf16 ulp of the largest output); kernel "
          f"{times['ms']:.4f} ms, stand-in {times['plain_ms']:.4f} ms, fused "
          f"{times['fused_ms']:.4f} ms, gather+sdpa {times['library_ms']:.4f} ms{extra}, wrapper "
          f"issue {times['host_us']:.1f} us, bound "
          f"{times['bound_ms']:.4f} ms ({times['bound_by']}), "
          f"{times['bound_ms'] / times['ms']:.1%} of bound [{card()}]", flush=True)
    contexts = bench.serve_contexts()
    width = block_bucket(max(-(-c // bench.BLOCK_SIZE) for c in contexts))
    serve, _ = bench.measure(pa, rows, contexts, width, bench.SERVE_COPIES, seed=2)
    times.update(serve_ms=serve["ms"], serve_bound_ms=serve["bound_ms"],
                 serve_library_ms=serve["library_ms"])
    print(f"{label} bf16 serve contexts {contexts} (table width {width}, "
          f"{bench.SERVE_COPIES} copies in turn): max_abs_err {serve['max_abs_err']:.3g}; kernel "
          f"{serve['ms']:.4f} ms, gather+sdpa {serve['library_ms']:.4f} ms, bound "
          f"{serve['bound_ms']:.4f} ms ({serve['bound_by']}), "
          f"{serve['bound_ms'] / serve['ms']:.1%} of bound [{card()}]", flush=True)
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
    """Eight prompts of ``attention_bench.PROMPT_WORDS`` words (one token
    each); prompts 0 and 1 share their first 128 words."""
    import random

    rnd = random.Random(7)

    def words(n):
        return " ".join(f"w{rnd.randrange(vocab_words)}" for _ in range(n))

    shared = words(128)
    first, second, *rest = bench.PROMPT_WORDS
    prompts = [shared + " " + words(first - 128), shared + " " + words(second - 128)]
    prompts += [words(n) for n in rest]
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
    step_ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()  # ends in the device-to-host copy of the logits
        step_ms.append((time.perf_counter() - t0) * 1e3)
    host_ms = sum(step_ms) / iters
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
        # the host's clock is shared with other work on the machine: the
        # median resists the outliers the mean takes in
        "host_ms_per_step_median": sorted(step_ms)[iters // 2],
        "device_ms_per_step": device_ms if measured else "not measured",
        "device_ms_by_kind": kinds if measured else "not measured",
        "device_idle_share": 1.0 - device_ms / host_ms if measured else "not measured",
    }
    label = "step" if rows == 1 else "verify step"
    print(f"{label}: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@contextlib.contextmanager
def http_server(*models):
    """``ServerCore`` + the HTTP front-end on a loopback port serving
    ``models`` (loaded here); yields the port, and stops the server, the
    engine and the event loop on the way out."""
    import asyncio

    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.http_server import serve_http
    from client_tpu_torch.server.model_repository import ModelRepository

    repository = ModelRepository()
    for model in models:
        repository.add_model(model)
    torch.cuda.synchronize()
    for entry in repository.index():
        if entry["state"] != "READY":
            raise AssertionError(f"{entry['name']} did not load: {entry['reason']}")
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


def percentile(values, q):
    """The nearest-rank ``q`` quantile of ``values``."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))]


def latency(records, wall) -> dict:
    ttft = [r["stamps"][0] - r["start"] for r in records]
    gaps = [b - a for r in records for a, b in zip(r["stamps"], r["stamps"][1:])]
    tokens = sum(len(r["tokens"]) for r in records)
    return {
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
        "ttft_ms_max": 1e3 * max(ttft),
        "itl_ms_mean": 1e3 * sum(gaps) / len(gaps),
        "itl_ms_p50": 1e3 * percentile(gaps, 0.5),
        "itl_ms_p99": 1e3 * percentile(gaps, 0.99),
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


# ---------------------------------------------------------------------------
# phase 6: the KServe v2 infer route on the card
# ---------------------------------------------------------------------------


def kserve_infer(conn, model, inputs, binary=True, outputs=()):
    """One ``POST /v2/models/<model>/infer`` on ``conn``. ``inputs`` are
    (name, datatype, array), sent as JSON or with the binary-tensor
    extension (BF16 is always binary), or (name, datatype, array, (region,
    byte_size, offset)), which the server reads from a registered
    shared-memory region (the array gives the shape). ``outputs`` are
    names, or (name, parameters) pairs. Returns {output name: array, or
    its parameters for an output written to a region}; raises
    :class:`InferError` on a non-200."""
    import numpy as np

    from client_tpu_torch import utils

    tensors, chunks = [], []
    for name, datatype, array, *shm in inputs:
        entry = {"name": name, "datatype": datatype, "shape": list(array.shape)}
        if shm:
            region, size, offset = shm[0]
            entry["parameters"] = {"shared_memory_region": region,
                                   "shared_memory_byte_size": size,
                                   "shared_memory_offset": offset}
        elif binary or datatype == "BF16":
            raw = (utils.serialize_byte_tensor(array) if datatype == "BYTES"
                   else np.ascontiguousarray(array)).tobytes()
            entry["parameters"] = {"binary_data_size": len(raw)}
            chunks.append(raw)
        elif datatype == "BYTES":
            entry["data"] = [b.decode() for b in array.reshape(-1)]
        else:
            entry["data"] = array.reshape(-1).tolist()
        tensors.append(entry)
    payload = {"inputs": tensors,
               "outputs": [{"name": o, "parameters": {"binary_data": binary}}
                           if isinstance(o, str) else {"name": o[0], "parameters": dict(o[1])}
                           for o in outputs]}
    header = json.dumps(payload).encode()
    headers = {"Content-Type": "application/octet-stream"}
    if chunks:
        headers["Inference-Header-Content-Length"] = str(len(header))
    conn.request("POST", f"/v2/models/{model}/infer", body=header + b"".join(chunks),
                 headers=headers)
    response = conn.getresponse()
    body = response.read()
    if response.status != 200:
        raise InferError(model, response.status, body)
    header_len = response.getheader("Inference-Header-Content-Length")
    split = int(header_len) if header_len else len(body)
    doc, tail, offset, out = json.loads(body[:split]), body[split:], 0, {}
    for o in doc["outputs"]:
        params = o.get("parameters", {})
        if "shared_memory_region" in params:
            out[o["name"]] = params
            continue
        size = params.get("binary_data_size")
        if size is None:
            data = o["data"]
            if o["datatype"] == "BYTES":
                array = np.array([d.encode() for d in data], dtype=object)
            else:
                array = np.array(data, dtype=utils.triton_to_np_dtype(o["datatype"]))
        else:
            raw = tail[offset:offset + size]
            offset += size
            array = (utils.deserialize_bytes_tensor(raw) if o["datatype"] == "BYTES"
                     else np.frombuffer(raw, dtype=utils.triton_to_np_dtype(o["datatype"])))
        out[o["name"]] = array.reshape(o["shape"])
    return out


class InferError(AssertionError):
    def __init__(self, model, status, body):
        super().__init__(f"{model}: HTTP {status} {body[:300]!r}")
        self.status = status
        self.body = body


def _stats(port, model):
    """``model``'s entry of the statistics route."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", f"/v2/models/{model}/stats")
        response = conn.getresponse()
        body = response.read()
        if response.status != 200:
            raise AssertionError(f"{model} stats: HTTP {response.status}")
        return json.loads(body)["model_stats"][0]
    finally:
        conn.close()


def _concurrently(port, work, threads):
    """Run ``work(conn, i)`` for i in range(len) on ``threads`` client
    threads (one keep-alive connection each), started together; returns
    the results and each call's latency in seconds."""
    n = len(work)
    results, latencies, errors = [None] * n, [None] * n, []
    barrier = threading.Barrier(threads)

    def client(worker):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            barrier.wait(60)
            for i in range(worker, n, threads):
                t0 = time.perf_counter()
                results[i] = work[i](conn)
                latencies[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)
        finally:
            conn.close()

    pool = [threading.Thread(target=client, args=(w,)) for w in range(threads)]
    t_start = time.perf_counter()
    for thread in pool:
        thread.start()
    for thread in pool:
        thread.join(900)
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    if any(thread.is_alive() for thread in pool) or None in latencies:
        raise AssertionError("a client thread did not finish")
    return results, latencies, wall


def kserve_tiny() -> None:
    """Phase 6a: the built-ins and a tiny fp32 ``text_encoder`` on the
    card, one ``ServerCore``: AddSub exact, the identities bit for bit
    (JSON and binary), 16 concurrent encoder requests within 1e-5 of the
    plain forward on the CPU one at a time, merged by the batcher."""
    import numpy as np

    from client_tpu_torch import utils
    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import TextEncoderModel
    from client_tpu_torch.server import models

    config = bert.BertConfig.tiny(dtype=torch.float32)
    cpu_params = bert.init_params(torch.Generator().manual_seed(4), config, "cpu")
    card_params = {k: v.to(DEVICE) for k, v in cpu_params.items() if k != "layers"}
    card_params["layers"] = [{k: v.to(DEVICE) for k, v in layer.items()}
                             for layer in cpu_params["layers"]]
    served = [models.AddSubModel(device=DEVICE),
              models.IdentityModel("identity_fp32", "FP32", device=DEVICE),
              models.IdentityModel("identity_bf16", "BF16", device=DEVICE),
              models.BytesIdentityModel(device=DEVICE),
              TextEncoderModel(config=config, params=card_params, device=DEVICE)]
    rng = np.random.default_rng(0)
    with http_server(*served) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        a = rng.integers(-2**20, 2**20, [5, 16], dtype=np.int32)
        b = rng.integers(-2**20, 2**20, [5, 16], dtype=np.int32)
        fp32 = rng.normal(size=[33]).astype(np.float32)
        bf16 = utils.deserialize_bf16_tensor(
            utils.serialize_bf16_tensor(rng.normal(size=[64]).astype(np.float32)))
        strings = np.array([b"alpha", b"", "été".encode()], dtype=object)
        for binary in (False, True):
            out = kserve_infer(conn, "simple", [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)],
                               binary, ("OUTPUT0", "OUTPUT1"))
            if not (np.array_equal(out["OUTPUT0"], a + b) and np.array_equal(out["OUTPUT1"], a - b)):
                raise AssertionError(f"simple (binary={binary}) is not a+b, a-b")
            for model, datatype, array in (("identity_fp32", "FP32", fp32),
                                           ("identity_bf16", "BF16", bf16),
                                           ("identity_bytes", "BYTES", strings)):
                got = kserve_infer(conn, model, [("INPUT0", datatype, array)], binary,
                                   ("OUTPUT0",))["OUTPUT0"]
                same = (list(got) == list(array) if datatype == "BYTES"
                        else got.tobytes() == array.tobytes())
                if not same:
                    raise AssertionError(f"{model} (binary={binary}) did not round-trip")
        conn.close()

        lengths = rng.integers(3, 201, 16)
        seqs = [rng.integers(1, config.vocab_size, n, dtype=np.int32) for n in lengths]
        before = _stats(port, "text_encoder")
        work = [lambda c, s=s: kserve_infer(c, "text_encoder", [("INPUT_IDS", "INT32", s[None])],
                                            outputs=("EMBEDDING",))["EMBEDDING"][0]
                for s in seqs]
        answers, _, _ = _concurrently(port, work, 16)
        after = _stats(port, "text_encoder")
    worst = 0.0
    with torch.inference_mode():
        for seq, got in zip(seqs, answers):
            want = bert.forward(cpu_params, torch.from_numpy(seq[None]), config)[1][0].numpy()
            worst = max(worst, float(np.abs(got - want).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"text_encoder on the card vs the CPU: {worst} > 1e-5")
    requests = after["inference_count"] - before["inference_count"]
    executions = after["execution_count"] - before["execution_count"]
    if requests != 16 or not executions < requests:
        raise AssertionError(f"text_encoder: {requests} requests in {executions} executions")
    print(f"kserve tiny: simple exact, identity_fp32/bf16/bytes bit-exact (JSON and binary); "
          f"16 concurrent text_encoder requests (lengths {int(lengths.min())}-"
          f"{int(lengths.max())}) within {worst:.3g} of the CPU forward (limit 1e-5) in "
          f"{executions} executions", flush=True)


KSERVE_REQUESTS = 128
KSERVE_CLIENTS = 16


def bert_large_bound_ms(config, rows: int, length: int) -> dict:
    """The least time one execution of ``rows`` x ``length`` tokens could
    take on the card: weight and attention products at the dense bf16 peak
    (989 TFLOP/s) against the weights' bytes at 3.35 TB/s."""
    d, f, layers = config.d_model, config.d_ff, config.n_layers
    tokens = rows * length
    weight_flops = 2 * layers * (4 * d * d + 2 * d * f) * tokens
    attention_flops = 2 * 2 * layers * rows * length * length * d
    weight_bytes = 2 * (layers * (4 * d * d + 2 * d * f) + (config.vocab_size + config.max_seq_len) * d)
    ops_ms = (weight_flops + attention_flops) / 989e12 * 1e3
    bytes_ms = weight_bytes / 3.35e12 * 1e3
    return {"tflop": (weight_flops + attention_flops) / 1e12,
            "weight_tflop": weight_flops / 1e12, "attention_tflop": attention_flops / 1e12,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def profile_device(step, kinds, bound_ms, iters: int = 10) -> dict:
    """Host wall time of ``step()`` (after 3 warm-up calls, ``iters``
    timed) and, from ``torch.profiler`` over ``iters`` more, its device
    time by kind against ``bound_ms``: ``kinds`` maps a kind to the name
    tags that put a kernel in it (the first match wins; the rest is
    "other"). Device numbers are "not measured" when the profiler saw no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    wall = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            step()
    by_kind = dict.fromkeys([*kinds, "other"], 0.0)
    by_kernel, launches = {}, 0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.key.lower()
        kind = next((k for k, tags in kinds.items() if any(t in name for t in tags)), "other")
        ms = event.self_device_time_total / 1e3 / iters
        by_kind[kind] += ms
        launches += event.count
        by_kernel[event.key[:80]] = by_kernel.get(event.key[:80], 0.0) + ms
    device_ms = sum(by_kind.values())
    measured = device_ms > 0
    host_ms = percentile(wall, 0.5)

    def device(value):
        return value if measured else "not measured"

    return {
        "host_ms_median": host_ms,
        "host_ms_mean": sum(wall) / iters,
        "device_ms": device(device_ms),
        "device_ms_by_kind": device(by_kind),
        "device_kernels_per_execution": device(launches / iters),
        "device_idle_share": device(1.0 - device_ms / host_ms),
        "bound_ms": bound_ms,
        "share_of_bound": device(bound_ms / device_ms if measured else 0.0),
        "top_kernels_ms": device(dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])),
    }


def profile_execution(model, config, rows: int = 16, length: int = 512) -> dict:
    """Where one ``text_encoder`` execution's time goes at ``rows`` x
    ``length``: host wall time of ``execute`` (its host read included)
    and, from ``torch.profiler``, device time by kind."""
    import numpy as np

    ids = np.random.default_rng(9).integers(1, config.vocab_size, [rows, length],
                                            dtype=np.int32)
    bound = bert_large_bound_ms(config, rows, length)
    result = {"rows": rows, "length": length, "tflop": bound["tflop"],
              "bound_by": bound["bound_by"],
              **profile_device(lambda: model.execute({"INPUT_IDS": ids}, {}),
                               {"matmul": ("gemm", "gemv", "cutlass", "nvjet", "xmma")},
                               bound["bound_ms"])}
    print("kserve execution: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def kserve_bert_large() -> dict:
    """Phase 6b: ``text_encoder`` at BERT-large's widths (24 layers, bf16,
    random weights from seed 0) behind the KServe v2 route: 128 binary
    requests from 16 client threads, lengths drawn from seed 0 in
    16-512; every answer held to the same model's unbatched forward on
    the card (max abs difference within 2 % of the answer's largest
    absolute value, no NaN)."""
    import numpy as np

    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import TextEncoderModel
    from client_tpu_torch.server.models import pad_batch_bucket

    config = bert.BertConfig()
    t0 = time.perf_counter()
    generator = torch.Generator(device=DEVICE).manual_seed(0)
    params = bert.init_params(generator, config, DEVICE)
    model = TextEncoderModel(config=config, params=params, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.warmup()
    # every (row bucket, length bucket) the run can meet, once
    rng_warm = np.random.default_rng(1)
    for length in (16, 32, 64, 128, 256, 512):
        for rows in (1, 2, 4, 8, 16):
            model.execute({"INPUT_IDS": rng_warm.integers(
                1, config.vocab_size, [rows, length], dtype=np.int32)}, {})
    warmup_s = time.perf_counter() - t0
    count = sum(t.numel() for t in [params["tok_emb"], params["pos_emb"]]) + sum(
        t.numel() for layer in params["layers"] for t in layer.values())
    print(f"kserve: text_encoder BERT-large ({count / 1e6:.1f} M parameters, bf16) loaded in "
          f"{load_s:.2f} s, warmed up in {warmup_s:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 513, KSERVE_REQUESTS)
    seqs = [rng.integers(1, config.vocab_size, n, dtype=np.int32) for n in lengths]
    with http_server(model) as port:
        before = _stats(port, "text_encoder")
        work = [lambda c, s=s: kserve_infer(c, "text_encoder", [("INPUT_IDS", "INT32", s[None])],
                                            outputs=("EMBEDDING",))["EMBEDDING"][0]
                for s in seqs]
        answers, latencies, wall = _concurrently(port, work, KSERVE_CLIENTS)
        after = _stats(port, "text_encoder")
    worst = 0.0
    with torch.inference_mode():
        for seq, got in zip(seqs, answers):
            want = bert.forward(params, torch.from_numpy(seq[None]).to(DEVICE),
                                config)[1][0].cpu().numpy()
            err = float(np.abs(got - want).max())
            tol = 2e-2 * float(np.abs(want).max())
            if not (np.isfinite(got).all() and err <= tol):
                raise AssertionError(f"BERT-large length {len(seq)}: {err} > {tol}")
            worst = max(worst, err / tol)
    requests = after["inference_count"] - before["inference_count"]
    executions = after["execution_count"] - before["execution_count"]
    if requests != KSERVE_REQUESTS or executions < 1:
        raise AssertionError(f"stats: {requests} requests in {executions} executions")
    stats = after["inference_stats"]
    result = {
        "model": f"text_encoder (d {config.d_model}, {config.n_layers} layers, "
                 f"{config.n_heads} heads, d_ff {config.d_ff}, {config.dtype})",
        "requests": KSERVE_REQUESTS,
        "clients": KSERVE_CLIENTS,
        "wall_s": wall,
        "requests_per_s": KSERVE_REQUESTS / wall,
        "sequences_per_s": KSERVE_REQUESTS / wall,
        "tokens_per_s": int(lengths.sum()) / wall,
        "latency_ms_p50": 1e3 * percentile(latencies, 0.5),
        "latency_ms_p99": 1e3 * percentile(latencies, 0.99),
        "executions": executions,
        "rows_per_execution": requests / executions,
        "queue_ms_mean": (stats["queue"]["ns"] - before["inference_stats"]["queue"]["ns"])
        / 1e6 / requests,
        "compute_infer_ms_mean_per_request": (stats["compute_infer"]["ns"]
                                              - before["inference_stats"]["compute_infer"]["ns"])
        / 1e6 / requests,
        "max_err_share_of_limit": worst,
        "length_buckets": sorted({min(pad_batch_bucket(int(n), 8), 512) for n in lengths}),
        "load_s": load_s,
        "warmup_s": warmup_s,
        "card": card(),
    }
    print("kserve: " + json.dumps(result), flush=True)
    result["profile"] = profile_execution(model, config)
    return result


# ---------------------------------------------------------------------------
# phase 7: the image classifier and the shared-memory data plane
# ---------------------------------------------------------------------------

IMAGE_REQUESTS = 128
IMAGE_CLIENTS = 8
DATA_PLANE_BYTES = 4 * 2**20
DATA_PLANE_REQUESTS = 64
DATA_PLANE_CLIENTS = 4


def shm_call(port, kind, action, name="", body=None):
    """A shared-memory route of ``kind`` (system, tpu or cuda): ``action``
    status, register or unregister, of one region (``name``) or all.
    Returns (HTTP status, parsed body or None)."""
    path = f"/v2/{kind}sharedmemory" + (f"/region/{name}" if name else "") + f"/{action}"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = json.dumps(body).encode() if body is not None else b""
        conn.request("GET" if action == "status" else "POST", path, body=data,
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        raw = response.read()
        return response.status, json.loads(raw) if raw else None
    finally:
        conn.close()


class ClientRegions:
    """One client's input and output regions of one kind (``system`` or
    ``tpu``), created with the port's client modules and registered with
    the server at ``port``; :meth:`close` unregisters and destroys them."""

    def __init__(self, port, kind, tag, in_bytes, out_bytes):
        import base64
        import os

        from client_tpu_torch.utils import shared_memory as shm
        from client_tpu_torch.utils import tpu_shared_memory as tpushm

        self.port, self.kind, self.handles = port, kind, {}
        self.module = shm if kind == "system" else tpushm
        for role, size in (("in", in_bytes), ("out", out_bytes)):
            name = f"chip_smoke_{os.getpid()}_{tag}_{role}"
            if kind == "system":
                handle = shm.create_shared_memory_region(name, name, size, create_only=True)
                body = {"key": name, "offset": 0, "byte_size": size}
            else:
                handle = tpushm.create_shared_memory_region(name, size)
                raw = base64.b64encode(tpushm.get_raw_handle(handle)).decode()
                body = {"raw_handle": {"b64": raw}, "device_id": 0, "byte_size": size}
            self.handles[role] = handle
            status, doc = shm_call(port, kind, "register", name, body)
            if status != 200:
                raise AssertionError(f"{kind} register {name}: HTTP {status} {doc}")

    def name(self, role):
        return self.handles[role].name()

    def write(self, array):
        """Copy ``array`` into the input region (the client's one copy)."""
        self.module.set_shared_memory_region(self.handles["in"], [array])

    def read(self, dtype, shape, offset=0):
        """A copy of the output region's bytes as an array."""
        return self.module.get_contents_as_numpy(self.handles["out"], dtype, shape,
                                                 offset).copy()

    def close(self):
        for handle in self.handles.values():
            shm_call(self.port, self.kind, "unregister", handle.name())
            self.module.destroy_shared_memory_region(handle)


def perturbed_classifier(config, generator, last_scale):
    """ResNet parameters from ``generator`` (on its device) with every norm
    perturbed: scale U(0.5, 1.5) (a block's last norm U(``last_scale``)),
    bias and running mean N(0, 0.1), running variance U(0.5, 1.5). The
    reference's default makes each block's last scale zero and every
    residual branch a no-op; this makes every branch count."""
    from client_tpu_torch.models import resnet

    params = resnet.init_params(generator, config, generator.device)
    norms = [(params["bn_init"], (0.5, 1.5))]
    for block in params["blocks"]:
        norms += [(block["norm0"], (0.5, 1.5)), (block["norm1"], (0.5, 1.5)),
                  (block["norm2"], last_scale)]
        if "norm_proj" in block:
            norms.append((block["norm_proj"], (0.5, 1.5)))
    for norm, (lo, hi) in norms:
        shape = norm["scale"].shape
        uniform = lambda a, b: torch.rand(shape, generator=generator,  # noqa: E731
                                          device=generator.device) * (b - a) + a
        norm["scale"] = uniform(lo, hi)
        norm["bias"] = 0.1 * torch.randn(shape, generator=generator, device=generator.device)
        norm["mean"] = 0.1 * torch.randn(shape, generator=generator, device=generator.device)
        norm["var"] = uniform(0.5, 1.5)
    return params


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def check_shm_routes(port) -> None:
    """Register, status and unregister for both kinds (idempotent
    re-registration, a conflicting one refused, a region of the other
    kind refused), and the ``cuda`` kind's empty status and refused
    registration."""
    import base64
    import os

    from client_tpu_torch.utils import shared_memory as shm
    from client_tpu_torch.utils import tpu_shared_memory as tpushm

    key = f"chip_smoke_{os.getpid()}_routes"
    sys_handle = shm.create_shared_memory_region(key, key, 256, create_only=True)
    tpu_handle = tpushm.create_shared_memory_region(key + "_tpu", 256)
    tpu_body = {"raw_handle": {"b64": base64.b64encode(tpushm.get_raw_handle(tpu_handle))
                               .decode()}, "device_id": 0, "byte_size": 256}
    try:
        expect = [
            (shm_call(port, "system", "register", "r_sys",
                      {"key": key, "offset": 0, "byte_size": 256}), 200),
            (shm_call(port, "system", "register", "r_sys",
                      {"key": key, "offset": 0, "byte_size": 256}), 200),  # idempotent
            (shm_call(port, "system", "register", "r_sys",
                      {"key": key, "offset": 0, "byte_size": 128}), 400),  # conflict
            (shm_call(port, "system", "register", "r_big",
                      {"key": key, "offset": 0, "byte_size": 512}), 400),  # past its end
            (shm_call(port, "tpu", "register", "r_tpu", tpu_body), 200),
            (shm_call(port, "cuda", "register", "r_cuda", tpu_body), 400),
            (shm_call(port, "tpu", "unregister", "r_sys"), 400),  # another kind
        ]
        for (status, doc), want in expect:
            if status != want:
                raise AssertionError(f"shm route answered {status} {doc}, expected {want}")
        refusal = shm_call(port, "cuda", "register", "r_cuda", tpu_body)[1]["error"]
        if "tpu" not in refusal.lower() or "system" not in refusal.lower():
            raise AssertionError(f"the cuda refusal does not point elsewhere: {refusal}")
        statuses = {kind: shm_call(port, kind, "status")[1]
                    for kind in ("system", "tpu", "cuda")}
        if ([r["name"] for r in statuses["system"]] != ["r_sys"]
                or statuses["system"][0]["byte_size"] != 256
                or [r["name"] for r in statuses["tpu"]] != ["r_tpu"]
                or statuses["tpu"][0]["key"] != tpu_handle.key()
                or statuses["cuda"] != []):
            raise AssertionError(f"shm status: {statuses}")
        if shm_call(port, "tpu", "status", "r_tpu")[1][0]["name"] != "r_tpu":
            raise AssertionError("region status of r_tpu")
        for kind, name in (("tpu", "r_tpu"), ("system", "never"), ("system", "")):
            if shm_call(port, kind, "unregister", name)[0] != 200:  # "": all of the kind
                raise AssertionError(f"unregister {kind} {name!r}")
        if shm_call(port, "system", "status")[1] or shm_call(port, "tpu", "status")[1]:
            raise AssertionError("regions left after unregister")
    finally:
        shm.destroy_shared_memory_region(sys_handle)
        tpushm.destroy_shared_memory_region(tpu_handle)


def classifier_tiny() -> None:
    """Phase 7a: a tiny fp32 classifier (stage_sizes (2, 1, 1, 1), 16
    filters, 64 x 64 images, every norm perturbed) and ``identity_fp32`` on
    the card. The logits within 1e-4 of the largest |logit| of the CPU
    forward on the same weights (TF32 is off: ``main`` switches it off for
    matmuls and cuDNN); one image over three routes (binary, system shm
    and TPU shm, input and output in regions) byte-identical; the top 3
    classes over shm equal to the logits' top 3; ``identity_fp32`` bit
    for bit through both kinds of region; the routes' register, status
    and unregister semantics."""
    import numpy as np

    from client_tpu_torch.models import resnet
    from client_tpu_torch.models.serving import ImageClassifierModel
    from client_tpu_torch.server import models
    from client_tpu_torch.utils import deserialize_bytes_tensor
    from client_tpu_torch.utils import tpu_shared_memory as tpushm

    config = resnet.ResNetConfig((2, 1, 1, 1), 1000, 16, torch.float32)
    size = 64
    cpu_params = perturbed_classifier(config, torch.Generator().manual_seed(5), (0.5, 1.5))
    image = np.random.default_rng(3).normal(size=[1, size, size, 3]).astype(np.float32)
    with torch.inference_mode():
        want = resnet.forward(cpu_params, torch.from_numpy(image), config).numpy()[0]
    served = [ImageClassifierModel(image_size=size, config=config,
                                   params=_to_device(cpu_params, DEVICE), device=DEVICE),
              models.IdentityModel("identity_fp32", "FP32", device=DEVICE)]
    logits_bytes = 4 * config.num_classes
    with http_server(*served) as port:
        check_shm_routes(port)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        answers = {"binary": kserve_infer(conn, "image_classifier", [("INPUT", "FP32", image)],
                                          outputs=("OUTPUT",))["OUTPUT"][0]}
        regions = {kind: ClientRegions(port, kind, f"tiny_{kind}", 1 << 20, 1 << 20)
                   for kind in ("system", "tpu")}
        try:
            for kind, region in regions.items():
                if kind == "tpu":  # staged from a tensor on the card
                    tpushm.set_shared_memory_region_from_torch(
                        region.handles["in"], [torch.from_numpy(image).to(DEVICE)])
                else:
                    region.write(image)
                shm_image = ("INPUT", "FP32", image, (region.name("in"), image.nbytes, 0))
                out = kserve_infer(conn, "image_classifier", [shm_image], outputs=[
                    ("OUTPUT", {"shared_memory_region": region.name("out"),
                                "shared_memory_byte_size": logits_bytes})])
                if out["OUTPUT"]["shared_memory_byte_size"] != logits_bytes:
                    raise AssertionError(f"{kind}: output parameters {out['OUTPUT']}")
                answers[kind] = region.read(np.float32, [config.num_classes])
                # class_count=3 into the region: BYTES "value:index" strings
                out = kserve_infer(conn, "image_classifier", [shm_image], outputs=[
                    ("OUTPUT", {"classification": 3,
                                "shared_memory_region": region.name("out"),
                                "shared_memory_byte_size": 1024,
                                "shared_memory_offset": 4096})])
                written = out["OUTPUT"]["shared_memory_byte_size"]
                raw = bytes(region.handles["out"].buf(4096, written))
                top = [s.decode().split(":") for s in deserialize_bytes_tensor(raw)]
                expect = np.argsort(answers[kind])[::-1][:3]
                if [int(i) for _, i in top] != list(expect) or any(
                        f"{answers[kind][int(i)]:f}" != v for v, i in top):
                    raise AssertionError(f"{kind} class_count=3 {top} vs top 3 {expect}")
                # identity_fp32 through the same regions, bit for bit
                values = np.random.default_rng(4).normal(size=[5000]).astype(np.float32)
                values[:3] = [np.inf, -0.0, np.nan]
                region.write(values)
                kserve_infer(conn, "identity_fp32",
                             [("INPUT0", "FP32", values, (region.name("in"), values.nbytes, 0))],
                             outputs=[("OUTPUT0", {"shared_memory_region": region.name("out"),
                                                   "shared_memory_byte_size": values.nbytes})])
                if region.read(np.float32, values.shape).tobytes() != values.tobytes():
                    raise AssertionError(f"identity_fp32 through {kind} shm is not bit-exact")
            # an output region smaller than the output is refused
            try:
                kserve_infer(conn, "identity_fp32", [("INPUT0", "FP32", values)],
                             outputs=[("OUTPUT0", {"shared_memory_region":
                                                   regions["system"].name("out"),
                                                   "shared_memory_byte_size": 16})])
                raise AssertionError("a too-small output region was accepted")
            except InferError as e:
                if e.status != 400 or b"too small" not in e.body:
                    raise
        finally:
            for region in regions.values():
                region.close()
            conn.close()
    if not (answers["binary"].tobytes() == answers["system"].tobytes()
            == answers["tpu"].tobytes()):
        raise AssertionError("binary, system shm and TPU shm answers differ")
    err = float(np.abs(answers["binary"] - want).max())
    limit = 1e-4 * float(np.abs(want).max())
    if not (np.isfinite(answers["binary"]).all() and err <= limit):
        raise AssertionError(f"tiny classifier on the card vs the CPU: {err} > {limit}")
    print(f"image tiny: fp32 (2,1,1,1)/16 classifier on the card within {err:.3g} of the CPU "
          f"forward (limit {limit:.3g}); binary, system shm and TPU shm answers byte-identical; "
          f"class_count=3 over shm = the logits' top 3; identity_fp32 bit-exact through both "
          f"region kinds; shm register/status/unregister and the cuda refusal as the JAX "
          f"server's", flush=True)


def resnet_flops(config, batch: int, size: int) -> dict:
    """Operations of one forward of ``batch`` images: each convolution's
    2·B·H_out·W_out·C_out·C_in·k² and the head's product; the bytes it must
    move: the weights (in ``config.dtype``), the images (fp32) and the
    logits."""
    flops, weights = 0, 0
    h = (size + 6 - 7) // 2 + 1  # the stem's explicit (3, 3) padding
    flops += 2 * batch * h * h * config.num_filters * 3 * 49
    weights += config.num_filters * 3 * 49
    h = -(-h // 2)  # the max pool
    for in_c, filters, stride in config.blocks():
        h_out = -(-h // stride)
        convs = [(in_c, filters, 1, h), (filters, filters, 3, h_out),
                 (filters, 4 * filters, 1, h_out)]
        if in_c != 4 * filters or stride != 1:
            convs.append((in_c, 4 * filters, 1, h_out))
        for cin, cout, k, hw in convs:
            flops += 2 * batch * hw * hw * cout * cin * k * k
            weights += cout * cin * k * k
        h = h_out
    width = 4 * config.blocks()[-1][1]
    head = 2 * batch * width * config.num_classes
    dtype_bytes = torch.tensor([], dtype=config.dtype).element_size()
    moved = (weights * dtype_bytes + 4 * (width + 1) * config.num_classes
             + 4 * batch * size * size * 3 + 4 * batch * config.num_classes)
    ops_ms = (flops + head) / bench.BF16_FLOPS * 1e3
    bytes_ms = moved / bench.HBM_BYTES_PER_S * 1e3
    return {"gflop": (flops + head) / 1e9, "conv_gflop": flops / 1e9,
            "bytes_moved": moved, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def profile_classifier(model, config, images) -> dict:
    """Where one ``image_classifier`` execution of ``len(images)`` images
    goes: host wall time of ``execute`` (its host-to-device copy and
    device-to-host read included) and, from ``torch.profiler``, device time
    by kind against the FLOP bound of the convolution shapes."""
    bound = resnet_flops(config, len(images), images.shape[1])
    kinds = {"conv": ("conv", "fprop", "implicit", "xmma", "cutlass", "gemm", "nvjet",
                      "wgrad", "dgrad"),
             "norm and elementwise": ("elementwise", "copy", "vectorized", "unrolled")}
    result = {"images": len(images), "gflop": bound["gflop"], "bound_by": bound["bound_by"],
              **profile_device(lambda: model.execute({"INPUT": images}, {}), kinds,
                               bound["bound_ms"])}
    print("image execution: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def serve_routes(port, model, routes, clients, requests, make_inputs, outputs, in_bytes,
                 out_bytes, check):
    """``requests`` requests from ``clients`` closed-loop client threads
    over each of ``routes`` (``none``: inline binary both ways; ``system``,
    ``tpu``: the input written into the client's own region and the
    output read back from its region). ``make_inputs(i)`` is request i's
    (name, datatype, array); ``check(i, route, answer)`` holds its
    answer. Returns {route: the run's numbers}."""
    results = {}
    for route in routes:
        regions = ([ClientRegions(port, route, f"{model}_{route}_{w}", in_bytes, out_bytes)
                    for w in range(clients)] if route != "none" else [])
        try:
            def work(conn, i):
                name, datatype, array = make_inputs(i)
                if route == "none":
                    out = kserve_infer(conn, model, [(name, datatype, array)],
                                       outputs=[o for o, _ in outputs])
                    return [out[o] for o, _ in outputs]
                region = regions[i % clients]
                region.write(array)
                kserve_infer(conn, model,
                             [(name, datatype, array, (region.name("in"), array.nbytes, 0))],
                             outputs=[(o, {"shared_memory_region": region.name("out"),
                                           "shared_memory_byte_size": out_bytes})
                                      for o, _ in outputs])
                return [region.read(dtype, shape) for _, (dtype, shape) in outputs]

            before = _stats(port, model)
            answers, latencies, wall = _concurrently(
                port, [lambda c, i=i: work(c, i) for i in range(requests)], clients)
            after = _stats(port, model)
        finally:
            for region in regions:
                region.close()
        for i, answer in enumerate(answers):
            check(i, route, answer)
        executions = after["execution_count"] - before["execution_count"]
        rows = after["inference_count"] - before["inference_count"]
        if rows != requests or executions < 1:
            raise AssertionError(f"{model} {route} stats: {rows} requests in {executions} "
                                 f"executions, not {requests}")
        results[route] = {
            "requests": requests, "clients": clients, "wall_s": wall,
            "requests_per_s": requests / wall,
            "latency_ms_p50": 1e3 * percentile(latencies, 0.5),
            "latency_ms_p99": 1e3 * percentile(latencies, 0.99),
            "executions": executions,
            "rows_per_execution": rows / executions,
            "queue_ms_mean": (after["inference_stats"]["queue"]["ns"]
                              - before["inference_stats"]["queue"]["ns"]) / 1e6 / requests,
            "compute_infer_ms_mean": (after["inference_stats"]["compute_infer"]["ns"]
                                      - before["inference_stats"]["compute_infer"]["ns"])
            / 1e6 / requests,
        }
    return results


def classifier_resnet50() -> dict:
    """Phase 7b: ``image_classifier`` at ResNet-50's widths (224 x 224,
    1000 classes, stage_sizes (3, 4, 6, 3), 64 filters, bf16; random
    weights from seed 0 with every norm perturbed, each block's last norm
    scale in U(0.1, 0.3)). 128 one-image requests (seed-0 noise per pixel
    and on a coarse grid) from 8 closed-loop
    client threads over loopback HTTP, three times: inline binary, system
    shm and TPU shm (input and output in the client's regions). Every
    answer within 2 % of the largest |logit| of that image's unbatched
    forward on the card, no NaN, while any two images' forwards differ by
    more than that limit; one 8-image execution profiled."""
    import numpy as np

    from client_tpu_torch.models import resnet
    from client_tpu_torch.models.serving import ImageClassifierModel

    config, size = resnet.resnet50(), 224
    t0 = time.perf_counter()
    params = perturbed_classifier(config, torch.Generator(device=DEVICE).manual_seed(0),
                                  (0.1, 0.3))
    model = ImageClassifierModel(image_size=size, config=config, params=params, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.warmup()
    for rows in (2, 4, 8):  # every batch bucket the run can meet, once
        model.execute({"INPUT": np.zeros([rows, size, size, 3], dtype=np.float32)}, {})
    warmup_s = time.perf_counter() - t0
    count = _parameter_count(params)
    print(f"image: image_classifier ResNet-50 ({count / 1e6:.1f} M parameters, bf16) loaded in "
          f"{load_s:.2f} s, warmed up in {warmup_s:.2f} s", flush=True)
    # per-pixel noise plus noise on a coarse 14 x 14 grid: global pooling
    # averages per-pixel noise away: white noise alone left the two closest
    # images' logits only 1.25 times the check's limit apart (NVIDIA H100
    # 80GB HBM3, 700 W), too near for the check to see a swapped answer
    rng = np.random.default_rng(0)
    coarse = rng.normal(size=[IMAGE_REQUESTS, 14, 14, 3])
    images = (np.repeat(np.repeat(coarse, size // 14, axis=1), size // 14, axis=2)
              + rng.normal(size=[IMAGE_REQUESTS, size, size, 3])).astype(np.float32)
    with torch.inference_mode():
        want = [resnet.forward(params, torch.from_numpy(image[None]).to(DEVICE),
                               config)[0].cpu().numpy() for image in images]
    # the check's fault side: another image's logits must miss an image's
    # limit, or a row swapped or shifted inside a batch would pass
    logits = np.stack(want)
    gaps = (np.abs(logits[:, None] - logits[None]).max(axis=2)
            / np.abs(logits).max(axis=1)[:, None])
    np.fill_diagonal(gaps, np.inf)
    distinct = float(gaps.min())
    if not distinct > 2e-2:
        raise AssertionError(f"two images' logits differ by only {distinct:.4f} of the larger "
                             f"|logit|: the 2 % check would not see a swapped answer")
    worst = [0.0]

    def check(i, route, answer):
        got = np.asarray(answer[0]).reshape(-1)
        err = float(np.abs(got - want[i]).max())
        tol = 2e-2 * float(np.abs(want[i]).max())
        if not (np.isfinite(got).all() and err <= tol):
            raise AssertionError(f"ResNet-50 {route} image {i}: {err} > {tol}")
        worst[0] = max(worst[0], err / tol)

    with http_server(model) as port:
        runs = serve_routes(
            port, "image_classifier", ("none", "system", "tpu"), IMAGE_CLIENTS,
            IMAGE_REQUESTS, lambda i: ("INPUT", "FP32", images[i:i + 1]),
            [("OUTPUT", (np.float32, [1, config.num_classes]))],
            images[0:1].nbytes, 4 * config.num_classes, check)
    for route, run in runs.items():
        run.update(route=route, images_per_s=run.pop("requests_per_s"))
        print("image: " + json.dumps(run) + f" [{card()}]", flush=True)
    result = {"runs": runs, "load_s": load_s, "warmup_s": warmup_s, "parameters": count,
              "max_err_share_of_limit": worst[0], "least_gap_share_of_limit": distinct / 2e-2}
    print(f"image: every answer of the three runs within {worst[0]:.3f} of its 2 % limit of "
          f"the unbatched forward, none NaN; the closest two images' logits differ by "
          f"{distinct / 2e-2:.3f} times that limit", flush=True)
    result["profile"] = profile_classifier(model, config, images[:8])
    return result


def _parameter_count(params) -> int:
    """Learned parameters (the norms' scale and bias, not their running
    statistics)."""
    count = 0

    def walk(tree):
        nonlocal count
        if isinstance(tree, dict):
            for key, value in tree.items():
                if key not in ("mean", "var"):
                    walk(value)
        elif isinstance(tree, list):
            for value in tree:
                walk(value)
        else:
            count += tree.numel()

    walk(params)
    return count


def data_plane() -> dict:
    """Phase 7c: ``identity_fp32`` at 4 MiB a request, 4 closed-loop
    clients, 64 requests, once inline (binary both ways), once through
    system shm and once through TPU shm; every answer bit-exact."""
    import numpy as np

    from client_tpu_torch.server import models

    count = DATA_PLANE_BYTES // 4
    base = np.random.default_rng(8).normal(size=[count]).astype(np.float32)

    def make(i):
        return "INPUT0", "FP32", base + np.float32(i)

    def check(i, route, answer):
        if answer[0].tobytes() != (base + np.float32(i)).tobytes():
            raise AssertionError(f"identity_fp32 {route} request {i} is not bit-exact")

    with http_server(models.IdentityModel("identity_fp32", "FP32", device=DEVICE)) as port:
        runs = serve_routes(port, "identity_fp32", ("none", "system", "tpu"),
                            DATA_PLANE_CLIENTS, DATA_PLANE_REQUESTS, make,
                            [("OUTPUT0", (np.float32, [count]))], DATA_PLANE_BYTES,
                            DATA_PLANE_BYTES, check)
    for route, run in runs.items():
        run.update(route=route, payload_mib_per_s=run["requests_per_s"] * DATA_PLANE_BYTES
                   / 2**20)
        print("data plane: " + json.dumps(run) + f" [{card()}]", flush=True)
    return runs


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card()}", flush=True)
    build()
    fp32_err = max(check_fp32(), check_edges())
    k1 = measure_kernel()
    check_verify_fp32()
    check_edges(rows=5)
    k2 = measure_kernel(rows=bench.VERIFY_ROWS)
    check_tiny_engine()
    check_tiny_engine_speculation()
    served, params, plain_streams = serve_7b()
    served_spec = serve_7b_speculative(params, plain_streams)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    kserve_tiny()
    kserve_bert_large()
    classifier_tiny()
    classifier_resnet50()
    data_plane()
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
                "serve_ms": k1["serve_ms"],
                "serve_bound_ms": k1["serve_bound_ms"],
                "serve_library_ms": k1["serve_library_ms"],
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
                "serve_ms": k2["serve_ms"],
                "serve_bound_ms": k2["serve_bound_ms"],
                "serve_library_ms": k2["serve_library_ms"],
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

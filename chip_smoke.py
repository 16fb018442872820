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
   dynamic batcher, sent, as in phases 7 and 8, by the port's own client
   (``client_tpu_torch.http``; client threads here, one client each): (a) ``simple``, the identities and a tiny fp32
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
8. the port's HTTP client (``client_tpu_torch.http``, sync and aio) and
   its slot ring (``ShmRing``) from client processes of their own
   (``multiprocessing`` spawn; they never touch the card): (a) one
   process checks health, metadata, config, statistics, region routes,
   ``simple`` and the identities over JSON, binary, system shm, TPU shm
   and the ring, the tiny fp32 classifier through the ring against its
   CPU forward, refused ring requests, the OpenAI error body and a
   chunked request body, and ``infer_decoupled`` of ``simple`` runs here
   (``client tiny:``); (b) phase 7b's 128 images from 8 processes over
   inline binary, system shm, TPU shm and the ring, each answer held as
   7b holds them (``image-procs:``, beside 7b's in-process figures); (c)
   ``identity_fp32`` from 4 processes at 256 KiB and 4 MiB over the four
   routes, 64 requests each, bit-exact (``data-plane-procs:``).
9. the port's perf harness and genai-perf (``python -m
   client_tpu_torch.perf`` / ``client_tpu_torch.genai_perf``), each run a
   subprocess that cannot see the card, with three 2 s windows (4 s for
   9d) and its own guards: no error, every completed request booked by
   the server's statistics, non-zero server queue and compute times, no
   region left registered. They run on the servers they measure, inside
   the phases that hold them: (a) on 7b's ResNet-50, ``-b 4
   --concurrency-range 8`` over none, system and TPU shm and the same
   profiler in-process on the server's ``ServerCore``, with the north-star
   ratio HTTP + TPU shm to in-process (``perf 9a:``); (b) Poisson arrivals
   over TPU shm at half of a closed ``-b 1`` run's rate (``perf 9b:``);
   (c) on 6b's BERT-large, ``--concurrency-range 4:16:12`` over 6b's
   first 16 requests (``perf 9c:``); (d) on phase 4's Llama-7B,
   genai-perf over the OpenAI route, 8 streams of 32 tokens, every
   request's token events equal to its ``max_tokens``, K1 launches >= 32
   x decode steps (``perf 9d (genai-perf):``).
10. the remaining built-ins, ``llm_decode`` and the server's
   observability surface, each inside the phase that holds its server:
   (a) ``repeat_int32``, ``sequence_accumulate`` and ``add_sub_chain`` on
   the card (``builtins 10a:``): the ensemble exactly ``2 * INPUT0`` and
   ``2 * INPUT1`` at batch 1 and from 8 client threads, the sequence
   model under the port's harness in sequence mode and by hand across
   the int32 wrap, ``repeat_int32`` streamed through
   ``ServerCore.infer_decoupled`` with ``delay_us`` and refused by
   ``/infer``; (b) after phase 5, ``llm_decode`` on phase 4's Llama-7B
   weights through the OpenAI route's default model, two prompts of 32
   tokens in turn and then at once, each stream equal to
   ``llama.generate`` (``llm_decode 10b:``, TTFT and ITL); (c)
   ``/metrics``: on 9d's server, ``tpu_llm_step_batch_size`` counts the
   engine's steps and ``tpu_llm_generated_tokens_total`` at least the
   tokens genai-perf counted; on 7b's, 9a's TPU-shm run again with
   ``--collect-metrics`` (its report's server-metrics section printed),
   the duration histogram's ``_count`` equal to the statistics'
   ``success.count``, device memory in (0, the card], the duty cycle in
   (0, 1] (``metrics 10c``); (d) 7b's ResNet-50 served from a spawned
   process of its own, a ``-b 1`` c=8 TPU-shm load with
   ``--profile-server`` and, under it, ``/v2/debug/profile`` for 2 s with a
   ``torch.profiler`` Chrome trace: the stage CPU table, the
   five stacks with the most samples, the busy samples by thread, the
   trace's CUDA kernel events (there must be some), the flight
   recorder's slowest requests and five-stamp trace records at
   ``trace_rate`` 1 (``profile 10d:``).

The last two lines are the card's name and power limit and the result
object; the line before them lists every kernel with its numbers.
"""

import contextlib
import faulthandler
import gc
import http.client
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import uuid

import torch

# phase 8's client processes are spawned from this file, which they import
# as __mp_main__: they speak HTTP and shared memory and never ask for the card
if __name__ != "__mp_main__" and not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

import attention_bench as bench  # noqa: E402
import client_tpu_torch.http as client_http  # noqa: E402
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


def _stream_one(port: int, prompt: str, max_tokens: int, record: dict,
                model: str = "llm_engine") -> None:
    """One streaming chat completion for ``model`` (None: the route's
    default model) into ``record``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        doc = {"stream": True, "max_tokens": max_tokens,
               "messages": [{"role": "user", "content": prompt}]}
        if model is not None:
            doc["model"] = model
        body = json.dumps(doc)
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


# port -> (ServerCore, its event loop) of each server http_server runs;
# phase 9a drives the same core in-process
SERVING = {}


@contextlib.contextmanager
def http_server(*models, builtins: bool = False):
    """``ServerCore`` + the HTTP front-end on a loopback port serving
    ``models`` (loaded here; with ``builtins``, the built-in models on the
    card too); yields the port, and stops the server, the engine and the
    event loop on the way out."""
    import asyncio

    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.http_server import serve_http
    from client_tpu_torch.server.model_repository import ModelRepository
    from client_tpu_torch.server.models import register_builtin_models

    repository = ModelRepository()
    if builtins:
        register_builtin_models(repository, device=DEVICE)
    for model in models:
        repository.add_model(model)
    torch.cuda.synchronize()
    for entry in repository.index():
        if entry["state"] != "READY":
            raise AssertionError(f"{entry['name']} did not load: {entry['reason']}")
    core = ServerCore(repository, max_workers=4, device=DEVICE)
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
        SERVING[box["server"].port] = (core, loop)
        yield box["server"].port
    finally:
        if "server" in box:
            SERVING.pop(box["server"].port, None)
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
        served_by_harness = genai_perf_7b(port, engine, config.n_layers)

    result = latency(records, wall)
    result.update(decode_steps=decode_steps, k1_launches=launches,
                  prefix_blocks_shared=prefix_hits)
    print("serve: " + json.dumps(result) + f" [{card()}]", flush=True)
    result["genai_perf"] = served_by_harness
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


def _shm_key(tag):
    """A shared-memory key (and region name) of this process's own:
    ``/dev/shm`` is shared by every run on the machine, and a run killed
    midway leaves its keys behind."""
    return f"chip_smoke_{os.getpid()}_{uuid.uuid4().hex[:8]}_{tag}"


class _ClientRoute:
    """One client's way to send a model tensors and get its outputs back,
    all through ``client_tpu_torch.http``: JSON (``json``; BF16 stays
    binary, as it has no JSON form), inline binary (``none``), its own
    input and output regions of ``in_bytes`` and ``out_bytes`` (``system``,
    ``tpu``), or its own one-slot ring (``ring``); :meth:`close`
    unregisters and destroys what it made."""

    def __init__(self, client, route, tag="", in_bytes=0, out_bytes=0):
        from client_tpu_torch.utils import shared_memory as shm
        from client_tpu_torch.utils import tpu_shared_memory as tpushm
        from client_tpu_torch.utils.tpu_shared_memory.ring import ShmRing

        self.client, self.route, self.regions, self.ring = client, route, [], None
        self.module = shm if route == "system" else tpushm
        if route == "ring":
            self.ring = ShmRing(n_slots=1, slot_size=in_bytes + out_bytes + 4096,
                                name=_shm_key(f"{tag}_ring"))
            self.ring.register(client)
        elif route in ("system", "tpu"):
            for role, size in (("in", in_bytes), ("out", out_bytes)):
                name = _shm_key(f"{tag}_{role}")
                if route == "system":
                    region = shm.create_shared_memory_region(name, name, size, create_only=True)
                    client.register_system_shared_memory(name, name, size)
                else:
                    region = tpushm.create_shared_memory_region(name, size)
                    client.register_tpu_shared_memory(name, tpushm.get_raw_handle(region), 0,
                                                      size)
                self.regions.append(region)

    def infer(self, model, inputs, outputs):
        """``inputs``: (name, datatype, array); ``outputs``: (name, dtype,
        shape), the dtype and shape read only from a region. Returns
        {output name: array}."""
        import numpy as np

        if self.ring is not None:
            return self.ring.infer(self.client, model,
                                   [(name, array) for name, _, array in inputs])
        tensors = [client_http.InferInput(name, list(a.shape), dt) for name, dt, a in inputs]
        if not self.regions:
            binary = self.route != "json"
            for tensor, (_, datatype, array) in zip(tensors, inputs):
                tensor.set_data_from_numpy(array, binary_data=binary or datatype == "BF16")
            result = self.client.infer(model, tensors, outputs=[
                client_http.InferRequestedOutput(name, binary_data=binary)
                for name, _, _ in outputs])
            return {name: result.as_numpy(name) for name, _, _ in outputs}
        self.module.set_shared_memory_region(self.regions[0], [a for _, _, a in inputs])
        offset = 0
        for tensor, (_, _, array) in zip(tensors, inputs):
            tensor.set_shared_memory(self.regions[0].name(), array.nbytes, offset)
            offset += array.nbytes
        sizes = [int(np.prod(shape)) * np.dtype(dtype).itemsize for _, dtype, shape in outputs]
        requested, offset = [], 0
        for (name, _, _), size in zip(outputs, sizes):
            requested.append(client_http.InferRequestedOutput(name).set_shared_memory(
                self.regions[1].name(), size, offset))
            offset += size
        self.client.infer(model, tensors, outputs=requested)
        answers, offset = {}, 0
        for (name, dtype, shape), size in zip(outputs, sizes):
            answers[name] = self.module.get_contents_as_numpy(
                self.regions[1], np.dtype(dtype), shape, offset).copy()
            offset += size
        return answers

    def close(self):
        if self.ring is not None:
            self.client.unregister_tpu_shared_memory(self.ring.region_name)
            self.ring.close()
        for region in self.regions:
            getattr(self.client, f"unregister_{self.route}_shared_memory")(region.name())
            self.module.destroy_shared_memory_region(region)


def _stats(port, model):
    """``model``'s entry of the statistics route."""
    with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
        return client.get_inference_statistics(model)["model_stats"][0]


def _concurrently(port, threads, open_way, work):
    """Run ``work[i](way)`` for i in range(len(work)) on ``threads``
    closed-loop client threads, each with a ``client_tpu_torch.http``
    client of its own and the :class:`_ClientRoute` that
    ``open_way(client, thread)`` made before the threads are released
    together. Returns the results, each call's latency in seconds and the
    seconds from the release to the last answer."""
    n = len(work)
    results, latencies, errors = [None] * n, [None] * n, []
    barrier = threading.Barrier(threads + 1)

    def client(worker):
        try:
            with client_http.InferenceServerClient(f"127.0.0.1:{port}",
                                                   network_timeout=600) as conn:
                way = open_way(conn, worker)
                try:
                    barrier.wait(300)
                    for i in range(worker, n, threads):
                        t0 = time.perf_counter()
                        results[i] = work[i](way)
                        latencies[i] = time.perf_counter() - t0
                finally:
                    way.close()
        except Exception as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)
            barrier.abort()  # no thread waits for this one any longer

    pool = [threading.Thread(target=client, args=(w,)) for w in range(threads)]
    for thread in pool:
        thread.start()
    try:
        barrier.wait(300)
    except threading.BrokenBarrierError:
        pass  # a thread failed: its error is in ``errors``
    t_start = time.perf_counter()
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
    with (http_server(*served) as port,
          client_http.InferenceServerClient(f"127.0.0.1:{port}") as client):
        a = rng.integers(-2**20, 2**20, [5, 16], dtype=np.int32)
        b = rng.integers(-2**20, 2**20, [5, 16], dtype=np.int32)
        fp32 = rng.normal(size=[33]).astype(np.float32)
        bf16 = utils.deserialize_bf16_tensor(
            utils.serialize_bf16_tensor(rng.normal(size=[64]).astype(np.float32)))
        strings = np.array([b"alpha", b"", "été".encode()], dtype=object)
        for route in ("json", "none"):
            way = _ClientRoute(client, route)
            out = way.infer("simple", [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)],
                            [("OUTPUT0", None, None), ("OUTPUT1", None, None)])
            if not (np.array_equal(out["OUTPUT0"], a + b) and np.array_equal(out["OUTPUT1"], a - b)):
                raise AssertionError(f"simple ({route}) is not a+b, a-b")
            for model, datatype, array in (("identity_fp32", "FP32", fp32),
                                           ("identity_bf16", "BF16", bf16),
                                           ("identity_bytes", "BYTES", strings)):
                got = way.infer(model, [("INPUT0", datatype, array)],
                                [("OUTPUT0", None, None)])["OUTPUT0"]
                same = (list(got) == list(array) if datatype == "BYTES"
                        else got.tobytes() == array.tobytes())
                if not same:
                    raise AssertionError(f"{model} ({route}) did not round-trip")

        lengths = rng.integers(3, 201, 16)
        seqs = [rng.integers(1, config.vocab_size, n, dtype=np.int32) for n in lengths]
        before = _stats(port, "text_encoder")
        work = [lambda way, s=s: way.infer("text_encoder", [("INPUT_IDS", "INT32", s[None])],
                                           [("EMBEDDING", None, None)])["EMBEDDING"][0]
                for s in seqs]
        answers, _, _ = _concurrently(port, 16, lambda c, w: _ClientRoute(c, "none"), work)
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
        work = [lambda way, s=s: way.infer("text_encoder", [("INPUT_IDS", "INT32", s[None])],
                                           [("EMBEDDING", None, None)])["EMBEDDING"][0]
                for s in seqs]
        answers, latencies, wall = _concurrently(port, KSERVE_CLIENTS,
                                                 lambda c, w: _ClientRoute(c, "none"), work)
        after = _stats(port, "text_encoder")
        swept = perf_bert(port, seqs[:16])
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
    result["perf_9c"] = swept
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


def check_shm_routes(client) -> None:
    """Register, status and unregister for both kinds (idempotent
    re-registration, a conflicting one refused, a region of the other
    kind refused), and the ``cuda`` kind's empty status and refused
    registration, through the port's client."""
    from client_tpu_torch.utils import InferenceServerException
    from client_tpu_torch.utils import shared_memory as shm
    from client_tpu_torch.utils import tpu_shared_memory as tpushm

    def answer(call, *args):
        """(HTTP status, error message) of one client call."""
        try:
            call(*args)
            return 200, ""
        except InferenceServerException as e:
            return int(e.status()), e.message()

    key = _shm_key("routes")
    sys_handle = shm.create_shared_memory_region(key, key, 256, create_only=True)
    tpu_handle = tpushm.create_shared_memory_region(key + "_tpu", 256)
    raw = tpushm.get_raw_handle(tpu_handle)
    try:
        expect = [
            (answer(client.register_system_shared_memory, "r_sys", key, 256), 200),
            (answer(client.register_system_shared_memory, "r_sys", key, 256), 200),  # idempotent
            (answer(client.register_system_shared_memory, "r_sys", key, 128), 400),  # conflict
            (answer(client.register_system_shared_memory, "r_big", key, 512), 400),  # past its end
            (answer(client.register_tpu_shared_memory, "r_tpu", raw, 0, 256), 200),
            (answer(client.register_cuda_shared_memory, "r_cuda", raw, 0, 256), 400),
            (answer(client.unregister_tpu_shared_memory, "r_sys"), 400),  # another kind
        ]
        for (status, message), want in expect:
            if status != want:
                raise AssertionError(f"shm route answered {status} {message}, expected {want}")
        refusal = answer(client.register_cuda_shared_memory, "r_cuda", raw, 0, 256)[1]
        if "tpu" not in refusal.lower() or "system" not in refusal.lower():
            raise AssertionError(f"the cuda refusal does not point elsewhere: {refusal}")
        statuses = {kind: getattr(client, f"get_{kind}_shared_memory_status")()
                    for kind in ("system", "tpu", "cuda")}
        if ([r["name"] for r in statuses["system"]] != ["r_sys"]
                or statuses["system"][0]["byte_size"] != 256
                or [r["name"] for r in statuses["tpu"]] != ["r_tpu"]
                or statuses["tpu"][0]["key"] != tpu_handle.key()
                or statuses["cuda"] != []):
            raise AssertionError(f"shm status: {statuses}")
        if client.get_tpu_shared_memory_status("r_tpu")[0]["name"] != "r_tpu":
            raise AssertionError("region status of r_tpu")
        for kind, name in (("tpu", "r_tpu"), ("system", "never"), ("system", "")):
            status = answer(getattr(client, f"unregister_{kind}_shared_memory"), name)
            if status[0] != 200:  # "": all of the kind
                raise AssertionError(f"unregister {kind} {name!r}: {status}")
        if client.get_system_shared_memory_status() or client.get_tpu_shared_memory_status():
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
    from client_tpu_torch.utils import InferenceServerException, deserialize_bytes_tensor
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
    with (http_server(*served) as port,
          client_http.InferenceServerClient(f"127.0.0.1:{port}") as client):
        check_shm_routes(client)
        answers = {"binary": _ClientRoute(client, "none").infer(
            "image_classifier", [("INPUT", "FP32", image)], [("OUTPUT", None, None)])
            ["OUTPUT"][0]}
        ways = {kind: _ClientRoute(client, kind, f"tiny_{kind}", 1 << 20, 1 << 20)
                for kind in ("system", "tpu")}

        def infer(model, name, array, way, *outputs):
            """``array`` read from ``way``'s input region; ``outputs`` are
            requested outputs. Returns the result."""
            tensor = client_http.InferInput(name, list(array.shape), "FP32")
            tensor.set_shared_memory(way.regions[0].name(), array.nbytes, 0)
            return client.infer(model, [tensor], outputs=list(outputs))

        try:
            for kind, way in ways.items():
                region_in, region_out = way.regions
                if kind == "tpu":  # staged from a tensor on the card
                    tpushm.set_shared_memory_region_from_torch(
                        region_in, [torch.from_numpy(image).to(DEVICE)])
                else:
                    way.module.set_shared_memory_region(region_in, [image])
                out = infer("image_classifier", "INPUT", image, way,
                            client_http.InferRequestedOutput("OUTPUT").set_shared_memory(
                                region_out.name(), logits_bytes))
                written = out.get_output("OUTPUT")["parameters"]["shared_memory_byte_size"]
                if written != logits_bytes:
                    raise AssertionError(f"{kind}: output parameters {out.get_output('OUTPUT')}")
                answers[kind] = way.module.get_contents_as_numpy(
                    region_out, np.float32, [config.num_classes]).copy()
                # class_count=3 into the region: BYTES "value:index" strings
                out = infer("image_classifier", "INPUT", image, way,
                            client_http.InferRequestedOutput("OUTPUT", class_count=3)
                            .set_shared_memory(region_out.name(), 1024, 4096))
                written = out.get_output("OUTPUT")["parameters"]["shared_memory_byte_size"]
                raw = bytes(region_out.buf(4096, written))
                top = [s.decode().split(":") for s in deserialize_bytes_tensor(raw)]
                expect = np.argsort(answers[kind])[::-1][:3]
                if [int(i) for _, i in top] != list(expect) or any(
                        f"{answers[kind][int(i)]:f}" != v for v, i in top):
                    raise AssertionError(f"{kind} class_count=3 {top} vs top 3 {expect}")
                # identity_fp32 through the same regions, bit for bit
                values = np.random.default_rng(4).normal(size=[5000]).astype(np.float32)
                values[:3] = [np.inf, -0.0, np.nan]
                got = way.infer("identity_fp32", [("INPUT0", "FP32", values)],
                                [("OUTPUT0", np.float32, values.shape)])["OUTPUT0"]
                if got.tobytes() != values.tobytes():
                    raise AssertionError(f"identity_fp32 through {kind} shm is not bit-exact")
            # an output region smaller than the output is refused
            tensor = client_http.InferInput("INPUT0", list(values.shape), "FP32")
            try:
                client.infer("identity_fp32", [tensor.set_data_from_numpy(values)], outputs=[
                    client_http.InferRequestedOutput("OUTPUT0").set_shared_memory(
                        ways["system"].regions[1].name(), 16)])
                raise AssertionError("a too-small output region was accepted")
            except InferenceServerException as e:
                if e.status() != "400" or "too small" not in e.message():
                    raise
        finally:
            for way in ways.values():
                way.close()
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
    output read back from its region), each through the port's client.
    ``make_inputs(i)`` is request i's (name, datatype, array); ``outputs``
    are (name, dtype, shape); ``check(i, route, answer)`` holds its
    answer. Returns {route: the run's numbers}."""
    results = {}
    for route in routes:
        def work(way, i):
            out = way.infer(model, [make_inputs(i)], outputs)
            return [out[name] for name, _, _ in outputs]

        before = _stats(port, model)
        answers, latencies, wall = _concurrently(
            port, clients,
            lambda c, w: _ClientRoute(c, route, f"{model}_{route}_{w}", in_bytes, out_bytes),
            [lambda way, i=i: work(way, i) for i in range(requests)])
        after = _stats(port, model)
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
            [("OUTPUT", np.float32, [1, config.num_classes])],
            images[0:1].nbytes, 4 * config.num_classes, check)
        for route, run in runs.items():
            run.update(route=route, images_per_s=run.pop("requests_per_s"))
            print("image: " + json.dumps(run) + f" [{card()}]", flush=True)
        procs = image_procs(port, images, check, runs)
        harness = perf_image(port)
        metrics_10c = image_metrics(port)
    result = {"runs": runs, "procs": procs, "perf_9ab": harness, "metrics_10c": metrics_10c,
              "load_s": load_s, "warmup_s": warmup_s,
              "parameters": count, "max_err_share_of_limit": worst[0],
              "least_gap_share_of_limit": distinct / 2e-2}
    print(f"image: every answer of the three in-process runs and of phase 8b's four within "
          f"{worst[0]:.3f} of its 2 % limit of the unbatched forward, none NaN; the closest "
          f"two images' logits differ by {distinct / 2e-2:.3f} times that limit", flush=True)
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
                            [("OUTPUT0", np.float32, [count])], DATA_PLANE_BYTES,
                            DATA_PLANE_BYTES, check)
    for route, run in runs.items():
        run.update(route=route, payload_mib_per_s=run["requests_per_s"] * DATA_PLANE_BYTES
                   / 2**20)
        print("data plane: " + json.dumps(run) + f" [{card()}]", flush=True)
    return runs



# ---------------------------------------------------------------------------
# phase 8: the port's client, from separate client processes
# ---------------------------------------------------------------------------

PROC_CLIENTS = 8
DATA_PLANE_PROC_CLIENTS = 4
DATA_PLANE_PROC_SIZES = (256 * 2**10, 4 * 2**20)


def _client_main(task, args, barrier, results):
    """A spawned client process: runs ``CLIENT_TASKS[task]`` and puts
    (worker, result, error) on ``results``, once a task or once a route.
    It imports torch for the client's dtype tables and never asks for the
    card: it speaks HTTP and shared memory only."""
    import traceback

    worker = args.get("worker", 0)
    try:
        for result in CLIENT_TASKS[task](barrier=barrier, **args):
            results.put((worker, result, None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        results.put((worker, None, traceback.format_exc()))
        barrier.abort()  # no process waits for this one any longer


def _load_task(barrier, url, worker, routes, images=None, seed=0):
    """Closed-loop load from one client process: per (route, request
    indices, bytes) of ``routes``, set up, wait for every process at
    ``barrier``, send the requests one after another and yield their
    latencies. With ``images`` ({index: [1, H, W, 3] image}) the model is
    ``image_classifier`` and the logits go back; otherwise it is
    ``identity_fp32`` on seed-``seed`` values, and the indices whose
    answer is not bit for bit what was sent go back."""
    import numpy as np

    with client_http.InferenceServerClient(url, network_timeout=600) as client:
        for route, indices, size in routes:
            if images is not None:
                model, outputs = "image_classifier", [("OUTPUT", np.float32, [1, 1000])]
                in_bytes, out_bytes = next(iter(images.values())).nbytes, 4 * 1000
            else:
                model, outputs = "identity_fp32", [("OUTPUT0", np.float32, [size // 4])]
                in_bytes = out_bytes = size
                base = np.random.default_rng(seed).normal(size=[size // 4]).astype(np.float32)
            way = _ClientRoute(client, route, f"{route}_{size}", in_bytes, out_bytes)
            try:
                barrier.wait(300)
                latencies, answers, wrong = [], [], []
                for i in indices:
                    sent = images[i] if images is not None else base + np.float32(i)
                    t0 = time.perf_counter()
                    out = way.infer(model, [(("INPUT" if images is not None else "INPUT0"),
                                             "FP32", sent)], outputs)[outputs[0][0]]
                    latencies.append(time.perf_counter() - t0)
                    if images is not None:
                        answers.append(out)
                    elif out.tobytes() != sent.tobytes():
                        wrong.append(i)
            finally:
                way.close()
            yield {"route": route, "indices": list(indices), "latencies": latencies,
                   "answers": answers, "wrong": wrong}


def _raw_exchange(url, head, body):
    """(status, body) of one request written as bytes to a fresh socket."""
    import socket

    host, port = url.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(head + body)
        received = b""
        while data := sock.recv(1 << 16):
            received += data
    split = received.index(b"\r\n\r\n")
    return int(received.split(b" ", 2)[1]), received[split + 4:]


def _correctness_task(barrier, url, image):
    """Phase 8a in a client process: the port's sync and aio clients
    against the port's server on the card."""
    import asyncio

    import numpy as np

    from client_tpu_torch import utils
    from client_tpu_torch.http import aio
    from client_tpu_torch.utils.tpu_shared_memory.ring import ShmRing

    rng = np.random.default_rng(0)
    a = rng.integers(-2**20, 2**20, [3, 16], dtype=np.int32)
    b = rng.integers(-2**20, 2**20, [3, 16], dtype=np.int32)
    fp32 = rng.normal(size=[5000]).astype(np.float32)
    fp32[:3] = [np.inf, -0.0, np.nan]
    bf16 = utils.deserialize_bf16_tensor(utils.serialize_bf16_tensor(
        rng.normal(size=[64]).astype(np.float32)))
    strings = np.array([b"alpha", b"", "\xe9t\xe9".encode()], dtype=object)
    cases = [("simple", [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)],
              {"OUTPUT0": a + b, "OUTPUT1": a - b}),
             ("identity_fp32", [("INPUT0", "FP32", fp32)], {"OUTPUT0": fp32}),
             ("identity_bf16", [("INPUT0", "BF16", bf16)], {"OUTPUT0": bf16}),
             ("identity_bytes", [("INPUT0", "BYTES", strings)], {"OUTPUT0": strings})]
    checked = []
    barrier.wait(300)
    with client_http.InferenceServerClient(url) as client:
        meta = client.get_server_metadata()
        if not (client.is_server_live() and client.is_server_ready()
                and client.is_model_ready("simple") and "tpu_shared_memory" in meta["extensions"]
                and [i["name"] for i in client.get_model_metadata("simple")["inputs"]]
                == ["INPUT0", "INPUT1"]
                and client.get_model_config("simple")["max_batch_size"] == 64):
            raise AssertionError(f"health, metadata or config: {meta}")
        before = client.get_inference_statistics("simple")["model_stats"][0]["inference_count"]
        for model, inputs, want in cases:
            outputs = [(name, arr.dtype, list(arr.shape)) for name, arr in want.items()]
            for route in ("json", "none", "system", "tpu", "ring"):
                if (route == "json" and model == "identity_bf16") or (
                        model == "identity_bytes" and route in ("system", "tpu")):
                    continue  # BF16 has no JSON form; a BYTES size is the data's own
                size = sum(x.nbytes for _, _, x in inputs) + 4096
                way = _ClientRoute(client, route, f"8a_{model}_{route}", size, size)
                try:
                    got = way.infer(model, inputs, outputs)
                finally:
                    way.close()
                for name, arr in want.items():
                    same = (list(got[name].reshape(-1)) == list(arr.reshape(-1))
                            if arr.dtype == object else got[name].tobytes() == arr.tobytes())
                    if not same:
                        raise AssertionError(f"8a {model} over {route}: {name} differs")
                checked.append(f"{model}/{route}")
        after = client.get_inference_statistics("simple")["model_stats"][0]["inference_count"]
        if after - before != 3 * 5:
            raise AssertionError(f"simple stats counted {after - before} rows, not 15")
        # region routes: register, status, unregister for both kinds
        for kind in ("system", "tpu"):
            way = _ClientRoute(client, kind, f"8a_status_{kind}", 64, 64)
            status = getattr(client, f"get_{kind}_shared_memory_status")()
            names = sorted(r["name"] for r in status)
            way.close()
            if names != sorted(r.name() for r in way.regions) or getattr(
                    client, f"get_{kind}_shared_memory_status")():
                raise AssertionError(f"{kind} region status {status}")
        # the tiny classifier through a ring: its logits go back for the check
        ring = ShmRing(n_slots=1, slot_size=image.nbytes + 4 * 1000 + 4096,
                       name=_shm_key("8a_classifier"))
        ring.register(client)
        try:
            logits = ring.infer(client, "image_classifier", [("INPUT", image)])["OUTPUT"]
        finally:
            client.unregister_tpu_shared_memory(ring.region_name)
            ring.close()
        # a stale ring slot is refused and the region gone says so
        ring = ShmRing(n_slots=1, slot_size=1024, name=_shm_key("8a_stale"))
        ring.register(client)
        try:
            ticket = ring.stage([("INPUT0", a[:1]), ("INPUT1", b[:1])])
            try:
                client.infer("simple", [], parameters=dict(ticket.parameters,
                                                           shm_ring_seq=ticket.seq + 1))
                raise AssertionError("a stale ring slot was served")
            except utils.InferenceServerException as e:
                if e.status() != "400" or "stale or torn" not in e.message():
                    raise
            ring.release(ticket)
            client.unregister_tpu_shared_memory(ring.region_name)
            try:
                ring.infer(client, "simple", [("INPUT0", a[:1]), ("INPUT1", b[:1])])
                raise AssertionError("a ring request to an unregistered region was served")
            except utils.InferenceServerException as e:
                if e.status() != "400" or "unavailable" not in e.message():
                    raise
        finally:
            ring.close()

    async def aio_ring():
        ring = ShmRing(n_slots=8, slot_size=2048, name=_shm_key("8a_aio"))
        async with aio.InferenceServerClient(url) as client:
            await ring.aregister(client)
            try:
                outs = await asyncio.gather(*(ring.ainfer(
                    client, "simple", [("INPUT0", a[:1] + k), ("INPUT1", b[:1])])
                    for k in range(8)))
                tensors = [aio.InferInput(n, [3, 16], "INT32").set_data_from_numpy(x)
                           for n, x in (("INPUT0", a), ("INPUT1", b))]
                inline = await client.infer("simple", tensors)
            finally:
                await client.unregister_tpu_shared_memory(ring.region_name)
                ring.close()
        for k, out in enumerate(outs):
            if not np.array_equal(out["OUTPUT0"], a[:1] + k + b[:1]):
                raise AssertionError(f"aio ring request {k} is not its own a+b")
        if not np.array_equal(inline.as_numpy("OUTPUT1"), a - b):
            raise AssertionError("aio inline simple is not a-b")

    asyncio.run(aio_ring())
    # fault 1: the OpenAI route's error body; fault 3: a chunked body
    body = json.dumps({"model": "simple", "messages": [{"content": "hi"}]}).encode()
    status, answer = _raw_exchange(url, b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                                   b"Connection: close\r\nContent-Length: %d\r\n\r\n"
                                   % len(body), body)
    if status != 400 or json.loads(answer) != {"error": {"message": (
            "unexpected inference input 'INPUT_IDS' for model 'simple'")}}:
        raise AssertionError(f"OpenAI error body: {status} {answer!r}")
    header = json.dumps({"inputs": [{"name": "INPUT0", "shape": [5000], "datatype": "FP32",
                                     "parameters": {"binary_data_size": fp32.nbytes}}],
                         "outputs": [{"name": "OUTPUT0",
                                      "parameters": {"binary_data": True}}]}).encode()
    payload = header + fp32.tobytes()
    common = (b"POST /v2/models/identity_fp32/infer HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
              b"Inference-Header-Content-Length: %d\r\n" % len(header))
    sized = _raw_exchange(url, common + b"Content-Length: %d\r\n\r\n" % len(payload), payload)
    chunks = b"".join(b"%x\r\n%s\r\n" % (len(payload[i:i + 7000]), payload[i:i + 7000])
                      for i in range(0, len(payload), 7000)) + b"0\r\n\r\n"
    chunked = _raw_exchange(url, common + b"Transfer-Encoding: chunked\r\n\r\n", chunks)
    if not (sized[0] == chunked[0] == 200 and sized[1] == chunked[1]
            and sized[1].endswith(fp32.tobytes())):
        raise AssertionError("a chunked body did not answer as its Content-Length twin")
    yield {"checked": checked, "classifier": logits}


CLIENT_TASKS = {"load": _load_task, "correctness": _correctness_task}


def run_client_processes(task, arglist, on_round, rounds=1):
    """Start one spawned client process per entry of ``arglist`` running
    ``task``; for each of ``rounds`` rounds call ``on_round(go)`` where
    ``go()`` releases the processes (all set up) and returns their results
    and the seconds from release to the last result. Fails if a process
    fails; stops and joins every process."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(len(arglist) + 1)
    results = ctx.Queue()
    procs = [ctx.Process(target=_client_main, args=(task, args, barrier, results), daemon=True)
             for args in arglist]
    for proc in procs:
        proc.start()
    try:
        for _ in range(rounds):
            def go():
                try:
                    barrier.wait(300)
                except threading.BrokenBarrierError:
                    pass  # a process failed: its error is on the queue
                t0 = time.perf_counter()
                got = []
                while len(got) < len(procs):
                    worker, result, error = results.get(timeout=300)
                    if error is not None:
                        raise AssertionError(f"client process {worker} failed:\n{error}")
                    got.append(result)
                return got, time.perf_counter() - t0

            on_round(go)
    except BaseException:
        barrier.abort()
        raise
    finally:
        for proc in procs:
            proc.join(60)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
        results.close()
    if any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"client exit codes {[p.exitcode for p in procs]}")


def client_correctness() -> None:
    """Phase 8a: the built-ins and a tiny fp32 classifier on the card,
    driven by the port's sync and aio clients from one client process:
    health, metadata, config, statistics; region register, status and
    unregister; ``simple`` exact and the identities bit for bit over
    JSON, binary, system shm, TPU shm and the ring; the classifier through
    the ring within phase 7a's bound of its CPU forward; a stale ring slot
    and an unregistered ring refused; the OpenAI error body; a chunked
    request body; and, in this process, ``infer_decoupled`` giving a
    non-decoupled model's one response."""
    import asyncio

    import numpy as np

    from client_tpu_torch.models import resnet
    from client_tpu_torch.models.serving import ImageClassifierModel
    from client_tpu_torch.server import models
    from client_tpu_torch.server.core import CoreRequest, CoreTensor, ServerCore
    from client_tpu_torch.server.model_repository import ModelRepository

    config = resnet.ResNetConfig((2, 1, 1, 1), 1000, 16, torch.float32)
    size = 64
    cpu_params = perturbed_classifier(config, torch.Generator().manual_seed(5), (0.5, 1.5))
    image = np.random.default_rng(6).normal(size=[1, size, size, 3]).astype(np.float32)
    with torch.inference_mode():
        want = resnet.forward(cpu_params, torch.from_numpy(image), config).numpy()
    served = [models.AddSubModel(device=DEVICE),
              models.IdentityModel("identity_fp32", "FP32", device=DEVICE),
              models.IdentityModel("identity_bf16", "BF16", device=DEVICE),
              models.BytesIdentityModel(device=DEVICE),
              ImageClassifierModel(image_size=size, config=config,
                                   params=_to_device(cpu_params, DEVICE), device=DEVICE)]
    box = {}
    with http_server(*served) as port:
        def collect(go):
            box["result"] = go()[0][0]

        run_client_processes("correctness", [{"url": f"127.0.0.1:{port}", "image": image}],
                             collect)
    result = box["result"]
    err = float(np.abs(result["classifier"] - want).max())
    limit = 1e-4 * float(np.abs(want).max())
    if not (np.isfinite(result["classifier"]).all() and err <= limit):
        raise AssertionError(f"8a classifier through the ring: {err} > {limit}")
    # fault 2: a non-decoupled model streams exactly its one response
    repository = ModelRepository()
    repository.add_model(models.AddSubModel(device=DEVICE))
    core = ServerCore(repository)
    a = np.arange(16, dtype=np.int32).reshape(1, 16)

    async def stream():
        request = CoreRequest("simple", inputs=[CoreTensor(n, "INT32", [1, 16], a)
                                                for n in ("INPUT0", "INPUT1")])
        return [r async for r in core.infer_decoupled(request)]

    try:
        responses = asyncio.run(stream())
        stats = core.statistics("simple")["model_stats"][0]
    finally:
        core.close()
    if not (len(responses) == 1 and np.array_equal(responses[0].outputs[0].data, 2 * a)
            and stats["inference_count"] == 1 and stats["execution_count"] == 1):
        raise AssertionError(f"infer_decoupled of simple: {responses}, {stats}")
    print(f"client tiny: from a client process, the port's sync and aio clients: health, "
          f"metadata, config, stats, system/TPU region register/status/unregister; "
          f"{len(result['checked'])} model x route answers exact ({', '.join(result['checked'])}); "
          f"tiny fp32 classifier through the ring within {err:.3g} of the CPU forward (limit "
          f"{limit:.3g}); stale slot and unregistered ring refused (400); OpenAI error body "
          f"as the JAX server's; chunked body = its Content-Length twin; infer_decoupled of "
          f"simple: one response", flush=True)


def _load_round(port, model):
    """``on_round`` for :func:`run_client_processes`: one route's run, with
    the model's statistics before and after. Returns (round callback,
    list the runs land in)."""
    runs = []

    def on_round(go):
        before = _stats(port, model)
        got, wall = go()
        after = _stats(port, model)
        runs.append((got, wall, before, after))

    return on_round, runs


def _summarize(got, wall, before, after, requests):
    latencies = [x for r in got for x in r["latencies"]]
    rows = after["inference_count"] - before["inference_count"]
    executions = after["execution_count"] - before["execution_count"]
    if len(latencies) != requests or rows != requests or executions < 1:
        raise AssertionError(f"{len(latencies)} answers, {rows} rows in {executions} "
                             f"executions, not {requests}")
    return {
        "requests": requests, "wall_s": wall, "requests_per_s": requests / wall,
        "latency_ms_p50": 1e3 * percentile(latencies, 0.5),
        "latency_ms_p99": 1e3 * percentile(latencies, 0.99),
        "executions": executions, "rows_per_execution": rows / executions,
        "compute_infer_ms_mean": (after["inference_stats"]["compute_infer"]["ns"]
                                  - before["inference_stats"]["compute_infer"]["ns"])
        / 1e6 / requests,
    }


IMAGE_PROC_ROUTES = ("none", "system", "tpu", "ring")


def image_procs(port, images, check, in_process) -> dict:
    """Phase 8b: phase 7b's 128 one-image requests from 8 client
    processes (16 each, closed loop) over inline binary, system shm, TPU
    shm and the ring, each answer held by ``check``; an ``image-procs:``
    line per route beside 7b's in-process figures of the same route."""
    import numpy as np

    per = IMAGE_REQUESTS // PROC_CLIENTS
    arglist = [{"url": f"127.0.0.1:{port}", "worker": w,
                "routes": [(r, range(w * per, (w + 1) * per), 0) for r in IMAGE_PROC_ROUTES],
                "images": {i: images[i:i + 1] for i in range(w * per, (w + 1) * per)}}
               for w in range(PROC_CLIENTS)]
    on_round, runs = _load_round(port, "image_classifier")
    run_client_processes("load", arglist, on_round, rounds=len(IMAGE_PROC_ROUTES))
    results = {}
    for route, (got, wall, before, after) in zip(IMAGE_PROC_ROUTES, runs):
        for r in got:
            for i, answer in zip(r["indices"], r["answers"]):
                check(i, f"{route} (client processes)", [np.asarray(answer)])
        run = _summarize(got, wall, before, after, IMAGE_REQUESTS)
        run.update(route=route, clients=f"{PROC_CLIENTS} processes",
                   images_per_s=run.pop("requests_per_s"))
        twin = in_process.get(route)
        run["in_process_7b"] = None if twin is None else {
            k: twin[k] for k in ("images_per_s", "latency_ms_p50", "latency_ms_p99",
                                 "rows_per_execution", "compute_infer_ms_mean")}
        print("image-procs: " + json.dumps(run) + f" [{card()}]", flush=True)
        results[route] = run
    return results


def data_plane_procs() -> dict:
    """Phase 8c: ``identity_fp32`` from 4 client processes (16 requests
    each, closed loop) at 256 KiB (the reference's ring crossover row,
    ring slot 2 x size + 4096) and 4 MiB (phase 7c's row), per route (none,
    system shm, TPU shm, ring); every answer bit-exact to what its
    process sent. The reference's rows run over gRPC; the port has no gRPC
    front-end yet, so these run over HTTP."""
    from client_tpu_torch.server import models

    per = DATA_PLANE_REQUESTS // DATA_PLANE_PROC_CLIENTS
    combos = [(route, size) for size in DATA_PLANE_PROC_SIZES for route in IMAGE_PROC_ROUTES]
    results = {}
    with http_server(models.IdentityModel("identity_fp32", "FP32", device=DEVICE)) as port:
        arglist = [{"url": f"127.0.0.1:{port}", "worker": w, "seed": 8,
                    "routes": [(r, range(w * per, (w + 1) * per), s) for r, s in combos]}
                   for w in range(DATA_PLANE_PROC_CLIENTS)]
        on_round, runs = _load_round(port, "identity_fp32")
        run_client_processes("load", arglist, on_round, rounds=len(combos))
    for (route, size), (got, wall, before, after) in zip(combos, runs):
        wrong = [i for r in got for i in r["wrong"]]
        if wrong:
            raise AssertionError(f"identity_fp32 {route} {size} B requests {wrong} not bit-exact")
        run = _summarize(got, wall, before, after, DATA_PLANE_REQUESTS)
        run.update(route=route, bytes_per_request=size,
                   clients=f"{DATA_PLANE_PROC_CLIENTS} processes",
                   payload_mib_per_s=run["requests_per_s"] * size / 2**20,
                   transport="HTTP/1.1 (the reference's row runs over gRPC, not ported yet)")
        print("data-plane-procs: " + json.dumps(run) + f" [{card()}]", flush=True)
        results[(route, size)] = run
    return results


# ---------------------------------------------------------------------------
# phase 9: the port's perf harness and genai-perf, in subprocesses
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# short windows: three of 2 s, stable within 50 %
HARNESS_WINDOWS = ["--measurement-interval", "2000", "--max-trials", "3",
                   "--stability-percentage", "50"]


def _harness(module, args) -> str:
    """``python -m module args`` in a subprocess that cannot see the card
    (``CUDA_VISIBLE_DEVICES`` empty): the harness speaks HTTP and shared
    memory only. A non-zero exit fails the run. Returns its stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


def _no_regions(port) -> None:
    with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
        left = (client.get_system_shared_memory_status(),
                client.get_tpu_shared_memory_status())
    if any(left):
        raise AssertionError(f"regions left registered after a harness run: {left}")


def _booked(before, after, field="success"):
    return (after["inference_stats"][field]["count"]
            - before["inference_stats"][field]["count"])


def perf_run(port, model, args, server_times=True) -> dict:
    """One run of the port's perf-analyzer against ``model`` with ``args``:
    its ``--json-summary``, CSV rows and profile export, held to the
    guards (no error, every completed request booked by the server,
    non-zero server queue and compute times in every row, unless
    ``server_times`` is off, no region left registered). The harness's
    stdout is kept under ``stdout``."""
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, export_path = os.path.join(tmp, "out.csv"), os.path.join(tmp, "export.json")
        before = _stats(port, model)
        t0 = time.perf_counter()
        out = _harness("client_tpu_torch.perf", [
            "-m", model, "-u", f"127.0.0.1:{port}", *HARNESS_WINDOWS, *args,
            "-f", csv_path, "--profile-export-file", export_path, "--json-summary"])
        wall = time.perf_counter() - t0
        after = _stats(port, model)
        summary = json.loads(out.strip().splitlines()[-1])
        with open(csv_path) as f:
            header, *lines = [line.split(",") for line in f.read().strip().splitlines()]
        rows = [dict(zip(header, line)) for line in lines]
        with open(export_path) as f:
            requests = [r for e in json.load(f)["experiments"] for r in e["requests"]]
    _no_regions(port)
    failed = [r for r in requests if not r["success"]]
    if summary["errors"] or failed or not requests:
        raise AssertionError(f"{model} {args}: {summary['errors']} errors, {len(failed)} "
                             f"failed of {len(requests)} exported requests")
    if _booked(before, after) < len(requests):
        raise AssertionError(f"{model} {args}: the server booked {_booked(before, after)} "
                             f"successes for {len(requests)} completed requests")
    for row in rows:
        if server_times and not (float(row["Server Queue"]) > 0
                                 and float(row["Server Compute Infer"]) > 0):
            raise AssertionError(f"{model} {args}: server times missing from {row}")
    executions = after["execution_count"] - before["execution_count"]
    return {
        "infer_per_s": summary["throughput"],
        "p50_ms": summary["p50_us"] / 1e3,
        "p99_ms": summary["p99_us"] / 1e3,
        "points": [{key: float(row[key]) for key in (
            header[0], "Inferences/Second", "p99 latency", "Server Queue",
            "Server Compute Infer")} for row in rows],
        "server_queue_us": float(rows[-1]["Server Queue"]),
        "server_compute_infer_us": float(rows[-1]["Server Compute Infer"]),
        "rows_per_execution": (after["inference_count"] - before["inference_count"])
        / max(1, executions),
        "completed": len(requests),
        "wall_s": wall,
        "summary": summary,
        "stdout": out,
    }


def local_twin(port, model, batch, concurrency) -> dict:
    """The same profiler in-process: ``LocalPerfBackend`` on the server's
    own ``ServerCore``, on its event loop (the in-process twin of the
    reference's ``bench.py`` north-star row)."""
    import asyncio

    from client_tpu_torch.perf.backend import LocalPerfBackend
    from client_tpu_torch.perf.data import DataLoader
    from client_tpu_torch.perf.load_manager import ConcurrencyManager
    from client_tpu_torch.perf.profiler import InferenceProfiler

    core, loop = SERVING[port]

    async def run():
        local = LocalPerfBackend(core)
        config = await local.get_model_config(model)
        loader = DataLoader(await local.get_model_metadata(model), batch_size=batch,
                            batched=config["max_batch_size"] > 0)
        loader.generate_synthetic()
        manager = ConcurrencyManager(local, model, loader)
        profiler = InferenceProfiler(manager, measurement_interval_s=2.0, stability_pct=50.0,
                                     max_trials=3)
        (experiment,) = await profiler.profile_concurrency_range(concurrency, concurrency)
        return experiment

    experiment = asyncio.run_coroutine_threadsafe(run(), loop).result(600)
    s = experiment.status
    if s.error_count or not s.request_count or not (s.server_queue_us > 0
                                                     and s.server_compute_infer_us > 0):
        raise AssertionError(f"in-process twin: {s.error_count} errors, {s.request_count} "
                             f"requests, server {s.server_queue_us} / "
                             f"{s.server_compute_infer_us} us")
    return {"infer_per_s": s.throughput, "p50_ms": s.latency_percentiles_us[50] / 1e3,
            "p99_ms": s.latency_percentiles_us[99] / 1e3,
            "server_queue_us": s.server_queue_us,
            "server_compute_infer_us": s.server_compute_infer_us}


def perf_image(port) -> dict:
    """Phases 9a-9b on phase 7b's ResNet-50 server. 9a, the north-star
    row: ``-b 4 --concurrency-range 8`` over ``--shared-memory none``,
    ``system`` and ``tpu``, and the same profiler in-process; the ratio of
    HTTP + TPU shm to in-process is reported (BASELINE.json's target is
    0.9), not gated. 9b, open load: Poisson arrivals at half the infer/s
    of a ``-b 1 --concurrency-range 8`` TPU-shm run made just before."""
    t0 = time.perf_counter()
    rows = {}
    for route in ("none", "system", "tpu"):
        rows[route] = perf_run(port, "image_classifier",
                               ["-b", "4", "--concurrency-range", "8", "--shared-memory", route])
        for key in ("summary", "stdout"):
            rows[route].pop(key)
    rows["in-process"] = local_twin(port, "image_classifier", 4, 8)
    for route, row in rows.items():
        row.update(route=route, images_per_s=4 * row["infer_per_s"])
        print("perf 9a: " + json.dumps(row) + f" [{card()}]", flush=True)
    north_star = rows["tpu"]["infer_per_s"] / rows["in-process"]["infer_per_s"]
    print(f"perf 9a: HTTP + TPU shm / in-process = {north_star:.3f} (BASELINE.json's target "
          f"0.9, reported, not gated) [{card()}]", flush=True)
    closed = perf_run(port, "image_classifier",
                      ["-b", "1", "--concurrency-range", "8", "--shared-memory", "tpu"])
    target = closed["infer_per_s"] / 2
    opened = perf_run(port, "image_classifier",
                      ["-b", "1", "--request-rate-range", f"{target:.3f}",
                       "--request-distribution", "poisson", "--shared-memory", "tpu"])
    for run in (closed, opened):
        for key in ("summary", "stdout"):
            run.pop(key)
    result = {"closed_c8": closed, "open": opened, "target_per_s": target,
              "achieved_per_s": opened["infer_per_s"],
              "achieved_share": opened["infer_per_s"] / target}
    print("perf 9b: " + json.dumps(result) + f" [{card()}]", flush=True)
    wall = time.perf_counter() - t0
    print(f"perf 9a-9b: {wall:.1f} s", flush=True)
    return {"rows": rows, "north_star_ratio": north_star, "open": result, "wall_s": wall}


def perf_bert(port, seqs) -> dict:
    """Phase 9c on phase 6b's BERT-large server: BASELINE.json's sweep,
    ``--concurrency-range 4:16:12`` over an ``--input-data`` file of
    phase 6b's first 16 requests."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.json")
        with open(path, "w") as f:
            json.dump({"data": [{"INPUT_IDS": {"content": s.tolist(), "shape": [1, len(s)]}}
                                for s in seqs]}, f)
        result = perf_run(port, "text_encoder",
                          ["--concurrency-range", "4:16:12", "--input-data", path])
    result["lengths"] = [len(s) for s in seqs]
    result["phase_wall_s"] = time.perf_counter() - t0
    print("perf 9c: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def genai_perf_7b(port, engine, n_layers) -> dict:
    """Phase 9d on phase 4's Llama-7B server: genai-perf over the OpenAI
    route, 8 concurrent streams, 16 prompts of 250 ± 50 synthetic words
    (one token each on both sides), 32 output tokens. Every request's
    token events equal its ``max_tokens`` and every stream ends in
    ``[DONE]`` (the harness fails a stream without it); K1 launches are
    counted as phase 4 counts them."""
    t0 = time.perf_counter()
    before = _stats(port, "llm_engine")
    scraped = _scrape(port)
    steps0 = engine.steps
    with tempfile.TemporaryDirectory() as tmp:
        # -- counters zeroed just before, read just after --
        pa.paged_attention_cuda.launches = 0
        out = _harness("client_tpu_torch.genai_perf", [
            "-m", "llm_engine", "-u", f"127.0.0.1:{port}", "--service-kind", "openai",
            "--endpoint-type", "openai-chat", "--streaming", "--tokenizer", "synthetic",
            "--concurrency", "8", "--num-prompts", "16",
            "--synthetic-input-tokens-mean", "250", "--synthetic-input-tokens-stddev", "50",
            "--output-tokens-mean", str(SERVE_TOKENS), "--measurement-interval", "4000",
            "--stability-percentage", "50", "--max-trials", "3", "--artifact-dir", tmp,
            "--json-summary"])
        launches = pa.paged_attention_cuda.launches
        # --------------------------------------------------
        decode_steps = engine.steps - steps0
        with open(os.path.join(tmp, "profile_export.json")) as f:
            requests = json.load(f)["experiments"][0]["requests"]
        with open(os.path.join(tmp, "llm_inputs.json")) as f:
            asked = {json.loads(e["payload"]["content"][0])["max_tokens"]
                     for e in json.load(f)["data"]}
    summary = next(json.loads(line) for line in reversed(out.splitlines())
                   if line.startswith("{") and "ttft_avg_ms" in line)
    after = _stats(port, "llm_engine")
    if asked != {SERVE_TOKENS}:
        raise AssertionError(f"the corpus asked for max_tokens {asked}")
    wrong = [len(r["response_timestamps"]) for r in requests
             if not r["success"] or len(r["response_timestamps"]) != SERVE_TOKENS]
    if wrong or not requests:
        raise AssertionError(f"genai-perf: {len(wrong)} of {len(requests)} requests failed or "
                             f"streamed other than {SERVE_TOKENS} tokens: {wrong[:8]}")
    if _booked(before, after) < len(requests):
        raise AssertionError(f"the server booked {_booked(before, after)} streams for "
                             f"{len(requests)} completed requests")
    if not 0 < n_layers * decode_steps <= launches:
        raise AssertionError(f"K1 launched {launches} times for {decode_steps} decode steps "
                             f"x {n_layers} layers")
    # streams the harness cut at its end finish on the server; none may leak
    deadline = time.monotonic() + 120
    while engine.allocator.blocks_in_use and time.monotonic() < deadline:
        time.sleep(0.1)
    if engine.allocator.blocks_in_use:
        raise AssertionError(f"{engine.allocator.blocks_in_use} KV blocks leaked after 9d")
    result = dict(summary, completed=len(requests), decode_steps=decode_steps,
                  k1_launches=launches, wall_s=time.perf_counter() - t0)
    print("perf 9d (genai-perf): " + json.dumps(result) + f" [{card()}]", flush=True)
    # phase 10c over 9d: the engine's families against its own counters
    # (every stream finished, so statistics, engine and scrape agree)
    tokens_counted = sum(len(r["response_timestamps"]) for r in requests)
    llm = llm_metrics_guards(port, scraped, before, engine.steps - steps0, tokens_counted)
    result["metrics_10c"] = llm
    return result


# ---------------------------------------------------------------------------
# phase 10: the remaining built-ins, llm_decode and the observability surface
# ---------------------------------------------------------------------------


def _scrape(port) -> dict:
    """The server's ``/metrics``, parsed (the port's own parser)."""
    from client_tpu_torch.observability.metrics import parse_exposition

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        response = conn.getresponse()
        body = response.read().decode()
    finally:
        conn.close()
    if response.status != 200:
        raise AssertionError(f"/metrics answered {response.status}: {body[:200]}")
    return parse_exposition(body)


def _http(port, path, method="GET", doc=None):
    """(status, headers, body text) of one request to the server, with
    ``doc`` as its JSON body."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps(doc).encode() if doc is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body else {})
        response = conn.getresponse()
        payload = response.read()
    finally:
        conn.close()
    text = payload.decode(errors="replace")
    return response.status, dict(response.getheaders()), text


def _hist_count(families, name, model) -> float:
    from client_tpu_torch.observability.metrics import histogram_totals

    return histogram_totals(families.get(name), {"model": model})["count"]


def _counter(families, name, model) -> float:
    from client_tpu_torch.observability.metrics import counter_total

    return counter_total(families.get(name), {"model": model})


def _duration_count_guard(model, scraped, after_scraped, before, after) -> int:
    """Per model: the duration histogram's ``_count`` delta equals the
    statistics route's ``success.count`` delta. Returns the delta."""
    counted = _hist_count(after_scraped, "tpu_inference_request_duration", model) - \
        _hist_count(scraped, "tpu_inference_request_duration", model)
    booked = _booked(before, after)
    if counted != booked:
        raise AssertionError(f"{model}: tpu_inference_request_duration _count moved "
                             f"{counted}, the statistics' success.count {booked}")
    return booked


def llm_metrics_guards(port, scraped, before, steps, tokens_counted) -> dict:
    """Phase 10c over 9d: ``tpu_llm_step_batch_size`` counts the engine's
    steps, ``tpu_llm_generated_tokens_total`` at least the tokens
    genai-perf counted, and the duration histogram the booked streams."""
    after_scraped = _scrape(port)
    after = _stats(port, "llm_engine")
    streams = _duration_count_guard("llm_engine", scraped, after_scraped, before, after)
    step_count = (_hist_count(after_scraped, "tpu_llm_step_batch_size", "llm_engine")
                  - _hist_count(scraped, "tpu_llm_step_batch_size", "llm_engine"))
    tokens = (_counter(after_scraped, "tpu_llm_generated_tokens_total", "llm_engine")
              - _counter(scraped, "tpu_llm_generated_tokens_total", "llm_engine"))
    if step_count != steps:
        raise AssertionError(f"tpu_llm_step_batch_size counted {step_count} steps, the "
                             f"engine {steps}")
    if not tokens >= tokens_counted > 0:
        raise AssertionError(f"tpu_llm_generated_tokens_total moved {tokens}, genai-perf "
                             f"counted {tokens_counted} tokens")
    result = {"streams_booked": streams, "steps": steps, "step_batch_count": step_count,
              "generated_tokens": tokens, "tokens_counted_by_genai_perf": tokens_counted}
    print("metrics 10c (9d): " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def image_metrics(port) -> dict:
    """Phase 10c: 9a's TPU-shm run again with ``--collect-metrics``
    (scrapes every 0.5 s: the flag is in seconds in both packages) and
    ``/metrics`` scraped around it. Guards: the duration histogram's
    ``_count`` delta equals ``success.count``'s; device memory above 0 and
    within the card; the duty cycle in (0, 1], from the harness's report
    and from the busy-ns counter over the run."""
    from client_tpu_torch.observability.metrics import gauge_values

    before, scraped, t0 = _stats(port, "image_classifier"), _scrape(port), time.monotonic()
    run = perf_run(port, "image_classifier",
                   ["-b", "4", "--concurrency-range", "8", "--shared-memory", "tpu",
                    "--collect-metrics", "--metrics-interval", "0.5"])
    after, after_scraped, t1 = _stats(port, "image_classifier"), _scrape(port), time.monotonic()
    booked = _duration_count_guard("image_classifier", scraped, after_scraped, before, after)
    memory = gauge_values(after_scraped.get("tpu_device_memory_bytes"))
    _free, total = torch.cuda.mem_get_info()
    if not (memory and 0 < max(memory) <= total):
        raise AssertionError(f"tpu_device_memory_bytes {memory} outside (0, {total}]")
    busy = (sum(gauge_values(after_scraped["tpu_device_compute_ns_total"]))
            - sum(gauge_values(scraped["tpu_device_compute_ns_total"])))
    duty = busy / ((t1 - t0) * 1e9)
    summary = run["summary"]
    for name, value in (("busy-ns duty over the run", duty),
                        ("harness duty avg", summary["server_duty_avg"]),
                        ("harness duty max", summary["server_duty_max"])):
        if not 0 < value <= 1:
            raise AssertionError(f"{name} {value} outside (0, 1]")
    section = run["stdout"].split("Server metrics (", 1)
    if len(section) != 2:
        raise AssertionError("the harness printed no Server metrics section")
    report = ("Server metrics (" + section[1]).split("\n\n", 1)[0]
    print("metrics 10c: the harness's report, ResNet-50 -b 4 c=8 TPU shm:\n" + report
          + f"\n[{card()}]", flush=True)
    result = {"infer_per_s": run["infer_per_s"], "duty_avg": summary["server_duty_avg"],
              "duty_max": summary["server_duty_max"],
              "batch_avg": summary["server_batch_avg"], "busy_ns_duty": duty,
              "device_memory_bytes": max(memory), "card_total_bytes": total,
              "requests_booked": booked}
    print("metrics 10c: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


# the leaf frames of a parked thread in the wall sampler's stacks
IDLE_LEAVES = ("threading.py:wait", "queue.py:get", "selectors.py:select",
               "socket.py:readinto", "thread.py:_worker",
               "threading.py:_wait_for_tstate_lock")


def _profile_child(conn) -> None:
    """The server process of phase 10d (``multiprocessing`` spawn)."""
    faulthandler.enable()
    try:
        import numpy as np

        from client_tpu_torch.models import resnet
        from client_tpu_torch.models.serving import ImageClassifierModel

        config, size = resnet.resnet50(), 224
        params = perturbed_classifier(config, torch.Generator(device=DEVICE).manual_seed(0),
                                      (0.1, 0.3))
        model = ImageClassifierModel(image_size=size, config=config, params=params,
                                     device=DEVICE)
        model.warmup()
        images = np.random.default_rng(0).normal(size=[4, size, size, 3]).astype(np.float32)
        with http_server(model) as port:
            conn.send(("ok", thread_profile(port, images)))
    except BaseException as e:  # noqa: BLE001 - reported to, and raised by, the parent
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


def server_thread_profile() -> dict:
    """Phase 10d in a server process of its own: phase 7b's ResNet-50
    (the same seed-0 weights) behind ``http_server`` in a spawned process
    that holds nothing else, as a deployed server would. (In this
    process, after phases 2-9 and their own ``torch.profiler`` sessions,
    the route's capture crashed the process twice, NVIDIA H100 80GB HBM3,
    700 W; see PERF.md.)"""
    import multiprocessing

    context = multiprocessing.get_context("spawn")
    parent, child = context.Pipe(duplex=False)
    proc = context.Process(target=_profile_child, args=(child,))
    proc.start()
    child.close()
    try:
        if not parent.poll(900):
            raise AssertionError("the 10d server process gave no answer in 900 s")
        try:
            status, payload = parent.recv()
        except EOFError:
            status, payload = "error", "the process ended without an answer"
    finally:
        proc.join(120)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if status != "ok" or proc.exitcode != 0:
        raise AssertionError(f"10d server process (exit {proc.exitcode}): {payload}")
    return payload


def thread_profile(port, images) -> dict:
    """Phase 10d, the server's threads under load: a 9a-shaped ResNet-50
    run (``-b 1``, c=8, TPU shm, three 2 s windows) with
    ``--profile-server``; once the load is on, ``/v2/debug/profile`` for
    2 s with a ``torch.profiler`` Chrome trace under the temp directory.
    Prints the stage CPU table, the five stacks with the most samples,
    each thread's share of samples not parked, and the trace's CUDA
    kernel events, which must exist. Then ``/v2/debug/requests`` must return
    slowest exemplars, and ``trace_rate`` 1 must write five-stamp
    records."""
    import numpy as np

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    base = _stats(port, "image_classifier")["inference_stats"]["success"]["count"]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.perf", "-m", "image_classifier",
             "-u", f"127.0.0.1:{port}", "-b", "1", "--concurrency-range", "8",
             "--shared-memory", "tpu", "--profile-server", *HARNESS_WINDOWS,
             "--json-summary"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            deadline = time.monotonic() + 120
            while (_stats(port, "image_classifier")["inference_stats"]["success"]["count"]
                   < base + 64):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("the 10d load did not start")
                time.sleep(0.05)
            trace_dir = os.path.join(tmp, "device_trace")
            status, headers, collapsed = _http(
                port, f"/v2/debug/profile?duration_s=2&hz=99&jax_trace_dir={trace_dir}")
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"10d harness exited {proc.returncode}:\n{out[-2000:]}\n"
                                 f"{err[-2000:]}")
        if status != 200:
            raise AssertionError(f"/v2/debug/profile answered {status}: {collapsed[:300]}")
        with open(headers["X-Device-Trace"]) as f:
            events = json.load(f)["traceEvents"]
    summary = json.loads(out.strip().splitlines()[-1])
    if summary["errors"] or not summary["count"]:
        raise AssertionError(f"10d harness: {summary['errors']} errors of {summary['count']}")
    stage_table = "Wire-gap attribution" + out.split("Wire-gap attribution", 1)[1].split(
        "\n\n", 1)[0]
    stacks = []
    for line in collapsed.strip().splitlines():
        stack, count = line.rsplit(" ", 1)
        stacks.append((int(count), stack.split(";")))
    total = sum(c for c, _ in stacks)
    top = sorted(stacks, key=lambda e: -e[0])[:5]
    # per thread: its samples, and the share of them not parked
    per_thread, busy = {}, {}
    for count, frames in stacks:
        per_thread[frames[0]] = per_thread.get(frames[0], 0) + count
        if frames[-1] not in IDLE_LEAVES:
            busy[frames[0]] = busy.get(frames[0], 0) + count
    busy = {name: busy.get(name, 0) / n for name, n in per_thread.items()}
    kernels = [e for e in events if e.get("cat") in ("kernel", "Kernel")]
    if not kernels:
        raise AssertionError(f"the Chrome trace holds no CUDA kernel events "
                             f"({len(events)} events)")
    kernel_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    print("profile 10d: " + stage_table + f"\n[{card()}]", flush=True)
    print(f"profile 10d: {total} thread samples over 2 s at "
          f"{headers['X-Profile-Hz-Effective']} Hz; the five stacks with the most "
          f"[{card()}]:", flush=True)
    for count, frames in top:
        print(f"  {100 * count / total:5.1f} %  {frames[0]}: {';'.join(frames[-4:])}",
              flush=True)
    print("profile 10d: share of each thread's samples not parked: " + ", ".join(
        f"{name} {100 * share:.1f} % of {per_thread[name]}" for name, share in
        sorted(busy.items(), key=lambda e: -e[1])) + f" [{card()}]", flush=True)
    print(f"profile 10d: the Chrome trace holds {len(kernels)} CUDA kernel events, "
          f"{kernel_ms:.1f} ms of kernel time in the 2 s window [{card()}]", flush=True)

    # the flight recorder's slowest exemplars, and five-stamp trace records
    status, _, body = _http(port, "/v2/debug/requests?model=image_classifier&limit=5")
    slowest = json.loads(body)["slowest"]
    if status != 200 or not slowest or "compute_us" not in slowest[0]["stages"]:
        raise AssertionError(f"/v2/debug/requests: {status} {body[:300]}")
    with tempfile.TemporaryDirectory() as tmp:
        trace_file = os.path.join(tmp, "trace.jsonl")
        setting = "/v2/models/image_classifier/trace/setting"
        status, _, body = _http(port, setting, "POST", {
            "trace_level": ["TIMESTAMPS"], "trace_rate": "1", "log_frequency": "1",
            "trace_file": trace_file})
        if status != 200:
            raise AssertionError(f"trace setting refused: {status} {body}")
        try:
            with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
                way = _ClientRoute(client, "none")
                for image in images:
                    way.infer("image_classifier", [("INPUT", "FP32", image[None])],
                              [("OUTPUT", np.float32, [1, 1000])])
        finally:
            _http(port, setting, "POST", {key: None for key in (
                "trace_level", "trace_rate", "log_frequency", "trace_file")})
        with open(trace_file) as f:
            records = [json.loads(line) for line in f]
    stamps = ["REQUEST_START", "QUEUE_START", "COMPUTE_START", "COMPUTE_END", "REQUEST_END"]
    if len(records) != len(images) or any(
            [t["name"] for t in r["timestamps"]] != stamps for r in records):
        raise AssertionError(f"trace_rate 1: {len(records)} records for {len(images)} "
                             f"requests, first {records[:1]}")
    result = {"stage_cpu_us": summary.get("server_stage_cpu_us"),
              "infer_per_s": summary["throughput"], "samples": total,
              "top_stacks": [(count / total, ";".join(frames)) for count, frames in top],
              "busy_share_by_thread": busy,
              "kernel_events": len(kernels), "kernel_ms_in_2s": kernel_ms,
              "slowest_total_us": slowest[0]["total_us"], "trace_records": len(records)}
    print("profile 10d: " + json.dumps({k: v for k, v in result.items() if k != "top_stacks"})
          + f" [{card()}]", flush=True)
    return result


def builtins_on_card() -> dict:
    """Phase 10a: the built-ins on the card through the port's HTTP
    client: ``add_sub_chain`` exact at batch 1 and from 8 concurrent
    clients; ``sequence_accumulate`` driven by the port's harness in
    sequence mode, then by hand across the int32 wrap; ``repeat_int32``
    streamed through ``ServerCore.infer_decoupled`` with ``delay_us``, and
    refused by ``/infer``."""
    import asyncio

    import numpy as np

    from client_tpu_torch.server.core import CoreRequest, CoreTensor

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    with http_server(builtins=True) as port:
        def chain(a, b):
            def send(way):
                got = way.infer("add_sub_chain", [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)],
                                [("OUTPUT0", np.int32, list(a.shape)),
                                 ("OUTPUT1", np.int32, list(a.shape))])
                if not (np.array_equal(got["OUTPUT0"], 2 * a)
                        and np.array_equal(got["OUTPUT1"], 2 * b)):
                    raise AssertionError("add_sub_chain answered other than 2*IN0, 2*IN1")
                return True
            return send

        def pair(rows):
            return [rng.integers(-2**20, 2**20, size=[rows, 16], dtype=np.int32)
                    for _ in range(2)]

        with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
            chain(*pair(1))(_ClientRoute(client, "none"))
        work = [chain(*pair(1)) for _ in range(64)]
        _, _, wall = _concurrently(port, 8, lambda c, w: _ClientRoute(c, "none"), work)
        chain_stats = _stats(port, "add_sub_chain")

        seq = perf_run(port, "sequence_accumulate",
                       ["--sequence-length", "8", "--num-of-sequences", "4",
                        "--concurrency-range", "4", "--measurement-interval", "1000"],
                       server_times=False)
        values = [2**31 - 5, 7, 2**31 - 1, -2**31, -9, 2**30]
        sums = []
        with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
            for i, value in enumerate(values):
                inp = client_http.InferInput("INPUT", [1], "INT32")
                inp.set_data_from_numpy(np.array([value], dtype=np.int32))
                answer = client.infer("sequence_accumulate", [inp], sequence_id=99,
                                      sequence_start=i == 0, sequence_end=i == len(values) - 1)
                sums.append(int(answer.as_numpy("OUTPUT")[0]))
            refused = None
            inp = client_http.InferInput("IN", [3], "INT32")
            inp.set_data_from_numpy(np.arange(3, dtype=np.int32))
            try:
                client.infer("repeat_int32", [inp])
            except Exception as e:  # noqa: BLE001 - the refusal is the point
                refused = str(e)
        want = [int(v) for v in np.cumsum(np.array(values, dtype=np.int64))
                .astype(np.uint32).astype(np.int32)]
        if sums != want:
            raise AssertionError(f"sequence_accumulate sums {sums}, want {want}")
        if not refused or "is decoupled; use streaming" not in refused:
            raise AssertionError(f"/infer on repeat_int32: {refused!r}")

        core, loop = SERVING[port]
        repeat = rng.integers(-1000, 1000, size=12).astype(np.int32)
        delay_us = 2000

        async def stream():
            request = CoreRequest("repeat_int32", parameters={"delay_us": delay_us},
                                  inputs=[CoreTensor("IN", "INT32", [12], repeat)])
            start = time.perf_counter()
            out = [([int(v) for v in r.outputs[0].data.reshape(-1)],
                    bool(r.parameters.get("triton_final_response")))
                   async for r in core.infer_decoupled(request)]
            return out, time.perf_counter() - start

        responses, stream_s = asyncio.run_coroutine_threadsafe(stream(), loop).result(60)
        if responses != [([int(v)], i == 11) for i, v in enumerate(repeat)]:
            raise AssertionError(f"repeat_int32 streamed {responses}")
        if stream_s < 11 * delay_us / 1e6:
            raise AssertionError(f"repeat_int32 took {stream_s} s for 11 delays of {delay_us} us")
    result = {"add_sub_chain_requests": 65, "add_sub_chain_8_clients_wall_s": wall,
              "add_sub_chain_rows_per_execution":
                  chain_stats["inference_count"] / max(1, chain_stats["execution_count"]),
              "sequence_harness_infer_per_s": seq["infer_per_s"],
              "sequence_harness_completed": seq["completed"],
              "wrapped_sums": sums, "repeat_stream_s": stream_s,
              "wall_s": time.perf_counter() - t0}
    print("builtins 10a: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def llm_decode_7b(params) -> dict:
    """Phase 10b: ``llm_decode`` at Llama-7B widths on phase 4's weights,
    through the OpenAI route's default model (no ``model`` in the body),
    32 tokens a stream: two prompts in turn, then the same two at once.
    Each stream must equal ``llama.generate`` on the same weights and
    prompt; TTFT and ITL are printed. A step holds the serving loop."""
    from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
    from client_tpu_torch.models.serving import LlmDecodeModel

    config = llama.LlamaConfig()
    prompts = _prompts()[:2]
    tokenizer = SyntheticTokenizer(config.vocab_size)
    with torch.inference_mode():
        want = [llama.generate(params, torch.tensor([tokenizer.encode(p)], dtype=torch.int32,
                                                      device=DEVICE), config, SERVE_TOKENS)
                [0].tolist() for p in prompts]
    t0 = time.perf_counter()
    model = LlmDecodeModel(config=config, params=params, device=DEVICE)
    with http_server(model) as port:
        load_s = time.perf_counter() - t0
        runs = {}
        for mode in ("in turn", "at once"):
            records = [dict() for _ in prompts]
            threads = [threading.Thread(target=_stream_one, args=(port, p, SERVE_TOKENS, r, None))
                       for p, r in zip(prompts, records)]
            start = time.perf_counter()
            for thread in threads:
                thread.start()
                if mode == "in turn":
                    thread.join(600)
            for thread in threads:
                thread.join(600)
            wall = time.perf_counter() - start
            for i, record in enumerate(records):
                if record.get("status") != 200 or not record.get("done"):
                    raise AssertionError(f"10b {mode} stream {i} failed: {record}")
                if record["tokens"] != want[i]:
                    raise AssertionError(f"10b {mode} stream {i} differs from generate: "
                                         f"{record['tokens']} vs {want[i]}")
            runs[mode] = latency(records, wall)
        stats = _stats(port, "llm_decode")
    if stats["inference_stats"]["success"]["count"] != 4:
        raise AssertionError(f"llm_decode booked {stats['inference_stats']}")
    result = {"load_s": load_s, **{mode: run for mode, run in runs.items()},
              "streams_equal_to_generate": 4}
    print("llm_decode 10b: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def main() -> int:
    faulthandler.enable()  # a fault in native code prints every thread's stack
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
    llm_decode_7b(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    kserve_tiny()
    kserve_bert_large()
    classifier_tiny()
    classifier_resnet50()
    data_plane()
    client_correctness()
    data_plane_procs()
    server_thread_profile()
    builtins_on_card()
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

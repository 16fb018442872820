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
2c. K3 (the BERT encoder's fused attention) against its plain version
   (fp32 at head dims 16, 64 and 128 over trailing, inner and all-pad key
   masks; bf16 no further from the fp32 attention than the plain
   version), and timed at the ``bert_large.ragged`` cell's shape (B 16,
   H 16, hd 64, masks drawn from its lengths) beside its bound, the plain
   version and ``F.scaled_dot_product_attention`` as a yardstick;
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
   subprocess that cannot see the card, with three 0.5 s windows (2 s for
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
   ``torch.profiler`` Chrome trace (one capture, the load still on when
   it answers): the stage CPU table, the five stacks with the most
   samples, the busy samples by thread, the trace's CUDA kernel events
   (there must be some), its kernel ms and the requests served in its
   window, the flight recorder's slowest requests and five-stamp trace
   records at ``trace_rate`` 1 (``profile 10d:``). A CUDA capture under
   this load kills the process in about one 2 s window in eleven, inside
   CUPTI's own worker thread, with or without a server around the model
   and under every setting torch and Kineto expose (PERF.md;
   ``profile_sweep.py`` reruns the control); so 10d takes one capture,
   and the run fails when it crashes.
11. lifecycle, admission and repository control, and the TFS and
   TorchServe front-ends: (a) inside phase 4, after 9d, the 8 streams
   again with ``llm_engine`` unloaded after their first tokens: while the
   unload drains a new stream gets 503 and the OpenAI error body and the
   index reads UNLOADING, then "unloaded"; the 8 streams equal phase 4's;
   ``POST .../load`` re-warms it (a new pool, the old engine closed after
   the probes) and the 8 streams equal phase 4's again, K1 launched >= 32
   x decode steps, every block back (``lifecycle 11a:``, the reload's
   peak memory); (b)-(e) after phases 12-13 on their ``python -m
   client_tpu_torch.server --model-repository`` spawned with the card,
   serving ``resnet50`` and
   ``resnet50_sched`` (ResNet-50's widths, seed 0; the second with two
   priority levels, a queue of 16 with the "continue" timeout action and
   one ``card`` rate-limiter resource) from ``<name>/model.py`` files, the
   harness in subprocesses: (b) one image through KServe, TFS ``:predict``
   and TorchServe, each within 2 % of KServe's largest |logit| with its
   top-1, and the harness's tfserving, torchserve and KServe kinds at c=8
   (``compat 11b:``); (c) c=32 at priorities 1,2 on ``resnet50_sched``:
   its 429s against ``tpu_queue_rejected_total``, priority 1's p99 no
   higher than priority 2's, the ``card`` pool back at 1 (``admission
   11c:``); (d) ``--rolling-restart 1`` for 6 s: >= 3 cycles, only 503
   failures, a probe image's answer unchanged, device memory grown by no
   more than one copy of the weights (``rolling 11d:``); (e) SIGTERM
   under a c=8 load while a request to the ``drain_hold`` identity sleeps
   4 s on the server: readiness 503 with ``Retry-After``, liveness 200,
   the harness sees 503s only, the process exits 0 inside its 20 s drain
   timeout with ``drain_started`` and ``drain_completed`` in its log
   (``drain 11e:``); (f) ``client_tpu_torch.server.embedded.start()`` in
   this process: ``simple`` exact through its binary wire (``embedded
   11f:``).
12. the KServe v2 gRPC surface (the native front-end, built with ``g++``,
   and the port's own gRPC clients; no grpcio): (a)-(b), (d) on
   ``python -m client_tpu_torch.server --grpc-port 0 --model-repository
   --drain-timeout 20`` spawned with the card (the server 11b-11e use
   after it), serving the built-ins, ``resnet50`` (as 11b), 11's models
   and the ``grpc_hold`` identity: (a) from a client process, the port's sync
   gRPC client: every RPC answers (health, metadata, config, statistics,
   repository index / unload / load, system and TPU shm register / status
   / unregister, CUDA shm status empty, trace and log settings),
   ``simple`` exact, ``identity_fp32`` at 4 MiB bit-exact inline and
   through TPU shm, one ResNet-50 image over gRPC bit-equal to the HTTP
   route's answer (both at batch 1), and the server's statistics book
   every request (``grpc 12a:``); (b) the harness with ``-i grpc`` beside
   ``-i http``, ResNet-50 ``-b 1`` c=8 over ``--shared-memory none`` and
   ``tpu``, three 0.5 s windows, phase 9's guards (``grpc 12b:``); (d) a
   request to ``grpc_hold`` held 3 s over gRPC while ``simple`` answers
   over gRPC the whole time, each under 0.5 s (``grpc 12d:``); (c) inside
   phase 4, after 11a, the 8 streams of 32 tokens again over
   ``ModelStreamInfer`` through the port's aio client, equal to phase 4's
   (or parting at a dense-forward near-tie, as 11a reads them), K1
   launched 32 x decode steps, and a ninth stream cancelled after two
   tokens, every KV block back (``grpc 12c:``, TTFT and ITL).
13. the rest of the gRPC surface: the multiplexed persistent stream
   (``stream_mode=True``), TLS on both sides (the front-end's listener
   through ``libssl.so.3``, ALPN h2; the clients' stdlib ``ssl``) and
   genai-perf's KServe endpoints: (a)-(b) beside phase 12 on its spawned
   server and on a second one spawned with ``--grpc-tls-cert/key`` (a
   throwaway certificate from the ``openssl`` CLI): (a) from a client
   process, the sync and aio clients in stream mode give ``simple``,
   ``identity_fp32`` at 4 MiB and one ResNet-50 image bit-equal to unary,
   in plaintext and over TLS, and sixteen ``simple`` requests behind one
   held 3 s on ``grpc_hold`` on the shared stream all answer first, each
   under 0.5 s (``grpc 13a:``); (b) the harness with ``-i grpc
   --stream-mode`` over none and TPU shm beside 12b's unary rows, and
   unary inline over TLS (``--ssl-grpc-root-certifications-file``), each
   ResNet-50 ``-b 1`` c=8, three 0.5 s windows, phase 9's guards (``grpc
   13b:``); then the TLS server is killed under a request held on the
   stream, which must fail with a retryable status inside 10 s; (c)
   inside phase 4, after 12c, genai-perf ``--service-kind triton
   --endpoint-type kserve-ids --streaming`` over gRPC with 9d's traffic
   (8 streams, 16 prompts, 32 tokens), every request 32 token events, K1
   launched exactly 32 x decode steps (``genai 13c:``, beside 9d); (d)
   after phase 5, the same with ``--speculation on`` against an engine on
   phase 4's weights whose draft is their first layer (K = 4), since
   phase 5's n-gram proposer finds little to copy in random-weight
   streams (genai-perf in this process, so that its two readings of the
   speculation counters fall on an idle engine): the JSON summary's
   speculation delta equals the engine's own counter deltas, its counters
   read over gRPC equal the engine's, at least half the steps and one per
   request are verify steps, and K2 launched >= 32 x verify steps
   (``genai 13d:``).
14. fault injection and engine recovery: (a) inside phase 4, after 13c,
   two rounds of phase 4's 8 streams on its 7B engine: once every stream
   has 4 tokens, a decode step asks the card for more memory than it has
   (a genuine ``torch.OutOfMemoryError``), then, on the recovered engine,
   the engine is quarantined from another thread with its reload held
   while a ninth stream is refused 503 with ``Retry-After`` and the
   OpenAI error body and a tenth, over gRPC with ``recovery: fail``,
   gets the error; each time the controller reloads the engine (a new
   pool beside the quarantined one), the 8 survivors re-prefill and
   finish equal to phase 4's (or part at a dense-forward near-tie, 11a's
   rule) with no client error, ``describe()`` reads READY with 1 then 2
   recoveries, ``tpu_recovery_total{tier="engine",outcome="success"}``
   rises by 2, every KV block comes back, K1 launches >= 32 x decode
   steps and the quarantined pools are freed (``recovery 14a:``,
   fault-to-READY, the longest token gap, peak and settled memory,
   ``tpu_server_state`` sampled); (b) a spawned ``--model-repository``
   server whose ``llm_engine`` (7B widths, 2 layers) hits a device-side
   assert with 4 streams in flight: every stream fails with the OpenAI
   error inside 10 s, every reload fails on the poisoned context, the
   controller reads FAILED after its attempts and
   ``tpu_recovery_total{...,outcome="failed"}`` is 1, the routes that
   still answer are recorded, and SIGTERM ends the process inside its
   drain timeout (``recovery 14b:``); (c) beside 7b, ``InProcessServer``
   with ``ChaosPolicy(error_rate=0.3)`` and a second with
   ``reset_rate=0.15, truncate_rate=0.15``, both serving ``simple`` and
   7b's ResNet-50 on the card: from 4 client processes with the
   reference's retry policy 100 ``simple`` requests answer exactly and 64
   images within 7b's 2 %, the servers booking only the requests that
   reached the model; without a policy every run fails with 503; the
   harness at ``-b 1`` c=8 with ``--max-error-rate 0.5`` sees about 30 %
   errors, beside the same load on 7b's server (``chaos 14c:``).
15. sharded serving over a mesh of shards of the one card (an explicit
   device list may repeat the card): (a) the tiny fp32 ``LlmEngineModel``
   at tp 1, 2 and 4 on ``[cuda:0] * tp``: prefill, suffix prefill, 4
   decode steps and a K=4 verify step within 1e-5 of tp 1 with equal
   argmax, K1 and K2 launched tp x n_layers times a step, greedy streams
   equal to the dense oracle with speculation off and n-gram on (``tp
   15a:``); (b) after phase 5, ``LlmEngineModel(tp=2, devices=[cuda:0,
   cuda:0])`` on phase 4's weights (16 heads and half the pool a shard)
   serves phase 4's 8 prompts x 32 tokens over HTTP, each stream equal to
   phase 4's or parting at a dense near-tie (11a's rule), K1 launched
   exactly 2 x 32 x decode steps; TTFT, ITL, host ms a step, K1's device
   ms a shard, peak and settled memory beside phase 4's (``tp 15b:``);
   (c) ``text_encoder_tp`` at BERT-large's widths, fp32, dp2 x tp2 on
   ``[cuda:0] * 4``: 16 requests of 16-512 tokens within 1e-4 of the
   largest |value| of the unsharded encoder, the axes on metadata, config
   and ``/v2/debug/state`` (``tp 15c:``); (d) ``llama_ring`` at 7B
   widths, bf16, sp=2: prompts of 1,024 and 4,096 tokens, LOGITS within 2
   % of the largest |logit| of the fp32 dense forward's last position, or
   no farther from it than 1.5 x the bf16 dense forward, with its top-1
   unless a near-tie (``tp 15d:``); (e) the zoo without ``devices``:
   ``text_encoder_tp``, ``llama_ring`` and an ``LlmEngineModel(tp=2)``
   UNAVAILABLE with ``mesh requires N devices, host has 1``, the server
   ready, 503 on infer, per-device duty for ``cuda:0`` only (``tp
   15e:``).
16. the pod and the fleet tier, after phase 4's weights are freed: the
   tiny pod and the 7B at tp=2 over two processes on the card, a member
   SIGKILLed under its streams, and ``--fleet 2`` (``pod 16a:`` ...
   ``fleet 16d:``).
17. the router tier, before phase 4's weights are freed: two
   ``InProcessServer`` replicas with the native gRPC front-end on the
   card, each an ``llm_engine`` on phase 4's weights (shared) with a pool
   of 512 blocks and the built-ins, behind ``python -m
   client_tpu_torch.router --serve`` processes: (a) phase 4's 8 streams
   of 32 tokens over ``ModelStreamInfer`` through the router, taken by
   both replicas, each equal to phase 4's or parting at a near-tie (11a's
   rule), K1 exactly 32 x both replicas' decode steps; (b) the same
   streams straight to replica A, the proxy tax recorded; (c) replica B
   stopped under ``simple`` from 4 client threads: no client failure, B
   benched in ``/v2/router/status``, then 8 streams all on A; (d) a
   second router with ``--max-inflight 4``: 8 default-priority streams
   and 2 at priority 1 at once, a default one shed in-band with
   RESOURCE_EXHAUSTED and its retry hint, none at priority 1, every
   admitted stream equal to phase 4's; ``simple`` past the limit gets 429
   with ``Retry-After`` over HTTP and ``retry-after`` in its gRPC
   trailers (``router 17a:`` ... ``router 17d:``).
18. training, after phase 4's weights are freed and before phase 16
   (it reaches neither kernel): (a) three tiny fp32 ``make_train_step``
   steps on the card equal to the same steps on the CPU (losses within
   1e-5, parameters within 1e-4; the first step's gradients beside),
   unsharded and at dp2 x sp2 x tp2 over ``[cuda:0] * 8``; (b)
   ``graft_entry.dryrun_multichip(8)`` over eight entries of the card,
   2 x 2 x 2 and 1 x 2 x 4, losses within 1e-3; (c) train steps at
   Llama-7B's widths (bf16, tokens ``[1, 512]``, the largest of 32, 24
   and 16 layers whose reckoned peak stays under 72 GiB): ms a step
   (median of 3 after a warm one), each loss (finite, the last below the
   first), tokens/s, matrix-product TFLOP/s against the bf16 dense peak,
   the forward and backward and the update timed apart, peak memory
   beside its reckoning
   (``train 18a:`` ... ``train 18c:``).

Every phase prints ``phase <label>: <s> s`` as it ends, and every
spawned server its start-up. The last two lines are the card's name and
power limit and the result object; the line before them lists every
kernel with its numbers.
"""

import asyncio
import contextlib
import dataclasses
import faulthandler
import functools
import gc
import http.client
import json
import math
import os
import re
import signal
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


@contextlib.contextmanager
def timed(label):
    """Prints ``phase <label>: <s> s`` as the block ends, failing or not:
    every phase reports its seconds against the script's time limit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)


def timed_phase(label):
    """The phase function decorated runs under :func:`timed`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with timed(label):
                return fn(*args, **kwargs)
        return run
    return wrap


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


@timed_phase("1 (build)")
def build() -> None:
    """Build both kernels; print each instance's registers and spills (from
    ptxas) and its dynamic shared memory and resident blocks an SM at the
    default partition (from the runtime). The gRPC front-end (``g++``,
    phases 12-13 and 17) builds beside them."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from client_tpu_torch import frontend_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        frontend = pool.submit(frontend_build.build)
        paths = kernels.build_all()
        frontend.result()
    print(f"build: {len(paths)} source(s) and the gRPC front-end in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    describe = {"paged_attention.cu": "rpa_describe", "paged_attention_mq.cu": "rpa_mq_describe",
                "bert_attention.cu": "bat_describe"}
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
            # K1 and K2 instances name (dtype, D, rows), K3's (dtype, D)
            shape = re.search(r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?", mangled)
            dtype, d = ("fp32" if shape.group(1) == "f" else "bf16"), int(shape.group(2))
            rows = int(shape.group(3)) if shape.group(3) else None
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            shape_args = (d,) if rows is None else (d, rows, pa.PARTITION_SLOTS)
            code = getattr(lib, describe[source])(0 if dtype == "fp32" else 1, *shape_args,
                                                  ctypes.byref(smem), ctypes.byref(blocks))
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


# K3 at the bert_large.ragged cell's shape: 16 rows an execution, BERT-large's
# 16 heads of 64, lengths lognormal (median 128, sigma 0.8) in 16-512,
# padded to the power-of-two bucket of the longest
ENCODER_ROWS, ENCODER_HEADS, ENCODER_HEAD_DIM = 16, 16, 64
ENCODER_LENGTHS = {"median": 128, "sigma": 0.8, "min": 16, "max": 512}
ENCODER_BATCHES = 8


def encoder_masks(seed: int, batches: int = ENCODER_BATCHES) -> list:
    """Key masks [16, L] of ``batches`` executions drawn from the cell's
    length distribution, each padded to its bucket."""
    import numpy as np

    from client_tpu_torch.server.models import pad_batch_bucket

    rng = np.random.default_rng(seed)
    spec = ENCODER_LENGTHS
    masks = []
    for _ in range(batches):
        lengths = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(ENCODER_ROWS))
        lengths = np.clip(np.round(lengths), spec["min"], spec["max"]).astype(int)
        width = min(pad_batch_bucket(int(lengths.max()), 8), spec["max"])
        masks.append(torch.arange(width)[None, :] < torch.from_numpy(lengths)[:, None])
    return masks


def encoder_attention_bound(key_mask, heads: int, hd: int, elem_bytes: int = 2) -> dict:
    """The least time K3 could take for one call: q, k, v read and ctx
    written once (and the mask) at 3.35 TB/s against the products these
    masks need (every query row against its row's real keys, QK^T and PV)
    at the dense bf16 peak."""
    b, length = key_mask.shape
    nbytes = 4 * b * length * heads * hd * elem_bytes + b * length
    flops = 4 * length * int(key_mask.sum()) * heads * hd
    bytes_ms, ops_ms = nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations", "bytes": nbytes, "flops": flops}


def measure_encoder_attention() -> dict:
    """Phase 2c: K3, the BERT encoder's fused attention. Held to its plain
    version (fp32 within 1e-5; bf16 no further from the fp32 attention of
    its inputs than the plain version, plus one bf16 ulp), then timed at
    the ``bert_large.ragged`` cell's shape (B 16, H 16, hd 64, bf16) over
    masks drawn from the cell's lengths: CUDA-event means of the kernel,
    the plain version and, as a yardstick the port never calls,
    ``F.scaled_dot_product_attention`` (``library_ms``), beside the bound."""
    import numpy as np
    import torch.nn.functional as F

    from client_tpu_torch.models import bert

    gen = torch.Generator().manual_seed(21)
    fp32 = bert.BertConfig.tiny(dtype=torch.float32)
    worst = 0.0
    for hd in (16, 64, 128):
        q, k, v = (torch.randn(4, 200, 4, hd, generator=gen).to(DEVICE) for _ in range(3))
        key_mask = torch.ones(4, 200, dtype=torch.bool)
        key_mask[0, 77:] = False
        key_mask[1, 64:128] = False
        key_mask[2] = False
        key_mask = key_mask.to(DEVICE)
        out = bert.encoder_attention_cuda(q, k, v, key_mask)
        err = (out - bert.encoder_attention_plain(q, k, v, key_mask, fp32)).abs().max().item()
        torch.cuda.synchronize()
        if not err <= 1e-5:
            raise AssertionError(f"K3 fp32 hd={hd}: {err} > 1e-5")
        worst = max(worst, err)

    bf16 = bert.BertConfig()
    shape = (ENCODER_ROWS, 512, ENCODER_HEADS, ENCODER_HEAD_DIM)
    q_all, k_all, v_all = (torch.randn(*shape, generator=gen).to(DEVICE, torch.bfloat16)
                           for _ in range(3))
    rows = []
    for key_mask in encoder_masks(seed=22):
        length = key_mask.shape[1]
        q, k, v = (t[:, :length].contiguous() for t in (q_all, k_all, v_all))
        key_mask = key_mask.to(DEVICE)
        out = bert.encoder_attention_cuda(q, k, v, key_mask)
        exact = bert.encoder_attention_plain(q.float(), k.float(), v.float(), key_mask, fp32)
        plain = bert.encoder_attention_plain(q, k, v, key_mask, bf16)
        kernel_err = (out.float() - exact).abs().max().item()
        plain_err = (plain.float() - exact).abs().max().item()
        if not kernel_err <= plain_err + BF16_ULP * exact.abs().max().item():
            raise AssertionError(f"K3 bf16 L={length}: {kernel_err} against the plain "
                                 f"version's {plain_err}")
        del exact, plain
        tiles = -(-length // 64)
        visited = sum(bool(m[i * 64:(i + 1) * 64].any())
                      for m in key_mask.cpu() for i in range(tiles))
        sdpa_mask = key_mask[:, None, None, :]
        rows.append({
            "length": length,
            "real_keys": int(key_mask.sum()),
            "tile_share": visited / (tiles * ENCODER_ROWS),
            "ms": cuda_ms(lambda: bert.encoder_attention_cuda(q, k, v, key_mask)),
            "plain_ms": cuda_ms(lambda: bert.encoder_attention_plain(q, k, v, key_mask, bf16)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=sdpa_mask)),
            "kernel_err": kernel_err,
            "plain_err": plain_err,
            **encoder_attention_bound(key_mask, ENCODER_HEADS, ENCODER_HEAD_DIM),
        })
    result = {key: float(np.mean([r[key] for r in rows]))
              for key in ("ms", "plain_ms", "library_ms", "bound_ms", "tile_share", "flops",
                          "bytes")}
    result.update(max_abs_err=max(r["kernel_err"] for r in rows),
                  plain_max_abs_err=max(r["plain_err"] for r in rows),
                  fp32_max_abs_err=worst, lengths=[r["length"] for r in rows],
                  bound_by=sorted({r["bound_by"] for r in rows}))
    print(f"k3 fp32 (hd 16, 64, 128; trailing, inner and all-pad masks): max_abs_err {worst:.3g} "
          f"(limit 1e-5)", flush=True)
    print(f"k3 bf16 bert_large.ragged shape (B {ENCODER_ROWS}, H {ENCODER_HEADS}, hd "
          f"{ENCODER_HEAD_DIM}; {len(rows)} masks drawn from the cell's lengths, L "
          f"{result['lengths']}, {result['tile_share']:.1%} of key tiles visited): max_abs_err "
          f"{result['max_abs_err']:.3g} from the fp32 attention (plain version "
          f"{result['plain_max_abs_err']:.3g}); kernel {result['ms']:.4f} ms, plain "
          f"{result['plain_ms']:.4f} ms, sdpa (yardstick) {result['library_ms']:.4f} ms, bound "
          f"{result['bound_ms']:.4f} ms ({', '.join(result['bound_by'])}), "
          f"{result['bound_ms'] / result['ms']:.1%} of bound [{card()}]", flush=True)
    return result


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


def _tiny_streams(speculation=None, tp=1):
    """The tiny fp32 Llama through the engine on the card, four concurrent
    greedy streams of 12 tokens, each held to the dense oracle. With
    ``tp`` > 1 the engine shards over ``tp`` shards of the card. Returns
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
        tp=tp, devices=[DEVICE] * tp,
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
            raise AssertionError(
                f"engine ({speculation}, tp {tp}) {stream} != dense {dense[0].tolist()}")
    if stats["kv_blocks_in_use"] != 0:
        raise AssertionError(
            f"{stats['kv_blocks_in_use']} KV blocks leaked ({speculation}, tp {tp})")
    return stats


@timed_phase("3")
def check_tiny_engine() -> None:
    """The tiny fp32 Llama through the engine (prefill, suffix prefill,
    K1 decode at head_dim 16) against the dense oracle on the card."""
    stats = _tiny_streams()
    if stats["prefix_cache_hits"] < 1:
        raise AssertionError("the shared prefix was never matched")
    print(f"tiny fp32 engine on the card: 4 greedy streams equal the dense oracle, "
          f"{stats['prefix_cache_hits']} prefix blocks shared", flush=True)


@timed_phase("3b")
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
                model: str = "llm_engine", started=None) -> None:
    """One streaming chat completion for ``model`` (None: the route's
    default model) into ``record``; ``started`` (an Event) is set at the
    first token."""
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
                if started is not None:
                    started.set()
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
def http_server(*models, builtins: bool = False, zoo: bool = False, unavailable=()):
    """``ServerCore`` + the HTTP front-end on a loopback port serving
    ``models`` (loaded here; with ``builtins``, the built-in models on the
    card too; with ``zoo``, the model zoo); yields the port, and stops the
    server, the engine and the event loop on the way out. Every model must
    load, but those named in ``unavailable``, which must not."""
    import asyncio

    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.http_server import serve_http
    from client_tpu_torch.server.model_repository import ModelRepository
    from client_tpu_torch.server.models import register_builtin_models

    repository = ModelRepository()
    if builtins:
        register_builtin_models(repository, device=DEVICE)
    if zoo:
        from client_tpu_torch.models.serving import register_zoo_models

        register_zoo_models(repository, device=DEVICE)
    for model in models:
        repository.add_model(model)
    torch.cuda.synchronize()
    for entry in repository.index():
        if (entry["state"] == "READY") == (entry["name"] in unavailable):
            raise AssertionError(f"{entry['name']}: {entry['state']} {entry['reason']!r}")
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
# random weights rarely repeat a token of the context, so n-gram proposals
# are rare: 128 tokens a stream give phase 5 a few verify steps (it asks
# for one); 13d drafts with a model instead
SPEC_SERVE_TOKENS = 128


@timed_phase("4 (with 9d, 11a, 12c, 13c, 14a)")
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
        loaded_gib = torch.cuda.memory_allocated() / 2**30
        print(f"serve: llm_engine loaded in {time.perf_counter() - t0:.1f} s "
              f"({pool.num_blocks} blocks x {pool.block_size} tokens, "
              f"{loaded_gib:.1f} GiB on the card)", flush=True)
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
        # [0]: a name for the returned pool would keep it alive past 11a
        logits = engine._prefill(probe, table, engine._pages, 4, 0)[0]
        if logits.shape != (1, config.vocab_size) or not np.isfinite(logits).all():
            raise AssertionError(f"7B prefill logits: shape {logits.shape}, finite "
                                 f"{np.isfinite(logits).all()}")
        step = profile_step(engine, [len(p.split()) + SERVE_TOKENS for p in _prompts()])
        served_by_harness = genai_perf_7b(port, engine, config.n_layers)
        # 11a reloads the engine: nothing here may keep the old pool alive
        del engine
        lifecycle = lifecycle_7b(port, model, config, [r["tokens"] for r in records])
        over_grpc = grpc_7b(port, model, config, [r["tokens"] for r in records])
        kserve_grpc = genai_grpc_13c(port, model, config, served_by_harness)
        recovered = recovery_7b(port, model, config, [r["tokens"] for r in records])

    result = latency(records, wall)
    result.update(decode_steps=decode_steps, k1_launches=launches,
                  prefix_blocks_shared=prefix_hits)
    print("serve: " + json.dumps(result) + f" [{card()}]", flush=True)
    result["step"] = step
    result["loaded_gib"] = loaded_gib
    result["genai_perf"] = served_by_harness
    result["lifecycle_11a"] = lifecycle
    result["grpc_12c"] = over_grpc
    result["genai_13c"] = kserve_grpc
    result["recovery_14a"] = recovered
    params = model._params
    # only one 17 GB pool at a time: drop this engine and its pool
    model.engine = None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return result, params, [r["tokens"] for r in records]


@timed_phase("5")
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
        del engine

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


@timed_phase("6a")
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
    launches = k3_launches(before, after)
    if launches != config.n_layers * executions:
        raise AssertionError(f"text_encoder: {launches} K3 launches in {executions} executions")
    print(f"kserve tiny: simple exact, identity_fp32/bf16/bytes bit-exact (JSON and binary); "
          f"16 concurrent text_encoder requests (lengths {int(lengths.min())}-"
          f"{int(lengths.max())}) within {worst:.3g} of the CPU forward (limit 1e-5) in "
          f"{executions} executions, {launches} K3 launches", flush=True)


def k3_launches(before, after) -> int:
    """K3 launches the text encoder's statistics entry booked between two
    readings."""
    def count(entry):
        return entry["kernel_launches"]["encoder_attention"]

    return count(after) - count(before)


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


@timed_phase("6b (with 9c)")
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
    launches = k3_launches(before, after)
    if launches != config.n_layers * executions:
        raise AssertionError(f"BERT-large: {launches} K3 launches in {executions} executions")
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
        "k3_launches": launches,
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


@timed_phase("7a")
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


@timed_phase("7b (with 8b, 9a-9b, 10c, 14c)")
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
        chaos = chaos_14c(port, model, images, check)
    result = {"runs": runs, "procs": procs, "perf_9ab": harness, "metrics_10c": metrics_10c,
              "chaos_14c": chaos,
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


@timed_phase("7c")
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


class _Spilled:
    """A numpy array a client process's arguments carry as a file: a
    spawned process is handed its arguments through a pipe only once it
    has imported this script, so large ones would make each start wait
    for the one before it."""

    def __init__(self, path):
        self.path = path


def _spill(value, directory):
    """``value`` with each numpy array in it saved under ``directory``."""
    import numpy as np

    if isinstance(value, np.ndarray):
        path = os.path.join(directory, f"{uuid.uuid4().hex}.npy")
        np.save(path, value)
        return _Spilled(path)
    if isinstance(value, dict):
        return {k: _spill(v, directory) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_spill(v, directory) for v in value)
    return value


def _unspill(value):
    import numpy as np

    if isinstance(value, _Spilled):
        return np.load(value.path)
    if isinstance(value, dict):
        return {k: _unspill(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_unspill(v) for v in value)
    return value


def _client_main(task, args, barrier, results):
    """A spawned client process: runs ``CLIENT_TASKS[task]`` and puts
    (worker, result, error) on ``results``, once a task or once a route.
    It imports torch for the client's dtype tables and never asks for the
    card: it speaks HTTP and shared memory only."""
    import traceback

    worker = args.get("worker", 0)
    try:
        args = _unspill(args)
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


def _grpc_correctness_task(barrier, url, http_url, image, worker=0):
    """Phase 12a from a client process: every RPC of the service through
    the port's sync gRPC client; the exact and bit-exact answers; one
    ResNet-50 image over gRPC against the HTTP route's answer; the
    server's statistics against the requests sent."""
    import numpy as np

    import client_tpu_torch.grpc as grpcclient
    from client_tpu_torch.utils import shared_memory as shm
    from client_tpu_torch.utils import tpu_shared_memory as tpushm

    barrier.wait(300)
    t0 = time.perf_counter()
    client = grpcclient.InferenceServerClient(url)
    sent = {"simple": 0, "identity_fp32": 0, "resnet50": 0}

    def stats():
        return {m: int(client.get_inference_statistics(m, as_json=True)["model_stats"][0]
                       ["inference_stats"]["success"].get("count", 0)) for m in sent}

    def tensor(name, arr, datatype):
        t = grpcclient.InferInput(name, list(arr.shape), datatype)
        return t.set_data_from_numpy(arr)

    checks = {}
    before = stats()
    if not (client.is_server_live() and client.is_server_ready()
            and client.is_model_ready("resnet50") and client.is_model_ready("simple")):
        raise AssertionError("health over gRPC")
    checks["server"] = client.get_server_metadata(as_json=True)["name"]
    meta = client.get_model_metadata("resnet50", as_json=True)
    checks["resnet50_input"] = meta["inputs"][0]["shape"]
    checks["simple_max_batch"] = client.get_model_config("simple", as_json=True)["config"][
        "max_batch_size"]
    index = {e["name"]: e.get("state") for e in
             client.get_model_repository_index(as_json=True)["models"]}
    if index.get("resnet50") != "READY" or index.get("grpc_hold") != "READY":
        raise AssertionError(f"repository index over gRPC: {index}")
    client.unload_model("identity_bytes")
    deadline = time.monotonic() + 60
    while True:
        unloaded = {e["name"]: e for e in client.get_model_repository_index(
            as_json=True)["models"]}["identity_bytes"]
        if unloaded.get("state") == "UNAVAILABLE" or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    client.load_model("identity_bytes")
    if unloaded.get("state") != "UNAVAILABLE" or not client.is_model_ready("identity_bytes"):
        raise AssertionError(f"unload / load over gRPC: {unloaded}")
    # system and TPU regions: register, status, unregister
    key = _shm_key("g12a")
    region = shm.create_shared_memory_region(key, key, 64)
    try:
        client.register_system_shared_memory(key, key, 64)
        status = client.get_system_shared_memory_status(key, as_json=True)["regions"]
        client.unregister_system_shared_memory(key)
        if status[key]["byte_size"] != "64" or client.get_system_shared_memory_status(
                as_json=True):
            raise AssertionError(f"system shm over gRPC: {status}")
    finally:
        shm.destroy_shared_memory_region(region)
    if client.get_cuda_shared_memory_status(as_json=True) != {}:
        raise AssertionError("CUDA shm status is not empty")
    trace = client.update_trace_settings(settings={"trace_rate": "7"}, as_json=True)
    client.update_trace_settings(settings={"trace_rate": None})
    log = client.get_log_settings(as_json=True)
    if trace["settings"]["trace_rate"]["value"] != ["7"] or "log_info" not in log["settings"]:
        raise AssertionError(f"trace / log settings over gRPC: {trace} {log}")
    # simple exact
    a = np.arange(16, dtype=np.int32)[None]
    b = np.full([1, 16], 7, dtype=np.int32)
    result = client.infer("simple", [tensor("INPUT0", a, "INT32"), tensor("INPUT1", b, "INT32")])
    sent["simple"] += 1
    if not (np.array_equal(result.as_numpy("OUTPUT0"), a + b)
            and np.array_equal(result.as_numpy("OUTPUT1"), a - b)):
        raise AssertionError("simple over gRPC is not exact")
    # identity_fp32 at 4 MiB, inline and through TPU regions
    x = np.random.default_rng(12).normal(size=[1 << 20]).astype(np.float32)
    result = client.infer("identity_fp32", [tensor("INPUT0", x, "FP32")])
    sent["identity_fp32"] += 1
    if result.as_numpy("OUTPUT0").tobytes() != x.tobytes():
        raise AssertionError("identity_fp32 at 4 MiB over gRPC is not bit-exact")
    names = [_shm_key("g12a_in"), _shm_key("g12a_out")]
    regions = [tpushm.create_shared_memory_region(n, x.nbytes) for n in names]
    try:
        tpushm.set_shared_memory_region(regions[0], [x])
        for n, r in zip(names, regions):
            client.register_tpu_shared_memory(n, tpushm.get_raw_handle(r), 0, x.nbytes)
        status = client.get_tpu_shared_memory_status(as_json=True)["regions"]
        inp = grpcclient.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_shared_memory(names[0], x.nbytes)
        out = grpcclient.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(names[1], x.nbytes)
        client.infer("identity_fp32", [inp], outputs=[out])
        sent["identity_fp32"] += 1
        got = tpushm.get_contents_as_numpy(regions[1], "FP32", list(x.shape))
        for n in names:
            client.unregister_tpu_shared_memory(n)
        if got.tobytes() != x.tobytes() or sorted(status) != sorted(names) \
                or client.get_tpu_shared_memory_status(as_json=True):
            raise AssertionError(f"identity_fp32 through TPU shm over gRPC: {status}")
    finally:
        for r in regions:
            tpushm.destroy_shared_memory_region(r)
    # one ResNet-50 image over gRPC and over HTTP, both at batch 1
    result = client.infer("resnet50", [tensor("INPUT", image, "FP32")])
    sent["resnet50"] += 1
    over_grpc = result.as_numpy("OUTPUT").astype(np.float32)
    with client_http.InferenceServerClient(http_url) as http_client:
        x_http = client_http.InferInput("INPUT", list(image.shape), "FP32")
        x_http.set_data_from_numpy(image, binary_data=True)
        over_http = http_client.infer("resnet50", [x_http]).as_numpy("OUTPUT").astype(
            np.float32)
    sent["resnet50"] += 1
    worst = float(np.abs(over_grpc - over_http).max())
    limit = 0.02 * float(np.abs(over_http).max())
    if worst > limit or over_grpc.argmax() != over_http.argmax():
        raise AssertionError(f"ResNet-50 over gRPC: {worst} from HTTP's answer (limit {limit})")
    if over_grpc.tobytes() != over_http.tobytes():
        raise AssertionError("ResNet-50 at batch 1 over gRPC is not bit-equal to HTTP's")
    after = stats()
    booked = {m: after[m] - before[m] for m in sent}
    if booked != sent:
        raise AssertionError(f"the server booked {booked} for {sent} requests")
    client.close()
    checks.update(booked=booked, resnet_top1=int(over_grpc.argmax()),
                  resnet_grpc_vs_http_max_abs=worst, wall_s=time.perf_counter() - t0)
    yield checks


def _grpc_mux_task(barrier, plain_url, tls_url, roots, image, worker=0):
    """Phase 13a from a client process: the port's sync and aio gRPC
    clients in stream mode against unary, in plaintext and over TLS
    (``simple``, ``identity_fp32`` at 4 MiB, one ResNet-50 image, each
    bit-equal), sixteen 4 MiB identities in turn each way (p50 ms and
    MiB/s: what TLS costs the payload), then sixteen ``simple`` requests behind one held 3 s on
    the shared stream (sync, then aio): every one answers before the
    held one, each under 0.5 s."""
    import numpy as np

    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.grpc.aio as grpcaio

    barrier.wait(300)
    t0 = time.perf_counter()
    big = np.random.default_rng(13).normal(size=[1 << 20]).astype(np.float32)
    a = np.arange(16, dtype=np.int32)[None]
    ones = np.ones([4], np.float32)

    def tensor(mod, name, arr, datatype):
        return mod.InferInput(name, list(arr.shape), datatype).set_data_from_numpy(arr)

    def requests(mod):
        return {"simple": ("simple", [tensor(mod, "INPUT0", a, "INT32"),
                                      tensor(mod, "INPUT1", a, "INT32")]),
                "identity_4mib": ("identity_fp32", [tensor(mod, "INPUT0", big, "FP32")]),
                "resnet50": ("resnet50", [tensor(mod, "INPUT", image, "FP32")])}

    def answers(results):
        return {key: sorted((out.name, result.as_numpy(out.name).tobytes())
                            for out in result.get_response().outputs)
                for key, result in results.items()}

    async def aio_answers(url, tls, stream_mode):
        client = grpcaio.InferenceServerClient(url, stream_mode=stream_mode, **tls)
        try:
            return answers({key: await client.infer(model, inputs)
                            for key, (model, inputs) in requests(grpcaio).items()})
        finally:
            await client.close()

    checks = {}
    for label, url, tls in (("plain", plain_url, {}),
                            ("tls", tls_url, {"ssl": True, "root_certificates": roots})):
        got = {}
        for mode in (False, True):
            with grpcclient.InferenceServerClient(url, stream_mode=mode, **tls) as client:
                got[f"sync_{mode}"] = answers({
                    key: client.infer(model, inputs)
                    for key, (model, inputs) in requests(grpcclient).items()})
            got[f"aio_{mode}"] = asyncio.run(aio_answers(url, tls, mode))
        first = got["sync_False"]
        if first["simple"] != [("OUTPUT0", (a + a).tobytes()), ("OUTPUT1", (a - a).tobytes())]:
            raise AssertionError(f"{label}: simple is not exact")
        if first["identity_4mib"] != [("OUTPUT0", big.tobytes())]:
            raise AssertionError(f"{label}: identity_fp32 at 4 MiB is not bit-exact")
        differ = [key for key, value in got.items() if value != first]
        if differ:
            raise AssertionError(f"{label}: {differ} differ from the sync client's unary answers")
        checks[f"{label}_bit_equal"] = sorted(got)
        # what TLS costs a 4 MiB inline round trip: 16 in turn, unary
        with grpcclient.InferenceServerClient(url, **tls) as client:
            model, inputs = requests(grpcclient)["identity_4mib"]
            client.infer(model, inputs)
            times = []
            for _ in range(16):
                t = time.perf_counter()
                client.infer(model, inputs)
                times.append(time.perf_counter() - t)
        checks[f"{label}_4mib_ms_p50"] = 1e3 * percentile(times, 0.5)
        checks[f"{label}_4mib_mib_s"] = 4 * len(times) / sum(times)

    def held_first(done, label):
        order = [name for name, _ in done]
        quick = [seconds for name, seconds in done if name != "held"]
        held = dict(done).get("held", 0.0)
        if order[-1] != "held" or len(quick) != 16 or held < 3.0 or max(quick) >= 0.5:
            raise AssertionError(f"{label}: not answered out of order behind the hold: {done}")
        checks[f"{label}_held_s"] = held
        checks[f"{label}_behind_ms_max"] = 1e3 * max(quick)

    simple = requests(grpcclient)["simple"][1]
    with grpcclient.InferenceServerClient(plain_url, stream_mode=True) as client:
        client.infer("simple", simple)  # the stream is open
        done = []

        def one(name, model, inputs, **kwargs):
            t = time.perf_counter()
            client.infer(model, inputs, **kwargs)
            done.append((name, time.perf_counter() - t))

        holder = threading.Thread(target=one, args=(
            "held", "grpc_hold", [tensor(grpcclient, "INPUT0", ones, "FP32")]),
            kwargs={"parameters": {"hold_s": 3.0}})
        holder.start()
        time.sleep(0.3)
        quick = [threading.Thread(target=one, args=(f"q{i}", "simple", simple))
                 for i in range(16)]
        for thread in quick:
            thread.start()
        for thread in quick + [holder]:
            thread.join(30)
    held_first(done, "sync")

    async def aio_held():
        client = grpcaio.InferenceServerClient(plain_url, stream_mode=True)
        inputs = requests(grpcaio)["simple"][1]
        await client.infer("simple", inputs)
        done = []

        async def one(name, model, inputs, **kwargs):
            t = time.perf_counter()
            await client.infer(model, inputs, **kwargs)
            done.append((name, time.perf_counter() - t))

        held = asyncio.ensure_future(one("held", "grpc_hold",
                                         [tensor(grpcaio, "INPUT0", ones, "FP32")],
                                         parameters={"hold_s": 3.0}))
        await asyncio.sleep(0.3)
        await asyncio.gather(held, *(one(f"q{i}", "simple", inputs) for i in range(16)))
        await client.close()
        return done

    held_first(asyncio.run(aio_held()), "aio")
    checks["wall_s"] = time.perf_counter() - t0
    yield checks


CHAOS_SIMPLE = 100
CHAOS_IMAGES = 64
CHAOS_PROCS = 4
CHAOS_ROUNDS = ("errors", "cuts", "errors_no_policy")


def _chaos_task(barrier, runs, worker, images):
    """Phase 14c's client process: for each ``(url, with_policy)`` of
    ``runs``, once every process is ready, ``CHAOS_SIMPLE / CHAOS_PROCS``
    ``simple`` requests (checked exactly) and then ``images`` through
    ``image_classifier`` over inline binary, with the reference's chaos
    retry policy or none. Without a policy the first failure ends the run
    and its status goes back."""
    import numpy as np

    from client_tpu_torch.resilience import RetryPolicy
    from client_tpu_torch.utils import InferenceServerException

    for url, with_policy in runs:
        policy = (RetryPolicy(max_attempts=10, initial_backoff_s=0.001, max_backoff_s=0.002)
                  if with_policy else None)
        wrong, answers, failed = 0, {}, None
        with client_http.InferenceServerClient(url, network_timeout=600,
                                               retry_policy=policy) as client:
            barrier.wait(300)
            try:
                for i in range(CHAOS_SIMPLE // CHAOS_PROCS):
                    a = (np.arange(16, dtype=np.int32) + 100 * worker + i).reshape(1, 16)
                    b = np.full([1, 16], 3, dtype=np.int32)
                    x = client_http.InferInput("INPUT0", [1, 16], "INT32")
                    x.set_data_from_numpy(a)
                    y = client_http.InferInput("INPUT1", [1, 16], "INT32")
                    y.set_data_from_numpy(b)
                    result = client.infer("simple", [x, y])
                    if not ((result.as_numpy("OUTPUT0") == a + b).all()
                            and (result.as_numpy("OUTPUT1") == a - b).all()):
                        wrong += 1
                for i, image in images.items():
                    x = client_http.InferInput("INPUT", list(image.shape), "FP32")
                    x.set_data_from_numpy(image)
                    answers[i] = client.infer("image_classifier", [x]).as_numpy("OUTPUT")
            except InferenceServerException as e:
                if with_policy:
                    raise
                failed = {"status": e.status(), "message": e.message()[:120]}
        yield {"wrong": wrong, "answers": answers, "failed": failed}


CLIENT_TASKS = {"load": _load_task, "correctness": _correctness_task,
                "grpc_correctness": _grpc_correctness_task, "grpc_mux": _grpc_mux_task,
                "chaos": _chaos_task}


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
    spilled = tempfile.TemporaryDirectory()
    procs = [ctx.Process(target=_client_main, daemon=True,
                         args=(task, _spill(args, spilled.name), barrier, results))
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
        spilled.cleanup()
    if any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"client exit codes {[p.exitcode for p in procs]}")


@timed_phase("8a")
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


@timed_phase("8b")
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


@timed_phase("8c")
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
# short windows: three of 0.5 s, stable within 50 % (2 s before the
# script had to make room for phase 17 inside its time limit)
HARNESS_WINDOW_MS = 500
HARNESS_WINDOWS = ["--measurement-interval", str(HARNESS_WINDOW_MS), "--max-trials", "3",
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


def perf_run(port, model, args, server_times=True, url=None) -> dict:
    """One run of the port's perf-analyzer against ``model`` with ``args``:
    its ``--json-summary``, CSV rows and profile export, held to the
    guards (no error, every completed request booked by the server,
    non-zero server queue and compute times in every row, unless
    ``server_times`` is off, no region left registered). The harness's
    stdout is kept under ``stdout``. ``url`` (default: the HTTP ``port``)
    is where the harness sends; the guards read the HTTP routes."""
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, export_path = os.path.join(tmp, "out.csv"), os.path.join(tmp, "export.json")
        before = _stats(port, model)
        t0 = time.perf_counter()
        out = _harness("client_tpu_torch.perf", [
            "-m", model, "-u", url or f"127.0.0.1:{port}", *HARNESS_WINDOWS, *args,
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
        profiler = InferenceProfiler(manager, measurement_interval_s=HARNESS_WINDOW_MS / 1e3,
                                     stability_pct=50.0, max_trials=3)
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


@timed_phase("9a-9b")
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
    return {"rows": rows, "north_star_ratio": north_star, "open": result,
            "wall_s": time.perf_counter() - t0}


@timed_phase("9c")
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


@timed_phase("9d")
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
            "--output-tokens-mean", str(SERVE_TOKENS), "--measurement-interval", "2000",
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


@timed_phase("10c")
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


def _profile_child(conn, started) -> None:
    """The server process of phase 10d (``multiprocessing`` spawn);
    ``started`` is the parent's ``time.monotonic()`` at its spawn."""
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
            print(f"profile 10d: the server process up in {time.monotonic() - started:.1f} s",
                  flush=True)
            conn.send(("ok", thread_profile(port, images)))
    except BaseException as e:  # noqa: BLE001 - reported to, and raised by, the parent
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


@timed_phase("10d")
def server_thread_profile() -> dict:
    """Phase 10d in a server process of its own: phase 7b's ResNet-50
    (the same seed-0 weights) behind ``http_server`` in a spawned process
    that holds nothing else, as a deployed server would, so that a crash
    of the capture fails the phase and not the script. The crash is
    inside CUPTI: a 2 s CUDA capture under this load killed a fresh
    server process in about one window in eleven, always in a
    ``libcupti`` worker thread freeing corrupt memory (SIGSEGV, SIGABRT
    from "double free or corruption"), and so did a bare loop of
    ResNet-50 forwards on one thread with no server (NVIDIA H100 80GB
    HBM3, 700 W; PERF.md holds the sweep, ``profile_sweep.py`` reruns
    the control)."""
    import multiprocessing

    context = multiprocessing.get_context("spawn")
    parent, child = context.Pipe(duplex=False)
    proc = context.Process(target=_profile_child, args=(child, time.monotonic()))
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
    run (``-b 1``, c=8, TPU shm, three 4 s windows) with
    ``--profile-server``; once the load is on, ``/v2/debug/profile`` for
    2 s with a ``torch.profiler`` Chrome trace under the temp directory,
    the load still on when the route answers (the trace's export takes
    longer than its window). One capture: under this load a CUDA capture
    kills the process in about one window in eleven, inside CUPTI (see
    :func:`server_thread_profile`). Prints the stage CPU table, the five
    stacks with the most samples, each thread's share of samples not
    parked, and the trace's CUDA kernel events, which must exist, with
    its kernel ms and the requests served while the route ran. Then
    ``/v2/debug/requests`` must return
    slowest exemplars, and ``trace_rate`` 1 must write five-stamp
    records."""
    import numpy as np

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    base = _stats(port, "image_classifier")["inference_stats"]["success"]["count"]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.perf", "-m", "image_classifier",
             "-u", f"127.0.0.1:{port}", "-b", "1", "--concurrency-range", "8",
             "--shared-memory", "tpu", "--profile-server", "--measurement-interval",
             "4000", "--max-trials", "3", "--stability-percentage", "50",
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
            served = _stats(port, "image_classifier")["inference_stats"]["success"]["count"]
            t0 = time.monotonic()
            status, headers, collapsed = _http(
                port, f"/v2/debug/profile?duration_s=2&hz=99&jax_trace_dir={trace_dir}")
            answered_s = time.monotonic() - t0
            served = (_stats(port, "image_classifier")["inference_stats"]["success"]["count"]
                      - served)
            if proc.poll() is not None:
                raise AssertionError("the 10d load ended before the profile route answered")
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
          f"{kernel_ms:.1f} ms of kernel time in the 2 s window; {served} requests served "
          f"while the route ran, which answered in {answered_s:.2f} s [{card()}]", flush=True)

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
              "requests_during_capture": served, "capture_answered_s": answered_s,
              "slowest_total_us": slowest[0]["total_us"], "trace_records": len(records)}
    print("profile 10d: " + json.dumps({k: v for k, v in result.items() if k != "top_stacks"})
          + f" [{card()}]", flush=True)
    return result


@timed_phase("10a")
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


@timed_phase("10b")
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


# ---------------------------------------------------------------------------
# phase 11: lifecycle, admission and repository control, the compat routes
# ---------------------------------------------------------------------------


def _index_entry(port, name) -> tuple:
    """(state, reason) of ``name`` in ``POST /v2/repository/index``."""
    status, _, text = _http(port, "/v2/repository/index", "POST")
    if status != 200:
        raise AssertionError(f"/v2/repository/index answered {status}: {text[:200]}")
    entry = {m["name"]: m for m in json.loads(text)}[name]
    return entry["state"], entry["reason"]


def _wait_for_entry(port, name, want, timeout_s=300.0) -> float:
    """Poll the index until ``name`` reads ``want``; returns the seconds."""
    t0 = time.perf_counter()
    while _index_entry(port, name) != want:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{name} never reached {want}: {_index_entry(port, name)}")
        time.sleep(0.005)
    return time.perf_counter() - t0


# a greedy bf16 stream may leave phase 4's only where the dense forward's
# two leading logits lie within this share of its largest |logit| (4 bf16
# ulps): there the batch a step ran in decides the token (phase 5's own
# stream 0 leaves phase 4's at index 18 in some runs)
TIE_SHARE = 2.0 ** -6


def _same_or_tie(params, config, prompt, want, got) -> dict:
    """``got`` equals ``want`` (phase 4's stream for ``prompt``), or the
    two part at a near-tie: at their first differing index the dense
    forward over the prompt and ``want``'s tokens before it ranks both
    tokens first and second within ``TIE_SHARE`` of its largest |logit|.
    Raises otherwise; returns where and by how much they part."""
    from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer

    k = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if k is None and len(want) == len(got):
        return {}
    if k is None:
        raise AssertionError(f"stream lengths {len(got)} and {len(want)}")
    ids = SyntheticTokenizer(config.vocab_size).encode(prompt) + list(want[:k])
    tokens = torch.tensor([ids], dtype=torch.int32, device=DEVICE)
    with torch.inference_mode():
        cache = llama.init_kv_cache(config, 1, max_len=len(ids), device=DEVICE)
        logits = llama.prefill_with_cache(params, tokens, cache, config)[0][0].float()
    top2 = [int(t) for t in logits.topk(2).indices]
    gap = abs(float(logits[want[k]] - logits[got[k]]))
    scale = float(logits.abs().max())
    if sorted(top2) != sorted([want[k], got[k]]) or gap > TIE_SHARE * scale:
        raise AssertionError(f"a stream left phase 4's at index {k}: tokens {want[k]} / "
                             f"{got[k]}, dense top-2 {top2}, gap {gap:.4f} of {scale:.2f}")
    return {"index": k, "gap_share": gap / scale}


@timed_phase("11a")
def lifecycle_7b(port, model, config, plain_streams) -> dict:
    """Phase 11a on phase 4's server: the 8 streams again; after their
    first tokens ``llm_engine`` is unloaded. While the unload drains, a
    new stream is refused with 503 and the OpenAI error body and the index
    reads UNLOADING, then "unloaded"; the 8 streams finish equal to phase
    4's. The programmatic re-warm (``POST .../load``) builds a new pool
    and closes the old engine after its probes; the 8 streams once more
    equal phase 4's. K1's counter is zeroed around both runs, and every
    KV block comes back."""
    t_phase = time.perf_counter()
    old = model.engine
    steps0 = old.steps
    gc.collect()
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    prompts = _prompts()
    records = [dict() for _ in prompts]
    started = [threading.Event() for _ in prompts]
    threads = [threading.Thread(target=_stream_one, args=(port, p, SERVE_TOKENS, r),
                                kwargs={"started": e})
               for p, r, e in zip(prompts, records, started)]
    # -- the main path: counters zeroed just before, read just after --
    pa.paged_attention_cuda.launches = 0
    for thread in threads:
        thread.start()
    for event in started:
        if not event.wait(300):
            raise AssertionError(f"a stream gave no first token: {records}")
    t_unload = time.perf_counter()
    status, _, text = _http(port, "/v2/repository/models/llm_engine/unload", "POST")
    if status != 200:
        raise AssertionError(f"unload answered {status}: {text[:200]}")
    unloading = _index_entry(port, "llm_engine")
    refused = _http(port, "/v1/chat/completions", "POST",
                    {"model": "llm_engine", "stream": True, "max_tokens": 4,
                     "messages": [{"role": "user", "content": prompts[0]}]})
    unload_s = time.perf_counter() - t_unload + _wait_for_entry(
        port, "llm_engine", ("UNAVAILABLE", "unloaded"))
    for thread in threads:
        thread.join(600)
    if unloading != ("UNLOADING", "unloading"):
        raise AssertionError(f"the index read {unloading} while the unload drained")
    body = json.loads(refused[2])
    if refused[0] != 503 or "not ready" not in body.get("error", {}).get("message", ""):
        raise AssertionError(f"a stream during the unload got {refused[0]}: {refused[2][:200]}")
    ties = {}
    for i, record in enumerate(records):
        if record.get("status") != 200 or not record.get("done"):
            raise AssertionError(f"stream {i} in flight at the unload failed: {record}")
        tie = _same_or_tie(model._params, config, prompts[i], plain_streams[i],
                           record["tokens"])
        if tie:
            ties[f"in_flight_{i}"] = tie
    old_steps = old.steps - steps0
    old_blocks = old.allocator.blocks_in_use
    del old
    torch.cuda.reset_peak_memory_stats()
    t_load = time.perf_counter()
    status, _, text = _http(port, "/v2/repository/models/llm_engine/load", "POST")
    load_s = time.perf_counter() - t_load
    if status != 200 or _index_entry(port, "llm_engine") != ("READY", ""):
        raise AssertionError(f"load answered {status}: {text[:200]}")
    engine = model.engine
    steps1 = engine.steps
    again, wall = stream_all(port, SERVE_TOKENS, config.vocab_size)
    launches = pa.paged_attention_cuda.launches
    # -------------------------------------------------------------------
    decode_steps = old_steps + engine.steps - steps1
    if launches < config.n_layers * decode_steps:
        raise AssertionError(f"K1 launched {launches} times for {decode_steps} decode steps "
                             f"x {config.n_layers} layers")
    for i, record in enumerate(again):
        tie = _same_or_tie(model._params, config, prompts[i], plain_streams[i],
                           record["tokens"])
        if tie:
            ties[f"reloaded_{i}"] = tie
    peak_bytes = torch.cuda.max_memory_allocated()
    deadline = time.monotonic() + 60
    while engine.allocator.blocks_in_use and time.monotonic() < deadline:
        time.sleep(0.05)
    if old_blocks or engine.allocator.blocks_in_use:
        raise AssertionError(f"KV blocks leaked: {old_blocks} in the old engine, "
                             f"{engine.allocator.blocks_in_use} in the new")
    del engine
    gc.collect()
    torch.cuda.synchronize()
    after_bytes = torch.cuda.memory_allocated()
    # the old engine's pool goes once nothing names it: a reload that
    # kept it would hold a second 16 GiB pool for good
    if after_bytes > before_bytes + 2**30:
        raise AssertionError(f"{(after_bytes - before_bytes) / 2**30:.2f} GiB more allocated "
                             f"after the reload than before the unload")
    result = {"unload_to_unloaded_ms": unload_s * 1e3, "load_s": load_s,
              "peak_gib_across_reload": peak_bytes / 2**30,
              "allocated_gib_before_unload": before_bytes / 2**30,
              "allocated_gib_after_reload": after_bytes / 2**30,
              "decode_steps": decode_steps, "k1_launches": launches,
              "refused_status": refused[0], "tokens_per_s_after_reload":
              sum(len(r["tokens"]) for r in again) / wall,
              "streams_equal_to_phase_4": 16 - len(ties), "parted_at_near_ties": ties,
              "wall_s": time.perf_counter() - t_phase}
    print("lifecycle 11a: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


# the model directory phases 11b-11e serve from: create_model() takes the
# server's --device through its device keyword
RESNET_MODEL_PY = """
from client_tpu_torch.models import resnet
from client_tpu_torch.models.serving import ImageClassifierModel


def create_model(device):
    model = ImageClassifierModel(image_size=224, config=resnet.resnet50(), device=device)
{extra}    return model
"""
SCHED_DECLARATIONS = """    model.priority_levels = 2
    model.queue_policy = {"max_queue_size": 16, "timeout_action": "continue"}
    model.rate_limiter = {"resources": [{"name": "card", "count": 1}]}
"""
# 11e holds the drain open with one request that sleeps ``hold_s`` on the
# server, so that the probes and the harness see the draining server
HOLD_MODEL_PY = """
import time

from client_tpu_torch.server.models import IdentityModel


class Hold(IdentityModel):
    def execute(self, inputs, parameters):
        time.sleep(float(parameters.get("hold_s", 0)))
        return super().execute(inputs, parameters)


def create_model(device):
    return Hold(device=device)
"""


def _one_window(args) -> dict:
    """One 2 s window (``--max-trials 1``) of the port's perf-analyzer in
    a subprocess that cannot see the card; its ``--json-summary``."""
    out = _harness("client_tpu_torch.perf", [*args, "--measurement-interval", "2000",
                                              "--max-trials", "1", "--json-summary"])
    return json.loads(out.strip().splitlines()[-1])


def _image_answer(port, model, image):
    import numpy as np

    with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
        x = client_http.InferInput("INPUT", list(image.shape), "FP32")
        x.set_data_from_numpy(image, binary_data=True)
        out = client_http.InferRequestedOutput("OUTPUT", binary_data=True)
        return np.asarray(client.infer(model, [x], outputs=[out]).as_numpy("OUTPUT"))


def _metric_sum(port, name, match) -> float:
    from client_tpu_torch.observability.metrics import counter_total

    return counter_total(_scrape(port).get(name), match)


@timed_phase("11b")
def compat_11b(port, image) -> dict:
    """11b: one image through KServe binary, TFS ``:predict`` and
    TorchServe ``/predictions``; the harness's tfserving, torchserve and
    KServe kinds, one 2 s window each at c=8."""
    import numpy as np

    kserve = _image_answer(port, "resnet50", image).reshape(-1)
    status, _, text = _http(port, "/v1/models/resnet50:predict", "POST",
                            {"instances": image.tolist()})
    if status != 200:
        raise AssertionError(f"TFS :predict answered {status}: {text[:200]}")
    tfs = np.asarray(json.loads(text)["predictions"], dtype=np.float32).reshape(-1)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/predictions/resnet50", body=image.tobytes(),
                     headers={"Content-Type": "application/octet-stream"})
        response = conn.getresponse()
        payload = response.read()
    finally:
        conn.close()
    if response.status != 200:
        raise AssertionError(f"TorchServe answered {response.status}: {payload[:200]}")
    torchserve = np.asarray(json.loads(payload), dtype=np.float32).reshape(-1)
    tol = 2e-2 * float(np.abs(kserve).max())
    errs = {}
    for kind, answer in (("tfserving", tfs), ("torchserve", torchserve)):
        err = float(np.abs(answer - kserve).max())
        if not (answer.shape == kserve.shape and err <= tol
                and int(answer.argmax()) == int(kserve.argmax())):
            raise AssertionError(f"{kind}: max err {err} (limit {tol}), top-1 "
                                 f"{int(answer.argmax())} vs {int(kserve.argmax())}")
        errs[kind] = err / tol
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "data"), "wb") as f:
            f.write(image.tobytes())
        url = f"127.0.0.1:{port}"
        for kind, extra in (("tfserving", ["--shape", "INPUT:1,224,224,3"]),
                            ("torchserve", ["--input-data", tmp]),
                            ("kserve", [])):
            summary = _one_window(["-m", "resnet50", "-u", url, "--service-kind", kind,
                                   "--concurrency-range", "8", *extra])
            if summary["errors"] or not summary["count"]:
                raise AssertionError(f"harness --service-kind {kind}: {summary}")
            rows[kind] = {"infer_per_s": summary["throughput"],
                          "p50_ms": summary["p50_us"] / 1e3, "p99_ms": summary["p99_us"] / 1e3}
    result = {"rows": rows, "err_share_of_limit": errs}
    print("compat 11b: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("11c")
def admission_11c(port) -> dict:
    """11c: the harness at c=32 on ``resnet50_sched`` (2 priority levels,
    a queue of 16 with the "continue" action, one ``card`` resource)."""
    match = {"model": "resnet50_sched"}
    before = _metric_sum(port, "tpu_queue_rejected_total", match)
    stats0 = _stats(port, "resnet50_sched")
    summary = _one_window(["-m", "resnet50_sched", "-u", f"127.0.0.1:{port}",
                           "--concurrency-range", "32", "--request-priority", "1,2",
                           "--queue-timeout-us", "2000000"])
    rise = _metric_sum(port, "tpu_queue_rejected_total", match) - before
    failed = _booked(stats0, _stats(port, "resnet50_sched"), "fail")
    p99 = summary.get("per_priority_p99_us", {})
    state = json.loads(_http(port, "/v2/debug/state")[2])
    pool = state["rate_limiter"].get("card")
    # the harness counts the 429s of the requests that completed inside
    # its window; the counter counts every one, those at the window's two
    # edges (at most the 32 in flight at each) included
    if not (0 < summary["rejected"] <= rise <= summary["rejected"] + 64):
        raise AssertionError(f"429s: the harness's window counted {summary['rejected']}, "
                             f"tpu_queue_rejected_total rose {rise}")
    if rise != failed:
        raise AssertionError(f"tpu_queue_rejected_total rose {rise}, the statistics' fail "
                             f"count {failed}")
    if summary["errors"] != summary["rejected"] + summary["timeouts"]:
        raise AssertionError(f"errors other than admission rejections: {summary}")
    if not ("1" in p99 and "2" in p99 and p99["1"] <= p99["2"]):
        raise AssertionError(f"priority-1 p99 above priority-2's: {p99}")
    if pool != {"capacity": 1, "used": 0, "waiters": 0}:
        raise AssertionError(f"the card resource did not come back: {pool}")
    result = {"infer_per_s": summary["throughput"], "rejected_in_window": summary["rejected"],
              "rejected_counter_rise": rise, "shed_rate": summary["shed_rate"],
              "p99_ms_by_priority": {k: v / 1e3 for k, v in p99.items()},
              "card_pool_after": pool}
    print("admission 11c: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("11d")
def rolling_11d(port, image, plain) -> dict:
    """11d: ``--rolling-restart 1`` on ``resnet50`` at c=8 for 6 s: every
    cycle reloads the directory model on the card; one cycle by hand
    first times the load, which stalls the serving loop for the model's
    warmup (the reference's design). ``plain`` is 11b's KServe row, the
    same load without cycles."""
    import numpy as np

    from client_tpu_torch.models import resnet

    # one copy of the weights: what the model's init allocates on the card
    allocated = torch.cuda.memory_allocated()
    params = resnet.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                                resnet.resnet50(), DEVICE)
    weight_bytes = torch.cuda.memory_allocated() - allocated
    del params
    torch.cuda.empty_cache()
    probe = _image_answer(port, "resnet50", image)
    memory = {"device": "cuda:0"}
    mem0 = _metric_sum(port, "tpu_device_memory_bytes", memory)
    status, _, text = _http(port, "/v2/repository/models/resnet50/unload", "POST")
    if status != 200:
        raise AssertionError(f"unload answered {status}: {text[:200]}")
    _wait_for_entry(port, "resnet50", ("UNAVAILABLE", "unloaded"), 60)
    t0 = time.perf_counter()
    status, _, text = _http(port, "/v2/repository/models/resnet50/load", "POST")
    stall_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"load answered {status}: {text[:200]}")
    url = f"127.0.0.1:{port}"
    out = _harness("client_tpu_torch.perf", [
        "-m", "resnet50", "-u", url, "--concurrency-range", "8", "--rolling-restart", "1",
        "--measurement-interval", "6000", "--max-trials", "1", "--json-summary"])
    rolled = json.loads(out.strip().splitlines()[-1])
    after = _image_answer(port, "resnet50", image)
    mem1 = _metric_sum(port, "tpu_device_memory_bytes", memory)
    if rolled.get("rolling_restart_cycles", 0) < 3:
        raise AssertionError(f"{rolled.get('rolling_restart_cycles')} rolling-restart cycles")
    if rolled["errors"] != rolled["dropped_unavailable"]:
        raise AssertionError(f"failures without a 503/UNAVAILABLE token: {rolled}")
    if not np.array_equal(probe, after):
        raise AssertionError(f"the probe's answer moved across the reloads: max diff "
                             f"{float(np.abs(probe - after).max())}")
    if mem1 - mem0 > weight_bytes:
        raise AssertionError(f"device memory grew {mem1 - mem0} bytes, more than one copy of "
                             f"the weights ({weight_bytes})")
    result = {"cycles": rolled["rolling_restart_cycles"], "unavailable": rolled["errors"],
              "rerouted": rolled["rerouted"], "infer_per_s": rolled["throughput"],
              "p99_ms_during_cycles": rolled["p99_us"] / 1e3,
              "p99_ms_without": plain["p99_ms"],
              "infer_per_s_without": plain["infer_per_s"], "load_stall_ms": stall_ms,
              "memory_growth_bytes": mem1 - mem0, "weight_bytes": weight_bytes,
              "report_line": next((line for line in out.splitlines()
                                   if line.startswith("Rolling restart:")), "")}
    print("rolling 11d: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("11e")
def drain_11e(proc, port, log) -> dict:
    """11e: SIGTERM under a c=8 harness load on ``resnet50``. One request
    to ``drain_hold`` that sleeps 4 s on the server holds the drain open:
    meanwhile readiness answers 503 with ``Retry-After``, liveness 200,
    and the harness's requests 503. The process must exit 0 inside its
    20 s drain timeout, its log holding ``drain_started`` and
    ``drain_completed`` with ``drained: true``."""
    import signal

    import numpy as np

    url = f"127.0.0.1:{port}"
    base = _stats(port, "resnet50")["inference_stats"]["success"]["count"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    harness = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.perf", "-m", "resnet50", "-u", url,
         "--concurrency-range", "8", "--measurement-interval", "3000", "--max-trials", "1",
         "--json-summary"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    held = {}

    def hold():
        try:
            with client_http.InferenceServerClient(url, network_timeout=60) as client:
                x = client_http.InferInput("INPUT0", [4], "FP32")
                x.set_data_from_numpy(np.arange(4, dtype=np.float32))
                held["answer"] = client.infer("drain_hold", [x], parameters={"hold_s": 4.0}
                                              ).as_numpy("OUTPUT0").tolist()
        except Exception as e:  # noqa: BLE001 - reported below
            held["error"] = repr(e)

    try:
        deadline = time.monotonic() + 120
        while _stats(port, "resnet50")["inference_stats"]["success"]["count"] < base + 50:
            if time.monotonic() > deadline or harness.poll() is not None:
                raise AssertionError("the harness's load never reached the server")
            time.sleep(0.05)
        holder = threading.Thread(target=hold)
        holder.start()
        time.sleep(0.3)  # the held request is in flight
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        ready = _http(port, "/v2/health/ready")
        live = _http(port, "/v2/health/live")
        out, err = harness.communicate(timeout=120)
        holder.join(60)
        code = proc.wait(30)
        exit_ms = (time.perf_counter() - t_sig) * 1e3
    finally:
        if harness.poll() is None:
            harness.kill()
            harness.wait()
    if harness.returncode != 0:
        raise AssertionError(f"harness exited {harness.returncode}: {out[-1000:]}{err[-1000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    if ready[0] != 503 or "Retry-After" not in ready[1] or live[0] != 200:
        raise AssertionError(f"while draining: ready {ready[0]} {ready[1]}, live {live[0]}")
    if held.get("answer") != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"the request in flight at SIGTERM: {held}")
    if summary["errors"] != summary["dropped_unavailable"] or not summary["count"]:
        raise AssertionError(f"the harness saw errors other than 503: {summary}")
    events = [json.loads(line) for line in log if line.startswith("{")]
    names = [e["event"] for e in events]
    completed = [e for e in events if e["event"] == "drain_completed"]
    if code != 0 or exit_ms > 20e3:
        raise AssertionError(f"the server exited {code} after {exit_ms:.0f} ms")
    if not ("drain_started" in names and completed and completed[0]["drained"] is True
            and names.index("drain_started") < names.index("drain_completed")):
        raise AssertionError(f"the drain's log: {names}")
    result = {"sigterm_to_exit_ms": exit_ms, "ready_during_drain": ready[0],
              "retry_after": ready[1]["Retry-After"], "live_during_drain": live[0],
              "harness_errors_503": summary["errors"], "harness_count": summary["count"]}
    print("drain 11e: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("11b-11e")
def lifecycle_11(proc, port, log, reader) -> dict:
    """Phases 11b-11e on the spawned ResNet-50 server (:func:`resnet_server`),
    whose directory holds ``resnet50`` (ResNet-50's widths, 224 x 224,
    1000 classes, bf16, seed-0 weights), ``resnet50_sched`` (the same with
    two priority levels, a queue of 16 with the "continue" timeout action
    and one ``card`` rate-limiter resource) and the 11e ``drain_hold``
    identity; it drains for up to 20 s. 11e ends the server. The harness
    runs in subprocesses that cannot see the card."""
    import numpy as np

    if _http(port, "/v2/health/ready")[0] != 200:
        raise AssertionError("the spawned server is not ready")
    image = np.random.default_rng(0).normal(size=[1, 224, 224, 3]).astype(np.float32)
    compat = compat_11b(port, image)
    result = {"compat_11b": compat, "admission_11c": admission_11c(port),
              "rolling_11d": rolling_11d(port, image, compat["rows"]["kserve"])}
    result["drain_11e"] = drain_11e(proc, port, log)
    reader.join(30)
    return result


@timed_phase("11f")
def embedded_11f() -> dict:
    """11f: ``client_tpu_torch.server.embedded.start()`` in this process,
    on the card: one ``simple`` request through its binary wire (status,
    header length, body), exact."""
    import struct

    import numpy as np

    from client_tpu_torch.server import embedded

    a = np.arange(16, dtype=np.int32)[None]
    b = np.full([1, 16], 7, dtype=np.int32)
    head = json.dumps({"inputs": [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}}],
        "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}},
                    {"name": "OUTPUT1", "parameters": {"binary_data": True}}]}).encode()
    runner = embedded.start()
    try:
        answer = runner.infer("simple", head + a.tobytes() + b.tobytes(), len(head))
    finally:
        runner.shutdown()
    status, header_len = struct.unpack("<IQ", answer[:12])
    doc = json.loads(answer[12:12 + header_len])
    data = np.frombuffer(answer[12 + header_len:], dtype=np.int32)
    names = [o["name"] for o in doc["outputs"]]
    if status != 0 or names != ["OUTPUT0", "OUTPUT1"] or not (
            np.array_equal(data[:16], (a + b)[0]) and np.array_equal(data[16:], (a - b)[0])):
        raise AssertionError(f"embedded simple: status {status}, {doc}")
    result = {"status": status, "header_bytes": header_len, "body_bytes": len(answer) - 12}
    print("embedded 11f: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 12: the KServe v2 gRPC surface
# ---------------------------------------------------------------------------


async def _grpc_streams(grpc_port, id_lists, max_tokens, cancel_ids=None):
    """The streams of ``id_lists`` at once over ``ModelStreamInfer``
    through the port's aio client, and, given ``cancel_ids``, one more
    stream on them that the client cancels after its second token.
    Returns (records, the cancelled stream's tokens or None, wall
    seconds)."""
    import numpy as np

    import client_tpu_torch.grpc.aio as grpc_aio

    client = grpc_aio.InferenceServerClient(f"127.0.0.1:{grpc_port}")

    async def one(ids, n, cancel_after=None):
        x = grpc_aio.InferInput("INPUT_IDS", [len(ids)], "INT32")
        x.set_data_from_numpy(np.array(ids, dtype=np.int32))

        async def requests():
            yield {"model_name": "llm_engine", "inputs": [x], "parameters": {"max_tokens": n}}

        record = {"start": time.perf_counter(), "stamps": [], "tokens": []}
        iterator = client.stream_infer(requests())
        async for result, error in iterator:
            if error is not None:
                raise AssertionError(f"in-band stream error: {error}")
            out = result.as_numpy("OUTPUT_IDS")
            if out is not None and out.size:
                record["stamps"].append(time.perf_counter())
                record["tokens"].extend(int(t) for t in out.reshape(-1))
            if cancel_after is not None and len(record["tokens"]) >= cancel_after:
                iterator.cancel()
                break
            final = result.get_response().parameters.get("triton_final_response")
            if final is not None and final.bool_param:
                break
        return record

    t0 = time.perf_counter()
    cancelled = [] if cancel_ids is None else [one(cancel_ids, 256, cancel_after=2)]
    records = await asyncio.gather(*(one(ids, max_tokens) for ids in id_lists), *cancelled)
    wall = time.perf_counter() - t0
    await client.close()
    if cancel_ids is None:
        return records, None, wall
    return records[:-1], records[-1]["tokens"], wall


@timed_phase("12c")
def grpc_7b(port, model, config, plain_streams) -> dict:
    """Phase 12c on phase 4's server, after 11a: the native gRPC
    front-end on the same ``ServerCore`` and loop, the 8 streams of 32
    tokens over ``ModelStreamInfer`` through the port's aio client, and a
    ninth cancelled after two tokens. The streams equal phase 4's (or part
    at a dense-forward near-tie, 11a's rule), K1 launches 32 x decode
    steps, and every KV block comes back."""
    from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
    from client_tpu_torch.server.native_frontend import NativeGrpcFrontend

    core, loop = SERVING[port]
    frontend = NativeGrpcFrontend(core, loop)
    frontend.start("127.0.0.1", 0)
    tokenizer = SyntheticTokenizer(config.vocab_size)
    prompts = _prompts()
    try:
        engine = model.engine
        steps0 = engine.steps
        # -- the path of 12c: K1's counter zeroed just before, read once idle --
        pa.paged_attention_cuda.launches = 0
        records, cut, wall = asyncio.run(_grpc_streams(
            frontend.port, [tokenizer.encode(p) for p in prompts], SERVE_TOKENS,
            tokenizer.encode(prompts[2])))
        # the cancelled stream may still be mid-step: counting then would
        # split a step's 32 launches from its step count. Every KV block
        # must come back (a fault otherwise).
        _wait_idle(engine, timeout_s=30)
        launches = pa.paged_attention_cuda.launches
        # --------------------------------------------------------------------------
        steps = engine.steps - steps0
        del engine
    finally:
        frontend.stop()
    if launches != config.n_layers * steps:
        raise AssertionError(f"K1 launched {launches} times for {steps} decode steps x "
                             f"{config.n_layers} layers")
    if not 2 <= len(cut) < 256:
        raise AssertionError(f"the cancelled stream delivered {len(cut)} tokens")
    ties = []
    for prompt, want, record in zip(prompts, plain_streams, records):
        if len(record["tokens"]) != SERVE_TOKENS:
            raise AssertionError(f"a gRPC stream delivered {len(record['tokens'])} tokens")
        parted = _same_or_tie(model._params, config, prompt, want, record["tokens"])
        if parted:
            ties.append(parted)
    result = latency(records, wall)
    result.update(decode_steps=steps, k1_launches=launches, near_ties=ties,
                  cancelled_stream_tokens=len(cut))
    print("grpc 12c: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("12d")
def grpc_hold_12d(grpc_port) -> dict:
    """12d: one request to ``grpc_hold`` held 3 s on the server over gRPC;
    meanwhile ``simple`` over gRPC the whole time, each answer under
    0.5 s (the reference's one pump thread would hold them all)."""
    import numpy as np

    import client_tpu_torch.grpc as grpcclient

    url = f"127.0.0.1:{grpc_port}"
    held = {}

    def hold():
        with grpcclient.InferenceServerClient(url) as client:
            x = grpcclient.InferInput("INPUT0", [4], "FP32")
            x.set_data_from_numpy(np.ones([4], np.float32))
            t0 = time.perf_counter()
            client.infer("grpc_hold", [x], parameters={"hold_s": 3.0})
            held["s"] = time.perf_counter() - t0

    holder = threading.Thread(target=hold)
    holder.start()
    time.sleep(0.3)  # the held request is in flight
    a = np.arange(16, dtype=np.int32)[None]
    latencies = []
    with grpcclient.InferenceServerClient(url) as client:
        inputs = [grpcclient.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                  grpcclient.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(a)]
        while holder.is_alive():
            t0 = time.perf_counter()
            result = client.infer("simple", inputs)
            latencies.append(time.perf_counter() - t0)
            if not np.array_equal(result.as_numpy("OUTPUT0"), a + a):
                raise AssertionError("simple over gRPC is not exact")
    holder.join()
    result = {"held_s": held.get("s"), "simple_answers": len(latencies),
              "simple_ms_max": 1e3 * max(latencies),
              "simple_ms_p50": 1e3 * percentile(latencies, 0.5)}
    print("grpc 12d: " + json.dumps(result) + f" [{card()}]", flush=True)
    if held.get("s", 0) < 3.0 or len(latencies) < 10 or max(latencies) >= 0.5:
        raise AssertionError(f"head-of-line blocking over gRPC: {result}")
    return result


@timed_phase("12 (with 13a-13b)")
def grpc_12(started, tls_server) -> dict:
    """Phases 12a, 12b and 12d (and 13a-13b) on the spawned ResNet-50
    server (:func:`resnet_server`) with the native gRPC front-end: the
    built-ins, ``resnet50`` (ResNet-50's widths, 224 x 224, bf16, seed-0
    weights) and the ``grpc_hold`` identity. 12a runs in a client process,
    12b's harness in subprocesses that cannot see the card."""
    import numpy as np

    if started["grpc_frontend"] != "native":
        raise AssertionError(f"the gRPC front-end: {started}")
    http_port, grpc_port = started["http_port"], started["grpc_port"]
    image = np.random.default_rng(12).normal(size=[1, 224, 224, 3]).astype(np.float32)
    result = {}

    def on_round(go):
        (checks,), seconds = go()
        result["grpc_12a"] = checks

    with timed("12a"):
        run_client_processes("grpc_correctness", [{
            "url": f"127.0.0.1:{grpc_port}", "http_url": f"127.0.0.1:{http_port}",
            "image": image}], on_round)
    print("grpc 12a: " + json.dumps(result["grpc_12a"]) + f" [{card()}]", flush=True)
    runs = {}
    with timed("12b"):
        for route in ("none", "tpu"):
            for protocol in ("grpc", "http"):
                url = f"127.0.0.1:{grpc_port if protocol == 'grpc' else http_port}"
                run = perf_run(http_port, "resnet50", [
                    "-i", protocol, "-b", "1", "--concurrency-range", "8",
                    "--shared-memory", route], url=url)
                runs[f"{protocol}_{route}"] = {k: run[k] for k in (
                    "infer_per_s", "p50_ms", "p99_ms", "server_queue_us",
                    "server_compute_infer_us", "rows_per_execution", "completed")}
                print(f"grpc 12b: -i {protocol} --shared-memory {route}: "
                      + json.dumps(runs[f"{protocol}_{route}"]) + f" [{card()}]",
                      flush=True)
    result["grpc_12b"] = runs
    result["grpc_12d"] = grpc_hold_12d(grpc_port)
    result["grpc_13"] = grpc_13(tls_server, http_port, grpc_port, image, runs)
    return result


@timed_phase("11-13 (one spawned ResNet-50 server)")
def resnet_server() -> dict:
    """Phases 12-13, then 11b-11e, on one ``python -m
    client_tpu_torch.server --model-repository <dir> --grpc-port 0
    --drain-timeout 20`` spawned with the card (one start-up and one
    ResNet-50 load for both; 11e's drain ends it, so 11 comes last). 13's
    TLS server over the same directory starts beside it."""
    with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as certs:
        for name, text in (("resnet50", RESNET_MODEL_PY.format(extra="")),
                           ("resnet50_sched", RESNET_MODEL_PY.format(extra=SCHED_DECLARATIONS)),
                           ("drain_hold", HOLD_MODEL_PY), ("grpc_hold", HOLD_MODEL_PY)):
            os.makedirs(os.path.join(tmp, name))
            with open(os.path.join(tmp, name, "model.py"), "w") as f:
                f.write(text)
        cert, key = tls_pair(certs)
        tls = launch_server("--model-repository", tmp, "--grpc-port", "0",
                            "--grpc-tls-cert", cert, "--grpc-tls-key", key)
        proc = tls[0]
        try:
            proc, started, log, reader = spawn_server(
                "--model-repository", tmp, "--grpc-port", "0", "--drain-timeout", "20")
            result = {"grpc": grpc_12(started, (tls, cert))}
            result["lifecycle"] = lifecycle_11(proc, started["http_port"], log, reader)
        finally:
            for server in {proc, tls[0]}:
                if server.poll() is None:
                    server.kill()
                    server.wait()
    return result


# ---------------------------------------------------------------------------
# phase 13: the multiplexed stream, TLS, genai-perf's KServe endpoints
# ---------------------------------------------------------------------------


def tls_pair(directory) -> tuple:
    """A throwaway self-signed certificate and key (CN=localhost, SAN
    127.0.0.1) made with the ``openssl`` CLI, as the reference's TLS test
    makes its pair."""
    cert, key = os.path.join(directory, "cert.pem"), os.path.join(directory, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
                    "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost",
                    "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    return cert, key


def launch_server(*flags) -> tuple:
    """Start ``python -m client_tpu_torch.server`` with the card and
    ``flags``, without waiting: :func:`await_server` takes what this
    returns, so a server's start-up can overlap other phases."""
    proc = subprocess.Popen([sys.executable, "-m", "client_tpu_torch.server", "--http-port",
                             "0", "--host", "127.0.0.1", *flags], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, flags, time.perf_counter()


def spawn_server(*flags) -> tuple:
    """:func:`launch_server`, then :func:`await_server`."""
    return await_server(launch_server(*flags))


def await_server(launched) -> tuple:
    """A launched server once it serves: (process, its ``server_started``
    record, its log lines, the thread that goes on appending to them),
    read from the structured log on stderr, where the server announces
    itself. A server that exits before it starts fails the run with its
    log."""
    proc, flags, t0 = launched
    log = []
    for line in proc.stderr:
        log.append(line)
        if '"server_started"' in line:
            started = json.loads(line)
            print(f"server {' '.join(flags)}: up in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            reader = threading.Thread(target=lambda: log.extend(proc.stderr), daemon=True)
            reader.start()
            return proc, started, log, reader
    proc.wait()
    raise AssertionError(f"the server exited {proc.returncode} before it started: "
                         f"{''.join(log)[-2000:]}")


@timed_phase("13a-13b")
def grpc_13(tls_server, http_port, grpc_port, image, unary) -> dict:
    """Phases 13a-13b beside phase 12 on its server, and on a second one
    (``tls_server``: (launched server, its root certificate)) spawned
    over phase 12's repository with ``--grpc-tls-cert/key``; then the TLS
    server is killed under a request held on a multiplexed stream."""
    import numpy as np

    import client_tpu_torch.grpc as grpcclient
    from client_tpu_torch.resilience.policy import exception_is_retryable
    from client_tpu_torch.utils import InferenceServerException

    t0 = time.perf_counter()
    result = {}
    launched, cert = tls_server
    proc, started, _, _ = await_server(launched)
    try:
        tls_http, tls_grpc = started["http_port"], started["grpc_port"]
        result["tls_server_start_s"] = time.perf_counter() - t0
        plain_url, tls_url = f"127.0.0.1:{grpc_port}", f"127.0.0.1:{tls_grpc}"
        try:  # the TLS port refuses plaintext
            with grpcclient.InferenceServerClient(tls_url) as client:
                client.is_server_live(client_timeout=5)
            raise AssertionError("the TLS port answered a plaintext client")
        except InferenceServerException:
            pass

        def on_round(go):
            (checks,), seconds = go()
            result["grpc_13a"] = checks

        run_client_processes("grpc_mux", [{"plain_url": plain_url, "tls_url": tls_url,
                                           "roots": cert, "image": image}], on_round)
        print("grpc 13a: " + json.dumps(result["grpc_13a"]) + f" [{card()}]", flush=True)
        rows = {}
        keys = ("infer_per_s", "p50_ms", "p99_ms", "server_queue_us",
                "server_compute_infer_us", "rows_per_execution", "completed")
        for route in ("none", "tpu"):
            run = perf_run(http_port, "resnet50", [
                "-i", "grpc", "--stream-mode", "-b", "1", "--concurrency-range", "8",
                "--shared-memory", route], url=plain_url)
            rows[f"stream_mode_{route}"] = {k: run[k] for k in keys}
            print(f"grpc 13b: -i grpc --stream-mode --shared-memory {route}: "
                  + json.dumps(rows[f"stream_mode_{route}"]) + f" (12b unary: "
                  + json.dumps(unary[f"grpc_{route}"]) + f") [{card()}]", flush=True)
        run = perf_run(tls_http, "resnet50", [
            "-i", "grpc", "-b", "1", "--concurrency-range", "8", "--shared-memory", "none",
            "--ssl-grpc-root-certifications-file", cert], url=tls_url)
        rows["tls_none"] = {k: run[k] for k in keys}
        print("grpc 13b: -i grpc over TLS --shared-memory none: "
              + json.dumps(rows["tls_none"]) + " (12b plaintext unary: "
              + json.dumps(unary["grpc_none"]) + f") [{card()}]", flush=True)
        result["grpc_13b"] = rows

        # a server killed under the stream: the held request fails,
        # retryably, and nothing hangs
        outcome = {}
        client = grpcclient.InferenceServerClient(tls_url, stream_mode=True, ssl=True,
                                                  root_certificates=cert)
        ones = grpcclient.InferInput("INPUT0", [4], "FP32").set_data_from_numpy(
            np.ones([4], np.float32))
        client.infer("grpc_hold", [ones])

        def held():
            t = time.perf_counter()
            try:
                client.infer("grpc_hold", [ones], parameters={"hold_s": 5.0})
            except InferenceServerException as e:
                outcome["error"] = e
            outcome["s"] = time.perf_counter() - t

        thread = threading.Thread(target=held)
        thread.start()
        time.sleep(0.5)
        proc.kill()
        proc.wait(30)
        thread.join(20)
        client.close()
        error = outcome.get("error")
        if thread.is_alive() or error is None or not exception_is_retryable(error):
            raise AssertionError(f"a server killed under the stream: {outcome}")
        result["killed_under_stream"] = {"status": error.status(), "s": outcome["s"]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    result["wall_s"] = time.perf_counter() - t0
    print(f"grpc 13a-13b: killed under the stream: "
          f"{json.dumps(result['killed_under_stream'])}", flush=True)
    return result


def _wait_idle(engine, timeout_s: float = 120.0) -> None:
    """Until no KV block is in use and no step has run for 0.3 s: the
    streams a harness cut at its end have finished on the server."""
    deadline = time.monotonic() + timeout_s
    steps, since = engine.steps, time.monotonic()
    while time.monotonic() < deadline:
        if engine.steps != steps:
            steps, since = engine.steps, time.monotonic()
        elif not engine.allocator.blocks_in_use and time.monotonic() - since >= 0.3:
            return
        time.sleep(0.02)
    raise AssertionError(f"the engine did not go idle: {engine.allocator.blocks_in_use} "
                         "blocks in use")


def _kserve_args(url, tokens, tmp) -> list:
    """genai-perf over KServe gRPC with 9d's traffic: 8 streams, 16
    prompts of 250 +- 50 synthetic words, ``tokens`` output tokens."""
    return ["-m", "llm_engine", "-u", url, "--service-kind", "triton", "--endpoint-type",
            "kserve-ids", "--streaming", "--tokenizer", "synthetic", "--concurrency", "8",
            "--num-prompts", "16", "--synthetic-input-tokens-mean", "250",
            "--synthetic-input-tokens-stddev", "50", "--output-tokens-mean", str(tokens),
            "--artifact-dir", tmp, "--json-summary"]


def _kserve_export(tmp, tokens) -> list:
    """The profile export's requests, each held to ``tokens`` token
    events (one a response), and the corpus to ``max_tokens`` ``tokens``."""
    with open(os.path.join(tmp, "profile_export.json")) as f:
        requests = json.load(f)["experiments"][0]["requests"]
    with open(os.path.join(tmp, "llm_inputs.json")) as f:
        asked = {e["parameters"]["max_tokens"] for e in json.load(f)["data"]}
    if asked != {tokens}:
        raise AssertionError(f"the corpus asked for max_tokens {asked}")
    wrong = [len(r["response_timestamps"]) for r in requests
             if not r["success"] or len(r["response_timestamps"]) != tokens]
    if wrong or not requests:
        raise AssertionError(f"genai-perf over gRPC: {len(wrong)} of {len(requests)} requests "
                             f"failed or streamed other than {tokens} tokens: {wrong[:8]}")
    return requests


def _summary(out) -> dict:
    return next(json.loads(line) for line in reversed(out.splitlines())
                if line.startswith("{") and "ttft_avg_ms" in line)


@timed_phase("13c")
def genai_grpc_13c(port, model, config, over_http) -> dict:
    """Phase 13c on phase 4's server, after 12c: the native gRPC front-end
    on its ``ServerCore``, genai-perf ``--service-kind triton
    --endpoint-type kserve-ids --streaming`` in a subprocess that cannot
    see the card, 9d's traffic and windows. No harness error, 32 token
    events a request, K1 launched exactly 32 x decode steps (counted once
    the engine is idle), printed beside 9d's OpenAI row."""
    from client_tpu_torch.server.native_frontend import NativeGrpcFrontend

    core, loop = SERVING[port]
    frontend = NativeGrpcFrontend(core, loop)
    frontend.start("127.0.0.1", 0)
    engine = model.engine
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _wait_idle(engine)
            steps0 = engine.steps
            # -- the path of 13c: K1's counter zeroed just before, read once idle --
            pa.paged_attention_cuda.launches = 0
            out = _harness("client_tpu_torch.genai_perf", _kserve_args(
                f"127.0.0.1:{frontend.port}", SERVE_TOKENS, tmp) + [
                "--measurement-interval", "2000", "--stability-percentage", "50",
                "--max-trials", "3"])
            _wait_idle(engine)
            launches = pa.paged_attention_cuda.launches
            # ------------------------------------------------------------------------
            steps = engine.steps - steps0
            requests = _kserve_export(tmp, SERVE_TOKENS)
    finally:
        frontend.stop()
    if launches != config.n_layers * steps:
        raise AssertionError(f"K1 launched {launches} times for {steps} decode steps x "
                             f"{config.n_layers} layers")
    result = dict(_summary(out), completed=len(requests), decode_steps=steps,
                  k1_launches=launches, wall_s=time.perf_counter() - t0)
    beside = {k: over_http[k] for k in ("tokens_per_sec", "ttft_avg_ms", "itl_avg_ms",
                                        "itl_p99_ms")}
    print("genai 13c (kserve-ids over gRPC): " + json.dumps(result) + " (9d OpenAI: "
          + json.dumps(beside) + f") [{card()}]", flush=True)
    return result


# 13d's engine: K as phase 5's, the draft the target's own first layer
# (its embedding, first block and head: an early exit), cheap enough that
# every lane proposes at every step
SPECULATION_13D = {"mode": "draft", "k": 4}
DRAFT_LAYERS_13D = 1


@timed_phase("13d")
def genai_grpc_13d(params, config) -> dict:
    """Phase 13d: genai-perf over KServe gRPC with ``--speculation on``,
    13c's traffic, against an engine on phase 4's weights whose draft is
    their first layer. Phase 5's n-gram proposer finds next to nothing to
    copy in random-weight streams (its ``serve-spec:`` line counts the
    verify steps), so a gate on that traffic would pass a path that hardly
    speculates; this draft proposes K tokens for every lane at every step
    (the whole target as its own draft costs seconds a step, dense). Random
    weights accept next to none of the drafts: the gate is on verify steps,
    not on acceptance. genai-perf runs in this process so that its two
    readings of the speculation counters (``fetch_spec_stats``, over gRPC)
    wait for an idle engine: each reading equals the engine's own counters,
    the JSON summary's speculation figures equal the delta, at least half
    the engine's steps and one per request are verify steps, and K2
    launched >= 32 x verify steps."""
    from client_tpu_torch.genai_perf import main as genai_main
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.server.native_frontend import NativeGrpcFrontend

    t0 = time.perf_counter()
    model = LlmEngineModel(
        config=config, params=params, device=DEVICE, speculation=SPECULATION_13D,
        draft_config=dataclasses.replace(config, n_layers=DRAFT_LAYERS_13D),
        draft_params=dict(params, layers=params["layers"][:DRAFT_LAYERS_13D]))
    with http_server(model) as port:
        parameters = model_config(port)
        if json.loads(parameters["speculation"]["string_value"]) != SPECULATION_13D:
            raise AssertionError(f"config reports speculation {parameters['speculation']}")
        core, loop = SERVING[port]
        frontend = NativeGrpcFrontend(core, loop)
        frontend.start("127.0.0.1", 0)
        try:
            result = _genai_13d_run(genai_main, frontend.port, model.engine, config)
        finally:
            frontend.stop()
    model.engine = None
    result["wall_s"] = time.perf_counter() - t0
    print("genai 13d (kserve-ids over gRPC, speculation on): " + json.dumps(result)
          + f" [{card()}]", flush=True)
    return result


def _genai_13d_run(genai_main, grpc_port, engine, config) -> dict:
    import io

    real_fetch = genai_main.fetch_spec_stats
    readings = []

    def fetch_when_idle(url, name):
        _wait_idle(engine)
        own = engine.stats()
        fetched = real_fetch(url, name)
        readings.append((own, fetched))
        return fetched

    genai_main.fetch_spec_stats = fetch_when_idle
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = io.StringIO()
            # -- the path of 13d: both counters zeroed just before, read once idle --
            pa.paged_attention_cuda.launches = 0
            pa.paged_attention_cuda_mq.launches = 0
            # a 32-token stream of this drafting engine takes 7.7-8.9 s
            # (ITL 220-263 ms, NVIDIA H100): two 4 s windows ended before
            # any stream did and exported no request, so 8 s each
            with contextlib.redirect_stdout(out):
                code = genai_main.main(_kserve_args(
                    f"127.0.0.1:{grpc_port}", SERVE_TOKENS, tmp) + [
                    "--speculation", "on", "--measurement-interval", "8000",
                    "--stability-percentage", "50", "--max-trials", "2"])
            _wait_idle(engine)
            k2_launches = pa.paged_attention_cuda_mq.launches
            k1_launches = pa.paged_attention_cuda.launches
            # ---------------------------------------------------------------------------
            if code != 0:
                raise AssertionError(f"genai-perf exited {code}:\n{out.getvalue()[-2000:]}")
            requests = _kserve_export(tmp, SERVE_TOKENS)
    finally:
        genai_main.fetch_spec_stats = real_fetch
    summary = _summary(out.getvalue())
    if len(readings) != 2 or any(fetched is None or fetched != {k: own[k] for k in fetched}
                                 for own, fetched in readings):
        raise AssertionError(f"the speculation counters over gRPC: {readings}")
    (before, _), (after, _) = readings
    delta = {key: after[key] - before[key] for key in
             ("steps", "spec_steps", "spec_proposed", "spec_accepted", "step_tokens",
              "lane_steps")}
    want = {"tokens_per_step": round(delta["step_tokens"] / max(1, delta["lane_steps"]), 3),
            "spec_acceptance_rate": round(
                delta["spec_accepted"] / max(1, delta["spec_proposed"]), 3)}
    if {k: summary.get(k) for k in want} != want:
        raise AssertionError(f"the summary's speculation delta {summary} is not the "
                             f"engine's {want}")
    if delta["spec_steps"] < max(len(requests), (delta["steps"] + 1) // 2):
        raise AssertionError(f"a drafting engine barely speculated: {delta} for "
                             f"{len(requests)} requests")
    if k2_launches < config.n_layers * delta["spec_steps"]:
        raise AssertionError(f"K2 launched {k2_launches} times for {delta['spec_steps']} "
                             f"verify steps x {config.n_layers} layers")
    return dict(summary, completed=len(requests), verify_steps=delta["spec_steps"],
                spec_delta=delta, k1_launches=k1_launches, k2_launches=k2_launches)


# -- phase 14: fault injection and engine recovery ----------------------------


def _wait_for(predicate, timeout_s, what) -> None:
    """Poll ``predicate`` every 2 ms until it holds; fails after
    ``timeout_s`` naming ``what``."""
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"no {what} after {timeout_s} s")
        time.sleep(0.002)


def _stream_live(port, prompt, max_tokens, record) -> None:
    """One streaming chat completion for ``llm_engine`` whose ``record``
    fills while it runs: ``tokens`` and one ``stamps`` entry a token event
    as they arrive, then ``status`` and ``done``; the first in-band error's
    message in ``error`` with its time in ``error_at``; for a refused
    request its ``Retry-After`` and ``body``. The server's answer never
    raises here: the caller holds it to what it expects."""
    record.update(tokens=[], stamps=[], status=None, done=False, error=None)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps({"model": "llm_engine", "stream": True, "max_tokens": max_tokens,
                           "messages": [{"role": "user", "content": prompt}]})
        record["start"] = time.perf_counter()
        conn.request("POST", "/v1/chat/completions", body=body,
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        record["status"] = response.status
        if response.status != 200:
            record.update(retry_after=response.getheader("Retry-After"),
                          body=response.read().decode(errors="replace"))
            return
        while True:
            line = response.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                record["done"] = True
                continue
            event = json.loads(payload)
            if "error" in event:
                if record["error"] is None:
                    record.update(error=event["error"].get("message", ""),
                                  error_at=time.perf_counter())
                continue
            content = event["choices"][0].get("delta", {}).get("content")
            if content:
                record["stamps"].append(time.perf_counter())
                record["tokens"].extend(int(t[3:]) for t in content.split())
    except (OSError, http.client.HTTPException) as e:
        record.update(error=f"transport: {e!r}", error_at=time.perf_counter())
    finally:
        conn.close()


def _grpc_stream_fail(grpc_port, ids, max_tokens, record) -> None:
    """One ``ModelStreamInfer`` stream for ``llm_engine`` with the request
    parameter ``recovery: fail``, through the port's aio gRPC client, on a
    thread of its own: ``record`` gets its tokens and its first in-band
    error."""
    import numpy as np

    import client_tpu_torch.grpc.aio as grpc_aio

    async def run():
        client = grpc_aio.InferenceServerClient(f"127.0.0.1:{grpc_port}")
        x = grpc_aio.InferInput("INPUT_IDS", [len(ids)], "INT32")
        x.set_data_from_numpy(np.array(ids, dtype=np.int32))

        async def requests():
            yield {"model_name": "llm_engine", "inputs": [x],
                   "parameters": {"max_tokens": max_tokens, "recovery": "fail"}}

        try:
            async for result, error in client.stream_infer(requests()):
                if error is not None:
                    record["error"] = error.message()
                    break
                out = result.as_numpy("OUTPUT_IDS")
                if out is not None:
                    record["tokens"].extend(int(t) for t in out.reshape(-1))
                final = result.get_response().parameters.get("triton_final_response")
                if final is not None and final.bool_param:
                    break
        finally:
            await client.close()

    record.update(tokens=[], error=None)
    asyncio.run(run())


class _StateSampler:
    """Reads ``tpu_server_state`` from ``/metrics`` in a loop on a thread
    of its own until :meth:`stop`; ``seen`` counts each value read."""

    def __init__(self, port):
        self.port, self.seen = port, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            status, _, text = _http(self.port, "/metrics")
            match = re.search(r"^tpu_server_state (\S+)$", text, re.M)
            value = match.group(1) if status == 200 and match else f"status {status}"
            self.seen[value] = self.seen.get(value, 0) + 1
            time.sleep(0.005)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(30)
        return self.seen


def _recovery_total(port, outcome) -> float:
    from client_tpu_torch.observability.metrics import counter_total

    return counter_total(_scrape(port).get("tpu_recovery_total"),
                         {"tier": "engine", "outcome": outcome})


def _count_prefills(model, counts) -> None:
    """From now on every engine ``model`` builds counts its prefills in
    ``counts`` (one entry an engine, in the order built); a warmup's probe
    prefills, all zero tokens, are not counted."""
    build = type(model)._build_device_fns

    def counted(*args):
        prefill, decode, decode_multi = build(model, *args)
        counts.append(0)
        slot = len(counts) - 1

        def prefill_counted(tokens, *rest):
            if tokens.any():
                counts[slot] += 1
            return prefill(tokens, *rest)

        return prefill_counted, decode, decode_multi

    model._build_device_fns = counted


def _longest_gap_ms(records, t_fault) -> float:
    """The longest gap between two token events of any stream that spans
    ``t_fault`` (the fault falls inside it)."""
    gaps = [b - a for r in records for a, b in zip(r["stamps"], r["stamps"][1:])
            if a <= t_fault < b]
    return 1e3 * max(gaps) if gaps else 0.0


RECOVERY_MIN_TOKENS = 4


def _recovery_round(port, grpc_port, model, config, plain_streams, fault) -> dict:
    """One round of 14a: phase 4's 8 streams; once each has
    ``RECOVERY_MIN_TOKENS`` tokens the engine faults — ``oom``: the next
    decode call asks the card for more than it holds, a genuine
    ``torch.OutOfMemoryError`` inside the step; ``quarantine``: the
    reference's induced path, ``engine.quarantine`` from this thread, with
    the reload held until a ninth stream has been refused 503 with
    ``Retry-After`` and the debug state read, and a tenth stream over
    gRPC with ``recovery: fail`` queued behind the 8. The controller
    reloads the engine and the 8 resume."""
    from client_tpu_torch.llm import recovery

    controller = model._recovery
    engine = model.engine
    steps0 = engine.steps
    recoveries0 = controller.recoveries
    torch.cuda.reset_peak_memory_stats()
    prompts = _prompts()
    records = [dict() for _ in prompts]
    threads = [threading.Thread(target=_stream_live, args=(port, p, SERVE_TOKENS, r))
               for p, r in zip(prompts, records)]
    for thread in threads:
        thread.start()
    _wait_for(lambda: all(r.get("tokens") for r in records), 300, "first token a stream")
    extra, gate, tenth = {}, threading.Event(), {}
    if fault == "quarantine":
        from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer

        ids = SyntheticTokenizer(config.vocab_size).encode(prompts[2])
        tenth_thread = threading.Thread(target=_grpc_stream_fail,
                                        args=(grpc_port, ids, SERVE_TOKENS, tenth))
        tenth_thread.start()
        _wait_for(lambda: engine.stats()["waiting_sequences"] >= 1, 60, "tenth stream queued")
        reload = model.reload

        def held_reload():
            gate.wait(120)
            reload()

        model.reload = held_reload
    sampler = _StateSampler(port)
    _wait_for(lambda: all(len(r["tokens"]) >= RECOVERY_MIN_TOKENS for r in records), 300,
              f"{RECOVERY_MIN_TOKENS} tokens a stream")
    if fault == "oom":
        fired = {}
        decode = engine._decode
        too_much = torch.cuda.get_device_properties(DEVICE).total_memory + 2**30

        def oom_once(*args):
            if not fired:
                fired["at"] = time.perf_counter()
                torch.empty(too_much, dtype=torch.uint8, device=DEVICE)
                raise AssertionError("an allocation past the card's memory succeeded")
            return decode(*args)

        engine._decode = oom_once
        _wait_for(lambda: fired, 60, "faulted decode step")
        t_fault = fired["at"]
    else:
        t_fault = time.perf_counter()
        engine.quarantine("induced device failure (phase 14a)")
        _wait_for(lambda: model.recovering, 30, "recovering controller")
        status, headers, text = _http(port, "/v1/chat/completions", "POST", {
            "model": "llm_engine", "stream": True, "max_tokens": 4,
            "messages": [{"role": "user", "content": prompts[0]}]})
        message = json.loads(text).get("error", {}).get("message", "")
        if status != 503 or headers.get("Retry-After") != "1" or "recovering" not in message:
            raise AssertionError(f"a stream sent while recovering got {status} "
                                 f"{headers.get('Retry-After')} {text[:200]}")
        doc = json.loads(_http(port, "/v2/debug/state")[2])
        if not doc["server"]["recovering"] or \
                doc["llm"]["llm_engine"]["recovery"]["state"] != recovery.RECOVERING:
            raise AssertionError(f"the debug state while recovering: {doc['server']}, "
                                 f"{doc['llm']['llm_engine'].get('recovery')}")
        _wait_for(lambda: "3" in sampler.seen, 30, "tpu_server_state 3")
        extra.update(refused_status=status, refused_retry_after=headers["Retry-After"],
                     refused_message=message)
        extra["held_ms"] = (time.perf_counter() - t_fault) * 1e3
        gate.set()
    _wait_for(lambda: controller.recoveries > recoveries0 or controller.state == recovery.FAILED,
              120, "recovery")
    t_ready = time.perf_counter()
    peak_bytes = torch.cuda.max_memory_allocated()
    if fault == "quarantine":
        del model.reload
        tenth_thread.join(120)
    seen = sampler.stop()
    doc = controller.describe()
    if doc["state"] != recovery.READY or doc["recoveries"] != recoveries0 + 1:
        raise AssertionError(f"the controller after the {fault} round: {doc}")
    old_steps, old_blocks = engine.steps - steps0, engine.allocator.blocks_in_use
    del engine
    for thread in threads:
        thread.join(600)
    new = model.engine
    _wait_idle(new, timeout_s=60)
    ties = {}
    for i, record in enumerate(records):
        if record["status"] != 200 or not record["done"] or record["error"] is not None:
            raise AssertionError(f"stream {i} across the {fault} recovery: {record['status']}, "
                                 f"done {record['done']}, error {record['error']}")
        if len(record["tokens"]) != SERVE_TOKENS:
            raise AssertionError(f"stream {i} delivered {len(record['tokens'])} tokens")
        tie = _same_or_tie(model._params, config, prompts[i], plain_streams[i],
                           record["tokens"])
        if tie:
            ties[i] = tie
    if old_blocks or new.allocator.blocks_in_use:
        raise AssertionError(f"KV blocks in use after the {fault} round: {old_blocks} in the "
                             f"quarantined engine, {new.allocator.blocks_in_use} in the new")
    if fault == "quarantine" and ("induced device failure" not in (tenth.get("error") or "")):
        raise AssertionError(f"the recovery: fail stream: {tenth}")
    if fault == "quarantine":
        extra.update(opt_out_error=tenth["error"][:120], opt_out_tokens=len(tenth["tokens"]))
    return dict(extra, fault=fault, fault_to_ready_ms=(t_ready - t_fault) * 1e3,
                controller_duration_ms=doc["last_duration_s"] * 1e3,
                longest_gap_ms=_longest_gap_ms(records, t_fault),
                itl_ms_p50=1e3 * percentile([b - a for r in records
                                             for a, b in zip(r["stamps"], r["stamps"][1:])],
                                            0.5),
                peak_gib=peak_bytes / 2**30, server_state_seen=seen,
                decode_steps=old_steps + new.steps, parted_at_near_ties=ties,
                describe=doc)


@timed_phase("14a")
def recovery_7b(port, model, config, plain_streams) -> dict:
    """Phase 14a on phase 4's server and 7B engine, after 13c: two rounds
    of :func:`_recovery_round` — a genuine CUDA OOM inside a decode step,
    then the reference's induced quarantine. Each round's 8 streams equal
    phase 4's (or part at a dense-forward near-tie, 11a's rule) with no
    client error; the controller reads READY with 1, then 2 recoveries;
    ``tpu_recovery_total{tier="engine",outcome="success"}`` rises by 2;
    each new engine re-prefills the 8 survivors; every KV block comes back;
    K1 launches >= 32 x decode steps; the quarantined pools are freed."""
    from client_tpu_torch.server.native_frontend import NativeGrpcFrontend

    t0 = time.perf_counter()
    if model._recovery is None or model._recovery.recoveries:
        raise AssertionError(f"phase 4's model has no fresh recovery controller: "
                             f"{model._recovery and model._recovery.describe()}")
    core, loop = SERVING[port]
    frontend = NativeGrpcFrontend(core, loop)
    frontend.start("127.0.0.1", 0)
    prefills = []
    _count_prefills(model, prefills)
    success0 = _recovery_total(port, "success")
    _wait_idle(model.engine)
    gc.collect()
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    rounds = []
    try:
        # -- the path of 14a: K1's counter zeroed just before, read once idle --
        pa.paged_attention_cuda.launches = 0
        for fault in ("oom", "quarantine"):
            rounds.append(_recovery_round(port, frontend.port, model, config, plain_streams,
                                          fault))
            rounds[-1]["re_prefills"] = prefills[-1]
        launches = pa.paged_attention_cuda.launches
        # ------------------------------------------------------------------------
    finally:
        frontend.stop()
        del model._build_device_fns
    steps = sum(r["decode_steps"] for r in rounds)
    if launches < config.n_layers * steps:
        raise AssertionError(f"K1 launched {launches} times for {steps} decode steps x "
                             f"{config.n_layers} layers")
    if [r["re_prefills"] for r in rounds] != [8, 8]:
        raise AssertionError(f"re-prefills a recovery: {[r['re_prefills'] for r in rounds]}")
    if "3" not in rounds[1]["server_state_seen"]:
        raise AssertionError(f"tpu_server_state never read 3: {rounds[1]['server_state_seen']}")
    successes = _recovery_total(port, "success") - success0
    if successes != 2:
        raise AssertionError(f"tpu_recovery_total success rose by {successes}, not 2")
    doc = json.loads(_http(port, "/v2/debug/state")[2])["llm"]["llm_engine"].get("recovery")
    if not doc or doc["state"] != "ready" or doc["recoveries"] != 2:
        raise AssertionError(f"the debug state's recovery document: {doc}")
    gc.collect()
    torch.cuda.synchronize()
    after_bytes = torch.cuda.memory_allocated()
    # a quarantined engine's pool goes once nothing names it: a recovery
    # that kept it would hold a second 16 GiB pool for good
    if after_bytes > before_bytes + 2**30:
        raise AssertionError(f"{(after_bytes - before_bytes) / 2**30:.2f} GiB more allocated "
                             f"after the recoveries than before")
    result = {"rounds": rounds, "k1_launches": launches, "decode_steps": steps,
              "recovery_total_success_delta": successes,
              "allocated_gib_before": before_bytes / 2**30,
              "allocated_gib_settled": after_bytes / 2**30,
              "card_gib": torch.cuda.get_device_properties(DEVICE).total_memory / 2**30,
              "wall_s": time.perf_counter() - t0}
    print("recovery 14a: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


# 14b's model: phase 4's widths cut to 2 layers; its decode callable reads
# past the end of a device tensor once the trigger file appears: the
# indexing kernel's device-side assert, surfaced by the synchronise, poisons
# the process's CUDA context
STICKY_MODEL_PY = """
import os

import torch

from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama

TRIGGER = {trigger!r}


class StickyFault(LlmEngineModel):
    def _build_device_fns(self, *args):
        prefill, decode, decode_multi = super()._build_device_fns(*args)
        device = self.device

        def decode_once_faulty(tokens, positions, page_tables, pages):
            if os.path.exists(TRIGGER):
                os.remove(TRIGGER)
                table = torch.zeros(4, device=device)
                table[torch.tensor([1 << 20], device=device)]
                torch.cuda.synchronize(device)
            return decode(tokens, positions, page_tables, pages)

        return prefill, decode_once_faulty, decode_multi


def create_model(device):
    return StickyFault(config=llama.LlamaConfig(n_layers=2), device=device)
"""
STICKY_STREAMS = 4
STICKY_TOKENS = 64
STICKY_ROUTES = (("GET", "/v2/health/live"), ("GET", "/v2/health/ready"), ("GET", "/metrics"),
                 ("GET", "/v2/debug/state"), ("POST", "/v2/repository/index"),
                 ("GET", "/v2/models/llm_engine/config"), ("GET", "/v2/models/stats"))


def launch_sticky():
    """14b's server, launched so that its start-up overlaps phases 11-13:
    (its model directory, the trigger path, the launched server)."""
    tmp = tempfile.TemporaryDirectory()
    trigger = os.path.join(tmp.name, "fire")
    os.makedirs(os.path.join(tmp.name, "llm_engine"))
    with open(os.path.join(tmp.name, "llm_engine", "model.py"), "w") as f:
        f.write(STICKY_MODEL_PY.format(trigger=trigger))
    return tmp, trigger, launch_server("--model-repository", tmp.name, "--drain-timeout", "20")


@timed_phase("14b")
def sticky_14b(sticky) -> dict:
    """Phase 14b: ``python -m client_tpu_torch.server --model-repository``
    spawned with the card (``sticky``, from :func:`launch_sticky`) serves
    the built-ins and ``llm_engine`` at 7B
    widths with 2 layers, whose decode callable raises a device-side
    assert once a trigger file appears. With 4 streams in flight the
    trigger fires: every stream fails with the OpenAI error inside 10 s of
    the fault; the reloads all fail on the poisoned context, so the
    controller reads FAILED after ``max_attempts`` attempts and
    ``tpu_recovery_total{tier="engine",outcome="failed"}`` is 1. Which
    routes still answer is recorded; the process exits on SIGTERM inside
    its 20 s drain timeout."""
    import signal

    import numpy as np

    t0 = time.perf_counter()
    tmp, trigger, launched = sticky
    with tmp:
        proc = launched[0]
        try:
            proc, started, log, reader = await_server(launched)
            port = started["http_port"]
            if _http(port, "/v2/health/ready")[0] != 200:
                raise AssertionError("the spawned server is not ready")
            start_s = time.perf_counter() - t0
            records = [dict() for _ in range(STICKY_STREAMS)]
            threads = [threading.Thread(target=_stream_live,
                                        args=(port, p, STICKY_TOKENS, r))
                       for p, r in zip(_prompts(), records)]
            for thread in threads:
                thread.start()
            _wait_for(lambda: all(len(r.get("tokens", ())) >= 2 for r in records), 300,
                      "2 tokens a stream")
            t_fault = time.perf_counter()
            with open(trigger, "w"):
                pass
            for thread in threads:
                thread.join(60)

            def events(name):
                return [json.loads(line) for line in list(log)
                        if line.startswith("{") and f'"{name}"' in line]

            _wait_for(lambda: events("llm_engine_recovery_exhausted"), 60,
                      "llm_engine_recovery_exhausted in the log")
            t_failed = time.perf_counter()
            routes = {path: _http(port, path, method)[0] for method, path in STICKY_ROUTES}
            with client_http.InferenceServerClient(f"127.0.0.1:{port}") as client:
                a = client_http.InferInput("INPUT0", [1, 16], "INT32")
                a.set_data_from_numpy(np.arange(16, dtype=np.int32).reshape(1, 16))
                b = client_http.InferInput("INPUT1", [1, 16], "INT32")
                b.set_data_from_numpy(np.ones([1, 16], dtype=np.int32))
                try:
                    out = client.infer("simple", [a, b]).as_numpy("OUTPUT0")
                    routes["simple /infer"] = 200 if (out == np.arange(1, 17)).all() else "wrong"
                except Exception as e:  # noqa: BLE001 - recorded: the context is gone
                    routes["simple /infer"] = f"{type(e).__name__}: {str(e)[:80]}"
            after = dict()
            _stream_live(port, _prompts()[0], 4, after)
            routes["new stream"] = after["status"] if after["status"] != 200 else \
                f"200, in-band error {str(after['error'])[:80]}"
            failed = (_recovery_total(port, "failed") if routes["/metrics"] == 200
                      else "no /metrics")
            state = json.loads(_http(port, "/v2/debug/state")[2])["llm"]["llm_engine"][
                "recovery"] if routes["/v2/debug/state"] == 200 else None
            t_sig = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(30)
            exit_ms = (time.perf_counter() - t_sig) * 1e3
            reader.join(30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    attempts = events("llm_engine_recovery_attempt_failed")
    exhausted = events("llm_engine_recovery_exhausted")[0]
    late = []
    for i, record in enumerate(records):
        error_ms = (record.get("error_at", float("inf")) - t_fault) * 1e3
        if record["status"] != 200 or record["error"] is None or error_ms > 10e3:
            late.append((i, record["status"], record["error"], error_ms))
    if late:
        raise AssertionError(f"streams without a retryable error inside 10 s: {late}")
    if failed != 1:
        raise AssertionError(f"tpu_recovery_total failed reads {failed}, routes {routes}")
    if state is None or state["state"] != "failed" or state["failures"] != 1 or \
            len(attempts) != state["max_attempts"] or exhausted["attempts"] != len(attempts):
        raise AssertionError(f"the controller: {state}, {len(attempts)} failed attempts")
    if exit_ms > 20e3:
        raise AssertionError(f"the server exited {code} after {exit_ms:.0f} ms")
    result = {"server_start_s": start_s,
              "fault_to_failed_ms": (t_failed - t_fault) * 1e3,
              "stream_error_ms": [(r["error_at"] - t_fault) * 1e3 for r in records],
              "stream_tokens": [len(r["tokens"]) for r in records],
              "stream_error": records[0]["error"][:160],
              "attempt_errors": [a.get("error", "")[:120] for a in attempts],
              "describe": state, "recovery_total_failed": failed,
              "routes_after": routes, "sigterm_to_exit_ms": exit_ms, "exit_code": code,
              "wall_s": time.perf_counter() - t0}
    print("recovery 14b: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("14c")
def chaos_14c(port, model, images, check) -> dict:
    """Phase 14c beside 7b: ``InProcessServer`` on the card serving the
    built-ins and 7b's ResNet-50 with ``ChaosPolicy(error_rate=0.3)``, and
    a second with ``reset_rate=0.15, truncate_rate=0.15``. From 4 client
    processes, with the reference's retry policy, 100 ``simple`` requests
    answer exactly and 64 images each within 7b's 2 % of its unbatched
    forward, on both servers; the servers' statistics book only the
    requests that reached the model; without a policy every process's run
    fails with 503. Then the harness at ``-b 1`` c=8 with
    ``--max-error-rate 0.5`` on the error server and on 7b's server with
    no chaos, one 1 s window each."""
    from client_tpu_torch.resilience import ChaosPolicy
    from client_tpu_torch.testing import InProcessServer

    t0 = time.perf_counter()
    servers = {"errors": InProcessServer(device=DEVICE,
                                         chaos=ChaosPolicy(error_rate=0.3, seed=14)),
               "cuts": InProcessServer(device=DEVICE, chaos=ChaosPolicy(
                   reset_rate=0.15, truncate_rate=0.15, seed=15))}
    for server in servers.values():
        server.core.repository.add_model(model)
        server.start()
    timings = {"setup_s": time.perf_counter() - t0}
    try:
        urls = {name: server.http_url for name, server in servers.items()}
        runs = [(urls["errors"], True), (urls["cuts"], True), (urls["errors"], False)]
        share = CHAOS_IMAGES // CHAOS_PROCS
        arglist = [{"runs": runs, "worker": w,
                    "images": {i: images[i:i + 1] for i in range(w * share, (w + 1) * share)}}
                   for w in range(CHAOS_PROCS)]
        rounds = {}

        def on_round(go):
            label = CHAOS_ROUNDS[len(rounds)]
            server = servers[label.split("_")[0]]
            before = (dict(server.chaos.injected), _stats(server.http_port, "simple"),
                      _stats(server.http_port, "image_classifier"))
            got, wall = go()
            after = (dict(server.chaos.injected), _stats(server.http_port, "simple"),
                     _stats(server.http_port, "image_classifier"))
            injected = {fate: after[0].get(fate, 0) - before[0].get(fate, 0)
                        for fate in ("error", "reset", "truncate")}
            rounds[label] = {"results": got, "wall_s": wall, "injected": injected,
                             "booked": {m: (_booked(b, a), _booked(b, a, "fail"))
                                        for m, b, a in (("simple", before[1], after[1]),
                                                        ("image_classifier", before[2],
                                                         after[2]))}}

        run_client_processes("chaos", arglist, on_round, rounds=len(CHAOS_ROUNDS))
        timings["clients_s"] = time.perf_counter() - t0 - timings["setup_s"]
        summary = {}
        for label, run in rounds.items():
            injected, booked = run["injected"], run["booked"]
            faults = sum(injected.values())
            if label == "errors_no_policy":
                statuses = [r["failed"] and r["failed"]["status"] for r in run["results"]]
                if statuses != ["503"] * CHAOS_PROCS:
                    raise AssertionError(f"without a policy: {[r['failed'] for r in run['results']]}")
                summary[label] = {"statuses": statuses, "injected": injected}
                continue
            if any(r["wrong"] for r in run["results"]):
                raise AssertionError(f"{label}: simple answered wrong under chaos")
            for r in run["results"]:
                for i, answer in r["answers"].items():
                    check(i, f"chaos {label}", [answer])
            answered = sum(len(r["answers"]) for r in run["results"])
            if answered != CHAOS_IMAGES or not faults:
                raise AssertionError(f"{label}: {answered} images answered, faults {injected}")
            # injected errors and resets never reach the model; a truncated
            # answer was computed, booked, then cut on the wire
            reached = booked["simple"][0] + booked["image_classifier"][0]
            if booked["simple"][1] or booked["image_classifier"][1] or \
                    reached != CHAOS_SIMPLE + CHAOS_IMAGES + injected["truncate"]:
                raise AssertionError(f"{label}: the server booked {booked} for "
                                     f"{CHAOS_SIMPLE + CHAOS_IMAGES} requests, {injected}")
            summary[label] = {"injected": injected, "booked": booked,
                              "retries_per_request": faults / (CHAOS_SIMPLE + CHAOS_IMAGES),
                              "wall_s": run["wall_s"]}
        harness_args = ["-m", "image_classifier", "-b", "1", "--concurrency-range", "8",
                        "--measurement-interval", "1000", "--max-trials", "1",
                        "--max-error-rate", "0.5", "--json-summary"]
        t_harness = time.perf_counter()
        server = servers["errors"]
        before = (dict(server.chaos.injected), _stats(server.http_port, "image_classifier"))
        chaotic = json.loads(_harness("client_tpu_torch.perf", harness_args + [
            "-u", urls["errors"]]).strip().splitlines()[-1])
        after = (dict(server.chaos.injected), _stats(server.http_port, "image_classifier"))
        plain = json.loads(_harness("client_tpu_torch.perf", harness_args + [
            "-u", f"127.0.0.1:{port}"]).strip().splitlines()[-1])
        timings["harness_s"] = time.perf_counter() - t_harness
    finally:
        for server in servers.values():
            server.stop()
    injected_errors = after[0].get("error", 0) - before[0].get("error", 0)
    booked = _booked(before[1], after[1])
    error_share = chaotic["errors"] / max(1, chaotic["errors"] + chaotic["count"])
    if not (chaotic["errors"] and 0.15 <= error_share <= 0.45
            and injected_errors >= chaotic["errors"] and booked >= chaotic["count"]
            and _booked(before[1], after[1], "fail") == 0 and not plain["errors"]):
        raise AssertionError(f"harness under chaos: {chaotic}, injected {injected_errors}, "
                             f"booked {booked}; without chaos {plain}")
    summary["harness"] = {
        "errors": chaotic["errors"], "count": chaotic["count"], "error_share": error_share,
        "injected_error_delta": injected_errors, "booked_success_delta": booked,
        "infer_per_s": chaotic["throughput"], "p99_ms": chaotic["p99_us"] / 1e3,
        "no_chaos_infer_per_s": plain["throughput"], "no_chaos_p99_ms": plain["p99_us"] / 1e3}
    summary.update(timings, wall_s=time.perf_counter() - t0)
    print("chaos 14c: " + json.dumps(summary) + f" [{card()}]", flush=True)
    return summary

# ---------------------------------------------------------------------------
# phase 15: sharded serving over a mesh of shards of the one card
# ---------------------------------------------------------------------------


def _drive_device_fns(engine, n_layers, tp):
    """The engine's device functions on fixed host inputs: a prefill of
    20 tokens, a suffix prefill sharing its first 2 blocks, 4 decode
    steps of both lanes and one K = 4 verify step (T = 5 rows a lane).
    Returns their logits, and checks that K1 launched ``tp x n_layers``
    times in each decode step and K2 as often in the verify step."""
    import numpy as np

    pages, out = engine._pages, {}
    tokens = np.zeros([1, 32], dtype=np.int32)
    tokens[0, :20] = np.arange(1, 21)
    table_a = np.zeros([8], dtype=np.int32)
    table_a[:4] = [1, 2, 3, 4]
    out["prefill"], pages = engine._prefill(tokens, table_a, pages, 19, 0)
    suffix = np.zeros([1, 16], dtype=np.int32)
    suffix[0, :6] = np.arange(30, 36)
    table_b = np.zeros([8], dtype=np.int32)
    table_b[:4] = [1, 2, 5, 6]
    out["suffix prefill"], pages = engine._prefill(suffix, table_b, pages, 5, 16)
    tables = np.stack([table_a, table_b])[:, :4]
    positions = np.array([20, 22], dtype=np.int32)
    launches = []
    for step in range(4):
        pa.paged_attention_cuda.launches = 0
        logits, pages = engine._decode(np.array([11 + step, 21 + step], dtype=np.int32),
                                       positions + step, tables, pages)
        launches.append(pa.paged_attention_cuda.launches)
        out[f"decode {step}"] = logits
    rows = positions[:, None] + 4 + np.arange(5, dtype=np.int32)[None, :]
    draft = np.array([[15, 7, 8, 9, 10], [25, 7, 8, 9, 10]], dtype=np.int32)
    pa.paged_attention_cuda_mq.launches = 0
    out["verify"], pages = engine._decode_multi(draft, rows, np.array([5, 5], dtype=np.int32),
                                                tables, pages)
    verify_launches = pa.paged_attention_cuda_mq.launches
    engine._pages = pages
    if launches != [tp * n_layers] * 4 or verify_launches != tp * n_layers:
        raise AssertionError(f"tp {tp}: K1 {launches} a decode step, K2 {verify_launches} "
                             f"a verify step; want {tp * n_layers} each")
    return out, sum(launches), verify_launches


@timed_phase("15a")
def tp_tiny_15a() -> dict:
    """Phase 15a: the tiny fp32 Llama through ``LlmEngineModel`` at tp 1,
    2 and 4 on ``[cuda:0] * tp``: every device function within 1e-5 of tp
    1 with equal argmax, K1 and K2 ``tp x n_layers`` launches a step, and
    greedy streams equal to the dense oracle with speculation off and
    n-gram on."""
    import numpy as np

    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    params = llama.init_params(torch.Generator(device=DEVICE).manual_seed(0), config, DEVICE)
    logits, k1, k2 = {}, {}, {}
    for tp in (1, 2, 4):
        model = LlmEngineModel(
            config=config, params=params, tp=tp, devices=[DEVICE] * tp,
            speculation={"mode": "ngram", "k": 4},
            engine_config=EngineConfig(block_size=8, num_blocks=65, max_active=8,
                                       max_seq_len=64))
        model.warmup()
        if model.decode_kernel != "cuda":
            raise AssertionError(f"tp {tp}: decode kernel {model.decode_kernel}")
        logits[tp], k1[tp], k2[tp] = _drive_device_fns(model.engine, config.n_layers, tp)
        model.shutdown()
    worst = 0.0
    for tp in (2, 4):
        for name, want in logits[1].items():
            got = logits[tp][name]
            worst = max(worst, float(np.abs(got - want).max()))
            if not np.abs(got - want).max() <= 1e-5:
                raise AssertionError(f"tp {tp} {name}: {np.abs(got - want).max()} > 1e-5")
            if not (got.argmax(-1) == want.argmax(-1)).all():
                raise AssertionError(f"tp {tp} {name}: argmax differs from tp 1")
    for tp in (2, 4):
        for spec in (None, {"mode": "ngram", "k": 4, "ngram": 2}):
            _tiny_streams(spec, tp=tp)
    result = {"max_abs_err": worst, "k1_launches": {f"tp{t}": k1[t] for t in (2, 4)},
              "k2_launches": {f"tp{t}": k2[t] for t in (2, 4)}}
    print("tp 15a: tiny fp32 engine at tp 2 and 4 on one card: prefill, suffix prefill, "
          "4 decode steps and a K=4 verify within " + f"{worst:.3g} of tp 1 (limit 1e-5), "
          "argmax equal, greedy streams equal to the dense oracle with speculation off "
          "and n-gram on; " + json.dumps(result), flush=True)
    return result


@timed_phase("15b")
def tp_7b_15b(params, plain_streams, served) -> dict:
    """Phase 15b: ``LlmEngineModel(tp=2, devices=[cuda:0, cuda:0])`` on
    phase 4's weights serves phase 4's 8 prompts x 32 tokens over HTTP;
    each stream equals phase 4's or parts at a dense near-tie, and K1
    launches exactly 2 x 32 x decode steps."""
    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig()
    gc.collect()
    torch.cuda.empty_cache()
    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlmEngineModel(config=config, params=params, tp=2, devices=[DEVICE, DEVICE])
    with http_server(model) as port:
        load_s = time.perf_counter() - t0
        parameters = model_config(port)
        if parameters["tp"]["string_value"] != "2":
            raise AssertionError(f"config reports tp {parameters['tp']}")
        engine = model.engine
        steps0 = engine.steps
        # -- the main path: counters zeroed just before, read just after --
        pa.paged_attention_cuda.launches = 0
        pa.paged_attention_cuda_mq.launches = 0
        records, wall = stream_all(port, SERVE_TOKENS, config.vocab_size)
        launches = pa.paged_attention_cuda.launches
        k2_launches = pa.paged_attention_cuda_mq.launches
        # -------------------------------------------------------------------
        decode_steps = engine.steps - steps0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        settled_gib = torch.cuda.memory_allocated() / 2**30
        if launches != 2 * config.n_layers * decode_steps:
            raise AssertionError(f"K1 launched {launches} times for {decode_steps} decode "
                                 f"steps x {config.n_layers} layers x 2 shards")
        if engine.allocator.blocks_in_use != 0:
            raise AssertionError(f"{engine.allocator.blocks_in_use} KV blocks leaked")
        step = profile_step(engine, [len(p.split()) + SERVE_TOKENS for p in _prompts()])
        del engine
    parted = [_same_or_tie(params, config, prompt, want, record["tokens"])
              for prompt, want, record in zip(_prompts(), plain_streams, records)]
    model.engine = None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    k1_ms = step["device_ms_by_kind"]
    result = latency(records, wall)
    result.update(
        load_s=load_s, decode_steps=decode_steps, k1_launches=launches,
        k2_launches=k2_launches, parted_at_near_tie=sum(1 for p in parted if p),
        host_ms_per_step_median=step["host_ms_per_step_median"],
        k1_device_ms_per_shard=(k1_ms["attention (K1)"] / 2 if isinstance(k1_ms, dict)
                                else "not measured"),
        peak_gib=peak_gib, settled_gib=settled_gib, before_gib=before_gib,
        freed_gib=torch.cuda.memory_allocated() / 2**30,
        phase_4={key: served[key] for key in ("ttft_ms_mean", "itl_ms_mean", "itl_ms_p50",
                                              "itl_ms_p99", "tokens_per_s")},
        phase_4_step={"host_ms_per_step_median": served["step"]["host_ms_per_step_median"],
                      "k1_device_ms": (served["step"]["device_ms_by_kind"]["attention (K1)"]
                                       if isinstance(served["step"]["device_ms_by_kind"], dict)
                                       else "not measured")},
        phase_4_loaded_gib=served["loaded_gib"],
    )
    print("tp 15b: " + json.dumps(result) + f" [{card()}]", flush=True)
    result["streams"] = [r["tokens"] for r in records]
    return result


@timed_phase("15c")
def text_encoder_tp_15c() -> dict:
    """Phase 15c: ``text_encoder_tp`` at BERT-large's widths, fp32, dp2 x
    tp2 on ``[cuda:0] * 4``: 16 ``/infer`` requests of lengths 16-512
    from 4 client threads, each within 1e-4 of the largest |value| of the
    unsharded ``TextEncoderModel`` on the same weights; metadata, model
    config and ``/v2/debug/state`` carry the mesh's axes."""
    import numpy as np

    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import ShardedTextEncoderModel, TextEncoderModel

    config = bert.BertConfig(dtype=torch.float32)
    params = bert.init_params(torch.Generator(device=DEVICE).manual_seed(0), config, DEVICE)
    plain = TextEncoderModel(config=config, params=params, device=DEVICE)
    model = ShardedTextEncoderModel(config=config, params=params, devices=[DEVICE] * 4)
    rng = np.random.default_rng(15)
    lengths = np.linspace(16, 512, 16).astype(int)
    seqs = [rng.integers(1, config.vocab_size, n, dtype=np.int32) for n in lengths]
    with http_server(model) as port:
        work = [lambda way, s=s: way.infer("text_encoder_tp", [("INPUT_IDS", "INT32", s[None])],
                                           [("EMBEDDING", None, None)])["EMBEDDING"][0]
                for s in seqs]
        answers, latencies, wall = _concurrently(port, 4, lambda c, w: _ClientRoute(c, "none"),
                                                 work)
        axes = {
            "metadata": json.loads(_http(port, "/v2")[2])["devices"]["models"][
                "text_encoder_tp"]["axes"],
            "config": json.loads(json.loads(_http(port, "/v2/models/text_encoder_tp/config")[2])[
                "parameters"]["mesh"]["string_value"])["axes"],
            "debug_state": json.loads(_http(port, "/v2/debug/state")[2])["devices"]["models"][
                "text_encoder_tp"]["axes"],
        }
        snapshot = model._executor.snapshot()
        stats = _stats(port, "text_encoder_tp")
    worst = 0.0
    for seq, got in zip(seqs, answers):
        want = plain.execute({"INPUT_IDS": seq[None]}, {})["EMBEDDING"][0]
        share = float(np.abs(got - want).max() / np.abs(want).max())
        worst = max(worst, share)
    if not worst <= 1e-4:
        raise AssertionError(f"text_encoder_tp vs the unsharded encoder: {worst} > 1e-4")
    if any(value != {"dp": 2, "tp": 2} for value in axes.values()):
        raise AssertionError(f"mesh axes {axes}")
    result = {"requests": len(seqs), "worst_share": worst, "wall_s": wall,
              "latency_ms_p50": 1e3 * percentile(latencies, 0.5),
              "latency_ms_max": 1e3 * max(latencies),
              "executions": stats["execution_count"], "executor": snapshot}
    print("tp 15c: " + json.dumps(result) + f" [{card()}]", flush=True)
    del model, plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return result


@timed_phase("15d")
def llama_ring_15d(params) -> dict:
    """Phase 15d: ``llama_ring`` at Llama-7B's widths, bf16, sp=2 on
    ``[cuda:0] * 2`` over phase 4's weights: prompts of 1,024 and 4,096
    tokens. The oracle is the dense forward's last position in fp32 on
    the same weights: the dense bf16 forward itself lies 2.4-3.5 % of the
    largest |logit| from it on an H100 (PERF.md), so two bf16 paths cannot
    be held within 2 % of each other. The ring's LOGITS must lie within 2 %
    of the largest |logit| of the oracle, or no farther from it than 1.5 x
    the dense bf16 forward, with the oracle's top-1 unless its top two lie
    within ``TIE_SHARE``."""
    import dataclasses

    import numpy as np

    from client_tpu_torch.models.serving import RingPrefillLlamaModel

    config = llama.LlamaConfig()
    model = RingPrefillLlamaModel(config=config, params=params, devices=[DEVICE, DEVICE])
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, config.vocab_size, n, dtype=np.int32) for n in (1024, 4096)]
    answers, ms = [], []
    with (http_server(model) as port,
          client_http.InferenceServerClient(f"127.0.0.1:{port}", network_timeout=600) as client):
        way = _ClientRoute(client, "none")
        for prompt in prompts:
            t0 = time.perf_counter()
            answers.append(way.infer("llama_ring", [("INPUT_IDS", "INT32", prompt[None])],
                                     [("LOGITS", None, None)])["LOGITS"][0])
            ms.append((time.perf_counter() - t0) * 1e3)
        way.close()
        snapshot = model._executor.snapshot()
    del model

    def share(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    fp32 = dataclasses.replace(config, dtype=torch.float32)
    rows = []
    with torch.inference_mode():
        upcast = {key: value.float() for key, value in params.items() if key != "layers"}
        upcast["layers"] = [{key: value.float() for key, value in layer.items()}
                            for layer in params["layers"]]
        for prompt, got in zip(prompts, answers):
            tokens = torch.from_numpy(prompt[None]).to(DEVICE)
            # the dense paths build one layer's fp32 scores at a time
            dense = llama.forward(params, tokens, config)[0, -1].float().cpu().numpy()
            oracle = llama.forward(upcast, tokens, fp32)[0, -1].cpu().numpy()
            top2 = np.argsort(oracle)[-2:][::-1]
            tie = float(oracle[top2[0]] - oracle[top2[1]]) <= TIE_SHARE * float(
                np.abs(oracle).max())
            row = {"tokens": len(prompt), "ring_vs_fp32": share(got, oracle),
                   "dense_vs_fp32": share(dense, oracle), "ring_vs_dense": share(got, dense),
                   "top1": [int(got.argmax()), int(dense.argmax()), int(top2[0])]}
            row["limit"] = max(0.02, 1.5 * row["dense_vs_fp32"])
            if row["ring_vs_fp32"] > row["limit"] or not (
                    int(got.argmax()) == int(top2[0]) or (tie and int(got.argmax()) in top2)):
                raise AssertionError(f"llama_ring against the fp32 oracle: {row}")
            rows.append(row)
        del upcast
    gc.collect()
    torch.cuda.empty_cache()
    result = {"prompts": rows, "request_ms": ms, "executor": snapshot}
    print("tp 15d: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("15e")
def default_resolution_15e() -> dict:
    """Phase 15e: the zoo on the one-card host: ``text_encoder_tp`` and
    ``llama_ring`` UNAVAILABLE with the reference's reasons, as is an
    ``LlmEngineModel(tp=2)`` without ``devices``; the server stays ready,
    the models answer 503, and ``/metrics`` credits device ``cuda:0``
    only."""
    import numpy as np

    from client_tpu_torch.llm.serving import LlmEngineModel

    tp_engine = LlmEngineModel(name="llm_engine_tp", tp=2, device=DEVICE,
                               config=llama.LlamaConfig.tiny(dtype=torch.float32))
    reasons = {"text_encoder_tp": "load failed: mesh requires 4 devices, host has 1",
               "llama_ring": "load failed: mesh requires 2 devices, host has 1",
               "llm_engine_tp": "load failed: mesh requires 2 devices, host has 1"}
    with (http_server(tp_engine, zoo=True, unavailable=tuple(reasons)) as port,
          client_http.InferenceServerClient(f"127.0.0.1:{port}") as client):
        index = {e["name"]: e for e in json.loads(_http(port, "/v2/repository/index",
                                                        "POST", {})[2])}
        got = {name: index[name]["reason"] for name in reasons}
        if got != reasons:
            raise AssertionError(f"index reasons {got}")
        ready = _http(port, "/v2/health/ready")[0]
        refused = _http(port, "/v2/models/text_encoder_tp/infer", "POST",
                        {"inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                     "shape": [1, 8], "data": [1] * 8}]})[0]
        way = _ClientRoute(client, "none")
        way.infer("text_encoder", [("INPUT_IDS", "INT32", np.ones([1, 8], dtype=np.int32))],
                  [("EMBEDDING", None, None)])
        way.close()
        topology = json.loads(_http(port, "/v2")[2])["devices"]["models"]
        family = _scrape(port)["tpu_device_compute_ns_total"]
        labels = sorted({sample.labels.get("device") for sample in family.samples})
    if ready != 200 or refused != 503:
        raise AssertionError(f"ready {ready}, infer on an unavailable mesh {refused}")
    if labels != ["cuda:0"]:
        raise AssertionError(f"per-device duty labels {labels}")
    unresolved = {name: topology[name] for name in ("text_encoder_tp", "llama_ring")}
    if any(doc.get("resolved") is not False for doc in unresolved.values()):
        raise AssertionError(f"topology of the unresolved meshes: {unresolved}")
    result = {"reasons": got, "ready": ready, "infer_status": refused,
              "duty_labels": labels}
    print("tp 15e: " + json.dumps(result), flush=True)
    return result


@timed_phase("15")
def sharded_15(params, plain_streams, served) -> dict:
    """Phase 15 (a-e), after phase 5 on phase 4's weights."""
    return {"15a": tp_tiny_15a(), "15b": tp_7b_15b(params, plain_streams, served),
            "15c": text_encoder_tp_15c(), "15d": llama_ring_15d(params),
            "15e": default_resolution_15e()}


# ---------------------------------------------------------------------------
# phase 16: the pod (two processes on the card) and the fleet tier
# ---------------------------------------------------------------------------

POD_SPECULATION = {"mode": "ngram", "k": 4, "ngram": 2}
# 16a's prompts repeat a phrase, so the n-gram proposer drafts from the
# first step on and the verify step (K2) runs on random weights too
POD_TINY_PROMPTS = ["w1 w2 w3 w4 w1 w2 w3 w4 w1 w2 w3",
                    "x5 x6 x7 x5 x6 x7 x5 x6",
                    "the cat sat the cat sat the cat",
                    "a b c d e a b c d e a b c",
                    "up down up down up down",
                    "p q p q p q p q p q",
                    "one two three one two three one",
                    "k l m n o k l m n o k"]
POD_TINY_TOKENS = 24
# what every pod member must report: the card, and the CUDA kernels
POD_MEMBER = ("cuda:0", "cuda")


def start_pod(env):
    """``python -m client_tpu_torch.pod.worker`` launched in two
    processes on ``cuda:0`` (a gloo group: NCCL takes one rank a card),
    serving ``llm_engine`` with the settings in ``env``. Returns (the
    launcher, its stats path, the directory holding it) for :func:`pod`."""
    from client_tpu_torch.pod import PodLauncher

    tmp = tempfile.TemporaryDirectory()
    stats = os.path.join(tmp.name, "stats")
    launcher = PodLauncher(2, 1, device=DEVICE, env_extra={
        "CLIENT_TPU_POD_MODEL_NAME": "llm_engine", "CLIENT_TPU_POD_STATS_FILE": stats, **env})
    launcher.launch()
    return launcher, stats, tmp


@contextlib.contextmanager
def pod(started, ready_s=300.0):
    """A pod :func:`start_pod` launched, once it serves: yields (launcher,
    ports, stats path). The members' counters are read through
    :func:`member_stats`; every process is stopped on the way out."""
    launcher, stats, tmp = started
    try:
        ports = launcher.wait_ready(ready_s)
        if (ports["backend"], ports["device"], ports["process_count"]) != (
                "gloo", POD_MEMBER[0], 2):
            raise AssertionError(f"pod layout {ports}")
        yield launcher, ports, stats
    except BaseException:
        print(launcher.log_tail(4000), flush=True)
        raise
    finally:
        launcher.stop(timeout_s=30)
        tmp.cleanup()


def member_stats(launcher, stats) -> list:
    """Each member's counters since the previous call (SIGUSR2: device
    calls by op and their ms, K1/K2 launches, peak memory), set to 0 as
    they are read. A member that serves from anything but the CUDA kernel
    fails the run."""
    paths = [f"{stats}.{i}" for i in range(len(launcher.procs))]
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)
    for proc in launcher.procs:
        proc.send_signal(signal.SIGUSR2)
    docs = []
    for path in paths:
        deadline = time.monotonic() + 30
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.02)
        with open(path) as f:
            docs.append(json.load(f))
    for doc in docs:
        if (doc["device"], doc["decode_kernel"]) != POD_MEMBER:
            raise AssertionError(f"pod member {doc['process_index']} serves on "
                                 f"{doc['device']} with {doc['decode_kernel']}")
    return docs


def _member_launches(docs, n_layers, verify=False, lockstep=True) -> dict:
    """Each member's K1 (and with ``verify`` K2) launches, checked against
    its device calls: one launch a layer a decode (verify) call, the
    member holding one head shard. Without ``lockstep`` (a member was
    replaced between the reads, and the warmup probes of the new engines
    launch too) the launches must cover the calls."""
    out = {}
    for doc in docs:
        decode, multi = doc["ops"].get("decode", 0), doc["ops"].get("decode_multi", 0)
        short = (doc["k1_launches"] < n_layers * decode if not lockstep
                 else doc["k1_launches"] != n_layers * decode)
        if short or decode < 1:
            raise AssertionError(f"member {doc['process_index']}: K1 {doc['k1_launches']} "
                                 f"for {decode} decode calls x {n_layers} layers")
        if verify and (doc["k2_launches"] != n_layers * multi or multi < 1):
            raise AssertionError(f"member {doc['process_index']}: K2 {doc['k2_launches']} "
                                 f"for {multi} verify calls x {n_layers} layers")
        out[str(doc["process_index"])] = {"k1": doc["k1_launches"], "k2": doc["k2_launches"]}
    if lockstep and docs[0]["ops"] != docs[1]["ops"]:
        raise AssertionError(f"the members ran other device calls: {docs[0]['ops']} / "
                             f"{docs[1]['ops']}")
    return out


GLOO_PROBE_PY = """
import json, os, sys

import torch
import torch.distributed as dist

from client_tpu_torch.pod.runtime import PodConfig, abandon, initialize

runtime = initialize(PodConfig.from_env())
device = runtime.device
out = {}
for name, call in (
        ("all_reduce", lambda t: dist.all_reduce(t)),
        ("broadcast", lambda t: dist.broadcast(t, 0)),
        ("all_gather", lambda t: dist.all_gather([torch.empty_like(t) for _ in range(2)], t)),
        ("reduce_scatter", lambda t: dist.reduce_scatter(t, [t.clone(), t.clone()])),
        ("all_to_all", lambda t: dist.all_to_all([torch.empty_like(t)] * 2, [t, t]))):
    try:
        call(torch.ones(4, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[name] = "accepted"
    except Exception as e:  # noqa: BLE001 - the answer is the point
        out[name] = type(e).__name__ + ": " + str(e).splitlines()[0][:120]
    dist.barrier()
if runtime.process_index == 0:
    with open(os.environ["GLOO_PROBE_OUT"], "w") as f:
        json.dump(out, f)
abandon()
"""


def start_gloo_probe():
    """Launch the probe of which collectives a gloo group of two
    processes on ``cuda:0`` takes for CUDA tensors directly (the port
    stages every one through the host on a gloo group, so none of the
    serving path depends on the answer); :func:`gloo_on_cuda` reads it."""
    from client_tpu_torch.pod import PodLauncher

    tmp = tempfile.TemporaryDirectory()
    with open(os.path.join(tmp.name, "gloo_probe.py"), "w") as f:
        f.write(GLOO_PROBE_PY)
    launcher = PodLauncher(2, 1, device=DEVICE, module="gloo_probe", with_bus=False,
                           env_extra={"PYTHONPATH": os.pathsep.join([tmp.name, ROOT]),
                                      "GLOO_PROBE_OUT": os.path.join(tmp.name, "out.json")})
    launcher.launch()
    return launcher, tmp


def gloo_on_cuda(probe) -> dict:
    """The answer of a probe :func:`start_gloo_probe` launched."""
    launcher, tmp = probe
    try:
        deadline = time.monotonic() + 120
        while None in launcher.poll() and time.monotonic() < deadline:
            time.sleep(0.1)
        codes = launcher.stop(timeout_s=10)
        out = os.path.join(tmp.name, "out.json")
        if codes != [0, 0] or not os.path.exists(out):
            raise AssertionError(f"gloo probe exited {codes}:\n{launcher.log_tail()}")
        with open(out) as f:
            return json.load(f)
    finally:
        tmp.cleanup()


@timed_phase("16a")
def pod_tiny_16a() -> dict:
    """16a: the tiny fp32 Llama (phase 15a's config and seed-0 weights) in
    a pod of two processes on the card with n-gram speculation: eight
    greedy streams over HTTP equal the single-process tp=2 engine's on
    ``[cuda:0, cuda:0]`` and the dense oracle, and each member launches K1
    and K2 on its head shard."""
    import numpy as np

    from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32)
    t0 = time.perf_counter()
    env = {"CLIENT_TPU_POD_MAX_SEQ_LEN": "64",
           "CLIENT_TPU_POD_SPECULATION": json.dumps(POD_SPECULATION)}
    with pod(start_pod(env), ready_s=180) as (launcher, ports, stats):
        up_s = time.perf_counter() - t0
        member_stats(launcher, stats)
        # -- the main path: counters zeroed just before, read just after --
        records = [dict() for _ in POD_TINY_PROMPTS]
        threads = [threading.Thread(target=_stream_one, args=(
            ports["http_port"], p, POD_TINY_TOKENS, r)) for p, r in zip(POD_TINY_PROMPTS,
                                                                        records)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(300)
        docs = member_stats(launcher, stats)
        # -------------------------------------------------------------------
    launches = _member_launches(docs, config.n_layers, verify=True)
    served = [r.get("tokens") for r in records]
    params = llama.init_params(torch.Generator(device=DEVICE).manual_seed(0), config, DEVICE)
    ids = [SyntheticTokenizer(config.vocab_size).encode(p) for p in POD_TINY_PROMPTS]
    model = LlmEngineModel(config=config, params=params, tp=2, devices=[DEVICE, DEVICE],
                           speculation=POD_SPECULATION)
    model.warmup()

    async def one(prompt):
        out = []
        async for item in model.execute_decoupled(
                {"INPUT_IDS": np.array(prompt, dtype=np.int32)},
                {"max_tokens": POD_TINY_TOKENS}):
            out.append(int(item["OUTPUT_IDS"][0]))
        return out

    async def all_streams():
        return await asyncio.gather(*(one(p) for p in ids))

    single = asyncio.run(all_streams())
    model.shutdown()
    dense = [llama.generate(params, torch.tensor([p], device=DEVICE), config,
                            POD_TINY_TOKENS)[0].tolist() for p in ids]
    if not served == single == dense:
        raise AssertionError(f"pod streams {served}, single-process tp=2 {single}, "
                             f"dense {dense}")
    result = {"up_s": up_s, "launches": launches, "ops": docs[0]["ops"],
              "streams_equal": True}
    print("pod 16a: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


def _pod_streams(port, records, started=None):
    """Phase 4's 8 prompts as concurrent streams into ``records``
    (``started``: an Event a stream, set at its first token)."""
    started = started or [None] * len(records)
    threads = [threading.Thread(target=_stream_one, args=(port, p, SERVE_TOKENS, r),
                                kwargs={"started": e})
               for p, r, e in zip(_prompts(), records, started)]
    for thread in threads:
        thread.start()
    return threads


def _check_streams(records, vocab_size) -> None:
    for i, record in enumerate(records):
        if record.get("status") != 200 or not record.get("done"):
            raise AssertionError(f"stream {i} failed: {record}")
        if len(record["tokens"]) != SERVE_TOKENS:
            raise AssertionError(f"stream {i} delivered {len(record['tokens'])} tokens")
        if not all(0 <= t < vocab_size for t in record["tokens"]):
            raise AssertionError(f"stream {i} has out-of-vocabulary ids")


def _parted(config, against, records) -> list:
    """Where each stream of ``records`` parts from ``against`` (15b's
    streams), held to the dense near-tie rule; the dense forward runs on
    seed-0 weights drawn again only when a stream parts."""
    params = None
    out = []
    for prompt, want, record in zip(_prompts(), against, records):
        if record["tokens"] == want:
            out.append({})
            continue
        if params is None:
            params = llama.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                                       config, DEVICE)
        out.append(_same_or_tie(params, config, prompt, want, record["tokens"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


@timed_phase("16b-16c")
def pod_7b_16bc(tp_streams, started) -> dict:
    """16b: the 7B's widths, bf16, seed-0 weights (phase 4's), tp=2 over
    two processes on the card: phase 4's 8 streams of 32 tokens through
    the coordinator's HTTP front-end, each equal to 15b's tp=2 stream or
    parting at a dense near-tie; K1 32 x decode calls in each member.
    16c: the same streams again; member 1 is SIGKILLed once every stream
    has its first tokens, ``PodSupervisor`` respawns it, the group
    re-forms at epoch 1, and the streams resume (equal to 16b's or parting
    at a near-tie). ``started``: the 7B pod, as :func:`start_pod` launched
    it."""
    from client_tpu_torch.pod import PodSupervisor

    config = llama.LlamaConfig()
    with pod(started) as (launcher, ports, stats):
        port = ports["http_port"]
        docs_up = member_stats(launcher, stats)
        # -- 16b, the main path: counters zeroed just before, read just after --
        records = [dict() for _ in range(8)]
        t_start = time.perf_counter()
        for thread in _pod_streams(port, records):
            thread.join(900)
        wall = time.perf_counter() - t_start
        docs_b = member_stats(launcher, stats)
        # -------------------------------------------------------------------
        _check_streams(records, config.vocab_size)
        launches_b = _member_launches(docs_b, config.n_layers)
        # -- 16c: a member lost under the same streams ------------------------
        events = []
        supervisor = PodSupervisor(launcher, poll_interval_s=0.1, deadline_s=600,
                                   on_event=events.append).start()
        try:
            records_c = [dict() for _ in range(8)]
            started = [threading.Event() for _ in range(8)]
            threads = _pod_streams(port, records_c, started)
            for event in started:
                event.wait(300)
            t_fault = time.perf_counter()
            launcher.kill(1)
            for thread in threads:
                thread.join(900)
            deadline = time.monotonic() + 120
            while not events and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            supervisor.stop()
        docs_c = member_stats(launcher, stats)
        metrics = _http(port, "/metrics")[2]
    if [e["outcome"] for e in events] != ["success"] or events[0]["epoch"] != 1:
        raise AssertionError(f"pod recovery events {events}")
    if 'tpu_recovery_total{tier="pod",outcome="success"} 1' not in metrics:
        raise AssertionError("the coordinator booked no pod recovery")
    _check_streams(records_c, config.vocab_size)
    parted_b = _parted(config, tp_streams, records)
    parted_c = _parted(config, [r["tokens"] for r in records], records_c)
    gib = 2.0 ** 30
    result_b = latency(records, wall)
    result_b.update(
        backend=ports["backend"], launches=launches_b, ops=docs_b[0]["ops"],
        decode_call_ms_mean={d["process_index"]: d["ops_ms"]["decode"] / d["ops"]["decode"]
                             for d in docs_b},
        collectives={d["process_index"]: {"calls": d["collectives"], "ms": d["collective_ms"]}
                     for d in docs_b},
        build_peak_gib={d["process_index"]: d.get("max_memory_allocated", 0) / gib
                        for d in docs_up},
        peak_gib={d["process_index"]: d.get("max_memory_allocated", 0) / gib for d in docs_b},
        settled_gib={d["process_index"]: d.get("memory_allocated", 0) / gib for d in docs_b},
        parted_from_15b=[p for p in parted_b if p],
    )
    result_c = {
        "mttr_s": events[0]["duration_s"],
        "longest_gap_ms": _longest_gap_ms(records_c, t_fault),
        "launches": _member_launches(docs_c, config.n_layers, lockstep=False),
        "ops": [d["ops"] for d in docs_c],
        "peak_gib": {d["process_index"]: d.get("max_memory_allocated", 0) / gib for d in docs_c},
        "parted_from_16b": [p for p in parted_c if p],
    }
    print("pod 16b: " + json.dumps(result_b) + f" [{card()}]", flush=True)
    print("pod 16c: " + json.dumps(result_c) + f" [{card()}]", flush=True)
    return {"16b": result_b, "16c": result_c}


@timed_phase("16d")
def fleet_16d(device="cuda", model_py=None) -> dict:
    """16d: ``python -m client_tpu_torch.perf --fleet 2`` over ResNet-50 on
    the card (each replica loads phase 11's model directory), c=8,
    ``--rolling-restart 2``: no failed request and a fleet row per
    replica; then a 2-rank ``--world-size 2`` run of two harness
    processes against one server."""
    from client_tpu_torch.pod.launcher import _free_port

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "resnet50"))
        with open(os.path.join(tmp, "resnet50", "model.py"), "w") as f:
            f.write(model_py or RESNET_MODEL_PY.format(extra=""))
        proc = subprocess.run(
            [sys.executable, "-m", "client_tpu_torch.perf", "-m", "resnet50", "--fleet", "2",
             "--fleet-device", device, "--fleet-model-repository", tmp,
             "--concurrency-range", "8", "--rolling-restart", "2",
             "--routing-policy", "least-outstanding", "--measurement-interval", "2000",
             "--max-trials", "3", "--json-summary"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"--fleet 2 exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = summary.get("fleet", {}).get("replicas", [])
    if summary["errors"] != 0 or len(rows) != 2 or summary["rolling_restart_cycles"] < 1:
        raise AssertionError(f"--fleet 2: {summary}")
    result = {"infer_per_s": summary["throughput"], "p99_ms": summary["p99_us"] / 1e3,
              "errors": summary["errors"], "cycles": summary["rolling_restart_cycles"],
              "replicas": rows, "skew": summary["fleet"]["skew"],
              "report": [line for line in proc.stdout.splitlines()
                         if line.startswith(("Fleet", "  Skew"))]}
    with http_server(builtins=True) as port:
        coordinator = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        ranks = [subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.perf", "-m", "simple", "-u",
             f"127.0.0.1:{port}", "--concurrency-range", "4", "--measurement-interval", "1000",
             "--max-trials", "2", "--world-size", "2", "--rank", str(rank), "--coordinator",
             coordinator, "--json-summary", "-v"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in (0, 1)]
        outs = [p.communicate(timeout=300) for p in ranks]
    world = []
    for rank, (p, (out, err)) in enumerate(zip(ranks, outs)):
        if p.returncode != 0 or f"rank {rank}/2 ready" not in out:
            raise AssertionError(f"rank {rank} exited {p.returncode}:\n{out[-1500:]}\n"
                                 f"{err[-1500:]}")
        doc = json.loads(out.strip().splitlines()[-1])
        if doc["errors"] != 0:
            raise AssertionError(f"rank {rank}: {doc}")
        world.append({"infer_per_s": doc["throughput"], "p99_ms": doc["p99_us"] / 1e3})
    result["world_size_2"] = world
    print("fleet 16d: " + json.dumps(result) + f" [{card()}]", flush=True)
    return result


@timed_phase("16")
def pod_16(tp_streams) -> dict:
    """Phase 16 (a-d), after phase 4's weights are freed. The gloo probe
    and the 7B pod start while 16a runs (16a checks answers only); 16b's
    streams begin once 16a is done."""
    probe = start_gloo_probe()
    big = start_pod({"CLIENT_TPU_POD_WIDTH": "llama-7b"})
    try:
        tiny = pod_tiny_16a()
        tiny["gloo_on_cuda"] = gloo_on_cuda(probe)
        print("pod 16a gloo on cuda: " + json.dumps(tiny["gloo_on_cuda"]), flush=True)
    except BaseException:
        for launcher, tmp in (probe, big[::2]):
            launcher.stop(timeout_s=10)
            tmp.cleanup()
        raise
    return {"16a": tiny, **pod_7b_16bc(tp_streams, big), "16d": fleet_16d()}


# ---------------------------------------------------------------------------
# phase 17: the router tier in front of two 7B replicas
# ---------------------------------------------------------------------------

# each replica's pool: 512 blocks of 16 tokens (8.4 MB a block at the 7B's
# widths, 4.3 GB a pool); a stream of phase 4's needs at most 24 blocks
ROUTER_POOL_BLOCKS = 512
# the second router's admission limit (17d)
ROUTER_SHED_LIMIT = 4
ROUTER_SHED_RETRY_S = 0.25  # the router's default retry-after hint


def _router_replica(params, config):
    """An ``InProcessServer`` with the native gRPC front-end on the card:
    the built-ins (``simple`` among them) and an ``llm_engine`` on
    ``params`` (shared, not copied) with a pool of its own. Returns
    (server, model)."""
    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.testing import InProcessServer

    model = LlmEngineModel(config=config, params=params, device=DEVICE,
                           engine_config=EngineConfig(
                               block_size=16, num_blocks=ROUTER_POOL_BLOCKS, max_active=8,
                               max_queue=64, max_seq_len=config.max_seq_len))
    server = InProcessServer(device=DEVICE, grpc="native")
    server.core.repository.add_model(model)
    return server.start(), model


def spawn_router(directory, name, replica_files, *flags):
    """``python -m client_tpu_torch.router --serve`` over the replicas'
    ports files, in a process that cannot see the card (the router never
    asks for it). It starts at once and waits for the files, so its start
    overlaps the replicas'. Returns (process, its ports file, its log,
    the time it was started)."""
    ports_file = os.path.join(directory, f"{name}.json")
    log = open(os.path.join(directory, f"{name}.log"), "w+")
    files = [arg for path in replica_files for arg in ("--replica-ports-file", path)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.router", "--serve", *files, "--ports-file",
         ports_file, "--probe-interval", "0.1", "--backend-wait", "300", *flags],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=subprocess.DEVNULL,
        stderr=log)
    return proc, ports_file, log, time.perf_counter()


def await_router(proc, ports_file, log, t0) -> dict:
    """The router's ports once it serves, with its start-up seconds."""
    from client_tpu_torch.perf.fleet_runner import read_ports_file

    deadline = time.perf_counter() + 300
    while time.perf_counter() < deadline:
        ports = read_ports_file(ports_file)
        if ports is not None:
            return dict(ports, start_s=time.perf_counter() - t0)
        if proc.poll() is not None:
            log.seek(0)
            raise AssertionError(f"the router exited {proc.returncode}: {log.read()[-2000:]}")
        time.sleep(0.05)
    raise AssertionError("the router published no ports in 300 s")


def _router_status(http_port) -> dict:
    status, _, body = _http(http_port, "/v2/router/status")
    if status != 200:
        raise AssertionError(f"/v2/router/status answered {status}")
    return json.loads(body)


def _held_to_phase4(params, config, prompts, plain_streams, records, indices=None) -> list:
    """Each stream of ``records`` delivers ``SERVE_TOKENS`` tokens equal to
    phase 4's for its prompt, or parting at a dense near-tie (11a's
    rule); returns the near-ties."""
    ties = []
    for i, record in zip(indices or range(len(records)), records):
        if len(record["tokens"]) != SERVE_TOKENS:
            raise AssertionError(f"a routed stream delivered {len(record['tokens'])} tokens")
        parted = _same_or_tie(params, config, prompts[i], plain_streams[i], record["tokens"])
        if parted:
            ties.append(parted)
    return ties


def _streams_on(replicas, grpc_port, ids):
    """Phase 4's streams over ``ModelStreamInfer`` to ``grpc_port``, K1's
    counter zeroed just before and read once every engine is idle.
    Returns (records, wall, K1 launches, decode steps and streams booked
    a replica)."""
    steps0 = [model.engine.steps for _, model in replicas]
    before = [_stats(server.http_port, "llm_engine") for server, _ in replicas]
    # -- the path: K1's counter zeroed just before, read once idle --------
    pa.paged_attention_cuda.launches = 0
    records, _, wall = asyncio.run(_grpc_streams(grpc_port, ids, SERVE_TOKENS))
    for _, model in replicas:
        _wait_idle(model.engine, timeout_s=60)
    launches = pa.paged_attention_cuda.launches
    # ----------------------------------------------------------------------
    steps = [model.engine.steps - s0 for (_, model), s0 in zip(replicas, steps0)]
    booked = [_booked(b, _stats(server.http_port, "llm_engine"))
              for (server, _), b in zip(replicas, before)]
    return records, wall, launches, steps, booked


def _simple_inputs(module):
    import numpy as np

    a = np.arange(16, dtype=np.int32)[None]
    return [module.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
            module.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(a)]


def router_kill_17c(router, replicas) -> dict:
    """17c: 4 client threads send ``simple`` through the router while
    replica B stops; no client sees a failure, the router benches B."""
    import numpy as np

    import client_tpu_torch.grpc as grpcclient

    url = f"127.0.0.1:{router['grpc_port']}"
    stop = threading.Event()
    answers, failures = [0] * 4, []
    want = 2 * np.arange(16, dtype=np.int32)[None]

    def client(i):
        with grpcclient.InferenceServerClient(url) as c:
            inputs = _simple_inputs(grpcclient)
            while not stop.is_set():
                try:
                    result = c.infer("simple", inputs)
                    if not np.array_equal(result.as_numpy("OUTPUT0"), want):
                        failures.append("simple answered wrong")
                    answers[i] += 1
                except Exception as e:  # noqa: BLE001 - every failure is counted
                    failures.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for thread in threads:
        thread.start()
    time.sleep(1.0)
    before_stop = sum(answers)
    t0 = time.perf_counter()
    server_b, model_b = replicas[1]
    server_b.stop()
    stop_s = time.perf_counter() - t0
    time.sleep(1.5)
    stop.set()
    for thread in threads:
        thread.join(30)
    states = {e["url"]: e["state"] for e in _router_status(router["http_port"])["pool"]["endpoints"]}
    b_url = f"127.0.0.1:{server_b.grpc_port}"
    result = {"answers": sum(answers), "answers_before_stop": before_stop,
              "client_failures": len(failures), "replica_b_stop_s": stop_s,
              "states": states}
    if failures or sum(answers) <= before_stop:
        raise AssertionError(f"17c: {result}; {failures[:3]}")
    if states.get(b_url) == "up":
        raise AssertionError(f"17c: the router did not bench the stopped replica: {states}")
    return result


async def _shed_burst(grpc_port, ids, defaults, protected) -> list:
    """``defaults`` + ``protected`` 7B streams at once, one a stream, the
    last ``protected`` at priority 1. Returns a record each: its tokens,
    or the in-band error."""
    import numpy as np

    import client_tpu_torch.grpc.aio as grpc_aio

    client = grpc_aio.InferenceServerClient(f"127.0.0.1:{grpc_port}")

    async def one(prompt_ids, priority):
        x = grpc_aio.InferInput("INPUT_IDS", [len(prompt_ids)], "INT32")
        x.set_data_from_numpy(np.array(prompt_ids, dtype=np.int32))

        async def requests():
            yield {"model_name": "llm_engine", "inputs": [x], "priority": priority,
                   "parameters": {"max_tokens": SERVE_TOKENS}}

        record = {"priority": priority, "tokens": [], "error": None}
        async for result, error in client.stream_infer(requests()):
            if error is not None:
                record["error"] = error
                break
            out = result.as_numpy("OUTPUT_IDS")
            if out is not None and out.size:
                record["tokens"].extend(int(t) for t in out.reshape(-1))
            final = result.get_response().parameters.get("triton_final_response")
            if final is not None and final.bool_param:
                break
        return record

    records = await asyncio.gather(*(one(ids[i % len(ids)], 0) for i in range(defaults)),
                                   *(one(ids[i % len(ids)], 1) for i in range(protected)))
    await client.close()
    return records


async def _unary_sheds(router) -> dict:
    """With the shedding router's slots held by ``repeat_int32`` streams
    whose first frame comes after 3 s: an HTTP ``/infer`` of ``simple``
    and a gRPC unary ``simple`` past the limit, each refused with its
    retry hint."""
    import numpy as np

    import client_tpu_torch.grpc.aio as grpc_aio
    from client_tpu_torch.utils import InferenceServerException

    client = grpc_aio.InferenceServerClient(f"127.0.0.1:{router['grpc_port']}")

    async def hold():
        x = grpc_aio.InferInput("IN", [1], "INT32").set_data_from_numpy(
            np.array([5], dtype=np.int32))

        async def requests():
            yield {"model_name": "repeat_int32", "inputs": [x], "priority": 1,
                   "parameters": {"delay_us": 3_000_000}}

        async for result, error in client.stream_infer(requests()):
            if error is not None:
                raise AssertionError(f"17d: a holding stream failed: {error}")
            return int(result.as_numpy("OUT")[0])

    holds = [asyncio.ensure_future(hold()) for _ in range(ROUTER_SHED_LIMIT)]
    loop = asyncio.get_running_loop()
    for _ in range(200):
        status = await loop.run_in_executor(None, _router_status, router["http_port"])
        if status["inflight"] >= ROUTER_SHED_LIMIT:
            break
        await asyncio.sleep(0.01)
    body = json.dumps({"inputs": [
        {"name": name, "shape": [1, 16], "datatype": "INT32", "data": list(range(16))}
        for name in ("INPUT0", "INPUT1")]})
    conn = http.client.HTTPConnection("127.0.0.1", router["http_port"], timeout=30)
    try:
        await loop.run_in_executor(None, lambda: conn.request(
            "POST", "/v2/models/simple/infer", body=body,
            headers={"Content-Type": "application/json"}))
        response = await loop.run_in_executor(None, conn.getresponse)
        http_shed = {"status": response.status,
                     "retry_after": response.getheader("Retry-After"),
                     "error": json.loads(response.read()).get("error")}
    finally:
        conn.close()
    try:
        await client.infer("simple", _simple_inputs(grpc_aio))
        grpc_shed = {"status": "OK"}
    except InferenceServerException as e:
        grpc_shed = {"status": e.status(), "retry_after_s": getattr(e, "retry_after_s", None),
                     "message": e.message()}
    held = await asyncio.gather(*holds)
    await client.close()
    if held != [5] * ROUTER_SHED_LIMIT:
        raise AssertionError(f"17d: the holding streams answered {held}")
    return {"http": http_shed, "grpc": grpc_shed}


def router_shed_17d(shed_router, replicas, params, config, prompts, plain_streams, ids) -> dict:
    """17d on the second router (``--max-inflight 4``, replica A behind
    it): 8 default-priority streams and 2 at priority 1 at once; a
    default one is shed in-band with RESOURCE_EXHAUSTED and its retry
    hint, no priority-1 one is, every admitted stream equals phase 4's;
    then ``simple`` over HTTP and gRPC unary past the limit: 429 with
    ``Retry-After`` and RESOURCE_EXHAUSTED with ``retry-after`` in its
    trailers."""
    from client_tpu_torch.grpc._mux import _derive_status

    records = asyncio.run(_shed_burst(shed_router["grpc_port"], ids, 8, 2))
    _wait_idle(replicas[0][1].engine, timeout_s=60)
    shed = [r for r in records if r["error"] is not None]
    for record in shed:
        # the in-band frame carries a message only; a stream-mode client
        # derives its status from it
        message = record["error"].message()
        if _derive_status(message) != "StatusCode.RESOURCE_EXHAUSTED" or \
                f"retry after {ROUTER_SHED_RETRY_S:g}s" not in message:
            raise AssertionError(f"17d: a stream failed otherwise: {message}")
    if not any(r["priority"] == 0 for r in shed):
        raise AssertionError("17d: no default-priority stream was shed")
    if any(r["priority"] == 1 for r in shed):
        raise AssertionError("17d: a priority-1 stream was shed")
    admitted = [(i, r) for i, r in enumerate(records) if r["error"] is None]
    ties = _held_to_phase4(params, config, [prompts[i % 8] for i in range(10)],
                           [plain_streams[i % 8] for i in range(10)],
                           [r for _, r in admitted], [i for i, _ in admitted])
    unary = asyncio.run(_unary_sheds(shed_router))
    if unary["http"]["status"] != 429 or \
            unary["http"]["retry_after"] != f"{ROUTER_SHED_RETRY_S:g}":
        raise AssertionError(f"17d: HTTP past the limit: {unary['http']}")
    if unary["grpc"]["status"] != "StatusCode.RESOURCE_EXHAUSTED" or \
            unary["grpc"]["retry_after_s"] != ROUTER_SHED_RETRY_S:
        raise AssertionError(f"17d: gRPC unary past the limit: {unary['grpc']}")
    return {"shed_default": sum(r["priority"] == 0 for r in shed),
            "admitted_default": sum(r["priority"] == 0 for _, r in admitted),
            "admitted_priority_1": sum(r["priority"] == 1 for _, r in admitted),
            "shed_message": shed[0]["error"].message(), "near_ties": ties, **unary}


@timed_phase("17 (router)")
def router_17(params, plain_streams) -> dict:
    """Phase 17: the router tier in front of two replicas, each an
    ``InProcessServer`` with the native gRPC front-end serving an
    ``llm_engine`` on phase 4's weights (pools of their own) and the
    built-ins; the routers are ``python -m client_tpu_torch.router
    --serve`` processes. (a) phase 4's 8 streams through the router, over
    both replicas, equal to phase 4's (or parting at 11a's near-tie),
    K1 exactly 32 x both replicas' decode steps; (b) the same streams
    straight to replica A (the proxy tax, recorded); (c) replica B
    stopped under ``simple`` from 4 client threads: no client failure,
    B benched, then 8 streams all on A; (d) shedding on a second router
    (``--max-inflight 4``)."""
    from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
    from client_tpu_torch.perf.fleet_runner import write_ports_file

    config = llama.LlamaConfig()
    prompts = _prompts()
    ids = [SyntheticTokenizer(config.vocab_size).encode(p) for p in prompts]
    result = {}
    replicas, routers = [], []
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, f"replica_{name}.json") for name in ("a", "b")]
        t0 = time.perf_counter()
        # the routers import while the replicas load
        routers.append(spawn_router(tmp, "router", files))
        routers.append(spawn_router(tmp, "router_shed", files[:1], "--max-inflight",
                                    str(ROUTER_SHED_LIMIT)))
        try:
            for path in files:
                server, model = _router_replica(params, config)
                replicas.append((server, model))
                write_ports_file(path, {"http_port": server.http_port,
                                        "grpc_port": server.grpc_port})
            replicas_s = time.perf_counter() - t0
            router, shed_router = (await_router(*started) for started in routers)
            print(f"router 17: two replicas up in {replicas_s:.1f} s, the routers in "
                  f"{router['start_s']:.1f} / {shed_router['start_s']:.1f} s "
                  f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)", flush=True)
            result["start_s"] = {"replicas": replicas_s, "router": router["start_s"],
                                 "router_shed": shed_router["start_s"]}

            # -- 17a: through the router ----------------------------------
            records, wall, launches, steps, booked = _streams_on(
                replicas, router["grpc_port"], ids)
            if launches != config.n_layers * sum(steps):
                raise AssertionError(f"17a: K1 launched {launches} times for {steps} decode "
                                     f"steps x {config.n_layers} layers")
            if sum(booked) != 8 or min(booked) < 1:
                raise AssertionError(f"17a: streams a replica {booked}")
            routed = latency(records, wall)
            routed.update(decode_steps=steps, k1_launches=launches, streams_a_replica=booked,
                          near_ties=_held_to_phase4(params, config, prompts, plain_streams,
                                                    records))
            print("router 17a: " + json.dumps(routed) + f" [{card()}]", flush=True)
            result["17a"] = routed

            # -- 17b: the same streams straight to replica A ----------------
            records, wall, _, _, _ = _streams_on(replicas, replicas[0][0].grpc_port, ids)
            direct = latency(records, wall)
            direct["near_ties"] = _held_to_phase4(params, config, prompts, plain_streams,
                                                  records)
            tax = {k: routed[k] - direct[k] for k in ("ttft_ms_mean", "itl_ms_mean",
                                                      "itl_ms_p50")}
            print("router 17b: " + json.dumps({"direct": direct, "router_minus_direct": tax})
                  + f" [{card()}]", flush=True)
            result["17b"] = {"direct": direct, "router_minus_direct": tax}

            # -- 17c: replica B stopped under load ----------------------------
            killed = router_kill_17c(router, replicas)
            replicas[1][1].engine = None  # B's pool goes with it
            records, wall, launches, steps, booked = _streams_on(
                replicas[:1], router["grpc_port"], ids)
            if booked != [8] or launches != config.n_layers * steps[0]:
                raise AssertionError(f"17c: after the stop, A booked {booked} streams, K1 "
                                     f"{launches} for {steps} decode steps")
            killed.update(after=latency(records, wall), k1_launches=launches,
                          decode_steps=steps[0],
                          near_ties=_held_to_phase4(params, config, prompts, plain_streams,
                                                    records))
            print("router 17c: " + json.dumps(killed) + f" [{card()}]", flush=True)
            result["17c"] = killed

            # -- 17d: shedding ---------------------------------------------------
            shed = router_shed_17d(shed_router, replicas, params, config, prompts,
                                   plain_streams, ids)
            print("router 17d: " + json.dumps(shed) + f" [{card()}]", flush=True)
            result["17d"] = shed
        finally:
            for proc, _, log, _ in routers:
                proc.terminate()
                try:
                    proc.wait(30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                log.close()
            for server, model in replicas:
                server.stop()
                model.engine = None
    gc.collect()
    torch.cuda.empty_cache()
    return result


TRAIN_STEPS = 3
TRAIN_PLAN = {"dp": 2, "sp": 2, "tp": 2}
TRAIN_TOKENS = 512
TRAIN_LAYERS = (32, 24, 16)  # the largest whose reckoned peak fits runs
TRAIN_PEAK_GIB = 72.0
TRAIN_ACT_BYTES = 0.18e9  # saved activations a 7B layer at [1, 512] (PERF.md)
H100_BF16_TFLOPS = 989.0  # dense, NVIDIA's data sheet (SXM)


def _train_run(start, tokens, config, axes, device):
    """The first step's gradients, then ``TRAIN_STEPS`` train steps on one
    batch from a copy of ``start`` on ``device`` (under ``axes`` over
    ``[device] * 8``): (gradients, parameters, losses)."""
    from client_tpu_torch.parallel import sharding

    plan = None
    if axes is not None:
        spec = sharding.MeshSpec.parse({"axes": axes})
        plan = sharding.resolve(spec, [device] * spec.device_count)
    tokens = tokens.to(device)
    watched = [leaf.to(device, copy=True).requires_grad_() for leaf in llama._leaves(start)]
    grads = torch.autograd.grad(
        llama.loss_fn(llama._rebuild(start, iter(watched)), tokens, config, plan), watched)
    params = llama._rebuild(start, (leaf.to(device, copy=True) for leaf in llama._leaves(start)))
    train_step, optimizer = llama.make_train_step(config, plan)
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = train_step(params, opt_state, tokens)
        losses.append(float(loss))
    return [g.cpu() for g in grads], [p.cpu() for p in llama._leaves(params)], losses


def train_tiny_18a() -> dict:
    """Phase 18a: three tiny fp32 train steps on the card equal to the
    same steps on the CPU (losses within 1e-5, parameters within 1e-4),
    unsharded and at dp2 x sp2 x tp2 over ``[cuda:0] * 8``; the first
    step's gradients are compared too, since Adam divides by ``sqrt(v) +
    1e-8`` and so magnifies a gradient near 1e-8."""
    import numpy as np

    config = llama.LlamaConfig.tiny(dtype=torch.float32)
    start = llama.init_params(torch.Generator().manual_seed(18), config, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(18).integers(0, config.vocab_size, [4, 16]))
    result = {}
    for name, axes in (("unsharded", None), ("dp2xsp2xtp2", TRAIN_PLAN)):
        want_grads, want, want_losses = _train_run(start, tokens, config, axes, torch.device("cpu"))
        grads, got, losses = _train_run(start, tokens, config, axes, DEVICE)
        row = {"losses": losses, "cpu_losses": want_losses,
               "loss_err": max(abs(a - b) for a, b in zip(losses, want_losses)),
               "grad_err": max(float((a - b).abs().max()) for a, b in zip(grads, want_grads)),
               "param_err": max(float((a - b).abs().max()) for a, b in zip(got, want))}
        if row["param_err"] > 1e-4:
            # the entry that parts, with both sides' first-step gradients
            k = max(range(len(got)), key=lambda i: float((got[i] - want[i]).abs().max()))
            at = int((got[k] - want[k]).abs().argmax())
            row["worst"] = {"leaf": k, "index": at, "cuda": float(got[k].flatten()[at]),
                            "cpu": float(want[k].flatten()[at]),
                            "grad_cuda": float(grads[k].flatten()[at]),
                            "grad_cpu": float(want_grads[k].flatten()[at])}
        print(f"train 18a ({name}): " + json.dumps(row), flush=True)
        if row["loss_err"] > 1e-5 or row["param_err"] > 1e-4:
            raise AssertionError(f"18a ({name}): the card's train steps part from the CPU's: "
                                 f"{row}")
        result[name] = row
    return result


def train_dryrun_18b() -> dict:
    """Phase 18b: ``graft_entry.dryrun_multichip(8)`` (the twin of
    ``__graft_entry__.py``) over eight entries of the one card: 2 x 2 x 2
    and 1 x 2 x 4, one bf16 tiny train step each, their losses within
    1e-3 (the twin raises if not)."""
    from client_tpu_torch import graft_entry

    losses = graft_entry.dryrun_multichip(8, devices=[DEVICE] * 8)
    if [mesh for mesh, _ in losses] != [(2, 2, 2), (1, 2, 4)] or not all(
            math.isfinite(loss) for _, loss in losses):
        raise AssertionError(f"18b: dryrun_multichip gave {losses}")
    result = {"losses": {"x".join(map(str, mesh)): loss for mesh, loss in losses}}
    print("train 18b: " + json.dumps(result), flush=True)
    return result


def train_reckoning(config, layers: int, allocated: int) -> dict:
    """The reckoned peak (GiB) of a bf16 train step at ``layers`` layers of
    ``config``'s widths on ``[1, TRAIN_TOKENS]``: 8 B a parameter (weight,
    gradient, the two AdamW moments), the optimizer's temporaries (two of
    the largest tensor: it steps one tensor at a time), the saved
    activations, the fp32 logits three times over (logits, log-softmax,
    their gradient), plus what the card already holds."""
    d, f, v = config.d_model, config.d_ff, config.vocab_size
    per_layer = 2 * d * d + 2 * d * config.n_kv_heads * config.head_dim + 3 * d * f + 2 * d
    params = layers * per_layer + 2 * v * d + d
    parts = {"params": params, "state_gib": 8 * params / 2**30,
             "temporaries_gib": 2 * 2 * v * d / 2**30,
             "activations_gib": layers * TRAIN_ACT_BYTES / 2**30,
             "logits_gib": 3 * 4 * TRAIN_TOKENS * v / 2**30,
             "allocated_gib": allocated / 2**30}
    parts["peak_gib"] = sum(value for key, value in parts.items() if key.endswith("_gib"))
    return parts


def train_flops(config, layers: int, tokens: int) -> dict:
    """Matrix-product FLOPs of one train step (backward twice the
    forward): the bf16 weight products and the fp32 attention products
    (``reference_attention`` forms the full square of scores)."""
    d, f, v = config.d_model, config.d_ff, config.vocab_size
    kv = config.n_kv_heads * config.head_dim
    weights = 2 * tokens * (layers * (2 * d * d + 2 * d * kv + 3 * d * f) + d * v)
    attention = layers * 4 * tokens * tokens * d
    return {"bf16": 3 * weights, "fp32_attention": 3 * attention}


def train_7b_18c() -> dict:
    """Phase 18c: timed train steps at Llama-7B's widths (d 4096, 32
    heads, ffn 11008, vocab 32000, bf16) on tokens ``[1, 512]`` with as
    many layers of 32, 24, 16 as the reckoned peak allows under
    ``TRAIN_PEAK_GIB``: one warm step, then ``TRAIN_STEPS`` timed by CUDA
    events (median), the loss of each (finite, the last below the first:
    one batch is being learnt), tokens/s, matrix-product TFLOP/s against
    the card's bf16 dense peak, the peak memory beside its reckoning, and
    one more step's forward and backward and its AdamW update timed
    apart."""
    import numpy as np

    base = llama.LlamaConfig()
    allocated = torch.cuda.memory_allocated()
    reckonings = {n: train_reckoning(base, n, allocated) for n in TRAIN_LAYERS}
    layers = next((n for n in TRAIN_LAYERS if reckonings[n]["peak_gib"] <= TRAIN_PEAK_GIB),
                  None)
    print("train 18c reckoning: " + json.dumps(
        {n: round(r["peak_gib"], 2) for n, r in reckonings.items()})
          + f"; {layers} layers run", flush=True)
    if layers is None:
        raise AssertionError(f"18c: no layer count fits {TRAIN_PEAK_GIB} GiB: {reckonings}")
    config = dataclasses.replace(base, n_layers=layers)
    params = llama.init_params(torch.Generator(device=DEVICE).manual_seed(0), config, DEVICE)
    tokens = torch.from_numpy(np.random.default_rng(18).integers(
        0, config.vocab_size, [1, TRAIN_TOKENS])).to(DEVICE)
    train_step, optimizer = llama.make_train_step(config, None)
    opt_state = optimizer.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, loss = train_step(params, opt_state, tokens)
    losses = [float(loss)]
    warm_ms = (time.perf_counter() - t0) * 1e3
    event_ms, host_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        begin.record()
        params, opt_state, loss = train_step(params, opt_state, tokens)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(begin.elapsed_time(end))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(event_ms)[len(event_ms) // 2]
    # the step's two halves timed apart: the forward and backward, then
    # the optimizer's update on those gradients
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    watched = [leaf.detach().requires_grad_() for leaf in llama._leaves(params)]
    grads = torch.autograd.grad(
        llama.loss_fn(llama._rebuild(params, iter(watched)), tokens, config), watched)
    marks[1].record()
    opt_state = optimizer.update(params, grads, opt_state)
    marks[2].record()
    torch.cuda.synchronize()
    forward_backward_ms, optimizer_ms = (marks[i].elapsed_time(marks[i + 1]) for i in (0, 1))
    del watched, grads
    flops = train_flops(config, layers, TRAIN_TOKENS)
    tflops = sum(flops.values()) / (ms * 1e-3) / 1e12
    result = {"layers": layers, "tokens": TRAIN_TOKENS, "ms_a_step": ms, "event_ms": event_ms,
              "host_ms": host_ms, "warm_ms": warm_ms, "forward_backward_ms": forward_backward_ms,
              "optimizer_ms": optimizer_ms, "losses": losses,
              "tokens_per_s": TRAIN_TOKENS / (ms * 1e-3), "matmul_flops": flops,
              "matmul_tflops": tflops, "share_of_bf16_peak": tflops / H100_BF16_TFLOPS,
              "peak_gib": peak / 2**30, "reckoned_peak_gib": reckonings[layers]["peak_gib"],
              "reckoning": reckonings[layers]}
    print("train 18c: " + json.dumps(result) + f" [{card()}]", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"18c: losses {losses} are not finite and falling")
    del params, opt_state, train_step, optimizer, loss
    gc.collect()
    torch.cuda.empty_cache()
    return result


@timed_phase("18 (train)")
def train_18() -> dict:
    """Phase 18: the training half on the card, after phase 4's weights
    are freed. It reaches neither kernel: the reference's training path
    has no Pallas kernel (dense or ring attention only)."""
    print(f"train 18: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card "
          f"at the start", flush=True)
    result = {"18a": train_tiny_18a(), "18b": train_dryrun_18b(), "18c": train_7b_18c()}
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main() -> int:
    faulthandler.enable()  # a fault in native code prints every thread's stack
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card()}", flush=True)
    build()
    with timed("2 (K1)"):
        fp32_err = max(check_fp32(), check_edges())
        k1 = measure_kernel()
    with timed("2b (K2)"):
        check_verify_fp32()
        check_edges(rows=5)
        k2 = measure_kernel(rows=bench.VERIFY_ROWS)
    with timed("2c (K3)"):
        k3 = measure_encoder_attention()
    check_tiny_engine()
    check_tiny_engine_speculation()
    served, params, plain_streams = serve_7b()
    served_spec = serve_7b_speculative(params, plain_streams)
    kserve_spec = genai_grpc_13d(params, llama.LlamaConfig())
    llm_decode_7b(params)
    sharded = sharded_15(params, plain_streams, served)
    routed = router_17(params, plain_streams)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    train_18()
    pods = pod_16(sharded["15b"]["streams"])
    kserve_tiny()
    bert_large = kserve_bert_large()
    classifier_tiny()
    classifier_resnet50()
    data_plane()
    client_correctness()
    data_plane_procs()
    server_thread_profile()
    builtins_on_card()
    sticky = launch_sticky()  # its start-up overlaps phases 11-13
    try:
        resnet_server()
        embedded_11f()
        sticky_14b(sticky)
    finally:
        if sticky[2][0].poll() is None:
            sticky[2][0].kill()
            sticky[2][0].wait()
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
                "lifecycle_11a_launches": served["lifecycle_11a"]["k1_launches"],
                "grpc_12c_launches": served["grpc_12c"]["k1_launches"],
                "grpc_13c_launches": served["genai_13c"]["k1_launches"],
                "recovery_14a_launches": served["recovery_14a"]["k1_launches"],
                "tp_15a_launches": sharded["15a"]["k1_launches"],
                "tp_15b_launches": sharded["15b"]["k1_launches"],
                # per pod member (process index -> launches)
                "pod_16a_launches": {m: c["k1"] for m, c in pods["16a"]["launches"].items()},
                "pod_16b_launches": {m: c["k1"] for m, c in pods["16b"]["launches"].items()},
                "pod_16c_launches": {m: c["k1"] for m, c in pods["16c"]["launches"].items()},
                # both replicas of one process behind the router
                "router_17a_launches": routed["17a"]["k1_launches"],
                "router_17c_launches": routed["17c"]["k1_launches"],
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
                "genai_13d_launches": kserve_spec["k2_launches"],
                "tp_15a_launches": sharded["15a"]["k2_launches"],
                # 15b serves without speculation: no verify step
                "tp_15b_launches": sharded["15b"]["k2_launches"],
                "pod_16a_launches": {m: c["k2"] for m, c in pods["16a"]["launches"].items()},
            },
            {
                "name": "encoder_attention",
                "route": "cuda",
                "source": "client_tpu_torch/csrc/bert_attention.cu",
                "replaces": None,  # the JAX package leaves this attention to XLA
                # phase 6b: 24 a BERT-large forward
                "launches": bert_large["k3_launches"],
                "max_abs_err": k3["max_abs_err"],
                "ms": k3["ms"],
                "plain_ms": k3["plain_ms"],
                "bound_ms": k3["bound_ms"],
                "bound_by": k3["bound_by"],
                "library_ms": k3["library_ms"],
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

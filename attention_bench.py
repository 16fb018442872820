"""Time the paged-attention kernels of one checkout at the main path's
shapes, or compare two checkouts in turns on one card.

    python3 attention_bench.py                    # this checkout: one JSON line
    python3 attention_bench.py --against DIR      # DIR, this, this, DIR
    python3 attention_bench.py --steps [--against DIR]

Each run imports ``client_tpu_torch`` from its checkout (``--tree``) and
builds that checkout's kernels from its ``csrc/``, so ``--against`` a
``git archive`` of another commit times the other commit's kernels on the
same card, each checkout in its own process. The shapes are Llama-7B's
(H = KV = 32, D = 128, bs = 16, bf16, batch 8):

- long: contexts 4096 ... 100 in a 256-block table (``chip_smoke.py``'s
  ``ms``);
- serve: the contexts ``chip_smoke.py``'s phase 4 decodes at the end of
  its streams (prompt lengths + 16 tokens), in the table width the
  engine's ``block_bucket`` gives them. Four copies live in disjoint pool
  blocks and are taken in turn, so that a launch finds its pages outside
  the 50 MB L2, as in a step where 31 other layers' pools and the weights
  pass between two launches of one layer.

K1 reads each sequence up to its last slot; K2 scores T = 5 verify rows,
the last 5 slots of each context. Each kernel is held to its stand-in on
the first copy, then timed with CUDA events beside its bound (the larger
of its bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s) and one
gather + scaled_dot_product_attention call on the same inputs, and the
host time its wrapper takes to issue a call (``host_us``). ``--steps``
times instead the host side of the 7B engine's decode and verify steps
(batch 8, serve contexts), the end-to-end cost a wrapper's host time
feeds. The script imports nothing of JAX and needs one card.
"""

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# the kernels' bf16 result is acc / l rounded once to bf16, like the
# stand-in's: two fp32 values a few ulps apart can round to neighbouring
# bf16 values, so the two may differ by one bf16 ulp (2^-7 relative) of
# the largest output
BF16_ULP = 2.0 ** -7

KV_HEADS, HEAD_DIM, BLOCK_SIZE = 32, 128, 16
LONG_CONTEXTS = (4096, 3001, 2048, 1500, 1024, 700, 333, 100)
LONG_TABLE_WIDTH = 256
VERIFY_ROWS = 5
SERVE_NEW_TOKENS = 16
SERVE_COPIES = 4
# words (one token each) of chip_smoke.py's 8 prompts; the first two share
# a 128-word prefix
PROMPT_WORDS = (128 + 120, 128 + 200, 150, 190, 230, 270, 310, 350)


def serve_contexts():
    return [w + SERVE_NEW_TOKENS for w in PROMPT_WORDS]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after a warm-up,
    from CUDA events. The timed calls queue behind a spin of the card
    (``torch.cuda._sleep``) that outlasts their issue, so they run back to
    back: at the serve shapes a kernel takes less device time than the
    host takes to issue it, and the events would otherwise time the host."""
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    issue_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    # 2e9 cycles a second is above the card's clock: the spin lasts at
    # least twice the time the host needs to issue the timed calls
    torch.cuda._sleep(int(2 * iters * issue_s * 2e9) + 1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Mean host time to issue ``fn()`` (no synchronisation inside the
    timed calls), in microseconds."""
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def ragged_cases(seed, contexts, rows, table_width, copies=1, device="cuda"):
    """``copies`` bf16 inputs of K1 (``rows`` None: q [B, H, D], positions
    [B]) or K2 (q [B, T, H, D], positions [B, T]) over one pool: each
    sequence's context in distinct random blocks (block 0 stays the trash
    block), its rows at its last slots."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    bs, kv, d = BLOCK_SIZE, KV_HEADS, HEAD_DIM
    per_copy = sum(-(-c // bs) for c in contexts)
    num_blocks = 1 + copies * per_copy
    k = torch.randn(num_blocks, bs, kv, d, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(num_blocks, bs, kv, d, generator=gen, device=device).to(torch.bfloat16)
    perm = (torch.randperm(num_blocks - 1, generator=gen, device=device) + 1).int()
    cases, used = [], 0
    for _ in range(copies):
        tables = torch.zeros(len(contexts), table_width, dtype=torch.int32, device=device)
        for i, n_ctx in enumerate(contexts):
            n = -(-n_ctx // bs)
            tables[i, :n] = perm[used:used + n]
            used += n
        ends = torch.tensor(contexts, dtype=torch.int32, device=device)
        if rows is None:
            positions = ends - 1
            q_shape = (len(contexts), kv, d)
        else:
            positions = ends[:, None] - rows + torch.arange(rows, dtype=torch.int32,
                                                             device=device)[None, :]
            q_shape = (len(contexts), rows, kv, d)
        q = torch.randn(*q_shape, generator=gen, device=device).to(torch.bfloat16)
        cases.append((q, k, v, tables, positions.contiguous()))
    return cases


def bound(case, contexts) -> tuple:
    """The least the card could take for one call, and what bounds it:
    every visible K/V row read once, q read, out written, tables and
    positions read; 4 FLOPs per element of each query head's visible
    slots (q.k and p.v) against the bf16 peak."""
    q, k, _, tables, positions = case
    heads, d = q.shape[-2], q.shape[-1]
    row_bytes = k.shape[2] * d * k.element_size()
    moved = (2 * sum(contexts) * row_bytes + 2 * q.numel() * q.element_size()
             + tables.numel() * 4 + positions.numel() * 4)
    visible = int((positions.long() + 1).sum())
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = 4 * visible * heads * d / BF16_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def library(case):
    """One gather + scaled_dot_product_attention with a per-row mask over
    the table's width: the PyTorch call for the same function (H = KV
    here). The mask is built outside the timed call."""
    import torch

    q, k, v, tables, positions = case
    b, kv, d = q.shape[0], k.shape[2], q.shape[-1]
    s = tables.shape[1] * k.shape[1]
    slots = torch.arange(s, device=q.device)
    rows = q.dim() == 4
    pos = positions if rows else positions[:, None]
    mask = (slots[None, None, :] <= pos[:, :, None])[:, None]  # [B, 1, T, S]
    q4 = q.transpose(1, 2) if rows else q[:, :, None, :]

    def call():
        k_ctx = k[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
        v_ctx = v[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
        out = torch.nn.functional.scaled_dot_product_attention(q4, k_ctx, v_ctx, attn_mask=mask)
        return out.transpose(1, 2) if rows else out[:, :, 0, :]

    return call


def measure(pa, rows, contexts, table_width, copies=1, seed=0):
    """Hold K1 (``rows`` None) or K2 against its stand-in on the first
    copy, then time kernel and gather + SDPA over the copies in turn.
    Returns (numbers, cases)."""
    import torch

    cases = ragged_cases(seed, contexts, rows, table_width, copies)
    kernel = pa.paged_attention_cuda if rows is None else pa.paged_attention_cuda_mq
    standin = pa.paged_attention_standin if rows is None else pa.paged_attention_standin_mq
    out = kernel(*cases[0])
    ref = standin(*cases[0])
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ULP * ref.float().abs().max().item()
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"rows={rows} contexts={contexts}: max_abs_err {err} > {tol}")
    turn = itertools.cycle(cases)
    calls = itertools.cycle([library(case) for case in cases])
    bound_ms, bound_by = bound(cases[0], contexts)
    numbers = {
        "ms": cuda_ms(lambda: kernel(*next(turn))),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: next(calls)()),
        "host_us": host_us(lambda: kernel(*next(turn))),
        "max_abs_err": err,
        "tolerance": tol,
    }
    return numbers, cases


def time_checkout() -> dict:
    """K1 and K2 of the imported checkout at the long and serve shapes,
    and T sequential K1 launches at the long shape."""
    from client_tpu_torch.llm.engine import block_bucket
    from client_tpu_torch.models import paged_attention as pa

    serve = serve_contexts()
    serve_width = block_bucket(max(-(-c // BLOCK_SIZE) for c in serve))
    result = {}
    for name, rows in (("k1", None), ("k2", VERIFY_ROWS)):
        long_numbers, cases = measure(pa, rows, LONG_CONTEXTS, LONG_TABLE_WIDTH, seed=1)
        serve_numbers, _ = measure(pa, rows, serve, serve_width, SERVE_COPIES, seed=2)
        result[name] = {"long": long_numbers, "serve": serve_numbers}
        if rows is not None:
            q, k, v, tables, positions = cases[0]
            split = [(q[:, r].contiguous(), positions[:, r].contiguous()) for r in range(rows)]

            def sequential_k1():
                for q_row, pos_row in split:
                    pa.paged_attention_cuda(q_row, k, v, tables, pos_row)

            result["k1_x_t_long_ms"] = cuda_ms(sequential_k1)
    result["serve_table_width"] = serve_width
    return result


def time_steps(iters: int = 30) -> dict:
    """Host time of the 7B engine's decode step and verify step (T = 5) at
    batch 8 at the serve contexts, over ``iters`` steps each: every step
    ends in the device-to-host copy of its logits, so its wall time is the
    host's. Median and quartiles, in ms. Random weights from seed 0; the
    steps write into free pool blocks."""
    import time

    import numpy as np
    import torch

    from client_tpu_torch.llm.engine import block_bucket
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.models import llama

    model = LlmEngineModel(config=llama.LlamaConfig(), device=torch.device("cuda"),
                           speculation={"mode": "ngram", "k": VERIFY_ROWS - 1})
    model.warmup()
    engine = model.engine
    contexts = serve_contexts()
    result = {}
    for name, rows in (("decode", 1), ("verify", VERIFY_ROWS)):
        widths = [(c + rows - 1 + BLOCK_SIZE) // BLOCK_SIZE for c in contexts]
        tables = np.zeros([len(contexts), block_bucket(max(widths))], dtype=np.int32)
        first = 1
        for i, n in enumerate(widths):
            tables[i, :n] = range(first, first + n)
            first += n
        positions = (np.array(contexts)[:, None] + np.arange(rows)[None, :]).astype(np.int32)
        tokens = np.full(positions.shape, 7, dtype=np.int32)
        if rows == 1:
            def step():
                engine._decode(tokens[:, 0], positions[:, 0], tables, engine._pages)
        else:
            lengths = np.full([len(contexts)], rows, dtype=np.int32)

            def step():
                engine._decode_multi(tokens, positions, lengths, tables, engine._pages)
        for _ in range(3):
            step()
        step_ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        q1, median, q3 = np.percentile(step_ms, [25, 50, 75])
        result[name] = {"host_ms_median": median, "host_ms_q1": q1, "host_ms_q3": q3}
    model.shutdown()
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                        help="checkout whose client_tpu_torch to time (default: this one)")
    parser.add_argument("--against", help="another checkout: time it and this one in turns")
    parser.add_argument("--steps", action="store_true",
                        help="time the 7B engine's decode and verify steps on the host "
                        "instead of the kernels")
    args = parser.parse_args()
    if args.against:
        here = str(Path(__file__).resolve())
        for tree in (args.against, args.tree, args.tree, args.against):
            proc = subprocess.run([sys.executable, here, "--tree", tree]
                                  + (["--steps"] if args.steps else []),
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                return proc.returncode
            print(proc.stdout.strip().splitlines()[-1], flush=True)
        return 0

    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("attention_bench: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    timed = time_steps() if args.steps else time_checkout()
    print(json.dumps({"tree": args.tree, **timed, "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

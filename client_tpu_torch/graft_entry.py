"""Entry points of the port: the tiny forward and a multi-device training
dryrun (the twin of the repository's ``__graft_entry__.py``).

- :func:`entry` returns the flagship model's forward step
  (``client_tpu_torch.models.llama``, tiny config) and example arguments.
- :func:`dryrun_multichip` lays ``n`` devices out as a ``dp x sp x tp``
  plan and runs one FULL training step on it (forward, backward through
  the shard loop and its collectives, AdamW) on tiny shapes: the
  Megatron tp layout, ring attention over sp, batch blocks over dp.

Devices are every card of the process unless the caller passes a list,
which may repeat one device (``["cuda:0"] * 8``: eight shards of one
card, run in turn) or name the CPU (``["cpu"] * 8``). Without a card and
without an explicit CPU list both raise.

    python -m client_tpu_torch.graft_entry [n] [--device DEV]

runs both on the process's cards, or with ``--device`` on ``n`` entries
of that one device.
"""

import argparse
import math
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from client_tpu_torch.models import llama
from client_tpu_torch.parallel import sharding
from client_tpu_torch.utils import resolve_device


def entry(device=None):
    """``(fn, example_args)``: the tiny model's forward on ``[2, 16]`` zero
    tokens, its weights drawn from a generator seeded 0 on ``device``
    (``cuda`` by default)."""
    device = resolve_device(device)
    config = llama.LlamaConfig.tiny()
    generator = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(generator, config, device)
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=device)

    def forward_step(params, tokens):
        return llama.forward(params, tokens, config)

    return forward_step, (params, tokens)


def _factor_mesh(n: int):
    """Split n devices into (dp, sp, tp) — tp innermost, powers of two
    preferred."""
    def largest_pow2_divisor(x, cap):
        f = 1
        while f * 2 <= cap and x % (f * 2) == 0:
            f *= 2
        return f

    tp = largest_pow2_divisor(n, min(n, 4))
    rest = n // tp
    sp = largest_pow2_divisor(rest, min(rest, 2))
    dp = rest // sp
    return dp, sp, tp


def _run_mesh_step(devices: Sequence[torch.device], dp: int, sp: int, tp: int, config,
                   batch: int, seq: int) -> float:
    """One training step over a dp x sp x tp plan of ``devices``; returns
    the loss. ``config``, ``batch`` and ``seq`` are the same for every
    factorization, so every layout must give the same loss."""
    spec = sharding.MeshSpec.parse({"axes": {"dp": dp, "sp": sp, "tp": tp}})
    plan = sharding.resolve(spec, list(devices))
    home = plan.devices[0]
    params = llama.init_params(torch.Generator(device=home).manual_seed(0), config, home)
    train_step, optimizer = llama.make_train_step(config, plan)
    opt_state = optimizer.init(params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, config.vocab_size, (batch, seq), dtype=np.int32)).to(home)
    params, opt_state, loss = train_step(params, opt_state, tokens)
    loss = float(loss)  # waits for the device
    print(f"dryrun_multichip ok: mesh dp={dp} sp={sp} tp={tp}, loss={loss:.4f}", flush=True)
    return loss


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> List[Tuple[Tuple[int, int, int], float]]:
    """One training step over each factorization of ``n_devices``: the
    automatic one, plus 2 x 2 x (n/4) first when that leaves dp at 1 and
    8 divides n (for n = 8: 2 x 2 x 2 and 1 x 2 x 4). Every factorization
    gets one config and one token shape (batch divisible by every dp,
    sequence by every sp, heads by every tp), and an ``AssertionError``
    is raised when two losses part by more than 1e-3: the layout must not
    change the math. Returns ``[((dp, sp, tp), loss), ...]``."""
    if devices is None:
        devices = sharding.host_devices()
    devices = [resolve_device(d) for d in devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
    dp, sp, tp = _factor_mesh(n_devices)
    factorizations = [(dp, sp, tp)]
    if dp == 1 and n_devices % 8 == 0:
        factorizations.insert(0, (2, 2, n_devices // 4))
    dp_lcm = math.lcm(*[f[0] for f in factorizations])
    sp_lcm = math.lcm(*[f[1] for f in factorizations])
    tp_lcm = math.lcm(*[f[2] for f in factorizations])
    heads = max(4, tp_lcm)
    config = llama.LlamaConfig.tiny(n_heads=heads, n_kv_heads=heads, d_model=16 * heads)
    batch, seq = 2 * dp_lcm, 8 * sp_lcm
    losses = [(f, _run_mesh_step(devices, *f, config, batch, seq)) for f in factorizations]
    if len(losses) == 2 and abs(losses[0][1] - losses[1][1]) > 1e-3:
        raise AssertionError(
            f"mesh factorizations disagree on the loss: {[loss for _, loss in losses]} "
            f"for {factorizations}")
    return losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m client_tpu_torch.graft_entry",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int,
                        help="devices of the dryrun's plan (default: every card)")
    parser.add_argument("--device", help="run on n entries of this one device "
                        "(cuda:0, cpu) instead of the process's cards")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    finite = bool(torch.isfinite(out).all())  # waits for the device
    print(f"entry ok: logits {tuple(out.shape)} {out.dtype}, finite {finite}", flush=True)
    n = args.n
    if n is None:
        n = 1 if args.device else torch.cuda.device_count()
    dryrun_multichip(n, None if args.device is None else [args.device] * n)
    return 0


if __name__ == "__main__":
    sys.exit(main())

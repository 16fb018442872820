"""k1_roofline: the decode attention kernel K1's share of its roofline,
in percent: the least time its launches could take (each lane's visible
keys and values read once, queries read, outputs written, tables and
positions read, at 3.35 TB/s; or its FLOPs at the bf16 peak, whichever
is larger) over their time on the card. Launches and their times come
from the kept profiler windows; each launch's contexts from the
harness's span of the decode call that issued it."""

import bisect

from harness import arith

KERNEL = "rpa_decode_kernel"


def read(run):
    p = run.profile
    k1 = p["kernels"].get(KERNEL) if p else None
    if not k1 or not k1["launches_at"] or not run.spans or not run.spans.decode:
        return None
    sizes = run.sizes
    calls = sorted(run.spans.decode)
    starts = [c[0] for c in calls]
    bound_s = 0.0
    for t in k1["launches_at"]:
        _, _, contexts, width = calls[max(0, bisect.bisect_right(starts, t) - 1)]
        bytes_s = arith.k1_bytes(contexts, sizes["num_attention_heads"],
                                 sizes["num_key_value_heads"], sizes["head_dim"],
                                 width) / arith.HBM_BYTES_PER_S
        flops_s = arith.k1_flops(contexts, sizes["num_attention_heads"],
                                 sizes["head_dim"]) / arith.BF16_FLOPS
        bound_s += max(bytes_s, flops_s)
    return 100.0 * bound_s / (k1["ns"] / 1e9)

"""mfu.bert: model FLOPs of each request answered in the window at its
own, unpadded length over the window's seconds and the card's bf16 dense
peak, in percent; the padding the batcher adds shows as waste."""

from harness import arith


def read(run):
    if run.system != "text_encoder":
        return None
    flops = sum(arith.encoder_flops(run.sizes, r["length"]) for r in run.records
                if r.get("done") and "error" not in r and run.in_window(r["t_first"]))
    return 100.0 * flops / (run.window_s * arith.BF16_FLOPS)

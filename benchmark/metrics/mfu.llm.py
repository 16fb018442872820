"""mfu.llm: model FLOPs of the tokens answered in the window over the
window's seconds and the card's bf16 dense peak, in percent. A prompt
counts (every position through the layers, attention over its causal
context, the head on its last position) when its first token arrives in
the window, a cached prefix as work done; each later output token counts
one decode position (the head included) when it arrives."""

from harness import arith, traffic


def read(run):
    if run.route != "openai_chat_stream":
        return None
    plan = traffic.Plan(run.mix, run.seed)
    flops = 0.0
    for r in run.records:
        if not r["stamps"]:
            continue
        prompt = len(plan.request(r["slot"], r["k"])["prompt"].split())
        if run.in_window(r["stamps"][0]):
            flops += arith.decoder_prompt_flops(run.sizes, prompt)
        for j, t in enumerate(r["stamps"][1:], start=1):
            if run.in_window(t):
                flops += arith.decoder_flops(run.sizes, prompt + j - 1, with_head=True)
    return 100.0 * flops / (run.window_s * arith.BF16_FLOPS)

"""ttft_p95_ms.client: nearest-rank 95th percentile, over every request
sent in the part of the window the metrics read that did not fail, of
send to first token event, as the client sees it: the whole path, from
the HTTP front-end through the server core to the engine's admission
and prefill. A traced run reads the window's first part only, before
its profiler windows."""

from harness.arith import percentile


def read(run):
    if run.route != "openai_chat_stream":
        return None
    ttft = [(r["t_first"] - r["t_send"]) / 1e6 for r in run.records
            if run.in_window(r["t_send"]) and "t_first" in r and "error" not in r]
    return percentile(ttft, 95) if ttft else None

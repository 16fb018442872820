"""itl_p95_ms: nearest-rank 95th percentile over every gap between two
consecutive token events of one stream, both inside the window."""

from harness.arith import percentile


def read(run):
    if run.route != "openai_chat_stream":
        return None
    gaps = [(b - a) / 1e6 for r in run.records for a, b in zip(r["stamps"], r["stamps"][1:])
            if run.in_window(a) and run.in_window(b)]
    return percentile(gaps, 95) if gaps else None

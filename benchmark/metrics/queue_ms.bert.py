"""queue_ms.bert: mean time a request waited in the batcher's queue over
the window: the statistics route's queue ns over its count, differences
of the window's closing and opening."""


def read(run):
    if run.system != "text_encoder" or "close" not in run.counters:
        return None
    a = run.counters["open"]["inference_stats"]["queue"]
    b = run.counters["close"]["inference_stats"]["queue"]
    count = b["count"] - a["count"]
    return (b["ns"] - a["ns"]) / count / 1e6 if count else None

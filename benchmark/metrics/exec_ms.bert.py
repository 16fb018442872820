"""exec_ms.bert: mean device execution time as the requests saw it over
the window: the statistics route's compute_infer ns over its count
(each request books its execution's time), differences of the window's
closing and opening."""


def read(run):
    if run.system != "text_encoder" or "close" not in run.counters:
        return None
    a = run.counters["open"]["inference_stats"]["compute_infer"]
    b = run.counters["close"]["inference_stats"]["compute_infer"]
    count = b["count"] - a["count"]
    return (b["ns"] - a["ns"]) / count / 1e6 if count else None

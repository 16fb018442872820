"""rows_per_exec.bert: rows per device execution of the dynamic batcher
over the window: the statistics route's inference_count over its
execution_count, each the difference between the window's closing and
its opening."""


def read(run):
    if run.system != "text_encoder" or "close" not in run.counters:
        return None
    rows = run.counters["close"]["inference_count"] - run.counters["open"]["inference_count"]
    execs = run.counters["close"]["execution_count"] - run.counters["open"]["execution_count"]
    return rows / execs if execs else None

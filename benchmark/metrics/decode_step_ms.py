"""decode_step_ms: total wall time of the decode device calls over their
number (each call is one step of the whole batch and ends in its logits'
device-to-host copy), from the harness's spans inside the window and
clear of profiler windows."""


def read(run):
    if run.spans is None:
        return None
    calls = [(b - a) / 1e6 for a, b, *_ in run.spans.decode if run.clear_of_profiler(a, b)]
    return sum(calls) / len(calls) if calls else None

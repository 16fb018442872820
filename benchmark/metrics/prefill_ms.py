"""prefill_ms: mean wall time of one prefill device call (the engine's
prefill callable, which ends in its logits' device-to-host copy), from
the harness's spans inside the window and clear of profiler windows."""


def read(run):
    if run.spans is None:
        return None
    calls = [(b - a) / 1e6 for a, b, _ in run.spans.prefill if run.clear_of_profiler(a, b)]
    return sum(calls) / len(calls) if calls else None

"""decode_batch: sequences advanced per decode step over the window, from
the engine's own counters (lane_steps and steps, read at the window's
opening and closing)."""


def read(run):
    if run.system != "llm_engine" or "close" not in run.counters:
        return None
    opened, closed = run.counters["open"], run.counters["close"]
    steps = closed["steps"] - opened["steps"]
    return (closed["lane_steps"] - opened["lane_steps"]) / steps if steps else None

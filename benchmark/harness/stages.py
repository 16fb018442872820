"""The program's stage ledger as the per-layer metrics read it.

``ServerCore`` books wall ns by stage into each model's statistics
(``stage_stats`` of ``GET /v2/models/<name>/stats``: ``{stage: {count,
ns}}``), always on; the harness keeps that document at the window's
opening and closing (``run.counters["open"]``, ``["close"]``, as the
model type's ``counters`` reads it). Counters without ``stage_stats``
(an engine's, or a program without the ledger): its readers find
nothing, whatever the system.
"""


def mean_ms(run, *stages):
    """The window's ns of ``stages`` together over the bookings of the
    first, in ms: the differences of the closing and the opening
    documents. None before the window closed, where the counters hold no
    ledger (an engine's counters, or a program without it) or it books
    none of these stages, or where none was booked in the window."""
    if "close" not in run.counters:
        return None
    opened = run.counters["open"].get("stage_stats")
    closed = run.counters["close"].get("stage_stats")
    if opened is None or closed is None or any(s not in closed for s in stages):
        return None
    zero = {"count": 0, "ns": 0}
    count = closed[stages[0]]["count"] - opened.get(stages[0], zero)["count"]
    ns = sum(closed[s]["ns"] - opened.get(s, zero)["ns"] for s in stages)
    return ns / count / 1e6 if count else None

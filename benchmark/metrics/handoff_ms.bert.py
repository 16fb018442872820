"""handoff_ms.bert: mean wall time of an execution's two hops between the
event loop and the executor thread (the submit to the thread's first line,
the thread's return to the loop resuming the batcher), in ms: the stage
ledger's handoff ns over its bookings (one an execution), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "handoff")

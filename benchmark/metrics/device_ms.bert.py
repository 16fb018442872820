"""device_ms.bert: mean span of an execution's forward on the card's own
clock, in ms: the stage ledger's device ns (two CUDA events, where the ids
reach the card and where the read back opens) over its bookings (one an
execution), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "device")

"""readback_ms.bert: mean wall time of an execution's read back to the host,
which waits for the forward to end on the card, in ms: the stage ledger's
readback ns over its bookings (one an execution), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "readback")

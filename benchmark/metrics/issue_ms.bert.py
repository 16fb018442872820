"""issue_ms.bert: mean wall time of an execution outside its marked
transfers, that is, the host's issue of the forward, in ms: the stage
ledger's compute ns over its bookings (one an execution), over the window.
Near device_ms.bert, the forward is launch-bound."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "compute")

"""device_gap_ms.bert: mean idle time of the card between two of the
batcher's forwards, in ms, on the card's own clock: the stage ledger's
device_gap ns (one execution's second CUDA event to the next's first) over
its bookings (one an execution), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "device_gap")

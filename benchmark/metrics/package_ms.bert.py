"""package_ms.bert: mean wall time the core spends packaging an execution's
answers (the sum over its requests), in ms: the stage ledger's package ns
over its bookings (one an execution), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "package")

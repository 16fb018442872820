"""assembly_ms.bert: mean wall time of the dynamic batcher's merge of an
execution's requests, the ragged pad included, in ms: the stage ledger's
batch_assembly ns over its bookings (one an execution), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "batch_assembly")

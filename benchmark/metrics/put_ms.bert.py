"""put_ms.bert: mean wall time of an execution's host-to-device part in the
BERT model (the bucket pad of the ids and their copy to the card), in ms:
the stage ledger's device_put ns over its bookings (one an execution), over
the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "device_put")

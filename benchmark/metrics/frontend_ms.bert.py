"""frontend_ms.bert: mean wall time the HTTP front-end spends on a request
of its own (the decode of the body into a core request, and the encode of
the answer), in ms: the stage ledger's frontend_decode and encode ns over
the frontend_decode bookings (one an answered request), over the window."""

from harness import stages


def read(run):
    return stages.mean_ms(run, "frontend_decode", "encode")

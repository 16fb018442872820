"""setup_s: process start to the window's opening (weights, the port's
load and warm-up, the server, the client and the ramp), host clock."""


def read(run):
    return run.setup_s

"""Test harness of the port: :class:`InProcessServer` runs the port's
server on a background thread."""

from client_tpu_torch.testing.inprocess import InProcessServer

__all__ = ["InProcessServer"]

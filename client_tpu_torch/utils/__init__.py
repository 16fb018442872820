"""The server's exception and the port's device helper."""

from typing import Optional, Union

import torch

__all__ = ["InferenceServerException", "resolve_device"]


class InferenceServerException(Exception):
    """Exception raised for server- or client-side inference errors:
    ``message()``, ``status()`` (e.g. a gRPC status name) and
    ``debug_details()`` accessors."""

    def __init__(
        self,
        msg: str,
        status: Optional[str] = None,
        debug_details: Optional[str] = None,
    ):
        self._msg = msg
        self._status = status
        self._debug_details = debug_details
        super().__init__(msg)

    def __str__(self) -> str:
        msg = super().__str__() if self._msg is None else self._msg
        if self._status is not None:
            msg = f"[{self._status}] {msg}"
        return msg

    def message(self) -> str:
        """The error message."""
        return self._msg

    def status(self) -> Optional[str]:
        """The error status code (e.g. gRPC status name), if any."""
        return self._status

    def debug_details(self) -> Optional[str]:
        """Low-level debug details (e.g. traceback), if any."""
        return self._debug_details


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. Raises when CUDA is asked for (or implied by
    ``None``) and there is no card — the port never falls back to the
    CPU on its own."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return resolved

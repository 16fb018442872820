"""Client plugin interface.

An own copy of ``client_tpu/_plugin.py``.

Reference semantics: src/python/library/tritonclient/_plugin.py:31-48 — a
plugin is a callable invoked with every outgoing :class:`Request` before it
hits the wire, typically to inject auth headers.
"""

import abc

from client_tpu_torch._request import Request


class InferenceServerClientPlugin(abc.ABC):
    """Base class for client plugins.

    A plugin is registered on a client via
    :meth:`client_tpu_torch._client.InferenceServerClientBase.register_plugin` and
    is called exactly once per outgoing request.
    """

    @abc.abstractmethod
    def __call__(self, request: Request) -> None:
        """Inspect/mutate ``request`` (headers) before it is sent."""
        raise NotImplementedError

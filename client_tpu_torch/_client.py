"""Protocol-agnostic client base: the plugin registry.

An own copy of ``client_tpu/_client.py``.

Reference semantics: src/python/library/tritonclient/_client.py:31-85 — a
single plugin may be registered per client; every outgoing request's headers
flow through it via ``_call_plugin``.
"""

from typing import Optional

from client_tpu_torch._plugin import InferenceServerClientPlugin
from client_tpu_torch._request import Request


class InferenceServerClientBase:
    """Shared base for all protocol clients (HTTP/gRPC, sync/aio)."""

    def __init__(self):
        self._plugin: Optional[InferenceServerClientPlugin] = None

    def register_plugin(self, plugin: InferenceServerClientPlugin) -> None:
        """Register ``plugin`` to be invoked on every request.

        Raises
        ------
        ValueError
            If a plugin is already registered (only one at a time).
        """
        if not isinstance(plugin, InferenceServerClientPlugin):
            raise ValueError(
                "plugin must be an InferenceServerClientPlugin instance"
            )
        if self._plugin is not None:
            raise ValueError(
                "A plugin is already registered; call unregister_plugin() first"
            )
        self._plugin = plugin

    def plugin(self) -> Optional[InferenceServerClientPlugin]:
        """Return the registered plugin, or None."""
        return self._plugin

    def unregister_plugin(self) -> None:
        """Remove the registered plugin.

        Raises
        ------
        ValueError
            If no plugin is registered.
        """
        if self._plugin is None:
            raise ValueError("No plugin is registered")
        self._plugin = None

    def _call_plugin(self, request: Request) -> None:
        """Run the registered plugin (if any) over an outgoing request."""
        if self._plugin is not None:
            self._plugin(request)

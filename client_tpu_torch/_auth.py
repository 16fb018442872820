"""Built-in auth plugins.

An own copy of ``client_tpu/_auth.py``.

Reference semantics: src/python/library/tritonclient/_auth.py:33-46.
"""

import base64

from client_tpu_torch._plugin import InferenceServerClientPlugin
from client_tpu_torch._request import Request


class BasicAuth(InferenceServerClientPlugin):
    """HTTP Basic auth plugin: adds an ``Authorization: Basic ...`` header."""

    def __init__(self, username: str, password: str):
        token = base64.b64encode(f"{username}:{password}".encode("utf-8"))
        self._auth_header = f"Basic {token.decode('ascii')}"

    def __call__(self, request: Request) -> None:
        request.headers["Authorization"] = self._auth_header

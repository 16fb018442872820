"""Request object passed to client plugins.

An own copy of ``client_tpu/_request.py``.

Reference semantics: src/python/library/tritonclient/_request.py:29-39 — a
plugin sees (and may rewrite) the headers of every outgoing request.
"""

from typing import Dict, Optional


class Request:
    """An outgoing request as visible to client plugins.

    Attributes
    ----------
    headers:
        Mutable mapping of HTTP/gRPC metadata headers. Plugins may add,
        rewrite, or delete entries in place.
    """

    def __init__(self, headers: Optional[Dict[str, str]] = None):
        self.headers: Dict[str, str] = dict(headers) if headers else {}

    def __repr__(self) -> str:
        return f"Request(headers={self.headers!r})"

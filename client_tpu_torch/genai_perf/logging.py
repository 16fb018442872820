"""Structured logging for genai-perf (the port's own copy of
``client_tpu/genai_perf/logging.py``; reference genai_perf/logging.py:1-79).

One ``init_logging()`` call configures the package-wide logger tree with a
structured formatter (timestamp, level, logger name); modules obtain
loggers via :func:`getLogger`. Verbosity: WARNING by default, INFO with
``-v``, DEBUG when the GENAI_PERF_LOG_LEVEL env var says so.
"""

import logging
import os
import sys
from typing import Optional

_ROOT = "genai_perf"
_FORMAT = "%(asctime)s [%(levelname)s] %(name)s - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"
_initialized = False


def init_logging(verbose: bool = False, stream=None) -> logging.Logger:
    """Configure the genai-perf logger tree; idempotent."""
    global _initialized
    root = logging.getLogger(_ROOT)
    level_name = os.environ.get("GENAI_PERF_LOG_LEVEL", "").upper()
    if level_name in ("DEBUG", "INFO", "WARNING", "ERROR"):
        level = getattr(logging, level_name)
    else:
        level = logging.INFO if verbose else logging.WARNING
    root.setLevel(level)
    if not _initialized:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        root.addHandler(handler)
        root.propagate = False
        _initialized = True
    elif stream is not None:
        # Re-point the existing handler (tests and embedding callers).
        for handler in root.handlers:
            if isinstance(handler, logging.StreamHandler):
                try:
                    handler.setStream(stream)
                except ValueError:
                    # setStream flushes the old stream first, which raises
                    # when that stream is already closed (e.g. a captured
                    # stderr from a finished test); re-point directly.
                    handler.stream = stream
    return root


def getLogger(name: Optional[str] = None) -> logging.Logger:  # noqa: N802
    """A child of the genai_perf logger tree (reference-parity casing)."""
    if not name or name == _ROOT:
        return logging.getLogger(_ROOT)
    suffix = name.split("client_tpu_torch.genai_perf.")[-1]
    return logging.getLogger(f"{_ROOT}.{suffix}")

"""Structured JSON logging: the real backend of the ``/v2/logging`` extension.

The port's own copy of ``client_tpu/observability/logging.py``.

Before this module the logging extension was an inert settings dict — the
RPCs validated and stored ``log_error``/``log_info``/``log_verbose_level``
and nothing ever read them. :class:`StructuredLogger` makes them live:
every emission re-checks the effective settings (global + per-model
overrides), so toggling a severity through ``/v2/logging`` changes what
the server writes with no restart, on both front-ends.

Design constraints, in order:

dependency-free
    Stdlib only (json + a lock); records are one JSON object per line so
    any log shipper can parse them without a schema registry.
cheap when quiet
    Severity gates are plain dict reads with no lock; the per-request
    ``verbose`` gate is a single cached attribute check
    (:attr:`StructuredLogger.verbose_hot`) while every effective
    ``log_verbose_level`` is 0 — the default — mirroring the
    ``TraceManager._enabled`` / ``resilience/policy.py`` armed-contextvar
    pattern.
rate-limited when loud
    Hot-path error sites pass ``rate_key=``: at most
    ``rate_max_per_window`` records per key per ``rate_window_s`` are
    written, and the next allowed record carries a ``suppressed`` count
    so nothing disappears silently. A model that fails every request
    leaves evidence without melting stderr.
clock-injectable
    All timestamps come from the injected wall clock
    (``tools/clock_lint.py`` pins this file), so rate-window tests run in
    fake milliseconds.

Exporters: an injected ``sink`` callable (tests; replaces the stream), the
file named by the live ``log_file`` setting, else a text stream
(``sys.stderr`` by default — resolved at emit time so capture fixtures
work).
"""

import json
import sys
import threading
import time
import traceback
from datetime import datetime, timezone
from typing import Any, Callable, Dict, IO, Optional

from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "DEFAULT_LOG_SETTINGS",
    "SEVERITIES",
    "StructuredLogger",
    "validate_log_settings",
]

SEVERITY_ERROR = "ERROR"
SEVERITY_WARNING = "WARNING"
SEVERITY_INFO = "INFO"
SEVERITY_VERBOSE = "VERBOSE"
SEVERITIES = (
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    SEVERITY_INFO,
    SEVERITY_VERBOSE,
)

DEFAULT_LOG_SETTINGS: Dict[str, Any] = {
    "log_file": "",
    "log_info": True,
    "log_warning": True,
    "log_error": True,
    "log_verbose_level": 0,
    "log_format": "default",
}

_LOG_SETTING_TYPES: Dict[str, type] = {
    "log_file": str,
    "log_info": bool,
    "log_warning": bool,
    "log_error": bool,
    "log_verbose_level": int,
    "log_format": str,
}
_LOG_FORMATS = ("default", "ISO8601")

# severity -> the boolean setting that gates it (verbose is level-gated)
_GATE_FOR = {
    SEVERITY_ERROR: "log_error",
    SEVERITY_WARNING: "log_warning",
    SEVERITY_INFO: "log_info",
}


def validate_log_settings(updates: Dict[str, Any]) -> Dict[str, Any]:
    """Validate a log-settings update; returns the normalized updates.

    Raises :class:`InferenceServerException` on unknown keys or
    wrong-typed values (both front-ends surface it as a client error).
    """
    out: Dict[str, Any] = {}
    for key, value in updates.items():
        expected = _LOG_SETTING_TYPES.get(key)
        if expected is None:
            raise InferenceServerException(f"unknown log setting '{key}'")
        if expected is bool:
            if not isinstance(value, bool):
                raise InferenceServerException(
                    f"log setting '{key}' expects a boolean, got {value!r}"
                )
        elif expected is int:
            if isinstance(value, bool) or not isinstance(value, int):
                raise InferenceServerException(
                    f"log setting '{key}' expects an integer, got {value!r}"
                )
            if value < 0:
                raise InferenceServerException(
                    f"log setting '{key}' must be >= 0, got {value}"
                )
        elif not isinstance(value, str):
            raise InferenceServerException(
                f"log setting '{key}' expects a string, got {value!r}"
            )
        if key == "log_format" and value not in _LOG_FORMATS:
            raise InferenceServerException(
                f"log setting 'log_format' expects one of {list(_LOG_FORMATS)},"
                f" got {value!r}"
            )
        out[key] = value
    return out


class StructuredLogger:
    """Severity-gated, rate-limited JSON-lines logger.

    Parameters
    ----------
    name:
        Emitted as the ``logger`` field of every record (e.g. "server",
        "client", "perf") so merged streams stay attributable.
    sink:
        Optional callable receiving each record dict. When set it
        REPLACES the stream output (tests and in-process consumers); the
        ``log_file`` setting is still honored.
    stream:
        Text stream for records when no ``log_file`` is set. ``None``
        resolves to ``sys.stderr`` at emit time.
    clock:
        Injectable wall-seconds clock (timestamps + rate windows).
    rate_max_per_window / rate_window_s:
        Per-``rate_key`` emission budget; records beyond it within one
        window are counted, not written, and the count rides on the next
        written record as ``suppressed``.
    """

    def __init__(
        self,
        name: str = "",
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        stream: Optional[IO] = None,
        clock: Callable[[], float] = time.time,
        rate_max_per_window: int = 8,
        rate_window_s: float = 5.0,
    ):
        self._name = name
        # public: tests and in-process consumers attach/replace the sink
        # at runtime (like TraceManager.exporter)
        self.sink = sink
        self._stream = stream
        self._clock = clock
        self._rate_max = max(1, int(rate_max_per_window))
        self._rate_window_s = rate_window_s
        self._lock = threading.Lock()
        self._settings: Dict[str, Any] = dict(DEFAULT_LOG_SETTINGS)
        self._model_settings: Dict[str, Dict[str, Any]] = {}
        # rate_key -> [window_start, emitted_in_window, suppressed]
        self._rate: Dict[Any, list] = {}
        self._files: Dict[str, IO] = {}
        # lock-free hot-path gate: True only while SOME effective
        # log_verbose_level (global or per-model override) is > 0
        self.verbose_hot = False
        self.emitted_count = 0
        self.suppressed_count = 0

    # -- settings ------------------------------------------------------------

    def settings(self, model_name: str = "") -> Dict[str, Any]:
        """The effective settings for ``model_name`` ("" = global)."""
        with self._lock:
            return self._settings_locked(model_name)

    def _settings_locked(self, model_name: str) -> Dict[str, Any]:
        merged = dict(self._settings)
        if model_name and model_name in self._model_settings:
            merged.update(self._model_settings[model_name])
        return merged

    def model_overrides(self) -> Dict[str, Dict[str, Any]]:
        """Per-model override map (copy; introspection/debug state)."""
        with self._lock:
            return {m: dict(o) for m, o in self._model_settings.items()}

    def update(
        self, updates: Dict[str, Any], model_name: str = ""
    ) -> Dict[str, Any]:
        """Apply validated setting updates; returns the effective settings.

        A value of ``None`` clears the setting: a per-model override is
        removed (falling back to the global value), a global setting
        resets to its default. Unknown keys and wrong-typed values raise
        :class:`InferenceServerException` — nothing is applied then.
        """
        cleared = [k for k, v in updates.items() if v is None]
        for key in cleared:
            if key not in DEFAULT_LOG_SETTINGS:
                raise InferenceServerException(f"unknown log setting '{key}'")
        normalized = validate_log_settings(
            {k: v for k, v in updates.items() if v is not None}
        )
        with self._lock:
            target = (
                self._model_settings.setdefault(model_name, {})
                if model_name
                else self._settings
            )
            for key in cleared:
                if model_name:
                    target.pop(key, None)
                else:
                    target[key] = DEFAULT_LOG_SETTINGS[key]
            target.update(normalized)
            if model_name and not target:
                self._model_settings.pop(model_name, None)
            self.verbose_hot = self._settings["log_verbose_level"] > 0 or any(
                o.get("log_verbose_level", 0) > 0
                for o in self._model_settings.values()
            )
            return self._settings_locked(model_name)

    # -- severity gates ------------------------------------------------------

    def enabled(self, severity: str, model_name: str = "") -> bool:
        """True when a ``severity`` record for ``model_name`` would be
        written right now. Lock-free (single dict reads) — the hot-path
        emission methods use the same checks inline."""
        if severity == SEVERITY_VERBOSE:
            return self._verbose_level(model_name) > 0
        gate = _GATE_FOR[severity]
        override = self._model_settings.get(model_name)
        if override is not None and gate in override:
            return bool(override[gate])
        return bool(self._settings[gate])

    def _verbose_level(self, model_name: str) -> int:
        override = self._model_settings.get(model_name)
        if override is not None and "log_verbose_level" in override:
            return int(override["log_verbose_level"])
        return int(self._settings["log_verbose_level"])

    # -- emission ------------------------------------------------------------

    def error(
        self,
        event: str,
        model: str = "",
        rate_key: Any = None,
        exc: Optional[BaseException] = None,
        **fields: Any,
    ) -> None:
        if not self.enabled(SEVERITY_ERROR, model):
            return
        self._emit(SEVERITY_ERROR, event, model, rate_key, exc, fields)

    def warning(
        self,
        event: str,
        model: str = "",
        rate_key: Any = None,
        exc: Optional[BaseException] = None,
        **fields: Any,
    ) -> None:
        if not self.enabled(SEVERITY_WARNING, model):
            return
        self._emit(SEVERITY_WARNING, event, model, rate_key, exc, fields)

    def info(
        self,
        event: str,
        model: str = "",
        rate_key: Any = None,
        exc: Optional[BaseException] = None,
        **fields: Any,
    ) -> None:
        if not self.enabled(SEVERITY_INFO, model):
            return
        self._emit(SEVERITY_INFO, event, model, rate_key, exc, fields)

    def verbose(
        self,
        event: str,
        model: str = "",
        level: int = 1,
        rate_key: Any = None,
        **fields: Any,
    ) -> None:
        """Per-request/diagnostic emission, gated by the live
        ``log_verbose_level`` (global or per-model). The one-attribute
        ``verbose_hot`` fast path keeps the all-quiet default at a single
        branch per call site."""
        if not self.verbose_hot:
            return
        if self._verbose_level(model) < level:
            return
        self._emit(SEVERITY_VERBOSE, event, model, rate_key, None, fields)

    def _emit(
        self,
        severity: str,
        event: str,
        model: str,
        rate_key: Any,
        exc: Optional[BaseException],
        fields: Dict[str, Any],
    ) -> None:
        now = self._clock()
        suppressed = 0
        if rate_key is not None:
            key = (severity, rate_key)
            with self._lock:
                state = self._rate.get(key)
                if state is None or now - state[0] >= self._rate_window_s:
                    state = [now, 0, 0 if state is None else state[2]]
                    self._rate[key] = state
                if state[1] >= self._rate_max:
                    state[2] += 1
                    self.suppressed_count += 1
                    return
                state[1] += 1
                suppressed, state[2] = state[2], 0
        record: Dict[str, Any] = {
            "ts": self._format_ts(now, model),
            "severity": severity,
            "event": event,
        }
        if self._name:
            record["logger"] = self._name
        if model:
            record["model"] = model
        if fields:
            record.update(fields)
        if exc is not None:
            record["error"] = str(exc) or type(exc).__name__
            record["error_type"] = type(exc).__name__
            if exc.__traceback__ is not None:
                record["traceback"] = "".join(
                    traceback.format_exception(type(exc), exc, exc.__traceback__)
                )
        if suppressed:
            record["suppressed"] = suppressed
        self._write(record, model)

    def _format_ts(self, now: float, model: str) -> Any:
        if self.settings_value("log_format", model) == "ISO8601":
            return datetime.fromtimestamp(now, timezone.utc).isoformat(
                timespec="milliseconds"
            )
        return round(now, 6)

    def settings_value(self, key: str, model_name: str = "") -> Any:
        """One effective setting, lock-free (hot-path helper)."""
        override = self._model_settings.get(model_name)
        if override is not None and key in override:
            return override[key]
        return self._settings[key]

    def _write(self, record: Dict[str, Any], model: str) -> None:
        try:
            line = json.dumps(record, default=str)
        except (TypeError, ValueError):  # non-serializable field slipped in
            line = json.dumps(
                {k: str(v) for k, v in record.items()}, default=str
            )
        log_file = self.settings_value("log_file", model)
        sink = self.sink
        # the lock guards only the counters and the file-handle map; all
        # IO — and especially the user-supplied sink, which may call back
        # into this logger — happens OUTSIDE it (the lock is not
        # reentrant, so a sink that logged would otherwise deadlock)
        handle = None
        with self._lock:
            self.emitted_count += 1
            if log_file:
                handle = self._files.get(log_file)
                if handle is None:
                    try:
                        handle = open(log_file, "a", encoding="utf-8")
                    except OSError:
                        handle = None
                    else:
                        self._files[log_file] = handle
        if sink is not None:
            try:
                sink(dict(record))
            except Exception:  # noqa: BLE001 - logging must never raise
                pass
        try:
            if handle is not None:
                # TextIOWrapper serializes concurrent write() calls
                # internally, so one record is one intact line
                handle.write(line + "\n")
                handle.flush()
            elif not log_file and sink is None:
                stream = self._stream or sys.stderr
                stream.write(line + "\n")
        except Exception:  # noqa: BLE001 - logging must never raise
            pass

    def flush(self) -> None:
        with self._lock:
            for handle in self._files.values():
                try:
                    handle.flush()
                except Exception:  # noqa: BLE001
                    pass

    def close(self) -> None:
        with self._lock:
            handles = list(self._files.values())
            self._files.clear()
        for handle in handles:
            try:
                handle.close()
            except Exception:  # noqa: BLE001
                pass

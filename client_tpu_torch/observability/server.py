"""Server-side tracing: the real trace extension behind the settings RPCs.

The port's own copy of ``client_tpu/observability/server.py``.

Honors the Triton trace-settings surface (``trace_level``, ``trace_rate``,
``trace_count``, ``log_frequency``, ``trace_file``; SURVEY §5) instead of
storing it as an inert dict: requests are sampled (one per ``trace_rate``,
stopping after ``trace_count`` traces), per-model overrides overlay the
global settings, and each traced request produces a Triton-style
timestamped record — ``REQUEST_START`` / ``QUEUE_START`` /
``COMPUTE_START`` / ``COMPUTE_END`` / ``REQUEST_END`` — keyed by the trace
id. A client-propagated W3C ``traceparent`` whose sampled flag is set
forces the trace (bypassing rate sampling) and reuses the client's trace
id, so the client span and server record correlate.

Records are written through the JSONL exporter named by ``trace_file``
(buffered per ``log_frequency``) and/or an injected exporter (tests use
:class:`client_tpu_torch.observability.trace.InMemoryExporter`).

Also home to the settings validation shared by both front-ends:
:meth:`TraceManager.update` and :func:`validate_log_settings` reject
unknown keys and wrong-typed values (HTTP 400 / gRPC INVALID_ARGUMENT).
"""

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# validate_log_settings moved to the structured-logging module (its
# canonical home since /v2/logging became real); re-exported here for
# back-compat with existing importers.
from client_tpu_torch.observability.logging import validate_log_settings  # noqa: F401
from client_tpu_torch.observability.trace import JsonlExporter, TraceContext
from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "ServerTrace",
    "TraceManager",
    "validate_log_settings",
]

TRACE_LEVELS = ("OFF", "TIMESTAMPS", "TENSORS")

# shared id generator (seeded from urandom once at import)
_ID_RNG = random.Random()
_ID_LOCK = threading.Lock()

_DEFAULT_SETTINGS: Dict[str, Any] = {
    "trace_level": ["OFF"],
    "trace_rate": "1000",
    "trace_count": "-1",
    "log_frequency": "0",
    "trace_file": "",
}


def _scalar(value) -> Any:
    """Unwrap the single-element list the gRPC wire uses for scalars."""
    if isinstance(value, (list, tuple)):
        if len(value) != 1:
            raise ValueError("expected a single value")
        return value[0]
    return value


def _as_int(key: str, value, minimum: int) -> str:
    value = _scalar(value)
    if isinstance(value, bool):
        raise InferenceServerException(
            f"trace setting '{key}' expects an integer, got a boolean"
        )
    try:
        parsed = int(value)
    except (TypeError, ValueError):
        raise InferenceServerException(
            f"trace setting '{key}' expects an integer, got {value!r}"
        ) from None
    if parsed < minimum:
        raise InferenceServerException(
            f"trace setting '{key}' must be >= {minimum}, got {parsed}"
        )
    return str(parsed)


def _normalize_trace_setting(key: str, value) -> Any:
    if key == "trace_level":
        levels = value if isinstance(value, (list, tuple)) else [value]
        out: List[str] = []
        for level in levels:
            if not isinstance(level, str) or level.upper() not in TRACE_LEVELS:
                raise InferenceServerException(
                    f"trace setting 'trace_level' expects values from "
                    f"{list(TRACE_LEVELS)}, got {level!r}"
                )
            out.append(level.upper())
        return out or ["OFF"]
    if key == "trace_rate":
        return _as_int(key, value, minimum=1)
    if key == "trace_count":
        return _as_int(key, value, minimum=-1)
    if key == "log_frequency":
        return _as_int(key, value, minimum=0)
    if key == "trace_file":
        value = _scalar(value)
        if not isinstance(value, str):
            raise InferenceServerException(
                f"trace setting 'trace_file' expects a string, got {value!r}"
            )
        return value
    raise InferenceServerException(f"unknown trace setting '{key}'")


class ServerTrace:
    """One traced server request: timestamped events -> one JSON record."""

    __slots__ = (
        "_manager",
        "trace_id",
        "parent_span_id",
        "model_name",
        "model_version",
        "request_id",
        "timestamps",
        "_done",
    )

    def __init__(
        self,
        manager: "TraceManager",
        trace_id: str,
        model_name: str,
        parent_span_id: Optional[str] = None,
    ):
        self._manager = manager
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.model_name = model_name
        self.model_version = ""
        self.request_id = ""
        self.timestamps: List[Dict[str, int]] = []
        self._done = False

    def event(self, name: str, ns: Optional[int] = None) -> None:
        """Record one timestamped trace event (monotonic ns; the
        caller's own clock readings pass straight through)."""
        if self._done:
            return
        if ns is None:
            ns = self._manager._clock_ns()
        self.timestamps.append({"name": name, "ns": int(ns)})

    def end(self, error: Optional[str] = None) -> None:
        """Complete the trace and hand the record to the manager
        (idempotent — front-ends call this from a finally)."""
        if self._done:
            return
        self._done = True
        record: Dict[str, Any] = {
            "id": self.trace_id,
            "model_name": self.model_name,
            "model_version": self.model_version,
            "request_id": self.request_id,
            "timestamps": self.timestamps,
        }
        if self.parent_span_id:
            record["parent_span_id"] = self.parent_span_id
        if error is not None:
            record["error"] = str(error)
        self._manager._complete(record)

    def to_dict(self) -> Dict[str, Any]:  # pragma: no cover - debug aid
        return {
            "id": self.trace_id,
            "model_name": self.model_name,
            "timestamps": self.timestamps,
        }


class TraceManager:
    """Owns trace settings (global + per-model), sampling, and records.

    Thread-safe: front-ends run on an event loop, the native front-end's
    pump thread books synchronously, and tests poke it directly.
    """

    def __init__(
        self,
        clock_ns: Callable[[], int] = time.monotonic_ns,
        exporter=None,
        id_source: Optional[Callable[[], str]] = None,
    ):
        self._clock_ns = clock_ns
        # explicit exporter (tests); trace_file adds a JSONL exporter
        self.exporter = exporter
        self._id_source = id_source
        self._lock = threading.Lock()
        self._settings: Dict[str, Any] = dict(_DEFAULT_SETTINGS)
        self._model_settings: Dict[str, Dict[str, Any]] = {}
        # per-model request counters for trace_rate sampling
        self._request_counts: Dict[str, int] = {}
        # traces remaining under trace_count (None = unlimited); a model
        # with its own trace_count override gets its own budget
        self._remaining: Optional[int] = None
        self._model_remaining: Dict[str, Optional[int]] = {}
        # lock-free hot-path gate: False while every effective trace_level
        # is OFF (the default), so begin() costs one attribute read per
        # request instead of a lock + settings merge
        self._enabled = False
        self._buffer: List[Dict[str, Any]] = []
        self._file_exporters: Dict[str, JsonlExporter] = {}
        self.started_count = 0
        self.completed_count = 0

    # -- settings -----------------------------------------------------------

    def settings(self, model_name: str = "") -> Dict[str, Any]:
        """The effective settings for ``model_name`` ("" = global)."""
        with self._lock:
            return self._settings_locked(model_name)

    def _settings_locked(self, model_name: str) -> Dict[str, Any]:
        merged = dict(self._settings)
        if model_name and model_name in self._model_settings:
            merged.update(self._model_settings[model_name])
        # copy mutable values so callers can't alias internal state
        merged["trace_level"] = list(merged["trace_level"])
        return merged

    def update(
        self, updates: Dict[str, Any], model_name: str = ""
    ) -> Dict[str, Any]:
        """Apply validated setting updates; returns the effective settings.

        A value of ``None`` clears the setting: a per-model override is
        removed (falling back to the global value), a global setting
        resets to its default. Unknown keys and wrong-typed values raise
        :class:`InferenceServerException` — nothing is applied then.
        """
        normalized: Dict[str, Optional[Any]] = {}
        for key, value in updates.items():
            if value is None:
                if key not in _DEFAULT_SETTINGS:
                    raise InferenceServerException(
                        f"unknown trace setting '{key}'"
                    )
                normalized[key] = None
            else:
                normalized[key] = _normalize_trace_setting(key, value)
        with self._lock:
            target = (
                self._model_settings.setdefault(model_name, {})
                if model_name
                else self._settings
            )
            for key, value in normalized.items():
                if value is None:
                    if model_name:
                        target.pop(key, None)
                    else:
                        target[key] = _DEFAULT_SETTINGS[key]
                else:
                    target[key] = value
                if key == "trace_count":
                    # (re)arm the countdown when a budget changes; a
                    # per-model override carries its own budget
                    if model_name:
                        if value is None:
                            self._model_remaining.pop(model_name, None)
                        else:
                            count = int(value)
                            self._model_remaining[model_name] = (
                                None if count < 0 else count
                            )
                    else:
                        count = int(self._settings["trace_count"])
                        self._remaining = None if count < 0 else count
            if model_name and not target:
                self._model_settings.pop(model_name, None)
            default_level = self._settings["trace_level"]
            self._enabled = default_level != ["OFF"] or any(
                o.get("trace_level", default_level) != ["OFF"]
                for o in self._model_settings.values()
            )
            return self._settings_locked(model_name)

    # -- sampling / lifecycle -----------------------------------------------

    def _gen_trace_id(self) -> str:
        if self._id_source is not None:
            return self._id_source()
        # PRNG, not os.urandom — same rationale as the client Tracer
        with _ID_LOCK:
            return f"{_ID_RNG.getrandbits(128):032x}"

    def begin(
        self,
        model_name: str,
        model_version: str = "",
        traceparent: Optional[str] = None,
        request_id: str = "",
    ) -> Optional[ServerTrace]:
        """Start a server trace for one request, or None when untraced.

        A sampled ``traceparent`` forces the trace (and reuses its trace
        id); otherwise every ``trace_rate``-th request per model traces.
        Both paths respect ``trace_level`` OFF and the ``trace_count``
        budget (a per-model trace_count override is its own budget).
        """
        if not self._enabled:  # lock-free default path: tracing all-OFF
            return None
        context = TraceContext.parse(traceparent)
        with self._lock:
            effective = self._settings_locked(model_name)
            if effective["trace_level"] == ["OFF"]:
                return None
            scoped = model_name in self._model_remaining
            remaining = (
                self._model_remaining[model_name]
                if scoped
                else self._remaining
            )
            if remaining is not None and remaining <= 0:
                return None
            if context is not None and context.sampled:
                pass  # forced by the propagated context
            else:
                rate = int(effective["trace_rate"])
                count = self._request_counts.get(model_name, 0)
                self._request_counts[model_name] = count + 1
                if count % rate != 0:
                    return None
            if remaining is not None:
                if scoped:
                    self._model_remaining[model_name] = remaining - 1
                else:
                    self._remaining = remaining - 1
            self.started_count += 1
        trace = ServerTrace(
            self,
            trace_id=context.trace_id if context else self._gen_trace_id(),
            model_name=model_name,
            parent_span_id=context.span_id if context else None,
        )
        trace.model_version = model_version
        trace.request_id = request_id
        trace.event("REQUEST_START")
        return trace

    # -- record sink --------------------------------------------------------

    def _complete(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.completed_count += 1
            self._buffer.append(record)
            settings = self._settings_locked(record.get("model_name", ""))
            frequency = max(1, int(settings["log_frequency"]))
            if len(self._buffer) < frequency:
                return
            batch, self._buffer = self._buffer, []
            exporters = []
            if self.exporter is not None:
                exporters.append(self.exporter)
            trace_file = settings["trace_file"]
            if trace_file:
                file_exporter = self._file_exporters.get(trace_file)
                if file_exporter is None:
                    file_exporter = JsonlExporter(trace_file)
                    self._file_exporters[trace_file] = file_exporter
                exporters.append(file_exporter)
        for exporter in exporters:
            try:
                exporter.export(batch)
            except Exception:  # noqa: BLE001 - tracing must never fail a request
                pass

    def flush(self) -> None:
        """Write out any buffered records (shutdown / test hook)."""
        with self._lock:
            batch, self._buffer = self._buffer, []
            exporters = [e for e in (self.exporter,) if e is not None]
            exporters.extend(self._file_exporters.values())
        if not batch:
            return
        for exporter in exporters:
            try:
                exporter.export(batch)
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        self.flush()
        with self._lock:
            exporters = list(self._file_exporters.values())
            self._file_exporters.clear()
        for exporter in exporters:
            exporter.close()

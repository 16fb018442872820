"""Client-side tracing core: spans, W3C trace context, exporters, metrics.

An own copy of ``client_tpu/observability/trace.py``; the ``traceparent``
header is byte-compatible with the JAX package's.

A lightweight, dependency-free tracer the client surfaces
(``http``, ``http.aio``, ``grpc``, ``grpc.aio``) use to attribute where
an inference request's time goes: serialize -> send -> wait ->
deserialize, per transport attempt, annotated with the retry and
circuit-breaker events the resilience layer performed on the call's
behalf. Trace context propagates to the server as a W3C ``traceparent``
HTTP header, so the server-side trace record of a server that records traces (the JAX package's; the port's server
records none yet) shares the client's trace id.

Everything is clock-injectable (``clock_ns``) — the same fake-clock
testing pattern as :mod:`client_tpu_torch.resilience.policy`.
"""

import contextlib
import contextvars
import dataclasses
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

TRACEPARENT_HEADER = "traceparent"

__all__ = [
    "TRACEPARENT_HEADER",
    "ClientMetrics",
    "ClientTrace",
    "InMemoryExporter",
    "JsonlExporter",
    "NOOP_TRACE",
    "Span",
    "TraceContext",
    "Tracer",
    "last_stages",
    "reset_last_stages",
    "start_trace",
]


# ---------------------------------------------------------------------------
# W3C trace context

_HEX = set("0123456789abcdef")


def _is_hex(value: str, length: int) -> bool:
    return len(value) == length and set(value) <= _HEX


@dataclasses.dataclass(slots=True, frozen=True)
class TraceContext:
    """A parsed W3C ``traceparent`` (version 00) value."""

    trace_id: str  # 32 lowercase hex chars, not all zero
    span_id: str  # 16 lowercase hex chars, not all zero
    sampled: bool = True

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    @classmethod
    def parse(cls, header: Optional[str]) -> Optional["TraceContext"]:
        """Parse a ``traceparent`` header; None for anything malformed
        (a bad header must never fail the request it rode in on)."""
        if not header:
            return None
        parts = header.strip().lower().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
        if not _is_hex(version, 2) or version == "ff":
            return None
        if not _is_hex(trace_id, 32) or trace_id == "0" * 32:
            return None
        if not _is_hex(span_id, 16) or span_id == "0" * 16:
            return None
        if not _is_hex(flags, 2):
            return None
        return cls(
            trace_id=trace_id,
            span_id=span_id,
            sampled=bool(int(flags, 16) & 0x01),
        )


# ---------------------------------------------------------------------------
# spans


@dataclasses.dataclass(slots=True)
class Span:
    """One timed operation within a trace (monotonic ns timestamps)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # (timestamp_ns, text) point annotations
    events: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    @property
    def duration_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)

    def to_dict(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
        }
        if self.parent_id:
            doc["parent_id"] = self.parent_id
        if self.attributes:
            doc["attributes"] = self.attributes
        if self.events:
            doc["events"] = [{"ns": ns, "text": text} for ns, text in self.events]
        if self.error is not None:
            doc["error"] = self.error
        return doc


# ---------------------------------------------------------------------------
# exporters


class InMemoryExporter:
    """Collects exported items in memory (the test exporter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Any] = []

    def export(self, items) -> None:
        with self._lock:
            self.items.extend(items)

    # span-flavored conveniences -------------------------------------------

    @property
    def spans(self) -> List[Any]:
        return list(self.items)

    def trace_ids(self) -> List[str]:
        seen = []
        for item in self.items:
            trace_id = (
                item.trace_id
                if hasattr(item, "trace_id")
                else item.get("trace_id") or item.get("id")
            )
            if trace_id not in seen:
                seen.append(trace_id)
        return seen

    def find(self, trace_id: str) -> List[Any]:
        out = []
        for item in self.items:
            tid = (
                item.trace_id
                if hasattr(item, "trace_id")
                else item.get("trace_id") or item.get("id")
            )
            if tid == trace_id:
                out.append(item)
        return out

    def clear(self) -> None:
        with self._lock:
            self.items.clear()


class JsonlExporter:
    """Writes one JSON object per line; accepts spans or plain dicts."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        directory = os.path.dirname(os.path.abspath(path))
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._file = open(path, "a", encoding="utf-8")

    def export(self, items) -> None:
        lines = []
        for item in items:
            doc = item.to_dict() if hasattr(item, "to_dict") else item
            lines.append(json.dumps(doc, default=str))
        with self._lock:
            if self._file.closed:
                return
            self._file.write("\n".join(lines) + "\n")
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()


# ---------------------------------------------------------------------------
# client metrics


class ClientMetrics:
    """Thread-safe client-side telemetry snapshot: request/error/retry
    counts plus a fixed-bucket latency histogram (microsecond bounds)."""

    BUCKET_BOUNDS_US = (
        100,
        250,
        500,
        1_000,
        2_500,
        5_000,
        10_000,
        25_000,
        50_000,
        100_000,
        250_000,
        500_000,
        1_000_000,
        2_500_000,
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.request_count = 0
        self.error_count = 0
        self.retry_count = 0
        self.total_latency_ns = 0
        # one overflow bucket past the last bound
        self._buckets = [0] * (len(self.BUCKET_BOUNDS_US) + 1)

    def record(self, latency_ns: int, error: bool = False, retries: int = 0) -> None:
        latency_us = latency_ns / 1e3
        index = len(self.BUCKET_BOUNDS_US)
        for i, bound in enumerate(self.BUCKET_BOUNDS_US):
            if latency_us <= bound:
                index = i
                break
        with self._lock:
            self.request_count += 1
            self.total_latency_ns += latency_ns
            self.retry_count += retries
            if error:
                self.error_count += 1
            self._buckets[index] += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count = self.request_count
            histogram = []
            cumulative = 0
            for bound, n in zip(self.BUCKET_BOUNDS_US, self._buckets):
                cumulative += n
                histogram.append({"le_us": bound, "count": cumulative})
            cumulative += self._buckets[-1]
            histogram.append({"le_us": "inf", "count": cumulative})
            return {
                "request_count": count,
                "error_count": self.error_count,
                "retry_count": self.retry_count,
                "avg_latency_us": (
                    self.total_latency_ns / count / 1e3 if count else 0.0
                ),
                "latency_histogram_us": histogram,
            }


# ---------------------------------------------------------------------------
# stage-durations contextvar (the perf harness reads this per request,
# same idiom as resilience.last_retry_count)

_last_stages: contextvars.ContextVar = contextvars.ContextVar(
    "client_tpu_last_trace_stages", default=None
)


def reset_last_stages() -> None:
    """Clear the per-context stage record (call before a traced call)."""
    _last_stages.set(None)


def last_stages() -> Optional[Dict[str, Any]]:
    """Stage durations of the most recent traced call in this context:
    ``{"serialize": ns, "transport": ns, "deserialize": ns, "total": ns,
    "attempts": n, "trace_id": hex}`` — None when the call was untraced."""
    return _last_stages.get()


# ---------------------------------------------------------------------------
# tracer


class _NoopTrace:
    """Zero-cost stand-in when tracing is off or the call was sampled out.

    Client code is single-path: every surface talks to this interface,
    and with no tracer configured the overhead is attribute reads and
    no-op calls — no spans, no contextvar writes.
    """

    __slots__ = ()

    traceparent = None
    trace_id = None

    def stage(self, name):
        return _NULL_CM

    def begin_span(self, name, **attributes):
        return None

    def end_span(self, span, error=None):
        return None

    def attempt_index(self) -> int:
        return 0

    def wrap_attempt(self, send, name="request"):
        return send

    def wrap_attempt_async(self, send, name="request"):
        return send

    def annotate(self, text) -> None:
        pass

    def finish(self, error=None) -> None:
        pass


_NULL_CM = contextlib.nullcontext()
NOOP_TRACE = _NoopTrace()


def start_trace(tracer, name: str, **attributes):
    """Start a client trace on ``tracer`` (None-safe): returns a
    :class:`ClientTrace`, or :data:`NOOP_TRACE` when ``tracer`` is None
    or the call is sampled out."""
    if tracer is None:
        return NOOP_TRACE
    trace = tracer.start(name, **attributes)
    return trace if trace is not None else NOOP_TRACE


class _StageCM:
    __slots__ = ("_trace", "_name", "_span")

    def __init__(self, trace, name):
        self._trace = trace
        self._name = name
        self._span = None

    def __enter__(self):
        self._span = self._trace.begin_span(self._name)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._trace.end_span(
            self._span, error=str(exc) if exc is not None else None
        )
        return False


# span names counted as transport time in the stage rollup
_TRANSPORT_SPANS = frozenset({"send", "wait", "request"})


class ClientTrace:
    """One traced client call: a root span plus stage/attempt children.

    Not thread-safe; a trace belongs to the one call that created it.
    """

    __slots__ = ("_tracer", "root", "spans", "_attempts", "_finished")

    def __init__(self, tracer: "Tracer", root: Span):
        self._tracer = tracer
        self.root = root
        self.spans: List[Span] = [root]
        self._attempts = 0
        self._finished = False

    # -- identity -----------------------------------------------------------

    @property
    def trace_id(self) -> str:
        return self.root.trace_id

    @property
    def traceparent(self) -> str:
        return TraceContext(
            trace_id=self.root.trace_id, span_id=self.root.span_id
        ).to_header()

    # -- spans --------------------------------------------------------------

    def begin_span(self, name: str, **attributes) -> Span:
        span = Span(
            name=name,
            trace_id=self.root.trace_id,
            span_id=self._tracer._gen_id(8),
            parent_id=self.root.span_id,
            start_ns=self._tracer._clock_ns(),
            attributes=attributes,
        )
        self.spans.append(span)
        return span

    def end_span(self, span: Optional[Span], error: Optional[str] = None) -> None:
        if span is None:
            return
        span.end_ns = self._tracer._clock_ns()
        if error is not None:
            span.error = error

    def stage(self, name: str) -> _StageCM:
        """Context manager timing one stage (serialize/deserialize/...)."""
        return _StageCM(self, name)

    def attempt_index(self) -> int:
        """The next transport attempt's 0-based index (increments)."""
        index = self._attempts
        self._attempts += 1
        return index

    def wrap_attempt(self, send: Callable, name: str = "request") -> Callable:
        """Wrap a sync per-attempt send so each attempt gets its own span
        (the gRPC clients' transport attempts)."""

        def wrapped(attempt_timeout):
            span = self.begin_span(name, attempt=self.attempt_index())
            try:
                value = send(attempt_timeout)
            except BaseException as e:
                self.end_span(span, error=f"{type(e).__name__}: {e}")
                raise
            self.end_span(span)
            return value

        return wrapped

    def wrap_attempt_async(self, send: Callable, name: str = "request") -> Callable:
        """Async twin of :meth:`wrap_attempt`."""

        async def wrapped(attempt_timeout):
            span = self.begin_span(name, attempt=self.attempt_index())
            try:
                value = await send(attempt_timeout)
            except BaseException as e:
                self.end_span(span, error=f"{type(e).__name__}: {e}")
                raise
            self.end_span(span)
            return value

        return wrapped

    def annotate(self, text: str) -> None:
        self.root.events.append((self._tracer._clock_ns(), str(text)))

    # -- completion ---------------------------------------------------------

    def finish(self, error=None) -> None:
        """End the root span, fold in resilience events, export, account."""
        if self._finished:
            return
        self._finished = True
        tracer = self._tracer
        self.root.end_ns = tracer._clock_ns()
        if error is not None:
            self.root.error = str(error)
        # retry/circuit-breaker events the resilience layer logged for
        # this context during the call
        from client_tpu_torch.resilience.policy import (
            last_retry_count,
            take_attempt_events,
        )

        events = take_attempt_events()
        retries = last_retry_count()
        if retries:
            self.root.attributes["retries"] = retries
        if events:
            self.root.attributes["resilience"] = events
        if self._attempts:
            self.root.attributes["attempts"] = self._attempts
        # stage rollup for the perf harness
        stages = {"serialize": 0, "transport": 0, "deserialize": 0}
        for span in self.spans[1:]:
            if span.name == "serialize":
                stages["serialize"] += span.duration_ns
            elif span.name in _TRANSPORT_SPANS:
                stages["transport"] += span.duration_ns
            elif span.name == "deserialize":
                stages["deserialize"] += span.duration_ns
        stages["total"] = self.root.duration_ns
        stages["attempts"] = self._attempts
        stages["trace_id"] = self.root.trace_id
        _last_stages.set(stages)
        tracer.metrics.record(
            self.root.duration_ns, error=error is not None, retries=retries
        )
        if tracer.exporter is not None:
            tracer.exporter.export(list(self.spans))


class Tracer:
    """Creates client traces; owns the exporter, metrics, clock, and ids.

    Parameters
    ----------
    exporter:
        Destination for finished traces' spans (``InMemoryExporter``,
        ``JsonlExporter``, or anything with ``export(spans)``). None
        keeps only metrics + the per-call stage rollup — the cheap
        configuration the perf harness uses.
    metrics:
        A shared :class:`ClientMetrics` (one is created when omitted).
    sample_rate:
        Fraction of calls traced (1.0 = all). Sampled-out calls cost one
        rng draw and run the untraced path.
    clock_ns / rng:
        Injectables for tests: ``clock_ns()`` -> monotonic nanoseconds;
        ``rng`` drives sampling and id generation (deterministic ids).
    """

    def __init__(
        self,
        exporter=None,
        metrics: Optional[ClientMetrics] = None,
        sample_rate: float = 1.0,
        clock_ns: Callable[[], int] = time.monotonic_ns,
        rng: Optional[random.Random] = None,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be within [0, 1], got {sample_rate}"
            )
        self.exporter = exporter
        self.metrics = metrics if metrics is not None else ClientMetrics()
        self.sample_rate = sample_rate
        self._clock_ns = clock_ns
        # PRNG ids, not os.urandom: trace ids need uniqueness, not
        # cryptography, and urandom is a ~20 us syscall per draw — it
        # dominated the traced hot path. Seeded from urandom once.
        self._rng = rng if rng is not None else random.Random()
        self._rng_lock = threading.Lock()

    def _gen_id(self, nbytes: int) -> str:
        with self._rng_lock:
            return f"{self._rng.getrandbits(nbytes * 8):0{nbytes * 2}x}"

    def _sampled(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        with self._rng_lock:
            return self._rng.random() < self.sample_rate

    def start(self, name: str, **attributes) -> Optional[ClientTrace]:
        """Begin a trace for one client call; None when sampled out."""
        if not self._sampled():
            return None
        from client_tpu_torch.resilience.policy import (
            begin_attempt_events,
            reset_retry_count,
        )

        root = Span(
            name=name,
            trace_id=self._gen_id(16),
            span_id=self._gen_id(8),
            start_ns=self._clock_ns(),
            attributes=dict(attributes),
        )
        # fresh per-context event log and retry counter, so the resilience
        # layer's events land on this trace and a call that fails before
        # the attempt loop can't inherit the previous call's retry count
        begin_attempt_events()
        reset_retry_count()
        return ClientTrace(self, root)

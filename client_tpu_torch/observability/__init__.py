"""Observability of the port: the client-side tracer
(:mod:`client_tpu_torch.observability.trace`). The server's metrics,
logs and recorders are not ported yet."""

from client_tpu_torch.observability.trace import (
    NOOP_TRACE,
    TRACEPARENT_HEADER,
    ClientMetrics,
    ClientTrace,
    InMemoryExporter,
    JsonlExporter,
    Span,
    TraceContext,
    Tracer,
    start_trace,
)

__all__ = [
    "NOOP_TRACE",
    "TRACEPARENT_HEADER",
    "ClientMetrics",
    "ClientTrace",
    "InMemoryExporter",
    "JsonlExporter",
    "Span",
    "TraceContext",
    "Tracer",
    "start_trace",
]

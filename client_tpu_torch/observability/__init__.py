"""Observability of the port, own copies of ``client_tpu/observability``:
the client-side tracer (:mod:`~client_tpu_torch.observability.trace`),
the dependency-free Prometheus registry (``metrics``), rolling windows
and SLO tracking (``window``, ``slo``), the flight recorder
(``recorder``), the structured logger (``logging``), the server's trace
manager (``server``) and the hot-path profilers (``profiling``, with a
``torch.profiler`` capture in place of the JAX one) and the fleet
aggregation (``fleet``).

Everything is clock-injectable; ``tools/clock_lint.py`` finds no direct
``time.*()`` call in this package.
"""

from client_tpu_torch.observability.logging import (
    DEFAULT_LOG_SETTINGS,
    StructuredLogger,
    validate_log_settings,
)
from client_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_exposition,
)
from client_tpu_torch.observability.profiling import (
    STAGES,
    ProfileResult,
    StageCpuAccounting,
    WallProfiler,
    maybe_torch_trace,
    stage_scope,
)
from client_tpu_torch.observability.recorder import FlightRecorder
from client_tpu_torch.observability.server import ServerTrace, TraceManager
from client_tpu_torch.observability.slo import LiveTelemetry, SloObjective
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
from client_tpu_torch.observability.window import (
    WindowedCounter,
    WindowedHistogram,
    WindowSnapshot,
)

__all__ = [
    "DEFAULT_LOG_SETTINGS",
    "NOOP_TRACE",
    "STAGES",
    "TRACEPARENT_HEADER",
    "ClientMetrics",
    "ClientTrace",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InMemoryExporter",
    "JsonlExporter",
    "LiveTelemetry",
    "MetricsRegistry",
    "ProfileResult",
    "ServerTrace",
    "SloObjective",
    "Span",
    "StageCpuAccounting",
    "StructuredLogger",
    "TraceContext",
    "TraceManager",
    "Tracer",
    "WallProfiler",
    "WindowSnapshot",
    "WindowedCounter",
    "WindowedHistogram",
    "maybe_torch_trace",
    "parse_exposition",
    "stage_scope",
    "start_trace",
    "validate_log_settings",
]

"""The port's perf harness: load generation and measurement.

An own copy of ``client_tpu/perf``: load managers (concurrency,
request-rate, custom-interval, periodic), a measurement engine with
stability windows, per-request records, CSV and profile-export JSON, and
a CLI with the reference's flags (``python -m client_tpu_torch.perf``).
Its backends speak through the port's own clients
(:mod:`client_tpu_torch.http.aio`, :mod:`client_tpu_torch.grpc.aio`, the
stdlib-asyncio REST readers) or call a
:class:`~client_tpu_torch.server.core.ServerCore` in-process. The harness
never touches the card: it only speaks HTTP, gRPC and shared memory.
Multi-process runs (``--world-size``, :mod:`~client_tpu_torch.perf.distributed`)
and fleets of replicas (``--fleet``, :mod:`~client_tpu_torch.perf.fleet_runner`)
are served as the reference serves them.
"""

from client_tpu_torch.perf.records import (  # noqa: F401
    PerfStatus,
    RequestRecord,
    ServerMetricsSummary,
)
from client_tpu_torch.perf.profiler import InferenceProfiler  # noqa: F401

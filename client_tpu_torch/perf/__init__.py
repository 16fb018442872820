"""The port's perf harness: load generation and measurement.

An own copy of ``client_tpu/perf``: load managers (concurrency,
request-rate, custom-interval, periodic), a measurement engine with
stability windows, per-request records, CSV and profile-export JSON, and
a CLI with the reference's flags (``python -m client_tpu_torch.perf``).
Its backends speak through the port's own clients
(:mod:`client_tpu_torch.http.aio`, a stdlib-asyncio OpenAI reader) or
call a :class:`~client_tpu_torch.server.core.ServerCore` in-process. The
harness never touches the card: it only speaks HTTP and shared memory.

Not ported yet: the gRPC, TensorFlow-Serving and TorchServe backends,
the ``/metrics`` collector, multi-process runs and in-process fleets;
the CLI refuses their flags with exit code 2.
"""

from client_tpu_torch.perf.records import (  # noqa: F401
    PerfStatus,
    RequestRecord,
    ServerMetricsSummary,
)
from client_tpu_torch.perf.profiler import InferenceProfiler  # noqa: F401

"""Router tier: a stateless, protocol-preserving fleet front door.

An own copy of ``client_tpu/router/``, on the port's native gRPC
front-end, its h2c client transport and stdlib asyncio (no grpcio, no
aiohttp). Clients keep speaking KServe v2 (HTTP or gRPC) to ONE address;
the router classifies each request with the protobuf-free wire scanner,
routes it over live per-backend telemetry (routing policies, outlier
ejection, consistent-hash affinity: the client fleet layer run
server-side), splices only the correlation id, and forwards raw bytes on
persistent multiplexed backend streams. Overload sheds default-priority
traffic with ``Retry-After``; the SLO autoscaler
(:mod:`client_tpu_torch.perf.fleet_runner`) grows and drains the replica
set behind it without a client ever noticing.
"""

from client_tpu_torch.router.backends import BackendLink, ReadinessProber  # noqa: F401
from client_tpu_torch.router.core import (  # noqa: F401
    ModelTable,
    RouterCore,
    RouterOverloadError,
)
from client_tpu_torch.router.server import RouterServer  # noqa: F401

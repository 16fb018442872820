"""Client endpoint failover, routing and hedging.

An own copy of the client side of ``client_tpu/lifecycle``: the
server-side drain controller (``drain.py``) is not ported yet.

:class:`EndpointPool`
    Accepted everywhere a ``url`` is (``urls=[...]`` or an explicit
    pool): sticky-primary routing that health-checks recovering
    endpoints via ``/v2/health/ready``, benches draining or dead
    endpoints, integrates per-endpoint circuit breakers, and fails over
    mid-retry-loop — immediately, skipping the backoff sleep — when
    another endpoint is available.
:class:`RoutingPolicy` and its built-ins
    Load-aware selection over the pool's live signals.
:class:`HedgePolicy`, :func:`hedged_send_async`
    A second attempt for the tail; first response wins.
"""

from client_tpu_torch.lifecycle.hedge import (
    HedgePolicy,
    hedged_send_async,
    resolve_hedge_policy,
)
from client_tpu_torch.lifecycle.pool import (
    UNAVAILABLE_TOKENS,
    Endpoint,
    EndpointPool,
    failover_retry_policy,
    status_is_unavailable,
)
from client_tpu_torch.lifecycle.routing import (
    ROUTING_POLICY_NAMES,
    ConsistentHashPolicy,
    LeastOutstandingPolicy,
    PowerOfTwoPolicy,
    RoundRobinPolicy,
    RoutingPolicy,
    resolve_routing_policy,
)

__all__ = [
    "ROUTING_POLICY_NAMES",
    "UNAVAILABLE_TOKENS",
    "ConsistentHashPolicy",
    "Endpoint",
    "EndpointPool",
    "HedgePolicy",
    "LeastOutstandingPolicy",
    "PowerOfTwoPolicy",
    "RoundRobinPolicy",
    "RoutingPolicy",
    "failover_retry_policy",
    "hedged_send_async",
    "resolve_hedge_policy",
    "resolve_routing_policy",
    "status_is_unavailable",
]

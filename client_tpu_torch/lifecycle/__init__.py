"""Graceful lifecycle: drain-aware shutdown and client endpoint failover.

An own copy of ``client_tpu/lifecycle``.

:class:`DrainController`, :class:`ServerDrainingError`
    The server's SERVING -> DRAINING -> STOPPED states with an in-flight
    census over every ``ServerCore`` execution path: draining flips
    readiness false (liveness stays true), rejects new inferences with
    503 + ``Retry-After``, and lets in-flight and queued work finish up
    to a drain deadline.

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

from client_tpu_torch.lifecycle.drain import (
    DRAINING,
    RECOVERING,
    SERVING,
    STATE_VALUES,
    STOPPED,
    DrainController,
    ServerDrainingError,
)
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
    grpc_status_is_endpoint_outage,
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
    "DRAINING",
    "RECOVERING",
    "ROUTING_POLICY_NAMES",
    "SERVING",
    "STATE_VALUES",
    "STOPPED",
    "UNAVAILABLE_TOKENS",
    "ConsistentHashPolicy",
    "DrainController",
    "Endpoint",
    "EndpointPool",
    "HedgePolicy",
    "LeastOutstandingPolicy",
    "PowerOfTwoPolicy",
    "RoundRobinPolicy",
    "RoutingPolicy",
    "ServerDrainingError",
    "failover_retry_policy",
    "grpc_status_is_endpoint_outage",
    "hedged_send_async",
    "resolve_hedge_policy",
    "resolve_routing_policy",
    "status_is_unavailable",
]

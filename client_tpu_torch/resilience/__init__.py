"""Transport-agnostic resilience for the port's clients: retries,
deadlines, circuit breaking.

An own copy of the client side of ``client_tpu/resilience``; its fault
injection (``chaos.py``, for the JAX package's in-process servers) is not
ported. Everything is off by default — a client with no ``retry_policy``
and no ``circuit_breaker`` makes one attempt a call.

RetryPolicy
    Capped exponential backoff with full jitter and retryable-error
    classification (connect errors, HTTP 429/502/503/504, gRPC
    UNAVAILABLE/DEADLINE_EXCEEDED/RESOURCE_EXHAUSTED). Clock, sleep and
    rng are injectable so fault tests run in milliseconds.
Deadline
    A total time budget shared by every attempt of one call.
CircuitBreaker
    closed/open/half-open breaker with a failure threshold and cooldown.
"""

from client_tpu_torch.resilience.policy import (
    CONNECTION_ERROR_STATUS,
    DEFAULT_RETRYABLE_GRPC_CODES,
    DEFAULT_RETRYABLE_HTTP_STATUSES,
    CircuitBreaker,
    CircuitBreakerOpenError,
    Deadline,
    RetryPolicy,
    begin_attempt_events,
    exception_is_retryable,
    last_retry_count,
    record_breaker_outcome,
    reset_retry_count,
    run_with_resilience,
    run_with_resilience_async,
    sequence_is_idempotent,
    take_attempt_events,
)

__all__ = [
    "CONNECTION_ERROR_STATUS",
    "DEFAULT_RETRYABLE_GRPC_CODES",
    "DEFAULT_RETRYABLE_HTTP_STATUSES",
    "CircuitBreaker",
    "CircuitBreakerOpenError",
    "Deadline",
    "RetryPolicy",
    "begin_attempt_events",
    "exception_is_retryable",
    "last_retry_count",
    "record_breaker_outcome",
    "reset_retry_count",
    "run_with_resilience",
    "run_with_resilience_async",
    "sequence_is_idempotent",
    "take_attempt_events",
]

"""Scheduling and admission control: queue policies, priority queues,
the rate limiter and the admission gate.

Own copies of ``client_tpu.scheduling``, with its module paths:

- :class:`QueuePolicy` (``policy.py``) — per-model admission
  configuration (``max_queue_size``, ``default_timeout_us``,
  ``timeout_action``, ``allow_timeout_override``, ``priority_levels``,
  ``default_priority_level``, the rate limiter's resource demands)
  resolved from the model's declarations; the admission errors.
- :class:`PriorityQueue` (``queue.py``) — bounded multi-level FIFO with
  deadline expiry: a timed-out entry is rejected, or, with the
  "continue" (DELAY) action, demoted behind every in-deadline entry.
- :class:`RateLimiter` (``rate_limiter.py``) — grants device executions
  against named resource pools in (priority, arrival) order.
- :class:`AdmissionGate` (``policy.py``) — the waiting-room bound of the
  execution paths that have no queue of their own.

No function here reads a wall clock: callers pass "now" values in.
"""

from client_tpu_torch.scheduling.policy import (
    SCHEDULING_PARAM_KEYS,
    TIMEOUT_ACTION_CONTINUE,
    TIMEOUT_ACTION_REJECT,
    AdmissionGate,
    QueueFullError,
    QueuePolicy,
    QueueTimeoutError,
    SchedulingError,
)
from client_tpu_torch.scheduling.queue import PriorityQueue, QueueItem
from client_tpu_torch.scheduling.rate_limiter import RateLimiter

__all__ = [
    "SCHEDULING_PARAM_KEYS",
    "TIMEOUT_ACTION_CONTINUE",
    "TIMEOUT_ACTION_REJECT",
    "AdmissionGate",
    "PriorityQueue",
    "QueueFullError",
    "QueueItem",
    "QueuePolicy",
    "QueueTimeoutError",
    "RateLimiter",
    "SchedulingError",
]

"""Queue policies, admission errors, and the non-queue admission gate.

The configuration surface mirrors the reference proto
(model_config.proto): ``ModelQueuePolicy`` (max_queue_size,
default_timeout_microseconds, timeout_action REJECT/DELAY,
allow_timeout_override) and the priority half of ``ModelDynamicBatching``
(priority_levels, default_priority_level), plus the resource demands of
``ModelRateLimiter``. A model declares them as plain attributes
(:class:`client_tpu_torch.server.model_repository.Model`); the server core
resolves one :class:`QueuePolicy` per model and stamps every admitted
request with its effective priority level and queue deadline.

The port's own copy of ``client_tpu/scheduling/policy.py``. No
wall-clock reads here: callers pass ``arrival_ns``/"now" values in.
"""

import threading
from typing import Any, Dict, Optional

from client_tpu_torch.utils import InferenceServerException

# Request parameters that carry scheduling intent ("priority" is the
# ModelInferRequest uint64 priority, "timeout"/"timeout_us" the queue
# timeout in microseconds). They are consumed by the admission layer and
# MUST be excluded from batch-compatibility signatures: two same-shape
# requests that differ only in scheduling params still share a device
# execution.
SCHEDULING_PARAM_KEYS = frozenset({"priority", "timeout", "timeout_us"})

# What happens to a request whose queue deadline passes before execution:
# "reject" fails it with a deadline error (Triton TIMEOUT_ACTION REJECT);
# "continue" demotes it behind every in-deadline request and executes it
# when nothing else is waiting (Triton TIMEOUT_ACTION DELAY).
TIMEOUT_ACTION_REJECT = "reject"
TIMEOUT_ACTION_CONTINUE = "continue"
_TIMEOUT_ACTIONS = (TIMEOUT_ACTION_REJECT, TIMEOUT_ACTION_CONTINUE)


class SchedulingError(InferenceServerException):
    """Base class for admission-control rejections.

    Carries both wire faces so each front-end can map it without parsing
    messages: ``http_status`` (+ optional ``retry_after_s`` rendered as a
    ``Retry-After`` header) and ``grpc_code`` (a grpc.StatusCode name).
    The exception ``status()`` is the gRPC code name, which the client
    resilience layer already classifies as retryable.
    """

    http_status = 503
    grpc_code = "UNAVAILABLE"
    # label value for tpu_queue_rejected_total{reason=...}
    reason = "scheduling"

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg, status=self.grpc_code)
        self.retry_after_s = retry_after_s


class QueueFullError(SchedulingError):
    """The model's scheduler queue is at ``max_queue_size``."""

    http_status = 429
    grpc_code = "RESOURCE_EXHAUSTED"
    reason = "queue_full"

    def __init__(
        self,
        model_name: str,
        max_queue_size: int,
        retry_after_s: float = 1.0,
    ):
        super().__init__(
            f"inference queue for model '{model_name}' is full "
            f"(max_queue_size {max_queue_size}); request rejected",
            retry_after_s=retry_after_s,
        )


class QueueTimeoutError(SchedulingError):
    """A request's queue deadline passed before it reached the device."""

    http_status = 504
    grpc_code = "DEADLINE_EXCEEDED"
    reason = "timeout"

    def __init__(self, model_name: str, timeout_us: int):
        super().__init__(
            f"request to model '{model_name}' timed out in queue "
            f"(queue timeout {timeout_us} us exceeded before execution)"
        )


class QueuePolicy:
    """Per-model admission configuration, resolved once per model load.

    ``priority_levels`` N declares levels ``1..N`` (1 = highest, matching
    Triton). Requests that carry no ``priority`` parameter land on
    ``default_priority_level`` when set, else on the LOWEST level —
    unprioritized traffic never jumps ahead of traffic that asked.
    ``max_queue_size`` 0 disables the bound; ``default_timeout_us`` 0
    disables the default deadline.
    """

    __slots__ = (
        "model",
        "max_queue_size",
        "default_timeout_us",
        "timeout_action",
        "allow_timeout_override",
        "priority_levels",
        "default_priority_level",
        "rate_resources",
        "rate_priority",
    )

    def __init__(
        self,
        model=None,
        max_queue_size: int = 0,
        default_timeout_us: int = 0,
        timeout_action: str = TIMEOUT_ACTION_REJECT,
        allow_timeout_override: bool = True,
        priority_levels: int = 0,
        default_priority_level: int = 0,
        rate_resources: Optional[Dict[str, int]] = None,
        rate_priority: int = 0,
    ):
        if timeout_action not in _TIMEOUT_ACTIONS:
            raise ValueError(
                f"timeout_action must be one of {_TIMEOUT_ACTIONS}, got "
                f"{timeout_action!r}"
            )
        self.model = model
        self.max_queue_size = max(0, int(max_queue_size))
        self.default_timeout_us = max(0, int(default_timeout_us))
        self.timeout_action = timeout_action
        self.allow_timeout_override = bool(allow_timeout_override)
        self.priority_levels = max(0, int(priority_levels))
        self.default_priority_level = max(0, int(default_priority_level))
        self.rate_resources = dict(rate_resources or {})
        self.rate_priority = int(rate_priority)

    @classmethod
    def from_model(cls, model) -> "QueuePolicy":
        """Resolve a model's scheduling declarations (all optional)."""
        declared = getattr(model, "queue_policy", None) or {}
        limiter = getattr(model, "rate_limiter", None) or {}
        resources = {
            str(r["name"]): int(r.get("count", 1))
            for r in limiter.get("resources", [])
        }
        return cls(
            model=model,
            max_queue_size=declared.get("max_queue_size", 0),
            default_timeout_us=declared.get("default_timeout_us", 0),
            timeout_action=declared.get(
                "timeout_action", TIMEOUT_ACTION_REJECT
            ),
            allow_timeout_override=declared.get(
                "allow_timeout_override", True
            ),
            priority_levels=getattr(model, "priority_levels", 0) or 0,
            default_priority_level=getattr(
                model, "default_priority_level", 0
            )
            or 0,
            rate_resources=resources,
            rate_priority=limiter.get("priority", 0),
        )

    @property
    def levels(self) -> int:
        """Number of queue levels actually maintained (>= 1)."""
        return max(1, self.priority_levels)

    def priority_of(self, parameters: Dict[str, Any]) -> int:
        """Effective queue level for a request's parameters (1 = highest).

        Out-of-range values clamp to the nearest level; missing/zero
        falls to ``default_priority_level``, else the lowest level.
        """
        levels = self.levels
        try:
            priority = int(parameters.get("priority", 0) or 0)
        except (TypeError, ValueError):
            priority = 0
        if priority <= 0:
            priority = self.default_priority_level or levels
        return min(max(1, priority), levels)

    def timeout_us_of(self, parameters: Dict[str, Any]) -> int:
        """Effective queue timeout in microseconds (0 = none)."""
        timeout_us = 0
        if self.allow_timeout_override:
            raw = parameters.get("timeout", parameters.get("timeout_us", 0))
            try:
                timeout_us = int(raw or 0)
            except (TypeError, ValueError):
                timeout_us = 0
        if timeout_us <= 0:
            timeout_us = self.default_timeout_us
        return max(0, timeout_us)

    def deadline_ns(
        self, parameters: Dict[str, Any], arrival_ns: int
    ) -> Optional[int]:
        timeout_us = self.timeout_us_of(parameters)
        if not timeout_us:
            return None
        return arrival_ns + timeout_us * 1000

    def stamp(self, request, arrival_ns: int) -> None:
        """Resolve and attach the request's scheduling fields
        (``priority_level``, ``deadline_ns``) once, at admission."""
        request.priority_level = self.priority_of(request.parameters)
        request.deadline_ns = self.deadline_ns(request.parameters, arrival_ns)

    @property
    def enabled(self) -> bool:
        """True when the MODEL configures admission behavior. A request
        may still opt in via its own ``timeout`` parameter on an
        unconfigured model (``allow_timeout_override`` defaults True), so
        ``ServerCore._admit_single`` skips stamping and the gate only
        when the policy is disabled AND the request carries no
        parameters at all."""
        return bool(
            self.max_queue_size
            or self.default_timeout_us
            or self.priority_levels
            or self.rate_resources
        )


class _Ticket:
    """One admitted request's handle on an :class:`AdmissionGate`.

    ``started()`` moves the request out of the waiting room (idempotent,
    thread-safe: the executor thread marks it when execution begins and
    the owning coroutine's ``finally`` closes it as a safety net — a
    request cancelled before its executor slot ran must not leak the
    waiting count)."""

    __slots__ = ("_gate", "_open")

    def __init__(self, gate: "AdmissionGate"):
        self._gate = gate
        self._open = True

    def started(self) -> None:
        gate = self._gate
        with gate._lock:
            if self._open:
                self._open = False
                gate.waiting -= 1

    close = started  # alias: `finally: ticket.close()` reads better


class AdmissionGate:
    """Waiting-room bound for execution paths without an explicit queue.

    The single, direct, and decoupled paths have no scheduler queue — a
    request "queues" in the thread-pool executor (or the pump thread's
    batch grouping). This gate bounds how many admitted requests may be
    waiting to start executing: ``enter()`` rejects with
    :class:`QueueFullError` once ``max_queue_size`` requests are waiting,
    and returns a ticket whose ``started()`` releases the slot when
    execution begins. Requests actively executing never count against
    the bound (matching the batcher, whose in-flight batch is outside
    its queue)."""

    __slots__ = ("policy", "_lock", "waiting")

    def __init__(self, policy: QueuePolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self.waiting = 0

    def enter(self, model_name: str) -> _Ticket:
        max_size = self.policy.max_queue_size
        with self._lock:
            if max_size and self.waiting >= max_size:
                raise QueueFullError(model_name, max_size)
            self.waiting += 1
        return _Ticket(self)

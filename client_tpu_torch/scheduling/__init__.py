"""Admission errors, queue policies and the waiting-room queue.

Own copies of what the serving engine and the dynamic batcher use from
``client_tpu.scheduling``: the admission-rejection errors and the
per-model :class:`QueuePolicy` (``policy.py``), and the multi-level
priority queue with deadline expiry (``queue.py``, reject-on-expiry
only). No wall-clock reads: callers pass "now" and arrival times in.
"""

from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "SCHEDULING_PARAM_KEYS",
    "TIMEOUT_ACTION_REJECT",
    "PriorityQueue",
    "QueueFullError",
    "QueueItem",
    "QueuePolicy",
    "QueueTimeoutError",
    "SchedulingError",
]

# Request parameters that carry scheduling intent ("priority", and the
# queue timeout in microseconds as "timeout"/"timeout_us"). They are
# consumed by admission and MUST be excluded from batch-compatibility
# signatures: two same-shape requests that differ only in them still
# share a device execution.
SCHEDULING_PARAM_KEYS = frozenset({"priority", "timeout", "timeout_us"})

# What happens to a request whose queue deadline passes before execution:
# it fails with a deadline error (Triton TIMEOUT_ACTION REJECT). The
# reference's "continue" (DELAY) action is not ported.
TIMEOUT_ACTION_REJECT = "reject"


class SchedulingError(InferenceServerException):
    """Base class for admission-control rejections.

    Carries both wire faces so each front-end can map it without parsing
    messages: ``http_status`` (+ optional ``retry_after_s`` rendered as a
    ``Retry-After`` header) and ``grpc_code`` (a grpc.StatusCode name,
    also the exception's ``status()``).
    """

    http_status = 503
    grpc_code = "UNAVAILABLE"
    reason = "scheduling"

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg, status=self.grpc_code)
        self.retry_after_s = retry_after_s


class QueueFullError(SchedulingError):
    """The model's waiting room is at its bound."""

    http_status = 429
    grpc_code = "RESOURCE_EXHAUSTED"
    reason = "queue_full"

    def __init__(self, model_name: str, max_queue_size: int,
                 retry_after_s: float = 1.0):
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
    """Per-model admission configuration, resolved once per model.

    ``priority_levels`` N declares levels ``1..N`` (1 = highest, as in
    Triton). Requests that carry no ``priority`` parameter land on
    ``default_priority_level`` when set, else on the LOWEST level.
    ``max_queue_size`` 0 disables the bound; ``default_timeout_us`` 0
    disables the default deadline.
    """

    __slots__ = (
        "max_queue_size",
        "default_timeout_us",
        "timeout_action",
        "allow_timeout_override",
        "priority_levels",
        "default_priority_level",
    )

    def __init__(
        self,
        max_queue_size: int = 0,
        default_timeout_us: int = 0,
        timeout_action: str = TIMEOUT_ACTION_REJECT,
        allow_timeout_override: bool = True,
        priority_levels: int = 0,
        default_priority_level: int = 0,
    ):
        if timeout_action != TIMEOUT_ACTION_REJECT:
            raise ValueError(
                f"timeout_action must be {TIMEOUT_ACTION_REJECT!r}, got "
                f"{timeout_action!r}"
            )
        self.max_queue_size = max(0, int(max_queue_size))
        self.default_timeout_us = max(0, int(default_timeout_us))
        self.timeout_action = timeout_action
        self.allow_timeout_override = bool(allow_timeout_override)
        self.priority_levels = max(0, int(priority_levels))
        self.default_priority_level = max(0, int(default_priority_level))

    @classmethod
    def from_model(cls, model) -> "QueuePolicy":
        """Resolve a model's scheduling declarations (all optional)."""
        declared = getattr(model, "queue_policy", None) or {}
        return cls(
            max_queue_size=declared.get("max_queue_size", 0),
            default_timeout_us=declared.get("default_timeout_us", 0),
            timeout_action=declared.get("timeout_action", TIMEOUT_ACTION_REJECT),
            allow_timeout_override=declared.get("allow_timeout_override", True),
            priority_levels=getattr(model, "priority_levels", 0) or 0,
            default_priority_level=getattr(model, "default_priority_level", 0) or 0,
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

    def deadline_ns(self, parameters: Dict[str, Any], arrival_ns: int) -> Optional[int]:
        timeout_us = self.timeout_us_of(parameters)
        if not timeout_us:
            return None
        return arrival_ns + timeout_us * 1000

    def stamp(self, request, arrival_ns: int) -> None:
        """Resolve and attach the request's scheduling fields
        (``priority_level``, ``deadline_ns``) once, at admission."""
        request.priority_level = self.priority_of(request.parameters)
        request.deadline_ns = self.deadline_ns(request.parameters, arrival_ns)


class QueueItem:
    """One queued entry (the queue owns the wrapper, callers the value)."""

    __slots__ = ("value", "level", "seq", "deadline_ns")

    def __init__(self, value, level, seq, deadline_ns):
        self.value = value
        self.level = level
        self.seq = seq
        self.deadline_ns = deadline_ns


class PriorityQueue:
    """Stable multi-level FIFO (level 1 = highest), consumed in (level,
    arrival) order through :meth:`scan` + :meth:`remove`. Not thread-safe:
    single-loop use."""

    def __init__(self, levels: int = 1):
        self._levels: List[deque] = [deque() for _ in range(max(1, levels))]
        self._seq = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def push(self, value: Any, level: int = 1,
             deadline_ns: Optional[int] = None) -> QueueItem:
        """Enqueue at ``level`` (clamped to the configured range)."""
        index = min(max(1, level), len(self._levels)) - 1
        self._seq += 1
        item = QueueItem(value, index + 1, self._seq, deadline_ns)
        self._levels[index].append(item)
        self._size += 1
        return item

    def scan(self) -> List[QueueItem]:
        """All queued items in consumption order."""
        out: List[QueueItem] = []
        for lane in self._levels:
            out.extend(lane)
        return out

    def remove(self, items: Iterable[QueueItem]) -> None:
        """Remove specific items (identity comparison)."""
        drop = set(map(id, items))
        if not drop:
            return
        for i, lane in enumerate(self._levels):
            if any(id(item) in drop for item in lane):
                self._levels[i] = deque(
                    item for item in lane if id(item) not in drop
                )
        self._size = sum(map(len, self._levels))

    def expire(self, now_ns: int) -> List[QueueItem]:
        """Remove and return the items whose deadline passed by
        ``now_ns`` (the caller fails their requests)."""
        expired: List[QueueItem] = []
        for i, lane in enumerate(self._levels):
            late = [
                item for item in lane
                if item.deadline_ns is not None and now_ns > item.deadline_ns
            ]
            if late:
                self._levels[i] = deque(item for item in lane if item not in late)
                expired.extend(late)
        self._size -= len(expired)
        return expired

"""Admission errors and the engine's waiting-room queue.

Own copies of what the serving engine uses from ``client_tpu.scheduling``:
the admission-rejection errors (``policy.py``) and the multi-level
priority queue with deadline expiry (``queue.py``, reject-on-expiry only).
No wall-clock reads: ``expire`` takes "now" from the caller.
"""

from collections import deque
from typing import Any, Iterable, List, Optional

from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "PriorityQueue",
    "QueueFullError",
    "QueueItem",
    "QueueTimeoutError",
    "SchedulingError",
]


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

"""Multi-level priority queue with deadline expiry.

The port's own copy of ``client_tpu/scheduling/queue.py``. Backs
``_ModelBatcher.pending`` and the LLM engine's waiting queue: entries
live on one of ``levels`` FIFO deques (level 1 = highest priority) and
are consumed in (level, arrival) order, so scheduling is a stable
priority sort. A timed-out entry is
either removed and returned by :meth:`expire` (``timeout_action
"reject"``) or demoted to a trailing lane served only when every live
level is empty (``"continue"`` — Triton's DELAY semantics).

The batcher's take path needs an ordered scan with selective removal
(batch-compatibility may skip entries), so the consuming API is
:meth:`scan` + :meth:`remove` rather than a pop: scan cost is O(queued)
per batch, bounded by ``max_queue_size``. No wall-clock reads —
``expire`` takes "now" from the caller.
"""

from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from client_tpu_torch.scheduling.policy import (
    TIMEOUT_ACTION_CONTINUE,
    TIMEOUT_ACTION_REJECT,
)


class QueueItem:
    """One queued entry (the queue owns the wrapper, callers the value)."""

    __slots__ = ("value", "level", "seq", "deadline_ns", "timeout_action", "demoted")

    def __init__(self, value, level, seq, deadline_ns, timeout_action):
        self.value = value
        self.level = level
        self.seq = seq
        self.deadline_ns = deadline_ns
        self.timeout_action = timeout_action
        self.demoted = False


class PriorityQueue:
    """Stable multi-level FIFO; NOT thread-safe (single-loop batcher use)."""

    def __init__(self, levels: int = 1):
        self._levels: List[deque] = [deque() for _ in range(max(1, levels))]
        self._delayed: deque = deque()  # timed-out "continue" entries
        self._seq = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def push(
        self,
        value: Any,
        level: int = 1,
        deadline_ns: Optional[int] = None,
        timeout_action: str = TIMEOUT_ACTION_REJECT,
    ) -> QueueItem:
        """Enqueue at ``level`` (clamped to the configured range)."""
        index = min(max(1, level), len(self._levels)) - 1
        self._seq += 1
        item = QueueItem(
            value, index + 1, self._seq, deadline_ns, timeout_action
        )
        self._levels[index].append(item)
        self._size += 1
        return item

    def scan(self) -> List[QueueItem]:
        """All queued items in consumption order: level 1..N FIFO, then
        the demoted (timed-out "continue") lane."""
        out: List[QueueItem] = []
        for lane in self._levels:
            out.extend(lane)
        out.extend(self._delayed)
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
        if any(id(item) in drop for item in self._delayed):
            self._delayed = deque(
                item for item in self._delayed if id(item) not in drop
            )
        self._size = sum(map(len, self._levels)) + len(self._delayed)

    def expire(self, now_ns: int) -> List[QueueItem]:
        """Apply deadline expiry as of ``now_ns``.

        Returns the items whose action is ``"reject"`` (removed from the
        queue; the caller fails their requests). ``"continue"`` items are
        demoted in place to the trailing lane and not returned; their
        deadline is cleared so they expire only once.
        """
        rejected: List[QueueItem] = []
        for i, lane in enumerate(self._levels):
            expired = [
                item
                for item in lane
                if item.deadline_ns is not None and now_ns > item.deadline_ns
            ]
            if not expired:
                continue
            keep = deque(
                item
                for item in lane
                if item.deadline_ns is None or now_ns <= item.deadline_ns
            )
            self._levels[i] = keep
            for item in expired:
                if item.timeout_action == TIMEOUT_ACTION_CONTINUE:
                    item.demoted = True
                    item.deadline_ns = None
                    self._delayed.append(item)
                else:
                    rejected.append(item)
        if rejected:
            self._size -= len(rejected)
        return rejected

    def depths(self) -> Dict[int, int]:
        """Queued entries per level (demoted entries count under their
        original level)."""
        depths = {i + 1: len(lane) for i, lane in enumerate(self._levels)}
        for item in self._delayed:
            depths[item.level] = depths.get(item.level, 0) + 1
        return depths

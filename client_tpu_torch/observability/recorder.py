"""Request flight recorder: per-request exemplars of recent server work.

The port's own copy of ``client_tpu/observability/recorder.py``.

Aggregate histograms (``/metrics``) answer "how slow is the service";
they cannot answer "WHICH request was slow, and where did its time go".
The flight recorder keeps that evidence: a fixed-size ring of
completed-request exemplars — model, request id, trace id, status,
per-stage wall timings (queue/compute/package, the same stage boundaries
the statistics extension books), error text — plus two reserved
sub-buffers that survive ring churn under load:

``errors``
    The most recent failed/rejected requests, so a rare failure is still
    retrievable after thousands of successes rolled the main ring.
``slowest``
    The highest-latency requests seen since the last clear (a min-heap on
    total latency), so tail exemplars survive any amount of fast traffic.

Exposed as ``GET /v2/debug/requests``; the perf harness's
``--dump-slow-requests N`` prints the slowest sub-buffer stage-decomposed
at the end of a run. Recording is a dict build + one lock + a deque
append (+ a heap op when the request makes the slow cut) — cheap enough
to stay on by default (measured in PERF.md).

Thread-safe: exemplars arrive from the event loop, the native front-end's
pump thread, and executor threads. Clock-injectable (wall timestamps
only; durations are computed by the caller from its own monotonic reads).
"""

import heapq
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["FlightRecorder"]

STATUS_OK = "ok"
STATUS_ERROR = "error"
STATUS_REJECTED = "rejected"


class FlightRecorder:
    """Fixed-size ring of request exemplars + error/slowest sub-buffers."""

    def __init__(
        self,
        capacity: int = 256,
        error_capacity: int = 64,
        slow_capacity: int = 32,
        clock: Callable[[], float] = time.time,
    ):
        self.capacity = int(capacity)
        self.error_capacity = int(error_capacity)
        self.slow_capacity = int(slow_capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=max(1, self.capacity))
        self._errors: deque = deque(maxlen=max(1, self.error_capacity))
        # min-heap of (total_us, seq, exemplar): the root is the fastest
        # of the slow set, evicted first
        self._slow: List[Any] = []
        self._seq = 0
        self.recorded_total = 0
        self.error_total = 0
        self.rejected_total = 0

    def record(
        self,
        model: str,
        request_id: str = "",
        trace_id: str = "",
        status: str = STATUS_OK,
        error: str = "",
        path: str = "",
        queue_us: float = 0.0,
        compute_us: float = 0.0,
        package_us: float = 0.0,
        total_us: float = 0.0,
        rows: int = 1,
        priority: int = 0,
        responses: Optional[int] = None,
    ) -> None:
        """Record one completed (or rejected) request. Hot path: keep it
        allocation-light; the exemplar dict IS the wire shape
        ``/v2/debug/requests`` returns."""
        if self.capacity <= 0:
            return
        exemplar: Dict[str, Any] = {
            "ts": self._clock(),
            "model": model,
            "request_id": request_id,
            "trace_id": trace_id,
            "status": status,
            "path": path,
            "total_us": round(total_us, 1),
            "stages": {
                "queue_us": round(queue_us, 1),
                "compute_us": round(compute_us, 1),
                "package_us": round(package_us, 1),
            },
        }
        if error:
            exemplar["error"] = error
        if rows != 1:
            exemplar["rows"] = rows
        if priority:
            exemplar["priority"] = priority
        if responses is not None:
            exemplar["responses"] = responses
        with self._lock:
            self._seq += 1
            self.recorded_total += 1
            self._recent.append(exemplar)
            if status != STATUS_OK:
                if status == STATUS_REJECTED:
                    self.rejected_total += 1
                else:
                    self.error_total += 1
                self._errors.append(exemplar)
            if self.slow_capacity > 0:
                entry = (total_us, self._seq, exemplar)
                if len(self._slow) < self.slow_capacity:
                    heapq.heappush(self._slow, entry)
                elif total_us > self._slow[0][0]:
                    heapq.heapreplace(self._slow, entry)

    # -- introspection -------------------------------------------------------

    def snapshot(
        self, model: Optional[str] = None, limit: Optional[int] = None
    ) -> Dict[str, Any]:
        """One consistent view: recent and errors newest-first, slowest
        by descending total latency; optional per-model filter and
        per-section entry cap."""
        with self._lock:
            recent = list(self._recent)
            errors = list(self._errors)
            slow = sorted(self._slow, key=lambda e: e[0], reverse=True)
            counts = {
                "recorded_total": self.recorded_total,
                "error_total": self.error_total,
                "rejected_total": self.rejected_total,
            }
        recent.reverse()
        errors.reverse()
        slowest = [entry[2] for entry in slow]
        if model:
            recent = [e for e in recent if e["model"] == model]
            errors = [e for e in errors if e["model"] == model]
            slowest = [e for e in slowest if e["model"] == model]
        if limit is not None and limit >= 0:
            recent = recent[:limit]
            errors = errors[:limit]
            slowest = slowest[:limit]
        return {
            "recent": recent,
            "errors": errors,
            "slowest": slowest,
            **counts,
            "capacity": {
                "recent": self.capacity,
                "errors": self.error_capacity,
                "slowest": self.slow_capacity,
            },
        }

    def stats(self) -> Dict[str, int]:
        """Counters only (cheap; the /v2/debug/state summary)."""
        with self._lock:
            return {
                "recorded_total": self.recorded_total,
                "error_total": self.error_total,
                "rejected_total": self.rejected_total,
                "recent": len(self._recent),
                "errors": len(self._errors),
                "slowest": len(self._slow),
            }

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._errors.clear()
            self._slow.clear()

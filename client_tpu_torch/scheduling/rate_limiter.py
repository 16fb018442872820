"""Resource-pool rate limiter (ModelRateLimiter semantics).

The port's own copy of ``client_tpu/scheduling/rate_limiter.py``.

Models may declare resource demands (``rate_limiter = {"resources":
[{"name": "accel_slot", "count": 1}], "priority": 1}``); the server core
acquires those resources around every device execution, so models sharing
a pool serialize instead of oversubscribing the device. Pool capacity
defaults to the maximum any model demands (the reference's behavior when
no explicit resource counts are configured server-side) and can be pinned
with :meth:`set_capacity`.

Waiters are granted strictly in (priority, arrival) order — priority 0 is
highest, matching ModelRateLimiter priority semantics — from whichever
thread calls :meth:`release`; asyncio waiters are woken through their own
loop. No wall-clock reads (blocking waits take their timeout from the
caller), so the limiter is fake-clock friendly by construction.
"""

import asyncio
import threading
from typing import Dict, List, Optional


class _Waiter:
    __slots__ = ("resources", "priority", "seq", "granted", "_event", "_loop", "_future")

    def __init__(self, resources, priority, seq, loop=None, future=None):
        self.resources = resources
        self.priority = priority
        self.seq = seq
        self.granted = False
        self._event = threading.Event() if loop is None else None
        self._loop = loop
        self._future = future

    def wake(self) -> None:
        if self._event is not None:
            self._event.set()
        else:
            def _set(future=self._future):
                if not future.done():
                    future.set_result(True)

            self._loop.call_soon_threadsafe(_set)

    def wait_blocking(self, timeout_s: Optional[float]) -> bool:
        return self._event.wait(timeout_s)


class RateLimiter:
    """Named resource pools guarding device executions. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._capacity: Dict[str, int] = {}
        self._used: Dict[str, int] = {}
        self._waiters: List[_Waiter] = []
        self._seq = 0

    # -- capacity ------------------------------------------------------------

    def register(self, resources: Dict[str, int]) -> None:
        """Grow pool capacities to cover a model's demand (capacity is
        the max demanded by any registered model unless pinned)."""
        with self._lock:
            for name, count in resources.items():
                self._capacity[name] = max(
                    self._capacity.get(name, 0), int(count)
                )

    def set_capacity(self, name: str, count: int) -> None:
        """Pin a pool's capacity explicitly (operator override)."""
        with self._lock:
            self._capacity[name] = int(count)
        self._grant_waiters()

    def available(self, name: str) -> int:
        with self._lock:
            return self._capacity.get(name, 0) - self._used.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-pool occupancy under one lock: capacity, grants in use,
        and parked waiters (``/v2/debug/state`` building block)."""
        with self._lock:
            waiting: Dict[str, int] = {}
            for waiter in self._waiters:
                for name in waiter.resources:
                    waiting[name] = waiting.get(name, 0) + 1
            return {
                name: {
                    "capacity": capacity,
                    "used": self._used.get(name, 0),
                    "waiters": waiting.get(name, 0),
                }
                for name, capacity in self._capacity.items()
            }

    # -- acquisition ---------------------------------------------------------

    def _fits_locked(self, resources: Dict[str, int]) -> bool:
        for name, count in resources.items():
            if (
                self._used.get(name, 0) + count
                > self._capacity.get(name, 0)
            ):
                return False
        return True

    def _take_locked(self, resources: Dict[str, int]) -> None:
        for name, count in resources.items():
            self._used[name] = self._used.get(name, 0) + count

    def release(self, resources: Dict[str, int]) -> None:
        with self._lock:
            for name, count in resources.items():
                self._used[name] = max(0, self._used.get(name, 0) - count)
        self._grant_waiters()

    def _grant_waiters(self) -> None:
        granted: List[_Waiter] = []
        with self._lock:
            # strict (priority, arrival) order: a waiter that does not
            # fit blocks everyone behind it — no starvation of large
            # demands by a stream of small ones
            self._waiters.sort(key=lambda w: (w.priority, w.seq))
            while self._waiters and self._fits_locked(
                self._waiters[0].resources
            ):
                waiter = self._waiters.pop(0)
                self._take_locked(waiter.resources)
                waiter.granted = True
                granted.append(waiter)
        for waiter in granted:
            waiter.wake()

    def _enqueue(self, resources, priority, loop=None, future=None):
        self._seq += 1
        waiter = _Waiter(resources, priority, self._seq, loop, future)
        self._waiters.append(waiter)
        return waiter

    def _abandon(self, waiter: _Waiter) -> bool:
        """Back out of a wait; returns True when the waiter had already
        been granted (the caller then owns — and must release — the
        resources)."""
        with self._lock:
            if waiter.granted:
                return True
            try:
                self._waiters.remove(waiter)
            except ValueError:
                pass
            return False

    async def acquire(
        self, resources: Dict[str, int], priority: int = 0
    ) -> None:
        """Await the resources (asyncio path; the event-loop batcher)."""
        loop = asyncio.get_running_loop()
        with self._lock:
            if not self._waiters and self._fits_locked(resources):
                self._take_locked(resources)
                return
            future = loop.create_future()
            waiter = self._enqueue(resources, priority, loop, future)
        try:
            await future
        except asyncio.CancelledError:
            if self._abandon(waiter):
                self.release(resources)
            raise

    def acquire_blocking(
        self,
        resources: Dict[str, int],
        priority: int = 0,
        timeout_s: Optional[float] = None,
    ) -> bool:
        """Blocking twin for the synchronous direct path; returns False
        when ``timeout_s`` elapses without a grant."""
        with self._lock:
            if not self._waiters and self._fits_locked(resources):
                self._take_locked(resources)
                return True
            waiter = self._enqueue(resources, priority)
        if waiter.wait_blocking(timeout_s):
            return True
        if self._abandon(waiter):
            # the grant raced the timeout: we own the resources after all
            return True
        return False

"""Server-side drain state machine.

The port's own copy of ``client_tpu/lifecycle/drain.py``.

A serving process dies gracefully in three steps (the pattern the
reference Triton stack's readiness/liveness split exists to support):

1. SERVING -> DRAINING: readiness goes false (``/v2/health/ready``, gRPC
   ``ServerReady``) while liveness stays true, so load balancers and
   :class:`~client_tpu_torch.lifecycle.EndpointPool` clients stop sending new
   work; new inference requests are rejected with a clean
   503 + ``Retry-After`` / gRPC ``UNAVAILABLE``.
2. In-flight and queued work finishes, up to a configurable drain
   deadline. The controller tracks every admitted request (all four
   ServerCore execution paths), globally and per model, so the drain can
   actually *wait* instead of cancelling futures.
3. DRAINING -> STOPPED: front-ends close. Anything still queued past the
   deadline fails with the same clean unavailability error — never a
   cancelled-future traceback.

No wall-clock reads happen in this module directly: the clock and async
sleep are injectable, so drain-deadline tests run on fake clocks.
"""

import asyncio
import threading
import time
from typing import Callable, Dict, Optional

from client_tpu_torch.scheduling import SchedulingError

SERVING = "serving"
DRAINING = "draining"
STOPPED = "stopped"
# Not a DrainController state: ServerCore overlays it on the
# tpu_server_state gauge while an engine reloads itself (the recovery
# layer, llm/recovery.py) — the lifecycle itself stays SERVING.
RECOVERING = "recovering"

# tpu_server_state gauge encoding (monotone along the lifecycle;
# RECOVERING sits outside the monotone drain arc)
STATE_VALUES = {SERVING: 0, DRAINING: 1, STOPPED: 2, RECOVERING: 3}


class ServerDrainingError(SchedulingError):
    """Raised for requests arriving while the server is draining/stopped.

    A :class:`~client_tpu_torch.scheduling.SchedulingError` so every wire face
    is already handled: HTTP maps ``http_status``/``retry_after_s`` to a
    503 + ``Retry-After`` response, gRPC maps ``grpc_code`` to
    ``UNAVAILABLE``, and the statistics paths skip double-booking. The
    client resilience layer classifies both faces as retryable, so a
    retry-configured client (or an EndpointPool) rides through a drain.
    """

    http_status = 503
    grpc_code = "UNAVAILABLE"
    reason = "draining"

    def __init__(self, state: str = DRAINING, retry_after_s: float = 1.0):
        super().__init__(
            f"server is {state} and not accepting new inference requests",
            retry_after_s=retry_after_s,
        )


class DrainController:
    """Explicit SERVING -> DRAINING -> STOPPED lifecycle + in-flight census.

    Thread-safe: the admission sites span the event loop (HTTP/grpc.aio
    paths), the native front-end's pump thread (``infer_direct``), and
    executor threads, so the counters live behind a lock.

    ``retry_after_s`` is the backoff hint stamped on drain rejections
    (how long a client without an alternative endpoint should wait before
    retrying — roughly the expected restart time).
    """

    def __init__(
        self,
        retry_after_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        async_sleep: Callable[[float], "asyncio.Future"] = asyncio.sleep,
    ):
        self.retry_after_s = retry_after_s
        self._clock = clock
        self._async_sleep = async_sleep
        self._lock = threading.Lock()
        self._state = SERVING
        self._inflight_total = 0
        self._inflight_by_model: Dict[str, int] = {}
        # drain rejections issued by this controller (observability; the
        # Prometheus counter is booked by the server core)
        self.rejected_total = 0

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def accepting(self) -> bool:
        """True while new inference requests are admitted."""
        with self._lock:
            return self._state == SERVING

    def begin_drain(self) -> None:
        """Stop accepting new work; in-flight work keeps running.

        Idempotent; a STOPPED controller stays stopped."""
        with self._lock:
            if self._state == SERVING:
                self._state = DRAINING

    def resume(self) -> None:
        """Abort a drain (DRAINING -> SERVING). No-op once STOPPED."""
        with self._lock:
            if self._state == DRAINING:
                self._state = SERVING

    def mark_stopped(self) -> None:
        with self._lock:
            self._state = STOPPED

    # -- in-flight census ----------------------------------------------------

    def check(self) -> None:
        """Raise :class:`ServerDrainingError` when not accepting, without
        touching the census (front-end fast paths; the real admission
        happens in :meth:`admit`)."""
        with self._lock:
            if self._state != SERVING:
                self.rejected_total += 1
                raise ServerDrainingError(
                    self._state, retry_after_s=self.retry_after_s
                )

    def admit(self, model_name: str = "") -> None:
        """Gate + count one request. Raises :class:`ServerDrainingError`
        the moment draining starts; otherwise the request is tracked until
        :meth:`finish`."""
        with self._lock:
            if self._state != SERVING:
                self.rejected_total += 1
                raise ServerDrainingError(
                    self._state, retry_after_s=self.retry_after_s
                )
            self._inflight_total += 1
            if model_name:
                self._inflight_by_model[model_name] = (
                    self._inflight_by_model.get(model_name, 0) + 1
                )

    def finish(self, model_name: str = "") -> None:
        """Mark one admitted request complete (success or failure)."""
        with self._lock:
            if self._inflight_total > 0:
                self._inflight_total -= 1
            if model_name:
                count = self._inflight_by_model.get(model_name, 0)
                if count <= 1:
                    self._inflight_by_model.pop(model_name, None)
                else:
                    self._inflight_by_model[model_name] = count - 1

    def snapshot(self) -> Dict[str, object]:
        """One consistent view of the census (state, totals, per-model
        in-flight counts) under a single lock acquisition — the
        ``/v2/debug/state`` building block."""
        with self._lock:
            return {
                "state": self._state,
                "accepting": self._state == SERVING,
                "inflight_total": self._inflight_total,
                "inflight_by_model": dict(self._inflight_by_model),
                "rejected_total": self.rejected_total,
            }

    def inflight(self, model_name: Optional[str] = None) -> int:
        with self._lock:
            if model_name is None:
                return self._inflight_total
            return self._inflight_by_model.get(model_name, 0)

    async def wait_idle(
        self,
        timeout_s: Optional[float] = None,
        model_name: Optional[str] = None,
        poll_s: float = 0.005,
    ) -> bool:
        """Wait until in-flight work (optionally one model's) reaches
        zero; returns False when ``timeout_s`` expires first."""
        deadline = (
            None if timeout_s is None else self._clock() + timeout_s
        )
        while self.inflight(model_name) > 0:
            if deadline is not None and self._clock() >= deadline:
                return False
            await self._async_sleep(poll_s)
        return True

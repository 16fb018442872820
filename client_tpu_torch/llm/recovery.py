"""Engine auto-recovery: bounded-retry background reload after a fatal.

An own copy of ``client_tpu/llm/recovery.py``, tier 1 of the
self-healing stack (the pod supervisor, ``pod/supervisor.py``, and the
fleet runner's replacement of a replica sit above it). An engine-fatal device failure marks the engine
closed-until-reload — clean retryable errors, but someone has to call
``warmup()``. :class:`EngineRecovery` closes that loop: it hangs off
:attr:`LlmEngine.on_fatal`, and when the engine quarantines itself the
controller

1. takes custody of the quarantined *survivors* (sequences that opted
   into ``recovery: resume`` — their consumers stay parked on their
   token queues, nothing has been failed),
2. runs ``model.reload()`` on a background thread with bounded retries —
   a full :meth:`LlmEngineModel.warmup`: fresh KV pool, re-probed
   kernels, a brand-new :class:`LlmEngine`,
3. re-binds the server core and hands the survivors to
   :meth:`LlmEngine.adopt` on the replacement via the serving loop. A
   survivor re-prefills its full context (prompt + tokens already
   streamed) and resumes on the same ``(seed, token-index)`` chain, so
   the recovered stream is token-identical to an uninterrupted one.

While the reload is in flight, submits against the quarantined engine
raise :class:`~client_tpu_torch.llm.engine.EngineRecoveringError` — 503 +
``Retry-After`` on HTTP, UNAVAILABLE on gRPC — and the model reports
``recovering`` through ``debug_state()`` / ``tpu_server_state``. If
every attempt fails, the survivors fail UNAVAILABLE and the model stays
closed, with the outcome booked either way to
``tpu_recovery_total{tier="engine"}`` and ``tpu_recovery_seconds``. A
sticky CUDA fault (an illegal address, a device-side assert) poisons the
process's CUDA context, so every reload attempt fails and the bounded
retries end in FAILED: the process is left to a higher tier.

Clock discipline: wall reads go through the injected ``clock``/``sleep``,
so the retry/backoff machine is testable on fake clocks.
"""

import asyncio
import threading
import time
from typing import Any, Callable, List, Optional

from client_tpu_torch.utils import InferenceServerException

#: controller states (reported via model.recovering / debug_state)
IDLE = "idle"
RECOVERING = "recovering"
READY = "ready"
FAILED = "failed"


class EngineRecovery:
    """Supervises one :class:`LlmEngineModel`'s engine-fatal reloads.

    One controller per model instance, surviving engine swaps: warmup
    re-attaches it to each replacement engine, so a second fatal after a
    successful recovery starts a second recovery (``max_attempts``
    bounds the retries *within* one recovery, not recoveries over the
    model's lifetime — persistent flapping surfaces in the
    ``tpu_recovery_total`` counter, which is the alert surface).
    """

    def __init__(
        self,
        model: Any,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        retry_after_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.model = model
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.retry_after_s = float(retry_after_s)
        self._clock = clock
        self._sleep = sleep
        self.state = IDLE
        self.recoveries = 0
        self.failures = 0
        self.last_duration_s: Optional[float] = None
        self.last_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def attach(self, engine: Any) -> None:
        """Wire this controller onto an engine (called by warmup for the
        initial engine and by the controller itself for each
        replacement)."""
        engine.on_fatal = self._on_fatal
        engine.retry_after_s = self.retry_after_s

    # -- serving-loop side ---------------------------------------------------

    def _on_fatal(self, exc: BaseException) -> None:
        """The engine's quarantine hook — runs on the serving loop with
        the engine already closed and its survivors parked. Captures
        everything the background thread needs and returns immediately
        (the loop must keep draining the 503s)."""
        engine = self.model.engine
        survivors = engine.detach_survivors()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # quarantined outside any loop (engine never served): there
            # is no loop to adopt onto, but an empty survivor set needs
            # none — a non-empty one fails below at adoption time
            loop = None
        self.state = RECOVERING
        # kept without its traceback: the failed step's frames hold its
        # device tensors, which would stay allocated beside the new pool
        self.last_error = exc.with_traceback(None)
        started = self._clock()
        self._thread = threading.Thread(
            target=self._reload_loop,
            args=(engine, loop, survivors, started),
            name=f"llm-recovery-{self.model.name}",
            daemon=True,
        )
        self._thread.start()

    # -- background thread ---------------------------------------------------

    def _reload_loop(
        self,
        old_engine: Any,
        loop: Optional[asyncio.AbstractEventLoop],
        survivors: List[Any],
        started: float,
    ) -> None:
        logger = getattr(old_engine, "logger", None)
        metrics = getattr(old_engine, "metrics", None)
        core = self.model._core
        error: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                self.model.reload()
                break
            except Exception as e:  # noqa: BLE001 - retry up to the bound
                if logger is not None:
                    logger.error(
                        "llm_engine_recovery_attempt_failed",
                        model=self.model.name, attempt=attempt, exc=e,
                    )
                # kept without its traceback, whose frames would pin what
                # the failed attempt allocated through the next attempt
                error = e.with_traceback(None)
                self._sleep(self.backoff_s * attempt)
        else:
            self._give_up(old_engine, loop, survivors, error, metrics, started)
            return
        duration = self._clock() - started
        new_engine = self.model.engine
        self.attach(new_engine)
        if core is not None:
            # warmup cleared _core; rebinding now restores metrics/
            # executor/logger BEFORE the survivors start decoding (a
            # later infer would rebind anyway, but adopted sequences
            # must not run their device calls inline on the loop)
            self.model.bind_core(core)
        adopted = False
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(new_engine.adopt, survivors)
                adopted = True
            except RuntimeError:
                pass  # loop closed between the check and the call
        if not adopted and survivors:
            fail = InferenceServerException(
                f"llm engine for '{self.model.name}' recovered but its "
                f"serving loop is gone; resubmit",
                status="UNAVAILABLE",
            )
            for seq in survivors:
                seq.fail(fail)
        self.state = READY
        self.recoveries += 1
        self.last_duration_s = duration
        if logger is not None:
            logger.info(
                "llm_engine_recovered", model=self.model.name,
                duration_s=round(duration, 3), survivors=len(survivors),
            )
        if metrics is not None:
            metrics.observe_recovery("engine", "success", duration)

    def _give_up(self, old_engine, loop, survivors, error, metrics,
                 started) -> None:
        """Retries exhausted: the model stays closed (manual-reload
        posture) and every parked survivor fails with the bounded-retry
        story — failing them on the serving loop when it is still alive,
        so queue puts never race a consumer."""
        duration = self._clock() - started
        fail = InferenceServerException(
            f"llm engine for '{self.model.name}' failed to recover "
            f"after {self.max_attempts} attempts: {error}",
            status="UNAVAILABLE",
        )

        def finish() -> None:
            old_engine.recovering = False
            for seq in survivors:
                seq.fail(fail)

        delivered = False
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(finish)
                delivered = True
            except RuntimeError:
                pass
        if not delivered:
            finish()
        self.state = FAILED
        self.failures += 1
        self.last_duration_s = duration
        self.last_error = error
        logger = getattr(old_engine, "logger", None)
        if logger is not None:
            logger.error(
                "llm_engine_recovery_exhausted", model=self.model.name,
                attempts=self.max_attempts, exc=error,
            )
        if metrics is not None:
            metrics.observe_recovery("engine", "failed", duration)

    # -- introspection -------------------------------------------------------

    def describe(self) -> dict:
        return {
            "state": self.state,
            "recoveries": self.recoveries,
            "failures": self.failures,
            "max_attempts": self.max_attempts,
            "last_duration_s": self.last_duration_s,
            "last_error": (
                str(self.last_error) if self.last_error is not None else None
            ),
        }

    def join(self, timeout_s: float = 30.0) -> None:
        """Test helper: wait for an in-flight reload thread."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout_s)

"""Retry, deadline, and circuit-breaker policies plus the attempt loop.

An own copy of ``client_tpu/resilience/policy.py`` (without
``http_status_is_retryable``, which no client calls).

The attempt loop comes in an async and a sync flavor with identical
semantics; both are idempotency-aware (callers mark sequence/streaming
inference non-idempotent and it is never auto-retried) and both honor a
total-time ``Deadline`` so retries never exceed the caller's timeout.

Clock, sleep, and rng are injectable on every component: chaos tests run
with a fake clock in milliseconds of wall time.
"""

import asyncio
import contextvars
import random
import threading
import time
from typing import Awaitable, Callable, FrozenSet, Optional

from client_tpu_torch.utils import InferenceServerException

# Status string carried by InferenceServerException for wrapped transport
# failures (connection refused/reset, timeouts) on any surface.
CONNECTION_ERROR_STATUS = "CONNECTION_ERROR"

# HTTP statuses worth retrying: upstream overload/restart signatures.
DEFAULT_RETRYABLE_HTTP_STATUSES: FrozenSet[int] = frozenset(
    {429, 502, 503, 504}
)
# gRPC codes worth retrying (names as in grpc.StatusCode.<NAME>).
DEFAULT_RETRYABLE_GRPC_CODES: FrozenSet[str] = frozenset(
    {"UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED"}
)

# Retries performed by the most recent resilient call in this context —
# within one asyncio task (or one thread) contextvar updates persist
# across awaits, so the perf harness reads the count right after
# ``await backend.infer(...)`` returns.
_last_retry_count: contextvars.ContextVar = contextvars.ContextVar(
    "client_tpu_last_retry_count", default=0
)

# Per-context event log of what the attempt loop did (retries taken,
# circuit-breaker trips/fast-fails). The observability tracer arms it
# before a traced call and drains it into span annotations afterwards;
# when unarmed (the default) logging is a None-check — zero cost.
_attempt_events: contextvars.ContextVar = contextvars.ContextVar(
    "client_tpu_attempt_events", default=None
)


def begin_attempt_events() -> list:
    """Arm the per-context attempt-event log; returns the live list."""
    events: list = []
    _attempt_events.set(events)
    return events


def take_attempt_events() -> list:
    """Drain and disarm the per-context attempt-event log."""
    events = _attempt_events.get()
    _attempt_events.set(None)
    return events if events is not None else []


def _note(event: str, **fields) -> None:
    log = _attempt_events.get()
    if log is not None:
        log.append({"event": event, **fields})


def sequence_is_idempotent(sequence_id) -> bool:
    """False when a request carries sequence state (``sequence_id`` set):
    sequence steps mutate server-side state and must never be
    auto-retried. One helper so every surface classifies identically."""
    return sequence_id == 0 or sequence_id == ""


def reset_retry_count() -> None:
    """Zero the per-context retry counter (call before a resilient call)."""
    _last_retry_count.set(0)


def last_retry_count() -> int:
    """Retries performed by the most recent resilient call in this context."""
    return _last_retry_count.get()


class CircuitBreakerOpenError(InferenceServerException):
    """Raised instead of attempting a request while the breaker is open."""

    def __init__(self, msg: str = "circuit breaker is open; failing fast"):
        super().__init__(msg, status="CIRCUIT_OPEN")


class RetryPolicy:
    """Capped exponential backoff with full jitter.

    Parameters
    ----------
    max_attempts:
        Total attempts including the first (``1`` disables retries).
    initial_backoff_s / max_backoff_s / backoff_multiplier:
        The attempt-``n`` backoff upper bound is
        ``min(max_backoff_s, initial_backoff_s * backoff_multiplier**n)``.
    jitter:
        With full jitter (default) each backoff is drawn uniformly from
        ``[0, bound]`` — decorrelates retry storms across clients.
    retryable_http / retryable_grpc / retry_connection_errors:
        The retryable-error classification.
    clock / sleep / async_sleep / rng:
        Injectables for tests: ``clock()`` -> monotonic seconds,
        ``sleep(s)`` blocking, ``async_sleep(s)`` awaitable.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        initial_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        backoff_multiplier: float = 2.0,
        jitter: bool = True,
        retryable_http: FrozenSet[int] = DEFAULT_RETRYABLE_HTTP_STATUSES,
        retryable_grpc: FrozenSet[str] = DEFAULT_RETRYABLE_GRPC_CODES,
        retry_connection_errors: bool = True,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        async_sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
        rng: Optional[random.Random] = None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if initial_backoff_s < 0 or max_backoff_s < 0:
            raise ValueError("backoff durations must be >= 0")
        self.max_attempts = max_attempts
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.backoff_multiplier = backoff_multiplier
        self.jitter = jitter
        self.retryable_http = frozenset(retryable_http)
        self.retryable_grpc = frozenset(retryable_grpc)
        self.retry_connection_errors = retry_connection_errors
        self.clock = clock
        self.sleep = sleep
        self.async_sleep = async_sleep
        self.rng = rng if rng is not None else random.Random()

    def backoff_bound_s(self, retries_so_far: int) -> float:
        """Deterministic upper bound for the next backoff."""
        return min(
            self.max_backoff_s,
            self.initial_backoff_s
            * self.backoff_multiplier**retries_so_far,
        )

    def backoff_s(self, retries_so_far: int) -> float:
        """The next backoff duration (full jitter unless disabled)."""
        bound = self.backoff_bound_s(retries_so_far)
        if not self.jitter:
            return bound
        return self.rng.uniform(0.0, bound)


class Deadline:
    """A total time budget shared by every attempt of one logical call."""

    def __init__(
        self, budget_s: float, clock: Callable[[], float] = time.monotonic
    ):
        self.budget_s = budget_s
        self._clock = clock
        self._start = clock()

    def elapsed_s(self) -> float:
        return self._clock() - self._start

    def remaining_s(self) -> float:
        return self.budget_s - self.elapsed_s()

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def attempt_timeout_s(self, floor_s: float = 0.001) -> float:
        """Per-attempt timeout derived from the remaining budget.

        Never exceeds what is left of the caller's total timeout; the
        floor keeps an exhausted budget from turning into "no timeout".
        """
        return max(floor_s, self.remaining_s())


class CircuitBreaker:
    """closed/open/half-open circuit breaker, safe to share across threads.

    closed: requests flow; ``failure_threshold`` consecutive failures trip
    it open. open: requests fail fast (``allow()`` is False) until
    ``cooldown_s`` elapses, then half-open. half-open: up to
    ``half_open_max_probes`` trial requests pass; one success closes the
    breaker, one failure re-opens it for another cooldown.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 5.0,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        logger=None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.half_open_max_probes = max(1, half_open_max_probes)
        self._clock = clock
        # optional StructuredLogger: state transitions emit
        # circuit_open / circuit_half_open / circuit_closed events; None
        # (the default) keeps every transition site a single None-check
        self._logger = logger
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.times_opened = 0  # observability

    def _log_transition(self, event: str, **fields) -> None:
        # lock may be held by the caller; the logger has its own lock and
        # never calls back into the breaker, so this cannot deadlock
        if self._logger is not None:
            self._logger.info(
                event, times_opened=self.times_opened, **fields
            )

    def _tick(self) -> None:
        # lock held by caller
        if (
            self._state == self.OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._state = self.HALF_OPEN
            self._probes_in_flight = 0
            self._log_transition("circuit_half_open")

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def allow(self) -> bool:
        """True if a request may be attempted right now."""
        with self._lock:
            self._tick()
            if self._state == self.CLOSED:
                return True
            if (
                self._state == self.HALF_OPEN
                and self._probes_in_flight < self.half_open_max_probes
            ):
                self._probes_in_flight += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._tick()
            if self._state == self.OPEN:
                # a request that was already in flight when the breaker
                # tripped has drained successfully; that is stale
                # evidence — stay open through the cooldown so recovery
                # goes through a half-open probe, not a flap
                return
            closed_now = self._state != self.CLOSED
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            if closed_now:
                self._log_transition("circuit_closed")

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            if self._state == self.HALF_OPEN:
                self._trip()
                return
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                self._trip()

    def record_inconclusive(self) -> None:
        """An attempt ended without saying anything about the server
        (local error, cancellation). Release the half-open probe slot it
        may have consumed — otherwise a half-open breaker whose probe got
        cancelled would wedge with every slot taken and never recover."""
        with self._lock:
            if self._state == self.HALF_OPEN and self._probes_in_flight > 0:
                self._probes_in_flight -= 1

    def _trip(self) -> None:
        # lock held by caller
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._probes_in_flight = 0
        self.times_opened += 1
        _note("circuit_tripped", times_opened=self.times_opened)
        self._log_transition("circuit_open", cooldown_s=self.cooldown_s)


# ---------------------------------------------------------------------------
# classification

# gRPC codes that mean the server answered and rejected the request —
# the caller's fault, not the server's health. CANCELLED is deliberately
# absent: a locally-cancelled RPC says nothing about the server and must
# stay inconclusive for the breaker.
_GRPC_CLIENT_FAULT_CODES = frozenset(
    {
        "INVALID_ARGUMENT",
        "NOT_FOUND",
        "ALREADY_EXISTS",
        "PERMISSION_DENIED",
        "UNAUTHENTICATED",
        "FAILED_PRECONDITION",
        "OUT_OF_RANGE",
        "UNIMPLEMENTED",
    }
)


def _status_token(status: str) -> str:
    """Normalize a status string: "StatusCode.UNAVAILABLE" -> its tail,
    numeric HTTP statuses stay as digits."""
    return status.rsplit(".", 1)[-1]


def _token_is_retryable(token: str, http_set, grpc_set) -> bool:
    if token.isdigit():
        return int(token) in http_set
    return token in grpc_set


def _token_breaker_outcome(token: str):
    """What a status token means to the breaker: True = infrastructure
    failure, False = server answered and is healthy enough to reject
    (4xx / client-fault gRPC codes), None = server-side fault that is
    not a liveness signal either way (5xx, INTERNAL, UNKNOWN, ...) —
    those must not RESET the failure count by counting as success."""
    if token.isdigit():
        code = int(token)
        if code in DEFAULT_RETRYABLE_HTTP_STATUSES:
            return True
        return False if code < 500 else None
    if token in DEFAULT_RETRYABLE_GRPC_CODES:
        return True
    return False if token in _GRPC_CLIENT_FAULT_CODES else None


def exception_is_retryable(
    exc: BaseException, policy: Optional[RetryPolicy] = None
) -> bool:
    """Classify an exception as a retryable (infrastructure) failure.

    Understands the wrapped statuses every client surface produces:
    numeric HTTP statuses ("503"), gRPC code reprs
    ("StatusCode.UNAVAILABLE"), and CONNECTION_ERROR for wrapped
    transport failures. Raw connection/timeout errors that escaped
    wrapping count as connection errors.
    """
    http_set = (
        policy.retryable_http
        if policy is not None
        else DEFAULT_RETRYABLE_HTTP_STATUSES
    )
    grpc_set = (
        policy.retryable_grpc
        if policy is not None
        else DEFAULT_RETRYABLE_GRPC_CODES
    )
    retry_conn = policy.retry_connection_errors if policy is not None else True
    if isinstance(exc, CircuitBreakerOpenError):
        return False
    if isinstance(exc, InferenceServerException):
        status = exc.status()
        if status is None:
            return False
        if status == CONNECTION_ERROR_STATUS:
            return retry_conn
        return _token_is_retryable(_status_token(status), http_set, grpc_set)
    if isinstance(
        exc, (ConnectionError, OSError, TimeoutError, asyncio.TimeoutError)
    ):
        return retry_conn
    return False


def _breaker_outcome(exc: BaseException):
    """What an exception means to the circuit breaker, independent of the
    retry policy: True = infrastructure failure (count it), False = the
    server answered and is healthy (4xx / client-fault codes), None =
    neither (local errors, cancellation, 5xx server faults — these must
    not reset the failure count). Uses the DEFAULT status sets: a policy
    that opts out of retrying connection errors must not stop the
    breaker from counting them."""
    if isinstance(exc, CircuitBreakerOpenError):
        return None
    if isinstance(exc, InferenceServerException):
        status = exc.status()
        if status is None:
            return None
        if status == CONNECTION_ERROR_STATUS:
            return True
        return _token_breaker_outcome(_status_token(status))
    if isinstance(
        exc, (ConnectionError, OSError, TimeoutError, asyncio.TimeoutError)
    ):
        return True
    return None


def _breaker_record_outcome(circuit_breaker, outcome) -> None:
    """Apply a classified outcome (True/False/None) to the breaker."""
    if circuit_breaker is None:
        return
    if outcome is True:
        circuit_breaker.record_failure()
    elif outcome is False:
        circuit_breaker.record_success()
    else:
        circuit_breaker.record_inconclusive()


def record_breaker_outcome(circuit_breaker, exc) -> None:
    """Record what ``exc`` says about server health on the breaker
    (no-op when ``circuit_breaker`` is None). Public so callback-style
    surfaces that cannot run the attempt loop can still feed it."""
    _breaker_record_outcome(circuit_breaker, _breaker_outcome(exc))


# ---------------------------------------------------------------------------
# attempt loops


def _should_retry_now(policy, idempotent, retries, retryable):
    return (
        policy is not None
        and idempotent
        and retryable
        and retries + 1 < policy.max_attempts
    )


def _backoff_within_budget(policy, deadline, retries):
    """The next backoff, or None when the deadline budget rules a retry
    out (the remaining budget could not cover the sleep plus any attempt)."""
    backoff = policy.backoff_s(retries)
    if deadline is not None and deadline.remaining_s() <= backoff:
        return None
    return backoff


def _apply_backoff_hint(backoff, hint_s, deadline):
    """Raise a drawn backoff to a server-provided floor (Retry-After on a
    429 shed response): the server knows its queue better than the
    client's jitter schedule. Returns None — no retry — when honoring the
    hint would blow the remaining deadline budget."""
    if backoff is None or not hint_s or hint_s <= backoff:
        return backoff
    if deadline is not None and deadline.remaining_s() <= hint_s:
        return None
    return hint_s


def _apply_backoff_cap(backoff, cap_s):
    """Cap a backoff from above — the failover fast path. When an attempt
    failed against an endpoint but the caller has ANOTHER endpoint to try
    (an :class:`~client_tpu_torch.lifecycle.EndpointPool` with a healthy
    alternative), sleeping out a backoff — or a draining server's
    Retry-After, which applies to THAT server, not its replicas — just
    adds latency: the cap (typically 0) overrides both so the retry goes
    elsewhere immediately."""
    if backoff is None or cap_s is None:
        return backoff
    return min(backoff, max(0.0, cap_s))


class _AttemptLoop:
    """Shared per-attempt decision core for the sync and async drivers.

    Holds the retry/deadline/breaker state of one logical call; the
    drivers only perform the actual send and the actual sleep, so the
    classification and bookkeeping logic exists exactly once.
    """

    def __init__(
        self,
        retry_policy,
        circuit_breaker,
        budget_s,
        idempotent,
        result_status,
        description,
        result_backoff_hint=None,
        result_backoff_cap=None,
    ):
        self.policy = retry_policy
        self.breaker = circuit_breaker
        self.budget_s = budget_s
        self.idempotent = idempotent
        self.result_status = result_status
        self.result_backoff_hint = result_backoff_hint
        self.result_backoff_cap = result_backoff_cap
        self.description = description
        clock = (
            retry_policy.clock if retry_policy is not None else time.monotonic
        )
        self.deadline = (
            Deadline(budget_s, clock=clock) if budget_s is not None else None
        )
        self.http_set = (
            retry_policy.retryable_http
            if retry_policy
            else DEFAULT_RETRYABLE_HTTP_STATUSES
        )
        self.grpc_set = (
            retry_policy.retryable_grpc
            if retry_policy
            else DEFAULT_RETRYABLE_GRPC_CODES
        )
        self.retries = 0

    def _finish(self) -> None:
        _last_retry_count.set(self.retries)

    def pre_attempt(self) -> Optional[float]:
        """Breaker gate + per-attempt timeout for the next attempt."""
        if self.breaker is not None and not self.breaker.allow():
            self._finish()
            _note("circuit_open", description=self.description)
            raise CircuitBreakerOpenError(
                f"circuit breaker is open; {self.description} failed fast"
            )
        if self.deadline is not None:
            return self.deadline.attempt_timeout_s()
        return self.budget_s

    def on_exception(self, exc: BaseException) -> float:
        """Classify a failed attempt; returns the backoff to sleep before
        retrying, or re-raises when the call is out of attempts/budget.
        Takes BaseException so a cancelled half-open probe still releases
        its breaker slot; non-Exceptions always propagate without retry."""
        record_breaker_outcome(self.breaker, exc)
        if isinstance(exc, Exception):
            retryable = exception_is_retryable(exc, self.policy)
            if _should_retry_now(
                self.policy, self.idempotent, self.retries, retryable
            ):
                backoff = _apply_backoff_cap(
                    _apply_backoff_hint(
                        _backoff_within_budget(
                            self.policy, self.deadline, self.retries
                        ),
                        getattr(exc, "retry_after_s", None),
                        self.deadline,
                    ),
                    # a client surface that just failed over to another
                    # endpoint stamps this on the exception: retry NOW
                    getattr(exc, "retry_backoff_cap_s", None),
                )
                if backoff is not None:
                    self.retries += 1
                    status = (
                        exc.status()
                        if isinstance(exc, InferenceServerException)
                        else None
                    )
                    _note(
                        "retry",
                        attempt=self.retries,
                        backoff_s=backoff,
                        error=status or type(exc).__name__,
                    )
                    return backoff
        self._finish()
        raise exc

    def on_result(self, value) -> Optional[float]:
        """Classify a returned value; None means the call is complete
        (return the value as-is — in-band error semantics preserved),
        otherwise the backoff to sleep before retrying."""
        token = (
            self.result_status(value)
            if self.result_status is not None
            else None
        )
        if token is not None and _token_is_retryable(
            token, self.http_set, self.grpc_set
        ):
            if self.breaker is not None:
                self.breaker.record_failure()
            if _should_retry_now(
                self.policy, self.idempotent, self.retries, True
            ):
                backoff = _apply_backoff_cap(
                    _apply_backoff_hint(
                        _backoff_within_budget(
                            self.policy, self.deadline, self.retries
                        ),
                        self.result_backoff_hint(value)
                        if self.result_backoff_hint is not None
                        else None,
                        self.deadline,
                    ),
                    self.result_backoff_cap(value)
                    if self.result_backoff_cap is not None
                    else None,
                )
                if backoff is not None:
                    self.retries += 1
                    _note(
                        "retry",
                        attempt=self.retries,
                        backoff_s=backoff,
                        error=token,
                    )
                    return backoff
            self._finish()
            return None
        # breaker outcome is policy-independent: a default-retryable
        # status still counts as failure even when a custom policy chose
        # not to retry it, and 5xx tokens are inconclusive
        _breaker_record_outcome(
            self.breaker,
            _token_breaker_outcome(token) if token is not None else False,
        )
        self._finish()
        return None


async def run_with_resilience_async(
    send: Callable[[Optional[float]], Awaitable],
    *,
    retry_policy: Optional[RetryPolicy] = None,
    circuit_breaker: Optional[CircuitBreaker] = None,
    budget_s: Optional[float] = None,
    idempotent: bool = True,
    result_status: Optional[Callable[[object], str]] = None,
    description: str = "request",
    result_backoff_hint: Optional[Callable[[object], Optional[float]]] = None,
    result_backoff_cap: Optional[Callable[[object], Optional[float]]] = None,
):
    """Run ``send(per_attempt_timeout)`` under retry/deadline/breaker rules.

    ``send`` performs one attempt; its timeout argument is the remaining
    deadline budget (or ``budget_s``/None when no budget). Failures may
    be exceptions or — for surfaces like HTTP that signal errors in-band
    — returned values whose ``result_status(value)`` token classifies as
    retryable; a failing value is returned as-is once attempts are
    exhausted, so non-retry semantics are unchanged.
    ``result_backoff_hint(value)`` may supply a server-provided backoff
    floor in seconds for a retryable value (HTTP ``Retry-After`` on a 429
    shed response); exceptions carry the same hint as a
    ``retry_after_s`` attribute. ``result_backoff_cap(value)`` is the
    inverse — a ceiling (typically 0) for the endpoint-failover case
    where the next attempt goes to a DIFFERENT endpoint, so neither the
    backoff nor the failed endpoint's Retry-After should delay it;
    exceptions carry it as ``retry_backoff_cap_s``.
    """
    if retry_policy is None and circuit_breaker is None:
        # default configuration: no loop state, no classification — the
        # hot path costs one contextvar write over a bare send
        _last_retry_count.set(0)
        return await send(budget_s)
    loop = _AttemptLoop(
        retry_policy,
        circuit_breaker,
        budget_s,
        idempotent,
        result_status,
        description,
        result_backoff_hint,
        result_backoff_cap,
    )
    while True:
        attempt_timeout = loop.pre_attempt()
        try:
            value = await send(attempt_timeout)
        except BaseException as exc:  # noqa: BLE001 - classified in the loop
            backoff = loop.on_exception(exc)  # re-raises when done
        else:
            backoff = loop.on_result(value)
            if backoff is None:
                return value
        await loop.policy.async_sleep(backoff)


def run_with_resilience(
    send: Callable[[Optional[float]], object],
    *,
    retry_policy: Optional[RetryPolicy] = None,
    circuit_breaker: Optional[CircuitBreaker] = None,
    budget_s: Optional[float] = None,
    idempotent: bool = True,
    result_status: Optional[Callable[[object], str]] = None,
    description: str = "request",
    result_backoff_hint: Optional[Callable[[object], Optional[float]]] = None,
    result_backoff_cap: Optional[Callable[[object], Optional[float]]] = None,
):
    """Sync twin of :func:`run_with_resilience_async` (blocking sleeps)."""
    if retry_policy is None and circuit_breaker is None:
        _last_retry_count.set(0)
        return send(budget_s)
    loop = _AttemptLoop(
        retry_policy,
        circuit_breaker,
        budget_s,
        idempotent,
        result_status,
        description,
        result_backoff_hint,
        result_backoff_cap,
    )
    while True:
        attempt_timeout = loop.pre_attempt()
        try:
            value = send(attempt_timeout)
        except BaseException as exc:  # noqa: BLE001 - classified in the loop
            backoff = loop.on_exception(exc)  # re-raises when done
        else:
            backoff = loop.on_result(value)
            if backoff is None:
                return value
        loop.policy.sleep(backoff)

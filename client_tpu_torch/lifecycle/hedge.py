"""Request hedging: a second attempt for the tail, first response wins.

An own copy of ``client_tpu/lifecycle/hedge.py``.

A hedged call sends the request normally, and — if no response arrived
within the hedge delay — launches ONE duplicate attempt against a
*different* healthy endpoint. Whichever attempt produces an acceptable
response first wins; the loser is cancelled. Hedging trades a small
amount of duplicate work (bounded by the trigger: a p95-derived delay
duplicates ~5% of requests) for a p99 that tracks the fleet's
second-slowest replica instead of its slowest.

Safety rules (enforced by the client surfaces, documented here because
they are the contract):

* Only idempotent requests hedge — sequence inference never does
  (same classification the retry loop uses).
* Requests carrying shm-ring tickets (``shm_ring_region`` parameter)
  never hedge: the slot is a mutable single-writer resource, and two
  servers racing to write one slot would corrupt whichever response
  loses.
* A cancelled loser closes its begin/finish bracket with
  ``cancelled=True`` — it books neither a latency sample nor an error
  in the pool telemetry, and only the winner's outcome reaches the
  retry loop, so hedges are never double-counted in either.

:class:`HedgePolicy` holds the trigger; the orchestration lives in
:func:`hedged_send_async` (asyncio surfaces — http.aio, grpc.aio, and
through them the sync http veneer). The sync gRPC client runs the same
state machine over gRPC futures (see ``_hedged_infer`` there). The
policy is deliberately clock-free: the latency window is fed from the
pool's own begin/finish measurements, so tests drive it with plain
numbers.
"""

import asyncio
import threading
from typing import Callable, List, Optional, Union

from client_tpu_torch.utils import InferenceServerException


class HedgePolicy:
    """When to launch the hedge attempt.

    Parameters
    ----------
    hedge_after_s:
        Fixed hedge delay in seconds. None (the default) derives the
        delay from observed latency instead: the ``quantile`` of a
        rolling window of successful-attempt latencies.
    quantile:
        The derived trigger's quantile (default 0.95 — hedge the
        slowest ~5% of requests).
    min_samples:
        Derived mode stays disarmed (``current_delay_s()`` is None, no
        hedging) until the window holds this many samples — hedging on
        a cold estimate would duplicate half the traffic.
    window:
        Latency-window size in samples (ring buffer).
    min_delay_s:
        Floor for the derived delay; keeps a microsecond-fast model
        from hedging every request that hits one scheduler hiccup.
    """

    def __init__(
        self,
        hedge_after_s: Optional[float] = None,
        quantile: float = 0.95,
        min_samples: int = 20,
        window: int = 512,
        min_delay_s: float = 0.001,
    ):
        if hedge_after_s is not None and hedge_after_s <= 0:
            raise ValueError("hedge_after_s must be > 0 (or None for p95)")
        if not 0.5 <= quantile < 1.0:
            raise ValueError("quantile must be in [0.5, 1.0)")
        if window < 8:
            raise ValueError("window must be >= 8")
        self.hedge_after_s = hedge_after_s
        self.quantile = quantile
        self.min_samples = max(1, min_samples)
        self.min_delay_s = min_delay_s
        self._lock = threading.Lock()
        self._window: List[float] = [0.0] * window
        self._count = 0  # total recorded (ring index = count % window)
        self._cached_delay: Optional[float] = None
        self._cached_at = -1

    def record(self, latency_s: float) -> None:
        """Feed one successful attempt's latency into the window."""
        with self._lock:
            self._window[self._count % len(self._window)] = latency_s
            self._count += 1

    def current_delay_s(self) -> Optional[float]:
        """The hedge delay to use right now; None disarms hedging
        (derived mode still warming up)."""
        if self.hedge_after_s is not None:
            return self.hedge_after_s
        with self._lock:
            if self._count < self.min_samples:
                return None
            # recompute every 16 samples; sorting a 512-entry window per
            # request would cost more than the hedge saves
            if self._cached_delay is None or self._count - self._cached_at >= 16:
                live = sorted(self._window[: min(self._count, len(self._window))])
                index = min(len(live) - 1, int(self.quantile * len(live)))
                self._cached_delay = max(self.min_delay_s, live[index])
                self._cached_at = self._count
            return self._cached_delay

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "mode": (
                    "fixed" if self.hedge_after_s is not None else "derived"
                ),
                "delay_s": self.hedge_after_s
                if self.hedge_after_s is not None
                else self._cached_delay,
                "samples": self._count,
            }


def resolve_hedge_policy(
    spec: Union[None, float, int, str, HedgePolicy],
) -> Optional[HedgePolicy]:
    """One resolver for every ``hedge_policy=`` surface: None (off), a
    :class:`HedgePolicy`, a positive number of seconds (fixed trigger),
    or ``"p95"``/``0`` (latency-derived trigger)."""
    if spec is None or isinstance(spec, HedgePolicy):
        return spec
    if isinstance(spec, str):
        name = spec.strip().lower()
        if name in ("p95", "derived", "auto"):
            return HedgePolicy()
        try:
            spec = float(name)
        except ValueError:
            raise ValueError(
                f"unknown hedge policy '{name}' (expected seconds, 'p95', "
                "or a HedgePolicy)"
            ) from None
    if isinstance(spec, (int, float)):
        if spec == 0:
            return HedgePolicy()  # 0 = derive from observed p95
        return HedgePolicy(hedge_after_s=float(spec))
    raise TypeError(
        f"hedge_policy must be seconds, 'p95', or HedgePolicy, got "
        f"{type(spec)!r}"
    )


async def _run_bracketed(
    pool, hedge, endpoint, send, timeout, value_ok, value_token=None
):
    """One attempt under the pool's begin/finish bracket. Cancellation
    (the hedge loser) closes the bracket with ``cancelled=True`` so the
    outstanding gauge never leaks AND the loser books neither an error
    nor a latency sample. Failure tokens ride into ``finish`` so
    client-fault responses never feed consecutive-error ejection."""
    started = pool.begin(endpoint)
    try:
        value = await send(endpoint, timeout)
    except asyncio.CancelledError:
        pool.finish(endpoint, started, ok=False, cancelled=True)
        raise
    except BaseException as e:
        pool.finish(
            endpoint,
            started,
            ok=False,
            token=e.status()
            if isinstance(e, InferenceServerException)
            else None,
        )
        raise
    ok = value_ok(value) if value_ok is not None else True
    latency_s = pool.finish(
        endpoint,
        started,
        ok=ok,
        token=None
        if ok or value_token is None
        else value_token(value),
    )
    if ok and hedge is not None:
        hedge.record(latency_s)
    return value


async def hedged_send_async(
    pool,
    hedge: HedgePolicy,
    pick: Callable,
    send: Callable,
    attempt_timeout: Optional[float],
    value_ok: Optional[Callable] = None,
    value_token: Optional[Callable] = None,
):
    """One hedged attempt: normal send, plus — past the hedge delay —
    one duplicate on a different endpoint; first acceptable response
    wins, the loser is cancelled.

    ``pick(timeout, exclude)`` is the surface's probe-aware endpoint
    picker (awaitable); ``send(endpoint, timeout)`` performs one raw
    attempt against a SPECIFIC endpoint (no pool bracketing — this
    function owns the brackets); ``value_ok(value)`` classifies in-band
    results (HTTP status tuples) — None means any return value wins.

    From the retry loop's point of view this whole dance is ONE
    attempt: exactly one outcome (the winner's — or, when both fail,
    the primary's) propagates, so hedges never inflate retry counts.
    """
    ep1 = await pick(attempt_timeout, None)
    loop = asyncio.get_running_loop()
    t1 = loop.create_task(
        _run_bracketed(
            pool, hedge, ep1, send, attempt_timeout, value_ok, value_token
        )
    )
    t2 = None
    try:
        delay = hedge.current_delay_s()
        if delay is not None and attempt_timeout is not None:
            delay = min(delay, attempt_timeout)
        if delay is None:
            # derived trigger still warming: plain attempt, feed the window
            return await t1
        done, _pending = await asyncio.wait({t1}, timeout=delay)
        if done:
            return t1.result()
        # the hedge rides what REMAINS of the attempt budget (~delay has
        # elapsed): giving it the full attempt_timeout would let the
        # hedged pair overrun the caller's deadline by up to the delay
        hedge_timeout = (
            max(0.001, attempt_timeout - delay)
            if attempt_timeout is not None
            else None
        )
        ep2 = await pick(hedge_timeout, ep1)
        if ep2 is None or ep2 is ep1:
            # nowhere distinct to hedge to — ride out the primary
            return await t1
        pool.note_hedge()
        t2 = loop.create_task(
            _run_bracketed(
                pool, hedge, ep2, send, hedge_timeout, value_ok, value_token
            )
        )
        outcomes = {}  # task -> ("ok" | "bad", value) | ("err", exc)
        winner = None
        pending = {t1, t2}
        while pending and winner is None:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                if task.cancelled():
                    outcomes[task] = ("err", asyncio.CancelledError())
                    continue
                exc = task.exception()
                if exc is not None:
                    outcomes[task] = ("err", exc)
                    continue
                value = task.result()
                ok = value_ok(value) if value_ok is not None else True
                outcomes[task] = ("ok" if ok else "bad", value)
            # winner selection is ORDERED (primary first), not the wait
            # set's iteration order: when both land in one wakeup the
            # primary's success wins and hedge_wins stays deterministic
            for task in (t1, t2):
                if outcomes.get(task, ("", None))[0] == "ok":
                    winner = task
                    break
        if winner is not None:
            if winner is t2:
                pool.note_hedge_win()
            return winner.result()
        # both attempts failed: the primary's outcome speaks for the call
        # (one outcome -> one retry-loop classification, never two)
        kind, payload = outcomes[t1]
        if kind == "err":
            raise payload
        return payload
    finally:
        # the loser — and, on external cancellation, both attempts —
        # must never be left running with an open pool bracket
        for task in (t1, t2):
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except BaseException:  # noqa: BLE001 - loser teardown
                    pass

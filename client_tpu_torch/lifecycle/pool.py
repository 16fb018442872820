"""Client-side endpoint pool: health-aware routing + failover state.

An own copy of ``client_tpu/lifecycle/pool.py`` (without the gRPC-only
``grpc_status_is_endpoint_outage``).

Every client surface accepts an :class:`EndpointPool` (or ``urls=[...]``)
wherever a single ``url`` is accepted today. The pool is pure state — it
owns no sockets and issues no probes itself (the owning client probes
``/v2/health/ready`` / gRPC ``ServerReady`` when the pool says a
recovering endpoint :meth:`needs_probe`), so one implementation serves
every client surface and tests drive it with a fake clock.

Routing defaults to sticky-primary with failover: :meth:`pick` returns
the current primary until a request against it fails with an
unavailability signal (connect error, HTTP 503, gRPC UNAVAILABLE — a
draining or dead server), at which point the endpoint is marked down for
``cooldown_s`` (or the server's own ``Retry-After`` hint) and the primary
advances. A :class:`~client_tpu_torch.lifecycle.routing.RoutingPolicy`
(``routing_policy=``) replaces the sticky scan with load-aware selection
— round-robin, least-outstanding, power-of-two-choices on the live
outstanding/EWMA signals, or consistent-hash affinity on a request key.
Per-endpoint :class:`~client_tpu_torch.resilience.CircuitBreaker` instances
(optional) are consulted by :meth:`pick` and fed by :meth:`observe`, so a
flapping endpoint fails fast instead of eating a timeout per attempt.

On top of the reactive down/cooldown machine the pool runs **outlier
ejection**: an endpoint that fails ``eject_consecutive_errors`` attempts
in a row, or whose EWMA latency drifts past ``eject_ewma_factor`` x the
median of its peers, is ejected for ``ejection_cooldown_s`` and must pass
the same readiness re-probe a benched endpoint does before carrying
traffic again. Ejection never removes the last healthy endpoint.
"""

import threading
import time
from typing import Callable, List, Optional, Sequence, Union

from client_tpu_torch.lifecycle.routing import resolve_routing_policy
from client_tpu_torch.resilience import CONNECTION_ERROR_STATUS

# Status tokens that mean "this endpoint cannot serve right now" — route
# around it. 503 / UNAVAILABLE are what a draining server returns; a
# connection error is what a dead one produces.
UNAVAILABLE_TOKENS = frozenset({"503", "UNAVAILABLE", CONNECTION_ERROR_STATUS})


def status_is_unavailable(token: Optional[str]) -> bool:
    """True when a status token ("503", "StatusCode.UNAVAILABLE",
    "CONNECTION_ERROR") signals an endpoint-level outage."""
    if not token:
        return False
    return token.rsplit(".", 1)[-1] in UNAVAILABLE_TOKENS


def failover_retry_policy(pool_size: int):
    """The retry policy multi-endpoint clients install by default when
    the caller supplied none: a small budget (failover needs attempts to
    spend; the backoff is capped to zero when another endpoint is
    available), with ``CANCELLED`` added to the retryable gRPC codes, as
    the JAX package's policy has them (a wire CANCELLED is a gRPC
    replica's shutdown signal)."""
    from client_tpu_torch.resilience import (
        DEFAULT_RETRYABLE_GRPC_CODES,
        RetryPolicy,
    )

    return RetryPolicy(
        max_attempts=2 * pool_size,
        initial_backoff_s=0.02,
        max_backoff_s=0.5,
        retryable_grpc=frozenset(
            DEFAULT_RETRYABLE_GRPC_CODES | {"CANCELLED"}
        ),
    )


# EWMA smoothing for the per-endpoint latency estimate: ~the last 20
# requests dominate, old incidents decay instead of poisoning the mean
# forever (the "least-EWMA-latency" routing policy input).
EWMA_ALPHA = 0.1

# Status tokens that mean "the endpoint answered and rejected the
# REQUEST" — the caller's fault, not the endpoint's health. These never
# count toward consecutive-error ejection (mirrors the resilience
# layer's client-fault classification; 429 is excluded on purpose — a
# shedding server is under pressure, which IS a health signal).
_CLIENT_FAULT_GRPC = frozenset(
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


def _token_is_client_fault(token: str) -> bool:
    tail = token.rsplit(".", 1)[-1]
    if tail.isdigit():
        code = int(tail)
        return 400 <= code < 500 and code != 429
    return tail in _CLIENT_FAULT_GRPC


class Endpoint:
    """One pool member's health + telemetry state.

    Beyond the failover fields, each endpoint carries the live stats the
    routing policies of the scale-out arc consume: ``outstanding`` (the
    least-outstanding / power-of-two-choices signal), ``ewma_latency_s``
    (the latency-aware signal), and error/reroute counters. All are
    updated under the pool lock by :meth:`EndpointPool.begin` /
    :meth:`EndpointPool.finish` / :meth:`EndpointPool.mark_down`.
    """

    __slots__ = (
        "url",
        "circuit_breaker",
        "down_until",
        "ejected_until",
        "was_down",
        "failures",
        "successes",
        "outstanding",
        "ewma_latency_s",
        "errors",
        "consecutive_errors",
        "ejections",
        "reroutes",
        "pinned_streams",
    )

    def __init__(self, url: str, circuit_breaker=None):
        self.url = url
        self.circuit_breaker = circuit_breaker
        self.down_until = 0.0
        # outlier ejection benches an endpoint on its own clock, composing
        # with (not replacing) the mark_down cooldown
        self.ejected_until = 0.0
        # once an endpoint has been marked down, its first use after the
        # cooldown should be a readiness probe, not a real request
        self.was_down = False
        self.failures = 0
        self.successes = 0
        # live telemetry (begin/finish bracket every attempt)
        self.outstanding = 0
        self.ewma_latency_s = 0.0
        self.errors = 0
        self.consecutive_errors = 0
        self.ejections = 0
        self.reroutes = 0
        # open bidirectional streams pinned to this endpoint (counted at
        # open/close, NOT per request — decoupled streams may produce N
        # responses per request so a per-request bracket is ill-defined;
        # routing policies deliberately exclude this from their load
        # signals and it is surfaced for visibility only)
        self.pinned_streams = 0

    def state(self, now: float) -> str:
        """The endpoint's health state at ``now``: ``up`` (serving),
        ``down`` (benched by an unavailability signal), ``ejected``
        (benched by outlier ejection), or ``probe`` (cooldown elapsed,
        awaiting a readiness re-probe before real traffic)."""
        if self.ejected_until and now < self.ejected_until:
            return "ejected"
        if self.down_until and now < self.down_until:
            return "down"
        if self.was_down:
            return "probe"
        return "up"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Endpoint({self.url!r}, down_until={self.down_until})"


class EndpointPool:
    """Health-aware endpoint selection shared by the client surfaces.

    Parameters
    ----------
    urls:
        Endpoint addresses (``host:port``). A single comma-separated
        string is accepted (the perf CLI's ``-u host1:p1,host2:p2``).
    cooldown_s:
        How long a failed endpoint stays out of rotation before it is
        probed again (a server's ``Retry-After`` hint overrides this per
        incident).
    breaker_factory:
        Optional zero-arg callable returning a per-endpoint
        :class:`~client_tpu_torch.resilience.CircuitBreaker`; when set,
        :meth:`pick` skips endpoints whose breaker is open and
        :meth:`observe` feeds each endpoint's breaker.
    routing_policy:
        None (sticky-primary, the default), a policy name
        (``round_robin`` / ``least_outstanding`` / ``p2c`` /
        ``consistent_hash``), or a
        :class:`~client_tpu_torch.lifecycle.routing.RoutingPolicy` instance.
    eject_consecutive_errors / eject_ewma_factor / ejection_cooldown_s:
        Outlier ejection: ``eject_consecutive_errors`` failed attempts
        in a row (0 disables), or an EWMA latency above
        ``eject_ewma_factor`` x the median of the other endpoints'
        EWMAs (0 disables; needs >= 3 endpoints with latency data),
        eject the endpoint for ``ejection_cooldown_s`` — it re-enters
        through the same readiness re-probe as a benched endpoint.
        Ejection never removes the last healthy endpoint.
    clock:
        Injectable monotonic-seconds clock (fake-clock tests).
    logger:
        Optional :class:`~client_tpu_torch.observability.StructuredLogger`.
        When set, failover state changes emit structured events
        (``endpoint_down`` / ``endpoint_ejected`` /
        ``endpoint_recovered``); when None — the default — each site is
        a single None-check (the same zero-cost pattern as the
        resilience layer's attempt-event log).
    """

    def __init__(
        self,
        urls: Union[str, Sequence[str]],
        cooldown_s: float = 1.0,
        breaker_factory: Optional[Callable[[], object]] = None,
        routing_policy=None,
        eject_consecutive_errors: int = 5,
        eject_ewma_factor: float = 4.0,
        ejection_cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        logger=None,
    ):
        if isinstance(urls, str):
            urls = [u.strip() for u in urls.split(",") if u.strip()]
        urls = list(urls)
        if not urls:
            raise ValueError("EndpointPool needs at least one url")
        self.cooldown_s = cooldown_s
        self.eject_consecutive_errors = eject_consecutive_errors
        self.eject_ewma_factor = eject_ewma_factor
        self.ejection_cooldown_s = ejection_cooldown_s
        self._clock = clock
        self._logger = logger
        self._breaker_factory = breaker_factory
        self._lock = threading.Lock()
        self._endpoints: List[Endpoint] = [
            Endpoint(u, breaker_factory() if breaker_factory else None)
            for u in urls
        ]
        self._routing_policy = None
        self._install_policy(resolve_routing_policy(routing_policy))
        self._primary = 0
        # times the primary moved off a failed endpoint (observability)
        self.failovers = 0
        # outlier ejections across the pool (observability)
        self.ejections = 0
        # hedged attempts launched / won by the hedge (fed by the hedge
        # orchestration; exposed as tpu_client_hedges_total downstream)
        self.hedges = 0
        self.hedge_wins = 0

    def _install_policy(self, policy) -> None:
        # consistent-hash rings must cover the FULL membership (health
        # filters at lookup); priming here — before any endpoint can be
        # benched — is what keeps key->endpoint stable across recoveries
        if policy is not None and hasattr(policy, "prime"):
            policy.prime([ep.url for ep in self._endpoints])
        self._routing_policy = policy

    @property
    def routing_policy(self):
        return self._routing_policy

    @routing_policy.setter
    def routing_policy(self, spec) -> None:
        self._install_policy(resolve_routing_policy(spec))

    @property
    def key_parameter(self) -> Optional[str]:
        """The request-parameter name the active policy keys affinity on
        (None unless a consistent-hash policy is installed) — client
        surfaces skip the per-request lookup entirely when None."""
        policy = self._routing_policy
        return policy.key_parameter if policy is not None else None

    @classmethod
    def resolve(
        cls,
        url: Optional[Union[str, "EndpointPool"]] = None,
        urls: Optional[Sequence[str]] = None,
        **kwargs,
    ) -> "EndpointPool":
        """The one spot every client constructor funnels through:
        ``url`` may be a host:port, a comma list, or an EndpointPool
        instance (returned as-is — shareable across clients, though an
        explicit ``routing_policy`` is installed onto it); ``urls``
        wins when given."""
        if isinstance(url, EndpointPool):
            policy = kwargs.get("routing_policy")
            if policy is not None:
                url.routing_policy = policy
            return url
        if urls:
            return cls(urls, **kwargs)
        if url is None:
            raise ValueError("either url or urls is required")
        return cls(url, **kwargs)

    # -- membership ----------------------------------------------------------
    #
    # Client pools are fixed at construction, but the router tier's pool
    # follows the autoscaler: replicas join as they launch and leave as
    # they drain. Both mutations re-prime any keyed policy's ring over
    # the FULL new membership (some keys move on a membership change —
    # that is inherent to consistent hashing, and the vnode ring bounds
    # how many).

    def add_endpoint(self, url: str) -> Endpoint:
        """Add one endpoint to the pool (idempotent: an existing url
        returns its live endpoint untouched, telemetry intact)."""
        with self._lock:
            for ep in self._endpoints:
                if ep.url == url:
                    return ep
            ep = Endpoint(
                url,
                self._breaker_factory() if self._breaker_factory else None,
            )
            self._endpoints.append(ep)
            policy = self._routing_policy
            if policy is not None and hasattr(policy, "prime"):
                policy.prime([e.url for e in self._endpoints])
        if self._logger is not None:
            self._logger.info("endpoint_added", endpoint=url)
        return ep

    def remove_endpoint(self, url: str) -> bool:
        """Remove one endpoint from rotation (a draining replica: the
        autoscaler stops routing to it BEFORE the drain starts, so
        in-flight work finishes and nothing new lands on it). Refuses to
        empty the pool. Returns True when a member was removed."""
        with self._lock:
            for index, ep in enumerate(self._endpoints):
                if ep.url == url:
                    break
            else:
                return False
            if len(self._endpoints) == 1:
                return False
            del self._endpoints[index]
            if self._primary >= len(self._endpoints):
                self._primary = 0
            policy = self._routing_policy
            if policy is not None and hasattr(policy, "prime"):
                policy.prime([e.url for e in self._endpoints])
        if self._logger is not None:
            self._logger.info("endpoint_removed", endpoint=url)
        return True

    # -- introspection -------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self._endpoints)

    @property
    def urls(self) -> List[str]:
        return [ep.url for ep in self._endpoints]

    @property
    def endpoints(self) -> List[Endpoint]:
        return list(self._endpoints)

    @property
    def primary_url(self) -> str:
        with self._lock:
            return self._endpoints[self._primary].url

    def _up(self, ep: Endpoint, now: float) -> bool:
        if ep.down_until and now < ep.down_until:
            return False
        if ep.ejected_until and now < ep.ejected_until:
            return False
        if ep.circuit_breaker is not None and not ep.circuit_breaker.allow():
            return False
        return True

    @staticmethod
    def _benched_until(ep: Endpoint) -> float:
        return max(ep.down_until, ep.ejected_until)

    # -- selection -----------------------------------------------------------

    def pick(
        self,
        key=None,
        exclude: Optional[Endpoint] = None,
        allow=None,
    ) -> Endpoint:
        """The endpoint the next request should target. With a routing
        policy installed, the policy selects among the currently healthy
        endpoints (on their live outstanding/EWMA signals, or on ``key``
        for consistent-hash affinity); without one — or when a keyed
        policy gets no key — the sticky-primary scan applies. ``exclude``
        removes one endpoint from consideration (the hedge path asks for
        somewhere *different*); ``allow`` (a url set, or None for all)
        restricts selection to a subset — the router's model→replica
        table picks only among replicas that serve the request's model.
        When every endpoint is down, returns the one whose cooldown ends
        soonest — callers still try it (the server may be back early)."""
        with self._lock:
            now = self._clock()
            n = len(self._endpoints)
            policy = self._routing_policy

            def eligible(ep):
                return allow is None or ep.url in allow

            if policy is not None:
                candidates = [
                    ep
                    for ep in self._endpoints
                    if ep is not exclude and eligible(ep) and self._up(ep, now)
                ]
                if candidates:
                    choice = policy.select(candidates, key)
                    if choice is not None:
                        return choice
            for offset in range(n):
                ep = self._endpoints[(self._primary + offset) % n]
                if ep is not exclude and eligible(ep) and self._up(ep, now):
                    return ep
            if exclude is not None:
                # nothing else healthy: the excluded endpoint (if up) is
                # all there is — callers detect the identity and skip
                # hedging rather than duplicate onto the same endpoint
                for ep in self._endpoints:
                    if eligible(ep) and self._up(ep, now):
                        return ep
            allowed = [ep for ep in self._endpoints if eligible(ep)]
            return min(allowed or self._endpoints, key=self._benched_until)

    def has_alternative(self, ep: Optional[Endpoint]) -> bool:
        """True when a request that just failed on ``ep`` (None: on
        whichever endpoint was benched for it) has somewhere else to go
        RIGHT NOW — the failover fast path (no backoff sleep)."""
        with self._lock:
            now = self._clock()
            return any(
                other is not ep and self._up(other, now)
                for other in self._endpoints
            )

    def needs_probe(self, ep: Endpoint) -> bool:
        """True when ``ep`` is coming back from a down/ejected period and
        should pass a readiness probe before carrying real traffic.
        Single-endpoint pools never probe — there is no alternative to
        protect."""
        if len(self._endpoints) == 1:
            return False
        with self._lock:
            return ep.was_down and self._clock() >= self._benched_until(ep)

    # -- per-endpoint telemetry ----------------------------------------------

    def begin(self, ep: Endpoint) -> float:
        """Mark one request outstanding on ``ep``; returns the start
        timestamp the caller passes back to :meth:`finish`. Every attempt
        a client surface sends brackets itself with begin/finish, so
        ``outstanding`` is the live in-flight count per endpoint — the
        signal a least-outstanding routing policy selects on."""
        with self._lock:
            ep.outstanding += 1
        return self._clock()

    def finish(
        self,
        ep: Endpoint,
        started: float,
        ok: bool,
        cancelled: bool = False,
        token: Optional[str] = None,
    ) -> float:
        """Close the begin/finish bracket: drop the outstanding count,
        fold a successful attempt's latency into the EWMA, count an
        error; returns the attempt latency in seconds (the hedge trigger
        feeds on it). ``cancelled=True`` (a hedge loser, or a locally
        cancelled attempt) books neither a latency sample nor an error —
        cancellation says nothing about the endpoint.

        Ejection triggers live here: ``eject_consecutive_errors``
        failures in a row, or — on a success — an EWMA that drifted past
        ``eject_ewma_factor`` x the median of the peers' EWMAs (the
        slow-replica outlier: it answers, just too late to wait for).
        ``token`` (the failed attempt's status, when the caller has one)
        keeps *client-fault* responses — 4xx, INVALID_ARGUMENT and kin —
        out of the consecutive-error count entirely: the endpoint
        answered, which proves it healthy, so such a response RESETS the
        streak rather than feeding it (a workload of consistently
        rejected requests must never eject a healthy replica).
        Endpoint-health *benching* signals (503/UNAVAILABLE) stay with
        :meth:`observe`."""
        latency_s = self._clock() - started
        event = None
        with self._lock:
            if ep.outstanding > 0:
                ep.outstanding -= 1
            if cancelled:
                return latency_s
            if ok:
                ep.consecutive_errors = 0
                if ep.ewma_latency_s:
                    ep.ewma_latency_s += EWMA_ALPHA * (
                        latency_s - ep.ewma_latency_s
                    )
                else:
                    ep.ewma_latency_s = latency_s
                event = self._maybe_eject_outlier(ep)
            else:
                ep.errors += 1
                if token is not None and _token_is_client_fault(token):
                    ep.consecutive_errors = 0
                else:
                    ep.consecutive_errors += 1
                    if (
                        self.eject_consecutive_errors
                        and ep.consecutive_errors
                        >= self.eject_consecutive_errors
                    ):
                        event = self._eject(ep, "consecutive_errors")
        if event is not None and self._logger is not None:
            self._logger.warning("endpoint_ejected", **event)
        return latency_s

    def _maybe_eject_outlier(self, ep: Endpoint):
        """EWMA-vs-peer-median ejection check (pool lock held). Needs at
        least two peers with latency data — below that, "slower than the
        median" is just "the two replicas differ"."""
        if not self.eject_ewma_factor or len(self._endpoints) < 3:
            return None
        if not ep.ewma_latency_s:
            return None
        if ep.successes < 10:
            # a cold endpoint's EWMA is one sample deep — a warmup/jit
            # spike would read as an "outlier" and eject a healthy
            # replica before its estimate has decayed toward reality
            return None
        peers = sorted(
            other.ewma_latency_s
            for other in self._endpoints
            if other is not ep and other.ewma_latency_s > 0
        )
        if len(peers) < 2:
            return None
        median = peers[len(peers) // 2]
        if median <= 0 or ep.ewma_latency_s <= self.eject_ewma_factor * median:
            return None
        return self._eject(ep, "ewma_outlier")

    def _eject(self, ep: Endpoint, reason: str):
        """Take ``ep`` out of rotation for the ejection cooldown (pool
        lock held). Returns the structured-log event, or None when the
        ejection was refused (it would have removed the last healthy
        endpoint). Re-entry goes through the same readiness re-probe a
        benched endpoint takes."""
        now = self._clock()
        if ep.ejected_until and now < ep.ejected_until:
            return None  # already ejected; don't inflate the counters
        if not any(
            other is not ep and self._up(other, now)
            for other in self._endpoints
        ):
            return None
        ep.ejected_until = now + self.ejection_cooldown_s
        ep.was_down = True
        ep.consecutive_errors = 0
        ep.ejections += 1
        self.ejections += 1
        n = len(self._endpoints)
        if n > 1 and self._endpoints[self._primary] is ep:
            for offset in range(1, n):
                candidate = (self._primary + offset) % n
                if self._up(self._endpoints[candidate], now):
                    self._primary = candidate
                    self.failovers += 1
                    ep.reroutes += 1
                    break
        return {
            "endpoint": ep.url,
            "reason": reason,
            "cooldown_s": round(self.ejection_cooldown_s, 3),
            "ejections": ep.ejections,
        }

    # -- hedging bookkeeping -------------------------------------------------

    def note_hedge(self) -> None:
        """One hedge attempt launched (tpu_client_hedges_total)."""
        with self._lock:
            self.hedges += 1

    def note_hedge_win(self) -> None:
        """The hedge attempt answered before the primary did."""
        with self._lock:
            self.hedge_wins += 1

    # -- pinned streams ------------------------------------------------------

    def pin_stream(self, ep: Endpoint) -> None:
        """One bidirectional stream opened against ``ep``. Stream traffic
        is counted at the STREAM granularity (decoupled models produce N
        responses per request, so a per-request bracket is ill-defined)
        and is deliberately excluded from the routing policies' load
        signals — it is surfaced in :meth:`snapshot` for visibility."""
        with self._lock:
            ep.pinned_streams += 1

    def unpin_stream(self, ep: Endpoint) -> None:
        with self._lock:
            if ep.pinned_streams > 0:
                ep.pinned_streams -= 1

    def snapshot(self) -> dict:
        """The pool's live telemetry in one consistent read: per-endpoint
        outstanding/EWMA/counters plus the pool-level failover, ejection
        and hedge counts — what the perf report's "Client metrics"
        section prints and what the routing policies consume. Each
        endpoint carries its health ``state`` (``up`` / ``down`` /
        ``ejected`` / ``probe``) so an ejected endpoint is never mistaken
        for a healthy idle one."""
        policy = self._routing_policy
        with self._lock:
            now = self._clock()
            return {
                "primary": self._endpoints[self._primary].url,
                "policy": policy.name if policy is not None else "sticky",
                "failovers": self.failovers,
                "ejections": self.ejections,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "endpoints": [
                    {
                        "url": ep.url,
                        "state": ep.state(now),
                        "outstanding": ep.outstanding,
                        "ewma_latency_us": round(ep.ewma_latency_s * 1e6, 1),
                        "successes": ep.successes,
                        "errors": ep.errors,
                        "marked_down": ep.failures,
                        "ejections": ep.ejections,
                        "reroutes": ep.reroutes,
                        "pinned_streams": ep.pinned_streams,
                        "down": bool(ep.down_until and now < ep.down_until),
                    }
                    for ep in self._endpoints
                ],
            }

    # -- health feedback -----------------------------------------------------

    def mark_down(
        self, ep: Endpoint, cooldown_s: Optional[float] = None
    ) -> None:
        """Take ``ep`` out of rotation for a cooldown and advance the
        primary off it."""
        effective_cooldown = cooldown_s if cooldown_s else self.cooldown_s
        failed_over = None
        with self._lock:
            ep.down_until = self._clock() + effective_cooldown
            ep.was_down = True
            ep.failures += 1
            n = len(self._endpoints)
            if n > 1 and self._endpoints[self._primary] is ep:
                self._primary = (self._primary + 1) % n
                self.failovers += 1
                # traffic that was sticky on ep is rerouted to the new
                # primary from here on — charged to the endpoint that
                # caused the move
                ep.reroutes += 1
                failed_over = self._endpoints[self._primary].url
        if self._logger is not None:
            self._logger.warning(
                "endpoint_down",
                endpoint=ep.url,
                cooldown_s=round(effective_cooldown, 3),
                failures=ep.failures,
                new_primary=failed_over,
                failovers=self.failovers,
            )

    def mark_up(self, ep: Endpoint) -> None:
        with self._lock:
            recovered = ep.was_down
            ep.down_until = 0.0
            ep.ejected_until = 0.0
            ep.was_down = False
            ep.consecutive_errors = 0
        if recovered and self._logger is not None:
            self._logger.info("endpoint_recovered", endpoint=ep.url)

    def observe(
        self,
        ep: Endpoint,
        ok: bool = False,
        token: Optional[str] = None,
        retry_after_s: Optional[float] = None,
    ) -> None:
        """Feed one request outcome: success re-arms the endpoint, an
        unavailability token benches it for ``retry_after_s`` (the
        server's own estimate — a draining server knows its restart time
        better than our default) or ``cooldown_s``. Other tokens (4xx,
        model errors) say nothing about endpoint health."""
        if ok:
            with self._lock:
                actively_ejected = bool(
                    ep.ejected_until and self._clock() < ep.ejected_until
                )
                ep.successes += 1
            if not actively_ejected:
                # a success from an endpoint we EJECTED (an in-flight
                # straggler draining out) must not override the
                # deliberate bench — re-entry is the re-probe path's call
                self.mark_up(ep)
            if ep.circuit_breaker is not None:
                ep.circuit_breaker.record_success()
            return
        if status_is_unavailable(token):
            self.mark_down(ep, cooldown_s=retry_after_s)
            if ep.circuit_breaker is not None:
                ep.circuit_breaker.record_failure()

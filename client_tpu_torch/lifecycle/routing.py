"""Pluggable routing policies for :class:`~client_tpu_torch.lifecycle.EndpointPool`.

An own copy of ``client_tpu/lifecycle/routing.py``.

The pool's per-endpoint telemetry (``outstanding``, ``ewma_latency_s`` —
maintained by the begin/finish brackets every unary attempt takes) was
built as the routing-signal set; a :class:`RoutingPolicy` turns those
signals into a selection. Policies see only the *healthy* candidate list
(the pool has already removed benched/ejected/breaker-open endpoints) and
run under the pool lock, so a policy must never call back into the pool.

Built-in policies (``resolve_routing_policy`` accepts these names, with
``-``/``_`` interchangeable):

``sticky``
    The default and the pre-policy behavior: the pool's sticky-primary
    failover scan (implemented in the pool itself; the resolver returns
    None).
``round_robin``
    Rotate through healthy endpoints; even spread regardless of load.
``least_outstanding``
    The endpoint with the fewest in-flight requests (ties broken by EWMA
    latency, then rotation) — tracks live load directly.
``p2c`` (power of two choices)
    Sample two distinct healthy endpoints at random, take the less
    loaded (outstanding, then EWMA). O(1), avoids the thundering-herd
    a deterministic least-loaded pick causes when many clients share
    the same view.
``consistent_hash``
    Hash a per-request key onto a ring of virtual nodes; the same key
    lands on the same endpoint while it is healthy — request affinity,
    the KV-cache-locality prerequisite. The key rides a request
    parameter (``key_parameter``, default ``"routing_key"``); requests
    without a key fall back to the pool's sticky scan.

Mid-request-stream membership changes are handled by construction: a
ring built from the FULL url list with unhealthy endpoints skipped at
lookup keeps every key whose owner is still healthy exactly where it
was (the stability property the tests assert).
"""

import hashlib
import random
from typing import List, Optional, Sequence, Union


class RoutingPolicy:
    """Selection strategy over the pool's healthy endpoints.

    Subclasses implement :meth:`select`. ``candidates`` is a non-empty
    list of healthy :class:`~client_tpu_torch.lifecycle.Endpoint` objects in
    pool order; ``key`` is the per-request routing key (None unless the
    request carried the policy's ``key_parameter``). Returning None
    tells the pool to fall back to its sticky-primary scan.
    """

    name = "policy"
    # request-parameter name whose value becomes the routing key; None
    # for policies that ignore keys (the client surfaces skip the
    # parameter lookup entirely in that case)
    key_parameter: Optional[str] = None

    def select(self, candidates: Sequence, key=None):
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}()"


class RoundRobinPolicy(RoutingPolicy):
    """Rotate through healthy endpoints in pool order."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def select(self, candidates: Sequence, key=None):
        choice = candidates[self._next % len(candidates)]
        self._next = (self._next + 1) % (1 << 30)
        return choice


class LeastOutstandingPolicy(RoutingPolicy):
    """The endpoint with the fewest in-flight requests right now.

    Ties break by EWMA latency (prefer the historically faster one),
    then by a rotating index so a fully idle pool still spreads load
    instead of hammering endpoint 0.
    """

    name = "least_outstanding"

    def __init__(self):
        self._tiebreak = 0

    def select(self, candidates: Sequence, key=None):
        self._tiebreak = (self._tiebreak + 1) % (1 << 30)
        n = len(candidates)
        best = None
        best_rank = None
        for offset in range(n):
            ep = candidates[(self._tiebreak + offset) % n]
            rank = (ep.outstanding, ep.ewma_latency_s)
            if best_rank is None or rank < best_rank:
                best, best_rank = ep, rank
        return best


class PowerOfTwoPolicy(RoutingPolicy):
    """Power-of-two-choices: sample two healthy endpoints, take the less
    loaded one (outstanding, then EWMA latency). The randomized pair
    decorrelates many clients making the same decision from the same
    slightly-stale signals.

    ``rng`` is injectable for deterministic tests.
    """

    name = "p2c"

    def __init__(self, rng: Optional[random.Random] = None):
        self._rng = rng if rng is not None else random.Random()

    def select(self, candidates: Sequence, key=None):
        n = len(candidates)
        if n == 1:
            return candidates[0]
        i = self._rng.randrange(n)
        j = self._rng.randrange(n - 1)
        if j >= i:
            j += 1
        a, b = candidates[i], candidates[j]
        if (b.outstanding, b.ewma_latency_s) < (a.outstanding, a.ewma_latency_s):
            return b
        return a


class ConsistentHashPolicy(RoutingPolicy):
    """Consistent-hash affinity on a request parameter.

    A ring of ``vnodes`` virtual nodes per endpoint url maps keys to
    endpoints; the ring is built ONCE from the pool's FULL membership
    (:meth:`prime`, called by the pool when the policy is installed) and
    health is filtered at *lookup*, so endpoint health changes never
    move keys whose owner is still healthy — when an owner is down,
    only its keys move (to the next healthy endpoint clockwise), which
    is the ≥90%-stability property affinity relies on. Building from
    the healthy subset instead would reshuffle unrelated keys when a
    benched endpoint recovered — exactly the churn this policy exists
    to avoid. Keyless requests return None (the pool falls back to its
    sticky scan).
    """

    name = "consistent_hash"

    def __init__(self, key_parameter: str = "routing_key", vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.key_parameter = key_parameter
        self.vnodes = vnodes
        self._ring: List = []  # sorted [(point, url)]
        self._ring_urls: Optional[tuple] = None

    def prime(self, urls: Sequence[str]) -> None:
        """Build the ring from the pool's full membership (the pool
        calls this at install time, BEFORE any endpoint can be benched,
        so the ring always covers every member)."""
        self._build_ring(urls)

    @staticmethod
    def _point(data: str) -> int:
        # placement hash, not cryptography: usedforsecurity=False keeps
        # FIPS-enforced builds from rejecting md5 here
        digest = hashlib.md5(
            data.encode("utf-8"), usedforsecurity=False
        ).digest()
        return int.from_bytes(digest[:8], "big")

    def _build_ring(self, urls: Sequence[str]) -> None:
        ring = []
        for url in urls:
            for i in range(self.vnodes):
                ring.append((self._point(f"{url}#{i}"), url))
        ring.sort()
        self._ring = ring
        self._ring_urls = tuple(sorted(urls))

    def select(self, candidates: Sequence, key=None):
        if key is None:
            return None
        # the ring covers the FULL membership (primed by the pool);
        # health filtering happens at lookup so a benched endpoint's
        # return never reshuffles keys owned by endpoints that stayed
        # healthy
        by_url = {ep.url: ep for ep in candidates}
        urls = tuple(sorted(by_url))
        if self._ring_urls is None or not set(urls) <= set(self._ring_urls):
            # unprimed direct use, or an unknown member appeared:
            # (re)build from what we see (the pool's prime() makes this
            # unreachable in normal operation — pool membership is fixed
            # at construction)
            self._build_ring(urls)
        point = self._point(str(key))
        ring = self._ring
        n = len(ring)
        # binary search for the first ring point >= key point
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < point:
                lo = mid + 1
            else:
                hi = mid
        for offset in range(n):
            url = ring[(lo + offset) % n][1]
            ep = by_url.get(url)
            if ep is not None:
                return ep
        return None


_POLICY_FACTORIES = {
    "sticky": lambda: None,
    "round_robin": RoundRobinPolicy,
    "least_outstanding": LeastOutstandingPolicy,
    "p2c": PowerOfTwoPolicy,
    "power_of_two": PowerOfTwoPolicy,
    "consistent_hash": ConsistentHashPolicy,
}

ROUTING_POLICY_NAMES = (
    "sticky",
    "round_robin",
    "least_outstanding",
    "p2c",
    "consistent_hash",
)


def resolve_routing_policy(
    spec: Union[None, str, RoutingPolicy],
) -> Optional[RoutingPolicy]:
    """One resolver for every ``routing_policy=`` surface: accepts None
    (sticky), a policy name, or a :class:`RoutingPolicy` instance.
    Returns None for sticky — the pool's built-in scan IS that policy."""
    if spec is None or isinstance(spec, RoutingPolicy):
        return spec
    if isinstance(spec, str):
        name = spec.strip().lower().replace("-", "_")
        factory = _POLICY_FACTORIES.get(name)
        if factory is None:
            raise ValueError(
                f"unknown routing policy '{spec}' "
                f"(expected one of {', '.join(ROUTING_POLICY_NAMES)})"
            )
        return factory()
    raise TypeError(
        f"routing_policy must be a name or RoutingPolicy, got {type(spec)!r}"
    )

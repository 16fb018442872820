"""Fault injection for the port's in-process HTTP front-end.

An own copy of ``client_tpu/resilience/chaos.py``. A :class:`ChaosPolicy`
is accepted by ``InProcessServer(chaos=...)`` and ``serve_http(...,
chaos=...)`` and applied to every matched HTTP request: injected errors
(HTTP 503 by default), added latency, connection resets and truncated
response bodies. Draws come from a seeded rng, so a chaos test replays
the same fault sequence every run, and the same seed and rates give the
reference's fate sequence draw for draw.

The policy is transport-free; the front-end interprets the drawn fate
(``"error"``, ``"reset"``, ``"truncate"``) in its own wire terms. The
port's only gRPC server is its native front-end, which has no injection
hooks (as in the reference), so chaos is refused there.
"""

import collections
import random
import threading
from typing import Optional


class ChaosPolicy:
    """Per-request fault plan for ``InProcessServer``.

    Parameters
    ----------
    error_rate:
        Probability of answering with injected unavailability (HTTP
        ``http_status``).
    latency_s:
        Extra latency added to every matched request (event-loop sleep,
        never a blocking sleep).
    reset_rate:
        Probability of aborting the connection before responding.
    truncate_rate:
        Probability of truncating the response body mid-write.
    seed:
        Seed for the fault sequence (deterministic across runs).
    scope:
        ``"infer"`` (default) matches only inference paths so client
        setup calls (metadata, health) stay clean; ``"all"`` matches
        everything.
    http_status:
        Status code used for injected HTTP errors (503 by default).
    """

    def __init__(
        self,
        error_rate: float = 0.0,
        latency_s: float = 0.0,
        reset_rate: float = 0.0,
        truncate_rate: float = 0.0,
        seed: int = 0,
        scope: str = "infer",
        http_status: int = 503,
    ):
        for name, rate in (
            ("error_rate", error_rate),
            ("reset_rate", reset_rate),
            ("truncate_rate", truncate_rate),
        ):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be within [0, 1], got {rate}")
        total = error_rate + reset_rate + truncate_rate
        if total > 1.0:
            # the fates partition one draw; a sum over 1 would silently
            # under-inject the later ones
            raise ValueError(
                "error_rate + reset_rate + truncate_rate must not exceed "
                f"1.0, got {total}"
            )
        if scope not in ("infer", "all"):
            raise ValueError(f"scope must be 'infer' or 'all', got {scope!r}")
        self.error_rate = error_rate
        self.latency_s = latency_s
        self.reset_rate = reset_rate
        self.truncate_rate = truncate_rate
        self.scope = scope
        self.http_status = http_status
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # fate -> count of injected faults, for test assertions
        self.injected = collections.Counter()

    def applies_to(self, path_or_method: str) -> bool:
        """Whether this request target is in scope for fault injection.

        ``"infer"`` scope matches only the inference endpoints themselves
        (HTTP paths ending in ``/infer``, the ``ModelInfer`` /
        ``ModelStreamInfer`` gRPC methods) — a model *named* e.g.
        ``inference_v2`` must not drag its metadata calls into scope.
        """
        if self.scope == "all":
            return True
        target = path_or_method.rstrip("/")
        tail = target.rsplit("/", 1)[-1]
        return tail == "infer" or tail in ("ModelInfer", "ModelStreamInfer")

    def draw(self) -> Optional[str]:
        """Draw the next fate: "error", "reset", "truncate", or None.

        Drawing does NOT count the fault — the front-end calls
        :meth:`record` at the actual injection site, so
        :attr:`injected` only counts faults that really fired.
        """
        with self._lock:
            r = self._rng.random()
        for fate, rate in (
            ("error", self.error_rate),
            ("reset", self.reset_rate),
            ("truncate", self.truncate_rate),
        ):
            if r < rate:
                return fate
            r -= rate
        return None

    def record(self, fate: str) -> None:
        """Count a fault the front-end actually injected."""
        with self._lock:
            self.injected[fate] += 1

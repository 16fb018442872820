"""Router core: the transport-agnostic routing brain.

An own copy of ``client_tpu/router/core.py``, over the port's own wire
scanner and client fleet layer.

The router tier is a thin, stateless front door: it never materializes a
proto message on the hot path. Each inference request arrives as
serialized ``ModelInferRequest`` bytes, is classified by the same
memoizing :class:`~client_tpu_torch.grpc._wire.RequestScanner` the server
runs (model name, affinity key, priority: one top-level tag walk plus a
dict hit), gets its ``id`` spliced to a router correlation id, and is
written onto a persistent multiplexed backend stream. The response comes
back, has its original id restored, and is forwarded: two id splices of
proxy tax, no (de)serialization.

What the client fleet layer does runs HERE, server-side, on the router's
own live telemetry: the :class:`~client_tpu_torch.lifecycle.pool.EndpointPool`
(routing policies, outlier ejection, consistent-hash affinity over
per-backend outstanding/EWMA), the
:class:`~client_tpu_torch.lifecycle.hedge.HedgePolicy` tail-cutter, and
UNAVAILABLE failover. A client pointing at ONE router url installs no
failover policy of its own (auto-failover requires a multi-url pool), so
backend failures MUST be absorbed at this layer for scale events to stay
client-invisible.

Overload backstop: when the router's in-flight count hits
``max_inflight``, default-priority requests are shed with
RESOURCE_EXHAUSTED and a ``retry_after_s`` hint; protected traffic
(``priority == 1``, the queue policy's highest level) is always admitted
so its p99 stays bounded while the autoscaler catches up.

Unlike the reference, the core also knows which models are decoupled
(:meth:`RouterCore.model_decoupled`): the stream front ends a forwarded
request at its final frame, and only a decoupled model answers with more
than one.
"""

import asyncio
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from client_tpu_torch.grpc import _wire as wire
from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._mux import _inband_error
from client_tpu_torch.grpc._utils import is_sequence_request, request_routing_key
from client_tpu_torch.lifecycle.hedge import HedgePolicy, hedged_send_async
from client_tpu_torch.lifecycle.pool import EndpointPool, status_is_unavailable
from client_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from client_tpu_torch.router.backends import BackendLink
from client_tpu_torch.utils import InferenceServerException

# the queue policy's highest priority level (1 = highest, 0 = default);
# protected traffic is never shed at the router
PROTECTED_PRIORITY = 1

# proxy-latency buckets: the router adds ~µs-ms, not the server's
# device-scale seconds
_PROXY_BUCKETS = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
)


class RouterOverloadError(InferenceServerException):
    """The router shed this request (admission control, not a backend
    failure). The message deliberately reads "queue full" so stream-mode
    clients derive RESOURCE_EXHAUSTED from the in-band frame, and
    ``retry_after_s`` rides to the client's backoff floor (trailing
    metadata on gRPC, ``Retry-After`` header on HTTP)."""

    def __init__(self, inflight: int, limit: int, retry_after_s: float):
        super().__init__(
            f"router admission queue full: {inflight} in flight "
            f"(limit {limit}); retry after {retry_after_s:g}s",
            status="StatusCode.RESOURCE_EXHAUSTED",
        )
        self.retry_after_s = retry_after_s


class ModelTable:
    """model name → the backend urls currently advertising it ready.

    Refreshed by the readiness prober from each backend's
    ``RepositoryIndex(ready=True)``. Lookup is PERMISSIVE: a model no
    backend has advertised yet (cold start, brand-new replica) resolves
    to None (route anywhere and let the backend answer), so the table
    narrows routing when it knows better and never blackholes traffic
    when it doesn't.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._by_backend: Dict[str, frozenset] = {}

    def set_backend_models(self, url: str, models) -> None:
        with self._lock:
            self._by_backend[url] = frozenset(models)

    def drop_backend(self, url: str) -> None:
        with self._lock:
            self._by_backend.pop(url, None)

    def urls_for(self, model_name: str) -> Optional[Set[str]]:
        with self._lock:
            urls = {
                url
                for url, models in self._by_backend.items()
                if model_name in models
            }
        return urls or None

    def models(self) -> Set[str]:
        with self._lock:
            out: Set[str] = set()
            for models in self._by_backend.values():
                out |= models
            return out

    def snapshot(self) -> Dict[str, List[str]]:
        with self._lock:
            return {
                url: sorted(models)
                for url, models in self._by_backend.items()
            }


class RouterCore:
    """Routing state + forward orchestration, shared by both protocol
    fronts. Construct inside the event loop that will run the forwards
    (backend links hold the port's h2 channels).

    ``backends`` maps each backend's gRPC address to its HTTP address
    (None when the fleet runs gRPC-only: the HTTP proxy then 503s).
    """

    def __init__(
        self,
        backends: Dict[str, Optional[str]],
        routing_policy="least_outstanding",
        hedge: Optional[HedgePolicy] = None,
        max_inflight: int = 0,
        shed_retry_after_s: float = 0.25,
        attempt_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        logger=None,
        channel_factory: Optional[Callable[[str], Any]] = None,
        link_factory: Callable[..., BackendLink] = BackendLink,
    ):
        if not backends:
            raise ValueError("router needs at least one backend")
        self._clock = clock
        self.pool = EndpointPool(
            list(backends),
            routing_policy=routing_policy,
            clock=clock,
            logger=logger,
        )
        self.http_urls: Dict[str, Optional[str]] = dict(backends)
        self.hedge = hedge
        self.max_inflight = max_inflight
        self.shed_retry_after_s = shed_retry_after_s
        self.attempt_timeout_s = attempt_timeout_s
        self.logger = logger
        self.table = ModelTable()
        # model name -> whether its config declares it decoupled (learned
        # from a backend's ModelConfig; the prober forgets a name that
        # leaves or joins a backend's index)
        self.decoupled: Dict[str, bool] = {}
        self.scanner = wire.RequestScanner()
        self.links: Dict[str, BackendLink] = {}
        self._channel_factory = channel_factory
        self._link_factory = link_factory
        self._rid = itertools.count(1)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self.m_requests = Counter(
            "tpu_router_requests_total",
            "Requests through the router by protocol and outcome.",
            labelnames=("protocol", "outcome"),
            registry=self.metrics,
        )
        self.m_shed = Counter(
            "tpu_router_shed_total",
            "Requests shed by router admission control, by priority class.",
            labelnames=("priority",),
            registry=self.metrics,
        )
        self.m_retries = Counter(
            "tpu_router_backend_retries_total",
            "Forwards retried on another backend after UNAVAILABLE.",
            registry=self.metrics,
        )
        self.m_proxy = Histogram(
            "tpu_router_proxy_seconds",
            "End-to-end router forward latency (includes backend time).",
            buckets=_PROXY_BUCKETS,
            registry=self.metrics,
        )
        self.g_backends = Gauge(
            "tpu_router_backends",
            "Pool membership by health state.",
            labelnames=("state",),
            registry=self.metrics,
        )
        self.g_inflight = Gauge(
            "tpu_router_inflight",
            "Requests currently being forwarded through the router.",
            registry=self.metrics,
        )
        self.metrics.add_collect_hook(self._collect)

    # -- observability -------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def _collect(self) -> None:
        states = {"up": 0, "down": 0, "ejected": 0, "probe": 0}
        now = self._clock()
        for ep in self.pool.endpoints:
            state = ep.state(now)
            states[state] = states.get(state, 0) + 1
        for state, count in states.items():
            self.g_backends.labels(state).set(count)
        self.g_inflight.set(self._inflight)

    def snapshot(self) -> dict:
        return {
            "pool": self.pool.snapshot(),
            "models": self.table.snapshot(),
            "inflight": self._inflight,
            "max_inflight": self.max_inflight,
            "backends": {
                url: {"http": http_url}
                for url, http_url in self.http_urls.items()
            },
        }

    # -- membership (autoscaler-driven) --------------------------------------

    def add_backend(self, grpc_url: str, http_url: Optional[str] = None):
        """A replica joined the fleet: route to it as soon as the prober
        sees it ready (it enters the pool up; the first failed forward
        benches it, exactly like a seed backend)."""
        self.http_urls[grpc_url] = http_url
        return self.pool.add_endpoint(grpc_url)

    def remove_backend(self, grpc_url: str) -> Optional[BackendLink]:
        """A replica is about to drain: pull it from routing FIRST (this
        is what makes scale-in dropless: no new request targets it while
        it finishes its in-flights). Returns the retiring link; the
        caller closes it once the replica is gone."""
        if not self.pool.remove_endpoint(grpc_url):
            return None
        self.table.drop_backend(grpc_url)
        self.http_urls.pop(grpc_url, None)
        link = self.links.pop(grpc_url, None)
        if link is not None:
            link.retiring = True
        return link

    def link_for(self, url: str) -> BackendLink:
        link = self.links.get(url)
        if link is None:
            link = self._link_factory(url, self._channel_factory)
            self.links[url] = link
        return link

    async def close(self) -> None:
        links, self.links = list(self.links.values()), {}
        for link in links:
            await link.close()

    # -- admission (overload backstop) ---------------------------------------

    def admit(self, priority: int) -> None:
        """Count one request in; raises :class:`RouterOverloadError` for
        default-priority traffic past ``max_inflight``. Protected
        traffic (priority 1) is always admitted: shedding exists to
        keep ITS latency bounded through overload."""
        with self._inflight_lock:
            if (
                self.max_inflight
                and priority != PROTECTED_PRIORITY
                and self._inflight >= self.max_inflight
            ):
                self.m_shed.labels("default").inc()
                raise RouterOverloadError(
                    self._inflight,
                    self.max_inflight,
                    self.shed_retry_after_s,
                )
            self._inflight += 1

    def release(self) -> None:
        with self._inflight_lock:
            if self._inflight > 0:
                self._inflight -= 1

    # -- request classification ----------------------------------------------

    def classify(self, data) -> Tuple[str, Any, int, bool]:
        """(model_name, routing_key, priority, is_sequence) of serialized
        request bytes: the scanner's top-level walk on the fast shape, a
        one-shot message parse otherwise. Unparseable bytes classify as
        anonymous default-priority (the backend will reject them with a
        real error message)."""
        key_parameter = self.pool.key_parameter
        try:
            scanned = self.scanner.scan(bytes(data))
        except wire.WireError:
            return "", None, 0, False
        if scanned is not None:
            template, _request_id, _extra, _raws = scanned
            params = template.parameters
            key = params.get(key_parameter) if key_parameter else None
            priority = params.get("priority", 0)
            sequence = bool(params.get("sequence_id"))
            return (
                template.model_name,
                key,
                int(priority) if isinstance(priority, int) else 0,
                sequence,
            )
        try:
            request = pb.ModelInferRequest.FromString(bytes(data))
        except Exception:  # noqa: BLE001 - backend owns the rejection
            return "", None, 0, False
        key = request_routing_key(request, key_parameter)
        priority = 0
        if "priority" in request.parameters:
            priority = int(request.parameters["priority"].uint64_param)
        return request.model_name, key, priority, is_sequence_request(request)

    def next_rid(self) -> str:
        return f"r{next(self._rid)}"

    async def model_decoupled(self, model_name: str, link: BackendLink) -> bool:
        """Whether ``model_name`` answers a stream request with several
        frames (its config's ``model_transaction_policy.decoupled``), as
        the prober or ``link``'s backend reports it. A model the backend
        does not serve counts as not decoupled: its answer is one error
        frame. Raises a retryable UNAVAILABLE
        :class:`InferenceServerException` when the backend cannot say:
        the router does not guess, since a wrong guess would end a
        decoupled request at its first frame and drop the rest."""
        known = self.decoupled.get(model_name)
        if known is None:
            try:
                known = await link.model_decoupled(model_name)
            except Exception as e:  # noqa: BLE001 - unreachable, timed out
                raise InferenceServerException(
                    f"backend {link.url} unavailable: cannot read the config "
                    f"of model '{model_name}': {e}",
                    status="StatusCode.UNAVAILABLE",
                ) from e
            if known is None:
                return False
            self.decoupled[model_name] = known
        return known

    # -- forwarding ----------------------------------------------------------

    async def _attempt(self, ep, timeout: Optional[float], data) -> bytes:
        """One raw forward against a SPECIFIC backend: splice, write,
        await the correlated frame, restore the original id. Raises
        :class:`InferenceServerException` (in-band backend errors get
        their status derived from the message text, the same mapping the
        client mux applies, so drain/queue-full stay retryable)."""
        link = self.link_for(ep.url)
        rid = self.next_rid()
        payload, original = wire.splice_forward_request(data, rid)
        try:
            error_message, response = await link.unary(payload, rid, timeout)
        except asyncio.TimeoutError:
            raise InferenceServerException(
                f"backend {ep.url} timed out after {timeout}s",
                status="StatusCode.DEADLINE_EXCEEDED",
            ) from None
        if error_message:
            raise _inband_error(error_message)
        spliced, _rid = wire.splice_message_id(response, original)
        return spliced

    async def forward_unary(
        self,
        data,
        protocol: str = "grpc",
        timeout: Optional[float] = None,
    ) -> bytes:
        """Serialized ModelInferRequest bytes in, serialized
        ModelInferResponse bytes out. Owns admission, backend selection,
        UNAVAILABLE failover (and hedging when armed), and the pool's
        begin/finish/observe telemetry brackets."""
        model_name, key, priority, sequence = self.classify(data)
        try:
            self.admit(priority)
        except RouterOverloadError:
            self.m_requests.labels(protocol, "shed").inc()
            raise
        started_total = self._clock()
        outcome = "error"
        try:
            result = await self._forward_admitted(
                data, key, sequence, self.table.urls_for(model_name), timeout
            )
            outcome = "ok"
            return result
        finally:
            self.release()
            self.m_proxy.observe(self._clock() - started_total)
            self.m_requests.labels(protocol, outcome).inc()

    async def _forward_admitted(
        self,
        data,
        key,
        sequence: bool,
        allow: Optional[Set[str]],
        timeout: Optional[float],
    ) -> bytes:
        if timeout is None:
            timeout = self.attempt_timeout_s
        # sequence requests are non-idempotent: never auto-retried,
        # never hedged (mirrors the client surfaces)
        max_attempts = 1 if sequence else max(2, self.pool.size)
        exclude = None
        for attempt in range(max_attempts):
            if self.hedge is not None and not sequence:
                # the hedge orchestration owns the telemetry brackets; a
                # hedged failure skips explicit mark_down (the bracket's
                # error count and the prober converge on the bench)
                async def _pick(_timeout, exclude_ep):
                    return self.pool.pick(
                        key=key, exclude=exclude_ep, allow=allow
                    )

                try:
                    return await hedged_send_async(
                        self.pool,
                        self.hedge,
                        _pick,
                        lambda ep, t: self._attempt(ep, t, data),
                        timeout,
                    )
                except InferenceServerException as exc:
                    if (
                        attempt + 1 < max_attempts
                        and status_is_unavailable(exc.status())
                        and self.pool.has_alternative(None)
                    ):
                        self.m_retries.inc()
                        continue
                    raise
            ep = self.pool.pick(key=key, exclude=exclude, allow=allow)
            started = self.pool.begin(ep)
            try:
                result = await self._attempt(ep, timeout, data)
            except InferenceServerException as exc:
                token = exc.status()
                self.pool.finish(ep, started, ok=False, token=token)
                self.pool.observe(
                    ep,
                    ok=False,
                    token=token,
                    retry_after_s=getattr(exc, "retry_after_s", None),
                )
                if (
                    attempt + 1 < max_attempts
                    and status_is_unavailable(token)
                    and self.pool.has_alternative(ep)
                ):
                    self.m_retries.inc()
                    exclude = ep
                    continue
                raise
            self.pool.finish(ep, started, ok=True)
            self.pool.observe(ep, ok=True)
            return result
        raise InferenceServerException(  # pragma: no cover - loop always
            "router retry loop exhausted",  # returns or raises above
            status="StatusCode.UNAVAILABLE",
        )

    # -- stream front support ------------------------------------------------

    def pick_stream_backend(self, data):
        """The backend a new client stream pins to, chosen from the
        first request's classification (streams keep strict ordering and
        sequence affinity by living on ONE backend, mirroring the client
        mux's pinned-stream semantics)."""
        model_name, key, _priority, _sequence = self.classify(data)
        return self.pool.pick(key=key, allow=self.table.urls_for(model_name))

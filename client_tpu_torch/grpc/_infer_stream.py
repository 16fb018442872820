"""Bidirectional streaming machinery for the sync gRPC client.

An own copy of ``client_tpu/grpc/_infer_stream.py``. The call it reads is
the sync client's adapter over the port's aio stream
(``client_tpu_torch.grpc.SyncStreamCall``), where the reference reads a
grpcio call.

A queue-fed request iterator plus a response-reader thread invoking the
user callback — the same shape as the reference's ``_InferStream`` /
``_RequestIterator`` (reference
src/python/library/tritonclient/grpc/_infer_stream.py:39-190), with the
response-statistics bug class avoided by never assuming 1:1
request/response (decoupled models send 0..N responses per request).

Resilience: when the owning client carries a ``RetryPolicy``, a stream
torn down with ``UNAVAILABLE`` (server restart, preempted pod) is
reopened with the policy's backoff. Requests that had already been
written to the dead connection are surfaced to the callback as errors —
never silently replayed (a decoupled request is not idempotent);
requests still queued client-side carry over to the new connection
unsent-and-safe.
"""

import queue
import threading
from typing import Callable, Optional

from client_tpu_torch.grpc._infer_result import InferResult
from client_tpu_torch.grpc._utils import RpcError, StatusCode, rpc_error_to_exception
from client_tpu_torch.resilience import Deadline
from client_tpu_torch.utils import InferenceServerException

_SENTINEL = object()


class _RequestIterator:
    """Blocking iterator feeding the gRPC stream writer."""

    def __init__(self, on_send: Optional[Callable] = None):
        self._queue: "queue.Queue" = queue.Queue()
        self._on_send = on_send

    def put(self, request) -> None:
        self._queue.put(request)

    def close(self) -> None:
        self._queue.put(_SENTINEL)

    def drain_pending(self) -> list:
        """Pop everything still queued (unsent requests; used to carry
        them over to a reconnected stream). The sentinel, if queued,
        is preserved in order."""
        items = []
        while True:
            try:
                items.append(self._queue.get_nowait())
            except queue.Empty:
                return items

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            raise StopIteration
        if self._on_send is not None:
            # the stream writer consumed it: it is now in flight; pass
            # ourselves so the stream can tell live and dead writers apart
            self._on_send(item, self)
        return item


class InferStream:
    """One active bidirectional inference stream."""

    def __init__(
        self,
        callback: Callable,
        verbose: bool = False,
        retry_policy=None,
        stream_budget_s: Optional[float] = None,
    ):
        self._callback = callback
        self._verbose = verbose
        self._retry_policy = retry_policy
        # the caller's stream_timeout is a TOTAL budget: replacement
        # calls opened by reconnects get only what remains of it
        clock = retry_policy.clock if retry_policy is not None else None
        self._deadline = (
            Deadline(stream_budget_s, **({"clock": clock} if clock else {}))
            if stream_budget_s is not None
            else None
        )
        self._requests = _RequestIterator(on_send=self._note_sent)
        self._call = None
        self._reconnect: Optional[Callable] = None
        self._worker: Optional[threading.Thread] = None
        self._active = False
        self._closing = False
        self._lock = threading.Lock()
        # ids of requests written to the wire and not yet answered
        self._inflight: list = []

    def init_handler(self, call, reconnect: Optional[Callable] = None) -> None:
        """Attach the gRPC call object and start the reader thread.

        ``reconnect(request_iterator)`` (optional) opens a replacement
        call after an UNAVAILABLE teardown; reconnection only happens
        when the owning client also configured a retry policy.
        """
        self._call = call
        self._reconnect = reconnect
        self._active = True
        self._worker = threading.Thread(
            target=self._process_responses,
            name="client-tpu-grpc-stream",
            daemon=True,
        )
        self._worker.start()

    @property
    def request_iterator(self) -> _RequestIterator:
        return self._requests

    def is_active(self) -> bool:
        with self._lock:
            return self._active

    def enqueue_request(self, request) -> None:
        if not self.is_active():
            raise InferenceServerException(
                "stream is not active; call start_stream() first"
            )
        # put under the lock: a concurrent reconnect swap must not leave
        # this request stranded on the drained, dead iterator
        with self._lock:
            self._requests.put(request)

    def _deactivate(self) -> None:
        with self._lock:
            self._active = False

    # -- in-flight accounting ------------------------------------------------

    def _note_sent(self, request, iterator) -> None:
        with self._lock:
            if iterator is self._requests:
                self._inflight.append(getattr(request, "id", ""))
                return
            # a dead connection's writer consumed this after the
            # reconnect swap; the call was already torn down, so it was
            # never transmitted — carry it over unsent (safe to send,
            # not a replay). The put stays under the lock: a second
            # reconnect must not retire the target iterator between the
            # staleness check and the put.
            self._requests.put(request)

    def _note_response(self, response) -> None:
        """Retire the in-flight entry a response answers (by id when the
        server echoes one, else the oldest un-id'd entry). Decoupled
        models may send several responses per request; the first retires
        the entry, and later ones must not retire OTHER requests'
        entries — exact accounting for un-id'd decoupled requests is
        inherently approximate, so set ``request_id`` when streaming
        decoupled models under a retry policy."""
        rid = response.infer_response.id
        with self._lock:
            if rid:
                if rid in self._inflight:
                    self._inflight.remove(rid)
            elif "" in self._inflight:
                self._inflight.remove("")

    def _fail_inflight(self) -> None:
        """Surface every unanswered in-flight request as an error.

        A raising user callback must not skip the remaining
        notifications or kill the reader thread mid-teardown."""
        with self._lock:
            lost, self._inflight = self._inflight, []
        for rid in lost:
            label = f"request '{rid}'" if rid else "a request"
            try:
                error = InferenceServerException(
                    f"{label} was in flight when the stream "
                    "disconnected; it was not retried",
                    status="StatusCode.UNAVAILABLE",
                )
                # which request this error kills, for callers that
                # correlate by id
                error.request_id = rid
                self._callback(None, error)
            except Exception:  # noqa: BLE001 - user callback raised
                if self._verbose:
                    print(f"stream callback raised while failing {label}")

    # -- reader --------------------------------------------------------------

    def _swap_iterators(self) -> "_RequestIterator":
        """Replace the request iterator, carrying queued-but-unsent
        requests over. The drain happens under the lock: a concurrent
        ``enqueue_request`` (which also puts under the lock) must land
        AFTER every carried-over request, preserving stream FIFO order.
        From this point the dead connection's writer is 'stale': anything
        it still consumes is carried over by ``_note_sent`` instead of
        silently vanishing."""
        with self._lock:
            old = self._requests
            fresh = _RequestIterator(on_send=self._note_sent)
            for item in old.drain_pending():
                fresh.put(item)
            self._requests = fresh
        # unblock the dead call's writer thread, if it still waits
        old.close()
        return fresh

    def _process_responses(self) -> None:
        # the stream must read inactive once this thread exits, no
        # matter how it exits (including a user callback raising)
        try:
            self._read_loop()
        finally:
            self._deactivate()

    def _read_loop(self) -> None:
        policy = self._retry_policy
        reconnects = 0
        while True:
            try:
                for response in self._call:
                    self._note_response(response)
                    if self._verbose:
                        print(
                            f"stream response: "
                            f"{response.error_message or 'ok'}"
                        )
                    if response.error_message:
                        error = InferenceServerException(
                            response.error_message
                        )
                        # in-band errors echo the request id (when the
                        # client sent one): carry it for correlation
                        error.request_id = response.infer_response.id
                        self._callback(None, error)
                    else:
                        self._callback(
                            InferResult(response.infer_response), None
                        )
                    reconnects = 0  # a healthy read resets the budget
                return  # clean end-of-stream
            except RpcError as e:
                code = e.code()
                if code == StatusCode.CANCELLED:
                    return
                # in-flight accounting is part of the reconnect feature;
                # without a policy the legacy single-error-callback
                # semantics are preserved exactly
                if policy is not None and self._reconnect is not None:
                    backoff = policy.backoff_s(reconnects)
                    if (
                        code == StatusCode.UNAVAILABLE
                        and reconnects + 1 < policy.max_attempts
                        and not self._closing
                        and (
                            self._deadline is None
                            # same rule as the unary loop: the remaining
                            # stream budget must cover the backoff, else
                            # the reconnect would open with a floored
                            # timeout and die immediately
                            or self._deadline.remaining_s() > backoff
                        )
                    ):
                        # order matters: retire the dead writer BEFORE
                        # failing in-flight (so late sends surface as
                        # lost), and fail BEFORE the new call starts
                        # writing (so carried-over requests are not
                        # falsely reported lost)
                        fresh = self._swap_iterators()
                        self._fail_inflight()
                        policy.sleep(backoff)
                        reconnects += 1
                        if self._closing:
                            # close() arrived during the backoff: do not
                            # open a fresh connection post-close
                            self._deactivate()
                            self._callback(None, rpc_error_to_exception(e))
                            return
                        remaining = (
                            self._deadline.attempt_timeout_s()
                            if self._deadline is not None
                            else None
                        )
                        try:
                            self._call = self._reconnect(fresh, remaining)
                        except Exception:  # noqa: BLE001 - best-effort
                            pass
                        else:
                            if self._verbose:
                                print(
                                    f"stream reconnected "
                                    f"(attempt {reconnects})"
                                )
                            continue
                    else:
                        # lost with the connection: error, never replay
                        self._fail_inflight()
                self._deactivate()
                self._callback(None, rpc_error_to_exception(e))
                return
            except Exception as e:  # noqa: BLE001 - surface to callback
                # same accounting contract on non-RpcError teardowns:
                # with the reconnect feature engaged, in-flight requests
                # must still be surfaced, never silently dropped
                if policy is not None and self._reconnect is not None:
                    self._fail_inflight()
                self._deactivate()
                self._callback(None, InferenceServerException(str(e)))
                return

    def close(self, cancel_requests: bool = False) -> None:
        """End the stream. ``cancel_requests`` aborts in-flight requests."""
        self._closing = True
        if cancel_requests and self._call is not None:
            self._call.cancel()
        with self._lock:
            requests = self._requests
        requests.close()
        if self._worker is not None:
            self._worker.join(timeout=30)
            if self._worker.is_alive() and self._call is not None:
                # Server never sent the final response: force the reader out
                # so its callback cannot interleave with a later stream.
                self._call.cancel()
                self._worker.join(timeout=10)
        self._deactivate()

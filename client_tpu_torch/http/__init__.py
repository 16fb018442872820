"""Synchronous HTTP/REST client for KServe v2 inference servers.

An own copy of ``client_tpu/http/__init__.py``.

A thin synchronous veneer over the asyncio client in
``client_tpu_torch.http.aio`` (one private event-loop thread per client). Method
surface parity with the reference sync HTTP client
(reference src/python/library/tritonclient/http/_client.py:102-1500),
including ``async_infer`` which returns an :class:`InferAsyncRequest`.

Unlike the reference client (gevent-based, "not thread safe",
reference http/_client.py:102-108), this client may be used from multiple
threads: calls serialize onto the private loop's connection pool.
"""

import asyncio
import concurrent.futures
from typing import List, Optional

from client_tpu_torch._sync_runner import EventLoopRunner
from client_tpu_torch.http import aio as _aio
from client_tpu_torch.http._infer_input import InferInput
from client_tpu_torch.http._infer_result import InferResult
from client_tpu_torch.http._requested_output import InferRequestedOutput
from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "InferenceServerClient",
    "InferAsyncRequest",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
]


class InferAsyncRequest:
    """Handle to an in-flight async_infer request."""

    def __init__(
        self,
        future: concurrent.futures.Future,
        loop: Optional[asyncio.AbstractEventLoop] = None,
        task_box: Optional[List] = None,
    ):
        self._future = future
        self._loop = loop
        # the coroutine records its own asyncio task here once it starts
        # running on the client loop, so cancel() can reach it
        self._task_box = task_box if task_box is not None else []

    def get_result(self, block: bool = True, timeout: Optional[float] = None):
        """Wait for and return the :class:`InferResult`.

        Raises
        ------
        InferenceServerException
            If the request failed, was cancelled, or ``block=False`` and
            it is still in flight.
        """
        if not block and not self._future.done():
            raise InferenceServerException("request is not yet completed")
        try:
            return self._future.result(timeout)
        except concurrent.futures.TimeoutError:
            raise InferenceServerException(
                "timeout waiting for async infer result"
            ) from None
        except (concurrent.futures.CancelledError, asyncio.CancelledError):
            raise InferenceServerException(
                "request was cancelled"
            ) from None

    def cancel(self, timeout: Optional[float] = 5.0) -> bool:
        """Cancel the in-flight request; returns whether it was cancelled.

        Cancellation is propagated to the underlying asyncio task on the
        client's loop, then this waits up to ``timeout`` for the request
        to settle and reports whether it actually ended cancelled rather
        than completing first — completion can win the race, and then
        this returns False and ``get_result()`` still yields the result.
        """
        if self._future.done():
            return False
        if (
            self._task_box
            and self._loop is not None
            and not self._loop.is_closed()
        ):
            # running on the loop: cancel the task and let the outcome
            # (cancelled vs completed-first) propagate to the future

            def _cancel_task():
                for task in self._task_box:
                    if not task.done():
                        task.cancel()

            self._loop.call_soon_threadsafe(_cancel_task)
        elif self._future.cancel():
            # never started: the pending future cancels directly
            return True
        concurrent.futures.wait([self._future], timeout=timeout)
        if self._future.cancelled():
            return True
        if not self._future.done():
            return False
        return isinstance(self._future.exception(), asyncio.CancelledError)


def _delegated(name, doc_source=None):
    """Build a sync method delegating to the aio client's coroutine."""

    def method(self, *args, **kwargs):
        return self._runner.run(getattr(self._aio_client, name)(*args, **kwargs))

    method.__name__ = name
    src = doc_source or getattr(_aio.InferenceServerClient, name, None)
    if src is not None and src.__doc__:
        method.__doc__ = src.__doc__
    return method


class InferenceServerClient:
    """Synchronous client for the KServe v2 HTTP/REST protocol."""

    def __init__(
        self,
        url=None,
        verbose: bool = False,
        concurrency: int = 16,
        connection_timeout: float = 60.0,
        network_timeout: float = 60.0,
        ssl: bool = False,
        ssl_context=None,
        retry_policy=None,
        circuit_breaker=None,
        tracer=None,
        urls=None,
        endpoint_cooldown_s: float = 1.0,
        logger=None,
        routing_policy=None,
        hedge_policy=None,
    ):
        """``url`` may be a single ``host:port``, a comma list, or an
        :class:`~client_tpu_torch.lifecycle.EndpointPool`; ``urls=[...]`` names
        replica endpoints for health-checked failover, ``routing_policy``
        selects among them (round_robin / least_outstanding / p2c /
        consistent_hash) and ``hedge_policy`` arms tail hedging (see the
        aio client's docs — this veneer passes all of it straight
        through)."""
        self._runner = EventLoopRunner(name=f"client-tpu-http[{url}]")
        self._aio_client = _aio.InferenceServerClient(
            url,
            verbose=verbose,
            concurrency=concurrency,
            connection_timeout=connection_timeout,
            network_timeout=network_timeout,
            ssl=ssl,
            ssl_context=ssl_context,
            retry_policy=retry_policy,
            circuit_breaker=circuit_breaker,
            tracer=tracer,
            urls=urls,
            endpoint_cooldown_s=endpoint_cooldown_s,
            logger=logger,
            routing_policy=routing_policy,
            hedge_policy=hedge_policy,
        )

    # plugin registry delegates to the aio client so headers flow through it
    def register_plugin(self, plugin):
        self._aio_client.register_plugin(plugin)

    def plugin(self):
        return self._aio_client.plugin()

    def unregister_plugin(self):
        self._aio_client.unregister_plugin()

    def endpoint_snapshot(self) -> dict:
        """Live per-endpoint pool telemetry (see
        :meth:`~client_tpu_torch.lifecycle.EndpointPool.snapshot`); sync read
        of the aio client's pool — no loop hop needed."""
        return self._aio_client.endpoint_snapshot()

    # health
    is_server_live = _delegated("is_server_live")
    is_server_ready = _delegated("is_server_ready")
    is_model_ready = _delegated("is_model_ready")
    # metadata / config
    get_server_metadata = _delegated("get_server_metadata")
    get_model_metadata = _delegated("get_model_metadata")
    get_model_config = _delegated("get_model_config")
    # repository
    get_model_repository_index = _delegated("get_model_repository_index")
    load_model = _delegated("load_model")
    unload_model = _delegated("unload_model")
    # statistics / settings
    get_inference_statistics = _delegated("get_inference_statistics")
    update_trace_settings = _delegated("update_trace_settings")
    get_trace_settings = _delegated("get_trace_settings")
    update_log_settings = _delegated("update_log_settings")
    get_log_settings = _delegated("get_log_settings")
    # shared memory
    get_system_shared_memory_status = _delegated("get_system_shared_memory_status")
    register_system_shared_memory = _delegated("register_system_shared_memory")
    unregister_system_shared_memory = _delegated("unregister_system_shared_memory")
    get_cuda_shared_memory_status = _delegated("get_cuda_shared_memory_status")
    register_cuda_shared_memory = _delegated("register_cuda_shared_memory")
    unregister_cuda_shared_memory = _delegated("unregister_cuda_shared_memory")
    get_tpu_shared_memory_status = _delegated("get_tpu_shared_memory_status")
    register_tpu_shared_memory = _delegated("register_tpu_shared_memory")
    unregister_tpu_shared_memory = _delegated("unregister_tpu_shared_memory")
    # inference
    infer = _delegated("infer")
    infer_with_body = _delegated("infer_with_body")

    generate_request_body = staticmethod(
        _aio.InferenceServerClient.generate_request_body
    )
    parse_response_body = staticmethod(
        _aio.InferenceServerClient.parse_response_body
    )

    def async_infer(self, model_name, inputs, **kwargs) -> InferAsyncRequest:
        """Issue an inference without blocking; returns a request handle.

        ``callback``, if given, is invoked as ``callback(result, error)``
        from the client's loop thread when the request completes.
        """
        callback = kwargs.pop("callback", None)
        task_box: list = []

        async def _tracked():
            # record the task so InferAsyncRequest.cancel() can reach the
            # coroutine after it has started running on the loop
            task_box.append(asyncio.current_task())
            return await self._aio_client.infer(model_name, inputs, **kwargs)

        future = self._runner.submit(_tracked())
        if callback is not None:

            def _done(f: concurrent.futures.Future):
                result, error = None, None
                try:
                    result = f.result()
                except (
                    concurrent.futures.CancelledError,
                    asyncio.CancelledError,
                ):
                    error = InferenceServerException("request was cancelled")
                except Exception as e:  # noqa: BLE001 - surface to callback
                    error = e
                callback(result, error)

            future.add_done_callback(_done)
        return InferAsyncRequest(future, loop=self._runner.loop, task_box=task_box)

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Close the connection pool and stop the loop thread."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        try:
            self._runner.run(self._aio_client.close(), timeout=timeout)
        except Exception:
            pass  # pool teardown is best-effort; the loop stops regardless
        finally:
            self._runner.close()

    def __enter__(self) -> "InferenceServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort cleanup, mirrors close()
        try:
            if self.__dict__.get("_closed", False):
                return
            self.close(timeout=5.0)
        except Exception:
            pass

"""A background event loop for exposing the asyncio clients synchronously.

An own copy of ``client_tpu/_sync_runner.py``.

The reference built its sync HTTP client on gevent greenlets and later added
separate aio implementations; here the asyncio implementation is primary and
sync surfaces delegate to it through one dedicated loop thread per client.
"""

import asyncio
import atexit
import concurrent.futures
import threading
from typing import Any, Coroutine, Optional


class EventLoopRunner:
    """Owns a daemon thread running an asyncio event loop."""

    def __init__(self, name: str = "client-tpu-loop"):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()
        atexit.register(self.close)

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        self._loop.run_forever()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop

    def submit(self, coro: Coroutine) -> concurrent.futures.Future:
        """Schedule ``coro`` on the loop; returns a concurrent Future."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def run(self, coro: Coroutine, timeout: Optional[float] = None) -> Any:
        """Run ``coro`` to completion and return its result (blocking)."""
        if threading.current_thread() is self._thread:
            # Blocking on our own loop would deadlock (e.g. GC finalizers
            # running on the loop thread); fail fast instead.
            coro.close()
            raise RuntimeError(
                "EventLoopRunner.run called from its own loop thread"
            )
        return self.submit(coro).result(timeout)

    def close(self) -> None:
        if self._loop.is_closed():
            return
        if self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
        if not self._loop.is_closed():
            self._loop.close()
        try:
            atexit.unregister(self.close)
        except Exception:
            pass

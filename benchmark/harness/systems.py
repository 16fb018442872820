"""The system under test: the port's model for a configuration, served
in this process by the port's own server.

A configuration's ``serve.system`` names its model type, a file of its
own: ``systems/<system>.py`` (:func:`load`), which defines :data:`NAMES`.
It draws the weights the benchmark hands the program, builds the port's
model on them, warms the shapes its traffic reaches, reads the program's
counters, compares the served answers with the plain reference, and cuts
the configuration and its traffic to a tiny size for the CPU tests.
Everything else (the engine, its pages, the batcher, the front-end) is
the port's, served by :class:`Server`. In traced runs :class:`Spans`
times the model's device calls from the outside: an engine's prefill
and decode callables (:meth:`Spans.wrap_engine`) and an encoder's
executions (:meth:`Spans.wrap_execute`).
"""

import asyncio
import importlib.util
import threading
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
# what a model type's file defines:
#   weights(sizes, seed, device): the weights from the seed, on ``device``
#   build(config, sizes, weights, device, spans): the port's model, not
#       yet loaded, served under the name of its system
#   warm(config, model, mix): run once every shape the mix reaches that
#       the served path does not meet before the window by itself
#   counters(model, server): the program's counters, kept at the window's
#       opening and closing (``run.counters``)
#   compare(run, weights, control): the numbers that decide ``correct``,
#       each beside its limit (``check.py`` holds the comparisons)
#   tiny(config, mix): cut the configuration and its mix, in place, to a
#       size a CPU test runs in seconds, with the limits for float32
#   INFER_TENSORS: (input, output), the tensors the ``kserve_infer``
#       route sends and reads
NAMES = ("weights", "build", "warm", "counters", "compare", "tiny", "INFER_TENSORS")


def load(system: str):
    """The model type ``system``: the module ``systems/<system>.py``."""
    path = BENCH / "systems" / f"{system}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no model type {system!r}: there is no {path}")
    spec = importlib.util.spec_from_file_location(f"bench_system_{system.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [name for name in NAMES if not hasattr(module, name)]
    if missing:
        raise AttributeError(f"{path} does not define {', '.join(missing)}")
    return module


def sizes_of(config: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration's sizes with the derived ones filled in."""
    sizes = dict(config)
    sizes.setdefault("head_dim", config["hidden_size"] // config["num_attention_heads"])
    sizes.setdefault("num_key_value_heads", config["num_attention_heads"])
    sizes["torch_dtype"] = config["serve"]["dtype"]
    return sizes


class Spans:
    """Host-clock spans (``time.monotonic_ns``) of the model's device
    calls, each ended by the call's own device-to-host read. A decode
    span keeps what its attention launches read: the visible slots of
    every lane and the table width. Under a profiler each call is also a
    ``record_function`` range named after it."""

    def __init__(self):
        self.prefill: List[tuple] = []
        self.decode: List[tuple] = []
        self.execute: List[tuple] = []
        self.windows = None

    def _around(self, call):
        """Run ``call`` with a profiler window opened or closed around it
        when :attr:`windows` (a :class:`devtrace.CallWindows`) asks: on
        the thread that runs the device calls, between two of them."""
        windows = self.windows
        if windows is None:
            return call()
        windows.before_call()
        try:
            return call()
        finally:
            windows.after_call()

    def wrap_engine(self, prefill, decode, decode_multi):
        from torch.profiler import record_function

        def timed_prefill(tokens, page_table, pages, last_index, start_index):
            t0 = time.monotonic_ns()
            with record_function("bench.prefill"):
                out = self._around(lambda: prefill(tokens, page_table, pages, last_index,
                                                   start_index))
            self.prefill.append((t0, time.monotonic_ns(), int(last_index) + 1))
            return out

        def timed_decode(tokens, positions, page_tables, pages):
            t0 = time.monotonic_ns()
            with record_function("bench.decode"):
                out = self._around(lambda: decode(tokens, positions, page_tables, pages))
            contexts = (np.asarray(positions, dtype=np.int64) + 1).tolist()
            self.decode.append((t0, time.monotonic_ns(), contexts,
                                int(np.shape(page_tables)[1])))
            return out

        return timed_prefill, timed_decode, decode_multi

    def wrap_execute(self, model):
        from torch.profiler import record_function

        execute = model.execute

        def timed_execute(inputs, parameters):
            t0 = time.monotonic_ns()
            with record_function("bench.execute"):
                out = self._around(lambda: execute(inputs, parameters))
            self.execute.append((t0, time.monotonic_ns()))
            return out

        model.execute = timed_execute


class Server:
    """The port's ``ServerCore`` and HTTP front-end on a loopback port,
    serving one model, with its event loop on a thread of its own."""

    def __init__(self, model, device: str):
        from client_tpu_torch.server.core import ServerCore
        from client_tpu_torch.server.http_server import serve_http
        from client_tpu_torch.server.model_repository import ModelRepository

        self.model = model
        t0 = time.monotonic_ns()
        repository = ModelRepository()
        repository.add_model(model)
        for entry in repository.index():
            if entry["state"] != "READY":
                raise RuntimeError(f"{entry['name']} did not load: {entry.get('reason')}")
        t1 = time.monotonic_ns()
        self.core = ServerCore(repository, max_workers=4, device=device)
        # seconds of the model's load (its warm-up) and of the core's set-up
        self.load_s, self.core_s = (t1 - t0) / 1e9, (time.monotonic_ns() - t1) / 1e9
        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        box = {}

        def run_loop():
            asyncio.set_event_loop(self.loop)
            try:
                box["server"] = self.loop.run_until_complete(
                    serve_http(self.core, "127.0.0.1", 0))
            except BaseException as e:  # noqa: BLE001 - reported to the caller below
                box["error"] = e
            finally:
                started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run_loop, name="bench-server", daemon=True)
        self.thread.start()
        started.wait(120)
        if "server" not in box:
            self.stop()
            raise RuntimeError(f"the HTTP front-end did not start: {box.get('error')}")
        self._http = box["server"]
        self.port = self._http.port

    def statistics(self) -> Dict[str, Any]:
        """The statistics route's document for the served model, as
        ``GET /v2/models/<name>/stats`` answers it."""
        import json
        import urllib.request

        url = f"http://127.0.0.1:{self.port}/v2/models/{self.model.name}/stats"
        with urllib.request.urlopen(url, timeout=30) as response:
            return json.loads(response.read())["model_stats"][0]

    def stop(self) -> None:
        """Close the front-end, the core and the engine, then the loop."""
        async def close():
            if getattr(self, "_http", None) is not None:
                await self._http.close()
            self.core.close()
            others = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            await asyncio.gather(*others, return_exceptions=True)

        if self.loop.is_running():
            asyncio.run_coroutine_threadsafe(close(), self.loop).result(120)
            self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(120)

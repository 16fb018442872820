"""The system under test: the port's model for a configuration, served
in this process by the port's own server.

A configuration's ``serve.system`` names the port's model type that
serves it (``llm_engine``: :class:`LlmEngineModel`; ``text_encoder``:
:class:`TextEncoderModel`). The benchmark hands it the weights it made;
everything else (the engine, its pages, the batcher, the front-end) is
the port's. In traced runs :class:`Spans` times the model's device calls
from the outside: the engine's prefill and decode callables (through the
model's ``device_fn_wrapper`` hook) and the encoder's executions.
"""

import asyncio
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

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


def build_model(config: Dict[str, Any], weights: Dict[str, Any], device: str,
                spans: Optional[Spans]):
    """The port's model for ``config``, on ``weights``, served under the
    name of its system; not yet loaded."""
    serve = config["serve"]
    sizes = sizes_of(config)
    system = serve["system"]
    if system == "llm_engine":
        import torch

        from client_tpu_torch.llm.engine import EngineConfig
        from client_tpu_torch.llm.serving import LlmEngineModel
        from client_tpu_torch.models import llama

        model_config = llama.LlamaConfig(
            vocab_size=sizes["vocab_size"], d_model=sizes["hidden_size"],
            n_layers=sizes["num_hidden_layers"], n_heads=sizes["num_attention_heads"],
            n_kv_heads=sizes["num_key_value_heads"], d_ff=sizes["intermediate_size"],
            max_seq_len=serve["max_seq_len"], rope_theta=float(sizes["rope_theta"]),
            norm_eps=float(sizes["rms_norm_eps"]), dtype=getattr(torch, serve["dtype"]))
        engine = dict(serve["engine"])
        engine_config = EngineConfig(max_seq_len=serve["max_seq_len"], **engine)
        model = LlmEngineModel(name=system, config=model_config, params=weights,
                               engine_config=engine_config, device=device)
        if spans is not None:
            model.device_fn_wrapper = spans.wrap_engine
        return model
    if system == "text_encoder":
        import torch

        from client_tpu_torch.models import bert
        from client_tpu_torch.models.serving import TextEncoderModel

        model_config = bert.BertConfig(
            vocab_size=sizes["vocab_size"], d_model=sizes["hidden_size"],
            n_layers=sizes["num_hidden_layers"], n_heads=sizes["num_attention_heads"],
            d_ff=sizes["intermediate_size"], max_seq_len=sizes["max_position_embeddings"],
            pad_token_id=sizes["pad_token_id"], norm_eps=float(sizes["layer_norm_eps"]),
            dtype=getattr(torch, serve["dtype"]))
        model = TextEncoderModel(name=system, config=model_config,
                                 params=weights, device=device)
        model.max_batch_size = int(serve["max_batch_size"])
        if spans is not None:
            spans.wrap_execute(model)
        return model
    raise ValueError(f"unknown system {system!r}")


def warm_shapes(config: Dict[str, Any], model, mix: Dict[str, Any]) -> None:
    """Run once every execution shape the mix can reach that the served
    path does not meet before the window by itself. The encoder's: every
    row bucket up to the batch limit by every length bucket of the mix's
    lengths. The engine's warm-up probes and the ramp cover its own."""
    if config["serve"]["system"] != "text_encoder":
        return
    spec = mix["input_tokens"]
    rows, lengths = [], []
    r = 1
    while r <= model.max_batch_size:
        rows.append(r)
        r *= 2
    n = 8
    while n < spec["max"]:
        n *= 2
        if n >= spec["min"]:
            lengths.append(n)
    for r in rows:
        for n in lengths:
            model.execute({"INPUT_IDS": np.ones([r, n], dtype=np.int32)}, {})


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

"""The port's HTTP front-end, on loopback, over the tiny fp32 Llama on CPU.

The server runs in-process on its own event-loop thread; requests go
over real sockets with ``http.client``. A streamed chat completion must
carry exactly the token ids JAX ``llama.generate`` produces for the same
``SyntheticTokenizer`` ids on the same weights.
"""

import asyncio
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import llama as jax_llama
from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
from client_tpu_torch.llm.engine import EngineConfig
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama
from client_tpu_torch.server.core import ServerCore
from client_tpu_torch.server.http_server import serve_http
from client_tpu_torch.server.model_repository import ModelRepository

torch.set_num_threads(1)

JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)
PROMPT = "the quick brown fox jumps over the lazy dog"


@pytest.fixture(scope="module")
def server():
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))(
        jax.random.PRNGKey(0)
    )
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    repository = ModelRepository()
    repository.add_model(
        LlmEngineModel(
            config=llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32),
            params=params,
            engine_config=EngineConfig(block_size=8, num_blocks=65, max_seq_len=64),
            device="cpu",
        )
    )
    core = ServerCore(repository, max_workers=2)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    box = {}

    def run():
        asyncio.set_event_loop(loop)
        box["http"] = loop.run_until_complete(serve_http(core, "127.0.0.1", 0))
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(30)
    yield box["http"].port, jax_params

    async def stop():
        await box["http"].close()
        core.close()
        others = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        await asyncio.gather(*others, return_exceptions=True)

    asyncio.run_coroutine_threadsafe(stop(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(30)
    assert not thread.is_alive()
    loop.close()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        payload = None if body is None else json.dumps(body)
        conn.request(method, path, body=payload, headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        return response.status, response.read()
    finally:
        conn.close()


def _jax_tokens(jax_params, text, max_tokens):
    ids = SyntheticTokenizer(JAX_CONFIG.vocab_size).encode(text)
    generate = jax.jit(lambda p, t: jax_llama.generate(p, t, JAX_CONFIG, max_tokens))
    return np.asarray(generate(jax_params, np.array([ids], dtype=np.int32)))[0].tolist()


def test_health_and_model_config(server):
    port, _ = server
    assert _request(port, "GET", "/v2/health/live")[0] == 200
    assert _request(port, "GET", "/v2/health/ready")[0] == 200
    status, body = _request(port, "GET", "/v2/models/llm_engine/config")
    assert status == 200
    assert json.loads(body)["parameters"]["decode_kernel"]["string_value"] == "fused"
    status, body = _request(port, "GET", "/v1/models")
    assert [m["id"] for m in json.loads(body)["data"]] == ["llm_engine"]


def test_streamed_chat_completion_carries_jax_generate_tokens(server):
    port, jax_params = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    body = {"model": "llm_engine", "messages": [{"role": "user", "content": PROMPT}],
            "max_tokens": 8, "stream": True}
    conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    response = conn.getresponse()
    assert response.status == 200
    assert response.getheader("Content-Type") == "text/event-stream"
    events = [line[len(b"data: "):].strip() for line in response.read().splitlines()
              if line.startswith(b"data: ")]
    conn.close()
    assert events[-1] == b"[DONE]"
    chunks = [json.loads(event) for event in events[:-1]]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    tokens = [int(word[len("tok"):]) for word in text.split()]
    assert tokens == _jax_tokens(jax_params, PROMPT, 8)


def test_unstreamed_completion_matches_the_stream(server):
    port, jax_params = server
    status, body = _request(port, "POST", "/v1/completions",
                            {"model": "llm_engine", "prompt": PROMPT, "max_tokens": 8})
    assert status == 200
    doc = json.loads(body)
    tokens = [int(word[len("tok"):]) for word in doc["choices"][0]["text"].split()]
    assert tokens == _jax_tokens(jax_params, PROMPT, 8)
    assert doc["usage"]["completion_tokens"] == 8


@pytest.mark.parametrize("max_tokens", [0, -3, "8", 2.5, True, 10 ** 9])
def test_bad_max_tokens_is_a_400(server, max_tokens):
    port, _ = server
    status, body = _request(port, "POST", "/v1/chat/completions",
                            {"model": "llm_engine", "messages": [{"content": PROMPT}],
                             "max_tokens": max_tokens})
    assert status == 400
    assert json.loads(body)["error"]["param"] == "max_tokens"


@pytest.mark.parametrize(
    "method,path,body,status",
    [
        ("POST", "/v1/chat/completions", {"model": "nope", "messages": []}, 404),
        ("GET", "/v2/models/nope/config", None, 400),
        ("GET", "/v2/no/such/route", None, 404),
        ("GET", "/v1/chat/completions", None, 405),
        ("POST", "/v1/chat/completions",
         {"model": "llm_engine", "messages": ["not an object"]}, 400),
        ("POST", "/v1/chat/completions", [1, 2], 400),
        # prompt (9 words) + max_tokens past the model's 64-token context
        ("POST", "/v1/chat/completions",
         {"model": "llm_engine", "messages": [{"content": PROMPT}], "max_tokens": 60,
          "stream": True}, 400),
    ],
    ids=["unknown-model", "unknown-config", "no-route", "wrong-method", "bad-messages",
         "body-not-object", "too-long"],
)
def test_error_statuses(server, method, path, body, status):
    port, _ = server
    assert _request(port, method, path, body)[0] == status


def test_connection_is_kept_alive_across_requests(server):
    port, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for _ in range(3):
            conn.request("GET", "/v2/health/ready")
            response = conn.getresponse()
            response.read()
            assert response.status == 200
    finally:
        conn.close()

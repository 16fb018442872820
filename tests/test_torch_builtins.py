"""The port's remaining built-ins and ``llm_decode`` against the JAX server.

Two in-process servers on ``127.0.0.1``: the JAX package's
(``client_tpu.testing.InProcessServer``, its built-ins) and the port's
(``client_tpu_torch.testing.InProcessServer``, its built-ins on
``device="cpu"``), each with ``llm_decode`` on the tiny fp32 Llama, the
port's weights carried from the JAX ones by ``llama.params_from_jax``.
Inputs are made with numpy from a seed. The repo's own client sends both
servers the same requests; the streams go through each server's
``ServerCore.infer_decoupled``.

- ``add_sub_chain`` (``simple`` -> ``simple``) answers exactly
  ``2 * INPUT0`` and ``2 * INPUT1`` on both sides;
- ``sequence_accumulate`` gives the same running sums, across the int32
  wrap, and the same error messages;
- ``repeat_int32`` gives the same streams and final flags, and ``/infer``
  refuses it on both sides;
- the three models' configs are equal (the framework name aside);
- ``llm_decode`` streams the reference's tokens for prompts of 5, 8 and
  13 tokens (across the reference's prefill buckets), refuses an
  overlong request with the reference's message, and is the OpenAI
  route's default model on both sides.
"""

import asyncio
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import client_tpu.http as httpclient
from client_tpu.models import llama as jax_llama
from client_tpu.models.serving import LlmDecodeModel as JaxLlmDecodeModel
from client_tpu.server.core import CoreRequest as JaxCoreRequest
from client_tpu.server.core import CoreTensor as JaxCoreTensor
from client_tpu.testing import InProcessServer as JaxInProcessServer
from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
from client_tpu_torch.models import llama
from client_tpu_torch.models.serving import LlmDecodeModel
from client_tpu_torch.server.core import CoreRequest, CoreTensor
from client_tpu_torch.testing import InProcessServer

torch.set_num_threads(1)

MAX_SEQ = 64
JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=jnp.float32)
CONFIG = llama.LlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=torch.float32)
SIDES = ("jax", "torch")


@pytest.fixture(scope="module")
def servers():
    jax_params = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))(
        jax.random.PRNGKey(0))
    reference = JaxInProcessServer(grpc=False).start()
    reference.core.repository.add_model(
        JaxLlmDecodeModel(config=JAX_CONFIG, params=jax_params))
    port = InProcessServer(device="cpu").start()
    port.core.repository.add_model(LlmDecodeModel(
        config=CONFIG,
        params=llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu"),
        device="cpu"))
    for server in (reference, port):
        assert [e["name"] for e in server.core.repository.index()
                if e["state"] != "READY"] == []
    clients = {
        "jax": httpclient.InferenceServerClient(reference.http_url),
        "torch": httpclient.InferenceServerClient(port.http_url),
    }
    yield {"servers": {"jax": reference, "torch": port}, "clients": clients}
    for client in clients.values():
        client.close()
    port.stop()
    reference.stop()


def _int32_inputs(rows, rng):
    a = rng.integers(-2**20, 2**20, size=[rows, 16], dtype=np.int32)
    b = rng.integers(-2**20, 2**20, size=[rows, 16], dtype=np.int32)
    inputs = [httpclient.InferInput("INPUT0", [rows, 16], "INT32"),
              httpclient.InferInput("INPUT1", [rows, 16], "INT32")]
    inputs[0].set_data_from_numpy(a)
    inputs[1].set_data_from_numpy(b)
    return a, b, inputs


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_add_sub_chain_is_exact_on_both_sides(servers, rows):
    a, b, inputs = _int32_inputs(rows, np.random.default_rng(rows))
    for side in SIDES:
        result = servers["clients"][side].infer("add_sub_chain", inputs)
        assert np.array_equal(result.as_numpy("OUTPUT0"), 2 * a), side
        assert np.array_equal(result.as_numpy("OUTPUT1"), 2 * b), side


def _accumulate(client, seq_id, value, start=False, end=False):
    inp = httpclient.InferInput("INPUT", [1], "INT32")
    inp.set_data_from_numpy(np.array([value], dtype=np.int32))
    return client.infer("sequence_accumulate", [inp], sequence_id=seq_id,
                        sequence_start=start, sequence_end=end)


def test_sequence_accumulate_sums_across_the_int32_wrap(servers):
    rng = np.random.default_rng(0)
    # large values, so the running sum crosses the int32 range both ways
    values = [int(v) for v in rng.integers(2**30, 2**31 - 1, size=6)]
    values += [int(v) for v in rng.integers(-2**31, -2**30, size=6)]
    sums = {}
    for side in SIDES:
        client = servers["clients"][side]
        out = []
        for i, value in enumerate(values):
            result = _accumulate(client, 7, value, start=i == 0, end=i == len(values) - 1)
            out.append(int(result.as_numpy("OUTPUT")[0]))
        sums[side] = out
    assert sums["jax"] == sums["torch"]
    wrapped = np.cumsum(np.array(values, dtype=np.int64))
    assert sums["torch"] == [int(v) for v in wrapped.astype(np.uint32).astype(np.int32)]
    assert any(v != w for v, w in zip(sums["torch"], wrapped))  # it did wrap


@pytest.mark.parametrize("case", ["zero_id", "no_start", "after_end"])
def test_sequence_accumulate_errors_match(servers, case):
    messages = {}
    for side in SIDES:
        client = servers["clients"][side]
        with pytest.raises(Exception) as info:
            if case == "zero_id":
                _accumulate(client, 0, 1, start=True)
            elif case == "no_start":
                _accumulate(client, 4242, 1)
            else:
                _accumulate(client, 31, 1, start=True, end=True)
                _accumulate(client, 31, 2)
        messages[side] = info.value.message()
    assert messages["jax"] == messages["torch"]
    assert "sequence" in messages["torch"]


async def _stream(core, request_type, tensor_type, name, values, parameters):
    request = request_type(model_name=name, parameters=dict(parameters))
    data = np.asarray(values, dtype=np.int32)
    request.inputs.append(tensor_type(
        "INPUT_IDS" if name == "llm_decode" else "IN", "INT32", list(data.shape), data))
    out = []
    async for response in core.infer_decoupled(request):
        tokens = [int(v) for t in response.outputs for v in np.asarray(t.data).reshape(-1)]
        out.append((tokens, bool(response.parameters.get("triton_final_response"))))
    return out


def _both_streams(servers, name, values, parameters):
    return {
        "jax": asyncio.run(_stream(servers["servers"]["jax"].core, JaxCoreRequest,
                                   JaxCoreTensor, name, values, parameters)),
        "torch": asyncio.run(_stream(servers["servers"]["torch"].core, CoreRequest,
                                     CoreTensor, name, values, parameters)),
    }


@pytest.mark.parametrize("length,delay_us", [(1, 0), (5, 200), (9, 0)])
def test_repeat_int32_streams_match(servers, length, delay_us):
    values = np.random.default_rng(length).integers(-1000, 1000, size=length)
    streams = _both_streams(servers, "repeat_int32", values, {"delay_us": delay_us})
    assert streams["jax"] == streams["torch"]
    assert [t for t, _ in streams["torch"]] == [[int(v)] for v in values]
    assert [f for _, f in streams["torch"]] == [False] * (length - 1) + [True]


def test_infer_on_repeat_is_refused_on_both_sides(servers):
    inp = httpclient.InferInput("IN", [3], "INT32")
    inp.set_data_from_numpy(np.arange(3, dtype=np.int32))
    messages = {}
    for side in SIDES:
        with pytest.raises(Exception) as info:
            servers["clients"][side].infer("repeat_int32", [inp])
        messages[side] = info.value.message()
    assert messages["jax"] == messages["torch"]
    assert "is decoupled; use streaming" in messages["torch"]


@pytest.mark.parametrize("model", ["sequence_accumulate", "add_sub_chain", "repeat_int32"])
def test_configs_equal_the_jax_servers(servers, model):
    docs = {side: servers["clients"][side].get_model_config(model) for side in SIDES}
    if model != "add_sub_chain":  # the ensemble's platform is "ensemble" on both
        for doc in docs.values():
            doc.pop("platform")
            doc.pop("backend")
    assert docs["torch"] == docs["jax"]
    assert ("dynamic_batching" in docs["torch"]) == (model not in (
        "sequence_accumulate", "add_sub_chain", "repeat_int32"))


@pytest.mark.parametrize("prompt_len", [5, 8, 13])
def test_llm_decode_streams_equal_the_reference(servers, prompt_len):
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(1, CONFIG.vocab_size, size=prompt_len)
    streams = _both_streams(servers, "llm_decode", prompt, {"max_tokens": 12})
    assert streams["torch"] == streams["jax"]
    assert len(streams["torch"]) == 12 and streams["torch"][-1][1]
    # and the dense oracle's greedy tokens
    want = llama.generate(
        servers["servers"]["torch"].core.repository.get("llm_decode")._params,
        torch.from_numpy(prompt[None].astype(np.int32)), CONFIG, 12)[0].tolist()
    assert [t[0] for t, _ in streams["torch"]] == want


def test_llm_decode_refuses_an_overlong_request_as_the_reference(servers):
    messages = {}
    for side, request_type, tensor_type in (("jax", JaxCoreRequest, JaxCoreTensor),
                                            ("torch", CoreRequest, CoreTensor)):
        with pytest.raises(Exception) as info:
            asyncio.run(_stream(servers["servers"][side].core, request_type, tensor_type,
                                "llm_decode", np.ones(20), {"max_tokens": MAX_SEQ}))
        messages[side] = info.value.message()
    assert messages["jax"] == messages["torch"]
    assert "exceeds max sequence length" in messages["torch"]


def _chat(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    response = conn.getresponse()
    payload = response.read()
    conn.close()
    return response.status, payload


def test_llm_decode_is_the_openai_default_on_both_sides(servers):
    text = "the quick brown fox"
    body = {"messages": [{"role": "user", "content": text}], "max_tokens": 6}
    for side in SIDES:
        status, payload = _chat(servers["servers"][side].http_port, body)
        assert status == 200, (side, payload)
        assert json.loads(payload)["model"] == "llm_decode"
    # the port's answer is llm_decode's greedy stream of the prompt
    doc = json.loads(_chat(servers["servers"]["torch"].http_port, body)[1])
    words = doc["choices"][0]["message"]["content"].split()
    ids = SyntheticTokenizer(CONFIG.vocab_size).encode(text)
    stream = _both_streams(servers, "llm_decode", ids, {"max_tokens": 6})["torch"]
    assert [int(w[len("tok"):]) for w in words] == [t[0] for t, _ in stream]

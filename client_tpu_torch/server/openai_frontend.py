"""OpenAI-compatible routes: chat/completions with SSE streaming.

Requests are tokenized with the deterministic synthetic tokenizer (its
vocabulary sized to the target model's, so every id is one the model can
embed), driven through a decoupled LLM model (INPUT_IDS -> OUTPUT_IDS)
and streamed back as one SSE event per generated token.
"""

import json
import time
from typing import Any, AsyncIterator, Dict, Optional

import numpy as np

from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer
from client_tpu_torch.server.core import CoreRequest, CoreTensor, ServerCore
from client_tpu_torch.server.http_server import (
    Request,
    Response,
    error_response,
    json_response,
)
from client_tpu_torch.server.model_repository import STATE_READY
from client_tpu_torch.utils import InferenceServerException

# Hard ceiling for the request-body max_tokens field: far above any model
# this stack serves, small enough that a client typo fails fast with a
# 400 instead of erroring mid-stream after the SSE 200 is committed.
MAX_TOKENS_CAP = 131072


def _messages_to_prompt(body: Dict[str, Any]) -> str:
    if "messages" in body:
        return "\n".join(str(m.get("content", "")) for m in body.get("messages", []))
    return str(body.get("prompt", ""))


def _mapped_error(e: InferenceServerException) -> Response:
    """A core exception in the OpenAI body shape, ``{"error": {"message":
    ...}}``, with its own status and ``Retry-After`` (the JAX server's
    ``_mapped_error``)."""
    response = error_response(e)
    response.body = json.dumps({"error": {"message": e.message()}}).encode()
    return response


def _invalid_request(message: str, param: str) -> Response:
    """OpenAI-style 400 error body (error.type/param/code)."""
    return json_response(
        {
            "error": {
                "message": message,
                "type": "invalid_request_error",
                "param": param,
                "code": "invalid_value",
            }
        },
        status=400,
    )


def _sampling(body: Dict[str, Any]):
    """(engine sampling parameters, None) or (None, a 400 response) from
    the body's temperature / seed / top_k fields."""
    sampling: Dict[str, Any] = {}
    temperature = body.get("temperature")
    if temperature is not None:
        if isinstance(temperature, bool) or not isinstance(
            temperature, (int, float)
        ) or temperature < 0:
            return None, _invalid_request(
                f"temperature must be a non-negative number, got {temperature!r}",
                "temperature",
            )
        sampling["temperature"] = float(temperature)
    seed = body.get("seed")
    if seed is not None:
        if isinstance(seed, bool) or not isinstance(seed, int):
            return None, _invalid_request(f"seed must be an integer, got {seed!r}", "seed")
        sampling["seed"] = seed
    top_k = body.get("top_k")
    if top_k is not None:
        if isinstance(top_k, bool) or not isinstance(top_k, int) or top_k < 0:
            return None, _invalid_request(
                f"top_k must be a non-negative integer, got {top_k!r}", "top_k"
            )
        sampling["top_k"] = top_k
    return sampling, None


def _max_tokens(body: Dict[str, Any]):
    """(max_tokens, None) or (None, a 400 response)."""
    raw = body.get("max_tokens")
    if raw is None:
        return 16, None
    if isinstance(raw, bool) or not isinstance(raw, int):
        return None, _invalid_request(
            f"max_tokens must be an integer, got {type(raw).__name__}", "max_tokens"
        )
    if raw <= 0:
        return None, _invalid_request(
            f"max_tokens must be a positive integer, got {raw}", "max_tokens"
        )
    if raw > MAX_TOKENS_CAP:
        return None, _invalid_request(
            f"max_tokens must be <= {MAX_TOKENS_CAP}, got {raw}", "max_tokens"
        )
    return raw, None


def _output_ids(core_response):
    """The token ids of a response: ``OUTPUT_IDS`` (the LLM models) or
    ``OUT`` (``repeat_int32``); None for a response without either."""
    for tensor in core_response.outputs:
        if tensor.name in ("OUTPUT_IDS", "OUT"):
            return np.asarray(tensor.data).reshape(-1).tolist()
    return None


async def _chain(first, rest):
    """Re-attach a prefetched first response to the rest of the stream."""
    if first is not None:
        yield first
    async for response in rest:
        yield response


def _sse(doc: Any) -> bytes:
    return b"data: " + json.dumps(doc).encode() + b"\n\n"


class OpenAiFrontend:
    def __init__(self, core: ServerCore, default_model: str = "llm_decode"):
        self.core = core
        self.default_model = default_model
        self._counter = 0

    async def handle_models(self, request: Request) -> Response:
        # only READY models are listable: the listing is "what I can call now"
        models = [
            {"id": entry["name"], "object": "model", "owned_by": "client_tpu_torch"}
            for entry in self.core.repository.index()
            if entry["state"] == STATE_READY
        ]
        return json_response({"object": "list", "data": models})

    def _generate(self, model_name: str, prompt_ids,
                  parameters: Dict[str, Any]) -> AsyncIterator:
        request = CoreRequest(
            model_name=model_name,
            inputs=[
                CoreTensor(
                    name="INPUT_IDS",
                    datatype="INT32",
                    shape=[len(prompt_ids)],
                    data=np.asarray(prompt_ids, dtype=np.int32),
                )
            ],
            parameters=parameters,
        )
        return self.core.infer_decoupled(request)

    async def handle_chat(self, request: Request) -> Optional[Response]:
        is_chat = request.path.endswith("/chat/completions")
        try:
            body = request.json()
        except ValueError:
            return json_response({"error": {"message": "invalid JSON body"}}, status=400)
        if not isinstance(body, dict):
            return json_response({"error": {"message": "body must be a JSON object"}},
                                 status=400)
        messages = body.get("messages", [])
        if not isinstance(messages, list) or not all(isinstance(m, dict) for m in messages):
            return _invalid_request("messages must be a list of objects", "messages")
        # validate everything BEFORE any work: a bad field is a clean 400,
        # never a 500 or an in-band error after the SSE 200 is committed
        max_tokens, invalid = _max_tokens(body)
        if invalid is not None:
            return invalid
        sampling, invalid = _sampling(body)
        if invalid is not None:
            return invalid
        model_name = body.get("model") or self.default_model
        try:
            model = self.core.repository.get(model_name, "")
        except InferenceServerException as e:
            return json_response({"error": {"message": e.message()}}, status=404)
        tokenizer = SyntheticTokenizer(getattr(model, "vocab_size", 32000))
        prompt_ids = tokenizer.encode(_messages_to_prompt(body)) or [2]
        stream = bool(body.get("stream", False))
        self._counter += 1
        completion_id = f"chatcmpl-{self._counter}"
        created = int(time.time())
        object_name = (
            "chat.completion.chunk" if (is_chat and stream)
            else "chat.completion" if is_chat
            else "text_completion"
        )

        def chunk(delta_text, finish):
            choice: Dict[str, Any] = {"index": 0, "finish_reason": finish}
            if is_chat:
                choice["delta"] = {"content": delta_text} if delta_text is not None else {}
            else:
                choice["text"] = delta_text or ""
            return {
                "id": completion_id,
                "object": object_name,
                "created": created,
                "model": model_name,
                "choices": [choice],
            }

        parameters = {"max_tokens": max_tokens, **sampling}
        iterator = self._generate(model_name, prompt_ids, parameters)
        try:
            if stream:
                return await self._stream(request, iterator, tokenizer, chunk)
            pieces = []
            async for core_response in iterator:
                ids = _output_ids(core_response)
                if ids is not None:
                    pieces.extend(ids)
            doc = chunk(None, "stop")
            text = tokenizer.decode(pieces)
            if is_chat:
                doc["choices"][0].pop("delta", None)
                doc["choices"][0]["message"] = {"role": "assistant", "content": text}
            else:
                doc["choices"][0]["text"] = text
            doc["usage"] = {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": len(pieces),
                "total_tokens": len(prompt_ids) + len(pieces),
            }
            return json_response(doc)
        except InferenceServerException as e:
            return _mapped_error(e)
        finally:
            await iterator.aclose()

    async def _stream(self, request: Request, iterator, tokenizer, chunk) -> None:
        """Stream the generation as SSE events, ending with ``[DONE]``."""
        # pull the FIRST response before committing the 200: submit-time
        # rejections (context too long, queue full) surface as real HTTP
        # errors with their own status, not as in-band events
        try:
            first = await iterator.__anext__()
        except StopAsyncIteration:
            first = None
        response = await request.stream(
            200, {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        count = 0
        try:
            async for core_response in _chain(first, iterator):
                ids = _output_ids(core_response)
                if ids is None:
                    continue
                text = (" " if count else "") + tokenizer.decode(ids)
                count += len(ids)
                await response.write(_sse(chunk(text, None)))
            await response.write(_sse(chunk(None, "stop")))
        except InferenceServerException as e:
            # mid-stream failure: deliver the error in-band, then end the
            # stream cleanly
            await response.write(_sse({"error": {"message": e.message()}}))
        await response.write(b"data: [DONE]\n\n")
        await response.write_eof()
        return None

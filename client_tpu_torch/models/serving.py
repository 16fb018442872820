"""Adapters exposing the model zoo as KServe v2 models on the port's server.

``image_classifier`` (:class:`ImageClassifierModel`, ResNet) is the
serving half of BASELINE.json's "image_client.py ResNet-50" configuration;
``text_encoder`` (:class:`TextEncoderModel`, BERT-family embeddings) that
of its "perf_analyzer concurrency sweep: BERT-large";
``llm_decode`` (:class:`LlmDecodeModel`, dense greedy decode, one stream
at a time) and ``llm_engine`` (``client_tpu_torch/llm/serving.py``,
continuous batching over paged attention) serve streaming generation.
"""

import asyncio
import dataclasses
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np
import torch

from client_tpu_torch.models import bert, llama, resnet
from client_tpu_torch.server.model_repository import Model
from client_tpu_torch.server.models import pad_batch_bucket, run_bucketed
from client_tpu_torch.utils import (
    InferenceServerException,
    numpy_to_tensor,
    resolve_device,
    tensors_to_numpy,
)


class ImageClassifierModel(Model):
    """ResNet image classifier: INPUT [H, W, 3] FP32 -> OUTPUT [classes]
    FP32 logits, on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``), with the classification extension's labels.

    ``config`` defaults to ResNet-50. ``params`` (the dict
    :func:`resnet.init_params` or :func:`resnet.params_from_jax` returns)
    must already live on ``device``; without them warmup draws random
    weights from seed 0. Executions pad the batch to a power of two
    (``run_bucketed``), so the card sees at most four batch shapes.
    """

    max_batch_size = 8

    def __init__(
        self,
        name: str = "image_classifier",
        image_size: int = 224,
        config: Optional[resnet.ResNetConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        class_labels: Optional[List[str]] = None,
        device=None,
    ):
        self.name = name
        self.device = resolve_device(device)
        self._config = config or resnet.resnet50()
        self._image_size = image_size
        self._params = params
        self._labels = class_labels
        self.inputs = [
            {"name": "INPUT", "datatype": "FP32", "shape": [image_size, image_size, 3]}
        ]
        self.outputs = [
            {"name": "OUTPUT", "datatype": "FP32", "shape": [self._config.num_classes]}
        ]

    def labels(self, output_name: str):
        return self._labels

    def warmup(self) -> None:
        if self._params is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
            self._params = resnet.init_params(generator, self._config, self.device)
        size = self._image_size
        self.execute({"INPUT": np.zeros([1, size, size, 3], dtype=np.float32)}, {})

    def execute(self, inputs, parameters):
        if "INPUT" not in inputs:
            raise InferenceServerException(f"model '{self.name}' expects input INPUT")
        images = inputs["INPUT"]
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[-1] != 3:
            raise InferenceServerException(
                f"INPUT must be [batch, H, W, 3] images, got shape {list(images.shape)}"
            )
        (logits,) = run_bucketed(
            lambda x: (resnet.forward(self._params, x, self._config),), images,
            device=self.device,
        )
        return {"OUTPUT": logits}


class TextEncoderModel(Model):
    """BERT-family text encoder: INPUT_IDS [-1] INT32 -> EMBEDDING [D] FP32
    (the mean of the last hidden states over non-pad tokens), on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    Declares ``allow_ragged_batch``: concurrent requests of different
    lengths share one execution — the batcher pads the ragged dim with
    token 0 (the pad token, masked inside the model) to a power-of-two
    bucket, so the device sees dense [B, L, D] products. ``execute``
    pads again, rows to a power of two and length to a power of two of
    at least 8 (capped at ``max_seq_len``), so unbatched calls see the
    same bounded set of shapes.

    ``params`` (the dict :func:`bert.init_params` or
    :func:`bert.params_from_jax` returns) must already live on
    ``device``; without them warmup draws random weights from seed 0.
    ``dtype`` overrides ``config.dtype``.
    """

    max_batch_size = 16
    allow_ragged_batch = True
    ragged_pad_value = 0  # == BertConfig.pad_token_id; masked in the model
    inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]

    def __init__(
        self,
        name: str = "text_encoder",
        config: Optional[bert.BertConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.name = name
        self.device = resolve_device(device)
        config = config or bert.BertConfig.tiny()
        if dtype is not None:
            config = dataclasses.replace(config, dtype=dtype)
        self._config = config
        self.ragged_dim_cap = config.max_seq_len
        self._params = params
        self.outputs = [
            {"name": "EMBEDDING", "datatype": "FP32", "shape": [config.d_model]}
        ]

    def warmup(self) -> None:
        if self._params is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
            self._params = bert.init_params(generator, self._config, self.device)
        self.execute({"INPUT_IDS": np.ones([1, 8], dtype=np.int32)}, {})

    def check_inputs(self, inputs):
        """Refuse token ids outside the vocabulary: an out-of-range index
        is a device-side fault on a card, where the reference clamps it.
        The batcher calls this per request, so such a request fails
        alone; :meth:`execute` calls it for the unbatched path."""
        ids = inputs.get("INPUT_IDS")
        vocab = self._config.vocab_size
        if ids is not None and ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise InferenceServerException(f"token ids must lie in [0, {vocab})")

    @torch.inference_mode()
    def execute(self, inputs, parameters):
        if "INPUT_IDS" not in inputs:
            raise InferenceServerException(
                f"model '{self.name}' expects input INPUT_IDS"
            )
        config = self._config
        ids = np.asarray(inputs["INPUT_IDS"], dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.ndim != 2:
            raise InferenceServerException(
                f"INPUT_IDS must be [batch, length], got shape {list(ids.shape)}"
            )
        if ids.shape[1] > config.max_seq_len:
            raise InferenceServerException(
                f"sequence length {ids.shape[1]} exceeds max {config.max_seq_len}"
            )
        self.check_inputs({"INPUT_IDS": ids})
        rows, length = ids.shape
        row_bucket = pad_batch_bucket(rows)
        len_bucket = min(pad_batch_bucket(length, minimum=8), config.max_seq_len)
        if (row_bucket, len_bucket) != (rows, length):
            padded = np.full([row_bucket, len_bucket], config.pad_token_id, dtype=np.int32)
            padded[:rows, :length] = ids
            ids = padded
        _, pooled = bert.forward(self._params, numpy_to_tensor(ids, self.device), config)
        (embedding,) = tensors_to_numpy([pooled[:rows]])
        return {"EMBEDDING": embedding}


class LlmDecodeModel(Model):
    """Decoupled dense LLM decode: INPUT_IDS -> one OUTPUT_IDS token a
    response (greedy), ``max_tokens`` (a request parameter, 16 by
    default) responses, the last flagged ``triton_final_response``; on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``config`` defaults to the tiny Llama with ``max_seq_len`` 512, as
    the reference's does. ``params`` (the dict :func:`llama.init_params`
    or :func:`llama.params_from_jax` returns) must already live on
    ``device``; without them warmup draws random weights from seed 0.

    Each stream prefills its prompt unpadded into a dense cache of
    ``prompt + max_tokens`` positions and decodes with
    :func:`llama.decode_step`: exactly the calls :func:`llama.generate`
    makes, so a stream equals ``generate`` token for token. The
    reference pads the prompt to a power-of-two bucket only to bound XLA
    retraces; the port is eager. As in the reference, every step runs on
    the serving loop, which it holds for the step's length, and yields
    to it between tokens.
    """

    decoupled = True
    max_batch_size = 0
    inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]
    outputs = [{"name": "OUTPUT_IDS", "datatype": "INT32", "shape": [1]}]

    def __init__(self, name: str = "llm_decode",
                 config: Optional[llama.LlamaConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self._config = config or llama.LlamaConfig.tiny(max_seq_len=512)
        self._params = params

    @property
    def vocab_size(self) -> int:
        return self._config.vocab_size

    def warmup(self) -> None:
        if self._params is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
            self._params = llama.init_params(generator, self._config, self.device)
        prompt = torch.zeros([1, 8], dtype=torch.int32, device=self.device)
        llama.generate(self._params, prompt, self._config, 2)

    async def execute_decoupled(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> AsyncIterator[Dict[str, np.ndarray]]:
        if "INPUT_IDS" not in inputs:
            raise InferenceServerException(
                f"model '{self.name}' expects input INPUT_IDS"
            )
        config = self._config
        prompt = np.asarray(inputs["INPUT_IDS"], dtype=np.int32).reshape(1, -1)
        max_tokens = int(parameters.get("max_tokens", 16))
        prompt_len = prompt.shape[1]
        if prompt_len + max_tokens > config.max_seq_len:
            raise InferenceServerException(
                f"prompt ({prompt_len}) + max_tokens ({max_tokens}) exceeds "
                f"max sequence length {config.max_seq_len}"
            )
        if prompt.size and (prompt.min() < 0 or prompt.max() >= config.vocab_size):
            # an out-of-range id would fault the device's embedding read
            raise InferenceServerException(
                f"INPUT_IDS must lie in [0, {config.vocab_size})"
            )
        with torch.inference_mode():
            cache = llama.init_kv_cache(config, 1, prompt_len + max_tokens, device=self.device)
            logits, cache = llama.prefill_with_cache(
                self._params, numpy_to_tensor(prompt, self.device), cache, config)
            token = logits.argmax(dim=-1).to(torch.int32)
        for i in range(max_tokens):
            (host,) = tensors_to_numpy([token])
            yield {"OUTPUT_IDS": host, "__final__": i == max_tokens - 1}
            if i == max_tokens - 1:
                break
            with torch.inference_mode():
                logits, cache = llama.decode_step(
                    self._params, token, prompt_len + i, cache, config)
                token = logits.argmax(dim=-1).to(torch.int32)
            # let other streams' requests interleave
            await asyncio.sleep(0)


def register_zoo_models(repository, small: bool = True, device=None) -> None:
    """Install the model-zoo adapters on ``device``: ``image_classifier``
    (64 x 64 images through the thin ResNet-18 when ``small``, else 224 x
    224 through ResNet-50), ``llm_decode`` and ``llm_engine`` (the tiny
    Llama) and ``text_encoder`` (the tiny BERT when ``small``, else
    BERT-large's widths), random weights from seed 0."""
    from client_tpu_torch.llm.serving import LlmEngineModel

    repository.add_model(ImageClassifierModel(
        image_size=64 if small else 224,
        config=resnet.resnet18_thin() if small else resnet.resnet50(), device=device,
    ))
    repository.add_model(LlmDecodeModel(device=device))
    repository.add_model(LlmEngineModel(device=device))
    repository.add_model(TextEncoderModel(
        config=bert.BertConfig.tiny() if small else bert.BertConfig(), device=device
    ))

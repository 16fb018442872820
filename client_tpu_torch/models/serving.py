"""Adapters exposing the model zoo as KServe v2 models on the port's server.

``image_classifier`` (:class:`ImageClassifierModel`, ResNet) is the
serving half of BASELINE.json's "image_client.py ResNet-50" configuration;
``text_encoder`` (:class:`TextEncoderModel`, BERT-family embeddings) that
of its "perf_analyzer concurrency sweep: BERT-large";
``llm_engine`` (``client_tpu_torch/llm/serving.py``) serves streaming
generation.
"""

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from client_tpu_torch.models import bert, resnet
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


def register_zoo_models(repository, small: bool = True, device=None) -> None:
    """Install the model-zoo adapters on ``device``: ``image_classifier``
    (64 x 64 images through the thin ResNet-18 when ``small``, else 224 x
    224 through ResNet-50), ``llm_engine`` (the tiny Llama) and
    ``text_encoder`` (the tiny BERT when ``small``, else BERT-large's
    widths), random weights from seed 0."""
    from client_tpu_torch.llm.serving import LlmEngineModel

    repository.add_model(ImageClassifierModel(
        image_size=64 if small else 224,
        config=resnet.resnet18_thin() if small else resnet.resnet50(), device=device,
    ))
    repository.add_model(LlmEngineModel(device=device))
    repository.add_model(TextEncoderModel(
        config=bert.BertConfig.tiny() if small else bert.BertConfig(), device=device
    ))

"""Adapters exposing the model zoo as KServe v2 models on the port's server.

``text_encoder`` (:class:`TextEncoderModel`, BERT-family embeddings) is the
serving half of BASELINE.json's "perf_analyzer concurrency sweep: BERT-large"
configuration; ``llm_engine`` (``client_tpu_torch/llm/serving.py``) serves
streaming generation.
"""

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from client_tpu_torch.models import bert
from client_tpu_torch.server.model_repository import Model
from client_tpu_torch.server.models import pad_batch_bucket
from client_tpu_torch.utils import (
    InferenceServerException,
    numpy_to_tensor,
    resolve_device,
    tensors_to_numpy,
)


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
    """Install the model-zoo adapters on ``device``: ``llm_engine`` (the
    tiny Llama) and ``text_encoder`` (the tiny BERT when ``small``, else
    BERT-large's widths), random weights from seed 0."""
    from client_tpu_torch.llm.serving import LlmEngineModel

    repository.add_model(LlmEngineModel(device=device))
    repository.add_model(TextEncoderModel(
        config=bert.BertConfig.tiny() if small else bert.BertConfig(), device=device
    ))

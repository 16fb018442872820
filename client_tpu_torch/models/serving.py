"""Adapters exposing the model zoo as KServe v2 models on the port's server.

``image_classifier`` (:class:`ImageClassifierModel`, ResNet) is the
serving half of BASELINE.json's "image_client.py ResNet-50" configuration;
``text_encoder`` (:class:`TextEncoderModel`, BERT-family embeddings) that
of its "perf_analyzer concurrency sweep: BERT-large";
``llm_decode`` (:class:`LlmDecodeModel`, dense greedy decode, one stream
at a time) and ``llm_engine`` (``client_tpu_torch/llm/serving.py``,
continuous batching over paged attention) serve streaming generation.
``text_encoder_tp`` (:class:`ShardedTextEncoderModel`, dp x tp) and
``llama_ring`` (:class:`RingPrefillLlamaModel`, ring attention over sp)
serve through a mesh (``client_tpu_torch/parallel/``).
"""

import asyncio
import dataclasses
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np
import torch

from client_tpu_torch.models import bert, llama, resnet
from client_tpu_torch.observability.profiling import transfer_scope
from client_tpu_torch.parallel import SP_AXIS, TP_AXIS, ShardedExecutor, plan_for_model, sharding
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

    Its statistics entry carries ``kernel_launches``:
    ``{"encoder_attention": n}``, the running count of the attention
    kernel's launches (``bert.encoder_attention_cuda.launches``) made
    while its forwards ran, ``n_layers`` a forward on a card (times the
    shards), none on the CPU.
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
        self._attention_launches = 0
        self.outputs = [
            {"name": "EMBEDDING", "datatype": "FP32", "shape": [config.d_model]}
        ]

    def statistics(self):
        return {"kernel_launches": {"encoder_attention": self._attention_launches}}

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

    def execute(self, inputs, parameters):
        # the host's padding and the copy to the card are the execution's
        # device_put; the read back in _encode its readback
        with transfer_scope("device_put"):
            ids, rows = self._bucketed_ids(inputs)
            ids = self._placed(ids)
        launches = bert.encoder_attention_cuda.launches
        embedding = self._encode(ids, rows)
        self._attention_launches += bert.encoder_attention_cuda.launches - launches
        return {"EMBEDDING": embedding}

    def _placed(self, ids: np.ndarray):
        """The padded ids where the forward reads them."""
        return numpy_to_tensor(ids, self.device)

    @torch.inference_mode()
    def _encode(self, ids: torch.Tensor, rows: int) -> np.ndarray:
        """The pooled embeddings of the first ``rows`` rows of ``ids``."""
        _, pooled = bert.forward(self._params, ids, self._config)
        with transfer_scope("readback"):
            (embedding,) = tensors_to_numpy([pooled[:rows]])
        return embedding

    def _bucketed_ids(self, inputs):
        """INPUT_IDS validated and padded (rows to a power of two, length
        to a power of two of at least 8, capped at ``max_seq_len``), and
        the true row count."""
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
        return ids, rows


class ShardedTextEncoderModel(TextEncoderModel):
    """Tensor-parallel text encoder over a ``dp x tp`` mesh.

    The sharded twin of :class:`TextEncoderModel`: the same wire contract
    (INPUT_IDS [-1] INT32 -> EMBEDDING [D]), but ``warmup()`` resolves the
    declared mesh against ``devices`` (default: every card of the
    process, or the CPU for a CPU model; an explicit list may repeat a
    device), cuts the parameters per ``bert.param_specs`` (heads and the
    FFN hidden over ``tp``) and executes through a
    :class:`~client_tpu_torch.parallel.ShardedExecutor`: batch rows split
    over ``dp``, products over ``tp``, and the output gathers back to the
    host. Float32 by default, so results match the unsharded encoder to
    rounding noise.

    With fewer than ``dp*tp`` devices the model loads UNAVAILABLE with
    reason ``load failed: mesh requires N devices, host has M``.
    """

    mesh = {
        "axes": {"dp": 2, "tp": 2},
        "inputs": {"INPUT_IDS": ["dp", None]},
        "outputs": {"EMBEDDING": ["dp", None]},
    }

    def __init__(self, name: str = "text_encoder_tp",
                 config: Optional[bert.BertConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None,
                 dtype: Optional[torch.dtype] = None, devices=None):
        device, self.devices = sharding.mesh_devices(device, devices)
        super().__init__(name=name, config=config or bert.BertConfig.tiny(dtype=torch.float32),
                         params=params, device=device, dtype=dtype)
        self.mesh_plan = None
        self._executor = None

    def warmup(self) -> None:
        plan = plan_for_model(self, self.devices)
        if self._params is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
            self._params = bert.init_params(generator, self._config, self.device)
        config = self._config
        shards = bert.shard_params(self._params, config, plan)
        groups = plan.groups(TP_AXIS)

        def run(arrays):
            blocks = arrays["INPUT_IDS"]
            out = [None] * len(plan.devices)
            for group in groups:  # one tp group per dp block
                _, pooled = bert.forward([shards[i] for i in group], blocks[group[0]], config)
                for i in group:
                    out[i] = pooled
            return {"EMBEDDING": out}

        executor = ShardedExecutor(plan, run)
        # run the smallest bucket once, and publish the plan and executor
        # only once it provably executes
        executor({"INPUT_IDS": np.ones([1, 8], dtype=np.int32)}, rows=1)
        self.mesh_plan = plan
        self._executor = executor

    def _placed(self, ids: np.ndarray) -> np.ndarray:
        # the executor places the dp blocks itself (padding the rows to
        # the dp extent)
        return ids

    def _encode(self, ids: np.ndarray, rows: int) -> np.ndarray:
        # the executor runs every shard, and gathers and trims the output
        return self._executor({"INPUT_IDS": ids}, rows=rows)["EMBEDDING"]


class RingPrefillLlamaModel(Model):
    """Long-context Llama prefill served through ring attention:
    INPUT_IDS [-1] INT32 -> LOGITS [vocab] FP32, the real last token's
    next-token logits. The sequence splits over the mesh's ``sp`` axis, so
    attention runs as blockwise ring-rotated online softmax across the
    shards (:func:`~client_tpu_torch.parallel.ring_attention`); the dense
    prefill is the numerical reference.

    Prompts pad to a power-of-two bucket (divisible by the sp extent);
    causal attention keeps the padded tail out of the real last position.
    ``config`` defaults to the tiny fp32 Llama with ``max_seq_len`` 256;
    ``devices`` as for :class:`ShardedTextEncoderModel`. With too few
    devices the model loads UNAVAILABLE with the reference's reason.
    """

    max_batch_size = 4
    mesh = {
        "axes": {"dp": 1, "tp": 1, "sp": 2},
        "inputs": {"INPUT_IDS": [None, "sp"]},
        "outputs": {"LOGITS": [None, None]},
    }
    inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]

    def __init__(self, name: str = "llama_ring",
                 config: Optional[llama.LlamaConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None, devices=None):
        self.name = name
        self.device, self.devices = sharding.mesh_devices(device, devices)
        self._config = config or llama.LlamaConfig.tiny(max_seq_len=256, dtype=torch.float32)
        self._params = params
        self.outputs = [
            {"name": "LOGITS", "datatype": "FP32", "shape": [self._config.vocab_size]}
        ]
        self.mesh_plan = None
        self._executor = None

    @property
    def vocab_size(self) -> int:
        return self._config.vocab_size

    def warmup(self) -> None:
        plan = plan_for_model(self, self.devices)
        if self._params is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
            self._params = llama.init_params(generator, self._config, self.device)
        config = self._config
        # the weights on every sp device (one tensor per distinct device)
        replicas = {}
        for device in plan.devices:
            if device not in replicas:
                replicas[device] = (self._params if self._params["embed"].device == device
                                    else _to_device(self._params, device))
        sp_devices = [plan.devices[i] for i in plan.groups(SP_AXIS)[0]]
        params = [replicas[d] for d in sp_devices]

        def run(arrays):
            blocks = [arrays["INPUT_IDS"][i] for i in plan.groups(SP_AXIS)[0]]
            last = int(arrays["LAST_INDEX"][0])
            width = blocks[0].shape[1]
            logits = llama.forward(params, blocks, config, mesh=plan)
            row = logits[last // width][:, last % width]
            return {"LOGITS": [row] * len(plan.devices)}

        executor = ShardedExecutor(plan, run)
        executor({"INPUT_IDS": np.zeros([1, 8], dtype=np.int32),
                  "LAST_INDEX": np.int32(7)}, rows=1)
        self.mesh_plan = plan
        self._executor = executor

    def check_inputs(self, inputs):
        ids = inputs.get("INPUT_IDS")
        vocab = self._config.vocab_size
        if ids is not None and ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise InferenceServerException(f"token ids must lie in [0, {vocab})")

    def execute(self, inputs, parameters):
        if "INPUT_IDS" not in inputs:
            raise InferenceServerException(
                f"model '{self.name}' expects input INPUT_IDS"
            )
        ids = np.asarray(inputs["INPUT_IDS"], dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        rows, length = ids.shape
        if length < 1:
            # LAST_INDEX would be -1 (a pad position): refuse instead of
            # returning logits computed at padding
            raise InferenceServerException(
                f"model '{self.name}' requires a non-empty prompt"
            )
        if length > self._config.max_seq_len:
            raise InferenceServerException(
                f"sequence length {length} exceeds max {self._config.max_seq_len}"
            )
        self.check_inputs({"INPUT_IDS": ids})
        # a power-of-two bucket bounds the shapes and divides by the sp
        # extent (max_seq_len is itself a power of two)
        bucket = min(pad_batch_bucket(length, minimum=8), self._config.max_seq_len)
        if bucket != length:
            padded = np.zeros([rows, bucket], dtype=np.int32)
            padded[:, :length] = ids
            ids = padded
        out = self._executor({"INPUT_IDS": ids, "LAST_INDEX": np.int32(length - 1)},
                             rows=rows)
        return {"LOGITS": out["LOGITS"]}


def _to_device(tree, device):
    """A copy of a parameter tree on ``device``."""
    if isinstance(tree, dict):
        return {key: _to_device(value, device) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_to_device(value, device) for value in tree]
    return tree.to(device)


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
    Llama), ``text_encoder`` (the tiny BERT when ``small``, else
    BERT-large's widths), and the sharded ``text_encoder_tp`` (dp2 x tp2)
    and ``llama_ring`` (sp2), random weights from seed 0. The sharded two
    resolve their meshes against the host's devices: with too few they
    register UNAVAILABLE with ``load failed: mesh requires N devices,
    host has M`` instead of blocking startup."""
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
    repository.add_model(ShardedTextEncoderModel(device=device))
    repository.add_model(RingPrefillLlamaModel(device=device))

"""Repository model type wrapping the continuous-batching engine.

``llm_engine`` is a decoupled KServe v2 model (INPUT_IDS -> one
OUTPUT_IDS token per streamed response) whose generations share ONE
:class:`LlmEngine`: every concurrent ``execute_decoupled`` call is a
sequence in the engine's running batch, so N concurrent streams cost one
batched decode step per token.
"""

from typing import Any, AsyncIterator, Dict, Optional

import numpy as np
import torch

from client_tpu_torch.llm.engine import EngineConfig, LlmEngine, block_bucket
from client_tpu_torch.models import llama, paged_attention
from client_tpu_torch.server.model_repository import Model
from client_tpu_torch.utils import InferenceServerException, resolve_device


class LlmEngineModel(Model):
    """Continuous-batching LLM generation over the paged KV cache, on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``params`` (the dict :func:`llama.init_params` or
    :func:`llama.params_from_jax` returns) must already live on
    ``device``; without them warmup draws random weights from seed 0.
    Tensor parallelism and speculative decoding are not ported yet.
    """

    decoupled = True
    max_batch_size = 0
    platform = "pytorch"
    backend = "pytorch"
    inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]
    outputs = [{"name": "OUTPUT_IDS", "datatype": "INT32", "shape": [1]}]

    def __init__(
        self,
        name: str = "llm_engine",
        config: Optional[llama.LlamaConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        engine_config: Optional[EngineConfig] = None,
        tp: int = 1,
        speculation: Optional[Dict[str, Any]] = None,
        device=None,
    ):
        if int(tp) != 1:
            raise InferenceServerException("tp > 1 is not yet ported")
        if speculation is not None:
            raise InferenceServerException(
                "speculative decoding is not yet ported"
            )
        self.name = name
        self.tp = 1
        self.device = resolve_device(device)
        self._config = config or llama.LlamaConfig.tiny(max_seq_len=512)
        if engine_config is None:
            # default pool: 8 full-length sequences' worth of blocks
            block_size = 16
            per_seq = (self._config.max_seq_len + block_size - 1) // block_size
            engine_config = EngineConfig(
                block_size=block_size,
                num_blocks=1 + 8 * per_seq,
                max_active=8,
                max_queue=64,
                max_seq_len=self._config.max_seq_len,
            )
        self.engine_config = engine_config
        self._params = params
        self.engine: Optional[LlmEngine] = None
        # the ragged paged-attention implementation warmup selected
        # ("cuda" on a card, "fused" on the CPU); reported in config()
        self.decode_kernel: Optional[str] = None
        self._core = None

    @property
    def vocab_size(self) -> int:
        return self._config.vocab_size

    def _build_device_fns(self, params, config, engine_config, attn):
        """The engine's device callables (prefill, decode). They take the
        engine's host int arrays, run on ``self.device`` and hand back
        host fp32 logits: one device-to-host copy per call, which is also
        the call's only synchronisation. ``prefill`` routes start == 0
        through the full-prompt path and block-aligned suffixes through
        ``prefill_suffix_into_pages`` with a power-of-two prefix bucket.
        Each enters inference mode itself: the engine calls them from an
        executor thread, and the mode is per thread."""
        device = self.device
        block_size = engine_config.block_size

        def to_device(array):
            return torch.from_numpy(np.asarray(array, dtype=np.int32)).to(device)

        def to_host(logits):
            return logits.float().cpu().numpy()

        @torch.inference_mode()
        def prefill(tokens, page_table, pages, last_index, start_index):
            tokens, page_table = to_device(tokens), to_device(page_table)
            if not start_index:
                logits, pages = llama.prefill_into_pages(
                    params, tokens, page_table, pages, int(last_index), config
                )
            else:
                prefix_blocks = min(
                    block_bucket(start_index // block_size),
                    engine_config.max_blocks_per_seq,
                )
                logits, pages = llama.prefill_suffix_into_pages(
                    params, tokens, page_table, pages, int(last_index),
                    int(start_index), prefix_blocks, config,
                )
            return to_host(logits), pages

        @torch.inference_mode()
        def decode(tokens, positions, page_tables, pages):
            logits, pages = llama.decode_step_paged_attn(
                params, to_device(tokens), to_device(positions),
                to_device(page_tables), pages, config, attn,
            )
            return to_host(logits), pages

        return prefill, decode

    def warmup(self) -> None:
        """Build the pool and the device callables and probe them at the
        shapes the engine serves: prefill at the smallest bucket, one
        suffix prefill, and decode at table widths 1 and
        ``min(8, max_blocks)`` (all writes land in the trash block). One
        kernel is picked for the device — the CUDA kernel on a card — and
        a probe that fails fails the load with its error."""
        config = self._config
        engine_config = self.engine_config
        if self.engine is not None:
            # a reload replaces the engine and its pool wholesale
            self.engine.close()
            self.engine = None
        with torch.inference_mode():
            if self._params is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
                self._params = llama.init_params(generator, config, self.device)
            name, attn = paged_attention.resolve_decode_attention(self.device)
            prefill, decode = self._build_device_fns(
                self._params, config, engine_config, attn
            )
            pages = llama.init_kv_pages(
                config, engine_config.num_blocks, engine_config.block_size,
                self.device,
            )
        max_blocks = engine_config.max_blocks_per_seq
        table = np.zeros([max_blocks], dtype=np.int32)
        probe_tokens = np.zeros([1, engine_config.prefill_bucket_min], dtype=np.int32)
        last = engine_config.prefill_bucket_min - 1
        _, pages = prefill(probe_tokens, table, pages, last, 0)
        if engine_config.prefix_sharing and max_blocks > 1:
            _, pages = prefill(probe_tokens, table, pages, last,
                               engine_config.block_size)
        for nb in sorted({1, min(8, max_blocks)}):
            _, pages = decode(
                np.zeros([1], dtype=np.int32), np.zeros([1], dtype=np.int32),
                table[None, :nb], pages,
            )
        self.decode_kernel = name
        self.engine = LlmEngine(prefill, decode, pages, engine_config,
                                model_name=self.name)
        self._core = None  # rebind the executor after a reload

    def config(self) -> Dict[str, Any]:
        """Model config with the warmup-selected decode kernel, the tp
        width and the prefix-sharing mode in the parameters map."""
        doc = super().config()
        parameters = doc.setdefault("parameters", {})
        parameters["decode_kernel"] = {
            "string_value": self.decode_kernel or "uninitialized"
        }
        parameters["tp"] = {"string_value": str(self.tp)}
        parameters["prefix_sharing"] = {
            "string_value": "cow" if self.engine_config.prefix_sharing else "off"
        }
        return doc

    def shutdown(self) -> None:
        """Stop the engine's step loop (``ServerCore.close`` hook)."""
        if self.engine is not None:
            self.engine.close()

    def bind_core(self, core) -> None:
        """Run the engine's device calls on the serving core's executor
        (called by ``ServerCore.infer_decoupled`` on first use)."""
        if self._core is core or self.engine is None:
            return
        self._core = core
        self.engine._executor = core._executor

    async def execute_decoupled(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> AsyncIterator[Dict[str, np.ndarray]]:
        if "INPUT_IDS" not in inputs:
            raise InferenceServerException(
                f"model '{self.name}' expects input INPUT_IDS"
            )
        prompt = np.asarray(inputs["INPUT_IDS"]).reshape(-1).astype(np.int64)
        if prompt.size and (prompt.min() < 0 or prompt.max() >= self.vocab_size):
            # an out-of-range id would fault the device's embedding read
            raise InferenceServerException(
                f"INPUT_IDS must lie in [0, {self.vocab_size})"
            )
        seq = self.engine.submit(prompt.tolist(), parameters=parameters)
        try:
            async for token, final in seq:
                yield {
                    "OUTPUT_IDS": np.array([token], dtype=np.int32),
                    "__final__": final,
                }
        finally:
            # client cancellation / stream teardown: the engine reclaims
            # the sequence's KV blocks within one step-loop iteration
            self.engine.release(seq)

"""Repository model type wrapping the continuous-batching engine.

``llm_engine`` is a decoupled KServe v2 model (INPUT_IDS -> one
OUTPUT_IDS token per streamed response) whose generations share ONE
:class:`LlmEngine`: every concurrent ``execute_decoupled`` call is a
sequence in the engine's running batch, so N concurrent streams cost one
batched decode step per token.
"""

import json
from typing import Any, AsyncIterator, Dict, Optional

import numpy as np
import torch

from client_tpu_torch.llm.engine import EngineConfig, LlmEngine, block_bucket
from client_tpu_torch.llm.recovery import RECOVERING, EngineRecovery
from client_tpu_torch.llm.speculation import build_proposer
from client_tpu_torch.models import llama, paged_attention
from client_tpu_torch.parallel import TP_AXIS, sharding
from client_tpu_torch.server.model_repository import Model
from client_tpu_torch.utils import InferenceServerException


class LlmEngineModel(Model):
    """Continuous-batching LLM generation over the paged KV cache, on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``params`` (the dict :func:`llama.init_params` or
    :func:`llama.params_from_jax` returns) must already live on
    ``device``; without them warmup draws random weights from seed 0.

    ``speculation`` (``{"mode": "draft" | "ngram", "k": N, ...}``, the
    knobs of :func:`~client_tpu_torch.llm.speculation.build_proposer`;
    ``"draft": "self"`` drafts with the target itself) turns on
    speculative decoding: each step verifies every lane's draft tokens
    and its next position in one ``decode_step_paged_multi`` call, whose
    attention is the multi-query twin of the decode kernel (K2 on a
    card). ``draft_config``/``draft_params`` name a draft model.

    ``tp`` > 1 shards the model and the page pool over a ``{"tp": N}``
    mesh resolved at warmup against ``devices`` (default: every card of
    the process, or the CPU for a CPU model; an explicit list may repeat
    a device). Each shard holds ``H/tp`` query heads, ``KV/tp`` KV heads
    and its own pool, and runs K1/K2 on its head slice
    (:func:`~client_tpu_torch.models.paged_attention.make_tp_attention`);
    the attention and MLP partials are all-reduced. Too few devices, or a
    ``tp`` that does not divide the head counts, fails the load with the
    reference's reason. ``device`` defaults to the first of ``devices``.

    With ``auto_recovery`` (the default) warmup wires an
    :class:`~client_tpu_torch.llm.recovery.EngineRecovery` controller onto
    the engine, built with ``recovery_options``: a fatal step failure
    reloads the engine in the background and resumes the streams that did
    not opt out (request parameter ``recovery: fail``).
    """

    decoupled = True
    max_batch_size = 0
    platform = "pytorch"
    backend = "pytorch"
    inputs = [{"name": "INPUT_IDS", "datatype": "INT32", "shape": [-1]}]
    outputs = [{"name": "OUTPUT_IDS", "datatype": "INT32", "shape": [1]}]

    #: engine-fatal auto-recovery (tier 1 of the self-healing stack): when
    #: True, warmup wires an EngineRecovery controller onto the engine, so
    #: a fatal device failure triggers a bounded-retry background reload
    #: instead of closed-until-manual-reload
    auto_recovery: bool = True

    #: knobs forwarded to the EngineRecovery constructor (repository model
    #: attr, e.g. ``{"max_attempts": 5, "retry_after_s": 2.0}``)
    recovery_options: Optional[Dict[str, Any]] = None

    def __init__(
        self,
        name: str = "llm_engine",
        config: Optional[llama.LlamaConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        engine_config: Optional[EngineConfig] = None,
        tp: int = 1,
        speculation: Optional[Dict[str, Any]] = None,
        draft_config: Optional[llama.LlamaConfig] = None,
        draft_params: Optional[Dict[str, Any]] = None,
        device=None,
        devices=None,
    ):
        self.name = name
        self.tp = int(tp)
        self.device, self.devices = sharding.mesh_devices(device, devices)
        # the resolved {"tp": N} mesh (None at tp 1), published by warmup
        self.mesh_plan = None
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
        self.speculation = dict(speculation) if speculation is not None else None
        self._draft_config = draft_config
        self._draft_params = draft_params
        # admission math must see the speculative lookahead the engine
        # will use (worst-case K+1 growth per sequence)
        if self.speculation is not None:
            engine_config.spec_k = max(1, int(self.speculation.get("k", 4)))
        self.engine_config = engine_config
        self._params = params
        self.engine: Optional[LlmEngine] = None
        # the ragged paged-attention implementation warmup selected
        # ("cuda" on a card, "fused" on the CPU); reported in config()
        self.decode_kernel: Optional[str] = None
        self._core = None
        # one recovery controller per model instance, created by the first
        # warmup and re-attached across engine swaps
        self._recovery = None

    @property
    def vocab_size(self) -> int:
        return self._config.vocab_size

    def _build_device_fns(self, params, config, engine_config, attn, attn_mq):
        """The engine's device callables (prefill, decode, decode_multi).
        They take the engine's host int arrays, run on ``self.device`` and
        hand back host fp32 logits: one device-to-host copy per call,
        which is also the call's only synchronisation. ``prefill`` routes
        start == 0 through the full-prompt path and block-aligned suffixes
        through ``prefill_suffix_into_pages`` with a power-of-two prefix
        bucket. ``decode_multi`` (the speculative verify step; None when
        ``attn_mq`` is None) rides the multi-query twin of the decode
        attention. Each enters inference mode itself: the engine calls
        them from an executor thread, and the mode is per thread."""
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

        decode_multi = None
        if attn_mq is not None:
            @torch.inference_mode()
            def decode_multi(tokens, positions, lengths, page_tables, pages):
                logits, pages = llama.decode_step_paged_multi(
                    params, to_device(tokens), to_device(positions),
                    to_device(lengths), to_device(page_tables), pages, config,
                    attn_mq,
                )
                return to_host(logits), pages

        return prefill, decode, decode_multi

    def _resolve_tp_plan(self, config: llama.LlamaConfig) -> sharding.MeshPlan:
        """Validate and resolve the ``{"tp": N}`` mesh for this model.
        Raises :class:`InferenceServerException` (a load failure) when
        the head counts do not divide or the devices are not there."""
        if config.n_heads % self.tp or config.n_kv_heads % self.tp:
            raise InferenceServerException(
                f"tp={self.tp} must divide n_heads={config.n_heads} and "
                f"n_kv_heads={config.n_kv_heads}"
            )
        try:
            spec = sharding.MeshSpec.parse({"axes": {TP_AXIS: self.tp}})
            return sharding.resolve(spec, self.devices, self.device)
        except (sharding.MeshDeclarationError, sharding.MeshUnavailableError) as e:
            raise InferenceServerException(str(e)) from e

    def _shard_pages(self, config: llama.LlamaConfig, plan: sharding.MeshPlan) -> list:
        """One zeroed pool per shard, on its device, holding its ``KV/tp``
        heads: every layer's ``(k_pages, v_pages)`` of ``[num_blocks,
        block_size, KV/tp, D]``, each its own contiguous tensor (the
        kernels take no strided view of a wider pool)."""
        engine_config = self.engine_config
        shape = (engine_config.num_blocks, engine_config.block_size,
                 config.n_kv_heads // self.tp, config.head_dim)
        return [
            [(torch.zeros(shape, dtype=config.dtype, device=device),
              torch.zeros(shape, dtype=config.dtype, device=device))
             for _ in range(config.n_layers)]
            for device in plan.devices
        ]

    def warmup(self) -> None:
        """Build the pool and the device callables and probe them at the
        shapes the engine serves: prefill at the smallest bucket, one
        suffix prefill, decode at table widths 1 and ``min(8,
        max_blocks)``, and with speculation the verify step at T=2 (width
        1) and at T = spec_k + 1 (all writes land in the trash block).
        One kernel is picked for the device — the CUDA kernels on a card —
        and a probe that fails fails the load with its error, as does a
        malformed speculation declaration. Under ``tp`` > 1 the mesh is
        resolved first, the parameters are cut per ``llama.param_specs``
        (shard copies beside the unsharded weights) and every shard gets
        its own pool; the probes run every shard.

        A reload (``ModelRepository.load``) builds and probes the new pool
        and engine first and closes the running engine only after that,
        in the reference's order: a reload whose probe fails leaves the
        old engine serving. For that moment both pools are on the
        device."""
        config = self._config
        engine_config = self.engine_config
        # a tp mesh that cannot be built fails the load before any weight
        # is drawn
        plan = self._resolve_tp_plan(config) if self.tp > 1 else None
        with torch.inference_mode():
            if self._params is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
                self._params = llama.init_params(generator, config, self.device)
            proposer = None
            if self.speculation is not None:
                draft_params, draft_config = self._draft_params, self._draft_config
                if self.speculation.get("draft") == "self":
                    # the draft is the target: near-full acceptance, which
                    # measures the verify machinery's ceiling
                    draft_params, draft_config = self._params, config
                try:
                    proposer = build_proposer(
                        self.speculation, target_config=config,
                        draft_params=draft_params, draft_config=draft_config,
                        device=self.device,
                    )
                except ValueError as e:
                    raise InferenceServerException(f"speculative decoding: {e}") from e
            name, attn = paged_attention.resolve_decode_attention(self.device)
            attn_mq = None
            if proposer is not None:
                _, attn_mq = paged_attention.resolve_verify_attention(self.device)
            if plan is None:
                params = self._params
                pages = llama.init_kv_pages(
                    config, engine_config.num_blocks, engine_config.block_size,
                    self.device,
                )
            else:
                # each shard runs the kernel on its head slice
                params = llama.shard_params(self._params, config, plan)
                pages = self._shard_pages(config, plan)
                attn = paged_attention.make_tp_attention(attn, plan)
                if attn_mq is not None:
                    attn_mq = paged_attention.make_tp_attention(attn_mq, plan,
                                                                multi_query=True)
            prefill, decode, decode_multi = self._build_device_fns(
                params, config, engine_config, attn, attn_mq
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
        if decode_multi is not None:
            for rows, nb in ((2, 1), (engine_config.spec_k + 1, min(8, max_blocks))):
                _, pages = decode_multi(
                    np.zeros([1, rows], dtype=np.int32),
                    np.zeros([1, rows], dtype=np.int32),
                    np.zeros([1], dtype=np.int32), table[None, :nb], pages,
                )
        engine = LlmEngine(prefill, decode, pages, engine_config, model_name=self.name,
                           decode_multi_fn=decode_multi, proposer=proposer)
        # a reload replaces the engine and its pool wholesale, only now
        # that the new one passed its probes
        if self.engine is not None:
            self.engine.close()
        self.decode_kernel = name
        self.mesh_plan = plan
        self.engine = engine
        self._core = None  # rebind the executor after a reload
        self._wire_recovery()

    def _wire_recovery(self) -> None:
        """Attach the auto-recovery controller to the (possibly brand
        new) engine. The controller itself re-attaches after its reloads;
        this covers the initial warmup and manual reloads."""
        if not self.auto_recovery:
            return
        if self._recovery is None:
            self._recovery = EngineRecovery(self, **dict(self.recovery_options or {}))
        self._recovery.attach(self.engine)

    def reload(self) -> None:
        """Rebuild device state from scratch: fresh KV pool, re-probed
        kernels, a new engine (:meth:`warmup`, called through the class as
        the reference does). First the quarantined engine's device calls
        still running on the executor settle, and on a card the device is
        synchronised: an asynchronous CUDA error surfaces there, and a
        sticky one (an illegal address, a device-side assert) fails every
        attempt. A reload never falls back to the CPU."""
        if self.engine is not None:
            self.engine.settle()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        type(self).warmup(self)

    @property
    def recovering(self) -> bool:
        """True while a background engine reload is in flight (surfaced in
        ``debug_state()`` and the ``tpu_server_state`` overlay)."""
        return self._recovery is not None and self._recovery.state == RECOVERING

    def config(self) -> Dict[str, Any]:
        """Model config with the warmup-selected decode kernel, the tp
        width, the prefix-sharing mode and the speculation declaration in
        the parameters map. ``speculation_stats`` carries the engine's
        live speculation counters as a JSON string, which a harness can
        difference before and after a run."""
        doc = super().config()
        parameters = doc.setdefault("parameters", {})
        parameters["decode_kernel"] = {
            "string_value": self.decode_kernel or "uninitialized"
        }
        parameters["tp"] = {"string_value": str(self.tp)}
        parameters["prefix_sharing"] = {
            "string_value": "cow" if self.engine_config.prefix_sharing else "off"
        }
        if self.speculation is None:
            parameters["speculation"] = {"string_value": "off"}
        else:
            parameters["speculation"] = {
                "string_value": json.dumps(self.speculation, sort_keys=True)
            }
            if self.engine is not None:
                stats = self.engine.stats()
                keys = ("steps", "lane_steps", "step_tokens", "spec_steps",
                        "spec_proposed", "spec_accepted")
                parameters["speculation_stats"] = {
                    "string_value": json.dumps(
                        {key: stats[key] for key in keys}, sort_keys=True
                    )
                }
        return doc

    def shutdown(self) -> None:
        """Stop the engine's step loop (``ServerCore.close`` hook)."""
        if self.engine is not None:
            self.engine.close()

    def bind_core(self, core) -> None:
        """Wire the engine into the server it serves under (called by
        ``ServerCore.infer_decoupled`` on first use): its metrics book
        into the core's registry, its device calls run on the core's
        executor, its errors go to the core's structured log."""
        if self._core is core or self.engine is None:
            return
        self._core = core
        self.engine.metrics = core.metrics
        self.engine._executor = core._executor
        self.engine.logger = core.logger
        self.engine._publish()

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

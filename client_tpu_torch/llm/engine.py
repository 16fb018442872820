"""Continuous-batching generation engine (iteration-level scheduling).

The orchestration layer between the decoupled execution path and the
paged-attention model functions (``models/llama.py``):

- **iteration-level scheduler**: one decode step per loop iteration over
  EVERY running sequence; new requests are prefilled and join the running
  batch at the next step boundary, finished sequences exit every step —
  no sequence ever waits for the slowest member of a static batch (the
  Orca/vLLM continuous-batching shape).
- **prefill/decode split**: admission pops the waiting queue in
  (priority, arrival) order and runs each prompt's prefill as its own
  device call (its first token streams immediately — TTFT is one prefill
  away, not one batch drain away), then the sequence decodes with the
  shared step.
- **paged KV admission**: a sequence is admitted only when the
  :class:`~client_tpu_torch.llm.kv_cache.BlockAllocator` can cover its prompt;
  a full cache QUEUES new work (bounded by ``max_queue`` —
  429/RESOURCE_EXHAUSTED past the bound) instead of failing allocation.
  Decode allocates blocks on demand; a dry pool preempts the
  lowest-priority youngest sequence (its blocks free immediately, it
  re-queues and later resumes by re-prefilling its full context).
- **token streaming**: every sequence owns an asyncio queue the step loop
  feeds one ``(token, final)`` pair per step; the serving adapter yields
  them through ``ServerCore.infer_decoupled`` so each decode step emits
  one response per active sequence on the decoupled gRPC stream and the
  OpenAI SSE front-end.
- **speculative decoding** (``llm/speculation.py``): when the model opts
  in, each step drafts up to K candidate tokens per sequence and the
  target verifies all K+1 positions in ONE multi-query paged-attention
  call; accepted tokens stream as multiple queue entries per step.  The
  emitted stream is token-for-token identical to plain decoding (greedy
  and seeded sampling both) — see :meth:`LlmEngine._spec_decode`.

Single-owner concurrency: every public method runs on the serving event
loop (the decoupled path executes models there); device calls hop to the
injected executor so the loop never blocks on the accelerator. Clock
reads go through the injected ``clock_ns``, so deadline behavior is
testable on fake clocks.
"""

import asyncio
import concurrent.futures
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from client_tpu_torch.llm.kv_cache import BlockAllocator, CacheCapacityError, TRASH_BLOCK
from client_tpu_torch.scheduling import (
    PriorityQueue,
    QueueFullError,
    QueueTimeoutError,
    SchedulingError,
)
from client_tpu_torch.utils import InferenceServerException


class EngineRecoveringError(SchedulingError):
    """The engine hit a fatal device failure and a background reload is
    in flight — the request is retryable, and ``Retry-After`` tells the
    client when the reload is expected to have finished.  Distinct from
    the closed-until-manual-reload UNAVAILABLE: this one promises the
    server is actively healing itself."""

    http_status = 503
    grpc_code = "UNAVAILABLE"
    reason = "recovering"

    def __init__(self, model_name: str, retry_after_s: float = 1.0):
        super().__init__(
            f"llm engine for '{model_name}' is recovering from a device "
            f"failure; retry shortly",
            retry_after_s=retry_after_s,
        )


class EngineConfig:
    """Engine sizing knobs.

    ``num_blocks`` counts physical blocks INCLUDING the reserved trash
    block; ``max_active`` bounds the decode batch (and the compiled batch
    buckets); ``max_queue`` bounds the waiting room (0 = unbounded);
    ``max_seq_len`` is the model's context limit (prompt + max_tokens
    validated against it at submit); ``priority_levels`` sizes the
    waiting queue's priority lanes; ``prefix_sharing`` turns the
    copy-on-write prompt-block index on (default) or off (the A/B
    baseline for the sharing bench); ``spec_k`` is the speculative
    lookahead — the most draft tokens one verify step may carry per
    sequence (0 disables speculation; admission counts the worst-case
    ``K+1`` growth for speculation-enabled sequences).
    """

    __slots__ = (
        "block_size",
        "num_blocks",
        "max_active",
        "max_queue",
        "max_seq_len",
        "priority_levels",
        "default_max_tokens",
        "prefill_bucket_min",
        "prefix_sharing",
        "spec_k",
    )

    def __init__(
        self,
        block_size: int = 16,
        num_blocks: int = 129,
        max_active: int = 8,
        max_queue: int = 64,
        max_seq_len: int = 512,
        priority_levels: int = 3,
        default_max_tokens: int = 16,
        prefill_bucket_min: int = 8,
        prefix_sharing: bool = True,
        spec_k: int = 0,
    ):
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_active = max(1, int(max_active))
        self.max_queue = max(0, int(max_queue))
        self.max_seq_len = int(max_seq_len)
        self.priority_levels = max(1, int(priority_levels))
        self.default_max_tokens = int(default_max_tokens)
        self.prefill_bucket_min = int(prefill_bucket_min)
        self.prefix_sharing = bool(prefix_sharing)
        self.spec_k = max(0, int(spec_k))

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_seq_len + self.block_size - 1) // self.block_size


_WAITING = "waiting"
_RUNNING = "running"
_DONE = "done"


def block_bucket(n: int) -> int:
    """Page-table width bucket: powers of two up to 8 blocks, multiples
    of 8 beyond. Finer than pure powers of two at the top (a 17-block
    context pays for 24, not 32) while still bounding the compiled
    program count to O(max_blocks / 8 + 3)."""
    n = max(1, int(n))
    if n <= 8:
        bucket = 1
        while bucket < n:
            bucket *= 2
        return bucket
    return ((n + 7) // 8) * 8


def _int_param(name: str, value: Any) -> int:
    """Coerce a wire request parameter; malformed values are a client
    error (400/INVALID_ARGUMENT), never an internal 500."""
    try:
        return int(value)
    except (TypeError, ValueError):
        raise InferenceServerException(
            f"request parameter {name!r} must be an integer, got {value!r}"
        ) from None


def _spec_param(value: Any) -> bool:
    """The per-request ``speculation`` parameter: ``on`` (default) /
    ``off`` — the genai-perf A/B switch. Anything else is a 400."""
    if value is None or value == "":
        return True
    if isinstance(value, bool):
        return value
    token = str(value).strip().lower()
    if token in ("on", "true", "1"):
        return True
    if token in ("off", "false", "0"):
        return False
    raise InferenceServerException(
        f"request parameter 'speculation' must be 'on' or 'off', "
        f"got {value!r}"
    )


def _recovery_param(value: Any) -> bool:
    """The per-request ``recovery`` parameter: ``resume`` (default)
    replays the sequence through an engine reload; ``fail`` opts out —
    the client would rather see a retryable error than a transparently
    resumed stream.  Anything else is a 400."""
    if value is None or value == "":
        return True
    token = str(value).strip().lower()
    if token == "resume":
        return True
    if token == "fail":
        return False
    raise InferenceServerException(
        f"request parameter 'recovery' must be 'resume' or 'fail', "
        f"got {value!r}"
    )


def _float_param(name: str, value: Any) -> float:
    """Like :func:`_int_param` for float-valued wire parameters."""
    try:
        result = float(value)
    except (TypeError, ValueError):
        raise InferenceServerException(
            f"request parameter {name!r} must be a number, got {value!r}"
        ) from None
    if result != result or result in (float("inf"), float("-inf")):
        raise InferenceServerException(
            f"request parameter {name!r} must be finite, got {value!r}"
        )
    return result


class Sequence:
    """One generation request: scheduling state + the token stream handle.

    Async-iterating a sequence yields ``(token_id, final)`` pairs as the
    step loop produces them. ``context`` (prompt + generated so far) is
    what a resume-after-preemption re-prefills.
    """

    __slots__ = (
        "seq_id",
        "prompt",
        "generated",
        "max_tokens",
        "priority_level",
        "deadline_ns",
        "timeout_us",
        "state",
        "blocks",
        "page_table",
        "last_token",
        "position",
        "cancelled",
        "preemptions",
        "temperature",
        "top_k",
        "seed",
        "block_hashes",
        "shared_blocks",
        "spec_enabled",
        "recovery_resume",
        "_out",
        "_engine",
    )

    def __init__(self, seq_id, prompt, max_tokens, priority_level,
                 deadline_ns, timeout_us, max_blocks: int, engine,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 spec_enabled: bool = True, recovery_resume: bool = True):
        self.seq_id = seq_id
        self.prompt: List[int] = prompt
        self.generated: List[int] = []
        self.max_tokens = max_tokens
        self.priority_level = priority_level
        self.deadline_ns = deadline_ns
        self.timeout_us = timeout_us
        self.state = _WAITING
        self.blocks: List[int] = []
        self.page_table = np.zeros([max_blocks], dtype=np.int32)
        self.last_token = 0
        self.position = 0
        self.cancelled = False
        self.preemptions = 0
        # sampling: temperature <= 0 is greedy; the PRNG key chain is
        # (seed, index-of-generated-token), so a preempt-and-resume
        # replays the exact same draws it would have made uninterrupted
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        # per-request speculation opt-out (the harness A/B switch); only
        # meaningful on an engine configured with spec_k > 0
        self.spec_enabled = spec_enabled
        # engine-fatal policy: True replays this sequence through a
        # reload (the PRNG chain keyed on (seed, token-index) makes the
        # resumed stream token-identical), False fails it immediately
        self.recovery_resume = recovery_resume
        # chained content hashes of the prompt's FULL blocks (computed
        # once at submit; matched against / published to the allocator's
        # shared index at every admission, including resumes)
        self.block_hashes: List[bytes] = []
        # leading blocks this sequence references but must never write
        self.shared_blocks = 0
        self._out: asyncio.Queue = asyncio.Queue()
        self._engine = engine

    @property
    def context(self) -> List[int]:
        return self.prompt + self.generated

    def emit(self, token: int, final: bool) -> None:
        self._out.put_nowait(("tok", int(token), final))

    def fail(self, exc: BaseException) -> None:
        # _DONE keeps the adapter's unconditional release() from booking
        # a failed/expired sequence as a client cancellation
        self.state = _DONE
        self._out.put_nowait(("err", exc, True))

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self.cancelled:
            raise StopAsyncIteration
        kind, value, final = await self._out.get()
        if kind == "end":
            raise StopAsyncIteration
        if kind == "err":
            raise value
        if final:
            # mark consumed-to-completion so release() is a no-op
            self.cancelled = True
            self.state = _DONE
            return value, True
        return value, False


class LlmEngine:
    """The continuous-batching engine; see the module docstring.

    ``prefill_fn(tokens[1, L], page_table[max_blocks], pages, last_index,
    start_index) -> (logits[1, V], pages)`` (``tokens`` holds ONLY the
    unshared suffix ``context[start_index:]``; ``last_index`` is its
    local last-token index; ``start_index`` is 0 when nothing matched)
    and ``decode_fn(tokens[B], positions[B], page_tables[B, NB], pages)
    -> (logits[B, V], pages)`` (``NB`` is the engine's ragged block
    bucket — any width up to ``max_blocks_per_seq``) are the injected
    device callables, which return host (numpy) logits; ``pages`` is
    opaque to the engine.
    ``metrics`` implements the ServerMetrics LLM hooks (set_kv_blocks /
    set_llm_sequences / observe_llm_step / observe_llm_preemption /
    observe_prefix_hits / observe_rejection / observe_llm_speculation);
    None disables export.

    Speculative decoding (``engine_config.spec_k > 0`` plus both
    ``decode_multi_fn`` and ``proposer``): each step first asks the
    proposer for up to K draft tokens per running sequence, then runs
    ``decode_multi_fn(tokens[B, T], positions[B, T], lengths[B],
    page_tables[B, NB], pages) -> (logits[B, T, V], pages)`` — ONE
    ragged verify call for all lanes — and walks each lane's logits
    with the same (seed, token_index) PRNG chain plain decoding uses,
    emitting sampled tokens while they match the drafts.  The emitted
    stream is therefore token-for-token identical to non-speculative
    decoding; speculation only changes how many tokens one device call
    yields.  Draft K/V lands in the sequence's exclusively-owned tail
    blocks only (the COW write assertion covers the whole speculative
    range) and lookahead blocks are rolled back to the plain-decode
    footprint after every verify step, so between steps a speculative
    engine holds exactly the blocks a non-speculative one would.
    """

    def __init__(
        self,
        prefill_fn: Callable,
        decode_fn: Callable,
        pages: Any,
        engine_config: EngineConfig,
        model_name: str = "llm_engine",
        metrics: Any = None,
        executor: Any = None,
        logger: Any = None,
        clock_ns: Callable[[], int] = time.monotonic_ns,
        decode_multi_fn: Optional[Callable] = None,
        proposer: Any = None,
    ):
        self.config = engine_config
        self.model_name = model_name
        self.allocator = BlockAllocator(
            engine_config.num_blocks, engine_config.block_size
        )
        self.metrics = metrics
        self.logger = logger
        self._clock_ns = clock_ns
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._decode_multi = decode_multi_fn
        self._proposer = proposer
        # speculation requires all three legs; a partial wiring (k but
        # no verify fn, or vice versa) silently runs plain decode
        self._speculative = (
            engine_config.spec_k > 0
            and decode_multi_fn is not None
            and proposer is not None
        )
        self._pages = pages
        self._executor = executor
        # device calls running on the executor: a quarantine cancels the
        # step loop, not a call a worker thread is running (settle())
        self._device_calls = set()
        self._waiting = PriorityQueue(levels=engine_config.priority_levels)
        self._running: List[Sequence] = []
        # the one sequence mid-prefill in _admit: it owns blocks but is
        # in neither _waiting nor _running, so shutdown/failure cleanup
        # must cover it explicitly
        self._admitting: Optional[Sequence] = None
        self._seq_counter = 0
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._closed = False
        # engine-fatal recovery: when a supervisor wired on_fatal, a
        # fatal step failure QUARANTINES the engine (recovering=True,
        # submits 503 with Retry-After=retry_after_s) instead of failing
        # the waiting room — resumable sequences park in _survivors until
        # a reloaded engine adopt()s them
        self.on_fatal: Optional[Callable[[BaseException], None]] = None
        self.recovering = False
        self.retry_after_s = 1.0
        self.last_failure: Optional[BaseException] = None
        self._survivors: List[Sequence] = []
        # cumulative counters (also mirrored to the metrics registry)
        self.steps = 0
        self.tokens_generated = 0
        self.preemptions = 0
        self.completed = 0
        self.cancelled_count = 0
        self.expired = 0
        # decode-step emissions only (prefill first-tokens excluded) and
        # the lane-steps that produced them (one per live lane per
        # step): step_tokens / lane_steps is the tokens-per-step A/B
        # headline — exactly 1.0 for a non-speculative engine by
        # construction
        self.step_tokens = 0
        self.lane_steps = 0
        # speculation accounting: drafts verified, drafts accepted, and
        # how many steps ran the multi-query verify path
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # full prompt blocks demanded across admissions — with
        # allocator.prefix_hits this yields the true prefix hit rate
        # (hits / demand), since the allocator only ever sees the
        # pre-matched hash slice
        self.prefix_block_demand = 0

    # -- submission / cancellation (serving-loop only) -----------------------

    def submit(
        self,
        prompt_ids: List[int],
        max_tokens: Optional[int] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> Sequence:
        """Admit one generation request into the waiting queue.

        Raises synchronously: :class:`InferenceServerException` for
        requests that can NEVER run (context exceeds the model's
        ``max_seq_len`` or the pool's total capacity) and
        :class:`QueueFullError` (429/RESOURCE_EXHAUSTED) once
        ``max_queue`` requests wait — the capacity-based admission the
        paged cache exists for.
        """
        if self._closed:
            if self.recovering:
                # quarantined with a reload in flight: same UNAVAILABLE
                # wire face, but with Retry-After so clients back off for
                # roughly one reload instead of hammering the 503
                raise EngineRecoveringError(
                    self.model_name, retry_after_s=self.retry_after_s
                )
            # UNAVAILABLE: a closed engine (shutdown, device failure, or
            # a lost pod worker) is a retryable replica-level condition —
            # the fleet's failover machinery routes around it
            raise InferenceServerException(
                f"llm engine for '{self.model_name}' is closed",
                status="UNAVAILABLE",
            )
        parameters = parameters or {}
        config = self.config
        if max_tokens is None:
            max_tokens = _int_param(
                "max_tokens",
                parameters.get("max_tokens", config.default_max_tokens),
            )
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise InferenceServerException("empty prompt")
        if max_tokens < 1:
            raise InferenceServerException(
                f"max_tokens must be >= 1, got {max_tokens}"
            )
        total = len(prompt) + max_tokens
        if total > config.max_seq_len:
            raise InferenceServerException(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds max sequence length {config.max_seq_len}"
            )
        block_hashes = (
            self.allocator.chain_hashes(prompt)
            if config.prefix_sharing
            else []
        )
        # capacity fast-fail against POST-MATCH demand: blocks the shared
        # index already holds are referenced, not allocated, so a prompt
        # mostly covered by a live shared prefix must not be 400'd for a
        # worst-case block count it will never request (the index can
        # shrink before admission — then the request queues like any
        # other too-big-for-now work instead of failing)
        matched_now = min(
            self.allocator.match_count(block_hashes),
            self._match_cap(len(prompt)),
        )
        if self.allocator.blocks_for(total) - matched_now > self.allocator.capacity:
            raise InferenceServerException(
                f"request needs {self.allocator.blocks_for(total)} KV "
                f"blocks ({matched_now} shared) but the pool holds "
                f"{self.allocator.capacity}"
            )
        # parse the remaining wire parameters BEFORE the queue-full
        # check: a malformed request is a 400, not a 429
        level = _int_param("priority", parameters.get("priority", 0) or 0)
        if level <= 0:
            # 0/negative = unset -> the default (lowest) lane, matching
            # QueuePolicy.priority_of — a negative value must not clamp
            # to the HIGHEST lane (priority escalation) downstream
            level = config.priority_levels
        timeout_us = _int_param(
            "timeout_us",
            parameters.get("timeout_us", parameters.get("timeout", 0)) or 0,
        )
        temperature = _float_param(
            "temperature", parameters.get("temperature", 0.0) or 0.0
        )
        if temperature < 0.0:
            raise InferenceServerException(
                f"request parameter 'temperature' must be >= 0, "
                f"got {temperature}"
            )
        top_k = _int_param("top_k", parameters.get("top_k", 0) or 0)
        if top_k < 0:
            raise InferenceServerException(
                f"request parameter 'top_k' must be >= 0, got {top_k}"
            )
        spec_enabled = _spec_param(parameters.get("speculation"))
        recovery_resume = _recovery_param(parameters.get("recovery"))
        seed = _int_param("seed", parameters.get("seed", 0) or 0)
        if seed < 0:
            # np.random.default_rng rejects negative entropy — validate
            # here so a bad seed is a 400, not an engine-fatal crash at
            # first sample
            raise InferenceServerException(
                f"request parameter 'seed' must be >= 0, got {seed}"
            )
        if config.max_queue and len(self._waiting) >= config.max_queue:
            error = QueueFullError(self.model_name, config.max_queue)
            if self.metrics is not None:
                self.metrics.observe_rejection(self.model_name, error.reason)
            raise error
        now_ns = self._clock_ns()
        deadline_ns = now_ns + timeout_us * 1000 if timeout_us > 0 else None
        self._seq_counter += 1
        seq = Sequence(
            self._seq_counter,
            prompt,
            max_tokens,
            level,
            deadline_ns,
            timeout_us,
            config.max_blocks_per_seq,
            self,
            temperature=temperature,
            top_k=top_k,
            seed=seed,
            spec_enabled=spec_enabled,
            recovery_resume=recovery_resume,
        )
        seq.block_hashes = block_hashes
        self._waiting.push(seq, level=level, deadline_ns=deadline_ns)
        self._ensure_task()
        self._publish()
        return seq

    def release(self, seq: Sequence) -> None:
        """Drop a sequence (client cancellation / stream teardown).

        Idempotent; safe on finished sequences. The step loop frees the
        KV blocks and removes the sequence within one iteration."""
        if seq.state == _DONE:
            return
        if not seq.cancelled:
            seq.cancelled = True
            self.cancelled_count += 1
        # unblock a consumer parked on the queue
        seq._out.put_nowait(("end", None, True))
        self._wake_loop()

    def close(self) -> None:
        """Stop the step loop and fail everything still queued/running.

        Idempotent. Thread-safe: while the serving loop is alive, an
        off-loop caller (ServerCore.close from the main thread) hops
        onto it — cancelling the task and waking parked stream
        consumers from a foreign thread would race the loop. Once the
        loop is stopped/closed, teardown runs directly."""
        self._closed = True
        task = self._task
        if task is not None and not task.done():
            loop = task.get_loop()
            try:
                on_loop = asyncio.get_running_loop() is loop
            except RuntimeError:
                on_loop = False
            if not on_loop and not loop.is_closed():
                try:
                    loop.call_soon_threadsafe(self._close_on_loop)
                    return
                except RuntimeError:
                    pass  # loop closed between the check and the call
        self._close_on_loop()

    def _close_on_loop(self) -> None:
        self._closed = True
        if self._task is not None:
            try:
                self._task.cancel()
            except RuntimeError:
                pass  # owning loop already closed
            self._task = None
        self._fail_all(
            InferenceServerException(
                f"llm engine for '{self.model_name}' shut down"
            )
        )

    def _fail_all(self, error: BaseException) -> None:
        """Free and fail every live sequence — running, waiting, and the
        one possibly mid-prefill — so no consumer hangs and no KV block
        leaks. Idempotent (free is; fail on a done sequence is inert)."""
        if self._admitting is not None:
            self.allocator.free(self._admitting.seq_id)
            self._admitting.fail(error)
            self._admitting = None
        for seq in self._running:
            self.allocator.free(seq.seq_id)
            seq.fail(error)
        self._running.clear()
        items = self._waiting.scan()
        for item in items:
            item.value.fail(error)
        self._waiting.remove(items)
        self._publish()

    # -- engine-fatal quarantine & recovery ----------------------------------

    def _quarantine(self, exc: BaseException) -> None:
        """Handle a fatal step-loop failure.

        A failed device call may have left the page pool half-written
        (the device callables update it in place), so the engine cannot
        safely serve against ``self._pages`` anymore — it stops taking
        work either way.  Without a supervisor (``on_fatal`` unset) this
        is the plain behavior: fail everything, refuse new work until a
        manual ``warmup()``.  With one, live sequences that opted into
        resume park in ``_survivors`` (their consumers stay blocked on
        their token queues — nothing is failed, nothing streams) and the
        supervisor's reload eventually :meth:`adopt`\\ s them onto a fresh
        engine; everything else fails with the preserved status."""
        if self.logger is not None:
            self.logger.error("llm_engine_loop_failed", exc=exc,
                              model=self.model_name)
        # preserve the inner status so a lost pod worker (UNAVAILABLE)
        # stays retryable instead of collapsing to a bare 500
        status = (
            exc.status() if isinstance(exc, InferenceServerException)
            else None
        )
        error = InferenceServerException(
            f"llm engine step failed: {exc}", status=status
        )
        self.last_failure = exc
        self._closed = True
        resumable = self.on_fatal is not None
        survivors: List[Sequence] = []

        def triage(seq: Sequence) -> None:
            self.allocator.free(seq.seq_id)
            seq.blocks = []
            seq.shared_blocks = 0
            seq.page_table[:] = TRASH_BLOCK
            if seq.cancelled or seq.state == _DONE:
                seq.state = _DONE
            elif resumable and seq.recovery_resume:
                seq.state = _WAITING
                survivors.append(seq)
            else:
                seq.fail(error)

        if self._admitting is not None:
            triage(self._admitting)
            self._admitting = None
        for seq in self._running:
            triage(seq)
        self._running.clear()
        items = self._waiting.scan()
        for item in items:
            triage(item.value)
        self._waiting.remove(items)
        self._survivors = survivors
        self.recovering = resumable
        self._publish()
        if resumable:
            try:
                self.on_fatal(exc)
            except Exception as hook_exc:  # noqa: BLE001 - no rescue -> fail
                if self.logger is not None:
                    self.logger.error("llm_engine_recovery_hook_failed",
                                      exc=hook_exc, model=self.model_name)
                self.recovering = False
                for seq in self._survivors:
                    seq.fail(error)
                self._survivors = []

    def quarantine(self, reason: str = "externally induced") -> None:
        """Force the engine-fatal path from OUTSIDE the step loop (the
        pod coordinator quarantines the engine before tearing down a
        broken mesh; chaos tests induce failures with it).  Thread-safe
        via the same loop-hop :meth:`close` uses; a direct call only
        when no loop/task is live."""
        error = InferenceServerException(
            f"llm engine for '{self.model_name}' failed: {reason}",
            status="UNAVAILABLE",
        )
        task = self._task
        if task is not None and not task.done():
            loop = task.get_loop()
            try:
                on_loop = asyncio.get_running_loop() is loop
            except RuntimeError:
                on_loop = False
            if not on_loop and not loop.is_closed():
                try:
                    loop.call_soon_threadsafe(self._quarantine_on_loop, error)
                    return
                except RuntimeError:
                    pass  # loop closed between the check and the call
        self._quarantine_on_loop(error)

    def _quarantine_on_loop(self, error: BaseException) -> None:
        if self._closed:
            return
        if self._task is not None:
            try:
                self._task.cancel()
            except RuntimeError:
                pass  # owning loop already closed
            self._task = None
        self._quarantine(error)

    def detach_survivors(self) -> List[Sequence]:
        """Hand the quarantined sequences to whoever will adopt them
        onto the replacement engine (clears the local list — exactly one
        recovery owns each survivor)."""
        survivors, self._survivors = self._survivors, []
        return survivors

    def fail_survivors(self, error: BaseException) -> None:
        """Recovery gave up: fail anything still parked and drop the
        recovering promise so submits report plain closed."""
        self.recovering = False
        for seq in self.detach_survivors():
            seq.fail(error)

    def adopt(self, survivors: List[Sequence]) -> None:
        """Re-queue sequences that survived a predecessor engine's
        quarantine (serving-loop only, like :meth:`submit`).

        Each survivor re-enters the waiting room exactly like a
        preempted sequence: its ``context`` (prompt + tokens already
        streamed) re-prefills in one call and decoding resumes on the
        same (seed, token-index) PRNG chain, so the resumed stream is
        token-identical to an uninterrupted one.  Sequences that already
        streamed tokens requeue WITHOUT a deadline (matching
        ``_preempt`` — their first tokens are live downstream; expiring
        them now would break streams the engine already committed to)."""
        for seq in survivors:
            if seq.cancelled or seq.state == _DONE:
                continue
            # adopted ids must not collide with this engine's own counter
            self._seq_counter = max(self._seq_counter, seq.seq_id)
            seq._engine = self
            seq.state = _WAITING
            deadline_ns = seq.deadline_ns if not seq.generated else None
            self._waiting.push(
                seq, level=seq.priority_level, deadline_ns=deadline_ns
            )
        self._ensure_task()
        self._publish()

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "active_sequences": len(self._running),
            "waiting_sequences": len(self._waiting),
            "recovering": self.recovering,
            "recovery_survivors": len(self._survivors),
            "kv_blocks_in_use": self.allocator.blocks_in_use,
            "kv_blocks_total": self.allocator.capacity,
            "kv_blocks_shared": self.allocator.blocks_shared,
            "block_size": self.allocator.block_size,
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "preemptions": self.preemptions,
            "completed": self.completed,
            "cancelled": self.cancelled_count,
            "expired": self.expired,
            "prefix_cache_hits": self.allocator.prefix_hits,
            "prefix_cache_queries": self.allocator.prefix_queries,
            "prefix_block_demand": self.prefix_block_demand,
            # speculation: tokens_per_step is the decode-only ratio (1.0
            # exactly for a non-speculative engine); acceptance is over
            # drafts actually verified, not merely proposed
            "speculative": self._speculative,
            "step_tokens": self.step_tokens,
            "lane_steps": self.lane_steps,
            "tokens_per_step": self.step_tokens / max(1, self.lane_steps),
            "spec_steps": self.spec_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": (
                self.spec_accepted / max(1, self.spec_proposed)
            ),
        }

    # -- step loop -----------------------------------------------------------

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            loop = asyncio.get_running_loop()
            # fresh Event per task: an asyncio.Event binds to the loop it
            # is first awaited on, and a restarted engine may be serving
            # a different loop than the task that just finished
            self._wake = asyncio.Event()
            self._task = loop.create_task(self._run())
        self._wake_loop()

    def _wake_loop(self) -> None:
        if self._wake is not None:
            self._wake.set()

    async def _run_device(self, fn, *args):
        if self._executor is None:
            return fn(*args)
        future = self._executor.submit(fn, *args)
        self._device_calls.add(future)
        future.add_done_callback(self._device_calls.discard)
        return await asyncio.wrap_future(future)

    def settle(self, timeout_s: float = 60.0) -> None:
        """Wait (up to ``timeout_s``) for the device calls still running
        on the executor — after a quarantine, the step the loop gave up
        on may still be issuing work for the old pool. Thread-safe."""
        pending = list(self._device_calls)
        if pending:
            concurrent.futures.wait(pending, timeout=timeout_s)

    async def _run(self) -> None:
        try:
            while not self._closed:
                if not self._running and not len(self._waiting):
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                self._prune()
                await self._admit()
                if self._running:
                    await self._step()
                self._publish()
                # one cooperative yield per iteration: stream consumers
                # on this loop drain their queues between steps
                await asyncio.sleep(0)
        except asyncio.CancelledError:
            # shutdown mid-iteration (possibly mid-prefill): clean up on
            # the loop before unwinding so nothing leaks or hangs
            self._fail_all(
                InferenceServerException(
                    f"llm engine for '{self.model_name}' shut down"
                )
            )
            raise
        except Exception as e:  # noqa: BLE001 - engine must not die silently
            self._quarantine(e)

    def _prune(self) -> None:
        """Drop cancelled sequences and expire waiting deadlines."""
        now_ns = self._clock_ns()
        for item in self._waiting.expire(now_ns):
            seq = item.value
            self.expired += 1
            if not seq.cancelled:
                error = QueueTimeoutError(self.model_name, seq.timeout_us)
                if self.metrics is not None:
                    self.metrics.observe_rejection(
                        self.model_name, error.reason
                    )
                seq.fail(error)
        stale = [i for i in self._waiting.scan() if i.value.cancelled]
        if stale:
            self._waiting.remove(stale)
        if any(seq.cancelled for seq in self._running):
            for seq in self._running:
                if seq.cancelled:
                    self.allocator.free(seq.seq_id)
                    seq.state = _DONE
            self._running = [s for s in self._running if not s.cancelled]

    def _match_cap(self, context_len: int) -> int:
        """Most shared blocks a context of this length may reference: at
        least ONE token (the last) must always be recomputed, because the
        first sampled token needs its logits — an all-block-aligned full
        match would otherwise leave nothing to prefill."""
        return max(0, (context_len - 1) // self.allocator.block_size)

    async def _admit(self) -> None:
        """Prefill waiting sequences into the running batch, in
        (priority, arrival) order, while the block pool and the
        ``max_active`` bound allow. The first blocker stops admission —
        a full cache queues behind it rather than skipping ahead (no
        starvation of large prompts). Prompt blocks already in the shared
        index are referenced instead of allocated (capacity math counts
        NEW blocks only) and their prefill is skipped: TTFT is one
        partial prefill of the unshared suffix."""
        allocator = self.allocator
        for item in self._waiting.scan():
            seq: Sequence = item.value
            if len(self._running) >= self.config.max_active:
                break
            context = seq.context
            # +1: the first decode step writes the freshly-sampled
            # token's K/V at position len(context). Speculation adds its
            # worst-case lookahead on top (the first verify step writes
            # up to K draft positions beyond that), clamped by the
            # sequence's own context ceiling — draft writes never pass
            # position prompt+max_tokens-2, so total capacity math is
            # unchanged and the admission demand stays exact.
            need = allocator.blocks_for(
                min(
                    len(seq.prompt) + seq.max_tokens,
                    len(context) + 1 + self._spec_k_for(seq),
                )
            )
            cap = self._match_cap(len(context))
            usable = min(
                allocator.match_count(seq.block_hashes), cap, len(seq.block_hashes)
            )
            if need - usable > allocator.capacity:
                # admitted on the strength of a shared prefix that has
                # since been reclaimed (its sharers finished): the
                # residual demand can never be satisfied — fail cleanly
                # instead of blocking the admission queue forever
                self._waiting.remove([item])
                error = CacheCapacityError(
                    f"request needs {need - usable} KV blocks but the "
                    f"pool holds {allocator.capacity} (a previously "
                    f"shared prefix is no longer resident)"
                )
                if self.metrics is not None:
                    self.metrics.observe_rejection(
                        self.model_name, "kv_capacity"
                    )
                seq.fail(error)
                continue
            if need - usable > allocator.free_blocks:
                break
            self._waiting.remove([item])
            if seq.cancelled:
                seq.state = _DONE
                continue
            self.prefix_block_demand += len(seq.block_hashes)
            blocks, matched = allocator.allocate_shared(
                seq.seq_id, need, seq.block_hashes[:usable]
            )
            seq.blocks = blocks
            seq.shared_blocks = matched
            seq.page_table[:] = TRASH_BLOCK
            seq.page_table[: len(blocks)] = blocks
            # visible to _fail_all while the prefill await is in flight:
            # the sequence owns blocks but is in neither queue nor batch.
            # Deliberately NOT cleared in a finally — on cancellation or
            # device failure it must still be set when the _run handlers
            # reclaim it; only a successful prefill clears it here.
            self._admitting = seq
            logits = await self._prefill_one(
                seq, context, matched * allocator.block_size
            )
            # the sequence's full prompt blocks (matched + just
            # prefilled) now hold valid K/V — publish them for the next
            # identical prefix
            if self.config.prefix_sharing:
                allocator.publish(seq.seq_id, seq.block_hashes)
            self._admitting = None
            if matched and self.metrics is not None:
                self.metrics.observe_prefix_hits(self.model_name, matched)
            token = self._sample(seq, logits)
            seq.generated.append(token)
            seq.last_token = token
            seq.position = len(context)
            final = len(seq.generated) >= seq.max_tokens
            seq.emit(token, final)
            self.tokens_generated += 1
            if self.metrics is not None:
                self.metrics.observe_llm_tokens(self.model_name)
            if final:
                self._finish(seq)
            else:
                seq.state = _RUNNING
                self._running.append(seq)

    async def _prefill_one(self, seq: Sequence, context: List[int],
                           start: int) -> np.ndarray:
        """Prefill ``context[start:]`` (``start`` = matched shared
        blocks, always block-aligned and < len(context)) and return the
        last real token's logits row."""
        from client_tpu_torch.server.models import pad_batch_bucket

        suffix = context[start:]
        bucket = min(
            pad_batch_bucket(
                len(suffix), minimum=self.config.prefill_bucket_min
            ),
            self.config.max_seq_len,
        )
        tokens = np.zeros([1, bucket], dtype=np.int32)
        tokens[0, : len(suffix)] = suffix
        # A failing device call is ENGINE-fatal, not sequence-fatal: the
        # inputs were engine-constructed (request validation happened at
        # submit) and the in-place page pool may be half-written — let it
        # propagate to the _run catch-all, which fails everything and
        # marks the engine for reload.
        logits, self._pages = await self._run_device(
            self._prefill,
            tokens,
            seq.page_table,
            self._pages,
            len(suffix) - 1,
            start,
        )
        return np.asarray(logits)[0]

    def _sample(self, seq: Sequence, logits: np.ndarray) -> int:
        """Next token from a logits row (the single-row prefill path);
        delegates to the batched sampler with this row's PRNG index."""
        return self._sample_rows([(seq, logits, len(seq.generated))])[0]

    def _sample_rows(self, items) -> List[int]:
        """Sample one token per ``(seq, logits_row, gen_index)`` item in
        ONE vectorized pass — the full-batch decode step and the K+1
        rows of a speculative verify all share it.

        The softmax/top-k pipeline runs batched in float64 (elementwise
        ops and per-row reductions, so each row's bits match the scalar
        pipeline exactly), but every row's DRAW still comes from its own
        ``np.random.default_rng((seed, gen_index))`` — the PRNG key is a
        pure function of the token's index in the generation, never of
        batch composition or speculation outcome, which is what makes
        preemption replay and spec-on/spec-off streams token-identical
        (tests pin the streams bit-exactly against the scalar path)."""
        n = len(items)
        out = [0] * n
        greedy = [i for i in range(n) if items[i][0].temperature <= 0.0]
        sampled = [i for i in range(n) if items[i][0].temperature > 0.0]
        if greedy:
            rows = np.stack([np.asarray(items[i][1]) for i in greedy])
            for i, pick in zip(greedy, rows.argmax(axis=-1)):
                out[i] = int(pick)
        if sampled:
            rows = np.stack(
                [np.asarray(items[i][1]) for i in sampled]
            ).astype(np.float64)
            temps = np.array(
                [items[i][0].temperature for i in sampled], dtype=np.float64
            )
            scaled = rows / temps[:, None]
            vocab = scaled.shape[-1]
            for j, i in enumerate(sampled):
                top_k = items[i][0].top_k
                if top_k and top_k < vocab:
                    kth = np.partition(scaled[j], -top_k)[-top_k]
                    scaled[j] = np.where(scaled[j] < kth, -np.inf, scaled[j])
            scaled -= scaled.max(axis=-1, keepdims=True)
            probs = np.exp(scaled)
            probs /= probs.sum(axis=-1, keepdims=True)
            for j, i in enumerate(sampled):
                seq, _, gen_index = items[i]
                rng = np.random.default_rng((seq.seed, gen_index))
                out[i] = int(rng.choice(vocab, p=probs[j]))
        return out

    def _spec_k_for(self, seq: Sequence) -> int:
        """Draft tokens a verify step may carry for this sequence NOW:
        the engine's lookahead, clamped so speculation never writes K/V
        past position ``prompt + max_tokens - 2`` (the last token of a
        generation needs no lookahead, which also keeps total capacity
        math identical to the non-speculative engine's)."""
        if not self._speculative or not seq.spec_enabled:
            return 0
        remaining = seq.max_tokens - len(seq.generated)
        return max(0, min(self.config.spec_k, remaining - 1))

    def _pick_victim(self) -> Optional[Sequence]:
        """Preemption victim: lowest priority (highest level number)
        first, youngest (most blocks still to earn) among equals."""
        if not self._running:
            return None
        return max(
            self._running,
            key=lambda s: (s.priority_level, -len(s.generated), s.seq_id),
        )

    def _preempt(self, victim: Sequence) -> None:
        """Push a running sequence back to the waiting queue and free its
        blocks NOW; it resumes later by re-prefilling prompt+generated
        (tokens already streamed stay streamed — deterministic greedy
        decode regenerates the identical cache)."""
        self.allocator.free(victim.seq_id)
        victim.blocks = []
        victim.shared_blocks = 0
        victim.page_table[:] = TRASH_BLOCK
        victim.state = _WAITING
        victim.preemptions += 1
        self.preemptions += 1
        self._running.remove(victim)
        # NO queue deadline on the requeue: timeout_us bounds time-to-
        # START, which this sequence already satisfied — expiring a
        # partially-streamed generation as "timed out in queue" would
        # turn delivered tokens into a spurious 504
        self._waiting.push(victim, level=victim.priority_level)
        if self.metrics is not None:
            self.metrics.observe_llm_preemption(self.model_name)
        if self.logger is not None:
            self.logger.verbose(
                "llm_sequence_preempted",
                model=self.model_name,
                seq=victim.seq_id,
                generated=len(victim.generated),
            )

    async def _step(self) -> None:
        """One iteration-level decode step over every running sequence."""
        from client_tpu_torch.server.models import pad_batch_bucket

        allocator = self.allocator
        # allocate-on-demand: sequences whose next write position enters
        # a new block claim it now; a dry pool preempts until it fits
        for seq in list(self._running):
            if seq not in self._running:
                continue  # already preempted below
            while seq.position // allocator.block_size >= len(seq.blocks):
                try:
                    block = allocator.extend(seq.seq_id)
                    seq.blocks.append(block)
                    seq.page_table[len(seq.blocks) - 1] = block
                except CacheCapacityError:
                    if allocator.blocks_for(
                        seq.position + 1
                    ) > allocator.capacity:
                        # the whole pool could not hold this context:
                        # possible only for a request admitted against a
                        # shared prefix (post-match demand fit; gross
                        # footprint never can). Fail it BEFORE picking a
                        # victim — preempting peers for a request that
                        # can never fit would drain the whole batch
                        # first, and preempt-and-retry on itself would
                        # loop forever.
                        allocator.free(seq.seq_id)
                        self._running.remove(seq)
                        seq.fail(
                            CacheCapacityError(
                                f"context ({seq.position + 1} tokens) "
                                f"outgrew the KV pool "
                                f"({allocator.capacity} blocks)"
                            )
                        )
                        break
                    victim = self._pick_victim()
                    self._preempt(victim)
                    if victim is seq:
                        break
        batch = self._running
        if not batch:
            return
        if self._speculative:
            drafts = await self._propose(batch)
            if any(drafts):
                await self._spec_decode(batch, drafts)
            else:
                await self._plain_decode(batch)
        else:
            await self._plain_decode(batch)
        self._running = [s for s in self._running if s.state == _RUNNING]

    async def _plain_decode(self, batch: List[Sequence]) -> None:
        """The non-speculative decode body: one token per live lane."""
        from client_tpu_torch.server.models import pad_batch_bucket

        allocator = self.allocator
        n = len(batch)
        bucket = pad_batch_bucket(n)
        # ragged page-table width: the decode kernel's attention cost is
        # proportional to the table width it sees, so slice it to a
        # bucket of the LONGEST live sequence instead of always paying
        # max_seq_len (bounded recompiles; see block_bucket)
        nb = min(
            block_bucket(max(len(seq.blocks) for seq in batch)),
            self.config.max_blocks_per_seq,
        )
        tokens = np.zeros([bucket], dtype=np.int32)
        positions = np.zeros([bucket], dtype=np.int32)
        page_tables = np.zeros([bucket, nb], dtype=np.int32)
        for i, seq in enumerate(batch):
            tokens[i] = seq.last_token
            positions[i] = seq.position
            page_tables[i] = seq.page_table[:nb]
            # COW invariant: the block this lane is about to write must
            # be exclusively owned (shared prefix blocks are read-only;
            # growth always lands in fresh blocks). A violation means
            # allocator state is corrupt — engine-fatal, not a lane skip.
            write_block = seq.position // allocator.block_size
            if allocator.refcount(seq.blocks[write_block]) != 1:
                raise InferenceServerException(
                    f"COW violation: sequence {seq.seq_id} would write "
                    f"block {seq.blocks[write_block]} with refcount "
                    f"{allocator.refcount(seq.blocks[write_block])}"
                )
        logits, self._pages = await self._run_device(
            self._decode, tokens, positions, page_tables, self._pages
        )
        logits_rows = np.asarray(logits)[:n]
        self.steps += 1
        live = [
            (seq, row) for seq, row in zip(batch, logits_rows)
            if not seq.cancelled  # pruned (and freed) next iteration
        ]
        picks = self._sample_rows(
            [(seq, row, len(seq.generated)) for seq, row in live]
        )
        self.lane_steps += len(live)
        emitted = 0
        for (seq, _), token in zip(live, picks):
            self._emit_step_token(seq, token)
            emitted += 1
        if self.metrics is not None:
            # emitted (not n): cancelled lanes decoded but streamed
            # nothing, and the exported counter must agree with stats()
            self.metrics.observe_llm_step(self.model_name, n)
            if emitted:
                self.metrics.observe_llm_tokens(self.model_name, emitted)

    def _emit_step_token(self, seq: Sequence, token: int) -> bool:
        """Book ONE decode-step emission (plain and speculative paths
        share this accounting — the tokens_per_step headline depends on
        both booking identically). Returns True when the sequence just
        finished."""
        seq.generated.append(token)
        seq.last_token = token
        seq.position += 1
        self.tokens_generated += 1
        self.step_tokens += 1
        final = len(seq.generated) >= seq.max_tokens
        seq.emit(token, final)
        if final:
            self._finish(seq)
        return final

    # -- speculative decode (draft-propose + batched paged-verify) -----------

    async def _propose(self, batch: List[Sequence]) -> List[List[int]]:
        """One draft proposal per running lane (empty = no speculation
        for that lane this step: opted out, final token pending, or the
        proposer found nothing). Proposer failures degrade that lane to
        plain decode — a broken draft model must never take down the
        engine, whose own page state it cannot touch."""
        lanes = [
            (self._spec_k_for(seq), seq.context if not seq.cancelled else [])
            for seq in batch
        ]
        # submit all lanes before awaiting any: the proposals are
        # independent, so with an executor the draft computations overlap
        # instead of serializing B round-trips ahead of the verify call
        results = await asyncio.gather(
            *[
                self._run_device(self._proposer.propose, context, k)
                for k, context in lanes
                if k >= 1 and context
            ],
            return_exceptions=True,
        )
        drafts: List[List[int]] = []
        it = iter(results)
        for k, context in lanes:
            if k < 1 or not context:
                drafts.append([])
                continue
            proposal = next(it)
            if isinstance(proposal, BaseException):
                # a broken draft model must never take down the engine,
                # whose own page state it cannot touch
                if self.logger is not None:
                    self.logger.warning(
                        "llm_spec_proposer_failed",
                        model=self.model_name,
                        error=str(proposal),
                        rate_key=("llm_spec_proposer_failed", self.model_name),
                    )
                proposal = []
            drafts.append([int(t) for t in proposal][:k])
        return drafts

    async def _spec_decode(
        self, batch: List[Sequence], drafts: List[List[int]]
    ) -> None:
        """One speculative step: verify every lane's draft tokens (plus
        its mandatory next position) in ONE multi-query decode call,
        then emit the longest sampled prefix that agrees with the
        drafts. Every emitted token is sampled from target logits with
        the same (seed, index) key chain as plain decode, so the stream
        is identical — acceptance only decides how FAR one step gets."""
        from client_tpu_torch.server.models import pad_batch_bucket

        allocator = self.allocator
        block_size = allocator.block_size
        # opportunistic lookahead blocks: draft K/V needs coverage up to
        # position+k. A dry pool SHRINKS the lane's speculative window to
        # the blocks it already owns instead of preempting a peer —
        # speculation is an optimization and must never evict real work.
        k_effs: List[int] = []
        for seq, proposal in zip(batch, drafts):
            k_eff = min(len(proposal), self._spec_k_for(seq))
            while (
                k_eff > 0
                and (seq.position + k_eff) // block_size >= len(seq.blocks)
            ):
                try:
                    block = allocator.extend(seq.seq_id)
                    seq.blocks.append(block)
                    seq.page_table[len(seq.blocks) - 1] = block
                except CacheCapacityError:
                    k_eff = len(seq.blocks) * block_size - 1 - seq.position
            k_effs.append(max(0, k_eff))
        n = len(batch)
        k_max = max(k_effs)
        if k_max == 0:
            # every lane degraded (dry pool shrank all windows to zero):
            # this step is just a plain one
            await self._plain_decode(batch)
            return
        bucket = pad_batch_bucket(n)
        t_width = min(pad_batch_bucket(k_max + 1), self.config.spec_k + 1)
        nb = min(
            block_bucket(max(len(seq.blocks) for seq in batch)),
            self.config.max_blocks_per_seq,
        )
        tokens = np.zeros([bucket, t_width], dtype=np.int32)
        positions = np.zeros([bucket, t_width], dtype=np.int32)
        lengths = np.zeros([bucket], dtype=np.int32)
        page_tables = np.zeros([bucket, nb], dtype=np.int32)
        row_offsets = np.arange(t_width)
        for i, (seq, proposal, k_eff) in enumerate(
            zip(batch, drafts, k_effs)
        ):
            tokens[i, 0] = seq.last_token
            tokens[i, 1:1 + k_eff] = proposal[:k_eff]
            # padding rows clamp to the last real position: their writes
            # are masked off by `lengths`, and clamping keeps every page
            # lookup inside the lane's own table
            positions[i] = seq.position + np.minimum(row_offsets, k_eff)
            lengths[i] = k_eff + 1
            page_tables[i] = seq.page_table[:nb]
            # COW invariant over the WHOLE speculative write range: the
            # verify scatters K/V at position..position+k_eff, and none
            # of those blocks may be shared. Engine-fatal on violation,
            # exactly like the plain step's single-position assertion.
            for wb in range(
                seq.position // block_size,
                (seq.position + k_eff) // block_size + 1,
            ):
                if allocator.refcount(seq.blocks[wb]) != 1:
                    raise InferenceServerException(
                        f"COW violation: sequence {seq.seq_id} would "
                        f"speculatively write block {seq.blocks[wb]} "
                        f"with refcount "
                        f"{allocator.refcount(seq.blocks[wb])}"
                    )
        logits, self._pages = await self._run_device(
            self._decode_multi, tokens, positions, lengths, page_tables,
            self._pages,
        )
        logits_rows = np.asarray(logits)
        self.steps += 1
        self.spec_steps += 1
        # batched sampling across every candidate row of every live lane
        # (the verify consumes the vectorized sampler wholesale): rows
        # sampled past a lane's first mismatch are simply discarded —
        # each draw is keyed by (seed, index) alone, so sampling a row
        # never perturbs any later draw
        items = []
        spans = []
        for lane, (seq, k_eff) in enumerate(zip(batch, k_effs)):
            if seq.cancelled:
                spans.append((0, 0))
                continue
            start = len(items)
            n0 = len(seq.generated)
            items.extend(
                (seq, logits_rows[lane, t], n0 + t)
                for t in range(k_eff + 1)
            )
            spans.append((start, k_eff + 1))
        picks = self._sample_rows(items) if items else []
        self.lane_steps += sum(1 for _, count in spans if count)
        emitted_total = 0
        proposed_total = 0
        accepted_total = 0
        lane_tokens: List[int] = []  # per-lane emissions (histogram feed)
        for seq, proposal, k_eff, (start, count) in zip(
            batch, drafts, k_effs, spans
        ):
            if count == 0:
                continue  # cancelled: decoded but streams nothing
            proposed_total += k_eff
            emitted = 0
            for t in range(count):
                token = picks[start + t]
                matched = t < k_eff and token == proposal[t]
                if matched:
                    accepted_total += 1
                emitted += 1
                if self._emit_step_token(seq, token) or not matched:
                    break
            emitted_total += emitted
            lane_tokens.append(emitted)
            # rejected-draft rollback: blocks claimed for lookahead that
            # the accepted prefix did not reach go straight back to the
            # pool, restoring the plain-decode footprint (truncate raises
            # engine-fatally if a rolled-back block were shared)
            if seq.state == _RUNNING:
                keep = allocator.blocks_for(seq.position + 1)
                if len(seq.blocks) > keep:
                    allocator.truncate(seq.seq_id, keep)
                    seq.page_table[keep:len(seq.blocks)] = TRASH_BLOCK
                    del seq.blocks[keep:]
        self.spec_proposed += proposed_total
        self.spec_accepted += accepted_total
        if self.metrics is not None:
            self.metrics.observe_llm_step(self.model_name, n)
            if emitted_total:
                self.metrics.observe_llm_tokens(self.model_name, emitted_total)
            self.metrics.observe_llm_speculation(
                self.model_name, proposed_total, accepted_total, lane_tokens
            )

    def _finish(self, seq: Sequence) -> None:
        self.allocator.free(seq.seq_id)
        seq.state = _DONE
        self.completed += 1

    def _publish(self) -> None:
        if self.metrics is None:
            return
        self.metrics.set_kv_blocks(
            self.model_name,
            self.allocator.blocks_in_use,
            self.allocator.capacity,
            self.allocator.blocks_shared,
        )
        self.metrics.set_llm_sequences(
            self.model_name, len(self._running), len(self._waiting)
        )

"""Server metrics: the registry behind ``/metrics``.

The port's own copy of ``client_tpu/server/metrics.py``. Every family
name, label set and bucket grid is the reference's, ``tpu_*`` names
included: they are the wire names both packages' perf harnesses read.
Device memory comes from ``torch.cuda`` (``memory_stats`` for the bytes
in use, ``mem_get_info`` for the capacity), labelled ``device="cuda:N"``;
a server on the CPU reports ``tpu_device_memory_bytes{device="cpu"}`` 0,
as the reference does for a backend without memory accounting. NVML is
not read.

Triton-parity metric families per model (the TPU face of the reference's
``nv_inference_*``/``nv_gpu_*`` families that perf_analyzer's
MetricsManager scrapes, reference metrics_manager.h:45-92,
metrics.h:37-42), built on the dependency-free registry in
:mod:`client_tpu_torch.observability.metrics`:

===================================  =========  ==============================
family                               type       source
===================================  =========  ==============================
tpu_inference_request_success        counter    ServerCore stage events
tpu_inference_request_failure        counter    ServerCore stage events
tpu_inference_request_duration       histogram  per request, seconds
tpu_inference_queue_duration         histogram  per request, seconds
tpu_inference_compute_duration       histogram  per request, seconds
tpu_inference_batch_size             histogram  per device execution, rows
tpu_pending_request_count            gauge      in-flight requests per model
tpu_request_cpu_seconds              histogram  per request thread-CPU {stage}
tpu_queue_rejected_total             counter    admission rejections {model,reason}
tpu_queue_depth                      gauge      queued requests {model,level}
tpu_frontend_request_errors          counter    requests rejected pre-core
tpu_duty_cycle                       gauge      busy-ns counter, scrape delta
tpu_device_compute_ns_total          counter    ServerCore busy-ns {device}
tpu_device_memory_bytes              gauge      torch.cuda.memory_stats() {device}
tpu_memory_used_bytes (+limit/util)  gauge      torch.cuda memory_stats / mem_get_info
tpu_inference_count (+duration_ns,   counter    statistics extension mirror
  fail_count)                                   (pre-registry wire names)
===================================  =========  ==============================

The histograms are fed from the same ServerCore stage events the
TraceManager receives, so ``/metrics``, the statistics extension, and the
gRPC ModelStatistics RPC all agree: a histogram's ``_count`` equals the
statistics ``success.count`` and its ``_sum`` equals ``success.ns / 1e9``.

Duty cycle is derived from ServerCore's monotone cumulative busy-ns
counter (device executions only — host-placed models never report the
TPU busy): each scrape books busy-delta / wall-delta since the previous
scrape under a lock, so concurrent scrapers each see a consistent (if
shorter) interval and the first scrape reports utilization since server
start instead of a hard-coded 0. Scrapers that want full control (the
perf collector) derive their own rate from ``tpu_device_compute_ns_total``.
"""

import threading
import time
from typing import Callable

import torch

from client_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from client_tpu_torch.observability.slo import LiveTelemetry, SloObjective
from client_tpu_torch.utils import resolve_device

# Seconds buckets tuned for TPU relays: sub-ms host models through
# multi-second LLM decodes.
DURATION_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# Tokens per speculative verify step per sequence: 1 (nothing accepted)
# up through deep-lookahead acceptance; draft windows beyond 16 are
# past the point of diminishing returns for any measured workload.
SPEC_TOKENS_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)
# Thread-CPU per stage per request: sub-microsecond codec touches through
# multi-millisecond model compute.
STAGE_CPU_BUCKETS_S = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4, 1e-3, 1e-2, 1e-1,
)


class ServerMetrics:
    """Owns the server registry and the hot-path observation methods.

    One instance per :class:`~client_tpu_torch.server.core.ServerCore`; the
    core's execution paths call ``observe_*``/``pending_*`` as requests
    move through, and both front-ends render scrapes via :meth:`render`.
    ``clock_ns`` is injectable (fake-clock tests). ``device`` is the
    device whose memory the scrape reports: ``cuda`` unless the caller
    passes ``"cpu"``; with no card, a scrape of the default raises.
    """

    def __init__(
        self,
        core,
        clock_ns: Callable[[], int] = time.monotonic_ns,
        device=None,
    ):
        self.core = core
        self._clock_ns = clock_ns
        self._device = device
        registry = self.registry = MetricsRegistry()
        model = ("model",)
        self.request_success = Counter(
            "tpu_inference_request_success",
            "Successful inference requests.",
            model,
            registry=registry,
        )
        self.request_failure = Counter(
            "tpu_inference_request_failure",
            "Failed inference requests.",
            model,
            registry=registry,
        )
        self.request_duration = Histogram(
            "tpu_inference_request_duration",
            "End-to-end request duration inside the server, in seconds "
            "(queue + compute).",
            model,
            buckets=DURATION_BUCKETS_S,
            registry=registry,
        )
        self.queue_duration = Histogram(
            "tpu_inference_queue_duration",
            "Time a request waited for a device execution slot, in seconds.",
            model,
            buckets=DURATION_BUCKETS_S,
            registry=registry,
        )
        self.compute_duration = Histogram(
            "tpu_inference_compute_duration",
            "Model compute time per request (input + infer + output), in "
            "seconds.",
            model,
            buckets=DURATION_BUCKETS_S,
            registry=registry,
        )
        self.batch_size = Histogram(
            "tpu_inference_batch_size",
            "Rows per device execution (dynamic batcher merge size).",
            model,
            buckets=BATCH_SIZE_BUCKETS,
            registry=registry,
        )
        self.pending_requests = Gauge(
            "tpu_pending_request_count",
            "Inference requests currently inside the server (queued or "
            "executing).",
            model,
            registry=registry,
        )
        self.stage_cpu = Histogram(
            "tpu_request_cpu_seconds",
            "Thread-CPU seconds a request spent in each named server "
            "stage (frontend_decode/queue_wait/batch_assembly/device_put/"
            "compute/readback/package/encode, plus rpc for non-inference "
            "methods). Populated only while stage-CPU accounting is "
            "enabled (POST /v2/debug/profiling {\"stage_cpu\": true}).",
            ("stage",),
            buckets=STAGE_CPU_BUCKETS_S,
            registry=registry,
        )
        # hot-path cache: stage -> histogram child, so observe_stage_cpu
        # skips the family-lock labels() lookup per booking
        from client_tpu_torch.observability.profiling import STAGES

        self._stage_children = {
            stage: self.stage_cpu.labels(stage) for stage in STAGES
        }
        self.queue_rejected = Counter(
            "tpu_queue_rejected_total",
            "Requests rejected by admission control, by reason "
            "(queue_full = max_queue_size hit, timeout = queue deadline "
            "passed before execution).",
            ("model", "reason"),
            registry=registry,
        )
        self.queue_depth = Gauge(
            "tpu_queue_depth",
            "Requests waiting in the scheduler queue, per priority level "
            "(level 1 = highest priority).",
            ("model", "level"),
            registry=registry,
        )
        self.drain_rejected = Counter(
            "tpu_drain_rejected_total",
            "Requests rejected because the server was draining or "
            "stopped (clean 503/UNAVAILABLE, load balancers should have "
            "routed elsewhere).",
            model,
            registry=registry,
        )
        self.server_state = Gauge(
            "tpu_server_state",
            "Lifecycle state of the server (0 = serving, 1 = draining, "
            "2 = stopped, 3 = recovering — an engine reload is in "
            "flight while the lifecycle itself keeps serving).",
            registry=registry,
        )
        # self-healing (PR 20): one counter/histogram pair covers every
        # supervision tier — tier="engine" (auto reload), "pod" (member
        # respawn + mesh re-init), "fleet" (replica replacement)
        self.recovery_total = Counter(
            "tpu_recovery_total",
            "Completed automatic recoveries by supervision tier "
            "(engine / pod / fleet) and outcome (success / failed).",
            ("tier", "outcome"),
            registry=registry,
        )
        self.recovery_seconds = Histogram(
            "tpu_recovery_seconds",
            "Detected-failure-to-serving-again duration (MTTR) per "
            "completed recovery, by supervision tier.",
            ("tier",),
            buckets=DURATION_BUCKETS_S,
            registry=registry,
        )
        self.frontend_errors = Counter(
            "tpu_frontend_request_errors",
            "Requests rejected by a front-end before reaching the engine "
            "(malformed payloads; not counted by the statistics extension).",
            ("protocol",),
            registry=registry,
        )
        self.codec_fastpath = Counter(
            "tpu_codec_fastpath_total",
            "ModelInfer wire-codec fast-path outcomes: 'hit' requests "
            "decoded by the protobuf-free scanner, 'fallback' requests "
            "outside the fast shape (parsed by the proto codec), "
            "'encode_fallback' responses the hand-rolled encoder "
            "declined.",
            ("outcome",),
            registry=registry,
        )
        self._codec_children = {
            outcome: self.codec_fastpath.labels(outcome)
            for outcome in ("hit", "fallback", "encode_fallback")
        }
        self.shm_ring_slots = Gauge(
            "tpu_shm_ring_slots_in_use",
            "Ring slots currently owned by the server (request read, "
            "response not yet written), per registered ring region.",
            ("region",),
            registry=registry,
        )
        self.duty_cycle = Gauge(
            "tpu_duty_cycle",
            "Fraction of wall time the device spent executing models since "
            "the previous scrape.",
            registry=registry,
        )
        self.device_compute_ns = Counter(
            "tpu_device_compute_ns_total",
            "Cumulative nanoseconds of device model execution, per device "
            "(monotone; derive per-device duty cycle from deltas). A "
            "sharded model's SPMD execution credits every device of its "
            "mesh; unsharded models credit their default device.",
            ("device",),
            registry=registry,
        )
        self.device_memory = Gauge(
            "tpu_device_memory_bytes",
            "Device memory in use per device (torch.cuda memory_stats "
            "allocated_bytes.all.current; 0 for a server on the CPU).",
            ("device",),
            registry=registry,
        )
        self.memory_used = Gauge(
            "tpu_memory_used_bytes",
            "Device memory in use, per local device.",
            ("device",),
            registry=registry,
        )
        self.memory_limit = Gauge(
            "tpu_memory_limit_bytes",
            "Device memory capacity, per local device.",
            ("device",),
            registry=registry,
        )
        self.memory_utilization = Gauge(
            "tpu_memory_utilization",
            "Used / limit device memory fraction, per local device.",
            ("device",),
            registry=registry,
        )
        # Pre-registry wire names, kept so existing scrape configs and the
        # round-1 dashboards survive the rewrite (statistics mirrors).
        self.legacy_count = Counter(
            "tpu_inference_count",
            "Successful inference requests.",
            model,
            registry=registry,
        )
        self.legacy_duration_ns = Counter(
            "tpu_inference_duration_ns",
            "Cumulative successful-request nanoseconds.",
            model,
            registry=registry,
        )
        self.legacy_fail_count = Counter(
            "tpu_inference_fail_count",
            "Failed inference requests.",
            model,
            registry=registry,
        )
        # Live telemetry (observability.slo): rolling-window latency
        # sketches + SLO error-budget tracking, fed from the SAME
        # observe_success/observe_failure events as the histograms above,
        # so the live signals and the cumulative ones can never disagree
        # about what happened — only about when.
        self.telemetry = LiveTelemetry(
            buckets=DURATION_BUCKETS_S,
            clock_ns=clock_ns,
            objective_resolver=self._resolve_objective,
        )
        self.rolling_latency = Gauge(
            "tpu_rolling_latency_seconds",
            "Rolling-window latency quantile per model (sliding sub-window "
            "sketch over the duration bucket grid; window=30s/5m, "
            "quantile=0.5/0.95/0.99). Reflects the window, not the "
            "server's lifetime.",
            ("model", "window", "quantile"),
            registry=registry,
        )
        self.slo_burn_rate = Gauge(
            "tpu_slo_latency_burn_rate",
            "Error-budget burn rate over the model's SLO window: the "
            "fraction of requests violating the SLO (failed or over the "
            "latency target) divided by the allowed fraction "
            "(1 - availability). 1.0 = burning exactly the budget; only "
            "models declaring an slo config report.",
            model,
            registry=registry,
        )
        self.slo_budget_remaining = Gauge(
            "tpu_slo_error_budget_remaining",
            "Fraction of the model's rolling-window error budget still "
            "unspent (1.0 = no violations, 0.0 = budget exhausted).",
            model,
            registry=registry,
        )
        # LLM engine families (client_tpu_torch.llm): paged KV-cache occupancy
        # and continuous-batching behavior. The blocks gauges are the
        # capacity-admission signal — in_use returning to zero after any
        # mix of completed/cancelled/expired generations is the engine's
        # no-leak invariant (asserted in tests/test_llm_engine.py).
        self.kv_blocks_in_use = Gauge(
            "tpu_kv_blocks_in_use",
            "Paged KV-cache blocks currently owned by live sequences.",
            model,
            registry=registry,
        )
        self.kv_blocks_total = Gauge(
            "tpu_kv_blocks_total",
            "Allocatable paged KV-cache blocks in the engine's pool "
            "(the reserved trash block excluded).",
            model,
            registry=registry,
        )
        self.kv_blocks_shared = Gauge(
            "tpu_kv_blocks_shared",
            "Physical KV blocks referenced by more than one live "
            "sequence (copy-on-write prefix sharing).",
            model,
            registry=registry,
        )
        self.prefix_cache_hits = Counter(
            "tpu_prefix_cache_hits_total",
            "Prompt blocks served from the shared prefix index instead "
            "of being prefilled (each hit skips one block of prefill "
            "compute and memory).",
            model,
            registry=registry,
        )
        self.llm_active_sequences = Gauge(
            "tpu_llm_active_sequences",
            "Sequences in the engine's running decode batch.",
            model,
            registry=registry,
        )
        self.llm_waiting_sequences = Gauge(
            "tpu_llm_waiting_sequences",
            "Sequences queued for admission (cache or batch capacity).",
            model,
            registry=registry,
        )
        self.llm_step_batch = Histogram(
            "tpu_llm_step_batch_size",
            "Sequences decoded per continuous-batching step (each step "
            "generates one token per member).",
            model,
            buckets=BATCH_SIZE_BUCKETS,
            registry=registry,
        )
        self.llm_preemptions = Counter(
            "tpu_llm_preemptions_total",
            "Sequences preempted (blocks reclaimed, re-queued) because "
            "the KV block pool ran dry mid-decode.",
            model,
            registry=registry,
        )
        self.llm_generated_tokens = Counter(
            "tpu_llm_generated_tokens_total",
            "Tokens generated by the LLM engine (prefill first-tokens "
            "included).",
            model,
            registry=registry,
        )
        # Speculative decoding (PR-15): proposed/accepted drive the
        # acceptance rate, and the per-sequence tokens-per-verify-step
        # distribution is the direct read of how much each multi-query
        # call bought (1 = nothing accepted, K+1 = the whole draft).
        self.llm_spec_proposed = Counter(
            "tpu_llm_spec_proposed_total",
            "Draft tokens submitted to speculative verification "
            "(post-clamp: only candidates a verify step actually "
            "carried).",
            model,
            registry=registry,
        )
        self.llm_spec_accepted = Counter(
            "tpu_llm_spec_accepted_total",
            "Draft tokens accepted by speculative verification (each "
            "one a decode step the engine did not have to run).",
            model,
            registry=registry,
        )
        self.llm_spec_tokens_per_step = Histogram(
            "tpu_llm_spec_tokens_per_step",
            "Tokens one sequence emitted per speculative verify step "
            "(accepted drafts + the sampled correction/bonus token).",
            model,
            buckets=SPEC_TOKENS_BUCKETS,
            registry=registry,
        )
        # Pod-scale serving: one row per pod member process. Exported by
        # the coordinator (the only member running front-ends) from step
        # bus acks — workers have no metrics endpoint of their own.
        self.pod_process_up = Gauge(
            "tpu_pod_process_up",
            "Pod member liveness: 1 while the process acks step "
            "broadcasts (process 0 is the coordinator itself), 0 once "
            "the bus declares it lost.",
            ("process",),
            registry=registry,
        )
        self.pod_process_duty = Gauge(
            "tpu_pod_process_duty_ratio",
            "Fraction of wall time each pod member spent executing "
            "device steps since the pod came up (workers report "
            "cumulative busy nanoseconds in their step acks).",
            ("process",),
            registry=registry,
        )
        self._duty_lock = threading.Lock()
        # First scrape reports utilization since server start — not 0.0
        # (the pre-registry handler's first-scrape blind spot).
        self._duty_prev = (self._clock_ns(), 0)
        registry.add_collect_hook(self._collect)

    # -- hot-path hooks (called by ServerCore's execution paths) ------------

    def _resolve_objective(self, model_name: str):
        """The model's declared SLO (repository config ``slo`` attr);
        None when it declares none or is unknown. A malformed declaration
        resolves to None but emits a rate-limited warning — a typo'd SLO
        silently tracking nothing would look exactly like a healthy
        model with no objective."""
        try:
            model = self.core.repository.peek(model_name)
        except Exception:  # noqa: BLE001 - telemetry must not fail requests
            return None
        if model is None:
            return None
        try:
            return SloObjective.from_model(model)
        except ValueError as e:
            logger = getattr(self.core, "logger", None)
            if logger is not None:
                logger.warning(
                    "slo_declaration_invalid",
                    model=model_name,
                    error=str(e),
                    rate_key=("slo_declaration_invalid", model_name),
                )
            return None

    def observe_success(
        self, model: str, queue_ns: int, compute_ns: int, total_ns: int,
        count: int = 1, trace_id: str = "",
    ) -> None:
        """Book ``count`` successful requests (per-request durations; the
        merged direct path passes its chunk average with count=n).
        ``trace_id`` (when the request was traced) becomes the duration
        histogram's OpenMetrics exemplar, linking ``/metrics`` buckets to
        ``/v2/debug/requests`` evidence."""
        total_s = total_ns / 1e9
        self.request_success.labels(model).inc(count)
        self.request_duration.labels(model).observe(
            total_s,
            count,
            exemplar=({"trace_id": trace_id}, total_s) if trace_id else None,
        )
        self.queue_duration.labels(model).observe(queue_ns / 1e9, count)
        self.compute_duration.labels(model).observe(compute_ns / 1e9, count)
        self.telemetry.record(model, total_s, ok=True, count=count)

    def observe_failure(self, model: str, count: int = 1) -> None:
        self.request_failure.labels(model).inc(count)
        self.telemetry.record(model, 0.0, ok=False, count=count)

    def observe_execution(self, model: str, rows: int) -> None:
        """Book one device execution of ``rows`` merged rows."""
        self.batch_size.labels(model).observe(float(rows))

    def observe_frontend_error(self, protocol: str) -> None:
        self.frontend_errors.labels(protocol).inc()

    def observe_stage_cpu(self, stage: str, cpu_ns: int, count: int = 1) -> None:
        """Book ``count`` requests' thread-CPU for one stage (merged
        batch paths pass their chunk total with count=n; the histogram
        records the per-request average n times so _sum stays the true
        total and _count the true request count)."""
        if count <= 0:
            return
        child = self._stage_children.get(stage)
        if child is None:
            child = self._stage_children[stage] = self.stage_cpu.labels(stage)
        child.observe(cpu_ns / count / 1e9, count)

    def observe_codec(self, outcome: str) -> None:
        """Book one wire-codec fast-path outcome (children precached —
        this rides the per-request decode path)."""
        child = self._codec_children.get(outcome)
        if child is None:
            child = self._codec_children[outcome] = self.codec_fastpath.labels(
                outcome
            )
        child.inc()

    def set_ring_slots(self, region: str, value: int) -> None:
        """Publish a ring region's in-flight slot count (exact at every
        read/complete transition, not sampled at scrape time)."""
        self.shm_ring_slots.labels(region).set(value)

    def remove_ring_region(self, region: str) -> None:
        """Drop an unregistered ring's gauge child — ring names rotate
        per client run, so pruning keeps /metrics cardinality bounded by
        the LIVE ring set, not history."""
        self.shm_ring_slots.remove(region)

    def observe_rejection(self, model: str, reason: str) -> None:
        """Book one admission-control rejection (queue_full / timeout)."""
        self.queue_rejected.labels(model, reason).inc()

    def observe_drain_rejection(self, model: str) -> None:
        """Book one request rejected by the lifecycle drain gate."""
        self.drain_rejected.labels(model or "").inc()

    def set_queue_depth(self, model: str, depths) -> None:
        """Publish the scheduler queue depth per priority level (fed from
        the same submit/take/expire events that stamp the statistics
        extension's queue timings)."""
        for level, depth in depths.items():
            self.queue_depth.labels(model, str(level)).set(depth)

    # -- LLM engine hooks (client_tpu_torch.llm.engine) ---------------------------

    def set_kv_blocks(
        self, model: str, in_use: int, total: int, shared: int = 0
    ) -> None:
        """Publish the paged KV-cache occupancy (the engine calls this on
        every allocation-state change, not at scrape time, so the gauge
        is exact the moment a sequence completes or is cancelled)."""
        self.kv_blocks_in_use.labels(model).set(in_use)
        self.kv_blocks_total.labels(model).set(total)
        self.kv_blocks_shared.labels(model).set(shared)

    def observe_prefix_hits(self, model: str, blocks: int = 1) -> None:
        """Book prompt blocks matched in the shared prefix index (their
        prefill was skipped)."""
        self.prefix_cache_hits.labels(model).inc(blocks)

    def set_llm_sequences(self, model: str, active: int, waiting: int) -> None:
        self.llm_active_sequences.labels(model).set(active)
        self.llm_waiting_sequences.labels(model).set(waiting)

    def set_pod_process(self, process: int, up: bool, duty: float) -> None:
        """One pod member's liveness + duty split (coordinator-side)."""
        label = str(process)
        self.pod_process_up.labels(label).set(1 if up else 0)
        self.pod_process_duty.labels(label).set(max(0.0, min(1.0, duty)))

    def prune_pod_process(self, process: int) -> None:
        """Drop one pod member's gauge children (the member was replaced
        or the pod shut down) — without this, a respawned member's stale
        twin lingers at its last value forever, exactly the SLO-gauge
        leak PR 8 fixed."""
        label = str(process)
        self.pod_process_up.remove(label)
        self.pod_process_duty.remove(label)

    def observe_recovery(self, tier: str, outcome: str, seconds: float) -> None:
        """Book one completed automatic recovery (any supervision tier);
        ``seconds`` is detection-to-serving-again — the MTTR sample."""
        self.recovery_total.labels(tier, outcome).inc()
        self.recovery_seconds.labels(tier).observe(max(0.0, seconds))

    def observe_llm_step(self, model: str, batch_size: int) -> None:
        """Book one continuous-batching decode step (per-step batch-size
        distribution; tokens are booked separately via
        :meth:`observe_llm_tokens` so cancelled lanes never count)."""
        self.llm_step_batch.labels(model).observe(batch_size)

    def observe_llm_tokens(self, model: str, count: int = 1) -> None:
        """Book generated-and-streamed tokens (prefill first tokens and
        per-step emissions)."""
        self.llm_generated_tokens.labels(model).inc(count)

    def observe_llm_preemption(self, model: str) -> None:
        self.llm_preemptions.labels(model).inc()

    def observe_llm_speculation(
        self, model: str, proposed: int, accepted: int, lane_tokens
    ) -> None:
        """Book one speculative verify step: drafts verified/accepted
        across the batch, plus each live lane's emitted-token count for
        the tokens-per-step histogram."""
        if proposed:
            self.llm_spec_proposed.labels(model).inc(proposed)
        if accepted:
            self.llm_spec_accepted.labels(model).inc(accepted)
        child = self.llm_spec_tokens_per_step.labels(model)
        for tokens in lane_tokens:
            child.observe(tokens)

    def pending_inc(self, model: str, count: int = 1) -> None:
        self.pending_requests.labels(model).inc(count)

    def pending_dec(self, model: str, count: int = 1) -> None:
        self.pending_requests.labels(model).dec(count)

    # -- scrape -------------------------------------------------------------

    def render(self, exemplars: bool = False) -> str:
        """The exposition document (runs the collect hook below).
        ``exemplars=True`` appends OpenMetrics exemplars (trace id +
        latency) to duration-histogram bucket samples that carry one;
        the default text format is unchanged. Device memory is read
        first, outside the registry's collect hooks: a device error fails
        the scrape instead of leaving the gauges stale."""
        self._collect_memory()
        return self.registry.render(exemplars=exemplars)

    def _collect(self) -> None:
        """Scrape-time refresh: exactly ONE statistics snapshot feeds the
        mirror counters (counters and derived values stay consistent
        within a scrape), plus duty cycle and device memory."""
        stats = self.core.statistics()
        for ms in stats["model_stats"]:
            name = ms["name"]
            inference = ms["inference_stats"]
            self.legacy_count.labels(name).set(inference["success"]["count"])
            self.legacy_duration_ns.labels(name).set(
                inference["success"]["ns"]
            )
            self.legacy_fail_count.labels(name).set(inference["fail"]["count"])
        # the port has no drain yet: serving (0) while live, else
        # stopped (2), the reference's wire values
        self.server_state.set(0.0 if self.core.live else 2.0)
        busy_ns = self.core.device_busy_ns_total
        now_ns = self._clock_ns()
        with self._duty_lock:
            prev_ns, prev_busy = self._duty_prev
            self._duty_prev = (now_ns, busy_ns)
        duty = 0.0
        if now_ns > prev_ns:
            duty = min(1.0, max(0, busy_ns - prev_busy) / (now_ns - prev_ns))
        self.duty_cycle.set(duty)
        # per-device split of the same monotone counter (sharded models
        # credit every mesh device); before any device execution the
        # default device exports 0 so the family always renders
        by_device = getattr(self.core, "device_busy_by_device", None)
        per_device = by_device() if callable(by_device) else {}
        if not per_device:
            # pre-execution: export the default device's label (the same
            # one add_busy_ns will credit) so no stale "0" child lingers
            # on hosts whose first device id is nonzero
            default = getattr(self.core, "_default_device_label_value", None)
            label = default() if callable(default) else "0"
            per_device = {label: busy_ns}
        for device, ns in per_device.items():
            self.device_compute_ns.labels(device).set(ns)
        # rolling quantiles + SLO burn gauges reflect the window at
        # scrape time, not the hot path (one O(buckets) merge per model)
        self.telemetry.collect(
            self.rolling_latency,
            self.slo_burn_rate,
            self.slo_budget_remaining,
        )

    def _collect_memory(self) -> None:
        """Device memory of the metrics' device: the CUDA caching
        allocator's bytes in use and the card's capacity; a CPU server
        exports ``tpu_device_memory_bytes{device="cpu"}`` 0."""
        device = resolve_device(self._device)
        if device.type != "cuda":
            self.device_memory.labels(device.type).set(0.0)
            return
        label = device_label(device)
        used = float(torch.cuda.memory_stats(device)["allocated_bytes.all.current"])
        _free, limit = torch.cuda.mem_get_info(device)
        self.device_memory.labels(label).set(used)
        self.memory_used.labels(label).set(used)
        self.memory_limit.labels(label).set(limit)
        self.memory_utilization.labels(label).set(used / limit)


def device_label(device) -> str:
    """The ``device`` label value of a torch device: ``cuda:N`` (the
    current card when the device names none) or its type (``cpu``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    return f"cuda:{index}"

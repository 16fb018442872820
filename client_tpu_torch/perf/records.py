"""Per-request records and window statistics.

The port's own copy of ``client_tpu/perf/records.py``. RequestRecord
mirrors the reference's request_record.h (6-point timestamps reduced to
the ones a network client can observe: send start, response(s),
completion); PerfStatus mirrors the client-side slice of
inference_profiler.h's PerfStatus; ServerMetricsSummary mirrors the
scraped-metrics slice its Metrics member carries (reference metrics.h:37-42
gpu_utilization / memory maps, TPU names here).
"""

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class RequestRecord:
    """One issued request's lifecycle (monotonic ns timestamps)."""

    start_ns: int
    end_ns: int = 0
    # per-response arrival times (>=1 entry; decoupled models several)
    response_ns: List[int] = dataclasses.field(default_factory=list)
    success: bool = True
    error: Optional[str] = None
    # status token of the failure ("429", "StatusCode.RESOURCE_EXHAUSTED",
    # "DEADLINE_EXCEEDED", ...) when the error carried one — classifies
    # admission sheds vs deadline errors vs other failures
    error_status: Optional[str] = None
    # scheduling priority this request was sent with (0 = unset)
    priority: int = 0
    # transparent client-side retries this request needed (resilience
    # layer); 0 when no retry policy is configured
    retries: int = 0
    sequence_id: int = 0
    request_id: str = ""
    # context/slot the dispatcher attributed this request to (rate mode
    # draws it randomly for non-sequence models, reference
    # rand_ctx_id_tracker.h; sequences own their slot)
    ctx_id: int = 0
    # client-side span stage durations for this request (observability
    # tracer rollup: serialize/transport/deserialize ns); None when the
    # backend has no tracer configured
    stages: Optional[Dict[str, Any]] = None

    @property
    def latency_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def first_response_ns(self) -> Optional[int]:
        return self.response_ns[0] if self.response_ns else None


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted sequence."""
    if not sorted_values:
        return 0.0
    rank = max(0, min(len(sorted_values) - 1, math.ceil(q / 100.0 * len(sorted_values)) - 1))
    return sorted_values[rank]


@dataclasses.dataclass
class PerfStatus:
    """Client-side statistics for one measurement window."""

    concurrency: int = 0
    request_rate: float = 0.0
    window_start_ns: int = 0
    window_end_ns: int = 0
    request_count: int = 0
    error_count: int = 0
    # transparent client-side retries summed over the window's requests
    retry_count: int = 0
    throughput: float = 0.0  # infer/sec
    response_throughput: float = 0.0  # responses/sec (decoupled)
    avg_latency_us: float = 0.0
    std_latency_us: float = 0.0
    latency_percentiles_us: Dict[int, float] = dataclasses.field(
        default_factory=dict
    )
    # server-side deltas (from the statistics extension), all microseconds
    server_queue_us: float = 0.0
    server_compute_infer_us: float = 0.0
    server_compute_input_us: float = 0.0
    server_compute_output_us: float = 0.0
    # client-side stage averages from the observability tracer's spans
    # (microseconds over the window's traced successes); traced_count 0
    # means no tracer was configured
    traced_count: int = 0
    client_serialize_us: float = 0.0
    client_transport_us: float = 0.0
    client_deserialize_us: float = 0.0
    # scheduling / overload: admission sheds (429 / RESOURCE_EXHAUSTED),
    # queue-deadline errors (504 / DEADLINE_EXCEEDED), the shed fraction
    # of all window completions, and the per-priority latency split for
    # mixed-priority runs: priority -> {"count", "avg", 50, 99, ...}
    rejected_count: int = 0
    timeout_count: int = 0
    shed_rate: float = 0.0
    per_priority_latency_us: Dict[int, Dict[Any, float]] = dataclasses.field(
        default_factory=dict
    )
    # lifecycle / rolling-restart: requests that DROPPED because an
    # endpoint was draining/dead (503 / UNAVAILABLE / connection error),
    # vs. requests that were REROUTED — completed successfully but only
    # after transparent retries (failover or ride-through)
    unavailable_count: int = 0
    rerouted_count: int = 0

    @property
    def goodput(self) -> float:
        """Successes/sec excluding rejected and failed requests. The
        client-side ``throughput`` already counts successes only, so
        this is an alias — it exists because under overload that number
        must be READ as goodput (rejects are not served work), and the
        overload report/JSON name it accordingly."""
        return self.throughput

    @property
    def stabilizing_latency_us(self) -> float:
        """The latency metric used for stability checks (p99 if computed,
        else avg) — reference DetermineStability semantics."""
        return self.latency_percentiles_us.get(99, self.avg_latency_us)


@dataclasses.dataclass
class ServerMetricsSummary:
    """Reduction of a run's scraped server metrics (--collect-metrics).

    Counter/histogram fields are first-scrape -> last-scrape deltas, so
    they cover exactly this run; gauges (duty, memory) are series
    statistics over the scrape interval.
    """

    scrape_count: int = 0
    scrape_errors: int = 0
    window_s: float = 0.0
    # TPU duty cycle over the scrape intervals (fractions in [0, 1]);
    # multi-device hosts report the per-device mean (each device's own
    # busy delta over the window)
    duty_avg: float = 0.0
    duty_max: float = 0.0
    # per-device duty over the run window (device label -> fraction),
    # from tpu_device_compute_ns_total{device} first->last deltas; >1
    # entry means a mesh-sharded (or multi-model multi-device) server,
    # and the spread is the per-chip skew
    device_duty: Dict[str, float] = dataclasses.field(default_factory=dict)
    # peak sum of tpu_memory_used_bytes across devices (0 = not exported)
    memory_peak_bytes: float = 0.0
    # per-request averages from the server-side histograms (microseconds)
    request_count: int = 0
    avg_request_us: float = 0.0
    avg_queue_us: float = 0.0
    avg_compute_us: float = 0.0
    # total queued seconds / total compute seconds over the run
    queue_compute_ratio: float = 0.0
    # device-execution batch sizes (dynamic batcher merge quality)
    batch_avg: float = 0.0
    # non-cumulative per-bucket observation counts [(le, count)]
    batch_buckets: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list
    )
    success_count: int = 0
    failure_count: int = 0
    # per-stage thread-CPU accounting deltas (--profile-server): stage ->
    # {"count": sampled bookings, "cpu_s": seconds}. cpu_s/count is the
    # per-request mean for that stage (stride sampling keeps it unbiased)
    stage_cpu: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )

    def stage_cpu_us(self) -> Dict[str, float]:
        """Per-stage thread-CPU microseconds per request (mean over the
        stage's sampled bookings); empty when accounting was off."""
        return {
            stage: entry["cpu_s"] / entry["count"] * 1e6
            for stage, entry in self.stage_cpu.items()
            if entry.get("count")
        }


# Status tokens that classify a failed request as shed by admission
# control vs failed on its queue deadline (all client surfaces: HTTP
# numeric statuses, gRPC code reprs, in-process scheduling errors).
_REJECT_STATUS_TOKENS = frozenset({"429", "RESOURCE_EXHAUSTED"})
_TIMEOUT_STATUS_TOKENS = frozenset({"504", "DEADLINE_EXCEEDED"})
# ...and as dropped by a draining/dead endpoint (the rolling-restart
# report's "dropped" column; client_tpu.lifecycle.UNAVAILABLE_TOKENS).
_UNAVAILABLE_STATUS_TOKENS = frozenset(
    {"503", "UNAVAILABLE", "CONNECTION_ERROR"}
)


def _error_token(record: RequestRecord) -> str:
    if record.success or not record.error_status:
        return ""
    return record.error_status.rsplit(".", 1)[-1]


def compute_window_status(
    records: List[RequestRecord],
    window_start_ns: int,
    window_end_ns: int,
    percentiles: Sequence[int] = (50, 90, 95, 99),
) -> PerfStatus:
    """Reduce the records completing inside a window to a PerfStatus."""
    window = [
        r
        for r in records
        if r.end_ns and window_start_ns <= r.end_ns <= window_end_ns
    ]
    status = PerfStatus(
        window_start_ns=window_start_ns, window_end_ns=window_end_ns
    )
    duration_s = max(1e-9, (window_end_ns - window_start_ns) / 1e9)
    successes = [r for r in window if r.success]
    status.request_count = len(successes)
    status.error_count = sum(1 for r in window if not r.success)
    status.retry_count = sum(r.retries for r in window)
    status.throughput = len(successes) / duration_s
    status.response_throughput = (
        sum(len(r.response_ns) for r in successes) / duration_s
    )
    if successes:
        lat_us = sorted(r.latency_ns / 1e3 for r in successes)
        n = len(lat_us)
        mean = sum(lat_us) / n
        status.avg_latency_us = mean
        status.std_latency_us = (
            (sum((x - mean) ** 2 for x in lat_us) / (n - 1)) ** 0.5
            if n > 1
            else 0.0
        )
        status.latency_percentiles_us = {
            q: percentile(lat_us, q) for q in percentiles
        }
    # scheduling / overload classification
    rejected = sum(
        1 for r in window if _error_token(r) in _REJECT_STATUS_TOKENS
    )
    timeouts = sum(
        1 for r in window if _error_token(r) in _TIMEOUT_STATUS_TOKENS
    )
    status.rejected_count = rejected
    status.timeout_count = timeouts
    if window:
        status.shed_rate = rejected / len(window)
    # lifecycle: dropped (unavailable endpoint) vs rerouted (succeeded
    # after transparent retries — failover or drain ride-through)
    status.unavailable_count = sum(
        1 for r in window if _error_token(r) in _UNAVAILABLE_STATUS_TOKENS
    )
    status.rerouted_count = sum(1 for r in successes if r.retries > 0)
    priorities = {r.priority for r in window}
    if priorities and priorities != {0}:
        split: Dict[int, Dict[Any, float]] = {}
        for p in sorted(priorities):
            lat_p = sorted(
                r.latency_ns / 1e3 for r in successes if r.priority == p
            )
            if not lat_p:
                continue
            entry: Dict[Any, float] = {
                "count": len(lat_p),
                "avg": sum(lat_p) / len(lat_p),
            }
            for q in percentiles:
                entry[q] = percentile(lat_p, q)
            split[p] = entry
        status.per_priority_latency_us = split
    traced = [r for r in successes if r.stages]
    if traced:
        n = len(traced)
        status.traced_count = n
        status.client_serialize_us = (
            sum(r.stages.get("serialize", 0) for r in traced) / n / 1e3
        )
        status.client_transport_us = (
            sum(r.stages.get("transport", 0) for r in traced) / n / 1e3
        )
        status.client_deserialize_us = (
            sum(r.stages.get("deserialize", 0) for r in traced) / n / 1e3
        )
    return status

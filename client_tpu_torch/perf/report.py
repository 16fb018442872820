"""Reporting: console summary, CSV, and profile-export JSON.

The port's own copy of ``client_tpu/perf/report.py``, the fleet block
(:func:`format_fleet`) included.
Console/CSV mirror the reference's ReportWriter output columns
(reference report_writer.cc); the profile export follows the shape of the
reference's ProfileDataExporter document (experiments with per-request
timestamps) that genai-perf consumes
(reference profile_data_exporter.h:52-86).
"""

import json
from typing import Any, Dict, Optional, Sequence

from client_tpu_torch.perf.profiler import ProfileExperiment
from client_tpu_torch.perf.records import ServerMetricsSummary


def console_report(
    experiments: Sequence[ProfileExperiment],
    percentile: Optional[int] = None,
) -> str:
    lines = []
    for experiment in experiments:
        s = experiment.status
        label = (
            f"Concurrency: {int(experiment.value)}"
            if experiment.mode == "concurrency"
            else f"Request rate: {experiment.value:g}"
        )
        lines.append(
            f"{label}, throughput: {s.throughput:.2f} infer/sec, latency "
            f"{int(s.avg_latency_us)} usec"
        )
    lines.append("")
    lines.append("Inferences/Second vs. Client Average Batch Latency")
    for experiment in experiments:
        s = experiment.status
        lines.append(
            f"{experiment.mode}: {experiment.value:g}, throughput: "
            f"{s.throughput:.2f} infer/sec, latency avg {int(s.avg_latency_us)}"
            f" usec, p50 {int(s.latency_percentiles_us.get(50, 0))} usec, "
            f"p90 {int(s.latency_percentiles_us.get(90, 0))} usec, "
            f"p95 {int(s.latency_percentiles_us.get(95, 0))} usec, "
            f"p99 {int(s.latency_percentiles_us.get(99, 0))} usec"
        )
    return "\n".join(lines)


def detailed_report(experiment: ProfileExperiment) -> str:
    """The per-point block the reference prints under each measurement."""
    s = experiment.status
    lines = [
        f"  Request count: {s.request_count}",
        f"  Throughput: {s.throughput:.2f} infer/sec",
    ]
    if s.response_throughput and s.response_throughput != s.throughput:
        lines.append(
            f"  Response throughput: {s.response_throughput:.2f} resp/sec"
        )
    lines += [
        f"  Avg latency: {int(s.avg_latency_us)} usec "
        f"(standard deviation {int(s.std_latency_us)} usec)",
    ]
    for q in sorted(s.latency_percentiles_us):
        lines.append(
            f"  p{q} latency: {int(s.latency_percentiles_us[q])} usec"
        )
    if s.server_compute_infer_us:
        lines.append(
            "  Server: queue "
            f"{s.server_queue_us:.0f} usec, compute input "
            f"{s.server_compute_input_us:.0f} usec, compute infer "
            f"{s.server_compute_infer_us:.0f} usec, compute output "
            f"{s.server_compute_output_us:.0f} usec"
        )
    if s.traced_count:
        # Client spans (observability tracer) split the end-to-end latency
        # into attributable stages; combined with the server-side stats
        # delta, the transport time decomposes into server work vs
        # network + wire overhead.
        lines.append(
            f"  Stage breakdown ({s.traced_count} traced): client "
            f"serialize {s.client_serialize_us:.0f} usec, transport "
            f"{s.client_transport_us:.0f} usec, deserialize "
            f"{s.client_deserialize_us:.0f} usec"
        )
        server_us = (
            s.server_queue_us
            + s.server_compute_input_us
            + s.server_compute_infer_us
            + s.server_compute_output_us
        )
        if server_us:
            network_us = max(0.0, s.client_transport_us - server_us)
            lines.append(
                f"    server queue {s.server_queue_us:.0f} usec + compute "
                f"{server_us - s.server_queue_us:.0f} usec -> network+wire "
                f"~{network_us:.0f} usec"
            )
    if s.error_count:
        lines.append(f"  Errors: {s.error_count}")
    if s.retry_count:
        lines.append(f"  Retries: {s.retry_count}")
    scheduling = format_scheduling(s)
    if scheduling:
        lines.append(scheduling)
    lifecycle = format_lifecycle(s)
    if lifecycle:
        lines.append(lifecycle)
    return "\n".join(lines)


def format_lifecycle(s) -> str:
    """The "Lifecycle" block: what a rolling restart (or any endpoint
    outage) cost the window — requests rerouted transparently (succeeded
    after client-side retries/failover) vs. dropped on an unavailable
    endpoint. Empty for undisturbed windows, so the acceptance claim
    ("zero failed requests across a drain") is measured, not asserted."""
    if not (s.rerouted_count or s.unavailable_count):
        return ""
    return (
        f"  Lifecycle: {s.rerouted_count} rerouted "
        f"(transparent retry/failover), {s.unavailable_count} dropped "
        "(endpoint unavailable)"
    )


def format_scheduling(s) -> str:
    """The "Scheduling" block: overload behavior (shed rate, goodput)
    and the per-priority latency split of a mixed-priority run. Empty
    when the window saw no admission activity and no priorities."""
    if not (
        s.rejected_count or s.timeout_count or s.per_priority_latency_us
    ):
        return ""
    lines = [
        "  Scheduling: shed rate "
        f"{s.shed_rate * 100:.1f}% ({s.rejected_count} queue-full, "
        f"{s.timeout_count} timeout), goodput {s.goodput:.2f} infer/sec"
    ]
    for p in sorted(s.per_priority_latency_us):
        entry = s.per_priority_latency_us[p]
        lines.append(
            f"    priority {p}: {int(entry['count'])} ok, avg "
            f"{entry['avg']:.0f} usec, p50 {entry.get(50, 0):.0f} usec, "
            f"p99 {entry.get(99, 0):.0f} usec"
        )
    return "\n".join(lines)


def format_shm_delta(
    shm_infer_per_sec: float,
    native_infer_per_sec: float,
    tensor_bytes: int = 0,
    label: str = "shm",
) -> str:
    """The shm-vs-inline verdict as a named number.

    BENCH_r05 buried an inversion (tpu-shm slower than inline gRPC at
    small tensor sizes) in an unlabeled JSON field for four rounds; this
    renders the delta explicitly and FLAGS the loss, so a shm path that
    stops paying for itself is a headline, not an easter egg.
    """
    if shm_infer_per_sec <= 0 or native_infer_per_sec <= 0:
        return ""
    ratio = shm_infer_per_sec / native_infer_per_sec
    delta_pct = (ratio - 1.0) * 100.0
    size = f" at {tensor_bytes} B/tensor" if tensor_bytes else ""
    line = (
        f"{label} vs inline wire{size}: {shm_infer_per_sec:.0f} vs "
        f"{native_infer_per_sec:.0f} infer/sec ({delta_pct:+.1f}%)"
    )
    if ratio < 1.0:
        line += (
            f"  ** {label.upper()} LOSES at this tensor size — the "
            "copy savings do not cover its per-request overhead **"
        )
    return line


def _format_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GiB"  # pragma: no cover - loop always returns


def format_server_metrics(summary: ServerMetricsSummary) -> str:
    """The "Server metrics" block printed when --collect-metrics scraped
    the server during the run (reference MetricsManager report role)."""
    lines = [
        f"Server metrics ({summary.scrape_count} scrapes over "
        f"{summary.window_s:.1f} s"
        + (
            f", {summary.scrape_errors} failed"
            if summary.scrape_errors
            else ""
        )
        + "):"
    ]
    lines.append(
        f"  TPU duty cycle: avg {summary.duty_avg * 100:.1f}%, "
        f"max {summary.duty_max * 100:.1f}%"
    )
    if len(summary.device_duty) > 1:
        # per-chip view (mesh-sharded servers): each device's own busy
        # delta over the window, plus the spread as the skew signal
        per = ", ".join(
            f"dev{device}: {duty * 100:.1f}%"
            for device, duty in sorted(summary.device_duty.items())
        )
        values = list(summary.device_duty.values())
        low, high = min(values), max(values)
        skew = f" (skew {high / low:.2f}x)" if low > 0 else ""
        lines.append(f"  Per-device duty: {per}{skew}")
    if summary.memory_peak_bytes:
        lines.append(
            f"  TPU memory: peak {_format_bytes(summary.memory_peak_bytes)} "
            "used"
        )
    if summary.request_count:
        lines.append(
            f"  Requests: {summary.success_count} ok, "
            f"{summary.failure_count} failed, avg "
            f"{summary.avg_request_us:.0f} usec in server"
        )
        lines.append(
            f"  Queue/compute: avg queue {summary.avg_queue_us:.0f} usec, "
            f"avg compute {summary.avg_compute_us:.0f} usec "
            f"(ratio {summary.queue_compute_ratio:.2f})"
        )
    if summary.batch_avg:
        dist = ", ".join(
            f"<={int(le) if float(le).is_integer() else le}: {int(count)}"
            for le, count in summary.batch_buckets
            if count > 0
        )
        lines.append(
            f"  Batch size: avg {summary.batch_avg:.1f} rows/execution"
            + (f" [{dist}]" if dist else "")
        )
    if summary.scrape_count == 0 or (
        not summary.request_count and not summary.duty_max
    ):
        lines.append(
            "  (no server activity captured; is the metrics endpoint the "
            "right server?)"
        )
    return "\n".join(lines)


def format_wire_gap(
    summary: ServerMetricsSummary,
    clock_mode: str = "",
    inproc_us_per_req: float = 0.0,
) -> str:
    """The "Wire-gap attribution" table (``--profile-server``): the
    server's per-stage thread-CPU µs per request, from the
    ``tpu_request_cpu_seconds{stage}`` deltas the collector scraped.

    Splits the stages into wire-only work (decode/encode/rpc — CPU the
    in-process path never pays: the directly-attributable slice of the
    wire gap) and shared work (assembly/device_put/compute/readback).
    ``inproc_us_per_req`` (when the caller measured an in-process
    baseline, e.g. bench.py) adds the explicit gap line.
    """
    from client_tpu_torch.observability.profiling import STAGES, WIRE_ONLY_STAGES

    per_request = summary.stage_cpu_us()
    header = "Wire-gap attribution (server stage CPU per request"
    if clock_mode and clock_mode != "thread_cpu":
        header += f"; clock: {clock_mode}"
    header += "):"
    if not per_request:
        return (
            header
            + "\n  no stage-CPU samples captured (is the server's"
            " /v2/debug/profiling endpoint reachable?)"
        )
    lines = [header]
    ordered = [s for s in STAGES if s in per_request] + sorted(
        set(per_request) - set(STAGES)
    )
    inference_stages = [s for s in ordered if s != "rpc"]
    total_us = sum(per_request[s] for s in inference_stages)
    for stage in ordered:
        us = per_request[stage]
        entry = summary.stage_cpu[stage]
        if stage == "rpc":
            # booked per method call, not per request: report the run
            # total so scrape/statistics overhead stays visible
            lines.append(
                f"  {stage:<15s} {entry['cpu_s'] * 1e3:8.2f} ms total "
                f"({int(entry['count'])} non-inference calls)"
            )
            continue
        share = us / total_us * 100 if total_us else 0.0
        line = f"  {stage:<15s} {us:8.1f} us/req  ({share:4.1f}%)"
        if stage == "queue_wait" and summary.avg_queue_us:
            line += f"  [wall {summary.avg_queue_us:.1f} us/req]"
        lines.append(line)
    lines.append(f"  {'total':<15s} {total_us:8.1f} us/req")
    wire_stages = [s for s in inference_stages if s in WIRE_ONLY_STAGES]
    shared_stages = [
        s for s in inference_stages if s not in WIRE_ONLY_STAGES
    ]
    wire_us = sum(per_request[s] for s in wire_stages)
    shared_us = total_us - wire_us
    lines.append(
        f"  wire-only stages ({'+'.join(wire_stages)}) {wire_us:.1f} "
        f"us/req vs shared stages ({'+'.join(shared_stages)}) "
        f"{shared_us:.1f} us/req"
    )
    if inproc_us_per_req > 0:
        lines.append(
            f"  in-process baseline {inproc_us_per_req:.1f} us/req -> "
            f"directly-attributed wire gap {wire_us:.1f} us/req"
        )
    return "\n".join(lines)


def format_shm_delta(
    shm_infer_per_sec: float,
    native_infer_per_sec: float,
    tensor_bytes: int = 0,
    label: str = "shm",
) -> str:
    """The shm-vs-inline verdict as a named number.

    BENCH_r05 buried an inversion (tpu-shm slower than inline gRPC at
    small tensor sizes) in an unlabeled JSON field for four rounds; this
    renders the delta explicitly and FLAGS the loss, so a shm path that
    stops paying for itself is a headline, not an easter egg.
    """
    if shm_infer_per_sec <= 0 or native_infer_per_sec <= 0:
        return ""
    ratio = shm_infer_per_sec / native_infer_per_sec
    delta_pct = (ratio - 1.0) * 100.0
    size = f" at {tensor_bytes} B/tensor" if tensor_bytes else ""
    line = (
        f"{label} vs inline wire{size}: {shm_infer_per_sec:.0f} vs "
        f"{native_infer_per_sec:.0f} infer/sec ({delta_pct:+.1f}%)"
    )
    if ratio < 1.0:
        line += (
            f"  ** {label.upper()} LOSES at this tensor size — the "
            "copy savings do not cover its per-request overhead **"
        )
    return line


def format_client_metrics(
    snapshot: Optional[Dict[str, Any]],
    endpoints: Optional[Dict[str, Any]] = None,
) -> str:
    """The "Client metrics" block: the tracer's ClientMetrics snapshot —
    error/retry counts and the client-side latency histogram the
    observability layer records on every traced call — plus, when the
    backend exposes one, the per-endpoint pool telemetry (outstanding
    requests, EWMA latency, error/reroute counters per endpoint; the
    inputs the scale-out routing policies consume). Either argument may
    be None; the section prints whatever is live."""
    lines = ["Client metrics:"]
    if snapshot is not None:
        lines.append(
            f"  Requests: {snapshot['request_count']} "
            f"(errors {snapshot['error_count']}, retries "
            f"{snapshot['retry_count']}), avg latency "
            f"{snapshot['avg_latency_us']:.0f} usec"
        )
        # de-cumulate the histogram and print the populated buckets
        parts = []
        prev = 0
        for entry in snapshot.get("latency_histogram_us", []):
            count = entry["count"] - prev
            prev = entry["count"]
            if count > 0:
                bound = entry["le_us"]
                label = f"<={bound}us" if bound != "inf" else ">last"
                parts.append(f"{label}: {count}")
        if parts:
            lines.append(f"  Latency histogram: {', '.join(parts)}")
    if endpoints is not None and endpoints.get("endpoints"):
        rows = endpoints["endpoints"]
        noun = "endpoint" if len(rows) == 1 else "endpoints"
        pool_line = (
            f"  Endpoint pool ({len(rows)} {noun}, policy "
            f"{endpoints.get('policy', 'sticky')}, primary "
            f"{endpoints.get('primary', '?')}, "
            f"{endpoints.get('failovers', 0)} failovers, "
            f"{endpoints.get('ejections', 0)} ejections):"
        )
        lines.append(pool_line)
        lines.append(
            f"    {'url':<28} {'state':>7} {'outst':>5} {'ewma_us':>10} "
            f"{'ok':>8} {'err':>5} {'reroutes':>8}"
        )
        for row in rows:
            # 'state' distinguishes an ejected/benched endpoint from a
            # healthy idle one (both would read outst=0 otherwise)
            state = row.get("state") or (
                "down" if row.get("down") else "up"
            )
            lines.append(
                f"    {row['url']:<28} {state:>7} {row['outstanding']:>5} "
                f"{row['ewma_latency_us']:>10.1f} {row['successes']:>8} "
                f"{row['errors']:>5} {row['reroutes']:>8}"
            )
        if endpoints.get("hedges"):
            lines.append(
                f"  Hedging: {endpoints['hedges']} hedges launched "
                f"(tpu_client_hedges_total), "
                f"{endpoints.get('hedge_wins', 0)} won the race"
            )
    if len(lines) == 1:
        lines.append("  (no client telemetry recorded)")
    return "\n".join(lines)


def format_fleet(summary) -> str:
    """The "Fleet" section (``--metrics-url a,b,c``): per-replica
    duty/p99/error split over the run window plus the skew verdict —
    the "which of my N replicas is slow" answer, computed from each
    replica's own ``/metrics`` (rolling p99 preferred, cumulative
    histogram delta as fallback)."""
    lines = [
        f"Fleet ({len(summary.replicas)} replicas): "
        f"{summary.total_requests} requests "
        f"({summary.total_failures} failures) over "
        f"{summary.window_s:.1f} s",
    ]
    lines.append(
        f"  {'replica':<28} {'req':>8} {'req/s':>8} {'duty':>6} "
        f"{'avg_us':>10} {'p99_us':>10} {'fail':>6}  p99 source"
    )
    for replica in summary.replicas:
        # the replica's own scrape span (a mid-run-dead endpoint covers
        # less time than the fleet), falling back to the fleet window
        span = replica.window_s or summary.window_s
        rate = replica.requests / span if span else 0.0
        lines.append(
            f"  {replica.url:<28} {replica.requests:>8} {rate:>8.1f} "
            f"{replica.duty:>6.2f} {replica.avg_request_us:>10.1f} "
            f"{replica.p99_s * 1e6:>10.1f} {replica.failures:>6}  "
            f"{replica.p99_source or '-'}"
        )
    if summary.skew is not None:
        skew = summary.skew
        verdict = "SKEW FLAGGED" if skew["flagged"] else "within tolerance"
        source = skew.get("source")
        via = f", {source} p99" if source else ""
        lines.append(
            f"  Skew: slowest {skew['slowest']} p99 "
            f"{skew['slowest_p99_us']:.1f} us vs fastest {skew['fastest']} "
            f"p99 {skew['fastest_p99_us']:.1f} us — ratio "
            f"{skew['ratio']:.2f}x ({verdict}{via})"
        )
    else:
        lines.append(
            "  Skew: not enough replicas reporting a comparable p99"
        )
    return "\n".join(lines)


def format_slow_requests(
    snapshot: Dict[str, Any], limit: Optional[int] = None
) -> str:
    """Render the flight recorder's slowest-request exemplars
    (``GET /v2/debug/requests``) stage-decomposed — the end-of-run answer
    to "which requests were the worst, and where did their time go"."""
    slowest = snapshot.get("slowest", [])
    if limit is not None:
        slowest = slowest[:limit]
    lines = ["Slowest requests (server flight recorder):"]
    if not slowest:
        lines.append("  (no exemplars recorded)")
        return "\n".join(lines)
    header = (
        f"  {'total_us':>10} {'queue_us':>10} {'compute_us':>10} "
        f"{'package_us':>10}  {'model':<16} {'path':<9} {'status':<8} detail"
    )
    lines.append(header)
    for exemplar in slowest:
        stages = exemplar.get("stages", {})
        detail = []
        if exemplar.get("request_id"):
            detail.append(f"id={exemplar['request_id']}")
        if exemplar.get("trace_id"):
            detail.append(f"trace={exemplar['trace_id']}")
        if exemplar.get("error"):
            detail.append(f"error={exemplar['error']}")
        lines.append(
            f"  {exemplar.get('total_us', 0):>10.0f}"
            f" {stages.get('queue_us', 0):>10.0f}"
            f" {stages.get('compute_us', 0):>10.0f}"
            f" {stages.get('package_us', 0):>10.0f}"
            f"  {exemplar.get('model', ''):<16}"
            f" {exemplar.get('path', ''):<9}"
            f" {exemplar.get('status', ''):<8}"
            f" {' '.join(detail)}".rstrip()
        )
    errors = snapshot.get("error_total", 0)
    rejected = snapshot.get("rejected_total", 0)
    if errors or rejected:
        lines.append(
            f"  ({errors} errored / {rejected} rejected requests recorded;"
            " full exemplars in the 'errors' section of"
            " GET /v2/debug/requests)"
        )
    return "\n".join(lines)


def write_csv(experiments: Sequence[ProfileExperiment], path: str) -> None:
    """Reference-compatible CSV columns."""
    percentile_cols = sorted(
        {
            q
            for e in experiments
            for q in e.status.latency_percentiles_us
        }
    )
    header = (
        ["Concurrency" if experiments and experiments[0].mode == "concurrency"
         else "Request Rate"]
        + ["Inferences/Second", "Client Send/Recv", "Server Queue",
           "Server Compute Input", "Server Compute Infer",
           "Server Compute Output"]
        + [f"p{q} latency" for q in percentile_cols]
        + ["Avg latency"]
    )
    rows = [",".join(header)]
    for e in experiments:
        s = e.status
        row = [
            f"{e.value:g}",
            f"{s.throughput:.2f}",
            "0",
            f"{s.server_queue_us:.0f}",
            f"{s.server_compute_input_us:.0f}",
            f"{s.server_compute_infer_us:.0f}",
            f"{s.server_compute_output_us:.0f}",
        ]
        row += [
            f"{s.latency_percentiles_us.get(q, 0):.0f}"
            for q in percentile_cols
        ]
        row.append(f"{s.avg_latency_us:.0f}")
        rows.append(",".join(row))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def export_profile(
    experiments: Sequence[ProfileExperiment],
    path: str,
    service_kind: str = "triton",
    endpoint: str = "",
) -> None:
    """Profile-export JSON: per-request timestamps per experiment.

    genai-perf's parser consumes this document (reference
    llm_metrics.py LLMProfileDataParser; exporter shape
    profile_data_exporter.h:52-86).
    """
    doc = {
        "service_kind": service_kind,
        "endpoint": endpoint,
        "experiments": [
            {
                "experiment": {
                    "mode": e.mode,
                    "value": e.value,
                },
                "requests": [
                    {
                        "timestamp": r.start_ns,
                        "sequence_id": r.sequence_id,
                        "response_timestamps": list(r.response_ns),
                        "success": r.success,
                    }
                    for r in e.records
                ],
                "window_boundaries": [
                    e.status.window_start_ns,
                    e.status.window_end_ns,
                ],
            }
            for e in experiments
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f)

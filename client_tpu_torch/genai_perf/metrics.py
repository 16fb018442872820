"""LLM metrics from profile exports.

The port's own copy of ``client_tpu/genai_perf/metrics.py``. The
reference's llm_metrics (reference genai-perf llm_metrics.py:47-658):
parse the profile-export JSON into per-request time-to-first-token,
inter-token latencies, and token/request throughput, reduce to Statistics
(avg/percentiles/min/max/std), and render console/CSV/JSON reports.
"""

import dataclasses
import json
from typing import Dict, List, Sequence


@dataclasses.dataclass
class Statistics:
    """Summary statistics over one metric's samples."""

    avg: float = 0.0
    p25: float = 0.0
    p50: float = 0.0
    p75: float = 0.0
    p90: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    min: float = 0.0
    max: float = 0.0
    std: float = 0.0
    count: int = 0

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "Statistics":
        from client_tpu_torch.perf.records import percentile

        if not samples:
            return cls()
        ordered = sorted(samples)
        n = len(ordered)

        def pct(q):
            return percentile(ordered, q)

        mean = sum(ordered) / n
        std = (
            (sum((x - mean) ** 2 for x in ordered) / (n - 1)) ** 0.5
            if n > 1
            else 0.0
        )
        return cls(
            avg=mean,
            p25=pct(25),
            p50=pct(50),
            p75=pct(75),
            p90=pct(90),
            p95=pct(95),
            p99=pct(99),
            min=ordered[0],
            max=ordered[-1],
            std=std,
            count=n,
        )


@dataclasses.dataclass
class LLMMetrics:
    """Per-benchmark LLM metrics (all times in nanoseconds)."""

    time_to_first_tokens: List[int] = dataclasses.field(default_factory=list)
    inter_token_latencies: List[float] = dataclasses.field(default_factory=list)
    request_latencies: List[int] = dataclasses.field(default_factory=list)
    output_token_counts: List[int] = dataclasses.field(default_factory=list)
    benchmark_duration_ns: int = 0
    request_count: int = 0

    @property
    def output_token_throughput(self) -> float:
        if self.benchmark_duration_ns <= 0:
            return 0.0
        return sum(self.output_token_counts) / (
            self.benchmark_duration_ns / 1e9
        )

    @property
    def request_throughput(self) -> float:
        if self.benchmark_duration_ns <= 0:
            return 0.0
        return self.request_count / (self.benchmark_duration_ns / 1e9)

    def statistics(self) -> Dict[str, Statistics]:
        return {
            "time_to_first_token": Statistics.from_samples(
                self.time_to_first_tokens
            ),
            "inter_token_latency": Statistics.from_samples(
                self.inter_token_latencies
            ),
            "request_latency": Statistics.from_samples(self.request_latencies),
            "num_output_tokens": Statistics.from_samples(
                [float(c) for c in self.output_token_counts]
            ),
        }


class LLMProfileDataParser:
    """Reduce a profile-export JSON document to LLMMetrics.

    Token accounting: each streamed response is one generated token (the
    in-repo decode model emits exactly one token per response; for text
    endpoints a tokenizer-based recount can be layered on).
    """

    def __init__(self, path: str):
        with open(path) as f:
            self._doc = json.load(f)

    def experiments(self) -> List[Dict]:
        return self._doc.get("experiments", [])

    def parse(self, experiment_index: int = 0) -> LLMMetrics:
        experiments = self.experiments()
        if not experiments:
            return LLMMetrics()
        experiment = experiments[experiment_index]
        metrics = LLMMetrics()
        start_bound = None
        end_bound = None
        for request in experiment.get("requests", []):
            if not request.get("success", True):
                continue
            responses = request.get("response_timestamps", [])
            if not responses:
                continue
            t0 = request["timestamp"]
            metrics.request_count += 1
            metrics.time_to_first_tokens.append(responses[0] - t0)
            metrics.request_latencies.append(responses[-1] - t0)
            metrics.output_token_counts.append(len(responses))
            if len(responses) > 1:
                gaps = [
                    responses[i + 1] - responses[i]
                    for i in range(len(responses) - 1)
                ]
                metrics.inter_token_latencies.extend(gaps)
            start_bound = t0 if start_bound is None else min(start_bound, t0)
            last = responses[-1]
            end_bound = last if end_bound is None else max(end_bound, last)
        if start_bound is not None and end_bound is not None:
            metrics.benchmark_duration_ns = end_bound - start_bound
        return metrics


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

_NS_METRICS = {
    "time_to_first_token",
    "inter_token_latency",
    "request_latency",
}


def console_table(metrics: LLMMetrics) -> str:
    """Reference-style console table (values in ms for time metrics)."""
    stats = metrics.statistics()
    header = f"{'Statistic':<26}{'avg':>12}{'min':>12}{'max':>12}{'p99':>12}{'p90':>12}{'p75':>12}"
    lines = ["LLM Metrics", header, "-" * len(header)]
    for name, s in stats.items():
        if s.count == 0:
            continue
        scale = 1e6 if name in _NS_METRICS else 1.0
        unit = " (ms)" if name in _NS_METRICS else ""
        lines.append(
            f"{name + unit:<26}"
            f"{s.avg / scale:>12.2f}{s.min / scale:>12.2f}"
            f"{s.max / scale:>12.2f}{s.p99 / scale:>12.2f}"
            f"{s.p90 / scale:>12.2f}{s.p75 / scale:>12.2f}"
        )
    lines.append("")
    lines.append(
        f"Output token throughput (per sec): "
        f"{metrics.output_token_throughput:.2f}"
    )
    lines.append(
        f"Request throughput (per sec): {metrics.request_throughput:.2f}"
    )
    return "\n".join(lines)


def export_csv(metrics: LLMMetrics, path: str) -> None:
    stats = metrics.statistics()
    rows = [
        "Metric,avg,min,max,p99,p95,p90,p75,p50,p25,std,count"
    ]
    for name, s in stats.items():
        rows.append(
            f"{name},{s.avg:.1f},{s.min:.1f},{s.max:.1f},{s.p99:.1f},"
            f"{s.p95:.1f},{s.p90:.1f},{s.p75:.1f},{s.p50:.1f},{s.p25:.1f},"
            f"{s.std:.1f},{s.count}"
        )
    rows.append(
        f"output_token_throughput_per_s,{metrics.output_token_throughput:.2f}"
        ",,,,,,,,,,"
    )
    rows.append(
        f"request_throughput_per_s,{metrics.request_throughput:.2f},,,,,,,,,,"
    )
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def export_json(
    metrics: LLMMetrics, path: str, tokenizer: str = ""
) -> None:
    doc = {
        name: dataclasses.asdict(s) for name, s in metrics.statistics().items()
    }
    doc["output_token_throughput_per_s"] = metrics.output_token_throughput
    doc["request_throughput_per_s"] = metrics.request_throughput
    doc["request_count"] = metrics.request_count
    if tokenizer:
        # Which tokenizer produced the token counts: bundled-BPE counts
        # against a real Llama-family endpoint are systematically off, and
        # consumers must be able to tell.
        doc["tokenizer"] = tokenizer
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)

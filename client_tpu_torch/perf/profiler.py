"""Measurement engine: windows, stability detection, mode sweeps.

The port's own copy of ``client_tpu/perf/profiler.py``. The reference's InferenceProfiler (reference
inference_profiler.h:192-747): time-based measurement windows repeated
until the last three are stable (throughput and latency within
±stability% of their running mean, latency under the threshold), swept
over a concurrency range or request-rate range (linear or binary search),
with server-side statistics deltas captured around each window.
"""

import asyncio
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from client_tpu_torch.perf.load_manager import (
    ConcurrencyManager,
    LoadManager,
    RequestRateManager,
)
from client_tpu_torch.perf.records import (
    PerfStatus,
    RequestRecord,
    compute_window_status,
)


@dataclasses.dataclass
class ProfileExperiment:
    """One swept point (reference profile_data_collector.h Experiment)."""

    mode: str  # "concurrency" | "request_rate"
    value: float
    status: PerfStatus
    records: List[RequestRecord]


class InferenceProfiler:
    def __init__(
        self,
        manager: LoadManager,
        measurement_interval_s: float = 5.0,
        stability_pct: float = 10.0,
        max_trials: int = 10,
        latency_threshold_us: Optional[float] = None,
        count_windows: bool = False,
        measurement_request_count: int = 50,
        percentiles: Sequence[int] = (50, 90, 95, 99),
        stability_percentile: Optional[int] = None,
        warmup_s: float = 0.0,
        warmup_requests: int = 0,
        verbose: bool = False,
        metrics_collector=None,
    ):
        self.manager = manager
        self.measurement_interval_s = measurement_interval_s
        self.stability_pct = stability_pct
        self.max_trials = max_trials
        self.latency_threshold_us = latency_threshold_us
        # count_windows: a window ends after measurement_request_count NEW
        # requests instead of after the interval, which then caps the wait
        # (reference --measurement-mode count_windows; C++ twin
        # ProfilerConfig.count_windows).
        self.count_windows = count_windows
        self.measurement_request_count = measurement_request_count
        self.percentiles = tuple(percentiles)
        # latency metric for stability + threshold checks: the given
        # percentile, or average latency when None (reference --percentile)
        self.stability_percentile = stability_percentile
        self.warmup_s = warmup_s
        self.warmup_requests = warmup_requests
        self.verbose = verbose
        self.experiments: List[ProfileExperiment] = []
        self._binary_answer: Optional[ProfileExperiment] = None
        # a running MetricsCollector (--collect-metrics): windows bracket
        # themselves with an extra scrape so window-boundary deltas exist
        # even when the scrape interval is longer than the window
        self.metrics_collector = metrics_collector

    def _stabilizing_latency(self, status: PerfStatus) -> float:
        if self.stability_percentile is None:
            return status.avg_latency_us
        return status.latency_percentiles_us.get(
            self.stability_percentile, status.avg_latency_us
        )

    # -- server stats --------------------------------------------------------

    async def _server_stats(self, model_name: str) -> Dict[str, Tuple[int, int]]:
        try:
            stats = await self.manager.backend.get_inference_statistics(
                model_name
            )
        except Exception:  # noqa: BLE001 - stats are best-effort
            return {}
        out = {}
        for entry in stats.get("model_stats", []):
            if entry.get("name") != model_name:
                continue
            for field, duration in entry.get("inference_stats", {}).items():
                out[field] = (
                    int(duration.get("count", 0)),
                    int(duration.get("ns", 0)),
                )
        return out

    @staticmethod
    def _stats_delta(before, after, field) -> float:
        """Average microseconds for ``field`` over the window."""
        b_count, b_ns = before.get(field, (0, 0))
        a_count, a_ns = after.get(field, (0, 0))
        d_count = a_count - b_count
        if d_count <= 0:
            return 0.0
        return (a_ns - b_ns) / d_count / 1e3

    # -- measurement ---------------------------------------------------------

    async def measure_window(self) -> PerfStatus:
        """One measurement window over the live manager."""
        before = await self._server_stats(self.manager.model_name)
        if self.metrics_collector is not None:
            await self.metrics_collector.scrape_now()
        self.manager.swap_records()  # discard partial records
        start_ns = time.monotonic_ns()
        if self.count_windows:
            deadline = start_ns + int(self.measurement_interval_s * 1e9)
            while (
                self.manager.record_count() < self.measurement_request_count
                and time.monotonic_ns() < deadline
            ):
                await asyncio.sleep(0.002)
        else:
            await asyncio.sleep(self.measurement_interval_s)
        self.manager.check_health()
        end_ns = time.monotonic_ns()
        records = self.manager.swap_records()
        after = await self._server_stats(self.manager.model_name)
        if self.metrics_collector is not None:
            await self.metrics_collector.scrape_now()
        status = compute_window_status(
            records, start_ns, end_ns, self.percentiles
        )
        status.server_queue_us = self._stats_delta(before, after, "queue")
        status.server_compute_infer_us = self._stats_delta(
            before, after, "compute_infer"
        )
        status.server_compute_input_us = self._stats_delta(
            before, after, "compute_input"
        )
        status.server_compute_output_us = self._stats_delta(
            before, after, "compute_output"
        )
        # keep records for export
        self._last_records = records
        return status

    def _is_stable(self, windows: List[PerfStatus]) -> bool:
        """Reference DetermineStability: last 3 windows' throughput AND
        latency each within ±stability% of their mean, with valid data."""
        if len(windows) < 3:
            return False
        recent = windows[-3:]
        if any(w.request_count == 0 for w in recent):
            return False
        for values in (
            [w.throughput for w in recent],
            [self._stabilizing_latency(w) for w in recent],
        ):
            mean = sum(values) / 3
            if mean == 0:
                return False
            if any(
                abs(v - mean) / mean > self.stability_pct / 100.0
                for v in values
            ):
                return False
        if self.latency_threshold_us is not None and any(
            self._stabilizing_latency(w) > self.latency_threshold_us
            for w in recent
        ):
            return False
        return True

    async def profile_point(self) -> Tuple[PerfStatus, bool]:
        """Measure until stable or out of trials (reference ProfileHelper).

        Returns (final merged status, stable?).
        """
        if self.warmup_s > 0:
            await asyncio.sleep(self.warmup_s)
            self.manager.swap_records()
        if self.warmup_requests > 0:
            # drop records drained from the previous sweep point so the
            # warm-up counts only requests at the new load level
            self.manager.swap_records()
            while len(self.manager.records) < self.warmup_requests:
                await asyncio.sleep(0.01)
                self.manager.check_health()
            self.manager.swap_records()  # discard warm-up records
        windows: List[PerfStatus] = []
        window_records: List[List[RequestRecord]] = []
        for trial in range(self.max_trials):
            status = await self.measure_window()
            windows.append(status)
            window_records.append(self._last_records)
            if self.verbose:
                print(
                    f"  window {trial + 1}: {status.request_count} requests, "
                    f"{status.throughput:.1f} infer/s, "
                    f"p99 {status.latency_percentiles_us.get(99, 0):.0f} us"
                )
            if self._is_stable(windows):
                merged = self._merge(windows[-3:])
                # records must match the windows the status summarizes
                self._last_records = [
                    r for recs in window_records[-3:] for r in recs
                ]
                return merged, True
        merged = self._merge(windows[-3:] if len(windows) >= 3 else windows)
        self._last_records = [
            r for recs in window_records[-3:] for r in recs
        ]
        return merged, False

    def _merge(self, windows: List[PerfStatus]) -> PerfStatus:
        """Merge the stable windows into one report (reference
        MergePerfStatusReports)."""
        if len(windows) == 1:
            return windows[0]
        merged = PerfStatus(
            window_start_ns=windows[0].window_start_ns,
            window_end_ns=windows[-1].window_end_ns,
        )
        total = sum(w.request_count for w in windows) or 1
        merged.request_count = sum(w.request_count for w in windows)
        merged.error_count = sum(w.error_count for w in windows)
        merged.retry_count = sum(w.retry_count for w in windows)
        merged.throughput = sum(w.throughput for w in windows) / len(windows)
        merged.response_throughput = sum(
            w.response_throughput for w in windows
        ) / len(windows)
        merged.avg_latency_us = (
            sum(w.avg_latency_us * w.request_count for w in windows) / total
        )
        merged.std_latency_us = max(w.std_latency_us for w in windows)
        for q in self.percentiles:
            merged.latency_percentiles_us[q] = sum(
                w.latency_percentiles_us.get(q, 0.0) * w.request_count
                for w in windows
            ) / total
        for field in (
            "server_queue_us",
            "server_compute_infer_us",
            "server_compute_input_us",
            "server_compute_output_us",
        ):
            setattr(
                merged,
                field,
                sum(getattr(w, field) for w in windows) / len(windows),
            )
        # client stage averages weight by each window's traced requests
        merged.traced_count = sum(w.traced_count for w in windows)
        if merged.traced_count:
            for field in (
                "client_serialize_us",
                "client_transport_us",
                "client_deserialize_us",
            ):
                setattr(
                    merged,
                    field,
                    sum(
                        getattr(w, field) * w.traced_count for w in windows
                    ) / merged.traced_count,
                )
        return merged

    # -- sweeps --------------------------------------------------------------

    async def profile_concurrency_range(
        self, start: int, end: int, step: int = 1
    ) -> List[ProfileExperiment]:
        """Linear sweep over concurrency levels (reference Profile<size_t>)."""
        assert isinstance(self.manager, ConcurrencyManager)
        results = []
        concurrency = start
        while concurrency <= end:
            await self.manager.change_concurrency(concurrency)
            status, stable = await self.profile_point()
            status.concurrency = concurrency
            if self.verbose and not stable:
                print(
                    f"  warning: concurrency {concurrency} did not stabilize "
                    f"in {self.max_trials} windows"
                )
            experiment = ProfileExperiment(
                mode="concurrency",
                value=concurrency,
                status=status,
                records=self._last_records,
            )
            self.experiments.append(experiment)
            results.append(experiment)
            if (
                self.latency_threshold_us is not None
                and self._stabilizing_latency(status)
                > self.latency_threshold_us
            ):
                break  # reference: stop the sweep past the latency budget
            concurrency += step
        await self.manager.stop()
        return results

    async def profile_request_rate_range(
        self, start: float, end: float, step: float = 1.0
    ) -> List[ProfileExperiment]:
        """Linear sweep over request rates."""
        assert isinstance(self.manager, RequestRateManager)
        results = []
        rate = start
        while rate <= end + 1e-9:
            await self.manager.change_rate(rate)
            status, stable = await self.profile_point()
            status.request_rate = rate
            experiment = ProfileExperiment(
                mode="request_rate",
                value=rate,
                status=status,
                records=self._last_records,
            )
            self.experiments.append(experiment)
            results.append(experiment)
            if (
                self.latency_threshold_us is not None
                and self._stabilizing_latency(status)
                > self.latency_threshold_us
            ):
                break
            rate += step
        await self.manager.stop()
        return results

    def binary_search_answer(self) -> Optional[ProfileExperiment]:
        """The highest threshold-meeting probe of the last binary search
        (None when nothing met the threshold)."""
        return self._binary_answer

    async def _probe_binary_point(self, mode: str, value) -> float:
        """One bisect probe at the already-applied load value; returns the
        stabilized latency (0.0 when no requests completed)."""
        status, stable = await self.profile_point()
        if mode == "concurrency":
            status.concurrency = int(value)
        else:
            status.request_rate = float(value)
        experiment = ProfileExperiment(
            mode=mode,
            value=value,
            status=status,
            records=self._last_records,
        )
        self.experiments.append(experiment)
        latency = (
            self._stabilizing_latency(status) if status.request_count else 0.0
        )
        meets = 0.0 < latency <= (self.latency_threshold_us or 0.0)
        if meets and (
            self._binary_answer is None
            or value > self._binary_answer.value
        ):
            self._binary_answer = experiment
        if self.verbose:
            verdict = "meets threshold" if meets else "over threshold"
            print(f"  binary search: {mode} {value} -> "
                  f"{latency:.0f} us ({verdict})")
        return latency

    async def _profile_binary(self, mode: str, start: int, end: int, apply):
        """Shared bisect driver: apply(value) retargets the manager, then
        the probe measures/records. Returns only THIS search's probes."""
        if not self.latency_threshold_us:
            raise ValueError("binary search needs latency_threshold_us")
        self._binary_answer = None
        first = len(self.experiments)
        lo, hi = start, end
        while lo <= hi:
            mid = lo + (hi - lo) // 2
            await apply(mid)
            latency = await self._probe_binary_point(mode, mid)
            if 0.0 < latency <= self.latency_threshold_us:
                if mid >= hi:
                    break
                lo = mid + 1
            else:
                if mid <= lo:
                    break
                hi = mid - 1
        await self.manager.stop()
        return self.experiments[first:]

    async def profile_concurrency_binary(
        self, start: int, end: int
    ) -> List[ProfileExperiment]:
        """Bisect [start, end] for the highest concurrency whose
        stabilized latency meets latency_threshold_us (reference
        Profile<T> binary mode; C++ twin ProfileConcurrencyBinary)."""
        assert isinstance(self.manager, ConcurrencyManager)
        return await self._profile_binary(
            "concurrency", start, end, self.manager.change_concurrency
        )

    async def profile_request_rate_binary(
        self, start: int, end: int
    ) -> List[ProfileExperiment]:
        """Rate twin of profile_concurrency_binary (integral rates >= 1;
        C++ twin ProfileRequestRateBinary)."""
        assert isinstance(self.manager, RequestRateManager)

        async def apply(rate):
            await self.manager.change_rate(float(rate))

        return await self._profile_binary(
            "request_rate", max(1, start), max(1, end), apply
        )

    async def profile_custom_intervals(
        self, intervals_s: Sequence[float]
    ) -> List[ProfileExperiment]:
        """Replay user-supplied inter-request intervals (reference
        CustomLoadManager mode)."""
        assert isinstance(self.manager, RequestRateManager)
        await self.manager.start_custom_intervals(intervals_s)
        status, _ = await self.profile_point()
        mean = sum(intervals_s) / len(intervals_s)
        status.request_rate = 1.0 / mean if mean > 0 else 0.0
        experiment = ProfileExperiment(
            mode="custom_intervals",
            value=status.request_rate,
            status=status,
            records=self._last_records,
        )
        self.experiments.append(experiment)
        await self.manager.stop()
        return [experiment]

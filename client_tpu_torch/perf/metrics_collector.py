"""Server-metrics collection during a perf run (``--collect-metrics``).

The port's own copy of ``client_tpu/perf/metrics_collector.py``, its
HTTP on stdlib asyncio (the harness's REST session) instead of aiohttp;
``bucket_delta`` is an own copy of ``client_tpu/observability/fleet.py``'s.
The fleet view (``FleetCollector``, several ``--metrics-url`` replicas)
waits for the port of ``observability/fleet.py``.

The Python twin of the reference's MetricsManager (reference
metrics_manager.h:45-92): while the load managers drive traffic, a
background task scrapes the server's Prometheus endpoint on an interval,
parses the exposition text with
:func:`client_tpu_torch.observability.metrics.parse_exposition` (our own
renderer's round-trip partner), and reduces the snapshot series to the
report's "Server metrics" section — avg/max TPU duty cycle, peak HBM
used, queue-vs-compute ratio, and the batch-size distribution the
dynamic batcher actually achieved under this load.

Duty cycle is derived from the server's monotone
``tpu_device_compute_ns_total`` counter (busy-ns delta over the scrape
interval), not from the server-computed ``tpu_duty_cycle`` gauge — the
gauge's interval is "since the last scrape by anyone", which another
scraper (an operator dashboard) would shorten; the counter is immune.

Clock-injectable (``clock_ns``) like the rest of the observability
stack; ``tools/clock_lint.py`` bans direct ``time.*()`` calls here.
"""

import asyncio
import json
import time
from typing import Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlencode

from client_tpu_torch.observability.metrics import (
    ParsedFamily,
    counter_total,
    gauge_values,
    histogram_totals,
    parse_exposition,
)
from client_tpu_torch.perf.backend import _RestSessionMixin
from client_tpu_torch.perf.records import ServerMetricsSummary

Snapshot = Tuple[int, Dict[str, ParsedFamily]]


def bucket_delta(
    before: List[Tuple[float, float]], after: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Per-bucket (non-cumulative) observation deltas between two
    cumulative bucket snapshots."""
    base = dict(before)
    out: List[Tuple[float, float]] = []
    previous = 0.0
    for le, cumulative in after:
        delta = cumulative - base.get(le, 0.0)
        out.append((le, delta - previous))
        previous = delta
    return out


class _Rest(_RestSessionMixin):
    """Keep-alive HTTP/1.1 on stdlib asyncio (the harness's REST session)."""

    async def request(self, method: str, url: str, doc=None) -> Tuple[int, bytes]:
        data = b"" if doc is None else json.dumps(doc).encode()
        headers = {"Content-Type": "application/json"} if doc is not None else {}
        async with self._rest(method, url, data, headers) as response:
            return response.status, await response.read()


async def _request_once(method: str, url: str, doc=None) -> Tuple[int, bytes]:
    rest = _Rest()
    try:
        return await rest.request(method, url, doc)
    finally:
        await rest.close()


def _normalize_url(url: str) -> str:
    if not url.startswith("http://") and not url.startswith("https://"):
        url = f"http://{url}"
    if "/metrics" not in url.split("://", 1)[1]:
        url = url.rstrip("/") + "/metrics"
    return url


class MetricsCollector:
    """Scrapes ``/metrics`` on an interval; reduces snapshots to a summary.

    Parameters
    ----------
    url:
        Metrics endpoint (``host:port``, ``host:port/metrics``, or a full
        ``http://`` URL).
    interval_s:
        Seconds between scrapes (reference ``--metrics-interval``, there
        in milliseconds).
    model_name:
        When set, per-model families (histograms, success/failure) are
        filtered to this model; TPU-wide gauges are unaffected.
    fetch:
        Injectable async ``() -> str`` returning the exposition text
        (tests); None gets ``url`` over HTTP.
    clock_ns:
        Injectable monotonic clock.
    """

    def __init__(
        self,
        url: str,
        interval_s: float = 1.0,
        model_name: str = "",
        fetch: Optional[Callable[[], Awaitable[str]]] = None,
        clock_ns: Callable[[], int] = time.monotonic_ns,
    ):
        if interval_s <= 0:
            raise ValueError(f"metrics interval must be > 0, got {interval_s}")
        self.url = _normalize_url(url)
        self.interval_s = interval_s
        self.model_name = model_name
        self._fetch = fetch
        self._clock_ns = clock_ns
        self._rest: Optional[_Rest] = None
        self._task: Optional[asyncio.Task] = None
        self.snapshots: List[Snapshot] = []
        self.scrape_errors = 0
        self.last_error: Optional[str] = None
        self._stopped = False

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Take the baseline scrape and begin the interval loop."""
        await self.scrape_now()
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            await self.scrape_now()

    async def stop(self) -> None:
        """Cancel the loop and take the closing scrape (idempotent)."""
        if self._stopped:
            return
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.scrape_now()
        if self._rest is not None:
            await self._rest.close()
            self._rest = None

    # -- scraping -----------------------------------------------------------

    async def _get(self) -> str:
        if self._fetch is not None:
            return await self._fetch()
        if self._rest is None:
            self._rest = _Rest()
        status, body = await self._rest.request("GET", self.url)
        text = body.decode("utf-8", errors="replace")
        if status != 200:
            raise RuntimeError(f"metrics endpoint HTTP {status}: {text[:200]!r}")
        return text

    async def scrape_now(self) -> bool:
        """One scrape; False (and an error count) on failure — a missing
        metrics endpoint degrades the report, never the run."""
        try:
            families = parse_exposition(await self._get())
        except Exception as e:  # noqa: BLE001 - collection is best-effort
            self.scrape_errors += 1
            self.last_error = str(e)
            return False
        self.snapshots.append((self._clock_ns(), families))
        return True

    # -- reduction ----------------------------------------------------------

    def _model_match(self) -> Optional[Dict[str, str]]:
        return {"model": self.model_name} if self.model_name else None

    def summary(self) -> ServerMetricsSummary:
        """Reduce the scrape series to the report's server-metrics block.

        Counters and histograms are reported as FIRST->LAST deltas, so the
        baseline scrape taken by :meth:`start` subtracts out everything
        that happened before this run.
        """
        out = ServerMetricsSummary(
            scrape_count=len(self.snapshots),
            scrape_errors=self.scrape_errors,
        )
        if not self.snapshots:
            return out
        match = self._model_match()
        first_ns, first = self.snapshots[0]
        last_ns, last = self.snapshots[-1]

        # Duty cycle from the monotone busy counter. The average must be
        # time-weighted: scrape intervals are deliberately unequal (the
        # interval loop plus the profiler's window-bracketing scrapes), so
        # an unweighted mean of per-interval duties would let a 20 ms
        # bracket interval outvote a 1 s load interval. The overall
        # first->last busy/wall ratio IS the time-weighted mean; the
        # per-interval series still supplies the peak. The counter is
        # labeled per device (sharded models credit every mesh device);
        # the aggregate divides by the device count so a fully-busy
        # 4-device mesh reads 100%, not 400%.
        duties: List[float] = []
        first_busy: Optional[Tuple[int, float]] = None
        prev: Optional[Tuple[int, float]] = None
        n_devices = 1
        first_by_device: Dict[str, Tuple[int, float]] = {}
        last_by_device: Dict[str, Tuple[int, float]] = {}
        for t_ns, families in self.snapshots:
            family = families.get("tpu_device_compute_ns_total")
            busy = gauge_values(family)
            if not busy:
                continue
            n_devices = max(n_devices, len(busy))
            for sample in family.samples:
                device = sample.labels.get("device", "")
                if device not in first_by_device:
                    first_by_device[device] = (t_ns, sample.value)
                last_by_device[device] = (t_ns, sample.value)
            total = sum(busy)
            if prev is not None and t_ns > prev[0]:
                delta = max(0.0, total - prev[1])
                duties.append(
                    min(1.0, delta / ((t_ns - prev[0]) * n_devices))
                )
            if first_busy is None:
                first_busy = (t_ns, total)
            prev = (t_ns, total)
        if duties:
            out.duty_max = max(duties)
            if prev[0] > first_busy[0]:
                out.duty_avg = min(
                    1.0,
                    max(0.0, prev[1] - first_busy[1])
                    / ((prev[0] - first_busy[0]) * n_devices),
                )
            for device, (t0, v0) in first_by_device.items():
                t1, v1 = last_by_device[device]
                if t1 > t0:
                    out.device_duty[device] = min(
                        1.0, max(0.0, v1 - v0) / (t1 - t0)
                    )
        else:
            # endpoint without the counter: fall back to the gauge samples
            # (server-computed per-scrape duties; unweighted by necessity)
            for _t_ns, families in self.snapshots[1:] or self.snapshots:
                duties.extend(gauge_values(families.get("tpu_duty_cycle")))
            if duties:
                out.duty_avg = sum(duties) / len(duties)
                out.duty_max = max(duties)

        # Peak HBM: max over snapshots of the total across devices.
        for _t_ns, families in self.snapshots:
            used = gauge_values(families.get("tpu_memory_used_bytes"))
            if used:
                out.memory_peak_bytes = max(out.memory_peak_bytes, sum(used))

        def _delta(name: str) -> Dict[str, float]:
            a = histogram_totals(first.get(name), match)
            b = histogram_totals(last.get(name), match)
            return {
                "count": b["count"] - a["count"],
                "sum": b["sum"] - a["sum"],
                "buckets": bucket_delta(a["buckets"], b["buckets"]),
            }

        request = _delta("tpu_inference_request_duration")
        queue = _delta("tpu_inference_queue_duration")
        compute = _delta("tpu_inference_compute_duration")
        batch = _delta("tpu_inference_batch_size")
        if request["count"] > 0:
            out.request_count = int(request["count"])
            out.avg_request_us = request["sum"] / request["count"] * 1e6
        if queue["count"] > 0:
            out.avg_queue_us = queue["sum"] / queue["count"] * 1e6
        if compute["count"] > 0:
            out.avg_compute_us = compute["sum"] / compute["count"] * 1e6
        if compute["sum"] > 0:
            out.queue_compute_ratio = queue["sum"] / compute["sum"]
        if batch["count"] > 0:
            out.batch_avg = batch["sum"] / batch["count"]
            out.batch_buckets = batch["buckets"]
        out.success_count = int(
            counter_total(last.get("tpu_inference_request_success"), match)
            - counter_total(first.get("tpu_inference_request_success"), match)
        )
        out.failure_count = int(
            counter_total(last.get("tpu_inference_request_failure"), match)
            - counter_total(first.get("tpu_inference_request_failure"), match)
        )
        out.window_s = max(0.0, (last_ns - first_ns) / 1e9)

        # Per-stage thread-CPU deltas (tpu_request_cpu_seconds{stage},
        # populated when --profile-server enabled the accounting). The
        # stage label set is discovered from the last scrape.
        stage_family = last.get("tpu_request_cpu_seconds")
        if stage_family is not None:
            stages = sorted(
                {
                    s.labels["stage"]
                    for s in stage_family.samples
                    if "stage" in s.labels
                }
            )
            first_family = first.get("tpu_request_cpu_seconds")
            for stage in stages:
                a = histogram_totals(first_family, {"stage": stage})
                b = histogram_totals(stage_family, {"stage": stage})
                count = b["count"] - a["count"]
                cpu_s = b["sum"] - a["sum"]
                if count > 0:
                    out.stage_cpu[stage] = {"count": count, "cpu_s": cpu_s}
        return out


# -- server profiling control (--profile-server / --flamegraph-out) ----------


def server_base_url(url: str) -> str:
    """host:port / http://host:port[/metrics] -> http://host:port."""
    if not url.startswith("http://") and not url.startswith("https://"):
        url = f"http://{url}"
    scheme, rest = url.split("://", 1)
    return f"{scheme}://{rest.split('/', 1)[0]}"


async def set_stage_cpu(url: str, enabled: bool) -> Optional[Dict]:
    """Toggle the server's stage-CPU accounting via
    ``POST /v2/debug/profiling``; returns ``{"previous": ..,
    "current": ..}`` config dicts (the caller restores ``previous``
    after the run; ``current`` carries the calibrated clock mode), or
    None when the endpoint is unreachable — profiling degrades, the run
    proceeds."""
    base = server_base_url(url)
    rest = _Rest()
    try:
        status, body = await rest.request("GET", f"{base}/v2/debug/profiling")
        if status != 200:
            return None
        previous = json.loads(body)
        status, body = await rest.request("POST", f"{base}/v2/debug/profiling",
                                          {"stage_cpu": enabled})
        if status != 200:
            return None
        return {"previous": previous, "current": json.loads(body)}
    except Exception:  # noqa: BLE001 - profiling is best-effort
        return None
    finally:
        await rest.close()


async def fetch_profile(
    url: str,
    duration_s: float,
    hz: float = 99.0,
    fmt: str = "collapsed",
) -> Optional[str]:
    """Run the server's on-demand sampler (``GET /v2/debug/profile``)
    and return the export text; None on any failure."""
    query = urlencode({"duration_s": f"{duration_s:g}", "hz": f"{hz:g}", "format": fmt})
    try:
        status, body = await asyncio.wait_for(
            _request_once("GET", f"{server_base_url(url)}/v2/debug/profile?{query}"),
            duration_s + 30.0)
    except Exception:  # noqa: BLE001 - profiling is best-effort
        return None
    return body.decode("utf-8", errors="replace") if status == 200 else None


async def fetch_debug_requests(
    url: str, model: str = "", limit: Optional[int] = None
) -> Optional[Dict]:
    """Fetch the server's flight-recorder snapshot
    (``GET /v2/debug/requests``): recent / failed / slowest request
    exemplars with per-stage timings. None on any failure — the dump is
    best-effort, the run's results stand without it."""
    params: Dict[str, str] = {}
    if model:
        params["model"] = model
    if limit is not None:
        params["limit"] = str(limit)
    query = f"?{urlencode(params)}" if params else ""
    try:
        status, body = await _request_once(
            "GET", f"{server_base_url(url)}/v2/debug/requests{query}")
        return json.loads(body) if status == 200 else None
    except Exception:  # noqa: BLE001 - debug dump is best-effort
        return None

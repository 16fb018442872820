"""Per-model SLO objectives and the live-telemetry tracker behind them.

The port's own copy of ``client_tpu/observability/slo.py``.

The statistics extension and the exposition histograms are cumulative
since server start; SLO operations run on *rolling* signals: "what is
p99 over the last 30 seconds" and "how fast am I burning this model's
error budget". :class:`LiveTelemetry` keeps both, fed from the same
ServerCore stage events that feed the statistics extension (the
``ServerMetrics.observe_success``/``observe_failure`` hooks), so the
live signals can never disagree with the cumulative ones about what
happened — only about *when*.

Objectives are declared in repository config: a model sets

.. code-block:: python

    class MyModel(Model):
        slo = {
            "latency_target_ms": 50,   # or latency_target_s
            "availability": 0.999,     # request-success objective
            "window_s": 300,           # error-budget window
        }

A request is **bad** when it fails OR completes over the latency target;
the burn rate is ``bad_fraction / (1 - availability)`` over the rolling
window (the SRE-workbook multiple: 1.0 = burning exactly the budget,
sustainable; >1 = an alert-worthy burn), and the remaining error budget
is the fraction of the window's allowance still unspent.

Surfaced three ways: ``/metrics`` gauges (``tpu_rolling_latency_seconds
{model,window,quantile}``, ``tpu_slo_latency_burn_rate{model}``,
``tpu_slo_error_budget_remaining{model}``), the ``GET /v2/debug/slo``
document, and the ``slo`` block of ``GET /v2/debug/state``.

Clock-injectable throughout (``tools/clock_lint.py`` covers this
package); ``enabled`` can be flipped off to A/B the recording overhead
(guarded under 2% p50 in the test suite).
"""

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from client_tpu_torch.observability.window import (
    WindowedCounter,
    WindowedHistogram,
)

__all__ = ["DEFAULT_WINDOWS", "LiveTelemetry", "ROLLING_QUANTILES", "SloObjective"]

# (label, horizon seconds, sub-window count): the 30 s window answers
# "right now", the 5 m window smooths pager decisions. Labels are the
# `window` label values on the rolling gauges.
DEFAULT_WINDOWS: Tuple[Tuple[str, float, int], ...] = (
    ("30s", 30.0, 6),
    ("5m", 300.0, 10),
)
ROLLING_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


@dataclass(frozen=True)
class SloObjective:
    """One model's declared service-level objective."""

    latency_target_s: float = 0.0  # 0 = no latency objective
    availability: float = 0.999
    window_s: float = 300.0

    @classmethod
    def from_model(cls, model) -> Optional["SloObjective"]:
        """The objective a repository model declares via its ``slo``
        attribute (dict), or None when it declares none. Raises on a
        malformed declaration — a typo'd SLO silently tracking nothing
        is worse than a load failure."""
        declared = getattr(model, "slo", None)
        if not declared:
            return None
        if not isinstance(declared, dict):
            raise ValueError(
                f"model slo declaration must be a dict, got {declared!r}"
            )
        known = {"latency_target_ms", "latency_target_s", "availability", "window_s"}
        unknown = set(declared) - known
        if unknown:
            raise ValueError(f"unknown slo key '{sorted(unknown)[0]}'")
        target_s = float(declared.get("latency_target_s", 0.0))
        if "latency_target_ms" in declared:
            target_s = float(declared["latency_target_ms"]) / 1e3
        availability = float(declared.get("availability", 0.999))
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"slo availability must be in (0, 1), got {availability}"
            )
        window_s = float(declared.get("window_s", 300.0))
        if window_s <= 0:
            raise ValueError(f"slo window_s must be > 0, got {window_s}")
        return cls(
            latency_target_s=target_s,
            availability=availability,
            window_s=window_s,
        )

    def config(self) -> Dict[str, Any]:
        return {
            "latency_target_s": self.latency_target_s,
            "availability": self.availability,
            "window_s": self.window_s,
        }


class _ModelTelemetry:
    """One model's rolling windows + optional SLO budget window."""

    __slots__ = ("windows", "objective", "budget")

    def __init__(
        self,
        buckets: Sequence[float],
        windows: Sequence[Tuple[str, float, int]],
        objective: Optional[SloObjective],
        clock_ns: Callable[[], int],
    ):
        self.windows = {
            label: WindowedHistogram(
                buckets, horizon_s=horizon, subwindows=subs, clock_ns=clock_ns
            )
            for label, horizon, subs in windows
        }
        self.objective = objective
        self.budget = (
            WindowedCounter(
                horizon_s=objective.window_s,
                subwindows=10,
                clock_ns=clock_ns,
            )
            if objective is not None
            else None
        )


class LiveTelemetry:
    """Rolling latency windows per model + SLO burn-rate tracking.

    Parameters
    ----------
    buckets:
        The latency bucket grid (seconds) — the server passes the same
        grid its exposition histograms use, so rolling and cumulative
        quantiles are computed over identical resolution.
    clock_ns:
        Injectable monotonic clock shared by every window.
    objective_resolver:
        ``model_name -> Optional[SloObjective]``; consulted once per
        model on first record (the server resolves from repository
        config). None means no model has an SLO.
    """

    def __init__(
        self,
        buckets: Sequence[float],
        clock_ns: Callable[[], int] = time.monotonic_ns,
        objective_resolver: Optional[
            Callable[[str], Optional[SloObjective]]
        ] = None,
        windows: Sequence[Tuple[str, float, int]] = DEFAULT_WINDOWS,
        quantiles: Sequence[float] = ROLLING_QUANTILES,
    ):
        self.buckets = tuple(float(b) for b in buckets)
        self.window_spec = tuple(windows)
        self.quantiles = tuple(quantiles)
        self.enabled = True
        self._clock_ns = clock_ns
        self._resolver = objective_resolver
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelTelemetry] = {}
        # bumped by reset(): an objective resolved before a concurrent
        # reset() must not be installed after it (stale-SLO TOCTOU)
        self._generation = 0

    # -- hot path -------------------------------------------------------------

    def _state(self, model: str) -> _ModelTelemetry:
        state = self._models.get(model)
        while state is None:
            # resolve OUTSIDE the lock (the resolver walks repository
            # config), but only install the result if no reset() ran in
            # between — otherwise the objective just resolved may be the
            # pre-reload one, and installing it would pin the stale SLO
            # until the next reload (the staleness reset() exists to kill)
            with self._lock:
                generation = self._generation
            objective = None
            if self._resolver is not None:
                try:
                    objective = self._resolver(model)
                except Exception:  # noqa: BLE001 - bad SLO must not fail requests
                    objective = None
            with self._lock:
                state = self._models.get(model)
                if state is not None:
                    break
                if self._generation != generation:
                    continue  # reset raced us; re-resolve
                state = _ModelTelemetry(
                    self.buckets, self.window_spec, objective,
                    self._clock_ns,
                )
                self._models[model] = state
        return state

    def reset(self, model: str) -> None:
        """Forget one model's windows and cached objective. Hot model
        reload calls this so the next record re-resolves the repository's
        CURRENT ``slo`` declaration — without it a reloaded model would
        burn against its pre-reload target forever."""
        with self._lock:
            self._models.pop(model, None)
            self._generation += 1

    def record(
        self, model: str, latency_s: float, ok: bool = True, count: int = 1
    ) -> None:
        """Book ``count`` completed requests (per-request latency; merged
        batch paths pass their chunk average with count=n). Failures
        contribute to the SLO bad count but not to the latency windows —
        mirroring the cumulative duration histograms, which only book
        successes."""
        if not self.enabled or count <= 0:
            return
        state = self._state(model)
        # one clock read per record, shared by every ring it touches —
        # on hosts where the monotonic clock is syscall-trapped this is
        # the difference between ~1 and ~3 trap costs per request
        now_ns = self._clock_ns()
        if ok:
            for window in state.windows.values():
                window.observe(latency_s, count, now_ns=now_ns)
        if state.budget is not None:
            objective = state.objective
            bad = (
                not ok
                or (
                    objective.latency_target_s > 0
                    and latency_s > objective.latency_target_s
                )
            )
            if bad:
                state.budget.add(bad=count, now_ns=now_ns)
            else:
                state.budget.add(good=count, now_ns=now_ns)

    # -- derived signals ------------------------------------------------------

    @staticmethod
    def _burn(objective: SloObjective, good: int, bad: int) -> Tuple[float, float]:
        """(burn_rate, budget_remaining) over one window's totals."""
        total = good + bad
        if total <= 0:
            return 0.0, 1.0
        allowed_fraction = 1.0 - objective.availability
        bad_fraction = bad / total
        burn_rate = bad_fraction / allowed_fraction
        allowed_count = allowed_fraction * total
        remaining = max(0.0, 1.0 - bad / allowed_count) if allowed_count else 0.0
        return burn_rate, min(1.0, remaining)

    def models(self):
        with self._lock:
            return list(self._models.items())

    def rolling(self, model: str) -> Dict[str, Dict[str, float]]:
        """Per-window rolling stats for one model:
        ``{window: {count, p50_us, p95_us, p99_us, avg_us}}``."""
        state = self._models.get(model)
        if state is None:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for label, window in state.windows.items():
            snap = window.snapshot()
            entry: Dict[str, float] = {"count": snap.count}
            if snap.count:
                entry["avg_us"] = round(snap.sum / snap.count * 1e6, 1)
            for q in self.quantiles:
                entry[f"p{_q_label(q)}_us"] = round(
                    snap.quantile(q) * 1e6, 1
                )
            out[label] = entry
        return out

    def slo_status(self, model: str) -> Optional[Dict[str, Any]]:
        state = self._models.get(model)
        if state is None or state.objective is None or state.budget is None:
            return None
        good, bad = state.budget.totals()
        burn_rate, remaining = self._burn(state.objective, good, bad)
        return {
            "objective": state.objective.config(),
            "window_good": good,
            "window_bad": bad,
            "burn_rate": round(burn_rate, 4),
            "error_budget_remaining": round(remaining, 4),
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /v2/debug/slo`` document: every tracked model's
        rolling windows + SLO status in one read."""
        doc: Dict[str, Any] = {
            "windows": [
                {"label": label, "horizon_s": horizon, "subwindows": subs}
                for label, horizon, subs in self.window_spec
            ],
            "models": {},
        }
        for name, _state in self.models():
            entry: Dict[str, Any] = {"rolling": self.rolling(name)}
            slo = self.slo_status(name)
            if slo is not None:
                entry["slo"] = slo
            doc["models"][name] = entry
        return doc

    def summary(self) -> Dict[str, Any]:
        """Compact per-model block for ``/v2/debug/state``: the shortest
        rolling window's p99 plus burn rate, nothing else."""
        out: Dict[str, Any] = {}
        short_label = self.window_spec[0][0] if self.window_spec else None
        for name, _state in self.models():
            rolling = self.rolling(name).get(short_label, {})
            entry: Dict[str, Any] = {
                f"rolling_{short_label}_p99_us": rolling.get("p99_us", 0.0),
                f"rolling_{short_label}_count": rolling.get("count", 0),
            }
            slo = self.slo_status(name)
            if slo is not None:
                entry["burn_rate"] = slo["burn_rate"]
                entry["error_budget_remaining"] = slo[
                    "error_budget_remaining"
                ]
            out[name] = entry
        return out

    def collect(self, rolling_gauge, burn_gauge, budget_gauge) -> None:
        """Scrape-time gauge refresh (the server registry's collect
        hook): rolling quantiles per (model, window) and the two SLO
        gauges for models that declare an objective. Children whose
        model is no longer tracked (``reset()`` on unload/reload) are
        pruned — without this a gauge would report the unloaded model's
        last pre-unload value forever, contradicting ``/v2/debug/slo``
        and keeping burn-rate alerts firing for a model that no longer
        serves."""
        models = self.models()
        tracked = {name for name, _ in models}
        with_slo = {
            name
            for name, state in models
            if state.objective is not None and state.budget is not None
        }
        for key in rolling_gauge.label_sets():
            if key and key[0] not in tracked:
                rolling_gauge.remove(*key)
        for gauge in (burn_gauge, budget_gauge):
            # a reload may also DROP the slo declaration, so prune on the
            # objective set, not mere presence
            for key in gauge.label_sets():
                if key and key[0] not in with_slo:
                    gauge.remove(*key)
        for name, state in models:
            for label, window in state.windows.items():
                snap = window.snapshot()
                for q in self.quantiles:
                    rolling_gauge.labels(name, label, str(q)).set(
                        snap.quantile(q)
                    )
            if state.objective is not None and state.budget is not None:
                good, bad = state.budget.totals()
                burn_rate, remaining = self._burn(
                    state.objective, good, bad
                )
                burn_gauge.labels(name).set(burn_rate)
                budget_gauge.labels(name).set(remaining)


def _q_label(q: float) -> str:
    """0.5 -> "50", 0.95 -> "95", 0.99 -> "99" (debug-doc key suffix)."""
    return f"{q * 100:g}"

"""Dependency-free Prometheus metrics: registry, families, exposition I/O.

The port's own copy of ``client_tpu/observability/metrics.py``: the
same families render the same bytes, so either package's harness
scrapes either server.

The metrics counterpart of :mod:`client_tpu_torch.observability.trace`: a small
registry (Counter / Gauge / Histogram with labels) that renders the
Prometheus text exposition format exactly — HELP before TYPE before
samples, label-value escaping, histogram ``_bucket``/``_sum``/``_count``
invariants — plus a parser for the same format, so the perf harness's
:class:`~client_tpu_torch.perf.metrics_collector.MetricsCollector` can scrape
our own ``/metrics`` output (and any other Prometheus endpoint) without a
client library.

Server wiring lives in :mod:`client_tpu_torch.server.metrics` (the registry the
``/metrics`` endpoint renders); this module is pure data structures.

Thread-safety: one lock per family guards its children AND their values,
so a scrape's view of any single family is consistent — a histogram can
never render a bucket count that disagrees with ``_count``. No component
here reads a clock (``tools/clock_lint.py`` enforces it): rate-style
derivations (duty cycle) belong to the callers, which inject clocks.
"""

import bisect
import math
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ParsedFamily",
    "ParsedSample",
    "escape_help",
    "escape_label_value",
    "format_exemplar",
    "format_value",
    "histogram_totals",
    "parse_exposition",
    "unescape_help",
    "unescape_label_value",
]

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus client_golang defaults; families override per domain.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5,
    0.75, 1.0, 2.5, 5.0, 7.5, 10.0,
)


def escape_label_value(value: str) -> str:
    """Exposition-format label-VALUE escaping (``\\``, ``"``, newline)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def unescape_label_value(value: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ('"', "\\"):
                out.append(nxt)
            else:  # unknown escape: keep both chars (Prometheus behavior)
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def escape_help(text: str) -> str:
    """HELP-line escaping (``\\`` and newline only; quotes stay bare)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def unescape_help(text: str) -> str:
    """Left-to-right HELP unescaping — ordered ``str.replace`` would turn
    the tail of an escaped backslash into a newline (``a\\nb`` escapes to
    ``a\\\\nb``, whose ``\\n`` substring is NOT a newline escape)."""
    out: List[str] = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def format_value(value: float) -> str:
    """Render a sample value the way Prometheus expects: integers bare,
    floats in shortest round-trip form, infinities as ``+Inf``/``-Inf``."""
    if isinstance(value, float):
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if math.isnan(value):
            return "NaN"
        if value == int(value) and abs(value) < 1e15:
            return str(int(value))
        return repr(value)
    return str(value)


def _format_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    parts = ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + parts + "}"


class _Child:
    """One labeled time series of a Counter/Gauge family."""

    __slots__ = ("_family", "_value")

    def __init__(self, family: "_Family"):
        self._family = family
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind == "counter" and amount < 0:
            raise ValueError("counters can only increase; use a gauge")
        with self._family._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._family.kind == "counter":
            raise ValueError("counters can only increase; use a gauge")
        with self._family._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        """Set the value outright. Gauges use this freely; counters only
        for scrape-time mirrors of an external cumulative total (the
        statistics-extension parity families)."""
        with self._family._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._family._lock:
            return self._value


class _HistogramChild:
    """One labeled histogram series: bucket counts + sum."""

    __slots__ = ("_family", "_counts", "_sum", "_exemplars")

    def __init__(self, family: "Histogram"):
        self._family = family
        # one slot per finite bound plus the +Inf overflow slot
        self._counts = [0] * (len(family.buckets) + 1)
        self._sum = 0.0
        # bucket index -> (labels dict, observed value): the most recent
        # exemplar per bucket (OpenMetrics exemplars; rendered only when
        # the registry renders with exemplars=True)
        self._exemplars: Optional[Dict[int, Tuple[Dict[str, str], float]]] = None

    def observe(
        self,
        value: float,
        count: int = 1,
        exemplar: Optional[Tuple[Dict[str, str], float]] = None,
    ) -> None:
        """Record ``count`` observations of ``value`` (count > 1 books a
        merged batch in one call — the direct-path per-chunk booking).
        ``exemplar`` — ``(labels, exemplar_value)``, e.g. a trace id and
        its latency — attaches to the bucket containing ``value``."""
        index = bisect.bisect_left(self._family.buckets, value)
        with self._family._lock:
            self._counts[index] += count
            self._sum += value * count
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[index] = exemplar

    def get(self) -> Tuple[List[int], float]:
        with self._family._lock:
            return list(self._counts), self._sum


@dataclass
class Sample:
    """One rendered time series: full sample name, labels, value.
    ``exemplar`` — (labels, value) — rides histogram bucket samples when
    the owning family recorded one (rendered only on request)."""

    name: str
    labels: List[Tuple[str, str]]
    value: float
    exemplar: Optional[Tuple[Dict[str, str], float]] = None


def format_exemplar(exemplar: Tuple[Dict[str, str], float]) -> str:
    """The OpenMetrics exemplar tail: ``# {label="v",...} value``."""
    labels, value = exemplar
    body = ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in labels.items()
    )
    return f"# {{{body}}} {format_value(float(value))}"


class _Family:
    """A named metric family with a fixed label set."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames: Sequence[str] = (),
        registry: Optional["MetricsRegistry"] = None,
    ):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name '{name}'")
        for label in labelnames:
            if not _LABEL_NAME_RE.match(label) or label.startswith("__"):
                raise ValueError(f"invalid label name '{label}'")
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if registry is not None:
            registry.register(self)

    def _make_child(self):
        return _Child(self)

    def labels(self, *values, **labelkwargs):
        """The child for one label-value combination (created on first use).
        Positional values follow ``labelnames`` order; keywords may name
        them instead."""
        if labelkwargs:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(labelkwargs[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for '{self.name}'") from None
            if len(labelkwargs) != len(self.labelnames):
                raise ValueError(f"unexpected labels for '{self.name}'")
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"'{self.name}' takes {len(self.labelnames)} label value(s), "
                f"got {len(key)}"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def remove(self, *values) -> None:
        """Drop the child for one label-value combination (no-op when
        absent) — a family whose label space churns (per-model gauges
        across unloads) prunes here so scrapes stop reporting entities
        that no longer exist."""
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(key, None)

    def label_sets(self) -> List[Tuple[str, ...]]:
        """The label-value combinations currently holding a child."""
        with self._lock:
            return list(self._children.keys())

    # unlabeled conveniences ------------------------------------------------

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def collect(self) -> List[Sample]:
        with self._lock:
            items = [
                (key, child._value) for key, child in self._children.items()
            ]
        return [
            Sample(self.name, list(zip(self.labelnames, key)), value)
            for key, value in items
        ]

    def render(self, out: List[str], exemplars: bool = False) -> None:
        out.append(f"# HELP {self.name} {escape_help(self.documentation)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for sample in self.collect():
            names = [n for n, _ in sample.labels]
            values = [v for _, v in sample.labels]
            line = (
                f"{sample.name}{_format_labels(names, values)} "
                f"{format_value(sample.value)}"
            )
            if exemplars and sample.exemplar is not None:
                line += f" {format_exemplar(sample.exemplar)}"
            out.append(line)


class Counter(_Family):
    kind = "counter"


class Gauge(_Family):
    kind = "gauge"

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)


class Histogram(_Family):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        registry: Optional["MetricsRegistry"] = None,
    ):
        buckets = tuple(float(b) for b in buckets)
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError("histogram buckets must strictly increase")
        if math.isinf(buckets[-1]):  # +Inf is implicit
            buckets = buckets[:-1]
        self.buckets = buckets
        super().__init__(name, documentation, labelnames, registry)

    def _make_child(self):
        return _HistogramChild(self)

    def observe(
        self,
        value: float,
        count: int = 1,
        exemplar: Optional[Tuple[Dict[str, str], float]] = None,
    ) -> None:
        self.labels().observe(value, count, exemplar=exemplar)

    def collect(self) -> List[Sample]:
        with self._lock:
            items = [
                (
                    key,
                    list(child._counts),
                    child._sum,
                    dict(child._exemplars) if child._exemplars else None,
                )
                for key, child in self._children.items()
            ]
        samples: List[Sample] = []
        for key, counts, total, exemplars in items:
            base = list(zip(self.labelnames, key))
            cumulative = 0
            for i, (bound, count) in enumerate(zip(self.buckets, counts)):
                cumulative += count
                samples.append(
                    Sample(
                        f"{self.name}_bucket",
                        base + [("le", format_value(float(bound)))],
                        cumulative,
                        exemplar=exemplars.get(i) if exemplars else None,
                    )
                )
            cumulative += counts[-1]
            samples.append(
                Sample(
                    f"{self.name}_bucket",
                    base + [("le", "+Inf")],
                    cumulative,
                    exemplar=(
                        exemplars.get(len(self.buckets)) if exemplars else None
                    ),
                )
            )
            samples.append(Sample(f"{self.name}_sum", list(base), total))
            samples.append(Sample(f"{self.name}_count", list(base), cumulative))
        return samples


class MetricsRegistry:
    """Owns metric families and renders the exposition document.

    ``collect hooks`` run at the start of every render — the place to
    refresh scrape-derived values (statistics-extension mirrors, device
    memory gauges, duty cycle) so each scrape reflects exactly one
    consistent snapshot of its source.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collect_hooks: List[Callable[[], None]] = []

    def register(self, family: _Family) -> _Family:
        with self._lock:
            if family.name in self._families:
                raise ValueError(
                    f"metric family '{family.name}' already registered"
                )
            self._families[family.name] = family
        return family

    def add_collect_hook(self, hook: Callable[[], None]) -> None:
        with self._lock:
            self._collect_hooks.append(hook)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def render(self, exemplars: bool = False) -> str:
        """The full exposition document (HELP, TYPE, samples per family,
        registration order). Hook failures are swallowed: a scrape must
        degrade, never 500. ``exemplars=True`` appends OpenMetrics
        exemplars to histogram bucket samples that carry one; the
        default Prometheus text format is byte-identical to before."""
        with self._lock:
            hooks = list(self._collect_hooks)
            families = list(self._families.values())
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 - metrics must never fail a scrape
                pass
        lines: List[str] = []
        for family in families:
            family.render(lines, exemplars=exemplars)
        return "\n".join(lines) + "\n"

    def sample_value(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        """Test/debug convenience: the value of one rendered sample
        (``name`` may be a histogram's ``_bucket``/``_sum``/``_count``)."""
        wanted = dict(labels or {})
        for family in self.families():
            for sample in family.collect():
                if sample.name == name and dict(sample.labels) == wanted:
                    return sample.value
        return None


# ---------------------------------------------------------------------------
# exposition-format parsing (the collector's half of the round trip)


@dataclass
class ParsedSample:
    name: str
    labels: Dict[str, str]
    value: float
    # OpenMetrics exemplar (labels, value) when the sample carried one
    exemplar: Optional[Tuple[Dict[str, str], float]] = None


@dataclass
class ParsedFamily:
    name: str
    kind: str = "untyped"
    help: str = ""
    samples: List[ParsedSample] = field(default_factory=list)


def _parse_label_block(block: str, line: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    n = len(block)
    while i < n:
        while i < n and block[i] in ", ":
            i += 1
        if i >= n:
            break
        eq = block.find("=", i)
        if eq < 0:
            raise ValueError(f"malformed label block in: {line}")
        name = block[i:eq].strip()
        i = eq + 1
        if i >= n or block[i] != '"':
            raise ValueError(f"unquoted label value in: {line}")
        i += 1
        raw: List[str] = []
        while i < n:
            c = block[i]
            if c == "\\" and i + 1 < n:
                raw.append(block[i : i + 2])
                i += 2
                continue
            if c == '"':
                break
            raw.append(c)
            i += 1
        if i >= n:
            raise ValueError(f"unterminated label value in: {line}")
        i += 1  # closing quote
        labels[name] = unescape_label_value("".join(raw))
    return labels


def _find_block_end(text: str, start: int) -> int:
    """Index of the ``}`` closing the label block opened at
    ``text[start] == '{'``, honoring quoted values and escapes — an
    exemplar tail may carry its own brace pair, so a blind rpartition
    would split the wrong block."""
    i = start + 1
    in_quote = False
    n = len(text)
    while i < n:
        c = text[i]
        if in_quote:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_quote = False
        elif c == '"':
            in_quote = True
        elif c == "}":
            return i
        i += 1
    raise ValueError(f"unclosed label block: {text}")


def _parse_exemplar(part: str, line: str) -> Tuple[Dict[str, str], float]:
    """``{label="v"} value [timestamp]`` -> (labels, value)."""
    part = part.strip()
    if not part.startswith("{"):
        raise ValueError(f"malformed exemplar in: {line}")
    end = _find_block_end(part, 0)
    labels = _parse_label_block(part[1:end], line)
    tokens = part[end + 1 :].split()
    if not tokens:
        raise ValueError(f"exemplar missing value in: {line}")
    try:
        value = float(tokens[0])
    except ValueError:
        raise ValueError(f"malformed exemplar value: {line}") from None
    return labels, value


_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_for(name: str, families: Dict[str, ParsedFamily]) -> ParsedFamily:
    # histogram/summary samples attach to their declared base family
    for suffix in _HISTOGRAM_SUFFIXES:
        if name.endswith(suffix):
            base = families.get(name[: -len(suffix)])
            if base is not None and base.kind in ("histogram", "summary"):
                return base
    family = families.get(name)
    if family is None:
        family = ParsedFamily(name=name)
        families[name] = family
    return family


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Parse a Prometheus text-format document into families.

    Tolerant where the format allows: unknown comment lines are skipped,
    optional timestamps are ignored, families without HELP/TYPE are
    collected as ``untyped``. Raises ``ValueError`` only on lines that
    cannot be a sample at all — a scrape of a non-Prometheus endpoint
    should fail loudly, not produce an empty summary.
    """
    families: Dict[str, ParsedFamily] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "HELP":
                family = families.setdefault(
                    parts[2], ParsedFamily(name=parts[2])
                )
                family.help = (
                    unescape_help(parts[3]) if len(parts) > 3 else ""
                )
            elif len(parts) >= 4 and parts[1] == "TYPE":
                family = families.setdefault(
                    parts[2], ParsedFamily(name=parts[2])
                )
                family.kind = parts[3]
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace >= 0 and (space < 0 or brace < space):
            name = line[:brace]
            end = _find_block_end(line, brace)
            labels = _parse_label_block(line[brace + 1 : end], line)
            value_part = line[end + 1 :].strip()
        else:
            name, _, value_part = line.partition(" ")
            labels = {}
        name = name.strip()
        # OpenMetrics exemplar tail: `value [ts] # {labels} value [ts]`
        value_part, exemplar_sep, exemplar_part = value_part.partition("#")
        exemplar = (
            _parse_exemplar(exemplar_part, line) if exemplar_sep else None
        )
        tokens = value_part.split()
        if not name or not tokens:
            raise ValueError(f"malformed sample line: {line}")
        try:
            value = float(tokens[0])  # handles +Inf/-Inf/NaN
        except ValueError:
            raise ValueError(f"malformed sample value: {line}") from None
        _family_for(name, families).samples.append(
            ParsedSample(
                name=name, labels=labels, value=value, exemplar=exemplar
            )
        )
    return families


def _matches(labels: Dict[str, str], want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    return all(labels.get(k) == v for k, v in want.items())


def histogram_totals(
    family: Optional[ParsedFamily],
    match: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Aggregate a parsed histogram family: ``count``, ``sum``, and the
    cumulative ``buckets`` [(le, count)] summed over every series whose
    labels (minus ``le``) match ``match``."""
    totals: Dict[str, Any] = {"count": 0.0, "sum": 0.0, "buckets": []}
    if family is None:
        return totals
    buckets: Dict[float, float] = {}
    for sample in family.samples:
        labels = {k: v for k, v in sample.labels.items() if k != "le"}
        if not _matches(labels, match):
            continue
        if sample.name.endswith("_count"):
            totals["count"] += sample.value
        elif sample.name.endswith("_sum"):
            totals["sum"] += sample.value
        elif sample.name.endswith("_bucket"):
            le = float(sample.labels.get("le", "+Inf"))
            buckets[le] = buckets.get(le, 0.0) + sample.value
    totals["buckets"] = sorted(buckets.items())
    return totals


def gauge_values(
    family: Optional[ParsedFamily],
    match: Optional[Dict[str, str]] = None,
) -> List[float]:
    """Every matching sample value of a parsed counter/gauge family."""
    if family is None:
        return []
    return [s.value for s in family.samples if _matches(s.labels, match)]


def counter_total(
    family: Optional[ParsedFamily],
    match: Optional[Dict[str, str]] = None,
) -> float:
    return float(sum(gauge_values(family, match)))

"""Prometheus primitives and exposition validation: the port's copy of the
JAX package's ``telemetry/metrics.py``, so one dashboard reads both.

  - :class:`Histogram` / :class:`Counter` / :class:`Gauge`: one Prometheus
    family each, thread-safe recording plus text exposition. Pure stdlib,
    O(buckets) / O(series) memory.
  - :class:`MetricsRegistry`: an ordered collection of families, exposed in
    one call (the ``/metrics`` body).
  - :func:`validate_exposition`: a promtool-style checker of a whole
    Prometheus text exposition.

``observability.py`` registers the serving families on one registry and
re-exports these types.
"""

from __future__ import annotations

import bisect
import threading

# Serving-latency bucket ladder: sub-millisecond (intra-chunk host work)
# through minutes (a long generation behind a queue). Upper bounds in
# seconds, strictly increasing; +Inf is implicit.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _fmt_float(v: float) -> str:
    """Prometheus sample value: shortest exact-enough decimal repr."""
    out = repr(float(v))
    return out


def _esc_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_esc_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Histogram:
    """One Prometheus histogram family: thread-safe ``observe`` plus text
    exposition with cumulative ``_bucket`` samples, ``_sum`` and ``_count``.

    Per-bucket counts are stored non-cumulative and summed at expose time, so
    ``observe`` is O(log buckets) (bisect) under a short lock. Labeled
    children share the family (one ``# TYPE`` line, samples grouped)."""

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram buckets must strictly increase: {buckets}")
        self.name = name
        self.help = help_text
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        # label-tuple -> [per-bucket counts..., +Inf count, sum, count]
        self._series: dict[tuple[tuple[str, str], ...], list] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        idx = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = [0] * (len(self.buckets) + 1) + [0.0, 0]
                self._series[key] = row
            row[idx] += 1
            row[-2] += float(value)
            row[-1] += 1

    def snapshot(self) -> dict:
        """{labels: {"buckets": cumulative counts, "sum": s, "count": n}}."""
        with self._lock:
            series = {k: list(v) for k, v in self._series.items()}
        out = {}
        for key, row in series.items():
            cum, total = [], 0
            for c in row[: len(self.buckets) + 1]:
                total += c
                cum.append(total)
            out[key] = {"buckets": cum, "sum": row[-2], "count": row[-1]}
        return out

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        snap = self.snapshot() or {(): {"buckets": [0] * (len(self.buckets) + 1),
                                        "sum": 0.0, "count": 0}}
        for key in sorted(snap):
            s = snap[key]
            bounds = [_fmt_float(b) for b in self.buckets] + ["+Inf"]
            for ub, c in zip(bounds, s["buckets"]):
                le = 'le="%s"' % ub
                lines.append(f"{self.name}_bucket{_fmt_labels(key, le)} {c}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_float(s['sum'])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {s['count']}")
        return lines


class Counter:
    """One Prometheus counter family: thread-safe monotonic ``inc`` plus
    exposition. ``inc`` accepts labels (``inc(stage="queue")``) — each
    distinct label set is its own series under the family's one ``# TYPE``
    line; label-less families expose a single bare sample.

    Process-wide like the registry's other families — engines sharing the
    process accumulate into one series (the per-engine breakdown lives in
    the ``quorum_tpu_engine_*`` block each engine's ``metrics()`` feeds)."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._series: dict[tuple[tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    @property
    def value(self) -> float:
        """Total across every labeled series (the label-less reading)."""
        with self._lock:
            return sum(self._series.values())

    def value_of(self, **labels: str) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            return self._series.get(key, 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            snap = dict(self._series) or {(): 0.0}
        for key in sorted(snap):
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_float(snap[key])}")
        return lines


class Gauge:
    """One Prometheus gauge: thread-safe ``set`` plus exposition.

    Process-wide last-writer-wins semantics (the scheduler threads of
    several engines share one family); fine for the depth-style gauges this
    registry carries — they describe "now", not an accumulation.

    ``set`` accepts labels (``set(3, stage="1")``) like :class:`Counter`'s
    ``inc`` — each distinct label set is its own last-writer-wins series
    under the family's one ``# TYPE`` line; label-less families keep their
    single bare sample."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._series: dict[tuple[tuple[str, str], ...], float] = {(): 0.0}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._series[key] = float(value)

    @property
    def value(self) -> float:
        """The label-less series (the pre-label reading); labeled series
        are read via :meth:`value_of`."""
        with self._lock:
            return self._series.get((), 0.0)

    def value_of(self, **labels: str) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            return self._series.get(key, 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            snap = dict(self._series)
        for key in sorted(snap):
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_float(snap[key])}")
        return lines


class MetricsRegistry:
    """Ordered collection of histogram/gauge families, one-call exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {}
        self._gauges: dict[str, Gauge] = {}
        self._counters: dict[str, Counter] = {}

    def histogram(self, name: str, help_text: str,
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = Histogram(name, help_text, buckets)
                self._hists[name] = h
            return h

    def gauge(self, name: str, help_text: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = Gauge(name, help_text)
                self._gauges[name] = g
            return g

    def counter(self, name: str, help_text: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = Counter(name, help_text)
                self._counters[name] = c
            return c

    def expose(self) -> list[str]:
        with self._lock:
            families = (list(self._hists.values())
                        + list(self._counters.values())
                        + list(self._gauges.values()))
        lines: list[str] = []
        for fam in families:
            lines.extend(fam.expose())
        return lines


# ---- exposition validation -------------------------------------------------

def validate_exposition(text: str) -> list[str]:
    """Promtool-style pure-Python check of a Prometheus text exposition.

    Returns a list of human-readable problems (empty = valid). Checks line
    grammar, one ``# TYPE`` line per family (samples grouped after it),
    numeric sample values, histogram bucket monotonicity, a ``+Inf`` bucket,
    and ``_count`` == the ``+Inf`` bucket per labeled series."""
    import re

    errors: list[str] = []
    typed: dict[str, str] = {}
    seen_sample_families: set[str] = set()
    # family -> labelkey -> {"buckets": [(le, v)...], "count": v, "sum": v}
    hist: dict[str, dict[str, dict]] = {}
    name_re = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)(\s+\S+)?$")
    label_re = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"$')

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed \
                    and typed[name[: -len(suffix)]] == "histogram":
                return name[: -len(suffix)]
        return name

    for n, raw in enumerate(text.splitlines(), 1):
        line = raw
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or not name_re.fullmatch(parts[2]) or \
                    parts[3] not in ("counter", "gauge", "histogram",
                                     "summary", "untyped"):
                errors.append(f"line {n}: malformed TYPE line: {raw!r}")
                continue
            fam = parts[2]
            if fam in typed:
                errors.append(f"line {n}: duplicate TYPE line for {fam}")
            if fam in seen_sample_families:
                errors.append(
                    f"line {n}: TYPE for {fam} appears after its samples")
            typed[fam] = parts[3]
            continue
        if line.startswith("#"):
            continue  # HELP / comments
        m = sample_re.match(line)
        if m is None:
            errors.append(f"line {n}: malformed sample line: {raw!r}")
            continue
        name, _, labelstr, value, _ = m.groups()
        labels: dict[str, str] = {}
        if labelstr:
            for part in _split_labels(labelstr):
                lm = label_re.match(part.strip())
                if lm is None:
                    errors.append(f"line {n}: malformed label {part!r}")
                    continue
                labels[lm.group(1)] = lm.group(2)
        try:
            val = float(value)
        except ValueError:
            errors.append(f"line {n}: non-numeric value {value!r}")
            continue
        fam = family_of(name)
        seen_sample_families.add(fam)
        if typed.get(fam) == "histogram":
            series = hist.setdefault(fam, {})
            key = ",".join(f"{k}={v}" for k, v in sorted(labels.items())
                           if k != "le")
            entry = series.setdefault(key, {"buckets": [], "count": None,
                                            "sum": None})
            if name.endswith("_bucket"):
                if "le" not in labels:
                    errors.append(f"line {n}: _bucket sample without le label")
                else:
                    le = (float("inf") if labels["le"] == "+Inf"
                          else float(labels["le"]))
                    entry["buckets"].append((le, val))
            elif name.endswith("_count"):
                entry["count"] = val
            elif name.endswith("_sum"):
                entry["sum"] = val
    for fam, series in hist.items():
        for key, entry in series.items():
            buckets = entry["buckets"]
            if not buckets:
                errors.append(f"{fam}{{{key}}}: histogram with no buckets")
                continue
            if buckets[-1][0] != float("inf"):
                errors.append(f"{fam}{{{key}}}: missing +Inf bucket")
            for (le1, v1), (le2, v2) in zip(buckets, buckets[1:]):
                if le2 <= le1:
                    errors.append(
                        f"{fam}{{{key}}}: bucket bounds not increasing "
                        f"({le1} -> {le2})")
                if v2 < v1:
                    errors.append(
                        f"{fam}{{{key}}}: bucket counts not monotonic "
                        f"(le={le1}:{v1} > le={le2}:{v2})")
            if entry["count"] is None:
                errors.append(f"{fam}{{{key}}}: missing _count sample")
            elif buckets and buckets[-1][0] == float("inf") \
                    and entry["count"] != buckets[-1][1]:
                errors.append(
                    f"{fam}{{{key}}}: _count {entry['count']} != +Inf "
                    f"bucket {buckets[-1][1]}")
            if entry["sum"] is None:
                errors.append(f"{fam}{{{key}}}: missing _sum sample")
    return errors


def _split_labels(labelstr: str) -> list[str]:
    """Split ``a="x",b="y,z"`` on commas outside quoted values."""
    parts, buf, in_q, esc = [], [], False, False
    for ch in labelstr:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
            continue
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return parts

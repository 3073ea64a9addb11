"""Metrics registry: Counter / Gauge / Histogram with labeled series.

The measurement substrate for the framework: executor compile/
cache counters, step-latency histograms, trainer throughput gauges and
bench rows all land here, so one exposition (Prometheus text or JSON)
describes a live process and a BENCH_r*.json alike.

Design notes
  * Prometheus data model (metric name + sorted label tuple -> series);
    exposition is pull-by-call here, served live by the HTTP endpoint
    in server.py (obs_http_port flag) and fleet-aggregated across
    workers by fleet.py.
  * `counter()/gauge()/histogram()` are get-or-create and idempotent, so
    every module can declare its metrics at import time without an
    ordering contract.
  * Recording is gated by the ``metrics`` flag (core/flags.py,
    ``PTPU_METRICS=0`` env): when off, inc/set/observe are no-ops and the
    hot paths pay one dict lookup.
  * Thread-safe: AsyncExecutor's feeder threads and reader processes may
    record concurrently; one registry lock covers series creation, and
    per-sample float ops ride the GIL.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import flags   # the metrics flag: core/flags.py


def enabled() -> bool:
    return bool(flags.get_flag("metrics"))


# -- histogram exemplars (request X-ray, observability/tracectx.py) ------
# A provider callable returns the ambient trace id (or None).  Injected
# by tracectx at import time rather than imported here: metrics is the
# bottom of the observability import graph and must stay cycle-free.
_exemplar_provider = None
_EXEMPLAR_RING = 4      # exemplars retained per bucket (newest kept)


def set_exemplar_provider(fn):
    """Register the ambient-trace-id source (tracectx.current_trace_id).
    When set, every Histogram.observe() that lands under an active
    trace records a (value, trace_id, time) exemplar on its bucket —
    the OpenMetrics-style link from a p99 bucket to a retrievable
    trace."""
    global _exemplar_provider
    _exemplar_provider = fn


def clear_exemplars():
    """Drop every exemplar ring in the registry (conftest: trace ids
    must not leak across tests; bucket counts are untouched)."""
    for m in REGISTRY.metrics():
        if m.buckets is None:
            continue
        with m._lock:
            for s in m._series.values():
                s.exemplars = None


# Latency-oriented default buckets (seconds): 50us .. 60s.
DEFAULT_BUCKETS = (
    5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Series:
    """State of one (metric, label-values) time series."""

    __slots__ = ("value", "sum", "count", "bucket_counts", "exemplars")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None):
        self.value = 0.0
        self.sum = 0.0
        self.count = 0
        self.bucket_counts = [0] * (len(buckets) + 1) if buckets else None
        # bucket index -> bounded newest-first list of exemplar dicts
        # ({value, trace_id, time_unix}); lazily created so the
        # no-tracing hot path pays nothing
        self.exemplars: Optional[Dict[int, List[dict]]] = None


class Metric:
    """Base: a named family of labeled series."""

    type = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self._series: Dict[Tuple[str, ...], _Series] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._series[()] = _Series(self.buckets)

    # -- series addressing -------------------------------------------------
    def labels(self, **labelvalues) -> "_Child":
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, _Series(self.buckets))
        return _Child(self, s)

    def _default(self) -> _Series:
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames}; "
                f"use .labels(...)")
        return self._series[()]

    # -- aggregate readers (tests / dashboards) ----------------------------
    def total(self) -> float:
        """Sum of all series values (histograms: sum of observations)."""
        if self.buckets is not None:
            return sum(s.sum for s in self._series.values())
        return sum(s.value for s in self._series.values())

    def total_count(self) -> int:
        """Histogram only: total observation count across series."""
        return sum(s.count for s in self._series.values())

    def series(self) -> Dict[Tuple[str, ...], _Series]:
        return dict(self._series)

    def reset(self):
        with self._lock:
            for key in list(self._series):
                self._series[key] = _Series(self.buckets)

    def clear(self):
        """Drop every labeled series (unlike reset(), which keeps the
        label keys at zero) — for bounded-cardinality publishers that
        re-publish a fresh top-K per sample (observability/tensorstats)
        and must not accumulate stale label values forever."""
        with self._lock:
            self._series = {}
            if not self.labelnames:
                self._series[()] = _Series(self.buckets)


class _Child:
    """One addressed series; exposes the metric-type verbs."""

    __slots__ = ("_metric", "_s")

    def __init__(self, metric: Metric, series: _Series):
        self._metric = metric
        self._s = series

    def inc(self, amount: float = 1.0):
        self._metric._inc(self._s, amount)

    def dec(self, amount: float = 1.0):
        self._metric._inc(self._s, -amount)

    def set(self, value: float):
        self._metric._set(self._s, value)

    def observe(self, value: float):
        self._metric._observe(self._s, value)

    @property
    def value(self) -> float:
        return self._s.value

    @property
    def count(self) -> int:
        return self._s.count

    @property
    def sum(self) -> float:
        return self._s.sum


class Counter(Metric):
    """Monotonically increasing count (compiles, cache hits, steps)."""

    type = "counter"

    def inc(self, amount: float = 1.0):
        self._inc(self._default(), amount)

    def _inc(self, s: _Series, amount: float):
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        if enabled():
            s.value += amount

    def _set(self, s, value):
        raise TypeError(f"counter {self.name!r} does not support set()")

    _observe = _set

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(Metric):
    """Point-in-time value (throughput, loss EMA, memory watermark)."""

    type = "gauge"

    def set(self, value: float):
        self._set(self._default(), value)

    def inc(self, amount: float = 1.0):
        self._inc(self._default(), amount)

    def dec(self, amount: float = 1.0):
        self._inc(self._default(), -amount)

    def _set(self, s: _Series, value: float):
        if enabled():
            s.value = float(value)

    def _inc(self, s: _Series, amount: float):
        if enabled():
            s.value += amount

    def _observe(self, s, value):
        raise TypeError(f"gauge {self.name!r} does not support observe()")

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(Metric):
    """Distribution with cumulative buckets (latencies)."""

    type = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames,
                         buckets=tuple(buckets or DEFAULT_BUCKETS))

    def observe(self, value: float):
        self._observe(self._default(), value)

    def time(self):
        """``with hist.time(): ...`` observes the block's wall time."""
        return _Timer(self._default_child())

    def _default_child(self) -> _Child:
        return _Child(self, self._default())

    def _observe(self, s: _Series, value: float):
        if not enabled():
            return
        value = float(value)
        s.sum += value
        s.count += 1
        idx = len(self.buckets)         # overflow (+Inf) bucket
        for i, b in enumerate(self.buckets):
            if value <= b:
                idx = i
                break
        s.bucket_counts[idx] += 1
        if _exemplar_provider is not None:
            tid = _exemplar_provider()
            if tid is not None:
                self._note_exemplar(s, idx, value, tid)

    def _note_exemplar(self, s: _Series, idx: int, value: float,
                       trace_id: str):
        ex = {"value": value, "trace_id": trace_id,
              "time_unix": time.time()}
        with self._lock:
            if s.exemplars is None:
                s.exemplars = {}
            ring = s.exemplars.setdefault(idx, [])
            ring.insert(0, ex)
            del ring[_EXEMPLAR_RING:]

    def _set(self, s, value):
        raise TypeError(f"histogram {self.name!r} does not support set()")

    _inc = _set

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum


class _Timer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: _Child):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Name -> Metric store with Prometheus-text and JSON exposition."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (type(existing) is not type(metric)
                        or existing.labelnames != metric.labelnames):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{existing.type}{existing.labelnames}")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        return sorted(self._metrics.values(), key=lambda m: m.name)

    def reset(self):
        """Zero every series (keep registrations) — tests and bench."""
        for m in self.metrics():
            m.reset()

    # -- exposition --------------------------------------------------------
    def prometheus_text(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (rendered from the same JSON
        document to_json() emits, by the ONE renderer the fleet-merged
        exposition also uses — see render_prometheus).
        ``exemplars=True`` appends OpenMetrics exemplar clauses to
        histogram bucket lines — ONLY valid when served as
        ``application/openmetrics-text`` (a v0.0.4 parser rejects a
        mid-line ``#``); the HTTP endpoint content-negotiates."""
        return render_prometheus(self.to_json(), exemplars=exemplars)

    def to_json(self) -> dict:
        """One JSON document for the whole registry — the schema shared
        with bench.py's metrics dump."""
        out = {}
        for m in self.metrics():
            series = []
            for key, s in sorted(m.series().items()):
                row: dict = {"labels": dict(zip(m.labelnames, key))}
                if m.type == "histogram":
                    row.update(sum=s.sum, count=s.count,
                               buckets={_fmt(b): c for b, c in
                                        zip(m.buckets, s.bucket_counts)},
                               overflow=s.bucket_counts[-1])
                    if s.exemplars:
                        # newest exemplar per bucket, keyed by the
                        # bucket's upper bound ("+Inf" for overflow) —
                        # the /metrics.json hook from a p99 bucket to
                        # a GET /trace/<id> waterfall
                        row["exemplars"] = {
                            (_fmt(m.buckets[i]) if i < len(m.buckets)
                             else "+Inf"): ring[0]
                            for i, ring in sorted(s.exemplars.items())
                            if ring}
                else:
                    row["value"] = s.value
                series.append(row)
            out[m.name] = {"type": m.type, "help": m.help,
                           "series": series}
        return {"schema": "paddle_tpu.metrics.v1", "metrics": out}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)


def render_prometheus(doc: dict, exemplars: bool = False) -> str:
    """Prometheus text for a ``paddle_tpu.metrics.v1`` JSON document —
    the single exposition renderer.  Both the live registry
    (:meth:`MetricsRegistry.prometheus_text`) and the fleet-merged view
    (observability/fleet.py) delegate here, so an exposition fix (e.g.
    escaping) can never diverge the two.

    ``exemplars=False`` (default) is strict v0.0.4: no exemplar
    clauses, because a mid-line ``#`` is a PARSE ERROR there (only a
    line-initial ``#`` is a comment) and one traced observation would
    fail the whole scrape.  ``exemplars=True`` appends OpenMetrics
    exemplar clauses — serve that variant only under the
    ``application/openmetrics-text`` content type (server.py
    content-negotiates on the Accept header)."""
    lines: List[str] = []
    metrics_map = doc.get("metrics", {})
    for name in sorted(metrics_map):
        m = metrics_map[name]
        mtype = m.get("type", "untyped")
        lines.append(f"# HELP {name} {_escape_help(m.get('help', ''))}")
        lines.append(f"# TYPE {name} {mtype}")
        for row in m.get("series", []):
            labels = row.get("labels") or {}
            if mtype == "histogram":
                cum = 0
                buckets = row.get("buckets") or {}
                exem = (row.get("exemplars") or {}) if exemplars else {}
                for b in sorted(buckets, key=float):
                    cum += buckets[b]
                    lines.append(_sample(f"{name}_bucket",
                                         {**labels, "le": _fmt(float(b))},
                                         cum)
                                 + _exemplar_suffix(
                                     exem.get(_fmt(float(b)))))
                cum += row.get("overflow", 0)
                lines.append(_sample(f"{name}_bucket",
                                     {**labels, "le": "+Inf"}, cum)
                             + _exemplar_suffix(exem.get("+Inf")))
                lines.append(_sample(f"{name}_sum", labels,
                                     row.get("sum", 0.0)))
                lines.append(_sample(f"{name}_count", labels,
                                     row.get("count", 0)))
            else:
                suffix = "_total" if (mtype == "counter" and
                                      not name.endswith("_total")) else ""
                lines.append(_sample(name + suffix, labels,
                                     row.get("value", 0.0)))
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(float(v))


def _exemplar_suffix(ex: Optional[dict]) -> str:
    """OpenMetrics exemplar clause for one bucket sample line:
    `` # {trace_id="<id>"} <value> <ts>``.  Pure-comment syntax to a
    v0.0.4 scraper, a real exemplar to an OpenMetrics one."""
    if not ex:
        return ""
    return (f' # {{trace_id="{_escape(str(ex.get("trace_id", "")))}"}} '
            f'{ex.get("value", 0.0)} {ex.get("time_unix", 0.0)}')


def _sample(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape(str(v))}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def _escape(s: str) -> str:
    """Label-value escaping per the Prometheus text exposition format:
    backslash, double-quote and line-feed."""
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(s: str) -> str:
    """HELP-line escaping: backslash and line-feed only (a raw newline
    would terminate the comment mid-text and corrupt the scrape)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


REGISTRY = MetricsRegistry()


# -- histogram quantiles ----------------------------------------------------
# Promoted out of serving/__init__.py (which re-exports for compat): the
# alert engine needs quantile predicates over any histogram — including
# rows of a FLEET-MERGED document — without importing the serving plane.

def histogram_row_quantiles(row: dict, qs: Sequence[float]
                            ) -> Optional[dict]:
    """Bucket-interpolated quantiles for ONE histogram series row in
    the ``paddle_tpu.metrics.v1`` JSON schema (``buckets`` map +
    ``overflow``/``count``/``sum``) — works on the local registry's
    to_json() rows and on fleet-merged rows alike.  Returns None when
    the row has no observations."""
    count = int(row.get("count", 0))
    if count <= 0:
        return None
    bounds = sorted((float(b), int(c))
                    for b, c in (row.get("buckets") or {}).items())
    out = {}
    for q in qs:
        target = q * count
        cum = 0
        val = None
        for b, c in bounds:
            cum += c
            if cum >= target:
                val = b
                break
        if val is None:              # landed in the overflow bucket
            val = bounds[-1][0] if bounds else 0.0
        out[f"p{int(round(q * 100))}"] = val
    out["count"] = count
    out["mean"] = float(row.get("sum", 0.0)) / count
    return out


def histogram_quantiles(name: str, qs: Sequence[float]
                        ) -> Optional[dict]:
    """Bucket-interpolated quantiles of a registry histogram's
    unlabeled series (the p50/p99 the /serving route reports) — one
    interpolation implementation, shared with the doc-row path.
    Returns None when the histogram has no observations."""
    m = REGISTRY.get(name)
    if m is None or m.buckets is None:
        return None
    s = m._series.get(())
    if s is None or s.count == 0:
        return None
    return histogram_row_quantiles(
        {"buckets": dict(zip(m.buckets, s.bucket_counts)),
         "count": s.count, "sum": s.sum}, qs)


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.register(Counter(name, help, labelnames))


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.register(Gauge(name, help, labelnames))


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Iterable[float]] = None) -> Histogram:
    return REGISTRY.register(Histogram(name, help, labelnames, buckets))

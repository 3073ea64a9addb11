"""Request X-ray: W3C-style trace context + per-request span store.

The observability planes so far answer aggregate
questions — "what is p99 TTFT", "how often do we recompile".  This
module answers the operator's most common one: *why was THIS request
(or THIS training step) slow?*  It provides:

* Trace identity: 128-bit ``trace_id`` / 64-bit ``span_id`` hex ids and
  ``traceparent`` parsing/formatting per the W3C Trace Context header
  (``00-<trace_id>-<span_id>-<flags>``), so an upstream proxy's trace
  ids flow through ``POST /serving/generate`` into every span this
  process stamps — and back out in the response.
* Ambient context: a ``contextvars``-based current span.  ``span()``
  opens a child of the active context; code deep in the stack (the
  executor's compile path, forensics, chaos) asks :func:`current_trace`
  with no plumbing.  Worker threads that service a request activate its
  context explicitly (serving/batcher.py does).
* The span store: a bounded per-trace dict of finished spans
  (``start_unix``/``start_perf``/``dur``/``parent_id``/attrs), with a
  generation counter and cursor reads so the FleetReporter ships new
  spans incrementally (at-least-once; the aggregator dedupes by
  ``span_id``).  ``waterfall()`` assembles one trace's spans into the
  ``paddle_tpu.xray.v1`` document ``GET /trace/<id>`` serves and the
  ``python -m paddle_tpu_torch.observability.xray`` CLI renders.
* Flight-style capture: :func:`capture` freezes a trace's assembled
  waterfall plus a small metrics excerpt under its trace id (bounded
  ring) — the batcher calls it when a request breaches the
  ``serving_p99_budget_ms`` SLO, so the evidence survives even after
  the span store evicts the trace.

Gated by the ``request_tracing`` flag: when off, ``span()`` is a
zero-allocation no-op context, no ids are minted and nothing is stored
— compile keys, explain() reports and step outputs are byte-identical
to a build without this module (the flag-off idiom, tier-1
tested).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..core import flags
from . import metrics as obs_metrics

# the request_tracing flag is declared in core/flags.py


SCHEMA = "paddle_tpu.xray.v1"
TRACEPARENT_VERSION = "00"

_MAX_TRACES = 512          # traces retained (oldest evicted)
_MAX_SPANS_PER_TRACE = 512  # spans per trace (excess dropped, counted)
_MAX_CAPTURES = 16         # SLO-breach capture bundles retained

_m_spans = obs_metrics.counter(
    "xray_spans_total", "X-ray spans recorded into the local store.")
_m_dropped = obs_metrics.counter(
    "xray_spans_dropped_total",
    "X-ray spans dropped by the per-trace bound.")
_m_captures = obs_metrics.counter(
    "xray_captures_total",
    "SLO-breach trace captures (flight-style bundles keyed by trace "
    "id).", ("reason",))

_lock = threading.Lock()
# trace_id -> list of finished span dicts, insertion-ordered per trace
_traces: Dict[str, List[dict]] = {}
_span_log: List[dict] = []      # flat append-order log (fleet cursor)
_log_base = 0                   # absolute index of _span_log[0]: the
#                                 log trims from the front, so cursors
#                                 are ABSOLUTE positions, not list
#                                 indices (a trim must not shift them)
_generation = 0
_captures: Dict[str, dict] = {}
_capture_seq = 0                # bumped per capture(): the fleet
#                                 reporter's ship-on-change watermark
_rank = 0                       # stamped on every span (fleet identity)


def enabled() -> bool:
    return bool(flags.get_flag("request_tracing"))


def set_rank(rank: int):
    """Identity stamped on locally-recorded spans (the supervisor's
    PTPU elastic workers call this; 0 is the single-process default)."""
    global _rank
    _rank = int(rank)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """One position in a trace: (trace_id, span_id) plus sampled flag.
    Immutable; children are derived via :func:`span`."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: str = "01"):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def traceparent(self) -> str:
        return (f"{TRACEPARENT_VERSION}-{self.trace_id}-"
                f"{self.span_id}-{self.flags}")

    def __repr__(self):
        return f"TraceContext({self.traceparent()})"


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """W3C ``traceparent`` -> TraceContext; None on anything malformed
    (a bad header must never 500 the request — we just mint fresh)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, fl = parts
    if len(tid) != 32 or len(sid) != 16 or len(ver) != 2:
        return None
    try:
        int(tid, 16), int(sid, 16), int(ver, 16), int(fl, 16)
    except ValueError:
        return None
    if set(tid) == {"0"} or set(sid) == {"0"}:
        return None                     # all-zero ids are invalid per spec
    return TraceContext(tid, sid, fl or "01")


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("ptpu_trace_ctx", default=None)


def current() -> Optional[TraceContext]:
    """The ambient trace context, or None (tracing off OR no active
    trace)."""
    if not enabled():
        return None
    return _current.get()


def current_trace_id() -> Optional[str]:
    ctx = current()
    return ctx.trace_id if ctx is not None else None


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Make `ctx` the ambient context for the with-block (worker
    threads servicing a request; the RPC handler).  None = no-op."""
    if ctx is None or not enabled():
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def start_trace(name: str,
                parent: Optional[TraceContext] = None
                ) -> Optional[TraceContext]:
    """Mint trace identity: a fresh trace, or — when `parent` carries
    upstream identity (a traceparent header, an ambient step trace) —
    a child position in that trace (same trace_id, new span_id).
    Identity only: the root SPAN is recorded by whoever owns the
    request lifecycle (batcher ``_finish``, trainer
    ``_record_step_spans``) once its duration is known; ``name`` is
    call-site documentation.  None when tracing is off."""
    if not enabled():
        return None
    if parent is not None:
        return TraceContext(parent.trace_id, new_span_id(), parent.flags)
    return TraceContext(new_trace_id(), new_span_id())


@contextlib.contextmanager
def span(name: str, kind: str = "internal",
         ctx: Optional[TraceContext] = None, **attrs):
    """Record one timed span under the ambient (or given) context.
    Yields the child TraceContext (None when tracing is off or no
    context is active: spans never mint orphan traces by themselves)."""
    parent = ctx if ctx is not None else current()
    if parent is None or not enabled():
        yield None
        return
    child = TraceContext(parent.trace_id, new_span_id(), parent.flags)
    t_unix = time.time()
    t0 = time.perf_counter()
    token = _current.set(child)
    try:
        yield child
    finally:
        _current.reset(token)
        record_span(name, parent.trace_id, child.span_id,
                    parent.span_id, t_unix, t0,
                    time.perf_counter() - t0, kind=kind, attrs=attrs)


def record_span(name: str, trace_id: str, span_id: str,
                parent_id: Optional[str], start_unix: float,
                start_perf: float, dur: float, kind: str = "internal",
                attrs: Optional[Dict[str, Any]] = None):
    """Append one finished span to the store (also the path for spans
    timed outside a with-block, e.g. the batcher's queue-wait)."""
    if not enabled():
        return
    ev = {"name": str(name), "trace_id": trace_id, "span_id": span_id,
          "parent_id": parent_id, "kind": kind, "rank": _rank,
          "start_unix": float(start_unix),
          "start_perf": float(start_perf), "dur": float(dur)}
    if attrs:
        ev["attrs"] = {str(k)[:60]: _safe_attr(v)
                       for k, v in list(attrs.items())[:16]}
    with _lock:
        spans = _traces.get(trace_id)
        if spans is None:
            while len(_traces) >= _MAX_TRACES:
                evicted = next(iter(_traces))
                _traces.pop(evicted)
            spans = _traces[trace_id] = []
        if len(spans) >= _MAX_SPANS_PER_TRACE:
            _m_dropped.inc()
            return
        spans.append(ev)
        _span_log.append(ev)
        # the flat log is a delivery cursor, not an archive: keep it
        # bounded by the same budget the per-trace store implies.  The
        # base offset advances with the trim so outstanding cursors
        # (absolute positions) stay valid — a reporter slower than the
        # trim loses the trimmed window, it does not resend/skip
        # arbitrary spans
        if len(_span_log) > _MAX_TRACES * 64:
            global _log_base
            cut = len(_span_log) // 2
            _log_base += cut
            del _span_log[:cut]
    _m_spans.inc()


def instant(name: str, kind: str = "marker", **attrs):
    """Zero-duration marker under the ambient context (retire events,
    recompile markers)."""
    ctx = current()
    if ctx is None:
        return
    record_span(name, ctx.trace_id, new_span_id(), ctx.span_id,
                time.time(), time.perf_counter(), 0.0, kind=kind,
                attrs=attrs or None)


def _safe_attr(v: Any):
    if isinstance(v, (int, float, bool)) or v is None:
        return v
    if isinstance(v, str):
        return v[:200]
    return repr(v)[:200]


# -- store reads -----------------------------------------------------------

def spans_for(trace_id: str) -> List[dict]:
    with _lock:
        return list(_traces.get(trace_id, ()))


def trace_ids() -> List[str]:
    with _lock:
        return list(_traces)


def generation() -> int:
    return _generation


def spans_since(cursor: int, gen: Optional[int] = None):
    """Atomic (generation, absolute length, tail) read for the
    FleetReporter — same contract as trace.events_since: a generation
    mismatch means reset() wiped the log, so the whole buffer returns.
    Cursors are ABSOLUTE append positions (the log trims from the
    front; ``_log_base`` keeps them stable across trims)."""
    with _lock:
        g = _generation
        start_abs = cursor if gen == g else 0
        idx = max(0, min(start_abs - _log_base, len(_span_log)))
        return g, _log_base + len(_span_log), _span_log[idx:]


def ingest_span(ev: dict):
    """Store an externally-produced span dict verbatim (the aggregator
    path uses its own store; this one is for single-process tooling /
    tests).  Dedupes by span_id within the trace."""
    with _lock:
        spans = _traces.setdefault(ev["trace_id"], [])
        if any(s["span_id"] == ev.get("span_id") for s in spans):
            return
        spans.append(dict(ev))


def reset():
    """Test hook (conftest): wipe traces, captures and the span log;
    bump the generation so cursor consumers resync."""
    global _generation, _log_base
    with _lock:
        _traces.clear()
        _span_log.clear()
        _captures.clear()
        _log_base = 0
        _generation += 1


# -- waterfall assembly ----------------------------------------------------

def build_waterfall(trace_id: str, spans: List[dict],
                    capture: Optional[dict] = None) -> dict:
    """Assemble one trace's spans into the ``paddle_tpu.xray.v1``
    waterfall document: spans sorted by start, offsets relative to the
    trace origin, parent links preserved, per-span rank attribution.
    Works on locally-recorded spans AND on the aggregator's
    clock-normalized fleet spans — the caller supplies them."""
    spans = sorted(spans, key=lambda s: s["start_unix"])
    t0 = spans[0]["start_unix"] if spans else 0.0
    end = max((s["start_unix"] + s["dur"] for s in spans), default=t0)
    ids = {s["span_id"] for s in spans}
    out = []
    for s in spans:
        row = {k: s[k] for k in ("name", "span_id", "kind", "rank",
                                 "dur") if k in s}
        row["offset_s"] = round(s["start_unix"] - t0, 6)
        row["start_unix"] = s["start_unix"]
        parent = s.get("parent_id")
        # a parent outside the collected set (the client's upstream
        # span, or an evicted sibling) renders at top level but keeps
        # the id so nothing silently pretends to be a root
        row["parent_id"] = parent
        row["orphan"] = bool(parent) and parent not in ids
        if s.get("attrs"):
            row["attrs"] = s["attrs"]
        out.append(row)
    doc = {"schema": SCHEMA, "trace_id": trace_id,
           "span_count": len(out), "duration_s": round(end - t0, 6),
           "start_unix": t0, "spans": out}
    if capture is not None:
        doc["capture"] = capture
    return doc


def waterfall(trace_id: str) -> Optional[dict]:
    """The local store's assembled waterfall for one trace (what
    ``GET /trace/<id>`` serves on a worker without an aggregator);
    None when the trace is unknown AND uncaptured."""
    spans = spans_for(trace_id)
    cap = _captures.get(trace_id)
    if not spans and cap is None:
        return None
    if not spans and cap is not None:
        return cap.get("waterfall") or build_waterfall(trace_id, [],
                                                       capture=cap)
    return build_waterfall(trace_id, spans,
                           capture=None if cap is None else
                           {k: v for k, v in cap.items()
                            if k != "waterfall"})


# -- SLO-breach capture ----------------------------------------------------

def capture(trace_id: str, reason: str, **detail) -> Optional[dict]:
    """Freeze a flight-style mini-bundle for one trace: its assembled
    waterfall plus the triggering detail and a timestamp, retrievable
    via ``GET /trace/<id>`` even after span-store eviction.  Bounded
    ring (oldest evicted); one capture per trace id."""
    if not enabled():
        return None
    doc = {"reason": str(reason), "time_unix": time.time(),
           "detail": {k: _safe_attr(v) for k, v in detail.items()},
           "waterfall": build_waterfall(trace_id, spans_for(trace_id))}
    global _capture_seq
    with _lock:
        if trace_id not in _captures:
            while len(_captures) >= _MAX_CAPTURES:
                _captures.pop(next(iter(_captures)))
        _captures[trace_id] = doc
        _capture_seq += 1
    _m_captures.labels(reason=str(reason)).inc()
    from . import flight as obs_flight
    obs_flight.record("xray", "capture", trace_id=trace_id,
                      reason=reason, **detail)
    return doc


def captures() -> Dict[str, dict]:
    with _lock:
        return dict(_captures)


def capture_seq() -> int:
    """Monotonic capture counter — the FleetReporter ships the capture
    dict to the coordinator whenever this moved since its last flush
    (so a worker's SLO-breach evidence is retrievable at the
    coordinator's GET /trace/<id>, not just locally)."""
    return _capture_seq


# Histogram exemplars: every observe() under an active trace records a
# (value, trace_id) exemplar on its bucket (metrics.py keeps the ring;
# registered here so metrics stays import-cycle-free).
obs_metrics.set_exemplar_provider(current_trace_id)

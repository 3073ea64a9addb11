"""Crash flight recorder: an always-on bounded ring of recent events
dumped as ONE JSON diagnostic bundle when something goes wrong.

Production training failures are post-mortem puzzles: the NaN that
tripped the guard, the retry budget that ran dry, the SIGTERM that
landed mid-epoch — by the time a human looks, the process state is
gone.  This module keeps a cheap ring buffer (``flight_recorder_events``
entries) of recent spans, compile/chaos/guard/retry events and metric
deltas, and on a trip writes a single self-contained bundle:

* the event ring (what just happened, in order)
* a full metrics-registry snapshot + counter deltas since the last dump
* the full flag state

The reference's bundle also carries per-program cost summaries
(costmodel.py), the diagnosed compile log (forensics.py) and the last
tensorstats snapshot.  Those three modules are not ported yet (ROADMAP
queue A.9), so this bundle leaves their sections out rather than fill
them with empty stand-ins.

Dump triggers (wired in trainer.py / resilience/):
NumericGuard trips, circuit-breaker opens, retry exhaustion, preemption,
and uncaught trainer exceptions.  ``flight_recorder_path`` names the
file; when empty the bundle is still built and held in memory
(:func:`last_bundle`) so tests and REPLs can inspect it without a
filesystem side effect.  Recording is O(1) dict appends — always on.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..core import flags
from . import metrics as obs_metrics

_MAX_BUNDLE_BYTES = 1 << 20      # hard bundle bound: 1 MiB

_lock = threading.Lock()
_ring: deque = deque(maxlen=256)
_ring_cap = 256
_last_bundle: Optional[dict] = None
_last_counter_snapshot: Dict[str, float] = {}
_dumps = 0


def _capacity() -> int:
    try:
        return int(flags.get_flag("flight_recorder_events"))
    except Exception:
        return 256


def record(kind: str, name: str, **data: Any):
    """Append one event to the ring.  Cheap and always-on; capacity 0
    disables recording."""
    global _ring, _ring_cap
    cap = _capacity()
    if cap <= 0:
        return
    ev = {"ts": time.time(), "kind": kind, "name": name}
    if data:
        ev["data"] = {k: _safe(v) for k, v in data.items()}
    with _lock:
        if cap != _ring_cap:
            _ring = deque(_ring, maxlen=cap)
            _ring_cap = cap
        _ring.append(ev)


def _safe(v: Any):
    """JSON-safe, size-bounded event payload value.  Non-finite floats
    become strings: the flagship trigger IS a NaN loss, and a bare
    ``NaN`` token would make the whole bundle invalid strict JSON."""
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, (int, bool)) or v is None:
        return v
    if isinstance(v, str):
        return v[:300]
    if isinstance(v, (list, tuple)):
        return [_safe(x) for x in list(v)[:20]]
    if isinstance(v, dict):
        return {str(k)[:80]: _safe(x) for k, x in list(v.items())[:20]}
    return repr(v)[:300]


def _strict_json(doc: Any):
    """Deep-copy `doc` with every non-finite float stringified, so the
    bundle always serializes under ``allow_nan=False`` (metric gauges
    may legitimately hold NaN/Inf — e.g. a poisoned bench loss)."""
    if isinstance(doc, float):
        return doc if math.isfinite(doc) else repr(doc)
    if isinstance(doc, dict):
        return {k: _strict_json(v) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [_strict_json(v) for v in doc]
    return doc


def events() -> List[dict]:
    with _lock:
        return list(_ring)


def reset():
    global _last_bundle, _last_counter_snapshot, _dumps
    with _lock:
        _ring.clear()
        _last_bundle = None
        _last_counter_snapshot = {}
        _dumps = 0


def last_bundle() -> Optional[dict]:
    """The most recently built bundle (also what the last dump wrote)."""
    return _last_bundle


def dump_count() -> int:
    return _dumps


def _counter_totals() -> Dict[str, float]:
    out = {}
    for m in obs_metrics.REGISTRY.metrics():
        if m.type == "counter":
            out[m.name] = m.total()
    return out


def bundle(reason: str, extra: Optional[dict] = None,
           advance_baseline: bool = True) -> dict:
    """Build the diagnostic bundle (no file I/O).  The counter-delta
    baseline advances here, under the lock: concurrent dumps each get a
    consistent window, and even when a later file write fails the
    window's deltas survive in :func:`last_bundle`.
    ``advance_baseline=False`` is for pure observers (the /flight HTTP
    route): they must not shrink the delta window of the next REAL
    crash dump."""
    global _last_counter_snapshot
    totals = _counter_totals()
    with _lock:
        prev = _last_counter_snapshot
        if advance_baseline:
            _last_counter_snapshot = totals
    deltas = {k: v - prev.get(k, 0.0) for k, v in totals.items()
              if v - prev.get(k, 0.0) != 0.0}
    # program_costs, compile_log and tensor_stats wait for costmodel,
    # forensics and tensorstats (ROADMAP queue A.9)
    doc = {
        "schema": "paddle_tpu.flight.v1",
        "reason": reason,
        "time_unix": time.time(),
        "flags": {k: _safe(v) for k, v in flags.all_flags().items()},
        "events": events(),
        "counter_deltas": deltas,
        "metrics": obs_metrics.REGISTRY.to_json(),
    }
    if extra:
        doc["extra"] = {k: _safe(v) for k, v in extra.items()}
    doc = _strict_json(doc)
    # hard size bound: the bundle must stay shippable (one log line /
    # one blob upload); the full registry is the first thing to go,
    # then the event ring shrinks
    if len(json.dumps(doc)) > _MAX_BUNDLE_BYTES:
        doc["metrics"] = {"truncated": True}
        if len(json.dumps(doc)) > _MAX_BUNDLE_BYTES:
            doc["events"] = doc["events"][-32:]
            doc["truncated_events"] = True
    return doc


def dump(reason: str, extra: Optional[dict] = None,
         path: Optional[str] = None) -> Optional[str]:
    """Build the bundle, remember it, and write it to
    ``flight_recorder_path`` (or `path`) when one is configured.
    Returns the written path, or None for in-memory-only.  Never raises:
    the recorder must not mask the failure it is documenting."""
    global _last_bundle, _dumps
    try:
        doc = bundle(reason, extra)
    except Exception:
        return None
    with _lock:
        _last_bundle = doc
        _dumps += 1
    record("flight", "dump", reason=reason)
    target = path or str(flags.get_flag("flight_recorder_path") or "")
    if not target:
        return None
    try:
        with open(target, "w") as f:
            json.dump(doc, f, allow_nan=False)   # bundle() stringified
        return target                            # every non-finite float
    except (OSError, ValueError):
        return None

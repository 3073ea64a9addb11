"""Timecard: chip-time accounting, the live plane the serving batcher feeds.

Counterpart of paddle_tpu/observability/goodput.py.  A per-rank wall-clock
**state machine** partitions the process's tracked time into monotonic,
non-overlapping segments drawn from a closed state catalog:

  compute | input_wait | compile | checkpoint_save | checkpoint_restore
  | resize_barrier | restart_gap | drain | idle

The port's one feeder is the serving batcher's drain boundary
(:func:`note_drain_begin` / :func:`note_drain_end`), charged through
:func:`note_span`; a gap between charged spans is idle.  The accounting
clock only moves forward and every charge advances it, so segments never
overlap and their sum is the tracked wall time.

Surfaces: ``chip_seconds_total{state}``, ``goodput_fraction`` and
``badput_fraction`` on the registry and :func:`snapshot`; with a journal
configured, each closed segment is journaled as a ``goodput``/``segment``
event in the reference's schema, so the reference's offline
reconstructor reads the port's journals.

Not ported: the trainer and elastic-worker seams (``note_step``,
``note_wait``), the journaled per-rank finals, the fleet rows, the alert
context, the status document, the offline reconstructor and its CLI.
They come with the callers that need them (ROADMAP queue A.9).

Everything is gated on the ``goodput`` flag: off, no boundary does any
work beyond one flag read.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..core import flags
from . import journal as obs_journal
from . import metrics as obs_metrics

# the closed state catalog; compute is the only goodput state
STATES = ("compute", "input_wait", "compile", "checkpoint_save",
          "checkpoint_restore", "resize_barrier", "restart_gap",
          "drain", "idle")
GOOD_STATE = "compute"

# --- registry metrics ------------------------------------------------------
_m_chip = obs_metrics.counter(
    "chip_seconds_total",
    "Accounted chip-seconds per Timecard state (compute|input_wait|"
    "compile|checkpoint_save|checkpoint_restore|resize_barrier|"
    "restart_gap|drain|idle).  Per-rank segments are non-overlapping "
    "and sum to the rank's tracked wall time (the conservation "
    "invariant).", ("state",))
_m_fraction = obs_metrics.gauge(
    "goodput_fraction",
    "compute chip-seconds / total tracked chip-seconds of this rank.")
# the complement: a labelless gauge always exposes a 0.0 default series,
# so an alert on low goodput_fraction would fire on a rank that has not
# tracked any chip-time yet; badput_fraction starts at the safe end
_m_badput = obs_metrics.gauge(
    "badput_fraction",
    "1 - goodput_fraction once chip-time is tracked (0 before).")

# durations below this are noise, not segments (clock granularity)
_EPS = 1e-9
# timeline ring bound: merging makes transitions rare, but a pathological
# alternation must not grow without bound
_SEG_MAX = 4096

_lock = threading.RLock()
_t0_unix: Optional[float] = None
_t0_perf: Optional[float] = None
_last_perf: Optional[float] = None
_accum: Dict[str, float] = {}
_segments: List[dict] = []          # closed segments (merged)
_cur: Optional[dict] = None         # open segment {state, start_unix, dur}
_drain_start: Optional[float] = None


def enabled() -> bool:
    return bool(flags.get_flag("goodput"))


# --- the state machine -----------------------------------------------------

def _ensure_started_locked(now_perf: float):
    global _t0_unix, _t0_perf, _last_perf
    if _t0_perf is None:
        _t0_perf = _last_perf = now_perf
        _t0_unix = time.time() - (time.perf_counter() - now_perf)


def _close_cur_locked():
    """Close the open segment: move it to the ring and (journal on)
    emit it — the offline reconstructor's per-rank timeline source."""
    global _cur
    if _cur is None or _cur["dur"] <= _EPS:
        _cur = None
        return
    seg = {"state": _cur["state"],
           "start_unix": round(_cur["start_unix"], 6),
           "dur": round(_cur["dur"], 6)}
    _segments.append(seg)
    if len(_segments) > _SEG_MAX:
        del _segments[:_SEG_MAX // 2]
    _cur = None
    obs_journal.emit("goodput", "segment", state=seg["state"],
                     seg_start_unix=seg["start_unix"], dur=seg["dur"])


def _charge_locked(state: str, start_perf: float, dur: float):
    """Book ``dur`` seconds of ``state`` starting at ``start_perf``.
    Callers guarantee start_perf >= _last_perf (monotonic)."""
    global _cur, _last_perf
    if dur <= _EPS:
        return
    _accum[state] = _accum.get(state, 0.0) + dur
    _m_chip.labels(state=state).inc(dur)
    start_unix = _t0_unix + (start_perf - _t0_perf)
    if _cur is not None and _cur["state"] == state:
        _cur["dur"] = (start_perf + dur) - _cur["_start_perf"]
    else:
        _close_cur_locked()
        _cur = {"state": state, "start_unix": start_unix,
                "_start_perf": start_perf, "dur": dur}
    _last_perf = max(_last_perf, start_perf + dur)
    total = sum(_accum.values())
    if total > _EPS:
        frac = _accum.get(GOOD_STATE, 0.0) / total
        _m_fraction.set(frac)
        _m_badput.set(1.0 - frac)


def note_span(state: str, seconds: float):
    """Charge a span that just ENDED with a caller-measured duration
    (compile spans, checkpoint save/restore).  The span is clipped to
    the unclaimed interval — time already booked is never re-booked —
    and any gap between the last boundary and the span start is idle."""
    if not enabled():
        return
    now = time.perf_counter()
    seconds = max(0.0, float(seconds))
    with _lock:
        # first-ever charge: start the clock at the span START so the
        # span itself is inside the tracked window
        _ensure_started_locked(now - seconds)
        start = max(_last_perf, now - seconds)
        gap = start - _last_perf
        if gap > _EPS:
            _charge_locked("idle", _last_perf, gap)
        _charge_locked(state, start, now - start)


def note_drain_begin():
    """Serving drain started (batcher.begin_drain — already journals
    here); the matching note_drain_end charges the span."""
    if not enabled():
        return
    global _drain_start
    with _lock:
        _drain_start = time.perf_counter()


def note_drain_end():
    if not enabled():
        return
    global _drain_start
    with _lock:
        if _drain_start is None:
            return
        dur = time.perf_counter() - _drain_start
        _drain_start = None
    note_span("drain", dur)


# --- reading ---------------------------------------------------------------

def _snapshot_locked() -> dict:
    tracked = sum(_accum.values())
    wall = 0.0 if _t0_perf is None else (_last_perf - _t0_perf)
    frac = (_accum.get(GOOD_STATE, 0.0) / tracked) if tracked > _EPS \
        else 0.0
    segs = list(_segments)
    if _cur is not None and _cur["dur"] > _EPS:
        segs.append({"state": _cur["state"],
                     "start_unix": round(_cur["start_unix"], 6),
                     "dur": round(_cur["dur"], 6)})
    return {"states": {k: round(v, 6) for k, v in sorted(_accum.items())},
            "wall_s": round(wall, 6),
            "tracked_s": round(tracked, 6),
            "goodput_fraction": round(frac, 6),
            "started_unix": _t0_unix,
            "segments": segs}


def snapshot() -> dict:
    """This rank's accounting: per-state seconds, tracked wall, the
    fraction, and the (bounded) segment timeline."""
    with _lock:
        return _snapshot_locked()


def reset():
    """Drop the accounting clock, accumulators, timeline and the three
    metric families (one test's chip-time must not leak into the
    next)."""
    global _t0_unix, _t0_perf, _last_perf, _cur, _drain_start
    with _lock:
        _t0_unix = _t0_perf = _last_perf = None
        _accum.clear()
        _segments.clear()
        _cur = None
        _drain_start = None
    _m_chip.clear()
    _m_fraction.clear()
    _m_badput.clear()

"""Perfscope: the per-phase step-time regression watch.

Counterpart of paddle_tpu/observability/perfscope.py, the parts the serving
plane calls: ``enabled`` and ``note_phase`` (the batcher times every
prefill and decode step with it), and the phase plane under them.  Per
phase, the FIRST ``perf_baseline_window`` samples freeze as the baseline;
the rolling median of the newest window is compared against it and
published as ``perf_regression_ratio{phase}``.  Everything is gated on the
``perfscope`` flag: off, nothing is recorded or published.

A timing-only sample carries no cost model, so it gets no roofline verdict
in the reference either.  The roofline half needs the cost model and is
not ported yet (ROADMAP queue A.9): ``device_params``, ``comm_model`` and
``program_model`` raise NotImplementedError; the verdicts, the per-program
sinks and the alert context are left out.
"""
from __future__ import annotations

import threading
from collections import deque
from statistics import median
from typing import Dict, Optional

from ..core import flags
from . import metrics as obs_metrics

_m_ratio = obs_metrics.gauge(
    "perf_regression_ratio",
    "Rolling step-time median / frozen baseline median per phase "
    "(perfscope regression watch; the built-in perf_regression alert "
    "thresholds this at perf_regression_factor).", ("phase",))

_lock = threading.RLock()
_phases: Dict[str, dict] = {}        # phase -> record (see _phase_rec)
_last_regression: Optional[dict] = None

_ROOFLINE = ("the roofline half of perfscope needs the cost model, which "
             "is not ported yet (ROADMAP queue A.9)")


def enabled() -> bool:
    return bool(flags.get_flag("perfscope"))


def device_params() -> dict:
    raise NotImplementedError(_ROOFLINE)


def comm_model(fn, abs_args) -> Dict[str, float]:
    raise NotImplementedError(_ROOFLINE)


def program_model(label: str, fn, args) -> Optional[dict]:
    raise NotImplementedError(_ROOFLINE)


# --- phase recording --------------------------------------------------------

def _phase_rec(phase: str) -> dict:
    rec = _phases.get(phase)
    if rec is None:
        window = max(1, int(flags.get_flag("perf_baseline_window")))
        rec = {"count": 0, "total_s": 0.0, "last_s": 0.0,
               "baseline": deque(maxlen=window),
               "recent": deque(maxlen=window),
               "ratio": 1.0, "regressed": False,
               "last_trace_id": None}
        _phases[phase] = rec
    return rec


def _watch(phase: str, rec: dict, seconds: float,
           trace_id: Optional[str]):
    """One regression-watch sample (call under _lock): the first
    window freezes as baseline, the rolling median of the newest
    window is the ratio numerator."""
    global _last_regression
    if trace_id:
        rec["last_trace_id"] = trace_id
    if len(rec["baseline"]) < rec["baseline"].maxlen:
        rec["baseline"].append(seconds)
    else:
        rec["recent"].append(seconds)
    ratio = 1.0
    if rec["recent"] and rec["baseline"]:
        base = median(rec["baseline"])
        ratio = median(rec["recent"]) / max(base, 1e-12)
    rec["ratio"] = ratio
    factor = float(flags.get_flag("perf_regression_factor"))
    rec["regressed"] = factor > 1.0 and ratio >= factor
    _m_ratio.labels(phase=phase).set(ratio)
    if rec["regressed"]:
        _last_regression = {
            "phase": phase, "ratio": ratio,
            "baseline_s": median(rec["baseline"]),
            "recent_s": median(rec["recent"]),
            "trace_id": rec["last_trace_id"]}


def note_phase(phase: str, seconds: float,
               trace_id: Optional[str] = None):
    """Timing-only sample (serving prefill/decode): regression watch
    and time-sink accounting, no roofline (no cost model attached)."""
    if not enabled():
        return
    with _lock:
        rec = _phase_rec(phase)
        rec["count"] += 1
        rec["total_s"] += seconds
        rec["last_s"] = seconds
        _watch(phase, rec, seconds, trace_id)


# --- reporting ---------------------------------------------------------------

def status_doc() -> dict:
    """The phase half of the paddle_tpu.perf.v1 document."""
    with _lock:
        phases = {}
        for name, rec in sorted(_phases.items()):
            d = {"count": rec["count"], "total_s": rec["total_s"],
                 "last_s": rec["last_s"], "regression_ratio": rec["ratio"],
                 "regressed": rec["regressed"],
                 "last_trace_id": rec["last_trace_id"]}
            if rec["baseline"]:
                d["baseline_s"] = median(rec["baseline"])
            phases[name] = d
        last_reg = dict(_last_regression) if _last_regression else None
    return {
        "schema": "paddle_tpu.perf.v1",
        "enabled": enabled(),
        "regression": {
            "factor": float(flags.get_flag("perf_regression_factor")),
            "window": int(flags.get_flag("perf_baseline_window")),
            "last": last_reg},
        "phases": phases,
    }


def reset():
    """Drop baselines and every perf_regression_ratio series (one test's
    regressions must not leak into the next)."""
    global _last_regression
    with _lock:
        _phases.clear()
        _last_regression = None
    _m_ratio.clear()

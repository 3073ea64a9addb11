"""Fleet event journal: one append-only JSONL timeline of lifecycle
events across the whole fleet.

The metrics registry answers "how much/how often"; the runlog answers
"what did THIS run's scalars do"; neither answers the incident
question: *what happened, in what order, across the fleet, around
14:32?*  This module is that record — structured lifecycle events
(supervisor spawn/restart/park/revive, master generation bumps,
resize requested/applied, lease fences, guard trips with their
first-bad-var, chaos injections, checkpoint/reshard commits, serving
drains) appended as strict-JSON lines, each stamped with the paired
(``time_unix``, ``perf_counter``) clock sample of the fleet
protocol and the ambient X-ray trace id, so events correlate across
hosts and against request waterfalls.

Write discipline is the runlog idiom: writes NEVER raise (a full disk
must not take training down — failures land in
``journal_write_failures_total``), every line is strict JSON
(non-finite floats stringified), and rotation is atomic
(``os.replace`` to ``<path>.1``).  Unlike the per-run runlog, the
journal APPENDS across process restarts — a respawned incarnation
continues the same timeline — and rotates only when the file outgrows
``journal_rotate_bytes``.

Fleet assembly: every event also lands in a bounded in-memory ring
with an absolute-cursor read (:func:`events_since`, the
``trace.events_since`` contract) so the FleetReporter ships new events
to the coordinator over the existing ``report_events`` transport; the
FleetAggregator normalizes their clocks onto the master timeline
(``perf_counter + offset``, the X-ray idiom — robust to
restarted perf epochs and skewed hosts) and appends them to the
coordinator's own journal file, producing ONE durable merged fleet
timeline.  ``python -m paddle_tpu_torch.observability.incident`` reads it
back.

Enable via the ``journal_path`` flag (``PTPU_JOURNAL_PATH``); empty =
every :func:`emit` is a cheap no-op and no file or ring state exists
(the flag-off invariance idiom, regression-tested).
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

from ..core import flags
from . import metrics as obs_metrics

SCHEMA = "paddle_tpu.journal.v1"

# the journal_path and journal_rotate_bytes flags are declared in
# core/flags.py


_m_events = obs_metrics.counter(
    "journal_events_total",
    "Events appended to the fleet event journal, by kind.", ("kind",))
_m_failures = obs_metrics.counter(
    "journal_write_failures_total",
    "Journal appends that failed (disk full / permission) and were "
    "absorbed — the journal must never take the fleet down.")
_m_collisions = obs_metrics.counter(
    "journal_field_collisions_total",
    "emit() instrumentation fields DROPPED because they collide with "
    "a reserved record name (rank/pid/seq/...).  Non-zero means a "
    "call site is silently losing data — rename the field (the "
    "'worker=' gotcha, caught at the source).", ("field",))

# the envelope emit() owns; an instrumentation field by one of these
# names would either be dropped (old behavior, silently) or corrupt
# the dedupe/merge keys if honored — so it is dropped LOUDLY instead
_RESERVED_FIELDS = ("schema", "kind", "event", "time_unix",
                    "perf_counter", "rank", "pid", "seq", "trace_id")
_warned_collisions: set = set()

_RING_MAX = 4096

_lock = threading.Lock()
_writer_f = None                 # open file handle (lazy)
_writer_path: Optional[str] = None
_ring: List[dict] = []
_ring_base = 0                   # absolute index of _ring[0]
_generation = 0                  # bumped by reset(): cursor consumers resync
_seq = 0                         # per-process monotonic id (dedupe key)
_rank = 0


def enabled() -> bool:
    return bool(str(flags.get_flag("journal_path") or ""))


def set_rank(rank: int):
    """Fleet identity stamped on every event this process emits (the
    supervisor's elastic workers call this; 0 is the single-process
    default)."""
    global _rank
    _rank = int(rank)


def _strict(v: Any):
    """JSON-safe copy: non-finite floats stringified (every line must
    be strict JSON — a NaN loss is exactly what gets journaled),
    numpy scalars coerced, unknown objects repr-bounded.  A local twin
    of runlog's helper: the runlog module doubles as a CLI and must
    stay OUT of the package import graph (the runpy gotcha), so the
    journal cannot import it."""
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, (int, bool, str)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k)[:80]: _strict(x) for k, x in list(v.items())[:32]}
    if isinstance(v, (list, tuple)):
        return [_strict(x) for x in list(v)[:32]]
    try:
        import operator
        return int(operator.index(v))     # integral numpy scalar
    except TypeError:
        pass
    try:
        return _strict(float(v))          # numpy scalar / 0-d array
    except (TypeError, ValueError):
        return repr(v)[:300]


def _open_writer(path: str):
    """Open (or reopen after a flag change) the journal file, rotating
    an oversized predecessor aside first.  Never raises."""
    global _writer_f, _writer_path
    cap = int(flags.get_flag("journal_rotate_bytes"))
    try:
        if cap > 0 and os.path.getsize(path) > cap:
            os.replace(path, path + ".1")
    except FileNotFoundError:
        pass
    except OSError as e:
        _m_failures.inc()
        warnings.warn(
            f"journal could not rotate {path!r} aside ({e}); "
            f"appending to the oversized file", RuntimeWarning,
            stacklevel=4)
    try:
        _writer_f = open(path, "a", encoding="utf-8")
        _writer_path = path
    except OSError as e:
        _writer_f, _writer_path = None, path
        _m_failures.inc()
        warnings.warn(f"journal not opened ({path}): {e}",
                      RuntimeWarning, stacklevel=4)


def emit(kind: str, event: str, **fields) -> Optional[dict]:
    """Append one lifecycle event: journal file + shipping ring.
    No-op (one flag read) when the journal is off; never raises.
    Returns the record, or None when disabled/failed."""
    path = str(flags.get_flag("journal_path") or "")
    if not path:
        return None
    global _seq
    from . import tracectx as obs_tracectx
    with _lock:
        _seq += 1
        rec: Dict[str, Any] = {
            "schema": SCHEMA, "kind": str(kind), "event": str(event),
            "time_unix": time.time(),
            "perf_counter": time.perf_counter(),
            "rank": _rank, "pid": os.getpid(), "seq": _seq,
        }
        tid = obs_tracectx.current_trace_id()
        if tid is not None:
            rec["trace_id"] = tid
        for k, v in fields.items():
            if k in _RESERVED_FIELDS:
                # LOUD drop: a collision with the envelope loses the
                # caller's data either way — say so (warn once per
                # site, count always) instead of eating it
                _m_collisions.labels(field=k).inc()
                site = (rec["kind"], rec["event"], k)
                if site not in _warned_collisions:
                    _warned_collisions.add(site)
                    warnings.warn(
                        f"journal.emit({rec['kind']}/{rec['event']}): "
                        f"field {k!r} collides with a reserved record "
                        f"name and was DROPPED — rename it (reserved: "
                        f"{_RESERVED_FIELDS})", RuntimeWarning,
                        stacklevel=2)
            elif k not in rec:
                rec[k] = _strict(v)
        _ring.append(rec)
        if len(_ring) > _RING_MAX:
            global _ring_base
            cut = len(_ring) // 2
            _ring_base += cut
            del _ring[:cut]
        if _writer_f is None or _writer_path != path:
            if _writer_f is not None:
                try:
                    _writer_f.close()
                except OSError:
                    pass
            _open_writer(path)
        _write_locked(rec)
    _m_events.labels(kind=str(kind)).inc()
    return rec


def _write_locked(rec: dict):
    global _writer_f
    if _writer_f is None:
        _m_failures.inc()
        return
    try:
        _writer_f.write(json.dumps(rec, allow_nan=False,
                                   separators=(",", ":")) + "\n")
        _writer_f.flush()
    except (OSError, ValueError):
        _m_failures.inc()


def append_raw(rec: dict):
    """Write a pre-built (already clock-normalized) record to THIS
    process's journal file — the coordinator's FleetAggregator appends
    worker-shipped events here so one file holds the merged durable
    fleet timeline.  Raw records bypass the shipping ring (they were
    shipped TO us) and, like every journal write, never raise."""
    path = str(flags.get_flag("journal_path") or "")
    if not path or not isinstance(rec, dict):
        return
    rec = dict(rec)
    rec.setdefault("schema", SCHEMA)
    with _lock:
        if _writer_f is None or _writer_path != path:
            if _writer_f is not None:
                try:
                    _writer_f.close()
                except OSError:
                    pass
            _open_writer(path)
        _write_locked({k: _strict(v) for k, v in rec.items()})


def events_since(cursor: int, gen: Optional[int] = None):
    """Atomic (generation, absolute length, tail) read for the
    FleetReporter — the trace.events_since contract: a generation
    mismatch means reset() wiped the ring, so the whole buffer
    returns; cursors are ABSOLUTE append positions (the ring trims
    from the front; ``_ring_base`` keeps them stable across trims)."""
    with _lock:
        g = _generation
        start_abs = cursor if gen == g else 0
        idx = max(0, min(start_abs - _ring_base, len(_ring)))
        return g, _ring_base + len(_ring), list(_ring[idx:])


def generation() -> int:
    return _generation


def tail(n: int = 100) -> List[dict]:
    """The newest `n` locally-emitted events (the /journal route's
    local half)."""
    with _lock:
        return list(_ring[-max(0, int(n)):])


def reset():
    """Test hook (conftest): close the writer, wipe the ring, bump the
    generation so cursor consumers resync, and zero the rank."""
    global _writer_f, _writer_path, _ring_base, _generation, _seq, _rank
    with _lock:
        if _writer_f is not None:
            try:
                _writer_f.close()
            except OSError:
                pass
        _writer_f, _writer_path = None, None
        _ring.clear()
        _ring_base = 0
        _generation += 1
        _seq = 0
        _rank = 0
        _warned_collisions.clear()
    _m_collisions.clear()


# -- reading / merging ------------------------------------------------------

def read_events(path: str) -> List[dict]:
    """Parse a journal file back into records.  Strict: every non-blank
    line must be a JSON object carrying this module's schema — the
    round-trip contract the incident CLI (and tests) rely on."""
    out: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from e
            if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
                raise ValueError(
                    f"{path}:{i}: schema "
                    f"{rec.get('schema') if isinstance(rec, dict) else rec!r}"
                    f" != {SCHEMA}")
            out.append(rec)
    return out


def _dedupe_key(rec: dict):
    """Stable identity of one emission: (rank, pid, seq).  The same
    event can reach the incident CLI twice — once from the emitting
    rank's own file and once through the coordinator's merged file
    (shipped over report_events) — and must appear ONCE in the
    timeline.  Records without the triple (foreign/synthetic) are
    never deduped."""
    if all(k in rec for k in ("rank", "pid", "seq")):
        return (rec["rank"], rec["pid"], rec["seq"])
    return None


def merge_events(streams: Sequence[Sequence[dict]]) -> List[dict]:
    """Merge event streams into one timeline: dedupe by emission
    identity, order by ``time_unix`` (already master-normalized for
    aggregator-shipped events; the emitter's own wall clock
    otherwise)."""
    seen = set()
    out: List[dict] = []
    for stream in streams:
        for rec in stream or []:
            if not isinstance(rec, dict):
                continue
            key = _dedupe_key(rec)
            if key is not None:
                if key in seen:
                    continue
                seen.add(key)
            out.append(rec)
    out.sort(key=lambda r: (float(r.get("time_unix", 0.0) or 0.0),
                            r.get("seq", 0)))
    return out

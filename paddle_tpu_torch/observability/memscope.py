"""Memscope: the KV-occupancy ledger and OOM forensics of the serving plane.

Counterpart of paddle_tpu/observability/memscope.py, the parts the serving
plane calls: ``enabled``, ``register_kv_engine``,
``register_sparse_shard`` (sparse/table.py's ``EmbeddingShard``),
``kv_occupancy``,
``note_kv`` and ``note_alloc_failure`` (the ``memory.alloc`` chaos site in
``DecodeEngine.decode_step``), with ``status_doc`` and ``reset``.  All of
it is behind the ``memscope`` flag (default off: zero serving-path work).

  kv ledger   DecodeEngine slab occupancy: reserved-vs-written
              positions per slot (and per prompt bucket) ->
              serving_kv_reserved_bytes / serving_kv_written_bytes /
              serving_kv_waste_fraction.  The slabs are torch tensors;
              the written positions come from the engine's host mirror
              of its lengths, so the ledger never reads the device.
  forensics   an allocation failure at a serving dispatch journals a
              memory/alloc_failure event and dumps a flight bundle.

Not ported yet (ROADMAP queue A.9): the census over live device buffers
(the reference walks ``jax.live_arrays()``; here it becomes
``torch.cuda.memory_stats``; ``sample`` raises NotImplementedError), the
per-program predicted-vs-measured peak reconciliation, the ticker and the
CLI.  An alloc-failure bundle carries no census.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np

from ..core import flags
from . import flight
from . import journal
from . import metrics

SCHEMA = "paddle_tpu.mem.v1"

_m_kv_reserved = metrics.gauge(
    "serving_kv_reserved_bytes",
    "KV slab bytes reserved by active decode slots (active_slots x "
    "max_len worth of positions).")
_m_kv_written = metrics.gauge(
    "serving_kv_written_bytes",
    "KV slab bytes actually written (sum of active slot lengths).")
_m_kv_waste = metrics.gauge(
    "serving_kv_waste_fraction",
    "1 - written/reserved over active decode slots: the worst-case "
    "over-reservation a paged KV cache would reclaim.")
_m_kv_bucket = metrics.gauge(
    "serving_kv_bucket_waste_fraction",
    "Per prompt-bucket KV waste fraction.", ("bucket",))

_lock = threading.RLock()
_state: Dict[str, Any] = {}
# Providers survive reset() on purpose: engines register once at
# construction, and tests reset between cases while module-scoped
# fixtures live on.  The WeakSet drops dead engines automatically.
_kv_engines: "weakref.WeakSet" = weakref.WeakSet()
_sparse_shards: "weakref.WeakSet" = weakref.WeakSet()

_CENSUS = ("the device-memory census is not ported yet (ROADMAP queue "
           "A.9: torch.cuda.memory_stats in place of jax.live_arrays)")


def enabled() -> bool:
    return bool(flags.get_flag("memscope"))


def register_kv_engine(engine) -> None:
    """Called by DecodeEngine.__init__ (construction time, not the
    request path): the census, once ported, claims the engine's slabs."""
    try:
        _kv_engines.add(engine)
    except TypeError:
        pass


def register_sparse_shard(shard) -> None:
    """Called by sparse EmbeddingShard.__init__: the census, once
    ported, files the host-side table bytes as the sparse_tables
    plane."""
    try:
        _sparse_shards.add(shard)
    except TypeError:
        pass


def sample(reason: str = "tick") -> int:
    raise NotImplementedError(_CENSUS)


# --- KV-cache occupancy ledger ---------------------------------------------

def kv_occupancy(engine) -> dict:
    """Reserved-vs-written slot math over a DecodeEngine's slabs (pure
    host-side arithmetic over the engine's host mirror of its lengths)."""
    slab = int(engine._kv_k.nbytes) + int(engine._kv_v.nbytes)
    nslots = int(engine.max_batch)
    max_len = int(engine.max_len)
    per_slot = slab // max(1, nslots)
    bpp = per_slot // max(1, max_len)
    lengths = np.asarray(engine._lengths_host)
    active = np.asarray(engine._active, dtype=bool)
    n_active = int(active.sum())
    written_pos = int(lengths[active].sum()) if n_active else 0
    reserved = n_active * per_slot
    written = written_pos * bpp
    waste = (1.0 - written / reserved) if reserved else 0.0
    buckets: Dict[str, dict] = {}
    slot_bucket = getattr(engine, "_slot_bucket", None)
    if slot_bucket is not None:
        for slot in np.nonzero(active)[0]:
            b = str(int(slot_bucket[slot]))
            row = buckets.setdefault(b, {"slots": 0, "reserved_bytes": 0,
                                         "written_bytes": 0})
            row["slots"] += 1
            row["reserved_bytes"] += per_slot
            row["written_bytes"] += int(lengths[slot]) * bpp
        for row in buckets.values():
            row["waste_fraction"] = (
                1.0 - row["written_bytes"] / row["reserved_bytes"]
                if row["reserved_bytes"] else 0.0)
    return {"slab_bytes": slab, "slots": nslots,
            "active_slots": n_active, "max_len": max_len,
            "bytes_per_position": bpp, "reserved_bytes": reserved,
            "written_bytes": written, "waste_fraction": waste,
            "buckets": buckets}


def note_kv(engine) -> None:
    """Serving-boundary hook (start_sequence / decode_step /
    retire_slot): refresh the occupancy ledger + gauges."""
    if not enabled():
        return
    doc = kv_occupancy(engine)
    _m_kv_reserved.set(doc["reserved_bytes"])
    _m_kv_written.set(doc["written_bytes"])
    _m_kv_waste.set(doc["waste_fraction"])
    _m_kv_bucket.clear()
    for b, row in doc["buckets"].items():
        _m_kv_bucket.labels(bucket=b).set(row["waste_fraction"])
    with _lock:
        _state["kv"] = doc
        if doc["active_slots"]:
            _state["kv_peak_waste"] = max(
                float(_state.get("kv_peak_waste") or 0.0),
                doc["waste_fraction"])


# --- OOM forensics ---------------------------------------------------------

def note_alloc_failure(where: str, label: Optional[str] = None,
                       cost=None) -> Optional[str]:
    """An allocation failed (the memory.alloc chaos site, or a real
    out-of-memory caller): journal the event so ``incident`` can
    reconstruct the kill timeline, and dump a flight bundle with the
    KV ledger.  The reference freezes its census into the bundle too;
    the census is not ported yet, so the bundle says so."""
    if not enabled():
        return None
    with _lock:
        _state["alloc_failures"] = int(_state.get("alloc_failures") or 0) + 1
        kv = dict(_state["kv"]) if _state.get("kv") else None
    journal.emit("memory", "alloc_failure", where=where, program=label)
    path = flight.dump("memory_alloc_failure",
                       extra={"memory": {"where": where, "program": label,
                                         "kv": kv,
                                         "census": "not ported (A.9)"}})
    with _lock:
        _state["last_alloc_failure"] = {
            "where": where, "program": label,
            "time_unix": time.time(), "bundle_path": path}
    return path


# --- reporting / lifecycle ---------------------------------------------------

def status_doc() -> dict:
    """The serving half of the paddle_tpu.mem.v1 document."""
    with _lock:
        return {
            "schema": SCHEMA, "enabled": enabled(),
            "kv": (dict(_state["kv"]) if _state.get("kv") else None),
            "kv_peak_waste_fraction": _state.get("kv_peak_waste"),
            "alloc_failures": int(_state.get("alloc_failures") or 0),
            "last_alloc_failure": (dict(_state["last_alloc_failure"])
                                   if _state.get("last_alloc_failure")
                                   else None),
        }


def reset() -> None:
    """Drop the ledger state and every serving_kv_* gauge series (one
    test's occupancy must not leak into the next).  The provider weakset
    survives: registration happens once at engine construction."""
    with _lock:
        _state.clear()
    for m in (_m_kv_reserved, _m_kv_written, _m_kv_waste, _m_kv_bucket):
        m.clear()

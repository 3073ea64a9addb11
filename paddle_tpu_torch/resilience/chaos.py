"""Deterministic, seeded fault injection.

The runtime half of the reference stack's fault story is only provable
if faults can be *produced* on demand: the Go master requeues leased
tasks on failure (go/master/service.go:455) and the pserver survives
torn checkpoint writes (go/pserver/service.go:346), and both are tested
by killing things.  This module is the killing machinery — named fault
points planted on the hot paths (executor compile/run, checkpoint shard
write, collective dispatch, task-queue RPC, trainer step) that stay
zero-overhead no-ops until armed via the ``chaos_spec`` flag
(``PTPU_CHAOS_SPEC`` env or ``set_flag``).

Spec grammar (one directive per site, ';'-separated)::

    site=kind[:prob[:arg]]

    trainer.step=nan:0.1              poison fetched loss with NaN, p=0.1
    checkpoint.shard_write=truncate:0.5   torn-write half the shard file
    task_queue.rpc=raise:0.2          raise at the RPC boundary, p=0.2
    executor.run=delay:1.0:0.05       sleep 0.05s before dispatch, p=1.0

Kinds: ``raise`` (the planted site's exception class — ConnectionError
at RPC sites, OSError at filesystem sites), ``nan`` / ``inf`` (poison a
value), ``delay`` (sleep ``arg`` seconds, default 0.01), ``truncate``
(cut a file to ``arg`` fraction of its bytes, default 0.5), ``exit``
(hard process death via ``os._exit(arg)`` — the ``kill -9`` a
supervisor must survive; default code 9), and ``refuse`` (a
connection-refused WINDOW: the first firing opens ``arg`` seconds —
default 0.25 — during which every pass of the site raises
``ConnectionRefusedError``, modelling a master that is down for a
stretch, driving client re-dial/failover).

Determinism: every fault point keeps a per-site invocation counter, and
the fire/skip decision hashes (seed, site, counter) through crc32 — no
process-randomized ``hash()``, no global RNG state — so the same
(spec, seed) replays the identical fault schedule in any process, and a
failure seen in CI reproduces locally from the two flag values.  The
fired schedule is recorded and exposed via :func:`schedule` for tests
to assert exact replay.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..core import flags
from ..observability import flight as obs_flight
from ..observability import journal as obs_journal
from ..observability import metrics as obs_metrics

_m_injected = obs_metrics.counter(
    "resilience_faults_injected_total",
    "Faults fired by the chaos plane, by site and kind.",
    ("site", "kind"))


class InjectedFault(Exception):
    """Default exception class for ``raise``-kind faults."""


class Fault:
    __slots__ = ("site", "kind", "prob", "arg")

    KINDS = ("raise", "nan", "inf", "delay", "truncate", "exit",
             "refuse")

    # per-kind default for the optional third field
    DEFAULT_ARGS = {"delay": 0.01, "truncate": 0.5, "exit": 9.0,
                    "refuse": 0.25}

    def __init__(self, site: str, kind: str, prob: float, arg: float):
        self.site = site
        self.kind = kind
        self.prob = prob
        self.arg = arg


def parse_spec(spec: str) -> Dict[str, Fault]:
    """Parse the chaos grammar; raises ValueError naming the bad
    directive (the same courtesy core/flags.py extends to env values)."""
    out: Dict[str, Fault] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"chaos_spec directive {part!r} has no '=': expected "
                f"site=kind[:prob[:arg]]")
        site, rhs = part.split("=", 1)
        fields = rhs.split(":")
        kind = fields[0].strip()
        if kind not in Fault.KINDS:
            raise ValueError(
                f"chaos_spec site {site!r}: unknown fault kind {kind!r} "
                f"(expected one of {Fault.KINDS})")
        try:
            prob = float(fields[1]) if len(fields) > 1 else 1.0
            arg = float(fields[2]) if len(fields) > 2 else \
                Fault.DEFAULT_ARGS.get(kind, 0.5)
        except ValueError:
            raise ValueError(
                f"chaos_spec site {site!r}: non-numeric prob/arg in "
                f"{rhs!r}")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"chaos_spec site {site!r}: prob {prob} not in [0, 1]")
        out[site.strip()] = Fault(site.strip(), kind, prob, arg)
    return out


# Parsed-spec cache + per-site counters + fired-schedule record.  One
# lock: fault points are on hot paths but the unarmed fast path below
# never takes it.
_lock = threading.Lock()
_EMPTY: Dict[str, Fault] = {}
_parsed: Tuple[str, Dict[str, Fault]] = ("", {})
_counters: Dict[str, int] = {}
_fired: List[Tuple[str, int, str]] = []
# open connection-refused windows per site (kind "refuse"): passes of
# the site inside the window raise without burning schedule slots
_refuse_until: Dict[str, float] = {}


def _active() -> Dict[str, Fault]:
    """Current armed spec (cached parse; re-parses when the flag text
    changes, so set_flag re-arms without a reset)."""
    global _parsed
    spec = flags.get_flag("chaos_spec")
    if not spec:
        return _EMPTY
    if _parsed[0] != spec:
        with _lock:
            if _parsed[0] != spec:
                _parsed = (spec, parse_spec(spec))
    return _parsed[1]


def reset():
    """Zero the per-site counters and the fired-schedule record, so the
    next armed run replays the schedule from the top."""
    global _parsed, _counters, _fired
    with _lock:
        _parsed = ("", {})
        _counters = {}
        _fired = []
        _refuse_until.clear()


def schedule() -> List[Tuple[str, int, str]]:
    """The (site, invocation_index, kind) tuples fired since reset() —
    two runs with the same (spec, seed) produce identical lists."""
    return list(_fired)


def _decide(fault: Fault) -> Optional[int]:
    """Advance the site counter; return the invocation index if this
    invocation fires, else None.  crc32 keyed on (seed, site, counter)
    is the whole RNG: stable across processes and replayable."""
    with _lock:
        n = _counters.get(fault.site, 0)
        _counters[fault.site] = n + 1
    seed = flags.get_flag("chaos_seed")
    h = zlib.crc32(f"{seed}:{fault.site}:{n}".encode()) / 0xFFFFFFFF
    if h >= fault.prob:
        return None
    with _lock:
        _fired.append((fault.site, n, fault.kind))
    _m_injected.labels(site=fault.site, kind=fault.kind).inc()
    obs_flight.record("chaos", fault.site, fault_kind=fault.kind, n=n)
    # journaled BEFORE the fault acts (the write flushes per line), so
    # even an `exit`-kind hard kill leaves "chaos killed me HERE" in
    # the victim's journal for the incident timeline
    obs_journal.emit("chaos", "injected", site=fault.site,
                     fault_kind=fault.kind, n=n)
    return n


def trigger(site: str, exc: type = InjectedFault):
    """Fire side-effect faults (raise/delay/exit/refuse) armed at
    `site`.  The unarmed path is one flag read + dict miss."""
    fault = _active().get(site)
    if fault is None:
        return
    if fault.kind == "refuse":
        now = time.time()
        with _lock:
            until = _refuse_until.get(site, 0.0)
        if until > now:
            # inside an open window: refuse without consuming a new
            # schedule slot (one decision opened the whole window)
            raise ConnectionRefusedError(
                f"chaos: refuse window at {site} "
                f"({until - now:.2f}s left)")
        n = _decide(fault)
        if n is None:
            return
        with _lock:
            _refuse_until[site] = now + fault.arg
        raise ConnectionRefusedError(
            f"chaos: injected refuse window at {site}#{n} "
            f"for {fault.arg}s")
    if fault.kind in ("raise", "delay", "exit"):
        n = _decide(fault)
        if n is None:
            return
        if fault.kind == "delay":
            time.sleep(fault.arg)
        elif fault.kind == "exit":
            # kill -9 semantics: no atexit, no finally, no flushes —
            # the process is simply gone mid-step (the supervisor's
            # problem now).  One stderr line so the operator can tell
            # an injected death from a real one.
            print(f"chaos: injected hard exit at {site}#{n} "
                  f"(code {int(fault.arg)})", file=sys.stderr,
                  flush=True)
            os._exit(int(fault.arg))
        else:
            raise exc(f"chaos: injected fault at {site}#{n}")


class fault_point:
    """``with fault_point("site"): ...`` or ``@fault_point("site")`` —
    fires raise/delay faults on entry.  Value/file faults use
    :func:`poison` / :func:`corrupt_file` at the site instead."""

    __slots__ = ("site", "exc")

    def __init__(self, site: str, exc: type = InjectedFault):
        self.site = site
        self.exc = exc

    def __enter__(self):
        trigger(self.site, self.exc)
        return self

    def __exit__(self, *e):
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            trigger(self.site, self.exc)
            return fn(*args, **kwargs)
        return wrapped


def poison(site: str, value: Any) -> Any:
    """NaN/Inf-poison `value` (a scalar, array, or list whose first
    element is the loss) when a nan/inf fault fires at `site`; returns
    the value unchanged otherwise."""
    fault = _active().get(site)
    if fault is None or fault.kind not in ("nan", "inf"):
        return value
    if isinstance(value, (list, tuple)) and not value:
        return value    # nothing to poison: don't burn a schedule slot
    if _decide(fault) is None:
        return value
    bad = float("nan") if fault.kind == "nan" else float("inf")

    def _poison_one(v):
        import numpy as np
        arr = np.asarray(v, dtype="float64") if not hasattr(v, "dtype") \
            else np.array(v, copy=True)
        if not np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype("float64")
        arr[...] = bad
        return arr

    if isinstance(value, (list, tuple)) and value:
        out = list(value)
        out[0] = _poison_one(out[0])
        return type(value)(out) if isinstance(value, tuple) else out
    return _poison_one(value)


# prefix of the named-variable poison family planted in the executor's
# lowering loop: `executor.var.<var_name>=nan:1.0` NaN-poisons that
# variable's value INSIDE the step — the deterministic "this layer went
# bad" injection tensorstats' first-bad-layer attribution is tested
# against (docs/RESILIENCE.md catalog).
VAR_SITE_PREFIX = "executor.var."


def var_sites_armed() -> bool:
    """True when any executor.var.* directive is armed — the executor's
    per-op guard, so the unarmed hot path pays one empty-dict check."""
    spec = _active()
    if not spec:
        return False
    return any(s.startswith(VAR_SITE_PREFIX) for s in spec)


def poison_value(site: str, value: Any) -> Any:
    """NaN/Inf-poison a (possibly traced) floating tensor when a
    nan/inf fault fires at `site`; returns it unchanged otherwise.
    Unlike :func:`poison` (host-side numpy), this keeps the value a
    torch tensor on its device; the port runs its ops eagerly, so the
    fire decision is made per call."""
    fault = _active().get(site)
    if fault is None or fault.kind not in ("nan", "inf"):
        return value
    import torch
    if not (isinstance(value, torch.Tensor)
            and value.dtype.is_floating_point):
        return value
    if _decide(fault) is None:
        return value
    bad = float("nan") if fault.kind == "nan" else float("inf")
    return torch.full_like(value, bad)


def corrupt_file(site: str, path: str):
    """Torn-write simulation: truncate `path` to the armed fraction of
    its bytes when a truncate fault fires at `site` (the partial flush a
    crash leaves behind — detected downstream by CRC, exactly the
    go/pserver:346 failure mode)."""
    fault = _active().get(site)
    if fault is None or fault.kind != "truncate":
        return
    if _decide(fault) is None:
        return
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(0, int(size * fault.arg)))
    except OSError:
        pass        # the file vanished mid-injection; nothing to tear

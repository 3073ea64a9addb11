"""Online serving plane: continuous batching, decode-loop KV cache, and
SLO-metered admission control.

Counterpart of paddle_tpu/serving/:

  * :mod:`.kv_cache`   — batched incremental decode over trained
    ``build_lm_net`` weights: per-layer K/V slabs, a bucketed prefill and
    one decode step, each a CUDA graph captured at ``prepare()`` on the
    card, per-slot retire/backfill.
  * :mod:`.batcher`    — request queue + continuous batcher + bounded
    admission (``ShedError`` = HTTP 429) + SIGTERM drain + SLO metrics.
  * :mod:`.loadgen`    — closed-loop concurrent client streams with
    p50/p99 TTFT / per-token reporting (the serving soak headline).

Not ported yet (ROADMAP queue A.9): the supervised HTTP worker
(``worker.py``, which needs observability/server), the multi-replica
router (``router.py``) and ``fleet_worker.py``.

One process-wide batcher may be ATTACHED here (:func:`attach`); tests
detach it via :func:`reset`.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Optional

from ..observability import metrics as obs_metrics
# lives in observability/metrics.py; re-exported for serving callers
from ..observability.metrics import histogram_quantiles  # noqa: F401
from .batcher import ContinuousBatcher, ServingRequest, ShedError
from .kv_cache import DecodeEngine, extract_lm_params

__all__ = ["DecodeEngine", "extract_lm_params", "ContinuousBatcher",
           "ServingRequest", "ShedError", "attach", "get", "drain",
           "reset", "status_doc", "histogram_quantiles", "get_router"]

_lock = threading.Lock()
_batcher: Optional[ContinuousBatcher] = None


def attach(batcher: ContinuousBatcher) -> ContinuousBatcher:
    """Register the process-wide batcher the HTTP routes serve from."""
    global _batcher
    with _lock:
        if _batcher is not None and _batcher is not batcher \
                and _batcher.running:
            raise RuntimeError(
                "a serving batcher is already attached; reset() first")
        _batcher = batcher
    return batcher


def get() -> Optional[ContinuousBatcher]:
    return _batcher


def get_router():
    """The attached router (serving/router.py, not ported yet), or None.
    DELIBERATELY lazy: the router module is looked up, never imported
    — a single-replica process that never touches the router keeps
    byte-identical routes, metric families and import graph (the
    router-off invariance contract)."""
    mod = sys.modules.get(__name__ + ".router")
    return None if mod is None else mod.get()


def drain(stop: bool = False) -> dict:
    """Drain the attached batcher on command: the
    controller's ``drain`` actuator and the body behind
    ``POST /serving/drain``.  Raises RuntimeError when no batcher is
    attached — a drain that silently did nothing is exactly the
    actuator failure the controller's circuit breaker exists to
    catch."""
    b = get()
    if b is None:
        raise RuntimeError("serving.drain: no serving batcher attached")
    b.begin_drain(stop=stop)
    return {"status": "draining", "stop": bool(stop),
            "queued": b.queue_depth}


def reset():
    """Test hook: stop the attached batcher (loop thread
    JOINED), detach it from the HTTP routes; same for the router
    (probe thread joined, per-replica metric series dropped) when its
    module was ever imported."""
    global _batcher
    with _lock:
        b, _batcher = _batcher, None
    if b is not None:
        b.stop()
    mod = sys.modules.get(__name__ + ".router")
    if mod is not None:
        mod.reset()


def status_doc() -> dict:
    """The ``/serving`` route body: batcher/engine state plus SLO
    quantiles derived from the serving histograms."""
    b = get()
    doc = {
        "schema": "paddle_tpu.serving.v1",
        "time_unix": time.time(),
        "attached": b is not None,
    }
    if b is not None:
        doc.update(b.status_doc())
    r = get_router()
    if r is not None:
        doc["router"] = r.status_doc()

    def _counter_value(name, **labels):
        m = obs_metrics.REGISTRY.get(name)
        if m is None:
            return 0.0
        if labels:
            return m.labels(**labels).value
        return m.total()

    doc["tokens_generated"] = _counter_value(
        "serving_tokens_generated_total")
    doc["requests"] = {
        status: _counter_value("serving_requests_total", status=status)
        for status in ("ok", "shed", "drained", "error")}
    doc["compiles"] = _counter_value("serving_compiles_total")
    for key, hist in (("ttft_s", "serving_ttft_seconds"),
                      ("per_token_s", "serving_token_seconds"),
                      ("prefill_s", "serving_prefill_seconds"),
                      ("decode_step_s", "serving_decode_step_seconds")):
        doc[key] = histogram_quantiles(hist, [0.5, 0.99])
    return doc

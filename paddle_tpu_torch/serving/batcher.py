"""Continuous batcher + admission control over the KV-cache decode engine.

Counterpart of paddle_tpu/serving/batcher.py (``ContinuousBatcher`` :238,
``ServingRequest``, ``ShedError``), copied: the control loop is
framework-neutral.  On the card the engine's decode step is a graph
replay on the engine's own stream, issued from this loop's thread; the
decode-error recovery path calls ``engine.reset()``, which zeros the
slabs in place, so the captured graphs stay valid.

The serving plane's control loop: one thread owns the
:class:`~.kv_cache.DecodeEngine` and runs

    admit (fill free slots from the queue) -> decode_step -> retire

forever.  New requests are admitted AT DECODE-STEP BOUNDARIES — a
finished sequence's slot is backfilled while the other slots keep
decoding, so short requests never wait for a full batch to drain
(in-flight/continuous batching, the vLLM-style scheduling the
reference's one-shot ``AnalysisPredictor`` tier never had).

Admission control: the queue is bounded by ``serving_queue_limit``;
past it :meth:`ContinuousBatcher.submit` raises :class:`ShedError`
(HTTP 429 at the /serving/generate route) — an EXPLICIT rejection the
client can retry, never an unbounded queue or a silent drop.

SLO metering: every request carries its timing — TTFT (submit to first
token, prefill inclusive) and per-token decode latency land in
``serving_ttft_seconds`` / ``serving_token_seconds`` histograms;
queue depth / batch occupancy / tokens generated ride as gauges and
counters.  All of it is on the /metrics exposition (local and
fleet-merged) plus the /serving status route.

Resilience: the trainer's preemption idiom applies — SIGTERM begins a DRAIN
honored at the decode-step boundary (stop admitting, shed the queue
explicitly, finish in-flight sequences, then stop); chaos sites
``serving.admit`` and ``serving.decode_step`` let the soak kill or
fault the loop deterministically (docs/RESILIENCE.md).
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..core import flags
from ..observability import flight as obs_flight
from ..observability import goodput as obs_goodput
from ..observability import journal as obs_journal
from ..observability import metrics as obs_metrics
from ..observability import tracectx as obs_tracectx
from ..resilience import chaos
from .kv_cache import DecodeEngine

# decode spans are flushed per CHUNK tokens (one span per token would
# bloat the store; one per request would hide mid-decode stalls)
_DECODE_CHUNK_TOKENS = 8

_m_queue_depth = obs_metrics.gauge(
    "serving_queue_depth",
    "Requests admitted but not yet prefilled into a decode slot.")
_m_occupancy = obs_metrics.gauge(
    "serving_batch_occupancy",
    "Active decode slots / serving_max_batch (0..1).")
_m_active = obs_metrics.gauge(
    "serving_active_slots", "Active decode slots (absolute).")
_m_tokens = obs_metrics.counter(
    "serving_tokens_generated_total",
    "Tokens emitted by the decode loop across all requests.")
_m_requests = obs_metrics.counter(
    "serving_requests_total",
    "Serving requests by terminal status: ok, shed (bounded-queue "
    "429), drained (rejected/aborted by SIGTERM drain), error.",
    ("status",))
_m_ttft = obs_metrics.histogram(
    "serving_ttft_seconds",
    "Time to first token: submit -> queue wait -> bucketed prefill -> "
    "first sampled token.")
_m_token_latency = obs_metrics.histogram(
    "serving_token_seconds",
    "Per-token decode latency (one decode-step dispatch, per active "
    "slot).")
_m_step = obs_metrics.histogram(
    "serving_decode_step_seconds",
    "Whole decode-step dispatch latency (all slots at once).")
_m_draining = obs_metrics.gauge(
    "serving_draining", "1 while a SIGTERM drain is in progress.")
_m_drains = obs_metrics.counter(
    "serving_drains_total",
    "SIGTERM/explicit drains honored at a decode-step boundary.")


class ShedError(RuntimeError):
    """Request rejected by admission control.  ``draining=False`` is
    the bounded-queue rejection (HTTP 429: back off, retry HERE);
    ``draining=True`` means the instance is going away (HTTP 503:
    fail over)."""

    def __init__(self, msg: str, queue_depth: int = 0,
                 draining: bool = False):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.draining = draining


class ServingRequest:
    """One generation request and its lifecycle/timing record."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "eos_id",
                 "tokens", "status", "error", "submit_t", "first_token_t",
                 "finish_t", "_done", "trace", "submit_unix", "admit_t",
                 "_chunk_t0", "_chunk_unix", "_chunk_tokens")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 temperature: float, eos_id: Optional[int],
                 trace: Optional[obs_tracectx.TraceContext] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.tokens: List[int] = []
        self.status = "pending"       # -> ok | error | drained
        self.error: Optional[str] = None
        self.submit_t = time.perf_counter()
        self.submit_unix = time.time()
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self._done = threading.Event()
        # request X-ray (observability/tracectx.py): the trace this
        # request's queue-wait/prefill/decode spans land under.  Minted
        # at submit() when tracing is on and none was handed in (the
        # HTTP route passes the client's traceparent-derived context).
        self.trace = trace
        self.admit_t: Optional[float] = None
        self._chunk_t0: Optional[float] = None
        self._chunk_unix: Optional[float] = None
        self._chunk_tokens = 0

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    # -- batcher side -------------------------------------------------------
    def _span(self, name: str, start_unix: float, start_perf: float,
              dur: float, kind: str, **attrs):
        if self.trace is None:
            return
        obs_tracectx.record_span(
            name, self.trace.trace_id, obs_tracectx.new_span_id(),
            self.trace.span_id, start_unix, start_perf, dur, kind=kind,
            attrs=attrs or None)

    def _flush_decode_chunk(self, now: float):
        """Emit the accumulated decode-chunk span (a window of up to
        _DECODE_CHUNK_TOKENS tokens) — mid-decode stalls then show as a
        long chunk instead of vanishing into one request-wide span."""
        if self.trace is None or self._chunk_t0 is None \
                or self._chunk_tokens == 0:
            return
        self._span("serving.decode", self._chunk_unix, self._chunk_t0,
                   now - self._chunk_t0, "decode",
                   tokens=self._chunk_tokens)
        self._chunk_t0 = None
        self._chunk_tokens = 0

    def _note_token(self, now: float):
        if self.trace is None:
            return
        if self._chunk_t0 is None:
            self._chunk_t0 = now
            self._chunk_unix = time.time()
        self._chunk_tokens += 1
        if self._chunk_tokens >= _DECODE_CHUNK_TOKENS:
            self._flush_decode_chunk(time.perf_counter())

    def _finish(self, status: str, error: Optional[str] = None):
        if self._done.is_set():      # terminal exactly once (a stop()
            return                   # after loop exit must not recount)
        self.status = status
        self.error = error
        self.finish_t = time.perf_counter()
        _m_requests.labels(status=status).inc()
        if self.trace is not None:
            self._flush_decode_chunk(self.finish_t)
            self._span("serving.retire", time.time(), self.finish_t,
                       0.0, "marker", status=status)
            # the ROOT span: the whole request, submit -> terminal
            obs_tracectx.record_span(
                "serving.request", self.trace.trace_id,
                self.trace.span_id, None, self.submit_unix,
                self.submit_t, self.finish_t - self.submit_t,
                kind="request",
                attrs={"status": status, "tokens": len(self.tokens),
                       "prompt_len": len(self.prompt),
                       **({"error": error[:120]} if error else {})})
            self._maybe_capture_slo()
        self._done.set()

    def _maybe_capture_slo(self):
        """Flight-style capture keyed by trace id when this request
        breached the serving_p99_budget_ms SLO (TTFT or per-token) —
        the evidence survives span-store eviction and is served by
        GET /trace/<id>."""
        budget_ms = float(flags.get_flag("serving_p99_budget_ms"))
        if budget_ms <= 0 or self.status != "ok" \
                or self.first_token_t is None:
            return
        ttft_ms = (self.first_token_t - self.submit_t) * 1e3
        per_tok_ms = None
        if len(self.tokens) > 1 and self.finish_t is not None:
            per_tok_ms = ((self.finish_t - self.first_token_t)
                          / (len(self.tokens) - 1)) * 1e3
        if ttft_ms > budget_ms or (per_tok_ms is not None
                                   and per_tok_ms > budget_ms):
            obs_tracectx.capture(
                self.trace.trace_id, "slo_breach",
                budget_ms=budget_ms, ttft_ms=round(ttft_ms, 3),
                per_token_ms=None if per_tok_ms is None
                else round(per_tok_ms, 3))

    # -- client side --------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until terminal; returns the response document (also
        the /serving/generate body).  Raises TimeoutError if the
        request is still in flight after `timeout`."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request not finished after {timeout}s "
                f"(status {self.status})")
        ttft = (None if self.first_token_t is None
                else self.first_token_t - self.submit_t)
        total = (None if self.finish_t is None
                 else self.finish_t - self.submit_t)
        doc = {"status": self.status, "tokens": list(self.tokens),
               "n_tokens": len(self.tokens),
               "error": self.error,
               "ttft_s": ttft, "latency_s": total}
        if self.trace is not None:
            doc["trace_id"] = self.trace.trace_id
        return doc


class ContinuousBatcher:
    """Single decode loop fronting a :class:`DecodeEngine`.

    ``start()`` spawns the loop thread; ``submit()`` is thread-safe and
    returns a :class:`ServingRequest` future.  ``begin_drain()`` (or
    SIGTERM via :meth:`install_signal_handlers`) stops admission,
    sheds the queue with explicit ``drained`` responses, finishes the
    in-flight sequences and — with ``stop=True`` — exits the loop.
    """

    def __init__(self, engine: DecodeEngine,
                 queue_limit: Optional[int] = None):
        self.engine = engine
        self.queue_limit = int(
            queue_limit if queue_limit is not None
            else flags.get_flag("serving_queue_limit"))
        self._queue: List[ServingRequest] = []
        self._slots: Dict[int, ServingRequest] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._draining = False
        self._stop_after_drain = False
        # set by the SIGTERM handler INSTEAD of calling begin_drain
        # directly: a handler runs on the main thread at an arbitrary
        # bytecode boundary — possibly inside submit()'s lock — so it
        # must touch nothing but this plain flag (no locks, no Events);
        # the loop honors it at the next decode-step boundary
        self._drain_requested = False
        self._old_handlers: Dict[int, object] = {}
        self.started_t: Optional[float] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("batcher already running")
        self._stop = False
        self._draining = False
        self._stop_after_drain = False
        self._drain_requested = False
        self.started_t = time.time()
        self._thread = threading.Thread(
            target=self._loop, name="serving-batcher", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0):
        """Hard stop: abort in-flight requests with explicit 'drained'
        responses and join the loop thread."""
        import warnings
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
            if t.is_alive():
                # keep the reference: `running` must stay True so a
                # second loop thread can't be started over an engine
                # the wedged one still owns
                warnings.warn(
                    f"serving batcher loop did not exit within "
                    f"{timeout}s; engine may be wedged in a dispatch",
                    RuntimeWarning, stacklevel=2)
                return
        self._thread = None
        self._fail_pending("drained", "serving stopped")
        _m_draining.set(0.0)
        obs_goodput.note_drain_end()

    def begin_drain(self, stop: bool = True):
        """SIGTERM semantics (the preemption contract, honored at
        the decode-step boundary): no new admissions, queued requests
        get explicit 'drained' responses, active sequences finish."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._stop_after_drain = stop
        _m_draining.set(1.0)
        _m_drains.inc()
        obs_goodput.note_drain_begin()
        obs_flight.record("serving", "drain_begin",
                          queued=self.queue_depth,
                          active=len(self._slots))
        obs_journal.emit("serving", "drain_begin",
                         queued=self.queue_depth,
                         active=len(self._slots), stop=stop)
        self._shed_queue("drained", "serving is draining (SIGTERM)")
        self._wake.set()

    def install_signal_handlers(self):
        """SIGTERM -> drain at the next decode-step boundary, chaining
        any previous handler (the Trainer's preemption hook coexists).
        The handler itself only sets a plain flag — it may interrupt
        the main thread INSIDE one of our own lock sections, where
        calling begin_drain (or any threading primitive) would
        deadlock.  Main thread only — elsewhere this degrades to no
        signal-driven drain, like Trainer._install_preemption_handlers."""
        if threading.current_thread() is not threading.main_thread():
            return

        def _on_term(signum, frame):
            self._drain_requested = True
            old = self._old_handlers.get(signum)
            if callable(old):
                old(signum, frame)

        self._old_handlers[signal.SIGTERM] = signal.signal(
            signal.SIGTERM, _on_term)

    def restore_signal_handlers(self):
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers.clear()

    # -- admission ----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               eos_id: Optional[int] = None,
               trace: Optional[obs_tracectx.TraceContext] = None
               ) -> ServingRequest:
        """Admit one request (bounded queue) — raises ShedError past
        serving_queue_limit or while draining.  ``trace`` carries an
        upstream traceparent-derived context (the HTTP route); without
        one, a fresh trace is minted per request when request_tracing
        is on — EVERY admitted request has a retrievable X-ray."""
        chaos.trigger("serving.admit", ConnectionAbortedError)
        if not self.running:
            raise RuntimeError("serving batcher is not running")
        if max_new_tokens is None:
            max_new_tokens = int(flags.get_flag("serving_max_new_tokens"))
        if trace is None:
            # a CHILD of any ambient context, never the ambient context
            # itself: two submits under one traced scope must not share
            # a root span id (span-id dedupe would collapse their
            # roots); no ambient -> a fresh trace per request
            trace = obs_tracectx.start_trace(
                "serving.request", parent=obs_tracectx.current())
        req = ServingRequest(prompt, max_new_tokens, temperature, eos_id,
                             trace=trace)
        # validate NOW so a hopeless request is an error at the door,
        # not a dead slot later (bucket fit AND room to generate)
        self.engine.validate_prompt(len(req.prompt))
        with self._lock:
            # _drain_requested too: between SIGTERM
            # landing and the next decode-step boundary the batcher is
            # already doomed — admitting here would queue-then-shed,
            # making a failing-over router (or client) WAIT on a dying
            # replica's queue instead of getting the synchronous
            # `drained` answer that triggers retry-elsewhere
            if self._draining or self._stop or self._drain_requested:
                req._finish("drained", "serving is draining")
                raise ShedError("serving is draining", self.queue_depth,
                                draining=True)
            if len(self._queue) >= self.queue_limit:
                req._finish("shed",
                            f"queue at limit {self.queue_limit}")
                raise ShedError(
                    f"serving queue at limit ({self.queue_limit})",
                    len(self._queue))
            self._queue.append(req)
            _m_queue_depth.set(len(self._queue))
        self._wake.set()
        return req

    # -- loop ---------------------------------------------------------------
    def _shed_queue(self, status: str, msg: str):
        with self._lock:
            shed, self._queue = self._queue, []
            _m_queue_depth.set(0)
        for req in shed:
            req._finish(status, msg)

    def _fail_pending(self, status: str, msg: str):
        self._shed_queue(status, msg)
        with self._lock:
            slots, self._slots = dict(self._slots), {}
        for slot, req in slots.items():
            self.engine.retire_slot(slot)
            if not req.done():
                req._finish(status, msg)
        self._publish_gauges()

    def _publish_gauges(self):
        _m_occupancy.set(self.engine.occupancy)
        _m_active.set(float(len(self._slots)))
        _m_queue_depth.set(float(len(self._queue)))

    def _admit_at_boundary(self):
        """Backfill free slots from the queue — the continuous-batching
        moment: this runs BETWEEN decode steps, never mid-dispatch."""
        while True:
            with self._lock:
                if self._draining or not self._queue:
                    return
                free = self.engine.free_slots()
                if not free:
                    return
                req = self._queue.pop(0)
                _m_queue_depth.set(len(self._queue))
                slot = free[0]
            req.admit_t = time.perf_counter()
            # X-ray: how long the request sat behind admission control
            req._span("serving.queue_wait", req.submit_unix,
                      req.submit_t, req.admit_t - req.submit_t, "queue",
                      queue_depth=len(self._queue))
            t_pf_unix, t_pf = time.time(), time.perf_counter()
            try:
                # activate the request's context for the dispatch: the
                # engine's prefill histogram gains this trace's
                # exemplar, and a lazy bucket compile inside
                # start_sequence lands INSIDE this request's timeline
                with obs_tracectx.activate(req.trace):
                    first = self.engine.start_sequence(
                        slot, req.prompt, temperature=req.temperature)
            except Exception as e:
                # a prefill that failed midway may have written part of
                # the shared slabs, and the exception type cannot tell a
                # failure before the replay from one after it.
                # Validation errors were already rejected at submit(), so
                # recover like a decode failure: fail in-flight requests
                # explicitly and zero the cache via engine.reset()
                req._finish("error", f"prefill failed: {e!r}")
                obs_flight.record("serving", "prefill_error",
                                  error=repr(e)[:200])
                self._fail_pending_active(e)
                continue
            req.first_token_t = time.perf_counter()
            req._span("serving.prefill", t_pf_unix, t_pf,
                      req.first_token_t - t_pf, "prefill",
                      bucket=self.engine.bucket_for(len(req.prompt)),
                      slot=slot)
            from ..observability import perfscope as obs_perfscope
            if obs_perfscope.enabled():
                obs_perfscope.note_phase(
                    "serving.prefill", req.first_token_t - t_pf,
                    trace_id=(req.trace.trace_id
                              if req.trace else None))
            with obs_tracectx.activate(req.trace):
                # TTFT exemplar: the p99 bucket links to THIS trace
                _m_ttft.observe(req.first_token_t - req.submit_t)
            req.tokens.append(first)
            _m_tokens.inc()
            with self._lock:
                self._slots[slot] = req
            if self._maybe_finish(slot, req, first):
                continue
            self._publish_gauges()

    def _maybe_finish(self, slot: int, req: ServingRequest,
                      token: int) -> bool:
        full = self.engine.remaining_capacity(slot) <= 0
        hit_eos = req.eos_id is not None and token == req.eos_id
        if (len(req.tokens) >= req.max_new_tokens or hit_eos or full):
            self.engine.retire_slot(slot)
            with self._lock:
                self._slots.pop(slot, None)
            req._finish("ok")
            self._publish_gauges()
            return True
        return False

    def _loop(self):
        # try/finally: even an unexpected exception outside the decode
        # try-block (admission, bookkeeping) must not strand pending
        # requests in 'pending' — every request terminates explicitly
        try:
            self._loop_body()
        finally:
            self._fail_pending("drained", "serving loop exited")

    def _loop_body(self):
        while True:
            if self._stop:
                break
            if self._drain_requested and not self._draining:
                # SIGTERM landed since the last boundary (the handler
                # only sets the flag — see install_signal_handlers)
                self.begin_drain(stop=True)
            self._admit_at_boundary()
            with self._lock:
                active = dict(self._slots)
                drain_done = self._draining and not active
            if drain_done:
                if self._stop_after_drain:
                    obs_journal.emit("serving", "drain_complete")
                    obs_goodput.note_drain_end()
                    break
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            if not active:
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            t0 = time.perf_counter()
            try:
                chaos.trigger("serving.decode_step")
                out = self.engine.decode_step()
            except Exception as e:
                # one bad step must not wedge the plane: fail the
                # in-flight requests EXPLICITLY and keep serving
                obs_flight.record("serving", "decode_step_error",
                                  error=repr(e)[:200])
                self._fail_pending_active(e)
                continue
            now = time.perf_counter()
            dt = now - t0
            _m_step.observe(dt)
            from ..observability import perfscope as obs_perfscope
            if obs_perfscope.enabled():
                # exemplar: any slot that decoded in this step links
                # the regression verdict back to a retrievable trace
                tid = next((r.trace.trace_id for r in active.values()
                            if r.trace is not None), None)
                obs_perfscope.note_phase("serving.decode_step", dt,
                                         trace_id=tid)
            for slot, tok in out.items():
                req = active.get(slot)
                if req is None:
                    continue
                req.tokens.append(tok)
                _m_tokens.inc()
                if req.trace is not None:
                    # per-slot exemplar: the per-token p99 bucket links
                    # to the trace that was decoding in that step
                    with obs_tracectx.activate(req.trace):
                        _m_token_latency.observe(dt)
                    req._note_token(t0)
                else:
                    _m_token_latency.observe(dt)
                self._maybe_finish(slot, req, tok)
            self._publish_gauges()

    def _fail_pending_active(self, exc: Exception):
        with self._lock:
            slots, self._slots = dict(self._slots), {}
        for slot, req in slots.items():
            self.engine.retire_slot(slot)
            req._finish("error", f"decode step failed: {exc!r}")
        self.engine.reset()
        self._publish_gauges()

    # -- status (the /serving route body) -----------------------------------
    def status_doc(self) -> dict:
        return {
            "running": self.running,
            "draining": self._draining,
            "queue_depth": self.queue_depth,
            "queue_limit": self.queue_limit,
            "active_slots": len(self._slots),
            "max_batch": self.engine.max_batch,
            "occupancy": round(self.engine.occupancy, 4),
            "prompt_buckets": list(self.engine.prompt_buckets),
            "max_len": self.engine.max_len,
            "started_unix": self.started_t,
        }

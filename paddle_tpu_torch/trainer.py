"""High-level Trainer with an event loop.

Counterpart of paddle_tpu/trainer.py (the reference's
python/paddle/fluid/contrib/trainer.py): the event classes (:143-166),
``CheckpointConfig`` (:167) and ``Trainer`` (:179) with its constructor,
``train`` (:363), ``test`` (:865), ``save_params``,
``save_inference_model`` and ``stop``.  The same event-driven loop
(BeginEpoch / BeginStep / EndStep / EndEpoch), gradient accumulation
through ``minimize(accumulate_steps=k)``, a ``param_path`` to start
from, async device prefetch of the feeds (``prefetch_depth``), the
numeric guard with its ``raise`` and ``skip_step`` policies and its
circuit breaker, the SIGTERM/SIGINT stop at a step boundary, the
``trainer.step`` chaos site, and the ``trainer_*`` metrics, flight and
journal records and per-step X-ray traces.  Each step's fetches are read
back synchronized, as the reference's ``block_until_ready`` +
``fetch_numpy`` does.

Refused with NotImplementedError, naming their queue items: checkpoints
(``checkpoint_config``, and ``nan_policy="rollback"``, which restores
one: ROADMAP A.8) and more than one trainer (``mesh``, and
``PADDLE_TRAINING_ROLE=TRAINER`` with ``PADDLE_TRAINERS`` > 1: A.7).
The reference's seams to modules the port lacks are left out (A.9): the
chrome-trace spans, the HTTP server, the runlog, alerts, tensor stats,
the cost-model MFU gauges, the device-memory sampling, the restart gauge
and the perfscope and goodput step notes.
"""
from __future__ import annotations

import os
import signal
import time
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import io as pio
from . import optimizer as optim
from .core import flags
from .core.enforce import check_arg
from .framework import unique_name
from .framework.executor import Executor, Scope, to_numpy
from .framework.program import Program, program_guard
from .observability import flight as obs_flight
from .observability import journal as obs_journal
from .observability import metrics as obs_metrics
from .observability import tracectx as obs_tracectx
from .resilience import chaos, guard as rguard

# --- telemetry: the training-loop view (throughput, loss health) --------
_m_steps = obs_metrics.counter(
    "trainer_steps_total", "Optimizer steps taken by Trainer.train.")
_m_epochs = obs_metrics.counter(
    "trainer_epochs_total", "Epochs completed by Trainer.train.")
_m_step_seconds = obs_metrics.histogram(
    "trainer_step_seconds",
    "Wall time of one Trainer train step (reader next + feed build + "
    "device step + metric fetch) — the sum the anatomy histograms "
    "below decompose.")
# step-time anatomy: data_wait + host + device ~= trainer_step_seconds
_m_data_wait_seconds = obs_metrics.histogram(
    "trainer_data_wait_seconds",
    "Input-pipeline wait per step: reader next() + feed build.  "
    "data_wait >> host+device = input-bound; grow reader.buffered or "
    "prefetch_depth.")
_m_host_seconds = obs_metrics.histogram(
    "trainer_host_seconds",
    "Host time of one step's Executor.run: the eager ops' launches "
    "(the host waits for the device only where an op reads back).")
_m_device_seconds = obs_metrics.histogram(
    "trainer_device_seconds",
    "Time from the end of Executor.run to the fetched metrics on the "
    "host: the device finishing the step's queued work plus the "
    "device->host copy.")
_m_examples_per_sec = obs_metrics.gauge(
    "trainer_examples_per_sec",
    "Training throughput of the last step in examples/s (tokens/s = "
    "this x sequence length).")
_m_loss = obs_metrics.gauge(
    "trainer_loss", "Last fetched training loss.")
_m_loss_ema = obs_metrics.gauge(
    "trainer_loss_ema",
    "Exponential moving average (decay 0.9) of the training loss.")
_m_skipped = obs_metrics.counter(
    "trainer_skipped_steps_total",
    "Bad steps dropped from the health statistics "
    "(nan_policy=skip_step).")
_m_preemptions = obs_metrics.counter(
    "trainer_preemptions_total",
    "SIGTERM/SIGINT preemptions honored at a step boundary (clean "
    "exit).")
_EMA_DECAY = 0.9
# input-bound warning needs a few steps of evidence: the first step's
# warm-up dwarfs everything and short smoke runs must stay warning-free
_INPUT_BOUND_MIN_STEPS = 8
# ... and an absolute floor: micro-programs whose whole step is sub-ms
# have data-wait "fractions" that are all noise, not a pipeline problem
_INPUT_BOUND_MIN_WAIT_S = 0.002
# exhaustion sentinel for the loop: a buggy reader yielding None must
# reach the feeder and fail loudly, not end the epoch early
_END_OF_DATA = object()


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """ref contrib/trainer.py:100.  The port's Trainer refuses it until
    checkpoints are ported (ROADMAP queue A.8)."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3,
                 epoch_interval: int = 1, step_interval: int = 10):
        self.checkpoint_dir = checkpoint_dir or os.getcwd()
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(1, int(epoch_interval))
        self.step_interval = max(1, int(step_interval))


class Trainer:
    """train_func builds (loss, [metrics...]) in the default program and
    returns either loss or [loss, metric, ...]; optimizer_func returns
    the Optimizer.  ``place`` None means the card (CUDAPlace(0))."""

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 place=None, param_path: Optional[str] = None,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 mesh=None, accumulate_steps: int = 1):
        if checkpoint_config is not None:
            raise NotImplementedError(
                "Trainer checkpoint_config: checkpoints are not ported yet "
                "(ROADMAP queue A.8, incubate/checkpoint.py)")
        if mesh is not None:
            raise NotImplementedError(
                "Trainer mesh: the parallel planes are not ported yet "
                "(ROADMAP queue A.7)")
        self._dist_transpile_if_necessary()
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()
        # the epoch train() starts from (a resumed checkpoint's, in the
        # reference)
        self.epoch_offset = 0
        # set when train() stopped at a step boundary for SIGTERM/SIGINT
        self.preempted = False
        # fresh name namespace so a re-constructed Trainer reproduces the
        # same parameter names (a saved param_path binds by them)
        with unique_name.guard(), \
                program_guard(self.train_program, self.startup_program):
            ret = train_func()
            if isinstance(ret, (list, tuple)):
                self.loss = ret[0]
                self.metrics = list(ret[1:])
            else:
                self.loss = ret
                self.metrics = []
            opt = optimizer_func()
            check_arg(isinstance(opt, optim.Optimizer),
                      "optimizer_func must return an Optimizer")
            opt.minimize(self.loss, accumulate_steps=accumulate_steps)
        self.test_program = self.train_program.clone(for_test=True)
        self.exe = Executor(place, scope=self.scope)
        self.exe.run(self.startup_program)
        if param_path:
            pio.load_persistables(self.exe, param_path,
                                  main_program=self.train_program)

    @staticmethod
    def _dist_transpile_if_necessary():
        """ref contrib/trainer.py _dist_transpile_if_necessary: the same
        PADDLE_* env contract.  One trainer runs as is; more need the
        parallel planes (ROADMAP queue A.7); PSERVER has no role here."""
        role = os.environ.get("PADDLE_TRAINING_ROLE")
        if not role:
            return
        if role == "PSERVER":
            raise RuntimeError(
                "PADDLE_TRAINING_ROLE=PSERVER: there are no parameter "
                "servers — run every process as TRAINER; gradients "
                "aggregate via collectives")
        if role != "TRAINER":
            raise RuntimeError(
                f"unknown PADDLE_TRAINING_ROLE {role!r}: expected "
                f"TRAINER or PSERVER (ref contrib/trainer.py "
                f"_dist_transpile_if_necessary)")
        trainers = int(os.environ.get("PADDLE_TRAINERS", "1"))
        if trainers > 1:
            raise NotImplementedError(
                f"PADDLE_TRAINERS={trainers}: more than one trainer needs "
                f"the parallel planes, not ported yet (ROADMAP queue A.7)")

    # -- loops -------------------------------------------------------------
    def train(self, num_epochs: int, event_handler: Callable,
              reader: Callable, feed_order: Sequence[str],
              prefetch_depth: Optional[int] = None):
        from .data_feeder import DataFeeder
        from .reader.decorator import DeviceBatch, device_prefetch
        block = self.train_program.global_block()
        feed_vars = [block.var(n) for n in feed_order]
        feeder = DataFeeder(feed_vars)
        fetch = [self.loss] + self.metrics
        self.preempted = False
        health = rguard.NumericGuard(ema_decay=_EMA_DECAY)
        if health.policy == "rollback":
            raise NotImplementedError(
                "nan_policy='rollback' restores a checkpoint; checkpoints "
                "are not ported yet (ROADMAP queue A.8)")
        # async input pipeline: a background thread builds feeds and
        # stages them on the device while the current step runs, so the
        # step's data wait is only the part it could not hide
        depth = int(flags.get_flag("prefetch_depth")
                    if prefetch_depth is None else prefetch_depth)
        prefetch = depth > 0
        device = self.exe.place.torch_device()
        if prefetch:
            reader = device_prefetch(reader, size=depth, feeder=feeder,
                                     device=device)
        stop = self._install_preemption_handlers()
        # step anatomy accumulators for the input-bound diagnosis
        anatomy = {"data_wait": 0.0, "step": 0.0, "n": 0, "warned": False,
                   "prefetch": prefetch}
        batches = None
        try:
            for epoch_id in range(self.epoch_offset, num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                batches = iter(reader())
                step_id = -1
                while True:
                    # --- data wait: reader next + feed build ----------
                    t0 = time.perf_counter()
                    batch = next(batches, _END_OF_DATA)
                    data_wait = time.perf_counter() - t0
                    if batch is _END_OF_DATA:
                        break
                    step_id += 1
                    begin = BeginStepEvent(epoch_id, step_id)
                    # user handler time is neither data wait nor
                    # host/device: excluded from the step clock
                    th0 = time.perf_counter()
                    event_handler(begin)
                    handler_s = time.perf_counter() - th0
                    if isinstance(batch, DeviceBatch):
                        # prefetched: feed already built AND on device
                        feed = batch.feed
                        n_examples = batch.size
                        donate = True
                    else:
                        tf = time.perf_counter()
                        feed = feeder.feed(batch)
                        data_wait += time.perf_counter() - tf
                        n_examples = len(batch)
                        donate = False
                    # every step gets its own X-ray trace (None when
                    # request_tracing is off)
                    step_ctx = obs_tracectx.start_trace("trainer.step")
                    with obs_tracectx.activate(step_ctx), \
                            chaos.fault_point("trainer.step"):
                        # --- host: the eager step ---------------------
                        th = time.perf_counter()
                        fetched = self.exe.run(
                            self.train_program, feed=feed,
                            fetch_list=fetch if begin.fetch_metrics
                            else [], return_numpy=False,
                            donate_feeds=donate)
                        host_s = time.perf_counter() - th
                        # --- device: synchronize + D2H copy -----------
                        td = time.perf_counter()
                        if fetched:
                            if device.type == "cuda":
                                torch.cuda.synchronize(device)
                            metrics = [to_numpy(v) for v in fetched]
                        else:
                            metrics = []
                        device_s = time.perf_counter() - td
                    metrics = chaos.poison("trainer.step", metrics)
                    dt = time.perf_counter() - t0 - handler_s
                    _m_steps.inc()
                    with obs_tracectx.activate(step_ctx):
                        # step-latency exemplars link the histogram's
                        # slow buckets back to this step's trace
                        _m_step_seconds.observe(dt)
                        _m_data_wait_seconds.observe(data_wait)
                        _m_host_seconds.observe(host_s)
                        if fetched:
                            _m_device_seconds.observe(device_s)
                    if step_ctx is not None:
                        self._record_step_spans(
                            step_ctx, epoch_id, step_id, t0, dt,
                            data_wait, th, host_s, td, device_s)
                    self._note_anatomy(anatomy, data_wait, dt)
                    if dt > 0:
                        _m_examples_per_sec.set(n_examples / dt)
                    if metrics:
                        loss_val = float(np.mean(np.asarray(metrics[0])))
                        if not self._guard_step(health, loss_val):
                            metrics = []    # unhealthy: keep it out of
                            loss_val = None  # EMA/gauges and the event
                    if metrics:
                        _m_loss.set(loss_val)
                        _m_loss_ema.set(health.ema)
                    event_handler(EndStepEvent(epoch_id, step_id, metrics))
                    if stop["signum"] is not None:
                        # step boundary: clean exit — the preemption
                        # contract (SIGTERM from the scheduler)
                        self._emergency_stop(epoch_id, step_id, stop)
                        return
                _m_epochs.inc()
                event_handler(EndEpochEvent(epoch_id))
                if stop["signum"] is not None:
                    self._emergency_stop(epoch_id + 1, -1, stop)
                    return
        except (rguard.BadStepError, rguard.CircuitBreakerOpen):
            raise               # flight bundle already dumped at the trip
        except Exception as e:
            # post-mortem artifact for ANY uncaught training failure
            obs_flight.dump("trainer_exception",
                            extra={"error": repr(e)[:500]})
            raise
        finally:
            # a prefetch thread ends with its iterator: stop and join it
            # whether the epoch ended, the reader raised or a signal
            # stopped the run
            close = getattr(batches, "close", None)
            if close is not None:
                close()
            self._restore_preemption_handlers(stop)

    def _note_anatomy(self, anatomy: Dict, data_wait: float, dt: float):
        """Accumulate the step anatomy and warn ONCE per train() when
        the input pipeline dominates: cumulative data-wait above
        ``input_bound_warn_fraction`` of cumulative step time after
        enough steps for the evidence to mean something.  Under device
        prefetch the measured wait is already the part the queue could
        not hide; the advice then is to deepen the pipeline."""
        anatomy["data_wait"] += data_wait
        anatomy["step"] += dt
        anatomy["n"] += 1
        frac = float(flags.get_flag("input_bound_warn_fraction"))
        if (frac > 0 and not anatomy["warned"]
                and anatomy["n"] >= _INPUT_BOUND_MIN_STEPS
                and anatomy["step"] > 0
                and anatomy["data_wait"]
                > _INPUT_BOUND_MIN_WAIT_S * anatomy["n"]
                and anatomy["data_wait"] > frac * anatomy["step"]):
            anatomy["warned"] = True
            pct = 100.0 * anatomy["data_wait"] / anatomy["step"]
            if anatomy.get("prefetch"):
                what = ("un-hidden input wait (reader slower than the "
                        "device even with async device prefetch)")
                fix = ("grow prefetch_depth or move decoding off the "
                       "training host")
            else:
                what = "data wait (reader next + feed build)"
                fix = ("enable async device prefetch (prefetch_depth "
                       "flag / reader.device_prefetch) or grow "
                       "reader.buffered()")
            warnings.warn(
                f"trainer is input-bound: {what} is {pct:.0f}% of step "
                f"time over {anatomy['n']} steps (threshold "
                f"{100 * frac:.0f}%) — {fix}", RuntimeWarning,
                stacklevel=3)

    def _record_step_spans(self, step_ctx, epoch_id, step_id, t0, dt,
                           data_wait, th, host_s, td, device_s):
        """One X-ray trace per train step: the root span plus the
        data-wait/host/device anatomy as children, addressable by trace
        id (tracectx.spans_for)."""
        now_unix = time.time()
        root = step_ctx

        def child(name, start_perf, dur, kind):
            obs_tracectx.record_span(
                name, root.trace_id, obs_tracectx.new_span_id(),
                root.span_id, now_unix - (time.perf_counter()
                                          - start_perf),
                start_perf, dur, kind=kind)
        child("trainer.data_wait", t0, data_wait, "input")
        child("trainer.host", th, host_s, "dispatch")
        child("trainer.device", td, device_s, "device")
        obs_tracectx.record_span(
            "trainer.step", root.trace_id, root.span_id, None,
            now_unix - (time.perf_counter() - t0), t0, dt,
            kind="step", attrs={"epoch": epoch_id, "step": step_id})

    # -- resilience plumbing -----------------------------------------------
    def _guard_step(self, health: "rguard.NumericGuard",
                    loss_val: float) -> bool:
        """Apply the numeric-guard policy to one fetched loss.  True =
        healthy; False = bad step absorbed (skip_step).  Raises on policy
        'raise' and always on an open circuit breaker."""
        verdict = health.observe(loss_val)  # raises CircuitBreakerOpen
        if verdict == rguard.OK:
            return True
        attr = health.last_attribution
        if health.policy == "raise":
            obs_flight.dump("numeric_guard",
                            extra={"verdict": verdict, "loss": loss_val,
                                   "attribution": attr})
            raise rguard.BadStepError(
                f"numeric guard: {verdict} loss {loss_val!r} [{attr}] "
                f"(nan_policy=raise)")
        _m_skipped.inc()
        warnings.warn(
            f"numeric guard: {verdict} loss {loss_val!r} [{attr}] — "
            f"step dropped from the health statistics "
            f"(nan_policy=skip_step)", RuntimeWarning, stacklevel=3)
        return False

    def _install_preemption_handlers(self) -> Dict:
        """SIGTERM/SIGINT set a flag honored at the next step boundary
        (clean exit).  Returns the stop token; signal handlers only exist
        in the main thread, so elsewhere this degrades to no preemption
        handling."""
        stop: Dict = {"signum": None, "old": {}}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                stop["old"][sig] = signal.signal(
                    sig, lambda signum, frame: stop.update(signum=signum))
            except ValueError:      # not the main thread
                break
        return stop

    def _restore_preemption_handlers(self, stop: Dict):
        for sig, old in stop["old"].items():
            signal.signal(sig, old)

    def _emergency_stop(self, epoch_id: int, step_id: int, stop: Dict):
        _m_preemptions.inc()
        self.preempted = True
        obs_flight.record("trainer", "preempted",
                          signum=stop["signum"], epoch=epoch_id,
                          step=step_id)
        obs_journal.emit("trainer", "preempted", signum=stop["signum"],
                         epoch=epoch_id, step=step_id)
        obs_flight.dump("preemption",
                        extra={"signum": stop["signum"],
                               "epoch": epoch_id, "step": step_id})

    def test(self, reader: Callable, feed_order: Sequence[str]):
        """The mean of each fetch over the reader's batches.  Side-effect
        free: the for_test clone still holds the backward and optimizer
        (and accumulation) ops, so it is pruned to the forward slice that
        produces the fetches, and no update runs."""
        from .data_feeder import DataFeeder
        fetch = [self.loss] + self.metrics
        key = tuple(feed_order)
        if getattr(self, "_test_pruned_key", None) != key:
            self._test_pruned = self.test_program.prune(
                key, [f.name for f in fetch])
            self._test_pruned_key = key
        test_prog = self._test_pruned
        block = test_prog.global_block()
        feed_vars = [block.var(n) for n in feed_order]
        feeder = DataFeeder(feed_vars)
        totals = None
        count = 0
        for batch in reader():
            vals = self.exe.run(test_prog,
                                feed=feeder.feed(batch), fetch_list=fetch)
            vals = [np.asarray(v) for v in vals]
            totals = vals if totals is None else [
                t + v for t, v in zip(totals, vals)]
            count += 1
        check_arg(count > 0, "test reader yielded no batches")
        return [t / count for t in totals]

    def save_params(self, param_path: str):
        pio.save_persistables(self.exe, param_path,
                              main_program=self.train_program)

    def save_inference_model(self, param_path: str,
                             feeded_var_names: Sequence[str],
                             target_vars: Sequence):
        pio.save_inference_model(param_path, feeded_var_names, target_vars,
                                 self.exe, main_program=self.train_program)

    def stop(self):
        self.exe.close()

"""Numeric health guard: NaN/Inf + EMA loss-spike detection with a
policy and a circuit breaker.

The reference only ever *detects* (FLAGS_check_nan_inf raises,
operator.cc:829); this guard adds the recovery policy the distributed
era needs: ``raise`` (the reference's behavior), ``skip_step`` (drop
the step from the health statistics and keep going — right when the
corruption is transient, e.g. a poisoned fetch), or ``rollback``
(restore the newest valid checkpoint via incubate.checkpoint and
continue — right when the parameters themselves may be poisoned).
Whatever the policy, K consecutive bad steps open the circuit breaker
and training stops: a persistently-diverging run must not silently
rollback-loop forever.

A copy of paddle_tpu/resilience/guard.py.  Its one tie to a module the
port lacks, tensorstats' first-bad-variable attribution, answers
"unattributed" here (ROADMAP queue A.9); the port's Trainer refuses the
rollback policy, which needs checkpoints (A.8).

The guard is pure bookkeeping — the *actions* (rollback, raise) are the
Trainer's; ``observe()`` returns a verdict and raises only for the
breaker.  Policy/limit default from the ``nan_policy`` /
``bad_step_limit`` flags so one env var flips a fleet.
"""
from __future__ import annotations

import math
from typing import Optional

from ..core import flags
from ..observability import flight as obs_flight
from ..observability import journal as obs_journal
from ..observability import metrics as obs_metrics

_m_bad_steps = obs_metrics.counter(
    "trainer_bad_steps_total",
    "Steps whose fetched loss failed the numeric guard, by reason "
    "(nan = NaN/Inf, spike = EMA loss-spike) and first-bad-variable "
    "attribution ('unattributed' in the port: tensorstats is not "
    "ported).",
    ("reason", "first_var"))


def _attribution():
    """(label, detail) of the first bad variable: tensorstats' answer in
    the reference, which the port does not have yet."""
    return "unattributed", "unattributed(tensor stats not ported)"

POLICIES = ("raise", "skip_step", "rollback")

OK = "ok"
NAN = "nan"
SPIKE = "spike"


class BadStepError(RuntimeError):
    """A guarded step failed and the policy is 'raise' (or recovery was
    impossible)."""


class CircuitBreakerOpen(RuntimeError):
    """bad_step_limit consecutive bad steps: recovery is not converging;
    stop instead of rollback-looping forever."""


class NumericGuard:
    """Feed every fetched loss through observe(); it returns OK / NAN /
    SPIKE and trips CircuitBreakerOpen after `bad_step_limit`
    consecutive non-OK verdicts."""

    def __init__(self, policy: Optional[str] = None,
                 bad_step_limit: Optional[int] = None,
                 ema_decay: float = 0.9,
                 spike_factor: float = 10.0,
                 warmup_steps: int = 5):
        self.policy = policy if policy is not None \
            else str(flags.get_flag("nan_policy"))
        if self.policy not in POLICIES:
            raise ValueError(
                f"nan_policy {self.policy!r} not one of {POLICIES}")
        self.bad_step_limit = bad_step_limit if bad_step_limit is not None \
            else int(flags.get_flag("bad_step_limit"))
        self.ema_decay = ema_decay
        # spike_factor <= 0 disables spike detection (NaN/Inf always on);
        # warmup_steps healthy observations must seed the EMA first, so
        # the noisy first losses of a fresh model aren't "spikes"
        self.spike_factor = spike_factor
        self.warmup_steps = warmup_steps
        self.ema: Optional[float] = None
        self.healthy_steps = 0
        self.consecutive_bad = 0
        # last non-OK verdict + its first-bad-var attribution detail —
        # the Trainer names these in its raise/skip/rollback log lines
        self.last_verdict: str = OK
        self.last_attribution: str = ""

    def observe(self, loss: float) -> str:
        loss = float(loss)
        verdict = OK
        if not math.isfinite(loss):
            verdict = NAN
        elif (self.spike_factor > 0 and self.ema is not None
                and self.healthy_steps >= self.warmup_steps
                and abs(loss) > self.spike_factor * (abs(self.ema) + 1e-12)):
            verdict = SPIKE
        if verdict == OK:
            self.consecutive_bad = 0
            self.healthy_steps += 1
            self.last_verdict = OK
            self.last_attribution = ""
            self.ema = loss if self.ema is None else (
                self.ema_decay * self.ema + (1 - self.ema_decay) * loss)
            return verdict
        self.consecutive_bad += 1
        # first-bad-layer attribution (the reference's tensorstats
        # answer; 'unattributed' until it is ported).  NaN verdicts
        # only: a finite-loss spike has no NaN to attribute.
        if verdict == NAN:
            label, detail = _attribution()
        else:
            label, detail = "unattributed", \
                "unattributed(finite loss spike, no NaN to attribute)"
        self.last_verdict = verdict
        self.last_attribution = detail
        _m_bad_steps.labels(reason=verdict, first_var=label).inc()
        obs_flight.record("guard", verdict, loss=loss,
                          consecutive_bad=self.consecutive_bad,
                          policy=self.policy, first_var=label,
                          attribution=detail)
        # the fleet journal carries the trip WITH its first-bad-var:
        # "what corrupted, where, under which policy" joins the
        # incident timeline next to chaos/supervisor/master events
        obs_journal.emit("guard", verdict, loss=loss,
                         consecutive_bad=self.consecutive_bad,
                         policy=self.policy, first_var=label,
                         attribution=detail)
        if 0 < self.bad_step_limit <= self.consecutive_bad:
            obs_flight.dump("circuit_breaker",
                            extra={"verdict": verdict, "loss": loss,
                                   "consecutive_bad": self.consecutive_bad,
                                   "bad_step_limit": self.bad_step_limit,
                                   "attribution": detail})
            obs_journal.emit("guard", "circuit_breaker", loss=loss,
                             consecutive_bad=self.consecutive_bad,
                             bad_step_limit=self.bad_step_limit,
                             attribution=detail)
            raise CircuitBreakerOpen(
                f"{self.consecutive_bad} consecutive bad steps (last: "
                f"{verdict}, loss={loss!r}, {detail}) >= bad_step_limit "
                f"{self.bad_step_limit}; training is not recovering")
        return verdict

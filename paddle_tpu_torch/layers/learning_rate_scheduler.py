"""In-graph learning-rate schedules (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py: the ``lr_schedule`` op :27,
``_global_step`` :87, ``_schedule`` :107 and the eight public schedules
:121-174).

A persistable int64 counter, ``@lr_global_step@``, starts at 0 (its
startup ``fill_constant``) and an ``increment_loop_counter`` op adds one
every run of the main program, so a run's lr is that of the step it
takes: 1 on the first run.  The ``lr_schedule`` op computes the lr from
the counter on the device, in f32 whatever FLAGS_amp_bf16 says, as a [1]
tensor; nothing is read back, so a schedule adds no sync to a step.  The
counter is state like any optimizer accumulator: ``run_steps`` advances
it once a step, and it is saved and reloaded with the persistables.
"""
from __future__ import annotations

import math

import torch

from ..framework import unique_name
from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable
from ..framework.registry import register_op, single_input

GLOBAL_STEP_VAR = "@lr_global_step@"

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]


def _decayed_exponent(step, attrs):
    e = step / float(attrs["decay_steps"])
    return torch.floor(e) if bool(attrs["staircase"]) else e


@register_op("lr_schedule")
def _lr_schedule(ctx, ins, attrs):
    """Step: the global step (any int or float dtype); Out: the [1] f32
    lr of attrs ``kind`` at that step, JAX's formulas op for op."""
    step = single_input(ins, "Step").to(torch.float32).reshape(())
    kind = attrs["kind"]
    if kind == "noam":
        d, warmup = float(attrs["d_model"]), float(attrs["warmup_steps"])
        s = step.clamp_min(1.0)
        lr = d ** -0.5 * torch.minimum(s ** -0.5, s * warmup ** -1.5)
    elif kind == "exponential":
        lr = float(attrs["lr"]) * float(attrs["decay_rate"]) ** \
            _decayed_exponent(step, attrs)
    elif kind == "natural_exp":
        lr = float(attrs["lr"]) * torch.exp(
            -float(attrs["decay_rate"]) * _decayed_exponent(step, attrs))
    elif kind == "inverse_time":
        lr = float(attrs["lr"]) / (
            1.0 + float(attrs["decay_rate"]) * _decayed_exponent(step,
                                                                 attrs))
    elif kind == "polynomial":
        base, decay_steps = float(attrs["lr"]), float(attrs["decay_steps"])
        end, power = float(attrs["end_lr"]), float(attrs["power"])
        if attrs["cycle"]:
            div = torch.ceil(step.clamp_min(1.0) / decay_steps)
            total = decay_steps * div.clamp_min(1.0)
        else:
            total = decay_steps
        s = (torch.minimum(step, total) if isinstance(total, torch.Tensor)
             else step.clamp_max(total))
        lr = (base - end) * (1 - s / total) ** power + end
    elif kind == "piecewise":
        values = [float(v) for v in attrs["values"]]
        lr = torch.full((), values[0], dtype=torch.float32,
                        device=step.device)
        for b, v in zip(attrs["boundaries"], values[1:]):
            lr = torch.where(step >= b, v, lr)
    elif kind == "cosine":
        base = float(attrs["lr"])
        cur_epoch = torch.floor(step / float(attrs["step_each_epoch"]))
        lr = base / 2.0 * (torch.cos(cur_epoch * math.pi
                                     / float(attrs["epochs"])) + 1.0)
    elif kind == "linear_warmup":
        start, end = float(attrs["start_lr"]), float(attrs["end_lr"])
        warmup = float(attrs["warmup_steps"])
        frac = torch.clamp(step / warmup, 0.0, 1.0)
        warm = start + (end - start) * frac
        after = (ins["After"][0].to(torch.float32).reshape(())
                 if ins.get("After") else end)
        lr = torch.where(step < warmup, warm, after)
    else:
        raise ValueError(f"unknown lr schedule {kind!r}")
    return {"Out": [lr.to(torch.float32).reshape(1)]}


def _global_step(helper: LayerHelper) -> Variable:
    """The shared persistable counter; the first schedule of a program
    also appends its increment (one a run)."""
    block = helper.main_program.global_block()
    if block.has_var(GLOBAL_STEP_VAR):
        return block.var(GLOBAL_STEP_VAR)
    step = block.create_var(name=GLOBAL_STEP_VAR, shape=[1],
                            dtype="int64", persistable=True,
                            stop_gradient=True)
    sb = helper.startup_program.global_block()
    if not sb.has_var(GLOBAL_STEP_VAR):
        sb.create_var(name=GLOBAL_STEP_VAR, shape=[1], dtype="int64",
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [GLOBAL_STEP_VAR]},
                     attrs={"shape": [1], "dtype": "int64", "value": 0})
    block.append_op("increment_loop_counter", {"X": [GLOBAL_STEP_VAR]},
                    {"Out": [GLOBAL_STEP_VAR]}, {"step": 1})
    return step


def _schedule(kind: str, inputs=None, **attrs) -> Variable:
    helper = LayerHelper("lr_schedule")
    _global_step(helper)
    out = helper.block.create_var(
        name=unique_name.generate(f"lr_{kind}"), shape=[1],
        dtype="float32", stop_gradient=True)
    ins = {"Step": [GLOBAL_STEP_VAR]}
    for k, v in (inputs or {}).items():
        ins[k] = [v.name if isinstance(v, Variable) else v]
    helper.main_program.global_block().append_op(
        "lr_schedule", ins, {"Out": [out.name]}, {"kind": kind, **attrs})
    return out


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (the Transformer
    paper's schedule, no extra scale)."""
    return _schedule("noam", d_model=d_model, warmup_steps=warmup_steps)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _schedule("exponential", lr=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _schedule("natural_exp", lr=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return _schedule("inverse_time", lr=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    return _schedule("polynomial", lr=learning_rate,
                     decay_steps=decay_steps, end_lr=end_learning_rate,
                     power=power, cycle=cycle)


def piecewise_decay(boundaries, values):
    """values[i] from boundary i - 1 (a step >= it) to boundary i."""
    assert len(values) == len(boundaries) + 1
    return _schedule("piecewise", boundaries=list(boundaries),
                     values=[float(v) for v in values])


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _schedule("cosine", lr=learning_rate,
                     step_each_epoch=step_each_epoch, epochs=epochs)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """A ramp from start_lr to end_lr over warmup_steps, then
    `learning_rate`: a float, or a schedule Variable (the op's After
    input) to switch to."""
    inputs = {}
    attrs = dict(warmup_steps=warmup_steps, start_lr=start_lr,
                 end_lr=end_lr)
    if isinstance(learning_rate, Variable):
        inputs["After"] = learning_rate
    else:
        attrs["end_lr"] = float(learning_rate)
    return _schedule("linear_warmup", inputs=inputs, **attrs)

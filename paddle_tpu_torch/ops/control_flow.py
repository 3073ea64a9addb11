"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow.py:
``_block_written_vars`` :31, while :41, conditional_block :83, scan :110,
static_rnn_scan :140 (the engine under layers.StaticRNN) and
increment_loop_counter :170).

The JAX package lowers a sub-block into ``lax.while_loop``, ``lax.cond``
or ``lax.scan`` with an explicit carry; here each op is a Python loop or
branch that runs the sub-block's ops through ``run_ops_in_env`` on a copy
of the live env.  Autograd over the loop gives the training gradient of
``scan`` and ``static_rnn_scan``, and over the taken branch that of
``conditional_block``: no backward is written by hand.

``while`` and ``conditional_block`` read their condition on the host,
one device sync per iteration or per block (``cond_reads`` counts the
reads): that is what ``lax.while_loop`` and ``lax.cond`` become in eager
torch.  ``conditional_block`` runs only the taken branch, as ``lax.cond``
does.  ``lax.while_loop`` has no reverse-mode rule: where a loss depends
on a ``while`` output that depends on a parameter, JAX's ``jax.vjp``
raises; here the op's outputs carry a backward that raises EnforceNotMet
naming the op, so ``torch.autograd.grad`` raises at the same point of the
run, before any update op runs or any state is stored.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core.enforce import EnforceNotMet
from ..framework.registry import register_op


def _lower_block(ctx, env: Dict[str, Any], block) -> Dict[str, Any]:
    """Run a sub-block's ops against `env` (a copy the caller made)."""
    from ..framework.executor import run_ops_in_env  # shared lowering loop
    return run_ops_in_env(ctx, env, block.ops)


def _block_written_vars(block) -> List[str]:
    """Every var the block's ops write, in first-write order."""
    written = []
    for op in block.ops:
        for names in op.outputs.values():
            for n in names:
                if n and n not in written:
                    written.append(n)
    return written


def _check_carry(name, old, new, op="static_rnn_scan",
                 hint="update_memory with a value of the memory's own "
                      "type"):
    """lax.scan's and lax.while_loop's rule: a carry keeps its dtype and
    shape from step to step.  The port raises where JAX raises and never
    casts quietly (an AMP bf16 result fed back into an f32 memory, say)."""
    if new.dtype != old.dtype or tuple(new.shape) != tuple(old.shape):
        raise EnforceNotMet(
            f"{op}: {'memory' if op == 'static_rnn_scan' else 'carry'} "
            f"{name!r} enters a step as {old.dtype} {tuple(old.shape)} and "
            f"leaves it as {new.dtype} {tuple(new.shape)}; a carry must keep "
            f"its dtype and shape ({hint})")


def _live(ctx, op):
    """The program and live env a sub-block op runs against."""
    if ctx.program is None or ctx.env is None:
        raise EnforceNotMet(f"{op} runs inside an Executor or a Predictor "
                            f"run (it needs the program and the live env)")
    return ctx.program, ctx.env


def _read_cond(cond) -> bool:
    """The condition on the host: one sync on the card."""
    _read_cond.cond_reads += 1
    return bool(cond.reshape(()))


_read_cond.cond_reads = 0


class _NoReverseMode(torch.autograd.Function):
    """Identity forward; a backward that raises, as JAX's jax.vjp raises
    on a lax.while_loop whose carry the loss differentiates."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise EnforceNotMet(
            "op 'while': reverse-mode differentiation does not work for a "
            "while loop (lax.while_loop has no reverse-mode rule); the "
            "loss depends on a while output that depends on a parameter. "
            "Use a scan (layers.StaticRNN) for a loop the loss "
            "differentiates")


@register_op("while")
def _while(ctx, ins, attrs):
    """attrs: sub_block, condition (the var name), out_vars.  The carry
    is the condition var plus every var the sub-block writes that already
    exists outside it; each step runs the sub-block on the live env
    updated with the carry, while the condition, read on the host, holds.
    Out: one value per out_vars entry, the carried ones after the loop
    and the rest as they were; an entry with no value before the loop
    raises (JAX :75-79)."""
    program, env = _live(ctx, "while")
    block = program.blocks[int(attrs["sub_block"])]
    cond_name = attrs["condition"]
    carried = [n for n in _block_written_vars(block) if n in env]
    if cond_name not in carried and cond_name in env:
        carried.append(cond_name)
    carry = {n: env[n] for n in carried}
    while _read_cond(carry[cond_name]):
        benv = dict(env)
        benv.update(carry)
        benv = _lower_block(ctx, benv, block)
        for n in carried:
            _check_carry(n, carry[n], benv[n], op="while",
                         hint="write each loop var with a value of its own "
                              "type")
        carry = {n: benv[n] for n in carried}
    outs = []
    for n in attrs.get("out_vars", carried):
        if n in carry:
            v = carry[n]
            outs.append(_NoReverseMode.apply(v) if v.requires_grad else v)
        elif n in env:
            outs.append(env[n])
        else:
            raise EnforceNotMet(
                f"while loop output {n!r} has no value before the loop; "
                f"initialise it (e.g. fill_constant) so it can be carried")
    return {"Out": outs}


def _meta_outputs(program, env, block, out_vars):
    """The shapes and dtypes the block gives `out_vars`, from one run of
    its ops on meta tensors (lax.cond's abstract evaluation of the
    then-branch)."""
    from ..framework.registry import LowerContext
    meta = torch.device("meta")
    mctx = LowerContext(0, meta, program)
    menv = {n: (torch.empty(tuple(v.shape), dtype=v.dtype, device=meta)
                if isinstance(v, torch.Tensor) else v)
            for n, v in env.items()}
    with torch.no_grad():
        menv = _lower_block(mctx, menv, block)
    return [menv[n] for n in out_vars]


@register_op("conditional_block")
def _conditional_block(ctx, ins, attrs):
    """attrs: sub_block, out_vars; Cond a one-element bool.  Read on the
    host: a true condition runs the sub-block and emits its values of
    out_vars; a false one runs nothing and passes each out_vars entry's
    value before the block through, or zeros shaped like the block's
    value where there is none (JAX :97-104).  Both branches must give an
    entry one dtype and shape, as lax.cond's must."""
    program, env = _live(ctx, "conditional_block")
    block = program.blocks[int(attrs["sub_block"])]
    out_vars = list(attrs["out_vars"])
    cond = ins["Cond"][0]
    if cond.numel() != 1:
        raise EnforceNotMet(f"conditional_block: Cond has shape "
                            f"{tuple(cond.shape)}, not one element")
    if _read_cond(cond):
        benv = _lower_block(ctx, dict(env), block)
        outs = [benv[n] for n in out_vars]
        for n, v in zip(out_vars, outs):
            if n in env:
                _check_carry(n, env[n], v, op="conditional_block",
                             hint="both branches must give a var one "
                                  "dtype and shape")
        return {"Out": outs}
    if all(n in env for n in out_vars):
        return {"Out": [env[n] for n in out_vars]}
    shapes = _meta_outputs(program, env, block, out_vars)
    return {"Out": [env[n] if n in env else
                    torch.zeros(tuple(m.shape), dtype=m.dtype,
                                device=ctx.device)
                    for n, m in zip(out_vars, shapes)]}


@register_op("scan")
def _scan(ctx, ins, attrs):
    """attrs: sub_block, carry_vars, x_vars (outer vars scanned over dim
    0, each bound to its own name in the step), y_vars (the per-step
    outputs).  CarryOut: the carries after the last step; Ys: each y's
    steps stacked on a new dim 0 (lax.scan over the leading axis)."""
    program, env = _live(ctx, "scan")
    block = program.blocks[int(attrs["sub_block"])]
    carry_names = list(attrs["carry_vars"])
    x_names = list(attrs.get("x_vars", []))
    y_names = list(attrs.get("y_vars", []))
    if not x_names:
        raise EnforceNotMet("scan needs x_vars: the number of steps is "
                            "their dim 0")
    xs = [env[n] for n in x_names]
    T = int(xs[0].shape[0])
    for n, x in zip(x_names, xs):
        if int(x.shape[0]) != T:
            raise EnforceNotMet(f"scan: x var {n!r} has {int(x.shape[0])} "
                                f"steps, the first {T}")
    carry = [env[n] for n in carry_names]
    ys = [[] for _ in y_names]
    for t in range(T):
        benv = dict(env)
        benv.update(zip(carry_names, carry))
        benv.update((n, x[t]) for n, x in zip(x_names, xs))
        benv = _lower_block(ctx, benv, block)
        new = [benv[n] for n in carry_names]
        for n, old, v in zip(carry_names, carry, new):
            _check_carry(n, old, v, op="scan",
                         hint="write each carry with a value of its own "
                              "type")
        carry = new
        for acc, n in zip(ys, y_names):
            acc.append(benv[n])
    return {"CarryOut": carry, "Ys": [torch.stack(acc) for acc in ys]}


@register_op("increment_loop_counter")
def _increment_loop_counter(ctx, ins, attrs):
    """Out = X + step in X's dtype (the schedules' int64 global step)."""
    return {"Out": [ins["X"][0] + attrs.get("step", 1)]}


@register_op("static_rnn_scan")
def _static_rnn_scan(ctx, ins, attrs):
    """Inputs: Init (one value per memory), X (scanned [T, B, ...]
    tensors).  attrs: sub_block, carry_vars (the memories' inner names),
    x_inner_vars (the per-step inner names, aligned with X), y_vars (the
    per-step outputs).  Outputs: Ys, each the steps' values stacked on a
    new dim 0, and CarryOut, the memories after the last step."""
    program, env = _live(ctx, "static_rnn_scan")
    block = program.blocks[int(attrs["sub_block"])]
    carry_names = list(attrs["carry_vars"])
    x_inner = list(attrs.get("x_inner_vars", []))
    y_names = list(attrs.get("y_vars", []))
    carry = list(ins.get("Init", []))
    xs = list(ins.get("X", []))
    if not xs:
        raise EnforceNotMet("static_rnn_scan needs a step_input: its "
                            "length is the scanned inputs' dim 0")
    T = int(xs[0].shape[0])
    for n, x in zip(x_inner, xs):
        if int(x.shape[0]) != T:
            raise EnforceNotMet(f"static_rnn_scan: step input {n!r} has "
                                f"{int(x.shape[0])} steps, the first {T}")
    ys = [[] for _ in y_names]
    for t in range(T):
        benv = dict(env)
        benv.update(zip(carry_names, carry))
        benv.update((n, x[t]) for n, x in zip(x_inner, xs))
        benv = _lower_block(ctx, benv, block)
        new = [benv[n] for n in carry_names]
        for n, old, v in zip(carry_names, carry, new):
            _check_carry(n, old, v)
        carry = new
        for acc, n in zip(ys, y_names):
            acc.append(benv[n])
    return {"Ys": [torch.stack(acc) for acc in ys], "CarryOut": carry}

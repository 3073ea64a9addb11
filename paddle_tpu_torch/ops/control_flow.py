"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow.py:
static_rnn_scan :140, the engine under layers.StaticRNN).

The JAX package lowers a sub-block into ``lax.scan`` with an explicit
carry; here the op is a Python loop over the scanned axis that runs the
sub-block's ops through ``run_ops_in_env`` once a step, on a copy of the
live env.  Autograd over the loop gives the training gradient: no
backward is written by hand.  ``while``, ``conditional_block`` and
``scan`` are not ported yet (ROADMAP queue A.5, item 7).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.enforce import EnforceNotMet
from ..framework.registry import register_op


def _lower_block(ctx, env: Dict[str, Any], block) -> Dict[str, Any]:
    """Run a sub-block's ops against `env` (a copy the caller made)."""
    from ..framework.executor import run_ops_in_env  # shared lowering loop
    return run_ops_in_env(ctx, env, block.ops)


def _check_carry(name, old, new):
    """lax.scan's rule: a carry keeps its dtype and shape from step to
    step.  The port raises where JAX raises and never casts quietly (an
    AMP bf16 result fed back into an f32 memory, say)."""
    if new.dtype != old.dtype or tuple(new.shape) != tuple(old.shape):
        raise EnforceNotMet(
            f"static_rnn_scan: memory {name!r} enters a step as "
            f"{old.dtype} {tuple(old.shape)} and leaves it as {new.dtype} "
            f"{tuple(new.shape)}; a carry must keep its dtype and shape "
            f"(update_memory with a value of the memory's own type)")


@register_op("static_rnn_scan")
def _static_rnn_scan(ctx, ins, attrs):
    """Inputs: Init (one value per memory), X (scanned [T, B, ...]
    tensors).  attrs: sub_block, carry_vars (the memories' inner names),
    x_inner_vars (the per-step inner names, aligned with X), y_vars (the
    per-step outputs).  Outputs: Ys, each the steps' values stacked on a
    new dim 0, and CarryOut, the memories after the last step."""
    if ctx.program is None or ctx.env is None:
        raise EnforceNotMet("static_rnn_scan runs inside an Executor or a "
                            "Predictor run (it needs the program and the "
                            "live env)")
    block = ctx.program.blocks[int(attrs["sub_block"])]
    env = ctx.env
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

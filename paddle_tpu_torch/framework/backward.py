"""Source-level autodiff: append_backward.

Counterpart of paddle_tpu/framework/backward.py:24.  One ``autodiff`` op
is appended that records (loss, params, grad names); the Executor expands
it with ``torch.autograd.grad`` over the forward segment and binds each
``param@GRAD`` name to a tensor.  The optimizer ops downstream read those
grad vars, as in the reference.  The op, its slots and attrs and the grad
vars are the JAX package's, so both training programs serialize alike.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.enforce import check_arg
from .program import Parameter, Variable, grad_var_name


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence] = None,
                    no_grad_set=None) -> List[Tuple[Parameter, Variable]]:
    """Append gradient computation for `loss` w.r.t. trainable parameters.

    Returns [(param, grad_var)] like the reference (backward.py:394).
    """
    block = loss.block
    program = block.program
    check_arg(block.idx == 0,
              "append_backward must be called on the main (global) block")

    no_grad = {v.name if isinstance(v, Variable) else str(v)
               for v in (no_grad_set or ())}

    if parameter_list is not None:
        params = []
        for p in parameter_list:
            name = p.name if isinstance(p, Variable) else str(p)
            params.append(block.var(name))
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    params = [p for p in params if p.name not in no_grad]
    check_arg(len(params) > 0, "no trainable parameters to differentiate")

    param_grads: List[Tuple[Parameter, Variable]] = []
    grad_names = []
    for p in params:
        gname = grad_var_name(p.name)
        if not block.has_var(gname):
            gvar = block.create_var(name=gname, shape=p.shape, dtype=p.dtype,
                                    stop_gradient=True)
        else:
            gvar = block.var(gname)
        grad_names.append(gname)
        param_grads.append((p, gvar))

    # loss@GRAD exists for API parity (always ones_like(loss)).
    if not block.has_var(grad_var_name(loss.name)):
        block.create_var(name=grad_var_name(loss.name), shape=loss.shape,
                         dtype=loss.dtype, stop_gradient=True)

    block.append_op(
        "autodiff",
        inputs={"Loss": [loss.name], "Params": [p.name for p in params]},
        outputs={"Grads": grad_names},
        attrs={"loss": loss.name,
               "params": [p.name for p in params],
               "grads": grad_names})
    return param_grads

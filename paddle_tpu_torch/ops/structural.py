"""The ``autodiff`` marker (counterpart of paddle_tpu/ops/structural.py:22).

``framework/backward.py`` appends it; the Executor expands it with
``torch.autograd.grad`` and never lowers it.  ``Block.append_op`` runs no
shape inference, so nothing else tries to lower it either.
"""
from ..framework.registry import register_op


@register_op("autodiff")
def _autodiff(ctx, ins, attrs):
    raise RuntimeError("autodiff op is expanded by the Executor; "
                       "it must not be lowered directly")

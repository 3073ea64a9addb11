"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py).

``sgd`` (:25), ``momentum`` (:31) and ``adam`` (:61) are ported.  Each op reads Param/Grad/LearningRate and
its accumulators and writes ParamOut and the accumulator outs to the SAME
var names; the Executor rebinds the names.  Plain torch, as the JAX
package leaves the op to XLA.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op


def _p(ins, slot):
    return ins[slot][0]


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    param, grad, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins,
                                                            "LearningRate")
    return {"ParamOut": [param - lr.reshape(()) * grad]}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    """v = mu * v + g; p -= lr * v, or with use_nesterov
    p -= (g + mu * v) * lr."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    vel, lr = _p(ins, "Velocity"), _p(ins, "LearningRate").reshape(())
    mu = float(attrs["mu"])
    v = mu * vel + grad
    if attrs.get("use_nesterov", False):
        p = param - (grad + mu * v) * lr
    else:
        p = param - lr * v
    return {"ParamOut": [p], "VelocityOut": [v]}


@register_op("adam")
def _adam(ctx, ins, attrs):
    """Paddle's Adam: the beta pows start at beta (not 1) and the bias
    correction uses the INCOMING pows; the pow outputs keep their [1]
    shape."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    m1, m2 = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p_in, b2p_in = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1p = b1p_in.reshape(())
    b2p = b2p_in.reshape(())
    lr = _p(ins, "LearningRate").reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    m1n = b1 * m1 + (1 - b1) * grad
    m2n = b2 * m2 + (1 - b2) * torch.square(grad)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p = param - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": [p], "Moment1Out": [m1n], "Moment2Out": [m2n],
            "Beta1PowOut": [(b1p * b1).reshape(b1p_in.shape)],
            "Beta2PowOut": [(b2p * b2).reshape(b2p_in.shape)]}

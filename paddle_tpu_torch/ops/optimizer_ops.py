"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py).

All fifteen are ported: ``sgd`` (:25), ``momentum`` (:31),
``lars_momentum`` (:44), ``adam`` (:61), ``adamw`` (:85), ``adamax``
(:96), ``adagrad`` (:114), ``decayed_adagrad`` (:125), ``adadelta``
(:137), ``rmsprop`` (:152), ``ftrl`` (:175), ``proximal_gd`` (:199),
``proximal_adagrad`` (:211), ``lamb`` (:226) and ``average_accumulates``
(:254, ModelAverage's running sums).  Each op reads Param/Grad/
LearningRate and its accumulators and writes ParamOut and the
accumulator outs to the SAME var names; the Executor rebinds the names.
Every op returns new tensors (gradient accumulation's ``.preupdate``
snapshots alias their vars through ``assign``, so an update in place
would move the snapshot too).  Plain torch, as the JAX package leaves
the ops to XLA; the norms of ``lars_momentum`` and ``lamb`` are over the
whole tensor.
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


@register_op("lars_momentum")
def _lars_momentum(ctx, ins, attrs):
    """Layer-wise adaptive rate scaling: the local lr is lr * coeff *
    ||p|| / (||g|| + wd * ||p|| + 1e-12) where both norms are > 0."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    vel, lr = _p(ins, "Velocity"), _p(ins, "LearningRate").reshape(())
    mu = float(attrs["mu"])
    lars_coeff = float(attrs.get("lars_coeff", 1e-3))
    lars_wd = float(attrs.get("lars_weight_decay", 5e-4))
    pn = torch.sqrt(torch.sum(torch.square(param)))
    gn = torch.sqrt(torch.sum(torch.square(grad)))
    local_lr = torch.where(
        (pn > 0) & (gn > 0),
        lr * lars_coeff * pn / (gn + lars_wd * pn + 1e-12), lr)
    v = mu * vel + local_lr * (grad + lars_wd * param)
    return {"ParamOut": [param - v], "VelocityOut": [v]}


@register_op("adamw")
def _adamw(ctx, ins, attrs):
    """Adam, then the decoupled decay: p -= lr * coeff * p (the incoming
    p)."""
    param = _p(ins, "Param")
    wd = float(attrs.get("coeff", 0.01))
    lr = _p(ins, "LearningRate").reshape(())
    outs = _adam(ctx, ins, attrs)
    outs["ParamOut"] = [outs["ParamOut"][0] - lr * wd * param]
    return outs


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    m, inf = _p(ins, "Moment"), _p(ins, "InfNorm")
    b1p_in = _p(ins, "Beta1Pow")
    b1p = b1p_in.reshape(())
    lr = _p(ins, "LearningRate").reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    mn = b1 * m + (1 - b1) * grad
    infn = torch.maximum(b2 * inf, torch.abs(grad) + eps)
    p = param - (lr / (1 - b1p)) * (mn / infn)
    return {"ParamOut": [p], "MomentOut": [mn], "InfNormOut": [infn],
            "Beta1PowOut": [(b1p * b1).reshape(b1p_in.shape)]}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    """m += g^2; p -= lr * g / (sqrt(m) + eps).  A zero gradient leaves
    its entry of p and m bit-equal (lr * 0 / (sqrt(m) + eps) is 0)."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    moment = _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    eps = float(attrs.get("epsilon", 1e-6))
    mn = moment + torch.square(grad)
    return {"ParamOut": [param - lr * grad / (torch.sqrt(mn) + eps)],
            "MomentOut": [mn]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    moment = _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    decay = float(attrs.get("decay", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    mn = decay * moment + (1 - decay) * torch.square(grad)
    return {"ParamOut": [param - lr * grad / (torch.sqrt(mn) + eps)],
            "MomentOut": [mn]}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    """No learning rate: the step is sqrt((E[u^2] + eps) / (E[g^2] +
    eps)) * g."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    avg_sq_g = _p(ins, "AvgSquaredGrad")
    avg_sq_u = _p(ins, "AvgSquaredUpdate")
    rho = float(attrs.get("rho", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    g2 = rho * avg_sq_g + (1 - rho) * torch.square(grad)
    upd = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * grad
    u2 = rho * avg_sq_u + (1 - rho) * torch.square(upd)
    return {"ParamOut": [param + upd], "AvgSquaredGradOut": [g2],
            "AvgSquaredUpdateOut": [u2]}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    """``centered`` subtracts the running mean gradient's square from the
    mean square (a MeanGrad accumulator more)."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    ms, mom = _p(ins, "MeanSquare"), _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    rho = float(attrs.get("decay", 0.9))
    eps = float(attrs.get("epsilon", 1e-10))
    mu = float(attrs.get("momentum", 0.0))
    centered = bool(attrs.get("centered", False))
    msn = rho * ms + (1 - rho) * torch.square(grad)
    if centered:
        mg = _p(ins, "MeanGrad")
        mgn = rho * mg + (1 - rho) * grad
        denom = torch.sqrt(msn - torch.square(mgn) + eps)
        momn = mu * mom + lr * grad / denom
        return {"ParamOut": [param - momn], "MeanSquareOut": [msn],
                "MomentOut": [momn], "MeanGradOut": [mgn]}
    momn = mu * mom + lr * grad / torch.sqrt(msn + eps)
    return {"ParamOut": [param - momn], "MeanSquareOut": [msn],
            "MomentOut": [momn]}


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    """FTRL-proximal; lr_power -0.5 takes square roots, any other power
    torch.pow."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    sq_acc = _p(ins, "SquaredAccumulator")
    lin_acc = _p(ins, "LinearAccumulator")
    lr = _p(ins, "LearningRate").reshape(())
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    power = float(attrs.get("lr_power", -0.5))
    new_sq = sq_acc + torch.square(grad)
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq_acc)) / lr
    else:
        sigma = (torch.pow(new_sq, -power)
                 - torch.pow(sq_acc, -power)) / lr
    new_lin = lin_acc + grad - sigma * param
    if power == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        denom = torch.pow(new_sq, -power) / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p = pre / denom
    return {"ParamOut": [p], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [new_lin]}


def _prox(prox, lr_l1, lr_l2):
    """sign(x) * max(|x| - lr * l1, 0) / (1 + lr * l2)."""
    return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr_l1, 0.0)
            / (1.0 + lr_l2))


@register_op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    lr = _p(ins, "LearningRate").reshape(())
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    return {"ParamOut": [_prox(param - lr * grad, lr * l1, lr * l2)]}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    moment = _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    mn = moment + torch.square(grad)
    alr = lr / (torch.sqrt(mn) + 1e-12)
    return {"ParamOut": [_prox(param - alr * grad, alr * l1, alr * l2)],
            "MomentOut": [mn]}


@register_op("lamb")
def _lamb(ctx, ins, attrs):
    """LAMB: Adam's bias-corrected step plus decay, r, scaled by the
    trust ratio ||p|| / ||r|| (1 where either norm is 0)."""
    param, grad = _p(ins, "Param"), _p(ins, "Grad")
    m1, m2 = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p_in, b2p_in = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1p = b1p_in.reshape(())
    b2p = b2p_in.reshape(())
    lr = _p(ins, "LearningRate").reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-6))
    wd = float(attrs.get("weight_decay", 0.01))
    m1n = b1 * m1 + (1 - b1) * grad
    m2n = b2 * m2 + (1 - b2) * torch.square(grad)
    mhat = m1n / (1 - b1p)
    vhat = m2n / (1 - b2p)
    r = mhat / (torch.sqrt(vhat) + eps) + wd * param
    pn = torch.sqrt(torch.sum(torch.square(param)))
    rn = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((pn > 0) & (rn > 0), pn / rn,
                        torch.ones_like(pn))
    return {"ParamOut": [param - lr * trust * r],
            "Moment1Out": [m1n], "Moment2Out": [m2n],
            "Beta1PowOut": [(b1p * b1).reshape(b1p_in.shape)],
            "Beta2PowOut": [(b2p * b2).reshape(b2p_in.shape)]}


@register_op("average_accumulates")
def _average_accumulates(ctx, ins, attrs):
    """ModelAverage's running sum of the parameter after each step and
    its count.  Within max_average_window runs the sum is exact; past the
    cap it slides (sum <- sum * (w - 1) / w + param) and the count stays
    at w, where an f32 count would otherwise stop at 2^24.  The count
    keeps its incoming shape ([1]; the JAX lowering returns it 0-d)."""
    param = _p(ins, "param")
    s1 = _p(ins, "in_sum_1")
    num_in = _p(ins, "in_num_accumulates")
    num = num_in.reshape(())
    w = float(attrs.get("max_average_window", 10000))
    s1_out = torch.where(num < w, s1 + param, s1 * (w - 1.0) / w + param)
    return {"out_sum_1": [s1_out],
            "out_num_accumulates": [torch.clamp_max(num + 1, w)
                                    .reshape(num_in.shape)]}

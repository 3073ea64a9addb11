"""Weight regularizers (counterpart of paddle_tpu/regularizer.py, the
reference's python/paddle/fluid/regularizer.py).

Applied by ``Optimizer.minimize`` as grad-side program ops, in place on
the grad var: grad += coeff * param (L2), grad += coeff * sign(param)
(L1), with the JAX package's ops and var names.  A parameter's own
regularizer (``ParamAttr(regularizer=...)``) wins over the optimizer's.
"""
from __future__ import annotations


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad_name, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = float(regularization_coeff)

    def append_regularization_op(self, param, grad_name, block):
        tmp = f"{grad_name}.l2decay"
        block.create_var(name=tmp, shape=param.shape, dtype=param.dtype,
                         stop_gradient=True)
        block.append_op("scale", {"X": [param.name]}, {"Out": [tmp]},
                        {"scale": self.coeff})
        block.append_op("sum", {"X": [grad_name, tmp]},
                        {"Out": [grad_name]}, {})


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = float(regularization_coeff)

    def append_regularization_op(self, param, grad_name, block):
        sgn = f"{grad_name}.l1sign"
        tmp = f"{grad_name}.l1decay"
        for n in (sgn, tmp):
            block.create_var(name=n, shape=param.shape, dtype=param.dtype,
                             stop_gradient=True)
        block.append_op("sign", {"X": [param.name]}, {"Out": [sgn]}, {})
        block.append_op("scale", {"X": [sgn]}, {"Out": [tmp]},
                        {"scale": self.coeff})
        block.append_op("sum", {"X": [grad_name, tmp]},
                        {"Out": [grad_name]}, {})


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer

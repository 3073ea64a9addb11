"""Operator overloading on Variable (counterpart of
paddle_tpu/layers/math_op_patch.py: ``monkey_patch_variable`` :46).

After the patch, ``a + b``, ``a < 2.0``, ``-a`` and the rest on a
Variable append the op of the same name to the current block and return
its output Variable; a Python scalar operand becomes a [1]
``fill_constant`` of the other operand's dtype.  ``==`` and ``!=`` build
ops too, so code that compares Variables, or looks one up with ``in`` or
``list.index``, must compare names or use ``is``; ``__hash__`` is the
object's id, so Variables still key dicts and sets.
"""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable


def _scalar_to_var(ref: Variable, value):
    helper = LayerHelper("fill_constant")
    out = helper.create_variable_for_type_inference(ref.dtype)
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": [1], "dtype": ref.dtype,
                      "value": float(value)})
    return out


def _binary(op_name, reverse=False):
    def impl(self, other):
        if not isinstance(other, Variable):
            other = _scalar_to_var(self, other)
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_name, {"X": [x], "Y": [y]}, {"Out": [out]},
                         {"axis": -1})
        return out
    return impl


def _compare(op_name):
    def impl(self, other):
        if not isinstance(other, Variable):
            other = _scalar_to_var(self, other)
        helper = LayerHelper(op_name)
        out = helper.create_variable_for_type_inference("bool")
        helper.append_op(op_name, {"X": [self], "Y": [other]},
                         {"Out": [out]}, {"axis": -1})
        out.stop_gradient = True
        return out
    return impl


def _neg(self):
    from . import nn
    return nn.scale(self, -1.0)


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add", reverse=True)
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul", reverse=True)
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__mod__ = _binary("elementwise_mod")
    Variable.__floordiv__ = _binary("elementwise_floordiv")
    Variable.__eq__ = _compare("equal")
    Variable.__ne__ = _compare("not_equal")
    Variable.__lt__ = _compare("less_than")
    Variable.__le__ = _compare("less_equal")
    Variable.__gt__ = _compare("greater_than")
    Variable.__ge__ = _compare("greater_equal")
    Variable.__hash__ = lambda self: hash(id(self))
    Variable.__neg__ = _neg

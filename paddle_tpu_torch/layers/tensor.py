"""Tensor layer functions (counterpart of paddle_tpu/layers/tensor.py:
create_tensor :12, fill_constant :18 (the ``While`` idiom's counters and
bounds; ``out=`` writes an existing var), fill_constant_batch_size_like
:28, cast :40, concat :48, sums :56, assign :63, argmin :79, argmax :87,
argsort :95, ones :105, zeros :109, ones_like :113, zeros_like :121,
reverse :128, linspace :137, diag :146 and eye :150), with the JAX
package's op types, slots and attrs, so both builds serialize alike."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..framework import unique_name
from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable

__all__ = ["create_tensor", "fill_constant",
           "fill_constant_batch_size_like", "cast", "concat", "sums",
           "assign", "argmin", "argmax", "argsort", "ones", "zeros",
           "ones_like", "zeros_like", "reverse", "linspace", "diag", "eye"]


def create_tensor(dtype="float32", name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(
        name=name or unique_name.generate("create_tensor"), dtype=dtype,
        persistable=persistable)


def fill_constant(shape, dtype, value, name=None, out=None):
    helper = LayerHelper("fill_constant", name=name)
    out = (out if out is not None
           else helper.create_variable_for_type_inference(dtype))
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": list(shape), "dtype": str(dtype),
                      "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant_batch_size_like", {"Input": [input]},
                     {"Out": [out]},
                     {"shape": list(shape), "dtype": str(dtype),
                      "value": float(value), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    return out


def cast(x: Variable, dtype) -> Variable:
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", {"X": [x]}, {"Out": [out]},
                     {"out_dtype": str(dtype)})
    return out


def concat(input: Sequence[Variable], axis=0, name=None) -> Variable:
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", {"X": list(input)}, {"Out": [out]},
                     {"axis": axis})
    return out


def sums(input: Sequence[Variable], out=None) -> Variable:
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", {"X": list(input)}, {"Out": [out]}, {})
    return out


def assign(input, output: Optional[Variable] = None) -> Variable:
    """A Variable becomes an ``assign`` op; a host array an
    ``assign_value`` op holding its values."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_variable_for_type_inference(
            input.dtype)
        helper.append_op("assign", {"X": [input]}, {"Out": [output]}, {})
        return output
    arr = np.asarray(input)
    output = output or helper.create_variable_for_type_inference(
        str(arr.dtype))
    helper.append_op("assign_value", {}, {"Out": [output]},
                     {"shape": list(arr.shape), "dtype": str(arr.dtype),
                      "values": arr})
    return output


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_min", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    out.stop_gradient = True
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_max", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    out.stop_gradient = True
    return out


def argsort(x, axis=-1, descending=False):
    """(x sorted along ``axis``, the int64 indices of the sort)."""
    helper = LayerHelper("argsort")
    out = helper.create_variable_for_type_inference(x.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op("argsort", {"X": [x]},
                     {"Out": [out], "Indices": [ids]},
                     {"axis": axis, "descending": descending})
    return out, ids


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x):
    helper = LayerHelper("fill_any_like")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", {"X": [x]}, {"Out": [out]},
                     {"value": 1.0})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    out = out or helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", {"X": [x]}, {"Out": [out]}, {})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op("reverse", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("linspace", {}, {"Out": [out]},
                     {"start": float(start), "stop": float(stop),
                      "num": int(num), "dtype": str(dtype)})
    return out


def diag(diagonal):
    """The square matrix with ``diagonal`` (a host array) on its diagonal,
    as an ``assign_value`` op."""
    return assign(np.diag(np.asarray(diagonal)))


def eye(num_rows, num_columns=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("eye", {}, {"Out": [out]},
                     {"num_rows": int(num_rows),
                      "num_columns": int(num_columns or num_rows),
                      "dtype": str(dtype)})
    return out

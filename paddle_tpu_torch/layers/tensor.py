"""Tensor layer functions (counterpart of paddle_tpu/layers/tensor.py:
create_tensor :12, fill_constant :18 (the ``While`` idiom's counters and
bounds; ``out=`` writes an existing var), fill_constant_batch_size_like
:28, cast :40, concat :48, sums :56, assign :63, ones :105 and zeros
:109), with the JAX package's op types, slots and attrs, so both builds
serialize alike."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..framework import unique_name
from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable

__all__ = ["create_tensor", "fill_constant",
           "fill_constant_batch_size_like", "cast", "concat", "sums",
           "assign", "ones", "zeros"]


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


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)

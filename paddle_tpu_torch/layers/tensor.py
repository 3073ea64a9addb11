"""Tensor layer functions (counterpart of paddle_tpu/layers/tensor.py:
fill_constant_batch_size_like :28, cast :40, concat :48, sums :56 and
assign :63), with the JAX package's op types, slots and attrs, so both
builds serialize alike."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable

__all__ = ["fill_constant_batch_size_like", "cast", "concat", "sums",
           "assign"]


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

"""Dtype plane: canonical framework dtype names <-> torch dtypes.

Counterpart of paddle_tpu/core/dtypes.py.  The canonical names are the ones
the Program IR serializes, so a program saved by either package reads the
same here.  torch computes 64-bit integers natively, so ``int64`` stays
``int64`` (there is no 32-bit lowering plane as under JAX's default x32).
The two fp8 types are canonical names too, so a frozen fp8 program reads the
same in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPE_MAP = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    # fp8 storage types of the quantized-execution plane (JAX
    # core/dtypes.py:29); a numpy array of them comes from ml_dtypes, which
    # the port never imports: io.py moves their bytes as uint8
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
FP8_NAMES = ("float8_e4m3fn", "float8_e5m2")
_FROM_TORCH = {v: k for k, v in _DTYPE_MAP.items()}


def convert_dtype(dtype) -> str:
    """Normalise any dtype spelling (str, np.dtype, torch.dtype) to a
    canonical framework name such as ``'float32'``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _FROM_TORCH:
            raise ValueError(f"Unsupported dtype: {dtype!r}")
        return _FROM_TORCH[dtype]
    if isinstance(dtype, str) and dtype in _DTYPE_MAP:
        return dtype
    if getattr(dtype, "name", None) in ("bfloat16",) + FP8_NAMES:
        return dtype.name           # ml_dtypes' types, by name
    if dtype == "bfloat16":
        return "bfloat16"
    name = np.dtype(dtype).name
    if name not in _DTYPE_MAP:
        raise ValueError(f"Unsupported dtype: {dtype!r}")
    return name


def to_torch_dtype(dtype) -> torch.dtype:
    """Framework/any dtype -> torch dtype."""
    return _DTYPE_MAP[convert_dtype(dtype)]

"""Process-wide config plane (counterpart of paddle_tpu/core/flags.py).

Only the flags the ported slice reads are declared.  Like the reference,
each flag is overridable via a ``PTPU_<NAME>`` environment variable at
import and mutable at runtime via set_flag/get_flag.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_FLAGS: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = ""):
    env_name = "PTPU_" + name.upper()
    env = os.environ.get(env_name)
    value = default
    if env is not None:
        try:
            if isinstance(default, bool):
                value = env.lower() in ("1", "true", "yes")
            elif isinstance(default, int):
                value = int(env)
            elif isinstance(default, float):
                value = float(env)
            else:
                value = env
        except ValueError as e:
            raise ValueError(
                f"malformed value for flag {name!r}: {env_name}={env!r} "
                f"is not a valid {type(default).__name__} ({e})") from e
    _FLAGS[name] = value


def get_flag(name: str) -> Any:
    return _FLAGS[name]


def set_flag(name: str, value: Any):
    if name not in _FLAGS:
        raise KeyError(f"Unknown flag {name!r}")
    _FLAGS[name] = value


define_flag("rng_seed", 0, "Global RNG seed used when a program has no seed.")
define_flag("amp_bf16", False,
            "Mixed precision: f32 matmul and attention inputs enter the "
            "tensor cores as bfloat16 (f32 master params), applied at "
            "lowering time (ops/math_ops.py amp_inputs, amp_result, "
            "amp_matmul).  The kernels accumulate in f32; the cuBLAS "
            "products do when torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction is off.")
define_flag("fuse_block", False,
            "Fuse whole transformer blocks (LN -> attention -> residual "
            "-> LN -> MLP -> residual) into single fused_transformer_"
            "block ops via transpiler/fused_block.py pattern matching; "
            "the op runs the hand-written block kernel "
            "(kernels/fused_block.py) on the card and its plain torch "
            "version on the CPU.")

"""Gradient clipping (counterpart of paddle_tpu/clip.py, the reference's
python/paddle/fluid/clip.py: GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip).  Applied as program ops on
the @GRAD vars (in place) between the autodiff op and the optimizer
updates, with the JAX package's op types, attrs and var names, so both
builds serialize alike.  ``Optimizer.minimize`` calls
``append_gradient_clip_ops``."""
from __future__ import annotations

from .framework.program import Program, default_main_program

_clip_attr_name = "__gradient_clip__"


class BaseGradientClipAttr:
    def append_clip_ops(self, block, param_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def append_clip_ops(self, block, param_grads):
        for p, g in param_grads:
            block.append_op("clip", {"X": [g.name]}, {"Out": [g.name]},
                            {"min": self.min, "max": self.max})


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def append_clip_ops(self, block, param_grads):
        for p, g in param_grads:
            block.append_op("clip_by_norm", {"X": [g.name]},
                            {"Out": [g.name]},
                            {"max_norm": self.clip_norm})


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def append_clip_ops(self, block, param_grads):
        sq_names = []
        for p, g in param_grads:
            sq = f"{g.name}.sq_l2"
            block.create_var(name=sq, shape=[], dtype="float32",
                             stop_gradient=True)
            block.append_op("squared_l2_norm", {"X": [g.name]},
                            {"Out": [sq]}, {})
            sq_names.append(sq)
        gsum = "global_norm.sq_sum"
        block.create_var(name=gsum, shape=[], dtype="float32",
                         stop_gradient=True)
        block.append_op("sum", {"X": sq_names}, {"Out": [gsum]}, {})
        gnorm = "global_norm.value"
        block.create_var(name=gnorm, shape=[], dtype="float32",
                         stop_gradient=True)
        block.append_op("sqrt", {"X": [gsum]}, {"Out": [gnorm]}, {})
        # scale = clip_norm / max(global_norm, clip_norm)
        denom = "global_norm.denom"
        block.create_var(name=denom, shape=[], dtype="float32",
                         stop_gradient=True)
        cn = "global_norm.clip"
        if not block.has_var(cn):
            block.create_var(name=cn, shape=[], dtype="float32",
                             stop_gradient=True)
        block.append_op("fill_constant", {}, {"Out": [cn]},
                        {"shape": [], "dtype": "float32",
                         "value": self.clip_norm})
        block.append_op("elementwise_max", {"X": [gnorm], "Y": [cn]},
                        {"Out": [denom]}, {"axis": -1})
        factor = "global_norm.factor"
        block.create_var(name=factor, shape=[], dtype="float32",
                         stop_gradient=True)
        block.append_op("elementwise_div", {"X": [cn], "Y": [denom]},
                        {"Out": [factor]}, {"axis": -1})
        for p, g in param_grads:
            block.append_op("elementwise_mul", {"X": [g.name],
                                                "Y": [factor]},
                            {"Out": [g.name]}, {"axis": -1})


def set_gradient_clip(clip: BaseGradientClipAttr, param_list=None,
                      program: Program = None):
    program = program or default_main_program()
    setattr(program, _clip_attr_name, (clip, param_list))


def append_gradient_clip_ops(program: Program, param_grads):
    clip_info = getattr(program, _clip_attr_name, None)
    if clip_info is None:
        return
    clip, param_list = clip_info
    if param_list is not None:
        names = {p if isinstance(p, str) else p.name for p in param_list}
        param_grads = [(p, g) for p, g in param_grads if p.name in names]
    clip.append_clip_ops(program.global_block(), param_grads)


class ErrorClipByValue:
    """ref clip.py ErrorClipByValue, kept for API parity as in the JAX
    package: with one autodiff op there is no per-op upstream gradient to
    clip, so it records its bounds and appends nothing."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

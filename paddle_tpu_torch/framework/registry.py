"""Op registry: the kernel-dispatch plane.

Counterpart of paddle_tpu/framework/registry.py (the reference's
OpRegistry + REGISTER_OPERATOR).  An op registers ONE ``lower`` function
that computes its outputs from torch tensors.  Which kernel runs is
decided inside the lowering by the tensors' device: a CUDA tensor goes to
the hand-written kernel (paddle_tpu_torch/kernels), a CPU tensor or a
``meta`` tensor (build-time shape inference) to its plain torch version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.enforce import EnforceNotMet

# lower(ctx, ins: {slot: [Tensor]}, attrs) -> {slot: [Tensor]}
LowerFn = Callable[["LowerContext", Dict[str, List[Any]], Dict[str, Any]],
                   Dict[str, List[Any]]]


@dataclasses.dataclass
class OpDef:
    type: str
    lower: LowerFn


_REGISTRY: Dict[str, OpDef] = {}
# compile-time shape/dtype inference rules (the reference's per-op
# InferShape), registered alongside the OpDef via register_shape_infer and
# consumed by paddle_tpu_torch/analysis.  A map of its own, because rules
# may register before or after their op (analysis imports lazily; ops
# register on first get_op_def).  Ops without a rule fall back to a meta
# evaluation of ``lower``; ops where neither applies degrade to "unknown
# shape", never a crash.
_INFER_RULES: Dict[str, Callable] = {}


def register_op(type: str):
    """Decorator: @register_op("relu") def _(ctx, ins, attrs): ..."""
    def deco(fn: LowerFn):
        if type in _REGISTRY:
            raise EnforceNotMet(f"op {type!r} registered twice")
        _REGISTRY[type] = OpDef(type, fn)
        return fn
    return deco


def get_op_def(type: str) -> OpDef:
    if type not in _REGISTRY:
        # ops/__init__ registers everything lazily on first touch
        from .. import ops as _ops  # noqa: F401
        if type not in _REGISTRY:
            raise EnforceNotMet(f"Operator {type!r} is not registered. "
                                f"Known: {sorted(_REGISTRY)[:20]}...")
    return _REGISTRY[type]


def register_shape_infer(type: str, allow_override: bool = False):
    """Decorator: register a compile-time shape/dtype inference rule
    alongside the op's OpDef (the reference's InferShape slot).

        rule(op, ins, attrs) -> {slot: [(shape, dtype)]} | None

    ``ins`` maps input slots to [(shape, dtype)], shape a tuple (-1 = a
    dynamic dim) or None (unknown), dtype a canonical name or None.  A rule
    raises analysis.InferError on a provable mismatch and returns None to
    defer to the meta evaluation (analysis/shape_inference.py).
    """
    def deco(fn: Callable):
        if type in _INFER_RULES and not allow_override:
            raise EnforceNotMet(f"shape-infer rule for {type!r} "
                                f"registered twice")
        _INFER_RULES[type] = fn
        return fn
    return deco


def get_shape_infer(type: str) -> Optional[Callable]:
    """The registered infer rule for an op type, or None."""
    return _INFER_RULES.get(type)


def unregister_shape_infer(type: str):
    """Test hook: drop a rule registered by a test (analysis.reset())."""
    _INFER_RULES.pop(type, None)


_MASK63 = (1 << 63) - 1


def _fold(seed: int, counter: int) -> int:
    """Deterministic 63-bit mix of (seed, counter): the counterpart of
    jax.random.fold_in for seeding one torch.Generator per random op."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(counter) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


class LowerContext:
    """Per-run lowering context handed to every op's lower().

    Carries the device the op runs on and the random plane: a
    ``torch.Generator`` on that device, reseeded for each random op from
    the program seed and an op counter (the counterpart of the JAX
    package's ``ctx.rng()`` key folding).  torch's Philox draws other
    numbers than JAX's threefry from the same seed; parity always starts
    from saved weights.

    A control-flow op (ops/control_flow.py) reads two more fields: the
    ``program`` being run, whose sub-block it runs (set by
    ``Executor.run`` and the Predictor), and ``env``, the innermost live
    name -> tensor map, which ``run_ops_in_env`` sets around each op.
    Both are None where nothing set them (a meta evaluation).
    """

    def __init__(self, seed: int, device: torch.device, program=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.program = program
        self.env: Optional[Dict[str, Any]] = None
        self._counter = 0
        self.generator: Optional[torch.Generator] = (
            None if self.device.type == "meta"
            else torch.Generator(device=self.device))

    def rng(self) -> Optional[torch.Generator]:
        """The generator reseeded for the next random op (None on meta,
        where nothing is drawn)."""
        self._counter += 1
        if self.generator is None:
            return None
        return self.generator.manual_seed(_fold(self.seed, self._counter))


def single_input(ins: Dict[str, List[Any]], slot: str = "X"):
    vs = ins.get(slot, [])
    if len(vs) != 1:
        raise EnforceNotMet(f"expected exactly one input in slot {slot!r}, "
                            f"got {len(vs)}")
    return vs[0]

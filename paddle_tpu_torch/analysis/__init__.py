"""Static program verifier and lint plane (counterpart of
paddle_tpu/analysis/).

Per-op compile-time shape/dtype inference (the reference's InferShape:
shape_inference.py and the rules registered alongside OpDef via
framework/registry.py ``register_shape_infer``) and a read-only pass
manager over the Program IR (passes.py) that emits structured Finding
records (schema ``paddle_tpu.analysis.v1``, the JAX package's).

Consumers: the Executor's gate before a program runs (the
``verify_program`` flag), FuseBlockTranspiler's post-condition
(``maybe_check_transpiled``) and the lint CLI (``python -m
paddle_tpu_torch.analysis.lint``, not imported here so that ``-m`` runs
it cleanly).  Nothing here imports JAX: shape inference runs the port's
own lowerings on ``meta`` tensors.
"""
from .findings import (ERROR, INFO, SCHEMA, WARN, AnalysisResult,
                       Finding)
from .infer_rules import InferError
from .passes import (ProgramVerificationError, check_transpiled,
                     maybe_check_transpiled, quick_lints, reset,
                     verify_program)
from . import traversal

__all__ = [
    "AnalysisResult", "Finding", "InferError",
    "ProgramVerificationError", "SCHEMA", "ERROR", "WARN", "INFO",
    "check_transpiled", "maybe_check_transpiled", "quick_lints",
    "reset", "traversal", "verify_program",
]

"""Program transpilers (counterpart of paddle_tpu/transpiler/):

  * FuseBlockTranspiler / maybe_fuse: whole transformer blocks as one op;
  * QuantizeTranspiler: the QAT rewrite and its freeze to int8 / fp8;
  * InferenceTranspiler: the conv + batch_norm fold;
  * memory_optimize / release_memory: no-ops kept so user scripts run
    unchanged (JAX :27-37): the executor runs ops eagerly on PyTorch's
    caching allocator, so there is no var-reuse rewrite to make.

The JAX package's parallel transpilers (distribute, tensor, context and
expert parallel, pipeline) are not ported (ROADMAP queue A.7).
"""
from .fused_block import FuseBlockTranspiler, maybe_fuse
from .inference_transpiler import InferenceTranspiler
from .quantize_transpiler import QuantizeTranspiler


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """ref memory_optimization_transpiler.py:491; returns the program."""
    return input_program


def release_memory(input_program, skip_opt_set=None):
    """ref memory_optimization_transpiler.py:547; returns the program."""
    return input_program


__all__ = ["FuseBlockTranspiler", "InferenceTranspiler",
           "QuantizeTranspiler", "maybe_fuse", "memory_optimize",
           "release_memory"]

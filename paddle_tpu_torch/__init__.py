"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style system — a Program/Block/Operator IR built by
``layers.*``, one ``lower`` function per registered op, a single
``autodiff`` op for gradients, the ``optimizer`` family (SGD to Lamb,
and ModelAverage) with ``clip`` and ``regularizer``, ``Executor.run``
behind the ``analysis`` verifier, ``io`` and the ``Predictor`` — with each op lowered to torch and each
Pallas TPU kernel on the ported path replaced by a CUDA kernel written by
hand for Hopper (``kernels/``).  The JAX package ``paddle_tpu`` stays the
reference; this package imports nothing of it and no JAX.

Entry points run on the card unless the caller asks for the CPU:
``Executor()`` and ``AnalysisConfig(model_dir)`` mean ``CUDAPlace(0)`` and
raise without a card; pass ``CPUPlace()`` / ``use_gpu=False`` for the CPU.
"""
from . import core
from .core import flags
from .core.place import CPUPlace, CUDAPlace, default_place
from .framework.program import (Program, Block, Variable, Parameter,
                                program_guard, default_main_program,
                                default_startup_program,
                                reset_default_programs)
from .framework import unique_name
from .framework.executor import Executor, Scope, global_scope
from .framework.layer_helper import ParamAttr
from .framework import initializer
from . import layers
from . import nets
from . import clip
from . import regularizer
from . import optimizer
from . import io
from . import inference
from . import models
from . import transpiler
from . import reader
from . import analysis
from . import metrics
from . import sparse
from .data_feeder import DataFeeder
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                      EndEpochEvent, EndStepEvent, Trainer)

__all__ = ["core", "flags", "CPUPlace", "CUDAPlace", "default_place",
           "Program", "Block", "Variable", "Parameter", "program_guard",
           "default_main_program", "default_startup_program",
           "reset_default_programs", "unique_name", "Executor", "Scope",
           "global_scope", "ParamAttr", "initializer", "layers", "nets", "clip",
           "regularizer", "optimizer", "io", "inference", "models",
           "transpiler", "reader", "analysis", "metrics", "sparse",
           "DataFeeder",
           "BeginEpochEvent", "BeginStepEvent", "CheckpointConfig",
           "EndEpochEvent", "EndStepEvent", "Trainer"]

"""Layers package (counterpart of paddle_tpu/layers/)."""
from . import nn, tensor  # noqa: F401
from .nn import *  # noqa: F401,F403
from .tensor import assign, cast  # noqa: F401

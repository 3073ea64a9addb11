"""Models (counterpart of paddle_tpu/models)."""
from . import lenet, resnet, transformer, vgg  # noqa: F401

"""Models (counterpart of paddle_tpu/models)."""
from . import bert, lenet, resnet, transformer, vgg  # noqa: F401

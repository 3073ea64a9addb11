"""Program transpilers (counterpart of paddle_tpu/transpiler/): only the
fuse-block rewrite is ported."""
from .fused_block import FuseBlockTranspiler, maybe_fuse

__all__ = ["FuseBlockTranspiler", "maybe_fuse"]

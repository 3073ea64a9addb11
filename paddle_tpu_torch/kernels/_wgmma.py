"""The tile sizes of csrc/wgmma_bf16.cuh, which the bf16 LM head's and the
bf16 block's wgmma kernels share, for the Python mirrors of their
schedules."""

# a CTA's tile (rows x columns, kBM = kBN) and its k-tile (kBK)
WG_TILE, WG_KTILE = 128, 64

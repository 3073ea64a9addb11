#!/usr/bin/env python3
"""Kernel variants of the bf16 block's wgmma GEMMs, timed on one CUDA card
in turns.

    python tools/block_gemm_ab.py TREE [TREE ...]

Each TREE is a copy of this repository (say, one under the gitignored
build/ with its csrc/fused_block_bf16.cu edited), run in turns by
tools/ab_trees.py (list a tree twice to run it twice: a b b a).  A run
builds the tree's kernels into TREE/build/torch_kernels and prints ptxas's
registers and spills of the block's wgmma GEMM kernels and any wgmma
serialization warning (C7518); checks three cases on the wgmma GEMMs (the
training shape, D 264 / E 192 / F 520 and W1 x 8: large W2 sums) against
transformer_block_plain at chip_smoke's BLOCK_BF16_RTOL and two calls for
the same bits; times the block forward cold (chip_smoke.time_ms over
rotated x) at the training shape (B 32, T 512, H 8, D = E 512, F 2048)
with its GEMMs on the wgmma path and on the sync path, with the host
enqueue per call; and lists one call's launches on the wgmma path with
each GEMM's time and TFLOP/s (chip_smoke.block_breakdown).
"""
import sys

import ab_trees

CODE = r'''
import functools
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build, fused_block as fb
_build.build()
_build.load()
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "C7518" in line:
        print(f"[ptxas] {line.strip()}")
    if "Compiling entry" in line and "block_gemm_bf16_wg_kernel" in line:
        print(f"[ptxas] {line.split('entry function')[-1].strip()}: "
              f"{log[i + 2].strip()}; {log[i + 3].strip()}")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(13)
bf = torch.bfloat16
blk = fb.transformer_block_bf16


def rnd(*s):
    return torch.randn(*s, generator=g, device=dev)


for B, T, H, D, E, F, w1s in [(32, 512, 8, 512, 512, 2048, 1),
                              (2, 300, 3, 264, 192, 520, 1),
                              (4, 512, 8, 512, 512, 2048, 8)]:
    x, p = cs.block_inputs(rnd, B, T, D, F, E, w1s)
    x, p = x.to(bf), cs.bf16_block_params(p)
    a = blk(x, p, H, True, gemm_path="wgmma")
    b = blk(x, p, H, True, gemm_path="wgmma")
    want = fb.transformer_block_plain(x, p, H, True)
    torch.cuda.synchronize()
    err, same = cs.rel_err(a, want), torch.equal(a, b)
    print(f"[check] B={B} T={T} H={H} D={D} E={E} F={F} W1 x{w1s}: "
          f"{err:.3g} of max |plain| (tol {cs.BLOCK_BF16_RTOL:g}); two "
          f"calls bit-identical: {same}")
    if not (err <= cs.BLOCK_BF16_RTOL and same):
        raise SystemExit(f"the block's wgmma GEMMs disagree: {err}, {same}")
B, T, H, D, F = 32, 512, 8, 512, 2048
x, p = cs.block_inputs(rnd, B, T, D, F)
p = cs.bf16_block_params(p)
rot = cs.rotation(lambda: rnd(B, T, D).to(bf))
for path in ("wgmma", "sync", "sync", "wgmma"):
    ms, host = cs.time_ms(lambda: blk(rot(), p, H, True, gemm_path=path),
                          iters=10, warmup=2)
    print(f"[time] bf16 block B={B} T={T} H={H} D={D} F={F} cold, GEMMs "
          f"{path}: {ms:.4f} ms, host enqueue {host:.4f} ms")
for name, r in cs.block_breakdown(torch, bf16=True, chain=7,
                                  gemm_path="wgmma").items():
    rate = f", {r['tflops']:.1f} TFLOP/s" if "tflops" in r else ""
    print(f"[time]   {name}: {r['ms']:.4f} ms{rate}")
'''

if __name__ == "__main__":
    sys.exit(ab_trees.run(sys.argv[1:], CODE, ("[ptxas", "[check", "[time"),
                          __doc__, timeout=300))

#!/usr/bin/env python3
"""Kernel variants of the bf16 LM-head forward's wgmma path, timed on one
CUDA card in turns.

    python tools/lm_head_fwd_ab.py TREE [TREE ...]

Each TREE is a copy of this repository (say, one under the gitignored
build/ with its csrc/lm_head_bf16.cu edited), run in turns by
tools/ab_trees.py (list a tree twice to run it twice: a b c c b a).  A run
builds lm_head_bf16.cu alone into TREE/build/lm_head_fwd_ab and prints
ptxas's registers and spills of the forward's wgmma kernels and any wgmma
serialization warning (C7518); checks four cases on the wgmma path (the
training shape, x * 12, a shape that is a multiple of no tile, D 1024
with x streamed) against lm_head_fwd_plain at chip_smoke's HEAD_TOL and
two calls for the same bits; and times the forward cold
(chip_smoke.time_ms over rotated inputs) at the training shape (N 16384,
D 512, V 32000) on the wgmma path and on the sync path.
"""
import sys

import ab_trees

CODE = r'''
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build, lm_head as lmh
_build.BUILD_DIR = _build.REPO_ROOT / "build" / "lm_head_fwd_ab"
_build.sources = lambda: [_build.CSRC_DIR / "lm_head_bf16.cu"]
_build.build()
_build.load()
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "C7518" in line:
        print(f"[ptxas] {line.strip()}")
    if "Compiling entry" in line and "lm_head_fwd_bf16_wg_kernel" in line:
        form = "x resident" if "ILb1E" in line else "x streamed"
        print(f"[ptxas] lm_head_fwd_bf16_wg_kernel ({form}): "
              f"{log[i + 2].strip()}; {log[i + 3].strip()}")
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device=dev).manual_seed(12)
bf = torch.bfloat16
fwd = lmh.lm_head_fwd_bf16
for N, D, V, amp in [(16384, 512, 32000, 1), (2048, 512, 32000, 12),
                     (3001, 264, 4104, 1), (1000, 1024, 4104, 1)]:
    x = (torch.randn(N, D, generator=g, device=dev) * amp).to(bf)
    w = (torch.randn(D, V, generator=g, device=dev) * 0.05).to(bf)
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    y[::97] = -1
    a, b = fwd(x, w, y, path="wgmma"), fwd(x, w, y, path="wgmma")
    want = lmh.lm_head_fwd_plain(x, w, y)
    torch.cuda.synchronize()
    err = max(cs.max_err(p, q) for p, q in zip(a, want))
    same = all(torch.equal(p, q) for p, q in zip(a, b))
    print(f"[check] N={N} D={D} V={V} x*{amp}: loss and lse max abs err "
          f"{err:.3g} (tol {cs.HEAD_TOL:g}); two calls bit-identical: {same}")
    if not (err <= cs.HEAD_TOL and same):
        raise SystemExit(f"the wgmma forward disagrees: {err}, {same}")
N, D, V = 16384, 512, 32000
y = torch.randint(0, V, (N,), generator=g, device=dev)
rot = cs.rotation(lambda: (torch.randn(N, D, generator=g, device=dev).to(bf),
                           (torch.randn(D, V, generator=g, device=dev)
                            * 0.05).to(bf)))
for path in ("wgmma", "sync"):
    ms, host = cs.time_ms(lambda: fwd(*rot(), y, path=path), iters=10,
                          warmup=2)
    print(f"[time] bf16 LM-head forward N={N} D={D} V={V} cold, {path}: "
          f"{ms:.4f} ms ({2 * N * D * V / ms / 1e9:.1f} TFLOP/s), host "
          f"enqueue {host:.4f} ms")
'''

if __name__ == "__main__":
    sys.exit(ab_trees.run(sys.argv[1:], CODE, ("[ptxas", "[check", "[time"),
                          __doc__, timeout=600))

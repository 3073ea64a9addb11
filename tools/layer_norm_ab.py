#!/usr/bin/env python3
"""Kernel variants of the layer norm on bf16 rows, timed on one CUDA card
in turns.

    python tools/layer_norm_ab.py TREE [TREE ...]

Each TREE is a copy of this repository (say, one under the gitignored
build/ with its csrc/layer_norm.cu edited), run in turns by
tools/ab_trees.py (list a tree twice to run it twice: a b b a).  A run
builds the tree's kernels into TREE/build/torch_kernels and prints ptxas's
registers, shared memory and spills of the layer-norm kernels; checks bf16
rows on the v16 path (the training shape N 16384 D 512, N 4095 D 520, N 1
D 264, N 333 D 2048) against layer_norm_plain, y at chip_smoke's
LN_BF16_TOL and the stats at LN_TOL, and two calls for the same bits;
times the layer norm on bf16 rows cold (chip_smoke.time_ms over 8 rotated
x of 16 MiB) at the training shape on the v16 and the scalar path in
turns (v16, scalar, scalar, v16) and F.layer_norm once, each with its host
enqueue per call; times the bf16 block forward cold at the training shape
(B 32, T 512, H 8, D = E 512, F 2048) and lists one call's launches
(chip_smoke.block_breakdown), the two layer norms among them.  A tree
whose wrapper has no bf16 paths (a commit before them) is checked and
timed on the one kernel it has, twice, with its host enqueue.
"""
import sys

import ab_trees

CODE = r'''
import torch
import torch.nn.functional as F
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build, fused_block as fb
from paddle_tpu_torch.kernels import layer_norm as ln
_build.build()
_build.load()
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "C7518" in line:
        print(f"[ptxas] {line.strip()}")
    if "Compiling entry" in line and "ln_fwd" in line:
        print(f"[ptxas] {line.split('entry function')[-1].strip()}: "
              f"{log[i + 2].strip()}; {log[i + 3].strip()}")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(14)
bf = torch.bfloat16


def rnd(*s):
    return torch.randn(*s, generator=g, device=dev)


paths = hasattr(ln.layer_norm, "launches_v16")
kw = dict(path="v16") if paths else {}
for N, D in [(16384, 512), (4095, 520), (1, 264), (333, 2048)]:
    x = (rnd(N, D) * 2 + 0.5).to(bf)
    gam, bet = rnd(D) * 0.5, rnd(D) * 0.5
    n = ln.layer_norm.launches_v16 if paths else 0
    a = ln.layer_norm(x, gam, bet, 1e-5, **kw)
    b = ln.layer_norm(x, gam, bet, 1e-5, **kw)
    want = ln.layer_norm_plain(x, gam, bet, 1e-5)
    torch.cuda.synchronize()
    ey = cs.max_err(a[0], want[0])
    es = max(cs.max_err(a[1], want[1]), cs.max_err(a[2], want[2]))
    same = all(torch.equal(p, q) for p, q in zip(a, b))
    moved = ln.layer_norm.launches_v16 - n if paths else 2
    print(f"[check] N={N} D={D}: y {ey:.3g} (tol {cs.LN_BF16_TOL:g}), "
          f"stats {es:.3g} (tol {cs.LN_TOL:g}); two calls bit-identical: "
          f"{same}; v16 launches {moved if paths else 'no paths'}")
    if not (ey <= cs.LN_BF16_TOL and es <= cs.LN_TOL and same
            and moved == 2):
        raise SystemExit(f"the v16 layer norm disagrees: {ey}, {es}, {same}")
N, D = 16384, 512
gam, bet = rnd(D), rnd(D)
rot = cs.rotation(lambda: rnd(N, D).to(bf), 8)
for path in ("v16", "scalar", "scalar", "v16") if paths else ("kernel",) * 2:
    pk = dict(path=path) if paths else {}
    ms, host = cs.time_ms(lambda: ln.layer_norm(rot(), gam, bet, 1e-5,
                                                **pk))
    print(f"[time] layer norm bf16 N={N} D={D} cold, {path}: {ms:.4f} ms, "
          f"host enqueue {host:.4f} ms")
ms, host = cs.time_ms(lambda: F.layer_norm(rot(), (D,), gam.to(bf),
                                           bet.to(bf), 1e-5))
print(f"[time] F.layer_norm bf16 N={N} D={D} cold: {ms:.4f} ms, host "
      f"enqueue {host:.4f} ms")
del rot
B, T, H, D, FF = 32, 512, 8, 512, 2048
x, p = cs.block_inputs(rnd, B, T, D, FF)
p = cs.bf16_block_params(p)
rot = cs.rotation(lambda: rnd(B, T, D).to(bf))
ms, host = cs.time_ms(lambda: fb.transformer_block_bf16(rot(), p, H, True),
                      iters=10, warmup=2)
print(f"[time] bf16 block B={B} T={T} H={H} D={D} F={FF} cold: {ms:.4f} "
      f"ms, host enqueue {host:.4f} ms")
for name, r in cs.block_breakdown(torch, bf16=True, chain=7).items():
    print(f"[time]   {name}: {r['ms']:.4f} ms ({r['launches']} launches)")
'''

if __name__ == "__main__":
    sys.exit(ab_trees.run(sys.argv[1:], CODE, ("[ptxas", "[check", "[time"),
                          __doc__, timeout=300))

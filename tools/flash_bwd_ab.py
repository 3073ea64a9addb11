#!/usr/bin/env python3
"""Kernel variants of the bf16 flash backward, timed on one CUDA card in
turns.

    python tools/flash_bwd_ab.py TREE [TREE ...]

Each TREE is a copy of this repository (say, one under the gitignored
build/ with its csrc/flash_attention_bf16.cu edited), run in turns by
tools/ab_trees.py (list a tree twice to run it twice).  A run prints
ptxas's registers and spills of the d 64 and d 128 wgmma backward
kernels; checks four cases (causal,
d 128 at a ragged T, kv_len, T 200) on the wgmma path against the plain
version at chip_smoke's BF16_RTOL by tile and against the sync path's
bits; times the backward cold (chip_smoke.time_ms over rotated inputs) at
the training shape (B 32, H 8, T 512, d 64, causal) on head-major operands
and on the block recompute's [B, T, H, d] views, twice each; and splits
one call into its two launches (chip_smoke.flash_bwd_breakdown).  Lines
are tagged with the run.  Compare versions only inside one call: two calls
may land on two cards.
"""
import sys

import ab_trees

CODE = r'''
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build, flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
_build.load()
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "Compiling entry" in line and "_bf16_wg_kernel" in line \
            and "flash_bwd" in line:
        name = line.split("flash_bwd_")[1].split("EEEv")[0]
        print(f"[ptxas] flash_bwd_{name}: {log[i + 2].strip()}; "
              f"{log[i + 3].strip()}")
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(11)
bf = torch.bfloat16
for H, d, B, T, causal, kv in [(8, 64, 4, 512, True, None),
                               (4, 128, 2, 296, True, None),
                               (8, 64, 2, 384, False, 300),
                               (8, 64, 2, 200, True, None)]:
    q, k, v, do = (torch.randn(H, d, B * T, generator=g, device=dev).to(bf)
                   for _ in range(4))
    kw = dict(causal=causal, kv_len=kv)
    po, plse = fa.flash_attention_hdt_plain(q, k, v, B, **kw)
    delta = (do.float() * po.float()).sum(1, keepdim=True)
    args = (q, k, v, plse, delta, do, B)
    got = fa.flash_attention_hdt_bwd_bf16(*args, path="wgmma", **kw)
    sync = fa.flash_attention_hdt_bwd_bf16(*args, path="sync", **kw)
    want = fa.flash_attention_hdt_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    err = cs.tile_rel_err(got, want)
    same = all(torch.equal(a, b) for a, b in zip(got, sync))
    print(f"[check] H={H} d={d} B={B} T={T} causal={causal} kv_len={kv}: "
          f"{err:.3g} of the tile's max |plain| (tol {cs.BF16_RTOL:g}); "
          f"the sync path's bits: {same}")
    if not err <= cs.BF16_RTOL:
        raise SystemExit(f"the wgmma backward disagrees: {err}")
H, d, B, T = 8, 64, cs.TRAIN_BATCH, cs.TRAIN_T


def make(view):
    def one():
        if view:
            q, k, v, do = (cs.bthd_view(torch.randn(
                B, T, H * d, generator=g, device=dev).to(bf), H)
                for _ in range(4))
            o, lse = fa.flash_attention_bf16(q, k, v, True)
            return q, k, v, lse, (do.float() * o.float()).sum(-1), do
        q, k, v, do = (torch.randn(H, d, B * T, generator=g,
                                   device=dev).to(bf) for _ in range(4))
        o, lse = fa.flash_attention_hdt_bf16(q, k, v, B, causal=True)
        return q, k, v, lse, (do.float() * o.float()).sum(1, keepdim=True), do
    return cs.rotation(one)


hm, views = make(False), make(True)
for _ in range(2):
    t_hm, _ = cs.time_ms(lambda: fa.flash_attention_hdt_bwd_bf16(
        *hm(), B, causal=True, path="wgmma"), iters=20, warmup=3)
    t_v, _ = cs.time_ms(lambda: fa.flash_attention_bwd_bf16(
        *views(), True, path="wgmma"), iters=20, warmup=3)
    print(f"[time] bf16 flash backward B={B} H={H} T={T} d={d} causal, cold, "
          f"wgmma: head-major {t_hm:.4f} ms, [B,T,H,d] views {t_v:.4f} ms")
cs.flash_bwd_breakdown(torch)
'''


if __name__ == "__main__":
    sys.exit(ab_trees.run(sys.argv[1:], CODE, ("[ptxas", "[check", "[time",
                                               "[flash bwd"), __doc__))

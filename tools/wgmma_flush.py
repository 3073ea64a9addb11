"""The flush finding of the bf16 wgmma paths: the LM head's and the
block's GEMMs.

``csrc/wgmma_bf16.cuh`` (the LM head's backward), the wgmma forward of
``csrc/lm_head_bf16.cu`` and the block's wgmma GEMMs
(``csrc/fused_block_bf16.cu``) carry each output tile's whole k loop in
one accumulator.  A build with ``-DPTT_WG_FLUSH=n`` (n > 0) instead adds
each tile's products into a second accumulator every n k-tiles, as
``gemm_bf16.cuh`` does every k-tile, in case the tensor cores truncate as
they accumulate.  This script builds the kernels both ways, each build in
its own process (the flags are in the library's hash), and prints, for
each, the forward's largest absolute error on loss and lse against
``lm_head_fwd_plain`` beside HEAD_TOL, and dx's and dW's largest error over
the largest |plain| against ``lm_head_bwd_plain`` beside BF16_RTOL, at the
training shape (N 16384, D 512, V 32000, chunk 4096: dx's K is the whole
vocabulary in one range) and at a peaked case (N 2048, chunk 1024, x * 12,
|logit| up to about 80, five ignored labels: dx in K ranges); and the bf16
block's output on its wgmma GEMMs against ``transformer_block_plain``,
largest error over the largest |plain| beside BLOCK_BF16_RTOL, at the
training shape and at chip_smoke's "large W2 sums" case (B 4, W1 x 8: W2's
K 2048 loop sums large hidden units).

Run from the repository root on a machine with an H100:

    python tools/wgmma_flush.py            # flush 0 (shipped) and 1
    python tools/wgmma_flush.py 0 1 4      # the flush counts given

It is a measurement tool, not part of the package: nothing imports it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_RTOL = 4 * 2.0 ** -8   # chip_smoke.py's
BLOCK_BF16_RTOL = BF16_RTOL  # chip_smoke.py's
HEAD_TOL = 2e-4             # chip_smoke.py's
CASES = [  # N, D, V, chunk, ignored labels, scale of x
    (16384, 512, 32000, 4096, 0, 1),
    (2048, 512, 32000, 1024, 5, 12),
]
BLOCK_CASES = [  # B, T, H, D, F, scale of W1 (causal)
    (32, 512, 8, 512, 2048, 1),
    (4, 512, 8, 512, 2048, 8),
]


def measure(flush: int) -> list:
    """The errors of the build with PTT_WG_FLUSH=flush, one dict a case."""
    import torch
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import lm_head as lmh
    if flush:
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + [f"-DPTT_WG_FLUSH={flush}"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    g = torch.Generator(device="cuda").manual_seed(20261017)
    out = []
    for N, D, V, chunk, n_ign, amp in CASES:
        x = (torch.randn(N, D, generator=g, device="cuda") * amp).to(
            torch.bfloat16)
        w = (torch.randn(D, V, generator=g, device="cuda") * 0.05).to(
            torch.bfloat16)
        y = torch.randint(0, V, (N,), generator=g, device="cuda")
        y[torch.randperm(N, generator=g, device="cuda")[:n_ign]] = -1
        gl = torch.rand(N, generator=g, device="cuda") * (2.0 / N)
        ploss, lse = lmh.lm_head_fwd_plain(x, w, y)
        before = lmh.lm_head_fwd_bf16.launches_wgmma
        floss, flse = lmh.lm_head_fwd_bf16(x, w, y, path="wgmma")
        torch.cuda.synchronize()
        if lmh.lm_head_fwd_bf16.launches_wgmma == before:
            raise RuntimeError("the wgmma forward did not run")
        ferr = [float((a - b).abs().max())
                for a, b in ((floss, ploss), (flse, lse))]
        want = lmh.lm_head_bwd_plain(x, w, y, lse, gl, chunk)
        before = lmh.lm_head_bwd_bf16.launches_wgmma
        got = lmh.lm_head_bwd_bf16(x, w, y, lse, gl, chunk, path="wgmma")
        torch.cuda.synchronize()
        if lmh.lm_head_bwd_bf16.launches_wgmma == before:
            raise RuntimeError("the wgmma path did not run")
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(got, want)]
        out.append(dict(N=N, D=D, V=V, chunk=chunk, x_scale=amp,
                        ranges=lmh.bwd_bf16_plan(
                            chunk, D, V, torch.cuda.get_device_properties(
                                0).multi_processor_count)["ranges"],
                        loss=ferr[0], lse=ferr[1], dx=errs[0], dW=errs[1]))
    return out


def measure_block(flush: int) -> list:
    """The bf16 block's output errors on its wgmma GEMMs in the build with
    PTT_WG_FLUSH=flush, one dict a case (run after measure, in its
    process)."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import fused_block as fb
    g = torch.Generator(device="cuda").manual_seed(20261018)
    out = []
    for B, T, H, D, F, w1s in BLOCK_CASES:
        x, p = cs.block_inputs(
            lambda *s: torch.randn(*s, generator=g, device="cuda"), B, T, D,
            F, w1_scale=w1s)
        x, p = x.to(torch.bfloat16), cs.bf16_block_params(p)
        blk = fb.transformer_block_bf16
        before = blk.launches_gemm_wgmma
        got = blk(x, p, H, True, gemm_path="wgmma")
        want = fb.transformer_block_plain(x, p, H, True)
        torch.cuda.synchronize()
        if blk.launches_gemm_wgmma != before + 1:
            raise RuntimeError("the block's wgmma GEMMs did not run")
        out.append(dict(B=B, T=T, D=D, F=F, w1_scale=w1s,
                        out=cs.rel_err(got, want)))
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps([measure(int(argv[2])),
                          measure_block(int(argv[2]))]))
        return 0
    flushes = [int(a) for a in argv[1:]] or [0, 1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else "no card")
    env = dict(os.environ, PYTHONPATH=ROOT)
    for n in flushes:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", str(n)], cwd=ROOT, env=env,
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            return 1
        head, block = json.loads(res.stdout.strip().splitlines()[-1])
        for r in block:
            print(f"flush {n}{' (shipped)' if n == 0 else ''}: bf16 block "
                  f"B={r['B']} T={r['T']} D={r['D']} F={r['F']} W1 "
                  f"x{r['w1_scale']} on its wgmma GEMMs: out {r['out']:.3g} "
                  f"of max |plain| (tol {BLOCK_BF16_RTOL:g})")
        for r in head:
            print(f"flush {n}{' (shipped)' if n == 0 else ''}: N={r['N']} "
                  f"D={r['D']} V={r['V']} chunk={r['chunk']} "
                  f"x*{r['x_scale']}: forward loss {r['loss']:.3g}, lse "
                  f"{r['lse']:.3g} max abs err (tol {HEAD_TOL:g}); dx K "
                  f"ranges {r['ranges']}: dx {r['dx']:.3g}, dW "
                  f"{r['dW']:.3g} of max |plain| (tol {BF16_RTOL:g})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

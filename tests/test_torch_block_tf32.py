"""The numerics plan of the fused-block kernel on the CPU: 3xTF32.

The card's block forward (csrc/fused_block.cu) takes its four projections
(q/k/v as one product with [Wq|Wk|Wv], Wo, W1, W2) on gemm_tc.cuh's tile
loop: operands split into (hi, lo) TF32 pairs where they are produced,
three mma passes per k8 step, each mma's sum truncated, and the per-k-tile
accumulator added to an f32 sum every 32 k.  This file builds the block in
the kernel's order with test_torch_lm_head_tf32.py's emulation of that
loop (mm_tc) for each product and plain f32 attention between them
(test_torch_flash_tf32.py covers the attention's own 3xTF32), and holds it
against the port's plain version within chip_smoke's BLOCK_RTOL of max
|plain|, at the path's widths (D 512, E 512, F 2048, H 8: W2's k loop is
2048 long) and a few tokens, causal and not, and on a peaked case (W1 x 8:
large hidden units and W2 sums).  Single-pass TF32 misses BLOCK_RTOL in
every case (2.2e-4 to 4.2e-4 of max |plain|), so the card's block compare
would refuse it, and is at least 10x further from an f64 reference than
3xTF32.  On one case of
tests/test_torch_fused_block.py the emulation also matches the JAX
package's block_reference at that file's BLOCK_TOL.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.kernels import fused_block as jfb
from paddle_tpu_torch.kernels import fused_block as tfb
from test_torch_flash_tf32 import mm1
from test_torch_fused_block import BLOCK_CASES, BLOCK_TOL
from test_torch_fused_block import H as FB_H
from test_torch_fused_block import _block_inputs as fb_block_inputs
from test_torch_lm_head_tf32 import mm_one_acc, mm_tc

BLOCK_RTOL = chip_smoke.BLOCK_RTOL


def block_tc(x, p, H, causal, mm=mm_tc, mm_w2=None, eps1=1e-5, eps2=1e-5):
    """The block as fused_block.cu computes it, every projection through
    mm (W2's through mm_w2 when given): LN1, one q/k/v product with q
    scaled by an f32 1/sqrt(dh) in its epilogue, attention, h = x + o Wo,
    LN2, u = relu(f W1 + b1), out = h + (u W2 + b2).  x [B, T, D]."""
    ln1g, ln1b, wq, wk, wv, wo, ln2g, ln2b, w1, b1, w2, b2 = p
    B, T, D = x.shape
    E = wq.shape[1]
    dh = E // H
    x2 = x.reshape(B * T, D)
    a = tfb._ln_affine(x2, ln1g, ln1b, eps1)
    qkv = mm(a, torch.cat([wq, wk, wv], 1))
    qscale = torch.tensor(1.0 / math.sqrt(dh), dtype=x.dtype)

    def heads(t):                       # [N, E] -> [B, H, T, dh]
        return t.reshape(B, T, H, dh).transpose(1, 2)

    q, k, v = heads(qkv[:, :E] * qscale), heads(qkv[:, E:2 * E]), \
        heads(qkv[:, 2 * E:])
    s = q @ k.transpose(-1, -2)
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, tfb.NEG_INF)
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B * T, E)
    h = x2 + mm(o, wo)
    f = tfb._ln_affine(h, ln2g, ln2b, eps2)
    u = torch.relu(mm(f, w1) + b1)
    out = h + ((mm_w2 or mm)(u, w2) + b2)
    return out.reshape(B, T, D)


def _inputs(B, T, w1_scale, seed):
    """x and the params at the path's widths (chip_smoke.block_inputs'
    scales), from numpy."""
    rng = np.random.RandomState(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    return chip_smoke.block_inputs(rnd, B, T, 512, 2048, 512, w1_scale)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


H = 8
# (B, T, causal, scale of W1)
CASES = {
    "causal": (2, 48, True, 1.0),
    "noncausal": (1, 80, False, 1.0),
    "peaked": (1, 64, True, 8.0),
}
_RUNS = {}


def _run(case):
    """(x, params, plain, f64 plain, 3xTF32 emulation) of a case, once
    per process."""
    if case not in _RUNS:
        B, T, causal, w1s = CASES[case]
        x, p = _inputs(B, T, w1s, seed=B * 1000 + T)
        want = tfb.transformer_block_plain(x, p, H, causal)
        exact = tfb.transformer_block_plain(
            x.double(), tuple(t.double() for t in p), H, causal)
        _RUNS[case] = (x, p, want, exact, block_tc(x, p, H, causal))
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_block_matches_plain(case):
    x, p, want, exact, got3 = _run(case)
    causal = CASES[case][2]
    got1 = block_tc(x, p, H, causal, mm=mm1)
    assert got3.shape == want.shape
    assert _rel(got3, want) <= BLOCK_RTOL
    assert _rel(got1, want) > BLOCK_RTOL     # single pass is not f32-grade
    off3, off1 = _rel(got3, exact), _rel(got1, exact)
    assert off1 >= 10 * off3, (off1, off3)


def test_one_truncating_accumulator_through_w2_stays_within_block_rtol():
    """What the per-k-tile flush buys at the block's longest k loop: W2's
    2048 (768 truncating mma) on the peaked case, whose W2 sums and output
    are several times the unscaled block's.  Carried through all of them
    in one accumulator, the drift stays within BLOCK_RTOL (here 2.0e-5 of
    max |f64| against 7.9e-7 with the flush): the block's tolerance is
    relative to its largest output, where the LM head's HEAD_TOL is
    absolute on logits near 80.  The kernel keeps the flush all the same:
    it is the loop the LM head needs, and it keeps the drift more than an
    order of magnitude lower."""
    x, p, want, exact, got3 = _run("peaked")
    assert float(want.abs().max()) >= 3 * float(_run("causal")[2].abs().max())
    one = block_tc(x, p, H, CASES["peaked"][2], mm_w2=mm_one_acc)
    r_one, r_two = _rel(one, exact), _rel(got3, exact)
    assert r_one <= BLOCK_RTOL, r_one
    assert r_one >= 10 * r_two, (r_one, r_two)


def test_3xtf32_block_matches_jax_block_reference():
    """On tests/test_torch_fused_block.py's ragged causal case (D 64, E 64,
    F 128, H 4, T 80), the emulation against the JAX package's
    block_reference at that file's BLOCK_TOL."""
    case = next(c for c in BLOCK_CASES if c[1] == 80)
    B, Tn, causal = case
    x, p, _ = fb_block_inputs(B, Tn)
    want = np.asarray(jfb.block_reference(jnp.asarray(x),
                                          tuple(map(jnp.asarray, p)), FB_H,
                                          causal))
    got = block_tc(torch.from_numpy(x), tuple(map(torch.from_numpy, p)),
                   FB_H, causal)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < BLOCK_TOL

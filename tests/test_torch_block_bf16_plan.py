"""The bf16 block's four GEMMs on the wgmma path, as far as the CPU can
hold them.

The wgmma kernel (csrc/fused_block_bf16.cu, block_gemm_bf16_wg_kernel)
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).  Here:

- the path choice, a pure function of the operands' addresses and of D, E
  and F (``block_gemm_path``): TMA and the 16-byte epilogue need
  16-byte-aligned bases and rows of a multiple of 8 elements, else the
  sync path;
- the schedule of each of the four launches on 132 SMs
  (``block_gemm_plan``, ``block_gemm_tiles``): every output tile is
  covered once, no q/k/v tile straddles two weights, each CTA's share (and
  each consumer warpgroup's, which takes the CTA's tiles of one parity) is
  within one tile of the mean;
- the four epilogues' float order, emulated tile by tile from bf16
  operands with f32 products and one rounding (``scheduled_block``):
  held to the JAX ``transformer_block`` (Pallas in interpret mode, as
  tests/test_torch_amp_fused_block.py runs it) at that file's
  REF_BF16_TOL and to ``transformer_block_plain`` at chip_smoke's
  BLOCK_BF16_RTOL;
- two planted faults of that emulation (a schedule without Wv's last
  column tile, the q scale applied to k) are refused by more than 4x
  BLOCK_BF16_RTOL.
"""
import numpy as np
import pytest
import torch

from chip_smoke import BLOCK_BF16_RTOL, block_inputs
from paddle_tpu_torch.kernels import fused_block as tfb
from test_torch_amp_fused_block import (REF_BF16_TOL, _block_inputs,
                                        _jax_pallas)
from test_torch_fused_block import H

SMS = 132   # the H100 SXM's SMs
TRAIN = (32, 512, 512, 512, 2048)   # the training step's B, T, D, E, F
BASE = 0x7f0000000000


def _ptrs(off=0, which=None):
    """Nine 16-byte-aligned addresses (x, six matrices, out, workspace),
    the one at index `which` moved by `off` bytes."""
    return [BASE + 0x100000 * i + (off if i == which else 0)
            for i in range(9)]


@pytest.mark.parametrize("ptrs,D,E,F,want", [
    (_ptrs(), 512, 512, 2048, "wgmma"),          # training
    (_ptrs(), 264, 192, 520, "wgmma"),           # multiples of 8, not 128
    (_ptrs(), 8, 8, 8, "wgmma"),
    (_ptrs(2, 0), 512, 512, 2048, "sync"),       # x 2 bytes off
    (_ptrs(8, 3), 512, 512, 2048, "sync"),       # wv 8 bytes off
    (_ptrs(4, 6), 512, 512, 2048, "sync"),       # w2 4 bytes off
    (_ptrs(2, 7), 512, 512, 2048, "sync"),       # out 2 bytes off
    (_ptrs(), 201, 128, 333, "sync"),            # odd D and F
    (_ptrs(), 516, 512, 2048, "sync"),           # D 8 bytes off
    (_ptrs(), 512, 196, 2048, "sync"),           # E
    (_ptrs(), 512, 512, 2052, "sync"),           # F
])
def test_gemm_path_choice(ptrs, D, E, F, want):
    assert tfb.block_gemm_path(ptrs, D, E, F) == want


def test_training_plans_on_132_sms():
    """The four launches at the training shape: 1536, 512, 2048 and 512
    tiles of 128 x 128 (11.6, 3.9, 15.5 and 3.9 waves), each on 132
    persistent CTAs."""
    plans = {name: tfb.block_gemm_plan(*dims, SMS) for name, dims in
             tfb.block_gemm_launches(*TRAIN).items()}
    assert {n: (p["tiles"], p["ctas"], p["k_tiles"])
            for n, p in plans.items()} == {
        "qkv": (1536, 132, 8), "wo": (512, 132, 8), "w1": (2048, 132, 8),
        "w2": (512, 132, 32)}
    assert plans["qkv"]["n_tiles"] == 4 and plans["qkv"]["weights"] == 3


# (B, T, D, E, F): the training shape, E 192 (H 3, a column tile past E),
# D 264 and F 520 (ragged k and column tiles), N 600 (a ragged row tile),
# and fewer tiles than SMs
SCHEDULE_SHAPES = [TRAIN, (2, 300, 512, 192, 2048), (2, 300, 264, 192, 520),
                   (2, 300, 512, 512, 2048), (1, 8, 64, 64, 128)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_schedule_covers_every_tile_once(shape):
    B, T, D, E, F = shape
    for name, (M, N, K, nw) in tfb.block_gemm_launches(*shape).items():
        p = tfb.block_gemm_plan(M, N, K, nw, SMS)
        assert p["ctas"] == min(SMS, p["tiles"])
        # each output element's writer, by (row tile, output column)
        seen = np.zeros((p["m_tiles"], nw * N), np.int64)
        per_cta, per_wg = [], []
        for c in range(p["ctas"]):
            tiles = tfb.block_gemm_tiles(p, c)
            per_cta.append(len(tiles))
            per_wg += [len(tiles[0::2]), len(tiles[1::2])]
            for m, z, n in tiles:
                assert 0 <= m < p["m_tiles"] and 0 <= n < p["n_tiles"]
                c0 = z * N + n * 128
                c1 = z * N + min(N, (n + 1) * 128)
                # no tile straddles two weights: its columns lie in z's
                assert z * N <= c0 < c1 <= (z + 1) * N, (name, m, z, n)
                seen[m, c0:c1] += 1
        assert (seen == 1).all(), name
        assert sum(per_cta) == p["tiles"]
        mean = p["tiles"] / p["ctas"]
        assert all(abs(n - mean) < 1 for n in per_cta), name
        assert all(abs(n - mean / 2) <= 1 for n in per_wg), name


def test_columns_run_fastest():
    """The CTAs that run at one time share A's row tiles: flat tiles 0-11
    of q/k/v at the training shape are row tile 0's twelve column tiles,
    Wq's four, then Wk's, then Wv's."""
    p = tfb.block_gemm_plan(*tfb.block_gemm_launches(*TRAIN)["qkv"], SMS)
    first = [tfb.block_gemm_tiles(p, c)[0] for c in range(13)]
    assert first == [(0, z, n) for z in range(3) for n in range(4)] + [
        (1, 0, 0)]
    assert tfb.block_gemm_tiles(p, 5)[:2] == [(0, 1, 1), (11, 1, 1)]


def scheduled_block(fb, x, params, H, causal, sms, drop=None,
                    scale_k=False):
    """out [B, T, D] bf16 of the bf16 block with its four products written
    tile by tile as the wgmma path's schedule writes them
    (fb.block_gemm_plan and block_gemm_tiles on `sms` SMs): each tile an
    f32 sum of products of the bf16 operands, through its epilogue in
    the kernel's float order (epi_value), rounded once: q = bf16(acc *
    scale), k, v = bf16(acc * 1), h = bf16(x + acc), u = bf16(max(acc +
    b1, 0)), out = bf16(h + (acc + b2)); the layer norms and the
    attention (scale 1 on the scaled q) plain.  On either device.  Two
    planted faults: drop = (product, weight, column tile), a schedule
    without that column tile of that weight in any row tile (an
    off-by-one in the weight's column tiles); scale_k, the q scale applied
    to k's tiles too."""
    ln1g, ln1b, wq, wk, wv, wo, ln2g, ln2b, w1, b1, w2, b2 = params
    bf, f32 = torch.bfloat16, torch.float32
    B, T, D = x.shape
    E, F = wq.shape[1], w1.shape[1]
    dh = E // H
    scale = float(torch.tensor(1.0) / torch.tensor(float(dh)).sqrt())
    launches = fb.block_gemm_launches(B, T, D, E, F)

    def product(name, A, ws, resid=None, bias=None):
        M, Nw, K, nw = launches[name]
        plan = fb.block_gemm_plan(M, Nw, K, nw, sms)
        acc = [A.reshape(M, K).float() @ w.float() for w in ws]
        y = torch.zeros(M, nw * Nw, dtype=bf, device=A.device)
        for c in range(plan["ctas"]):
            for m, z, n in fb.block_gemm_tiles(plan, c):
                if drop == (name, z, n):
                    continue
                r = slice(m * 128, min(M, (m + 1) * 128))
                cols = slice(n * 128, min(Nw, (n + 1) * 128))
                a = acc[z][r, cols]
                if name == "qkv":
                    v = a * (scale if z == 0 or (scale_k and z == 1)
                             else 1.0)
                elif name == "wo":
                    v = resid[r, cols].float() + a
                elif name == "w1":
                    v = torch.clamp_min(a + bias[cols].to(f32), 0.0)
                else:
                    v = resid[r, cols].float() + (a + bias[cols].to(f32))
                y[r, z * Nw + cols.start:z * Nw + cols.stop] = v.to(bf)
        return y

    a = fb._ln_affine(x, ln1g, ln1b, 1e-5).to(bf)
    qkv = product("qkv", a, (wq, wk, wv)).reshape(B, T, 3, H, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2).float() for i in range(3))
    s = q @ k.transpose(-1, -2)
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1).to(bf)
    o = (p.float() @ v).to(bf).transpose(1, 2).reshape(B * T, E)
    h = product("wo", o, (wo,), resid=x.reshape(B * T, D))
    f = fb._ln_affine(h, ln2g, ln2b, 1e-5).to(bf)
    u = product("w1", f, (w1,), bias=b1)
    return product("w2", u, (w2,), resid=h, bias=b2).reshape(B, T, D)


def _wv_last_tile(B, T, D, E, F, sms):
    """Wv's last column tile, which a schedule with one column tile too
    few for the last weight drops in every row tile."""
    M, N, K, nw = tfb.block_gemm_launches(B, T, D, E, F)["qkv"]
    return "qkv", 2, tfb.block_gemm_plan(M, N, K, nw, sms)["n_tiles"] - 1


# (B, T, causal, SMs): the JAX Pallas cases of
# tests/test_torch_amp_fused_block.py (D = E 64, F 128, H 4: a power-of-two
# q scale), on few SMs so that a CTA takes several tiles
PALLAS_CASES = [(2, 128, True, 3), (2, 80, True, 2)]


@pytest.mark.parametrize("params", ["op", "bf16"])
@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_epilogue_order_matches_pallas_and_plain(case, params):
    B, T, causal, sms = case
    tx, tp = _block_inputs(B, T, params)
    got = scheduled_block(tfb, tx, tp, H, causal, sms)
    plain = tfb.transformer_block_plain(tx, tp, H, causal)
    want = _jax_pallas((B, T, causal), params)[0]
    assert got.dtype == torch.bfloat16
    ref = np.asarray(want).astype(np.float32)
    rel = float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())
    assert rel < REF_BF16_TOL, rel
    err = float((got.float() - plain.float()).abs().max()
                / plain.float().abs().max())
    assert err <= BLOCK_BF16_RTOL, err


def _seeded(B, T, D, E, F, seed):
    g = torch.Generator().manual_seed(seed)
    x, p = block_inputs(lambda *s: torch.randn(*s, generator=g), B, T, D, F,
                        E)
    return x.to(torch.bfloat16), tuple(
        t.to(torch.bfloat16) if t.ndim == 2 else t for t in p)


# (B, T, H, D, E, F, causal, SMs): chip_smoke's wgmma compare case of
# multiples of 8 that are not of 128 (head dim 64: q scale 1/8), and one
# where E is a multiple of 128
ODD_CASES = [(2, 300, 3, 264, 192, 520, True, 132),
             (1, 200, 4, 128, 256, 256, False, 7)]


@pytest.mark.parametrize("case", ODD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_epilogue_order_on_ragged_tiles_matches_plain(case):
    B, T, H_, D, E, F, causal, sms = case
    x, p = _seeded(B, T, D, E, F, seed=B + T + D)
    got = scheduled_block(tfb, x, p, H_, causal, sms)
    plain = tfb.transformer_block_plain(x, p, H_, causal)
    err = float((got.float() - plain.float()).abs().max()
                / plain.float().abs().max())
    assert err <= BLOCK_BF16_RTOL, err


@pytest.mark.parametrize("fault", ["drop_wv_last_tile", "q_scale_on_k"])
@pytest.mark.parametrize("case", [PALLAS_CASES[0], ODD_CASES[0]],
                         ids=["pallas", "odd"])
def test_planted_faults_are_refused(case, fault):
    """Each planted fault moves the block's output by more than 4x
    BLOCK_BF16_RTOL of max |plain|."""
    if len(case) == 4:
        B, T, causal, sms = case
        x, p = _block_inputs(B, T, "op")
        H_, D, E, F = H, x.shape[2], p[2].shape[1], p[8].shape[1]
    else:
        B, T, H_, D, E, F, causal, sms = case
        x, p = _seeded(B, T, D, E, F, seed=B + T + D)
    kw = (dict(drop=_wv_last_tile(B, T, D, E, F, sms))
          if fault == "drop_wv_last_tile" else dict(scale_k=True))
    got = scheduled_block(tfb, x, p, H_, causal, sms, **kw)
    plain = tfb.transformer_block_plain(x, p, H_, causal)
    err = float((got.float() - plain.float()).abs().max()
                / plain.float().abs().max())
    assert err > 4 * BLOCK_BF16_RTOL, err

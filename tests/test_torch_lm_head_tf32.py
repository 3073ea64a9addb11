"""The numerics plan of the LM-head kernels on the CPU: 3xTF32.

The card's LM-head forward and backward kernels (csrc/lm_head.cu on the
tile loop of csrc/gemm_tc.cuh) take every product on the TF32 tensor cores
in three passes: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
a.b = lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b).  This file emulates the
loop with the int32 rounding of test_torch_flash_tf32.py and a model of
how the tensor cores accumulate: each mma.sync m16n8k8 adds its 8 exact
products to its accumulator and rounds the sum toward zero.  The loop
runs the three passes of each k8 step into one accumulator and adds it
to a second f32 sum (round to nearest) after every k-tile of 32, then
zeroes it.  From that product it builds the streamed LM head in the
kernels' order: the forward's running (max, sum of exp, gold) per lane
over vocab tiles of 128, merged over the quad, the warps and the
vocabulary shares in order; the backward chunk by chunk (the dlogits
recompute, dx = dlogits W^T over K ranges summed in order, dW summed
over the chunks), with the tile, share and range counts the kernels pick
on an H100.  It holds the result against the port's plain versions
within chip_smoke's tolerances (HEAD_TOL abs on loss and lse, BWD_RTOL of
max |plain| on dx and dW) at a ragged, an odd-D, a peaked and a
below-one-tile case.  Single-pass TF32 is at least 10x further from an
f64 reference in every case, and one truncating accumulator carried
through the whole k loop misses HEAD_TOL on the peaked case, as it did
on the card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.kernels import lm_head as lmh
from test_torch_flash_tf32 import mm1, tf32

HEAD_TOL = chip_smoke.HEAD_TOL
BWD_RTOL = chip_smoke.BWD_RTOL
BM = BN = 128      # gemm_tc.cuh kBM, kBN: a CTA's tile; the forward's vocab tile
BK = 32            # gemm_tc.cuh kBK: the k-tile
SMS, WAVES = 132, 4   # the H100's SMs, lm_head.cu kWaves
LOG2E = 1.4426950408889634
NEG = -1e30        # lm_head.cu kNegInf


def cdiv(a, b):
    return -(-a // b)


def fwd_plan(N, V):
    """lm_head.cu fwd_plan: (vocab tiles per share, shares)."""
    mt, nt = cdiv(N, BM), cdiv(V, BN)
    s = min(max(cdiv(WAVES * SMS, mt), 1), nt)
    per = cdiv(nt, s)
    return per, cdiv(nt, per)


def dx_plan(C, D, V):
    """lm_head.cu dx_plan: (length of a K range, ranges) of dx."""
    kt = cdiv(V, BK)
    s = min(max(cdiv(WAVES * SMS, cdiv(C, BM) * cdiv(D, BN)), 1), kt)
    kchunk = cdiv(kt, s) * BK
    return kchunk, cdiv(V, kchunk)


def trunc32(x):
    """f64 x to f32, rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mm_tc(a, b, flush=True):
    """a @ b as gemm_tc.cuh's run_tiles sums it: per k8 step the passes
    lo.hi, hi.lo, hi.hi, each an mma that adds 8 exact products to the
    accumulator and truncates; the accumulator added to an f32 sum and
    zeroed after every k-tile.  flush=False carries one accumulator
    through the whole k loop (the design the card rejected)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    K = a.shape[1]
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    for k0 in range(0, K, 8):
        ks = slice(k0, k0 + 8)
        for p, q in ((al, bh), (ah, bl), (ah, bh)):
            part = trunc32(part.double() + p[:, ks].double() @ q[ks].double())
        if flush and ((k0 + 8) % BK == 0 or k0 + 8 >= K):
            acc = acc + part
            part = torch.zeros_like(acc)
    return acc + part


def mm_one_acc(a, b):
    return mm_tc(a, b, flush=False)


def merge(a, b):
    """lm_head.cu merge of two running (max, sum of exp) states."""
    m = torch.maximum(a[0], b[0])
    return m, (a[1] * torch.exp2((a[0] - m) * LOG2E)
               + b[1] * torch.exp2((b[0] - m) * LOG2E))


def head_fwd(x, w, y, mm):
    """(loss, lse) as the forward kernel takes them.  A lane (warp wn
    along the vocab tile, quad lane t) folds columns 32 wn + 8 j + 2 t + e
    (j < 4, e < 2) of each tile of its share into its own running state,
    in that order; then the quad's lanes, the 4 warps and the shares
    merge in order.  The gold logit is the one term the kernel's gold sums
    add."""
    s = mm(x, w)
    N, V = s.shape
    per, shares = fwd_plan(N, V)
    nt = cdiv(V, BN)
    pad = torch.zeros(N, nt * BN)
    pad[:, :V] = s
    # [N, tile, wn, t, 8]: each lane's 8 columns of a tile, in (j, e) order
    lanes = pad.view(N, nt, 4, 4, 4, 2).permute(0, 1, 2, 4, 3, 5).reshape(
        N, nt, 4, 4, 8)
    valid = (torch.arange(nt * BN) < V).view(nt, 4, 4, 4, 2).permute(
        0, 1, 3, 2, 4).reshape(nt, 4, 4, 8)
    total = (torch.full((N,), NEG), torch.zeros(N))
    for k in range(shares):
        m, l = torch.full((N, 4, 4), NEG), torch.zeros(N, 4, 4)
        for tile in range(k * per, min((k + 1) * per, nt)):
            blk, ok = lanes[:, tile], valid[tile]
            mn = torch.maximum(m, torch.where(ok, blk, NEG).amax(-1))
            terms = torch.where(ok, torch.exp2((blk - mn[..., None]) * LOG2E),
                                0.0)
            add = torch.zeros_like(l)
            for q in range(8):
                add = add + terms[..., q]
            l = l * torch.exp2((m - mn) * LOG2E) + add
            m = mn
        quad = [(m[..., t], l[..., t]) for t in range(4)]
        st = merge(merge(quad[0], quad[1]), merge(quad[2], quad[3]))
        share = (st[0][:, 0], st[1][:, 0])
        for wn in range(1, 4):
            share = merge(share, (st[0][:, wn], st[1][:, wn]))
        total = merge(total, share)
    lse = total[0] + torch.log(total[1].clamp(min=1e-30))
    yl = y.long()
    gold = s[torch.arange(N), yl.clamp(min=0)]
    return torch.where(yl >= 0, lse - gold, 0.0), lse


def head_bwd(x, w, y, lse, g, chunk, mm):
    """(dx, dw) as the backward kernel's chunks take them: dlogits
    recomputed, dx over the K ranges of dx_plan summed in range order, dW
    summed over the chunks in chunk order."""
    yl = y.long()
    gm = g * (yl >= 0).to(g.dtype)
    N, D = x.shape
    V = w.shape[1]
    cap = max(1, min(chunk, N))
    kchunk, _ = dx_plan(cap, D, V)
    wt = w.t()
    dx = torch.empty_like(x)
    dw = None
    for r0 in range(0, N, cap):
        sl = slice(r0, min(r0 + cap, N))
        onehot = (torch.arange(V)[None, :] == yl[sl, None]).to(x.dtype)
        dl = (torch.exp2((mm(x[sl], w) - lse[sl, None]) * LOG2E)
              - onehot) * gm[sl, None]
        parts = [mm(dl[:, k0:k0 + kchunk], wt[k0:k0 + kchunk])
                 for k0 in range(0, V, kchunk)]
        d = parts[0]
        for p in parts[1:]:
            d = d + p
        dx[sl] = d
        p = mm(x[sl].t(), dl)
        dw = p if dw is None else dw + p
    return dx, dw


def _inputs(N, D, V, n_ignored, amp, ydtype, seed):
    """x (times amp), w at the op's init scale, labels with n_ignored
    negatives, and a loss cotangent of about 1/N."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32)) * amp
    w = torch.from_numpy(rng.randn(D, V).astype(np.float32)) * 0.05
    y = rng.randint(0, V, size=N)
    y[rng.permutation(N)[:n_ignored]] = -1
    g = torch.from_numpy((rng.rand(N) * 2.0 / N).astype(np.float32))
    return x, w, torch.from_numpy(y.astype(ydtype)), g


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


# (N, D, V, chunk, ignored labels, scale of x, label dtype); the peaked
# case is chip_smoke's (D 512, x x 12, |logit| up to about 80) at a
# CPU-sized N and V
CASES = {
    "ragged": (300, 64, 1001, 128, 7, 1.0, np.int64),
    "odd_d": (257, 201, 500, 100, 5, 1.0, np.int32),
    "peaked": (256, 512, 1000, 64, 3, 12.0, np.int64),
    "below_one_tile": (5, 12, 100, 4096, 1, 1.0, np.int64),
}


def _fwd_inputs(case):
    N, D, V, _, n_ign, amp, ydt = CASES[case]
    return _inputs(N, D, V, n_ign, amp, ydt, seed=N + D + V)


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_lm_head_forward_matches_plain(case):
    x, w, y, _ = _fwd_inputs(case)
    want = lmh.lm_head_fwd_plain(x, w, y)
    exact = lmh.lm_head_fwd_plain(x.double(), w.double(), y)
    got3 = head_fwd(x, w, y, mm_tc)
    got1 = head_fwd(x, w, y, mm1)
    if case == "peaked":
        assert float(exact[1].abs().max()) >= 50.0
    assert max(_max_err(a, b) for a, b in zip(got3, want)) <= HEAD_TOL
    assert bool((got3[0][y < 0] == 0).all())
    off3 = max(_max_err(a, b) for a, b in zip(got3, exact))
    off1 = max(_max_err(a, b) for a, b in zip(got1, exact))
    assert off1 >= 10 * off3, (off1, off3)


def test_one_truncating_accumulator_misses_head_tol_when_peaked():
    """Why the loop flushes its accumulator every k-tile: carried through
    all 192 mma of a D-512 logit, truncation pulls peaked logits past
    HEAD_TOL."""
    x, w, y, _ = _fwd_inputs("peaked")
    want = lmh.lm_head_fwd_plain(x, w, y)
    one = max(_max_err(a, b)
              for a, b in zip(head_fwd(x, w, y, mm_one_acc), want))
    two = max(_max_err(a, b) for a, b in zip(head_fwd(x, w, y, mm_tc), want))
    assert one > HEAD_TOL >= two, (one, two)


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_lm_head_backward_matches_plain(case):
    N, D, V, chunk, n_ign, amp, ydt = CASES[case]
    x, w, y, g = _inputs(N, D, V, n_ign, amp, ydt, seed=N + D + V + 1)
    lse = lmh.lm_head_fwd_plain(x, w, y)[1]
    lse64 = lmh.lm_head_fwd_plain(x.double(), w.double(), y)[1]
    want = lmh.lm_head_bwd_plain(x, w, y, lse, g, chunk)
    exact = lmh.lm_head_bwd_plain(x.double(), w.double(), y, lse64,
                                  g.double(), chunk)
    got3 = head_bwd(x, w, y, head_fwd(x, w, y, mm_tc)[1], g, chunk, mm_tc)
    got1 = head_bwd(x, w, y, head_fwd(x, w, y, mm1)[1], g, chunk, mm1)
    for a, b in zip(got3, want):
        assert _max_err(a, b) <= BWD_RTOL * float(b.abs().max())
    off3 = max(_max_err(a, b) / float(b.abs().max())
               for a, b in zip(got3, exact))
    off1 = max(_max_err(a, b) / float(b.abs().max())
               for a, b in zip(got1, exact))
    assert off1 >= 10 * off3, (off1, off3)

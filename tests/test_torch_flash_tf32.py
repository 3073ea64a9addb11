"""The numerics plan of the flash kernels on the CPU: 3xTF32.

The card's flash forward and backward kernels take every product on the
TF32 tensor cores with the three-pass split (csrc/flash_mma.cuh): x = hi +
lo with hi = tf32(x) (cvt.rna: round to nearest, ties away from zero, 10
mantissa bits) and lo = tf32(x - hi), and a.b = lo(a).hi(b) + hi(a).lo(b) +
hi(a).hi(b).  This file emulates that rounding with int32 bit arithmetic,
builds attention forward and backward from the emulated product at small
shapes, and holds them against the port's plain versions within
chip_smoke's tolerances (FA_TOL abs on o and lse, BWD_RTOL of max |plain|
on the gradients).  It also shows why the split is there: single-pass TF32
is at least 10x further off.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.kernels import flash_attention as fa

FA_TOL = chip_smoke.FA_TOL
BWD_RTOL = chip_smoke.BWD_RTOL


def tf32(x):
    """cvt.rna.tf32.f32 on f32 x: add half a unit of the 13 dropped bits to
    the magnitude bits, then clear them (sign-magnitude, so ties round away
    from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernels take it: three TF32 products into an f32 sum,
    the small terms first."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a, b):
    """a @ b in single-pass TF32."""
    return tf32(a) @ tf32(b)


def attention_fwd(q, k, v, causal, scale, kv_len, mm):
    """(o, lse) on [B, H, T, d], every product through mm."""
    s = mm(q * scale, k.transpose(-1, -2))
    Tq, Tk = s.shape[-2:]
    keep = torch.ones(Tq, Tk, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if kv_len is not None:
        keep = keep & (torch.arange(Tk) < kv_len)
    s = s.masked_fill(~keep, fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l))[..., 0]


def attention_bwd(q, k, v, lse, delta, do, causal, scale, kv_len, mm):
    """(dq, dk, dv) on [B, H, T, d] as the backward kernels take them: s
    and dp recomputed, scale applied in the exponent and to dq and dk."""
    s = mm(q, k.transpose(-1, -2)) * scale
    Tq, Tk = s.shape[-2:]
    keep = torch.ones(Tq, Tk, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if kv_len is not None:
        keep = keep & (torch.arange(Tk) < kv_len)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None])
    dq = scale * mm(ds, k)
    dk = scale * mm(ds.transpose(-1, -2), q)
    dv = mm(p.transpose(-1, -2), do)
    return dq, dk, dv


def _inputs(B, H, T, d, amp, seed):
    """q and k times amp (amp 4: a peaked softmax), v and do as drawn."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, T, d).astype(np.float32))
                   for _ in range(4))
    return q * amp, k * amp, v, do


def _hm(t):
    """[B, H, T, d] -> the head-major [H, d, B*T]."""
    B, H, T, d = t.shape
    return t.permute(1, 3, 0, 2).reshape(H, d, B * T).contiguous()


def _rows(t):
    """[B, H, T] -> [H, 1, B*T]."""
    B, H, T = t.shape
    return t.permute(1, 0, 2).reshape(H, 1, B * T).contiguous()


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie rounds away
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                     # below half a unit
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),    # above half a unit
    (2.0 - 2.0 ** -12, 2.0),                     # carries into the exponent
])
def test_tf32_rounding(x, want):
    assert tf32(torch.tensor([x], dtype=torch.float32)).item() == want


def test_split_is_exact_to_f32_grade():
    """hi + lo keeps 21 or more bits of x; hi alone 11."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    assert ((hi.double() - x.double()).abs()
            / x.double().abs()).max().item() <= 2.0 ** -11


# (d, T, causal, kv_len, scale of q and k, layout)
CASES = [
    (64, 64, True, None, 1, "bhtd"),
    (64, 130, True, None, 1, "bhtd"),
    (128, 64, False, None, 1, "bhtd"),
    (128, 130, True, None, 1, "bhtd"),
    (64, 130, False, 100, 1, "hdt"),
    (64, 64, True, None, 4, "bhtd"),       # peaked
    (128, 130, False, 77, 4, "hdt"),       # peaked, kv_len
    (64, 130, True, None, 4, "hdt"),       # peaked, causal
]


def _fwd_plain(q, k, v, causal, kv_len, layout, B):
    if layout == "hdt":
        o, lse = fa.flash_attention_hdt_plain(_hm(q), _hm(k), _hm(v), B,
                                              causal=causal, kv_len=kv_len)
        return o, lse
    return fa.flash_attention_plain(q, k, v, causal)


def _to_layout(o, lse, layout):
    if layout == "hdt":
        return _hm(o), _rows(lse)
    return o, lse


@pytest.mark.parametrize("d,T,causal,kv_len,amp,layout", CASES)
def test_3xtf32_forward_matches_plain(d, T, causal, kv_len, amp, layout):
    B, H = 2, 2
    q, k, v, _ = _inputs(B, H, T, d, amp, seed=d + T + amp)
    scale = 1.0 / math.sqrt(d)
    want = _fwd_plain(q, k, v, causal, kv_len, layout, B)
    exact = _fwd_plain(q.double(), k.double(), v.double(), causal, kv_len,
                       layout, B)
    got3 = _to_layout(*attention_fwd(q, k, v, causal, scale, kv_len, mm3),
                      layout)
    got1 = _to_layout(*attention_fwd(q, k, v, causal, scale, kv_len, mm1),
                      layout)
    err3 = max(_max_err(a, b) for a, b in zip(got3, want))
    assert err3 <= FA_TOL
    off3 = max(_max_err(a, b) for a, b in zip(got3, exact))
    off1 = max(_max_err(a, b) for a, b in zip(got1, exact))
    assert off1 >= 10 * off3, (off1, off3)


@pytest.mark.parametrize("d,T,causal,kv_len,amp,layout", CASES)
def test_3xtf32_backward_matches_plain(d, T, causal, kv_len, amp, layout):
    B, H = 2, 2
    q, k, v, do = _inputs(B, H, T, d, amp, seed=d + T + amp + 1)
    scale = 1.0 / math.sqrt(d)
    o, lse = attention_fwd(q.double(), k.double(), v.double(), causal,
                           scale, kv_len, torch.matmul)
    o, lse = o.float(), lse.float()
    delta = (do * o).sum(-1)
    if layout == "hdt":
        want = fa.flash_attention_hdt_bwd_plain(
            _hm(q), _hm(k), _hm(v), _rows(lse), _rows(delta), _hm(do), B,
            causal=causal, kv_len=kv_len)
        exact = fa.flash_attention_hdt_bwd_plain(
            *(_hm(t.double()) for t in (q, k, v)), _rows(lse.double()),
            _rows(delta.double()), _hm(do.double()), B, causal=causal,
            kv_len=kv_len)
        conv = _hm
    else:
        want = fa.flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)
        exact = fa.flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, lse, delta, do)), causal)

        def conv(t):
            return t

    def run(mm):
        return [conv(t) for t in attention_bwd(q, k, v, lse, delta, do,
                                               causal, scale, kv_len, mm)]

    got3, got1 = run(mm3), run(mm1)
    top = max(float(w.abs().max()) for w in want)
    assert max(_max_err(a, b) for a, b in zip(got3, want)) <= BWD_RTOL * top
    off3 = max(_max_err(a, b) for a, b in zip(got3, exact))
    off1 = max(_max_err(a, b) for a, b in zip(got1, exact))
    assert off1 >= 10 * off3, (off1, off3)

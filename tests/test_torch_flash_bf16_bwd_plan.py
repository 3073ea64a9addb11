"""The bf16 flash backward's wgmma path, as far as the CPU can hold it.

The wgmma kernels (csrc/flash_attention_bf16.cu flash_bwd_dkv_bf16_wg_kernel
and flash_bwd_dq_bf16_wg_kernel) run only on the card (chip_smoke.py,
tests/test_torch_cuda.py).  Here:

- the path choice, a pure function of the operands' addresses, strides and
  extents (``bwd_bf16_path``): TMA needs 16-byte-aligned bases, q, k and v
  in one orientation (all feature stride 1, or all token stride 1 with
  T % 8 == 0), do and each of dq, dk, dv in its own, and every other
  stride a multiple of 16 bytes, else the sync path.  Every bf16 flash
  compare case of chip_smoke.py, the mixed orientations among them, and
  the two training call sites;
- the persistent schedules: the dk/dv kernel's (``bwd_bf16_schedule``) and
  the dq kernel's (the forward's ``fwd_bf16_schedule``) take every work
  tile once, each CTA's causal work within one heavy tile of the others;
- the wgmma kernels' summation order, emulated in f32 on the CPU: dv and
  dk summed over the dk/dv kernel's query blocks in order (128 queries at
  d 64, 64 at d 128; the blocks before a key's causal diagonal add exact
  zeros, so starting there or at 0 gives the same bits), dq over blocks of
  64 keys, with p and ds rounded to bf16 per block and each gradient
  rounded once.  The emulation is held to the Pallas
  kernels in interpret mode (``_flash_bwd_hdt`` and ``_flash_bwd`` on bf16
  inputs, T zero-padded to 128 with kv_len where it is ragged) run with the
  same blocks at the tolerance of test_torch_amp.py (one bf16 step at the
  largest entry, 99 % of the entries the same bits; measured 99.79-99.99 %
  for dq, whose key blocks the Pallas kernel adds as scaled partials in
  XLA's order, and 99.99-100 % for dk and dv), and to
  the plain backward (``flash_attention_hdt_bwd_plain``, one sum over all
  keys) within one bf16 step and at chip_smoke's BF16_RTOL by tile.  Head
  dims whose scale is a power of two (d 64; d 128 with scale 1/8), as
  test_torch_amp.py explains.
"""
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (BF16_RTOL, FLASH_BHTD_BF16_CASES,
                        FLASH_HDT_BF16_CASES, bhtd_bf16_operands,
                        hdt_bf16_operands, tile_rel_err)
from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_amp import _jbf, _np, _tbf, assert_bf16_close
from test_torch_flash_bf16_plan import _padded, _within_step

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")

SMS = 132   # the H100 SXM's SMs
BF = torch.bfloat16


def _rnd(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=g)


def _shrunk(case):
    """A training-batch case cut to batch 2 (the path depends on strides
    and extents, not on the batch count, above 1)."""
    return (case[:2] + (2,) + case[3:]) if case[2] > 8 else case


# the backward's path on each chip_smoke case, in the lists' order: T not a
# multiple of 8, a token-strided q (with k and v head-major: q, k, v in two
# orientations) and operands 2 bytes off alignment take sync; the last
# case's do, in the other orientation than q, k and v, takes wgmma
HDT_BWD_WANT = ["wgmma", "sync", "sync", "sync", "sync", "sync", "sync",
                "wgmma", "sync", "wgmma", "wgmma", "wgmma", "wgmma", "wgmma",
                "wgmma", "wgmma"]
# (the [B, H, T, d] call, its head-major copy): the copy of a T that is no
# multiple of 8 takes sync where the view takes wgmma; the last case's do
# has token stride 1 beside q, k, v in token rows
BHTD_BWD_WANT = [("wgmma", "wgmma"), ("wgmma", "sync"), ("wgmma", "sync"),
                 ("wgmma", "sync"), ("wgmma", "sync"), ("sync", "sync"),
                 ("sync", "sync"), ("wgmma", "wgmma"), ("wgmma", "wgmma"),
                 ("wgmma", "wgmma")]


def _hdt_path(q, k, v, do, B):
    """bwd_bf16_path of head-major operands with the outputs the wrapper
    allocates (contiguous [H, d, B*T])."""
    return tfa.bwd_bf16_path(q, k, v, do, torch.empty(q.shape, dtype=BF),
                             torch.empty(k.shape, dtype=BF),
                             torch.empty(v.shape, dtype=BF), None, None,
                             batch=B)


def _bhtd_path(q, k, v, do):
    """... of [B, H, T, d] ones (outputs empty_like, as the wrapper)."""
    return tfa.bwd_bf16_path(q, k, v, do, *map(torch.empty_like, (q, k, v)),
                             None, None)


@pytest.mark.parametrize("i", range(len(FLASH_HDT_BF16_CASES)))
def test_bwd_path_of_the_head_major_compare_cases(i):
    assert len(HDT_BWD_WANT) == len(FLASH_HDT_BF16_CASES)
    case = _shrunk(FLASH_HDT_BF16_CASES[i])
    q, k, v, do = hdt_bf16_operands(_rnd(i), case)
    assert _hdt_path(q, k, v, do, case[2]) == HDT_BWD_WANT[i]


@pytest.mark.parametrize("i", range(len(FLASH_BHTD_BF16_CASES)))
def test_bwd_path_of_the_bhtd_compare_cases(i):
    assert len(BHTD_BWD_WANT) == len(FLASH_BHTD_BF16_CASES)
    case = _shrunk(FLASH_BHTD_BF16_CASES[i])
    q, k, v, do = bhtd_bf16_operands(_rnd(i), case)
    got = _bhtd_path(q, k, v, do)
    hm = list(map(chip_smoke.head_major, (q, k, v, do)))
    assert (got, _hdt_path(*hm, case[2])) == BHTD_BWD_WANT[i]


def test_mixed_do_cases_have_do_in_the_other_orientation():
    """The two mixed compare cases do what their names say: the head-major
    one's do has feature stride 1 beside q, k, v in feature rows; the
    [B, H, T, d] one's do has token stride 1 (the strides of a [H d, B T]
    gradient, as autograd handed the block's recompute on the CPU) beside
    q, k, v in token rows."""
    hdt, = [c for c in FLASH_HDT_BF16_CASES if c[7] == "do-f1"]
    q, _, _, do = hdt_bf16_operands(_rnd(0), hdt)
    assert q.stride()[2] == 1 and do.stride()[1] == 1
    bhtd, = [c for c in FLASH_BHTD_BF16_CASES if c[6].endswith(":do-t1")]
    H, d, B, T = bhtd[:4]
    q, _, _, do = bhtd_bf16_operands(_rnd(0), bhtd)
    assert q.stride()[3] == 1 and do.stride() == (T, d * B * T, 1, B * T)


def test_bwd_path_of_the_training_call_sites():
    """fused_mha's head-major q, k, v and do (contiguous [8, 64, 32*512]);
    the block recompute's and fused_attention's [B, T, H, d] views of
    [32, 512, 512] projections, with do in the same token rows (the
    strides the card hands it: _MmF32's backward returns a contiguous
    [B, T, E] gradient) and with token stride 1 (the CPU's): all wgmma."""
    hm = torch.empty(8, 64, 32 * 512, dtype=BF)
    assert _hdt_path(hm, hm, hm, hm, 32) == "wgmma"
    x = chip_smoke.bthd_view(torch.empty(32, 512, 512, dtype=BF), 8)
    assert tuple(x.stride()) == (512 * 512, 64, 512, 1)
    assert _bhtd_path(x, x, x, x) == "wgmma"
    do_t1 = torch.empty(512, 32 * 512, dtype=BF).view(8, 64, 32, 512) \
        .permute(2, 0, 3, 1)
    assert tuple(do_t1.stride()) == (512, 64 * 32 * 512, 1, 32 * 512)
    assert _bhtd_path(x, x, x, do_t1) == "wgmma"


def test_bwd_path_refuses_what_tma_cannot_describe():
    """A base 2 bytes off (an input or an output), a ragged head-major T,
    q, k, v in two orientations, a stride of no multiple of 16 bytes and a
    head dim the kernels do not take give sync; the same operands without
    the fault give wgmma."""
    x = torch.empty(2 * 64 * 8 * 64 + 8, dtype=BF)

    def view(off, T=64, E=512):
        return chip_smoke.bthd_view(x[off:off + 2 * T * E].view(2, T, E), 8)

    ok = view(0)
    outs = [view(8)] * 3
    assert tfa.bwd_bf16_path(ok, ok, ok, ok, *outs, None, None) == "wgmma"
    assert tfa.bwd_bf16_path(view(1), ok, ok, ok, *outs, None,
                             None) == "sync"                      # 2 bytes
    assert tfa.bwd_bf16_path(ok, ok, ok, view(1), *outs, None,
                             None) == "sync"                      # do
    assert tfa.bwd_bf16_path(ok, ok, ok, ok, view(1), *outs[1:], None,
                             None) == "sync"                      # dq
    hm = torch.empty(8, 64, 2 * 300, dtype=BF)
    assert _hdt_path(hm, hm, hm, hm, 2) == "sync"                 # T 300
    hm = torch.empty(8, 64, 2 * 304, dtype=BF)
    assert _hdt_path(hm, hm, hm, hm, 2) == "wgmma"                # T 304
    tok1 = torch.empty(2, 8, 64, 64, dtype=BF).transpose(2, 3)   # token 1
    assert _bhtd_path(tok1, ok, ok, ok) == "sync"     # q, k, v mixed
    assert _bhtd_path(tok1, tok1, tok1, ok) == "wgmma"   # do alone differs
    odd = chip_smoke.bthd_view(torch.empty(2, 64, 516, dtype=BF)[..., :512],
                               8)                                # 1032 B
    assert _bhtd_path(odd, odd, odd, ok) == "sync"
    assert _bhtd_path(ok, ok, ok, odd) == "sync"
    d32 = torch.empty(2, 8, 64, 32, dtype=BF)
    assert _bhtd_path(d32, d32, d32, d32) == "sync"


@pytest.mark.parametrize("B,H,T,sms", [
    (32, 8, 512, SMS), (8, 8, 512, SMS), (2, 8, 520, SMS), (2, 3, 1000, 7),
    (1, 1, 64, SMS)])
def test_bwd_schedules_cover_every_tile_once(B, H, T, sms):
    nt = -(-T // tfa.WG_QTILE)
    want = {(b, h, t * tfa.WG_QTILE) for b in range(B) for h in range(H)
            for t in range(nt)}
    for s in (tfa.bwd_bf16_schedule(B, H, T, sms),      # dk/dv: key tiles
              tfa.fwd_bf16_schedule(B, H, T, sms)):     # dq: query tiles
        assert len(s) == min(sms, B * H * nt)
        tiles = [t for mine in s for t in mine]
        assert len(tiles) == len(want) and set(tiles) == want


def test_dkv_schedule_balances_causal_work_at_the_training_shape():
    """B 32, H 8, T 512: 1024 key tiles on 132 CTAs; a tile from key k0
    walks (512 - k0) / 128 query blocks, and each CTA's total lies within
    one heavy tile of every other's (16-20 blocks, mean 19.4)."""
    s = tfa.bwd_bf16_schedule(32, 8, 512, SMS)
    n = tfa.WG_DKV_BLOCK[64]
    loads = [sum((512 - k0) // n for _, _, k0 in mine) for mine in s]
    assert max(loads) - min(loads) <= 512 // n
    assert max(loads) <= 1.05 * sum(loads) / len(loads)


def wgmma_order_bwd(q, k, v, lse, delta, do, batch, causal, scale,
                    kv_len=None):
    """(dq, dk, dv) bf16 head-major of head-major bf16 q, k, v, do and f32
    lse, delta [H, 1, B*Tq] in the wgmma kernels' order, in f32 on the
    CPU: q' = bf16(q * bf16(scale)), s = q'k^T, p = exp(s - lse) and ds =
    p (do v^T - delta) in f32, masked to 0; dv += bf16(p)^T do and dk +=
    bf16(ds)^T q' over blocks of WG_DKV_BLOCK[d] queries in order; dq +=
    bf16(ds) k over blocks of WG_DQ_BLOCK keys in order, dq = bf16(scale
    dq)."""
    H, d, Nq = q.shape
    Tq, Tk = Nq // batch, k.shape[2] // batch
    kend = Tk if kv_len is None else kv_len
    qs = tfa.bf16_scaled(q, scale).float().reshape(H, d, batch, Tq)
    kf, vf = (t.float().reshape(H, d, batch, Tk) for t in (k, v))
    dof = do.float().reshape(H, d, batch, Tq)
    lse4, delta4 = (t.reshape(H, batch, Tq).permute(1, 0, 2)[..., None]
                    for t in (lse, delta))                # [B, H, Tq, 1]

    def p_ds(qb, kb):            # query slice, key slice -> [B, H, q, k]
        s = torch.einsum("hdbq,hdbk->bhqk", qs[..., qb], kf[..., kb])
        qi = torch.arange(Tq)[qb][:, None]
        ki = torch.arange(Tk)[kb][None, :]
        keep = ki < kend
        if causal:
            keep = keep & (ki <= qi)
        p = torch.exp(s - lse4[:, :, qb]).masked_fill(~keep, 0.0)
        dp = torch.einsum("hdbq,hdbk->bhqk", dof[..., qb], vf[..., kb])
        return p, p * (dp - delta4[:, :, qb])

    def bf(t):
        return t.to(BF).float()

    dk = torch.zeros(batch, H, Tk, d)
    dv = torch.zeros(batch, H, Tk, d)
    nq, nk = tfa.WG_DKV_BLOCK[d], tfa.WG_DQ_BLOCK
    for q0 in range(0, Tq, nq):
        qb = slice(q0, min(q0 + nq, Tq))
        p, ds = p_ds(qb, slice(0, Tk))
        dv += torch.einsum("bhqk,hdbq->bhkd", bf(p), dof[..., qb])
        dk += torch.einsum("bhqk,hdbq->bhkd", bf(ds), qs[..., qb])
    dq = torch.zeros(batch, H, Tq, d)
    for k0 in range(0, Tk, nk):
        kb = slice(k0, min(k0 + nk, Tk))
        _, ds = p_ds(slice(0, Tq), kb)
        dq += torch.einsum("bhqk,hdbk->bhqd", bf(ds), kf[..., kb])

    def hm(t, T):                # [B, H, T, d] -> [H, d, B*T] bf16
        return t.permute(1, 3, 0, 2).reshape(H, d, batch * T).to(BF)

    return hm(scale * dq, Tq), hm(dk, Tk), hm(dv, Tk)


# (H, d, B, Tq, Tk, causal, kv_len, scale): several query and key blocks,
# a causal kv_len, Tq != Tk with kv_len, d 128, a T that the JAX side pads
ORDER_CASES = [
    (2, 64, 2, 256, 256, True, None, None),
    (2, 64, 2, 256, 256, True, 200, None),
    (2, 64, 2, 128, 256, False, 200, None),
    (2, 128, 1, 256, 256, True, None, 0.125),
    (2, 64, 2, 200, 200, True, None, None),
]


def _order_inputs(case):
    H, d, B, Tq, Tk = case[:5]
    rng = np.random.RandomState(H + d + 7 * Tq + 3 * Tk + (case[6] or 0))
    q, do = (rng.randn(H, d, B * Tq).astype("float32") * 2 for _ in range(2))
    k, v = (rng.randn(H, d, B * Tk).astype("float32") * 2 for _ in range(2))
    return q, k, v, do


def _pallas_bwd_hdt(q, k, v, do, B, s, causal, kv_len, Tq, Tk):
    """The head-major Pallas forward and backward (interpret mode) on bf16
    inputs with the wgmma kernels' blocks (WG_DKV_BLOCK[d] queries,
    WG_DQ_BLOCK keys), T zero-padded to 128 with kv_len where ragged:
    (dq, dk, dv) at T, and the forward's o and lse."""
    Tqp, Tkp = -(-Tq // 128) * 128, -(-Tk // 128) * 128
    kv = kv_len if kv_len is not None else (Tk if Tkp != Tk else None)
    jq, jk, jv, jdo = (_jbf(_padded(a, B, T, Tp, 2)) for a, T, Tp in
                       ((q, Tq, Tqp), (k, Tk, Tkp), (v, Tk, Tkp),
                        (do, Tq, Tqp)))
    H, d = q.shape[:2]
    nq, nk = tfa.WG_DKV_BLOCK[d], tfa.WG_DQ_BLOCK
    jo, jlse = jflash._flash_fwd_hdt(jq, jk, jv, B, s, causal, True, nq, nk,
                                     kv)
    grads = jflash._flash_bwd_hdt(B, s, causal, kv, True,
                                  (jq, jk, jv, jo, jlse), jdo, nq, nk)

    def cut(a, T, Tp):
        return np.asarray(a.astype(np.float32)).reshape(
            H, a.shape[1], B, Tp)[..., :T].reshape(H, a.shape[1], B * T)

    return ([cut(g, T, Tp) for g, T, Tp in zip(
        grads, (Tq, Tk, Tk), (Tqp, Tkp, Tkp))],
        cut(jo, Tq, Tqp), cut(jlse, Tq, Tqp))


@pytest.mark.parametrize("case", ORDER_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_wgmma_order_matches_pallas_and_plain(case):
    H, d, B, Tq, Tk, causal, kv_len, scale = case
    q, k, v, do = _order_inputs(case)
    s = scale or 1.0 / np.sqrt(d)
    jgrads, jo, jlse = _pallas_bwd_hdt(q, k, v, do, B, s, causal, kv_len,
                                       Tq, Tk)
    tq, tk, tv, tdo = map(_tbf, (q, k, v, do))
    # the backward from the Pallas forward's residuals; delta in f32 from
    # do before its rounding and the bf16 o, as _flash_bwd_hdt takes it
    lse = torch.from_numpy(np.array(jlse))
    delta = torch.sum(torch.from_numpy(np.array(do)).to(BF).float()
                      * torch.from_numpy(np.array(jo)), dim=1, keepdim=True)
    got = wgmma_order_bwd(tq, tk, tv, lse, delta, tdo, B, causal, s, kv_len)
    for name, t, j in zip(("dq", "dk", "dv"), got, jgrads):
        assert_bf16_close(t, _jbf(j), f"{name} (Pallas, the same "
                          f"blocks)")
    want = tfa.flash_attention_hdt_bwd_plain(tq, tk, tv, lse, delta, tdo, B,
                                             causal=causal, scale=scale,
                                             kv_len=kv_len)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        _within_step(t, w, f"{name} (plain)")
    assert tile_rel_err(got, want) <= BF16_RTOL


@pytest.mark.parametrize("case", [c for c in ORDER_CASES
                                  if c[6] is None and c[3] == c[4]
                                  and c[3] % 128 == 0],
                         ids=lambda c: "-".join(str(v) for v in c))
def test_wgmma_order_matches_the_bhtd_pallas_kernel(case):
    """The same emulation against the [B, H, T, d] Pallas backward
    (``_flash_bwd``) with the same blocks on the same values: the
    [B, T, H, d] views of rows 14 run the kernels' order of row 10."""
    H, d, B, T, _, causal, _, scale = case
    q, k, v, do = _order_inputs(case)
    s = scale or 1.0 / np.sqrt(d)

    def bhtd(a):                 # head-major -> [B*H, T, d] bf16
        return _jbf(a.reshape(H, d, B, T).transpose(2, 0, 3, 1).reshape(
            B * H, T, d))

    jq, jk, jv, jdo = map(bhtd, (q, k, v, do))
    nq, nk = tfa.WG_DKV_BLOCK[d], tfa.WG_DQ_BLOCK
    jo, jlse = jflash._flash_fwd(jq, jk, jv, s, causal, True, nq, nk)
    jgrads = jflash._flash_bwd(s, causal, None, True, (jq, jk, jv, jo, jlse),
                               jdo, nq, nk)

    def hm(a):                   # [B*H, T, c] -> head-major f32 numpy
        return _np(a).reshape(B, H, T, -1).transpose(1, 3, 0, 2).reshape(
            H, -1, B * T)

    lse = torch.from_numpy(_np(jlse).reshape(B, H, T).transpose(
        1, 0, 2).reshape(H, 1, B * T).copy())
    tdo = _tbf(do)
    delta = torch.sum(tdo.float() * torch.from_numpy(hm(jo).copy()), dim=1,
                      keepdim=True)
    got = wgmma_order_bwd(*map(_tbf, (q, k, v)), lse, delta, tdo, B, causal,
                          s)
    for name, t, j in zip(("dq", "dk", "dv"), got, jgrads):
        assert_bf16_close(t, _jbf(hm(j)), f"{name} (bhtd Pallas, the same "
                          f"blocks)")


def test_emulation_pins_the_kernels_blocks():
    """The emulation is the kernels' blocked order, not a restatement of
    the plain version: blocks of 64 against one sum over all keys (and all
    queries) move some dq, dk and dv entries by a bf16 rounding (13, 11 and
    8 of 131072 here), at most a bf16 step at the largest entry."""
    case = (2, 64, 2, 512, 512, True, None, None)
    q, k, v, do = map(_tbf, _order_inputs(case))
    o, lse = tfa.flash_attention_hdt_plain(q, k, v, 2, causal=True)
    delta = torch.sum(do.float() * o.float(), dim=1, keepdim=True)
    got = wgmma_order_bwd(q, k, v, lse, delta, do, 2, True, 0.125)
    want = tfa.flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, 2,
                                             causal=True)
    differ = [float((a != b).float().mean()) for a, b in zip(got, want)]
    assert all(0.0 < x < 0.01 for x in differ), differ
    for a, b in zip(got, want):
        _within_step(a, b, "blocked against one sum")


def test_wrappers_take_a_path_and_count_it_by_path():
    """The bf16 backward wrappers take path=None|"wgmma"|"sync" and carry
    .launches_wgmma and .launches_sync beside .launches; a path name they
    do not know raises before any launch."""
    for fn in (tfa.flash_attention_hdt_bwd_bf16,
               tfa.flash_attention_bwd_bf16):
        assert isinstance(fn.launches_wgmma, int)
        assert isinstance(fn.launches_sync, int)
    with pytest.raises(ValueError, match="no path"):
        tfa._bf16_path("flash_attention_hdt_bwd_bf16", "tma", "wgmma")
    assert tfa._bf16_path("x", None, "sync") == "sync"
    assert tfa._bf16_path("x", "sync", "wgmma") == "sync"

"""The bf16 flash forward's wgmma path, as far as the CPU can hold it.

The wgmma kernel (csrc/flash_attention_bf16.cu flash_fwd_bf16_wg_kernel)
runs only on the card (chip_smoke.py, tests/test_torch_cuda.py).  Here:

- the path choice, a pure function of the operands' addresses, strides and
  extents (``fwd_bf16_path``; the block kernel's ``flash_path_in_block``):
  TMA needs 16-byte-aligned bases, q, k, v and o in one orientation (all
  feature stride 1, or all token stride 1 with T % 8 == 0) and every other
  stride a multiple of 16 bytes, else the sync path.  Every bf16 flash
  compare case of chip_smoke.py and the three training call sites;
- the persistent schedule (``fwd_bf16_schedule``): every (batch row,
  head, query tile) once, a (batch row, head)'s query tiles side by side,
  each CTA's causal work within one heavy tile of the others;
- the wgmma kernel's order, emulated in f32 on the CPU: 128-query tiles,
  key blocks of 128 (64 at d 128), p rounded to bf16 against each block's
  running max, f32 accumulation, one rounding of o.  The emulation is held
  to the Pallas kernels in interpret mode (``_flash_fwd_hdt`` and
  ``_flash_fwd`` on bf16 inputs, T zero-padded to 128 with kv_len where
  it is ragged) run with the same query tiles and key blocks at the
  tolerance of test_torch_amp.py (one bf16 step at the largest entry, 99 %
  of entries the same bits; lse 1e-5).  Against the one-softmax
  references (the Pallas kernels with their own key blocks, one block a
  row here, and ``flash_attention_hdt_plain``) it is held to the same one
  bf16 step and to chip_smoke's tile_rel_err at BF16_RTOL; 5-10 % of the
  entries round the other way there (p is rounded against another max),
  which is why the bits share is asked of the same blocking only.  Head
  dims whose scale is a power of two (d 64; d 128 with scale 1/8), as
  test_torch_amp.py explains.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (BF16_RTOL, FLASH_BHTD_BF16_CASES,
                        FLASH_HDT_BF16_CASES, bhtd_bf16_operands,
                        hdt_bf16_operands, tile_rel_err)
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_block as tfb
from test_torch_amp import F32, _jbf, _np, _tbf, assert_bf16_close

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")

SMS = 132   # the H100 SXM's SMs
BF = torch.bfloat16


def _rnd(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=g)


# the forward's path on each chip_smoke case, in the lists' order: T not a
# multiple of 8, a token-strided q and a q 2 bytes off alignment take sync
# (do's layout, the last case's, is no matter to the forward)
HDT_WANT = ["wgmma", "sync", "sync", "sync", "sync", "sync", "sync", "wgmma",
            "sync", "wgmma", "wgmma", "wgmma", "wgmma", "wgmma", "wgmma",
            "wgmma"]
# (the [B, H, T, d] call, its head-major copy): the copy of a T that is no
# multiple of 8 takes sync where the view takes wgmma
BHTD_WANT = [("wgmma", "wgmma"), ("wgmma", "sync"), ("wgmma", "sync"),
             ("wgmma", "sync"), ("wgmma", "sync"), ("sync", "sync"),
             ("sync", "sync"), ("wgmma", "wgmma"), ("wgmma", "wgmma"),
             ("wgmma", "wgmma")]


def _shrunk(case):
    """A training-batch case cut to batch 2 (the path depends on strides
    and extents, not on the batch count, above 1)."""
    return (case[:2] + (2,) + case[3:]) if case[2] > 8 else case


@pytest.mark.parametrize("i", range(len(FLASH_HDT_BF16_CASES)))
def test_fwd_path_of_the_head_major_compare_cases(i):
    assert len(HDT_WANT) == len(FLASH_HDT_BF16_CASES)
    case = _shrunk(FLASH_HDT_BF16_CASES[i])
    H, d, B, Tq = case[:4]
    q, k, v, _ = hdt_bf16_operands(_rnd(i), case)
    o = torch.empty(H, d, B * Tq, dtype=BF)   # as the wrapper allocates it
    assert tfa.fwd_bf16_path(q, k, v, o, batch=B) == HDT_WANT[i]


@pytest.mark.parametrize("i", range(len(FLASH_BHTD_BF16_CASES)))
def test_fwd_path_of_the_bhtd_compare_cases(i):
    assert len(BHTD_WANT) == len(FLASH_BHTD_BF16_CASES)
    case = _shrunk(FLASH_BHTD_BF16_CASES[i])
    B = case[2]
    q, k, v, _ = bhtd_bf16_operands(_rnd(i), case)
    got = tfa.fwd_bf16_path(q, k, v, torch.empty_like(q))
    qh, kh, vh = map(chip_smoke.head_major, (q, k, v))
    got_h = tfa.fwd_bf16_path(qh, kh, vh, torch.empty_like(qh), batch=B)
    assert (got, got_h) == BHTD_WANT[i]


def test_fwd_path_of_the_training_call_sites():
    """fused_mha's head-major q, k, v; fused_attention's and the block
    recompute's [B, T, H, d] views of [32, 512, 512] projections; the bf16
    block kernel's q, k, v views of its qkv [16384, 1536] and o [16384,
    512]: all wgmma."""
    hm = torch.empty(8, 64, 32 * 512, dtype=BF)
    assert tfa.fwd_bf16_path(hm, hm, hm, torch.empty_like(hm),
                             batch=32) == "wgmma"
    x = chip_smoke.bthd_view(torch.empty(32, 512, 512, dtype=BF), 8)
    assert tfa.fwd_bf16_path(x, x, x, torch.empty_like(x)) == "wgmma"
    qkv = torch.empty(16384, 1536, dtype=BF)
    o = torch.empty(16384, 512, dtype=BF)

    def view(t, c0):
        return chip_smoke.bthd_view(t[:, c0:c0 + 512].view(32, 512, 512), 8)

    assert tfa.fwd_bf16_path(view(qkv, 0), view(qkv, 512), view(qkv, 1024),
                             view(o, 0)) == "wgmma"


@pytest.mark.parametrize("B,T,D,E,H,want", [
    (32, 512, 512, 512, 8, "wgmma"),     # the training shape
    (2, 67, 201, 128, 2, "wgmma"),       # chip_smoke's odd block case
    (2, 300, 512, 512, 4, "wgmma"),      # head dim 128
    (2, 64, 512, 516, 4, "sync"),        # head dim 129
])
def test_block_flash_path_is_the_path_of_its_views(B, T, D, E, H, want):
    """flash_path_in_block, from the workspace's address and the layout of
    fused_block_bf16.cu's work(), agrees with fwd_bf16_path of real views
    of that workspace."""
    nbytes = tfb._align256(2 * B * T * D) + tfb._align256(2 * B * T * 3 * E) \
        + tfb._align256(2 * B * T * E)
    work = torch.empty(nbytes + 64, dtype=torch.uint8)
    ptr = work.data_ptr()
    assert ptr % 16 == 0
    got = tfb.flash_path_in_block(ptr, B, T, D, E, H)
    w = work.view(BF)
    qkv0 = tfb._align256(2 * B * T * D) // 2
    o0 = qkv0 + tfb._align256(2 * B * T * 3 * E) // 2
    qkv = w[qkv0:qkv0 + B * T * 3 * E].view(B, T, 3 * E)
    o = w[o0:o0 + B * T * E].view(B, T, E)
    views = [chip_smoke.bthd_view(t, H) for t in (
        qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:], o)]
    assert got == tfa.fwd_bf16_path(*views) == want


def test_fwd_path_refuses_what_tma_cannot_describe():
    """A base 2 bytes off, a ragged head-major T, mixed orientations, a
    stride of no multiple of 16 bytes and a head dim the kernel does not
    take give sync; the same operands without the fault give wgmma."""
    x = torch.empty(2 * 64 * 8 * 64 + 8, dtype=BF)

    def view(off, T=64, E=512):
        return chip_smoke.bthd_view(x[off:off + 2 * T * E].view(2, T, E), 8)

    ok = view(0)
    assert tfa.fwd_bf16_path(ok, ok, ok, view(8)) == "wgmma"
    assert tfa.fwd_bf16_path(view(1), ok, ok, ok) == "sync"       # 2 bytes
    assert tfa.fwd_bf16_path(ok, ok, ok, view(1)) == "sync"       # o too
    hm = torch.empty(8, 64, 2 * 300, dtype=BF)
    assert tfa.fwd_bf16_path(hm, hm, hm, hm, batch=2) == "sync"   # T 300
    hm = torch.empty(8, 64, 2 * 304, dtype=BF)
    assert tfa.fwd_bf16_path(hm, hm, hm, hm, batch=2) == "wgmma"  # T 304
    mixed = chip_smoke.bthd_view(torch.empty(2, 64, 512, dtype=BF), 8)
    tok1 = torch.empty(2, 8, 64, 64, dtype=BF).transpose(2, 3)   # token 1
    assert tfa.fwd_bf16_path(tok1, mixed, mixed, mixed) == "sync"
    odd = chip_smoke.bthd_view(torch.empty(2, 64, 516, dtype=BF)[..., :512],
                               8)                                # 1032 B
    assert tfa.fwd_bf16_path(odd, odd, odd, ok) == "sync"
    d32 = torch.empty(2, 8, 64, 32, dtype=BF)
    assert tfa.fwd_bf16_path(d32, d32, d32, d32) == "sync"


@pytest.mark.parametrize("B,H,Tq,sms", [
    (32, 8, 512, SMS), (8, 8, 512, SMS), (2, 8, 520, SMS), (2, 3, 1000, 7),
    (1, 1, 64, SMS)])
def test_schedule_covers_every_tile_once(B, H, Tq, sms):
    s = tfa.fwd_bf16_schedule(B, H, Tq, sms)
    nqt = -(-Tq // tfa.WG_QTILE)
    assert len(s) == min(sms, B * H * nqt)
    tiles = [t for mine in s for t in mine]
    want = {(b, h, q * tfa.WG_QTILE) for b in range(B) for h in range(H)
            for q in range(nqt)}
    assert len(tiles) == len(want) and set(tiles) == want
    # each pass of the grid takes a (batch row, head)'s query tiles together
    grid = len(s)
    for p in range(max(map(len, s))):
        passed = [mine[p] for mine in s if p < len(mine)]
        groups = {}
        for b, h, _ in passed:
            groups[(b, h)] = groups.get((b, h), 0) + 1
        assert all(n <= nqt for n in groups.values())
        assert len(groups) <= -(-grid // nqt) + 1


def test_schedule_balances_causal_work_at_the_training_shape():
    """B 32, H 8, T 512: 1024 tiles on 132 CTAs, each CTA's query tiles
    rotating; its causal key blocks (q0 / 128 + 1 a tile) lie within one
    heavy tile of every other CTA's (16-20 against a mean of 19.4)."""
    s = tfa.fwd_bf16_schedule(32, 8, 512, SMS)
    loads = [sum(q0 // tfa.WG_QTILE + 1 for _, _, q0 in mine) for mine in s]
    assert max(loads) - min(loads) <= 4
    assert max(loads) <= 1.05 * sum(loads) / len(loads)


def wgmma_order_fwd(q, k, v, batch, causal, scale, kv_len=None):
    """(o bf16 [H, d, B*Tq], lse f32 [H, 1, B*Tq]) of head-major bf16 q, k,
    v in the wgmma kernel's order, in f32 on the CPU: q' = bf16(q *
    bf16(scale)); per key block of WG_KBLOCK[d] keys, s = q'k^T in f32,
    masked, the running max m, p = exp(s - m) in f32, l = l c + rowsum p,
    o = o c + bf16(p) v (c = exp(m_old - m)); o = bf16(o / l), lse = m +
    log l.  A query tile of the kernel stops at its causal diagonal; the
    blocks past it are masked for all its rows here, which leaves m, l and
    o exactly as they are (c = 1, p = 0), so all rows run together."""
    H, d, Nq = q.shape
    Tq, Tk = Nq // batch, k.shape[2] // batch
    kn = tfa.WG_KBLOCK[d]
    kend = Tk if kv_len is None else kv_len
    qs = tfa.bf16_scaled(q, scale).float().reshape(H, d, batch, Tq)
    kf = k.float().reshape(H, d, batch, Tk)
    vf = v.float().reshape(H, d, batch, Tk)
    rows = torch.arange(Tq)[:, None]
    m = torch.full((batch, H, Tq), tfa.NEG_INF)
    l = torch.zeros(batch, H, Tq)
    acc = torch.zeros(batch, H, Tq, d)
    for k0 in range(0, kend, kn):
        keys = torch.arange(k0, min(k0 + kn, Tk))
        s = torch.einsum("hdbq,hdbk->bhqk", qs, kf[..., keys])
        keep = keys[None, :] < kend
        if causal:
            keep = keep & (keys[None, :] <= rows)
        s = s.masked_fill(~keep, tfa.NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        c = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * c + p.sum(-1)
        acc = acc * c[..., None] + torch.einsum(
            "bhqk,hdbk->bhqd", p.to(BF).float(), vf[..., keys])
        m = mx
    l = l.clamp_min(1e-30)
    o = (acc / l[..., None]).to(BF).permute(1, 3, 0, 2).reshape(H, d, Nq)
    lse = (m + torch.log(l)).permute(1, 0, 2).reshape(H, 1, Nq)
    return o, lse


# (H, d, B, Tq, Tk, causal, kv_len, scale): several key blocks a row, a
# causal kv_len, Tq != Tk, d 128 (key blocks of 64), T needing padding on
# the JAX side (its entry points pad to 128 and mask)
ORDER_CASES = [
    (2, 64, 2, 384, 384, True, None, None),
    (2, 64, 2, 384, 384, True, 300, None),
    (2, 64, 2, 256, 384, False, 300, None),
    (2, 128, 1, 256, 256, True, None, 0.125),
    (2, 128, 2, 256, 256, False, 200, 0.125),
    (2, 64, 2, 200, 200, True, None, None),
    (2, 128, 1, 136, 136, True, None, 0.125),
]


def _within_step(t, j, what):
    """max |t - j| within one bf16 step at j's largest entry."""
    t, j = _np(t), _np(j)
    err, top = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert err <= 2.0 ** -7 * top, (what, err, top)


def _padded(a, B, T, Tp, axis):
    """a with each batch row's T tokens along `axis` (B rows of T, or the
    [B*H, T, d] rows) zero-padded to Tp."""
    if Tp == T:
        return a
    if axis == 2:    # head-major [H, d, B*T]
        H, d, _ = a.shape
        out = np.zeros((H, d, B, Tp), a.dtype)
        out[..., :T] = a.reshape(H, d, B, T)
        return out.reshape(H, d, B * Tp)
    out = np.zeros((a.shape[0], Tp, a.shape[2]), a.dtype)
    out[:, :T] = a
    return out


def _pallas_hdt(q, k, v, B, s, causal, kv_len, block_k, Tq, Tk):
    """The head-major Pallas forward (interpret mode) on bf16 q, k, v with
    query tiles of 128 and key blocks of block_k (None: its own), T
    zero-padded to 128 with kv_len where ragged: (o, lse) at T."""
    Tp = -(-max(Tq, Tk) // 128) * 128 if Tq != Tk or Tq % 128 else Tq
    if Tq != Tk:
        Tqp, Tkp = -(-Tq // 128) * 128, -(-Tk // 128) * 128
    else:
        Tqp = Tkp = Tp
    kv = kv_len if kv_len is not None else (Tk if Tkp != Tk else None)
    jq, jk, jv = (_jbf(_padded(a, B, T, Tpad, 2)) for a, T, Tpad in
                  ((q, Tq, Tqp), (k, Tk, Tkp), (v, Tk, Tkp)))
    o, lse = jflash._flash_fwd_hdt(jq, jk, jv, B, s, causal, True,
                                   128 if block_k else None, block_k, kv)
    H, d = q.shape[:2]
    o = jnp.reshape(o, (H, d, B, Tqp))[..., :Tq].reshape(H, d, B * Tq)
    lse = jnp.reshape(lse, (H, 1, B, Tqp))[..., :Tq].reshape(H, 1, B * Tq)
    return o, lse


def _order_inputs(case):
    H, d, B, Tq, Tk = case[:5]
    rng = np.random.RandomState(H + d + 7 * Tq + 3 * Tk + (case[6] or 0))
    q = rng.randn(H, d, B * Tq).astype("float32") * 2
    k, v = (rng.randn(H, d, B * Tk).astype("float32") * 2 for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case", ORDER_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_wgmma_order_matches_pallas_and_plain(case):
    H, d, B, Tq, Tk, causal, kv_len, scale = case
    q, k, v = _order_inputs(case)
    s = scale or 1.0 / np.sqrt(d)
    tq, tk, tv = map(_tbf, (q, k, v))
    o, lse = wgmma_order_fwd(tq, tk, tv, B, causal, s, kv_len)
    po, plse = tfa.flash_attention_hdt_plain(tq, tk, tv, B, causal=causal,
                                             scale=scale, kv_len=kv_len)
    # the Pallas kernel with the wgmma kernel's query tiles and key blocks
    jo, jlse = _pallas_hdt(q, k, v, B, s, causal, kv_len, tfa.WG_KBLOCK[d],
                           Tq, Tk)
    assert_bf16_close(o, jo, "o (Pallas, the same blocks)")
    np.testing.assert_allclose(_np(lse), _np(jlse), **F32)
    # ... and with its own (one key block a row at these T)
    jo1, _ = _pallas_hdt(q, k, v, B, s, causal, kv_len, None, Tq, Tk)
    _within_step(o, jo1, "o (Pallas, its own blocks)")
    _within_step(o, po, "o (plain)")
    np.testing.assert_allclose(_np(lse), _np(plse), **F32)
    assert tile_rel_err([o], [po]) <= BF16_RTOL


@pytest.mark.parametrize("case", [c for c in ORDER_CASES
                                  if c[6] is None and c[3] == c[4]],
                         ids=lambda c: "-".join(str(v) for v in c))
def test_wgmma_order_matches_the_bhtd_pallas_kernel(case):
    """The same emulation against the [B, H, T, d] Pallas kernel
    (``_flash_fwd``, or the entry point where T needs padding) on the
    same values: the [B, T, H, d] views of rows 13 and 15 run the same
    kernel order as the head-major call of row 9."""
    H, d, B, Tq, Tk, causal, _, scale = case
    q, k, v = _order_inputs(case)
    s = scale or 1.0 / np.sqrt(d)
    o, _ = wgmma_order_fwd(*map(_tbf, (q, k, v)), B, causal, s)

    def bhtd(a, T):
        return a.reshape(H, d, B, T).transpose(2, 0, 3, 1)

    Tp = -(-Tq // 128) * 128
    jq, jk, jv = (_jbf(_padded(bhtd(a, Tq).reshape(B * H, Tq, d), B, Tq,
                               Tp, 1)) for a in (q, k, v))
    jo = jflash._flash_fwd(jq, jk, jv, s, causal, True, 128,
                           tfa.WG_KBLOCK[d], Tq if Tp != Tq else None)[0]
    jo_hm = jnp.transpose(jo[:, :Tq].reshape(B, H, Tq, d),
                          (1, 3, 0, 2)).reshape(H, d, B * Tq)
    assert_bf16_close(o, jo_hm, "o (bhtd Pallas, the same blocks)")


def test_emulated_order_is_not_the_one_block_softmax():
    """Rounding p against each block's running max moves o off the plain
    version's bits (one softmax over the row) in some entries, by at most a
    bf16 step at the largest entry: the emulation computes the kernel's
    order, not the plain one (6.8 % of the entries at this case)."""
    case = (2, 64, 2, 512, 512, True, None, None)
    q, k, v = map(_tbf, _order_inputs(case))
    o, _ = wgmma_order_fwd(q, k, v, 2, True, 0.125)
    po, _ = tfa.flash_attention_hdt_plain(q, k, v, 2, causal=True)
    differ = float((o != po).float().mean())
    assert 0.01 < differ < 0.15
    assert float((o.float() - po.float()).abs().max()) \
        <= 2.0 ** -7 * float(po.float().abs().max())

"""Flash attention, forward and backward: the hand-written CUDA kernels
and their plain torch versions, in two layouts.

- ``flash_attention_hdt`` takes the head-major ``[H, d, B*T]`` layout that
  the ``fused_mha`` op's projections produce.  It replaces the Pallas TPU
  kernels ``paddle_tpu/kernels/flash_attention.py:_flash_fwd_hdt`` (body
  ``_fwd_kernel_hdt``) and ``_flash_bwd_hdt`` (bodies
  ``_bwd_fused1_kernel_hdt``, ``_bwd_fused_kernel_hdt``,
  ``_bwd_dkv_kernel_hdt`` and ``_bwd_dq_kernel_hdt``).
- ``flash_attention`` takes ``[B, H, T, d]`` (or ``[BH, T, d]``) in any
  strides, as the ``fused_attention`` op and the fused block's backward
  recompute hand it.  It replaces ``_flash_fwd`` (body ``_fwd_kernel``) and
  ``_flash_bwd`` (bodies ``_bwd_fused1_kernel``, ``_bwd_dkv_kernel`` and
  ``_bwd_dq_kernel``), entry ``flash_attention``.

Both layouts run the same two kernel sources, ``csrc/flash_attention_hdt.cu``
and ``csrc/flash_attention_hdt_bwd.cu``, which read and write every operand
through (batch, head, feature, token) element strides: no second kernel and
no transpose copy.  Both take every product on the TF32 tensor cores in
three passes (3xTF32, f32-grade: ``csrc/flash_mma.cuh``).  Their headers
say what bounds them on the H100 (tensor-core operations) and how each
design stages tiles in shared memory by ``cp.async`` along the path its
operand's strides allow (16-byte copies along a unit feature stride, 4-byte
ones otherwise, the same tile either way), stops at the causal diagonal and
at ``kv_len``, and masks ragged tiles itself, so the caller pads nothing
(the JAX entries pad to 128-token granules).

Both entries are differentiable (``torch.autograd.Function``s): the forward
saves (q, k, v, o, lse); the backward takes ``delta = rowsum(do * o)`` in
f32 in torch, as the JAX package does (flash_attention.py:329, :763), and
calls the backward kernel.  Every entry decides by the tensors' device:
CUDA tensors launch the kernel (or raise), CPU or meta tensors take the
``_plain`` version.  ``flash_attention_hdt.launches``,
``flash_attention_hdt_bwd.launches``, ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count each entry's kernel launches.  The
card kernels take f32 inputs with d in {64, 128} and dv == d.

Under ``FLAGS_amp_bf16`` the ``fused_mha`` op hands ``flash_attention_hdt``
bf16 q, k and v, and ``fused_attention`` and the fused block's recompute
hand ``flash_attention`` bf16 ``[B, H, T, d]`` views.  Those go to two more
kernels, ``csrc/flash_attention_bf16.cu``, through the same strides
(wrappers ``flash_attention_hdt_bf16``, ``flash_attention_hdt_bwd_bf16``,
``flash_attention_bf16`` and ``flash_attention_bwd_bf16``, each with its
own ``.launches``), rounding where the Pallas kernels round in bf16 with
f32 accumulation.  The bf16 forward has two kernels, chosen on the host
from the operands before the launch (``fwd_bf16_path``):

- "wgmma" where TMA can describe q, k, v and o (16-byte-aligned bases, all
  in token rows, feature stride 1, or all in feature rows, token stride 1
  with T % 8 == 0, every other stride a multiple of 16 bytes, d 64 or
  128): ``flash_fwd_bf16_wg_kernel``, a persistent grid of 128-query work
  tiles whose producer warp loads q and a ring of k, v blocks by TMA and
  whose two consumer warpgroups take s = q'k^T and o += p.v on ``wgmma``
  (p from registers).  Every (batch row, head, query tile) is one work
  tile, the query tiles of one (batch row, head) side by side
  (``fwd_bf16_schedule``);
- "sync" otherwise (a ragged head-major T, a view 2 bytes off alignment,
  mixed layouts): one ``mma.sync`` m16n8k16 per product.

The bf16 backward likewise has two kernel pairs (dk/dv, then dq), chosen
by ``bwd_bf16_path``:

- "wgmma" where TMA can describe q, k and v in one orientation, do in its
  own, and each of dq, dk, dv in its own (d 64 or 128):
  ``flash_bwd_dkv_bf16_wg_kernel`` (128-key work tiles whose k and v stay
  in shared memory while blocks of q, do, lse and delta stream past, 128
  queries a block at d 64 and 64 at d 128, ``bwd_bf16_schedule``) and
  ``flash_bwd_dq_bf16_wg_kernel`` (the forward's 128-query tiles and
  schedule, 64-key blocks), each a persistent grid of a producer warp and
  two consumer warpgroups on ``wgmma``;
- "sync" otherwise: one ``mma.sync`` m16n8k16 per product.

All four bf16 wrappers take ``path=None`` (the operands' choice) or a
forced path, for the compares and timings; a forced "wgmma" on operands
TMA cannot describe raises.  ``.launches_wgmma`` and ``.launches_sync``
count each path's launches beside ``.launches``.

q' = bf16(q * bf16(scale)) (flash_attention.py:529, :597; :85, :229,
:262); p, and in the backward ds, are rounded to bf16 before the products
that take them (:542, :586, :588, :615; :108, :237, :240, :267); the
running max, sum, lse, delta and every accumulator stay f32; dq takes its
scale in f32 at the end (:273); o, dq, dk and dv are rounded once.  The
plain versions carry the same roundings for bf16 inputs (the ``[B, H, T,
d]`` ones through the head-major composition, ``_bhtd_plain_bf16``) and
keep the full-softmax f32 arithmetic for f32 ones.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
_fns = {}


def _check(q, k, v, batch, causal, kv_len):
    """The JAX entry's argument contract; returns (Tq, Tk)."""
    H, d, Nq = q.shape
    if k.shape[:2] != (H, d) or v.shape[0] != H or v.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Nq % batch or k.shape[2] % batch:
        raise ValueError(f"token counts {Nq}/{k.shape[2]} not divisible "
                         f"by batch {batch}")
    Tq, Tk = Nq // batch, k.shape[2] // batch
    if causal and Tq != Tk:
        raise ValueError("causal attention requires Tq == Tk")
    if kv_len is not None and not 1 <= kv_len <= Tk:
        raise ValueError(f"kv_len={kv_len} out of range [1, {Tk}]")
    return Tq, Tk


def _scores(q, k, v, batch, causal, scale, kv_len, Tq, Tk):
    """(q*scale, k, v) as [H, d, B, T] in the working precision, and the
    masked scores [B, H, Tq, Tk]."""
    H, d, _ = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    q4 = (q.to(acc) * scale).reshape(H, d, batch, Tq)
    k4 = k.to(acc).reshape(H, d, batch, Tk)
    v4 = v.to(acc).reshape(H, v.shape[1], batch, Tk)
    s = torch.einsum("hdbq,hdbk->bhqk", q4, k4)
    keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    if kv_len is not None:
        keep = keep & (torch.arange(Tk, device=q.device) < kv_len)
    return q4, k4, v4, s.masked_fill(~keep, NEG_INF)


def bf16_scaled(q, scale):
    """q' = bf16(q * bf16(scale)) of bf16 q: the Pallas kernel's pre-scaled
    queries (flash_attention.py:529, :597).  The product of two bf16 values
    is exact in f32, so this is one rounding."""
    sb = float(torch.tensor(float(scale), dtype=torch.bfloat16))
    return (q.float() * sb).to(torch.bfloat16)


def _hdt_plain_bf16(q, k, v, batch, causal, scale, kv_len, Tq, Tk):
    """The bf16 forward's arithmetic, as the Pallas kernel runs it with one
    key block: s = q'k^T in f32, p = exp(s - rowmax) in f32, o = bf16(
    (bf16(p) . v) / rowsum(p)) with an f32 product, lse = rowmax +
    log rowsum(p)."""
    H, d, _ = q.shape
    dv = v.shape[1]
    q4, k4, v4, s = _scores(bf16_scaled(q, scale), k, v, batch, causal, 1.0,
                            kv_len, Tq, Tk)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    pb = p.to(torch.bfloat16).float()
    o = torch.einsum("bhqk,hdbk->hdbq", pb, v4) \
        / l[..., 0].permute(1, 0, 2)[:, None]
    lse = (m + torch.log(l))[..., 0].permute(1, 0, 2).reshape(
        H, 1, batch * Tq)
    return o.reshape(H, dv, batch * Tq).to(torch.bfloat16), lse


def flash_attention_hdt_plain(q, k, v, batch, causal=False, scale=None,
                              kv_len=None):
    """(o [H, dv, B*Tq], lse [H, 1, B*Tq] f32): a full-softmax composition
    in f32 (f64 for f64 inputs) of what the kernel computes; for bf16
    inputs, the bf16 kernel's roundings (``_hdt_plain_bf16``)."""
    H, d, _ = q.shape
    dv = v.shape[1]
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.dtype == torch.bfloat16:
        return _hdt_plain_bf16(q, k, v, batch, causal, scale, kv_len, Tq, Tk)
    q4, k4, v4, s = _scores(q, k, v, batch, causal, scale, kv_len, Tq, Tk)
    lse = torch.logsumexp(s, dim=-1)                      # [B, H, Tq]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,hdbk->hdbq", p, v4).reshape(H, dv, batch * Tq)
    lse = lse.permute(1, 0, 2).reshape(H, 1, batch * Tq)
    return o.to(q.dtype), lse


def _kernel(name="ptt_flash_fwd"):
    """The forward C entry: ptt_flash_fwd (f32) or ptt_flash_fwd_bf16 (its
    path argument before the stream)."""
    if name not in _fns:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        path = [i] if name.endswith("_bf16") else []
        _fns[name] = _build.bind(name, [p] * 5 + [i] * 7 + [
            f, ctypes.POINTER(ctypes.c_longlong)] + path + [p])
    return _fns[name]


# the wgmma forward's work tile (queries) and key block by head dim
# (csrc/flash_attention_bf16.cu kWgM, WgCfg<D>::kN); the wgmma backward's
# work tiles (128 keys, or 128 queries: kBwdM), its dk/dv kernel's query
# blocks by head dim (kDkvN) and its dq kernel's key blocks (kDqN)
WG_QTILE = 128
WG_KBLOCK = {64: 128, 128: 64}
WG_DKV_BLOCK = {64: 128, 128: 64}
WG_DQ_BLOCK = 64
BF16_PATHS = ("wgmma", "sync")


def _tma_ok(ptr, strides, extents, token_rows):
    """Whether TMA can describe one operand for the wgmma forward (csrc/
    flash_attention_bf16.cu wg_ok): a 16-byte-aligned base, the unit
    stride of the orientation (feature stride 1 in token rows, token
    stride 1 in feature rows), and every other stride of a dimension
    longer than 1 a positive multiple of 8 elements; feature rows also
    need T % 8 == 0 (o is written 8 tokens a store).  strides and
    extents are (batch, head, feature, token)."""
    sb, sh, sd, st = strides
    B, H, d, T = extents

    def ok(x, n):
        return n <= 1 or (0 < x < 2 ** 39 and x % 8 == 0)

    if ptr % 16:
        return False
    if token_rows:
        return sd == 1 and ok(st, T) and ok(sh, H) and ok(sb, B)
    return st == 1 and T % 8 == 0 and ok(sd, d) and ok(sh, H) \
        and ok(sb, B)


def fwd_path(operands, d):
    """The bf16 forward's path for operands q, k, v, o given as (address,
    (batch, head, feature, token) element strides, (B, H, d, T) extents):
    "wgmma" where d is 64 or 128 and TMA can describe all four in one
    orientation (token rows where every feature stride is 1), else
    "sync"."""
    if d not in KERNEL_HEAD_DIMS:
        return "sync"
    token_rows = all(st[2] == 1 for _, st, _ in operands)
    return "wgmma" if all(_tma_ok(p, st, ex, token_rows)
                          for p, st, ex in operands) else "sync"


def fwd_bf16_path(q, k, v, o, batch=None):
    """``fwd_path`` of tensors: head-major [H, d, B*T] ones (batch given,
    as ``flash_attention_hdt`` takes them) or [B, H, T, d] ones in any
    strides."""
    if batch is not None:
        Tq, Tk = q.shape[2] // batch, k.shape[2] // batch
        ops = [(t.data_ptr(), _hdt_strides(t, T),
                (batch, t.shape[0], t.shape[1], T))
               for t, T in ((q, Tq), (k, Tk), (v, Tk), (o, Tq))]
        return fwd_path(ops, q.shape[1])
    ops = [(t.data_ptr(), _bhtd_strides(t),
            (t.shape[0], t.shape[1], t.shape[3], t.shape[2]))
           for t in (q, k, v, o)]
    return fwd_path(ops, q.shape[-1])


def bwd_path(operands, d):
    """The bf16 backward's path for operands q, k, v, do, dq, dk, dv given
    as ``fwd_path``'s: "wgmma" where d is 64 or 128 and TMA can describe
    q, k and v in one orientation (token rows where all three have feature
    stride 1) and do, dq, dk and dv each in its own (token rows where its
    feature stride is 1), else "sync"."""
    if d not in KERNEL_HEAD_DIMS:
        return "sync"
    token_rows = all(st[2] == 1 for _, st, _ in operands[:3])
    return "wgmma" if all(
        _tma_ok(p, st, ex, token_rows if i < 3 else st[2] == 1)
        for i, (p, st, ex) in enumerate(operands)) else "sync"


def bwd_bf16_path(q, k, v, do, dq, dk, dv, lse, delta, batch=None):
    """``bwd_path`` of tensors: head-major [H, d, B*T] ones (batch given,
    as ``flash_attention_hdt_bwd_bf16`` takes them) or [B, H, T, d] ones in
    any strides.  lse and delta (f32, token stride 1) do not narrow the
    choice: the kernels' producer warp reads them with ordinary loads."""
    del lse, delta
    ts = (q, k, v, do, dq, dk, dv)
    if batch is not None:
        Tq, Tk = q.shape[2] // batch, k.shape[2] // batch
        ops = [(t.data_ptr(), _hdt_strides(t, T),
                (batch, t.shape[0], t.shape[1], T))
               for t, T in zip(ts, (Tq, Tk, Tk, Tq, Tq, Tk, Tk))]
        return bwd_path(ops, q.shape[1])
    ops = [(t.data_ptr(), _bhtd_strides(t),
            (t.shape[0], t.shape[1], t.shape[3], t.shape[2])) for t in ts]
    return bwd_path(ops, q.shape[-1])


def _schedule(B, H, T, sms, tile):
    """A persistent grid's schedule on `sms` SMs: one list per CTA (the grid
    is min(work tiles, sms)) of the (batch row, head, first token) of its
    128-token work tiles in the order it takes them; CTA c takes tiles c,
    c + grid, ...  The nt tiles of (batch row, head) bh are tiles bh nt ..
    bh nt + nt - 1, so the CTAs that run at one time share its operands
    through the L2; tile bh nt + j is token tile tile(j, bh, nt)."""
    nt = -(-T // WG_QTILE)
    tiles = B * H * nt
    grid = min(tiles, sms)
    out = []
    for c in range(grid):
        mine = []
        for t in range(c, tiles, grid):
            bh, j = divmod(t, nt)
            mine.append((bh // H, bh % H, tile(j, bh, nt) * WG_QTILE))
        out.append(mine)
    return out


def bwd_bf16_schedule(B, H, Tk, sms):
    """The wgmma backward's dk/dv schedule (csrc/flash_attention_bf16.cu
    kv_work): 128-key work tiles, tile j of (batch row, head) bh being key
    tile (j + bh) % nkt, so that where the grid is a multiple of nkt a
    CTA's causal work (the queries from its keys on) rotates from one pass
    of the grid to the next.  The dq kernel takes the forward's schedule
    (``fwd_bf16_schedule``) over Tq."""
    return _schedule(B, H, Tk, sms, lambda j, bh, nt: (j + bh) % nt)


def fwd_bf16_schedule(B, H, Tq, sms):
    """The wgmma forward's persistent schedule (csrc/flash_attention_bf16.cu
    wg_work): 128-query work tiles, tile j of (batch row, head) bh being
    query tile nqt - 1 - (j + bh) % nqt, so that where the grid is a
    multiple of nqt a CTA's query tile, and with it its causal work,
    rotates from one pass of the grid to the next."""
    return _schedule(B, H, Tq, sms, lambda j, bh, nt: nt - 1 - (j + bh) % nt)


def _check_card(name, ts, d, dv, stats=(), dtypes=(torch.float32,
                                                    torch.bfloat16)):
    """The card kernels' contract: CUDA, one device, the operands ts of one
    dtype in dtypes (f32, or bf16 where a bf16 kernel exists), the stats
    (lse, delta) f32, d == dv in KERNEL_HEAD_DIMS."""
    every = tuple(ts) + tuple(stats)
    if not all(t.is_cuda for t in every):
        raise RuntimeError(f"{name} kernel: every tensor must lie on a CUDA "
                           f"device")
    if len({t.device for t in every}) != 1:
        raise ValueError(f"{name} kernel: inputs on different devices")
    kinds = {t.dtype for t in ts}
    if len(kinds) != 1 or not kinds <= set(dtypes) or not all(
            t.dtype == torch.float32 for t in stats):
        want = " or ".join(str(t)[6:].replace("float32", "f32")
                           .replace("bfloat16", "bf16") for t in dtypes)
        raise ValueError(f"{name} kernel: {want} inputs of one dtype (f32 "
                         f"lse and delta) only, got "
                         f"{[str(t.dtype) for t in every]}")
    if d not in KERNEL_HEAD_DIMS or dv != d:
        raise ValueError(f"{name} kernel: head dims d={d}, dv={dv}; the "
                         f"kernel takes d == dv in {KERNEL_HEAD_DIMS}")


def _hdt_strides(t, T):
    """(batch, head, feature, token) element strides of a head-major
    [H, d, B*T] tensor."""
    sh, sd, st = t.stride()
    return (T * st, sh, sd, st)


def _bhtd_strides(t):
    """(batch, head, feature, token) element strides of [B, H, T, d]."""
    sb, sh, st, sd = t.stride()
    return (sb, sh, sd, st)


def _stride_array(vals):
    return (ctypes.c_longlong * len(vals))(*vals)


def _fwd_call(name, q, k, v, o, lse, H, d, B, Tq, Tk, kv_len, causal,
              scale, strides, path=None):
    """One forward launch; path "wgmma" or "sync" for the bf16 entry."""
    entry = "ptt_flash_fwd_bf16" if q.dtype == torch.bfloat16 \
        else "ptt_flash_fwd"
    extra = (int(path == "wgmma"),) if path else ()
    err = _kernel(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), H, d, B, Tq, Tk, Tk if kv_len is None
        else int(kv_len), int(causal), float(scale), _stride_array(strides),
        *extra, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed"
                           f"{f' ({path} path)' if path else ''}: CUDA "
                           f"error {err}")


def _bf16_path(name, path, shape_path):
    """A bf16 kernel's path: the operands' (shape_path) unless forced to
    "wgmma" or "sync"."""
    if path not in (None,) + BF16_PATHS:
        raise ValueError(f"{name} kernel: no path {path!r}")
    return path or shape_path


def _count(fn, path):
    fn.launches += 1
    if path:
        setattr(fn, "launches_" + path, getattr(fn, "launches_" + path) + 1)


def _launch(q, k, v, batch, causal, scale, kv_len, path=None):
    """The head-major forward kernel of q's dtype: o in q's dtype, lse
    f32; bf16 on `path` (None: fwd_bf16_path's)."""
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_hdt" + ("_bf16" if bf16 else "")
    _check_card(name, (q, k, v), q.shape[1], v.shape[1])
    H, d, Nq = q.shape
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    o = torch.empty(H, d, Nq, dtype=q.dtype, device=q.device)
    lse = torch.empty(H, 1, Nq, dtype=torch.float32, device=q.device)
    if bf16:
        path = _bf16_path(name, path, fwd_bf16_path(q, k, v, o, batch))
    _fwd_call(name, q, k, v, o, lse, H, d, batch, Tq, Tk,
              kv_len, causal, scale,
              (*_hdt_strides(q, Tq), *_hdt_strides(k, Tk),
               *_hdt_strides(v, Tk), *_hdt_strides(o, Tq), Tq, Nq), path)
    _count(flash_attention_hdt_bf16 if bf16 else flash_attention_hdt, path)
    return o, lse


def flash_attention_hdt_bf16(q, k, v, batch, causal=False, scale=None,
                             kv_len=None, path=None):
    """The bf16 head-major forward kernels (csrc/flash_attention_bf16.cu)
    on bf16 CUDA tensors: (o bf16, lse f32).  The path is
    ``fwd_bf16_path`` of the operands, or `path` ("sync" runs on any
    operands; "wgmma" raises where TMA cannot describe them).  Launches are
    counted in ``flash_attention_hdt_bf16.launches``, and by path in
    ``.launches_wgmma`` and ``.launches_sync``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_hdt_bf16 kernel: bf16 inputs "
                         f"only, got {q.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[1])
    return _launch(q, k, v, batch, causal, scale, kv_len, path)


def _forward(q, k, v, batch, causal, scale, kv_len):
    if q.device.type == "cuda":
        return _launch(q, k, v, batch, causal, scale, kv_len)
    return flash_attention_hdt_plain(q, k, v, batch, causal, scale, kv_len)


def flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, batch,
                                  causal=False, scale=None, kv_len=None):
    """(dq, dk, dv) from the forward's inputs, its lse [H, 1, B*Tq], delta
    = rowsum(do * o) [H, 1, B*Tq] and do [H, dv, B*Tq]: the full-matrix
    composition of the FlashAttention-2 backward that the kernel tiles
    (p = exp(s - lse), ds = p * (do.v - delta)); for bf16 inputs with the
    bf16 kernel's roundings (s from q', p and ds rounded to bf16 before
    the gradient products, f32 sums, one rounding of each gradient)."""
    H, d, _ = q.shape
    dv = v.shape[1]
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bf16 = q.dtype == torch.bfloat16
    if bf16:   # s from q' = bf16(q * bf16(scale)); dq takes scale in f32
        q4, k4, v4, s = _scores(bf16_scaled(q, scale), k, v, batch, causal,
                                1.0, kv_len, Tq, Tk)
    else:
        q4, k4, v4, s = _scores(q, k, v, batch, causal, scale, kv_len, Tq,
                                Tk)
    acc = s.dtype

    def rows(t):                             # [H, 1, B*Tq] -> [B, H, Tq, 1]
        return t.to(acc).reshape(H, batch, Tq).permute(1, 0, 2)[..., None]

    p = torch.exp(s - rows(lse))
    do4 = do.to(acc).reshape(H, dv, batch, Tq)
    dp = torch.einsum("hdbq,hdbk->bhqk", do4, v4)
    ds = p * (dp - rows(delta))
    if bf16:   # p and ds enter their products as bf16
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dq = scale * torch.einsum("bhqk,hdbk->hdbq", ds, k4)
    dk = torch.einsum("bhqk,hdbq->hdbk", ds, q4)
    dvv = torch.einsum("bhqk,hdbq->hdbk", p, do4)
    return (dq.reshape(H, d, batch * Tq).to(q.dtype),
            dk.reshape(H, d, batch * Tk).to(k.dtype),
            dvv.reshape(H, dv, batch * Tk).to(v.dtype))


def _bwd_kernel(name="ptt_flash_bwd"):
    """The backward C entry: ptt_flash_bwd (f32) or ptt_flash_bwd_bf16 (its
    path argument before the stream)."""
    if name not in _fns:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        path = [i] if name.endswith("_bf16") else []
        _fns[name] = _build.bind(name, [p] * 9 + [i] * 7 + [
            f, ctypes.POINTER(ctypes.c_longlong)] + path + [p])
    return _fns[name]


def _bwd_call(name, q, k, v, lse, delta, do, dq, dk, dv, H, d, B, Tq, Tk,
              kv_len, causal, scale, strides, path=None):
    """One backward launch (two kernels); path "wgmma" or "sync" for the
    bf16 entry."""
    entry = "ptt_flash_bwd_bf16" if q.dtype == torch.bfloat16 \
        else "ptt_flash_bwd"
    extra = (int(path == "wgmma"),) if path else ()
    err = _bwd_kernel(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), H, d, B, Tq, Tk,
        Tk if kv_len is None else int(kv_len), int(causal), float(scale),
        _stride_array(strides), *extra,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed"
                           f"{f' ({path} path)' if path else ''}: CUDA "
                           f"error {err}")


def _launch_bwd(q, k, v, lse, delta, do, batch, causal, scale, kv_len,
                path=None):
    """The head-major backward kernels of q's dtype: dq, dk, dv in q's
    dtype; bf16 on `path` (None: bwd_bf16_path's)."""
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_hdt_bwd" + ("_bf16" if bf16 else "")
    _check_card(name, (q, k, v, do), q.shape[1], v.shape[1],
                stats=(lse, delta))
    H, d, Nq = q.shape
    if tuple(do.shape) != (H, d, Nq):
        raise ValueError(f"{name} kernel: do {tuple(do.shape)} != "
                         f"{(H, d, Nq)}")
    for what, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (H, 1, Nq) or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} must be contiguous "
                             f"{(H, 1, Nq)}, got {tuple(t.shape)}")
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    dq = torch.empty(H, d, Nq, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dvv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    if bf16:
        path = _bf16_path(name, path, bwd_bf16_path(
            q, k, v, do, dq, dk, dvv, lse, delta, batch))
    _bwd_call(name, q, k, v, lse, delta, do, dq, dk,
              dvv, H, d, batch, Tq, Tk, kv_len, causal, scale,
              (*_hdt_strides(q, Tq), *_hdt_strides(k, Tk),
               *_hdt_strides(v, Tk), *_hdt_strides(do, Tq),
               *_hdt_strides(dq, Tq), *_hdt_strides(dk, Tk),
               *_hdt_strides(dvv, Tk), Tq, Nq), path)
    _count(flash_attention_hdt_bwd_bf16 if bf16 else flash_attention_hdt_bwd,
           path)
    return dq, dk, dvv


def flash_attention_hdt_bwd_bf16(q, k, v, lse, delta, do, batch,
                                 causal=False, scale=None, kv_len=None,
                                 path=None):
    """The bf16 head-major backward kernels (csrc/flash_attention_bf16.cu,
    dk/dv then dq) on bf16 CUDA tensors, f32 lse and delta: (dq, dk, dv)
    bf16.  The path is ``bwd_bf16_path`` of the operands, or `path`
    ("sync" runs on any operands; "wgmma" raises where TMA cannot describe
    them).  Its launches (one per call, two kernels) are counted in
    ``flash_attention_hdt_bwd_bf16.launches``, and by path in
    ``.launches_wgmma`` and ``.launches_sync``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_hdt_bwd_bf16 kernel: bf16 inputs "
                         f"only, got {q.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[1])
    return _launch_bwd(q, k, v, lse, delta, do, batch, causal, scale, kv_len,
                       path)


def flash_attention_hdt_bwd(q, k, v, lse, delta, do, batch,
                            causal: bool = False, scale: float = None,
                            kv_len: int = None):
    """The backward of ``flash_attention_hdt``: (dq, dk, dv) in the
    head-major layout, deterministic (no atomics)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[1])
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, lse, delta, do, batch, causal, scale,
                           kv_len)
    return flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, batch,
                                         causal, scale, kv_len)


class _FlashHdt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, batch, causal, scale, kv_len):
        o, lse = _forward(q, k, v, batch, causal, scale, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (batch, causal, scale, kv_len)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        acc = torch.promote_types(o.dtype, torch.float32)
        delta = torch.sum(do.to(acc) * o.to(acc), dim=1, keepdim=True)
        dq, dk, dv = flash_attention_hdt_bwd(q, k, v, lse, delta,
                                             do.to(q.dtype), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_hdt(q, k, v, batch, causal: bool = False,
                        scale: float = None, kv_len: int = None):
    """Flash attention in the transpose-free head-major layout.

    q, k: [H, d, batch*Tq] / [H, d, batch*Tk]; v: [H, dv, batch*Tk].
    Returns (o [H, dv, batch*Tq], lse [H, 1, batch*Tq] f32).  Keys at
    positions >= kv_len are masked; causal requires Tq == Tk.  Any Tq, Tk.
    Differentiable in q, k and v.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[1])
    return _FlashHdt.apply(q, k, v, batch, causal, scale, kv_len)


flash_attention_hdt.launches = 0
flash_attention_hdt_bwd.launches = 0
flash_attention_hdt_bf16.launches = 0
flash_attention_hdt_bf16.launches_wgmma = 0
flash_attention_hdt_bf16.launches_sync = 0
flash_attention_hdt_bwd_bf16.launches = 0
flash_attention_hdt_bwd_bf16.launches_wgmma = 0
flash_attention_hdt_bwd_bf16.launches_sync = 0


# --- [B, H, T, d] in any strides (JAX flash_attention.py:441) ---------------

def _check_bhtd(q, k, v, causal):
    """The [B, H, T, d] contract; returns (B, H, Tq, Tk, d)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: q, k, v must be [B, H, T, d], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Tq, d = q.shape
    if (tuple(k.shape[:2]) != (B, H) or k.shape[3] != d
            or tuple(v.shape[:3]) != tuple(k.shape[:3])):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Tk = k.shape[2]
    if causal and Tq != Tk:
        raise ValueError("causal attention requires Tq == Tk")
    return B, H, Tq, Tk, d


def _scores_bhtd(q, k, causal, scale):
    """(q*scale, k) in the working precision and the masked scores
    [B, H, Tq, Tk]."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qs, kf = q.to(acc) * scale, k.to(acc)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        Tq, Tk = s.shape[-2:]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return qs, kf, s


def _to_hdt(t):
    """[B, H, T, c] -> the head-major [H, c, B*T] (a copy)."""
    B, H, T, c = t.shape
    return t.permute(1, 3, 0, 2).reshape(H, c, B * T)


def _from_hdt(t, B):
    """The head-major [H, c, B*T] -> [B, H, T, c]."""
    H, c, N = t.shape
    return t.reshape(H, c, B, N // B).permute(2, 0, 3, 1)


def _rows_to_hdt(t):
    """[B, H, T] f32 rows (lse, delta) -> [H, 1, B*T]."""
    B, H, T = t.shape
    return t.permute(1, 0, 2).reshape(H, 1, B * T)


def _bhtd_plain_bf16(q, k, v, causal, scale):
    """The bf16 forward of [B, H, T, d] inputs: the head-major bf16
    composition (``_hdt_plain_bf16``) on head-major copies, the Pallas
    kernel's roundings with one key block."""
    B, H, Tq, _ = q.shape
    o, lse = flash_attention_hdt_plain(_to_hdt(q), _to_hdt(k), _to_hdt(v),
                                       B, causal, scale)
    return _from_hdt(o, B), lse.reshape(H, B, Tq).permute(1, 0, 2) \
        .contiguous()


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """(o [B, H, Tq, dv], lse [B, H, Tq] f32): a full-softmax composition
    in f32 (f64 for f64 inputs) of what the kernel computes; for bf16
    inputs, the bf16 kernel's roundings (``_bhtd_plain_bf16``)."""
    _check_bhtd(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.bfloat16:
        return _bhtd_plain_bf16(q, k, v, causal, scale)
    _, _, s = _scores_bhtd(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.to(s.dtype))
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, lse, delta, do, causal=False,
                              scale=None):
    """(dq, dk, dv) from the forward's inputs, its lse [B, H, Tq], delta =
    rowsum(do * o) [B, H, Tq] and do [B, H, Tq, dv]: the full-matrix
    composition of the FlashAttention-2 backward that the kernels tile;
    for bf16 inputs the head-major composition with the bf16 kernel's
    roundings (``flash_attention_hdt_bwd_plain``)."""
    _check_bhtd(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.bfloat16:
        B = q.shape[0]
        grads = flash_attention_hdt_bwd_plain(
            _to_hdt(q), _to_hdt(k), _to_hdt(v), _rows_to_hdt(lse),
            _rows_to_hdt(delta), _to_hdt(do), B, causal, scale)
        return tuple(_from_hdt(t, B) for t in grads)
    qs, kf, s = _scores_bhtd(q, k, causal, scale)
    acc = s.dtype
    p = torch.exp(s - lse.to(acc)[..., None])
    dof = do.to(acc)
    ds = p * (torch.matmul(dof, v.to(acc).transpose(-1, -2))
              - delta.to(acc)[..., None])
    dq = scale * torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dvv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def _launch_bhtd(q, k, v, causal, scale, path=None):
    """The [B, H, T, d] forward kernel of q's dtype: o in q's dtype and,
    where q is dense, q's layout (a [B, T, H, d] view stays one); lse
    f32; bf16 on `path` (None: fwd_bf16_path's)."""
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention" + ("_bf16" if bf16 else "")
    _check_card(name, (q, k, v), q.shape[-1], v.shape[-1])
    B, H, Tq, Tk, d = _check_bhtd(q, k, v, causal)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    if bf16:
        path = _bf16_path(name, path, fwd_bf16_path(q, k, v, o))
    _fwd_call(name, q, k, v, o, lse, H, d, B, Tq, Tk, None, causal, scale,
              (*_bhtd_strides(q), *_bhtd_strides(k), *_bhtd_strides(v),
               *_bhtd_strides(o), *lse.stride()[:2]), path)
    _count(flash_attention_bf16 if bf16 else flash_attention, path)
    return o, lse


def flash_attention_bf16(q, k, v, causal=False, scale=None, path=None):
    """The bf16 [B, H, T, d] forward kernels (csrc/flash_attention_bf16.cu)
    on bf16 CUDA tensors in any strides: (o bf16, lse f32).  The path is
    ``fwd_bf16_path`` of the operands or `path`, as in
    ``flash_attention_hdt_bf16``.  Launches are counted in
    ``flash_attention_bf16.launches``, and by path in ``.launches_wgmma``
    and ``.launches_sync``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bf16 kernel: bf16 inputs only, "
                         f"got {q.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch_bhtd(q, k, v, causal, scale, path)


def _launch_bwd_bhtd(q, k, v, lse, delta, do, causal, scale, path=None):
    """The [B, H, T, d] backward kernels of q's dtype: dq, dk, dv in q's
    dtype, each in its input's layout where that is dense; bf16 on `path`
    (None: bwd_bf16_path's)."""
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_bwd" + ("_bf16" if bf16 else "")
    _check_card(name, (q, k, v, do), q.shape[-1], v.shape[-1],
                stats=(lse, delta))
    B, H, Tq, Tk, d = _check_bhtd(q, k, v, causal)
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name} kernel: do {tuple(do.shape)} != "
                         f"{tuple(q.shape)}")
    for what, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Tq) or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} must be contiguous "
                             f"{(B, H, Tq)}, got {tuple(t.shape)}")
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if bf16:
        path = _bf16_path(name, path, bwd_bf16_path(
            q, k, v, do, dq, dk, dvv, lse, delta))
    _bwd_call(name, q, k, v, lse, delta, do, dq, dk, dvv, H, d, B, Tq, Tk,
              None, causal, scale,
              (*_bhtd_strides(q), *_bhtd_strides(k), *_bhtd_strides(v),
               *_bhtd_strides(do), *_bhtd_strides(dq), *_bhtd_strides(dk),
               *_bhtd_strides(dvv), *lse.stride()[:2]), path)
    _count(flash_attention_bwd_bf16 if bf16 else flash_attention_bwd, path)
    return dq, dk, dvv


def flash_attention_bwd_bf16(q, k, v, lse, delta, do, causal=False,
                             scale=None, path=None):
    """The bf16 [B, H, T, d] backward kernels (csrc/flash_attention_bf16.cu,
    dk/dv then dq) on bf16 CUDA tensors, f32 lse and delta: (dq, dk, dv)
    bf16.  The path is ``bwd_bf16_path`` of the operands or `path`, as in
    ``flash_attention_hdt_bwd_bf16``.  Its launches (one per call, two
    kernels) are counted in ``flash_attention_bwd_bf16.launches``, and by
    path in ``.launches_wgmma`` and ``.launches_sync``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd_bf16 kernel: bf16 inputs "
                         f"only, got {q.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch_bwd_bhtd(q, k, v, lse, delta, do, causal, scale, path)


def flash_attention_bwd(q, k, v, lse, delta, do, causal: bool = False,
                        scale: float = None):
    """The backward of ``flash_attention`` in the [B, H, T, d] layout:
    (dq, dk, dv), each in its input's layout where that is dense;
    deterministic (no atomics)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, lse, delta, do, causal,
                                         scale)
    return _launch_bwd_bhtd(q, k, v, lse, delta, do, causal, scale)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cuda":
            o, lse = _launch_bhtd(q, k, v, causal, scale)
        else:
            o, lse = flash_attention_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        acc = torch.promote_types(o.dtype, torch.float32)
        delta = torch.sum(do.to(acc) * o.to(acc), dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, delta,
                                         do.to(q.dtype), *ctx.args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale: float = None):
    """Flash attention on q, k, v [B, H, T, d] (or [BH, T, d]) in any
    strides; returns o of q's shape (in q's layout where q is dense, so a
    [B, T, H, d] view in gives one out).  Any T: ragged tiles are masked
    in the kernel, nothing is padded.  Causal requires Tq == Tk.
    Differentiable in q, k and v."""
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[:, None], k[:, None], v[:, None]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o = _Flash.apply(q, k, v, bool(causal), float(scale))
    return o[:, 0] if squeeze else o


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bf16.launches = 0
flash_attention_bf16.launches_wgmma = 0
flash_attention_bf16.launches_sync = 0
flash_attention_bwd_bf16.launches = 0
flash_attention_bwd_bf16.launches_wgmma = 0
flash_attention_bwd_bf16.launches_sync = 0

"""Streamed LM head with softmax cross-entropy, forward and backward: the
hand-written CUDA kernels and their plain torch versions.

Replaces the Pallas TPU kernels ``paddle_tpu/kernels/lm_head.py:_fwd``
(body ``_fwd_kernel``) and ``_bwd`` (body ``_bwd_kernel``), entry
``lm_head_xent``, called by the ``fused_lm_head_loss`` op.  The kernel
source is ``csrc/lm_head.cu`` on the tile loop of ``csrc/gemm_tc.cuh``;
its header says what bounds it on the H100 (operations: one product of
x [N, D] and W [D, V] forward, three backward, each on the TF32 tensor
cores in three passes) and how the design streams the vocabulary: the
forward keeps a running (max, sum of exp, gold logit) per token across
vocab tiles, so no [N, V] logits reach device memory, and the backward
goes chunk by chunk through a [chunk, V] dlogits scratch.  The wrappers
allocate the kernels' workspace (x and W split into TF32 (hi, lo) pairs,
the scratch, partial sums), sized by the library's ``*_workspace``
entries.

``lm_head_xent(x, w, labels)`` is the differentiable entry (a
``torch.autograd.Function`` over ``lm_head_fwd`` and ``lm_head_bwd``); it
returns the per-token loss [N] f32, 0 where the label is negative.  Both
directions decide by the tensors' device: CUDA tensors launch the kernel
(or raise), CPU or meta tensors take ``lm_head_fwd_plain`` /
``lm_head_bwd_plain``.  ``lm_head_fwd.launches`` counts forward launches,
``lm_head_bwd.launches`` one per token chunk of the backward.  Any N and
any V: the JAX gates on N % 256 and d <= 2048 exist for Mosaic's tiles.

Under ``FLAGS_amp_bf16`` the ``fused_lm_head_loss`` op hands the head bf16
x and W.  Those go to the kernels of ``csrc/lm_head_bf16.cu`` (wrappers
``lm_head_fwd_bf16`` and ``lm_head_bwd_bf16``, each with its own
``.launches``), bf16 products with f32 accumulation, no split.  Each
direction has two paths, chosen on the host from the operands before the
launch (``bf16_path``, one condition for both): "wgmma",
built from the pieces of ``csrc/wgmma_bf16.cuh`` (TMA loads into an
mbarrier ring, ``wgmma``, a producer warp and two consumer warpgroups on a
persistent grid), where TMA can describe x and W (16-byte-aligned bases, D
and V multiples of 8); and "sync", the ``mma.sync`` loop of
``csrc/gemm_bf16.cuh``, for the rest (an odd D or V).  The wgmma forward
splits the flat (token tile, vocab tile) grid evenly over min(SMs, tiles)
CTAs (``fwd_bf16_plan``), keeps x's tile in shared memory where D <= 640
and folds each vocab tile into the running softmax in the epilogue.  Each
path counts its launches apart (``.launches_wgmma``, ``.launches_sync`` of
both wrappers; the backward's are chunks).  Loss and lse stay f32.  The
backward rounds where the Pallas kernel rounds in bf16: dlogits to x's
dtype before the dx and dW products (lm_head.py:128), dx once per chunk
(:243), and dW summed in f32 over the chunks and rounded once at the end
(:244).  The plain versions carry the same roundings for bf16 inputs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._wgmma import WG_KTILE, WG_TILE

DEFAULT_CHUNK = 4096
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library entry -> (argument types, result type)
_SIGNATURES = {
    "ptt_lm_head_fwd_workspace": ([_I] * 3, _LL),
    "ptt_lm_head_bwd_workspace": ([_I] * 3, _LL),
    "ptt_lm_head_fwd": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "ptt_lm_head_bwd_chunk": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "ptt_lm_head_fwd_bf16_workspace": ([_I] * 3, _LL),
    "ptt_lm_head_bwd_bf16_workspace": ([_I] * 3, _LL),
    "ptt_lm_head_fwd_bf16": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "ptt_lm_head_bwd_chunk_bf16": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "ptt_lm_head_bwd_bf16_wgmma_workspace": ([_I] * 4, _LL),
    "ptt_lm_head_bwd_chunk_bf16_wgmma": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "ptt_lm_head_fwd_bf16_wgmma_workspace": ([_I] * 3, _LL),
    "ptt_lm_head_fwd_bf16_wgmma": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "ptt_lm_head_fwd_bf16_wgmma_plan": ([_I] * 3 + [_P] * 2 + [_I], _I),
}
# the wgmma forward's shared memory (csrc/lm_head_bf16.cu fwd_wg): a
# block's opt-in bytes, the alignment pad and the barriers' 2 KiB, one
# 16-KiB box of 64 k x 128 rows, the ring's stages at least (where x stays
# resident) and at most
FWD_SMEM, FWD_FIXED, FWD_BOX = 232448, 1024 + 2048, 16384
FWD_MIN_STAGES, FWD_MAX_STAGES = 4, 8
_fns = {}
_sms = {}


def _check(x, w, labels):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"lm_head: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain as [N, D] x [D, V]")
    if tuple(labels.shape) != (x.shape[0],):
        raise ValueError(f"lm_head: labels {tuple(labels.shape)} != "
                         f"[{x.shape[0]}]")


def _cdiv(a, b):
    return -(-a // b)


def bf16_path(x_ptr: int, w_ptr: int, D: int, V: int) -> str:
    """The path of the bf16 forward and backward for x [N, D] at address
    x_ptr and W [D, V] at w_ptr, both contiguous: "wgmma" where TMA can
    describe both (bases 16-byte aligned, rows of D and V bf16 a multiple
    of 16 bytes, so every chunk's rows are too), else "sync"."""
    aligned = x_ptr % 16 == 0 and w_ptr % 16 == 0 and D % 8 == 0 \
        and V % 8 == 0
    return "wgmma" if aligned else "sync"


def fwd_bf16_plan(N: int, D: int, V: int, sms: int) -> dict:
    """The wgmma forward's schedule on `sms` SMs, as the kernel's
    fwd_wg_plan makes it.  The (token tile, vocab tile) grid of 128 x 128
    tiles, flattened with the vocabulary fastest (tile t = m nt + v), is
    cut into `ctas` = min(sms, tiles) contiguous ranges of floor(c tiles /
    ctas) boundaries, one per persistent CTA.  A range's tiles of one token
    tile are a segment, which writes its rows' state to slot (CTA - the
    token tile's first CTA) of the workspace: `slots` is the most any token
    tile takes.  x stays in shared memory where its cdiv(D, 64) boxes leave
    room for at least 4 ring stages of W (D <= 640); `stages` is the ring's
    depth (W's 16-KiB k-tiles beside resident x, else x's and W's)."""
    mt, nt = _cdiv(N, WG_TILE), _cdiv(V, WG_TILE)
    tiles = mt * nt
    ctas = min(sms, tiles)

    def owner(t):
        return ((t + 1) * ctas - 1) // tiles

    slots = max(owner(m * nt + nt - 1) - owner(m * nt) + 1
                for m in range(mt))
    room = FWD_SMEM - FWD_FIXED
    res = (room - _cdiv(D, WG_KTILE) * FWD_BOX) // FWD_BOX
    resident = res >= FWD_MIN_STAGES
    stages = min(FWD_MAX_STAGES, res if resident else room // (2 * FWD_BOX))
    return dict(token_tiles=mt, vocab_tiles=nt, tiles=tiles, ctas=ctas,
                slots=slots, x_resident=resident, stages=stages)


def fwd_bf16_segments(N: int, V: int, ctas: int) -> list:
    """The wgmma forward's segments in the order the kernel runs them: (CTA,
    token tile, first vocab tile, end vocab tile, slot) for each CTA's
    range [floor(c tiles / ctas), floor((c + 1) tiles / ctas)) cut at the
    token tiles' boundaries."""
    nt = _cdiv(V, WG_TILE)
    tiles = _cdiv(N, WG_TILE) * nt
    out = []
    for c in range(ctas):
        t, end = c * tiles // ctas, (c + 1) * tiles // ctas
        while t < end:
            m = t // nt
            se = min(end, (m + 1) * nt)
            first = ((m * nt + 1) * ctas - 1) // tiles
            out.append((c, m, t - m * nt, se - m * nt, c - first))
            t = se
    return out


def bwd_bf16_plan(cap: int, D: int, V: int, sms: int) -> dict:
    """The wgmma path's tiles for chunks of at most `cap` rows on `sms`
    SMs: each product's output tiles (the grid is min(tiles, sms)
    persistent CTAs) and the dx product's K ranges.  dx has only
    cdiv(cap, 128) x cdiv(D, 128) output tiles, so its vocabulary (K,
    cdiv(V, 64) k-tiles) is cut into ranges of `range_ktiles` k-tiles (the
    last shorter) where those tiles alone fill less than the SMs: floor(sms
    / tiles) ranges, at least one and at most one a k-tile, then as many as
    ranges of cdiv(k-tiles, ranges) need (the kernel's ptt_wg::sched).
    Each range's partial is summed in range order."""
    dx_tiles = _cdiv(cap, WG_TILE) * _cdiv(D, WG_TILE)
    kt = _cdiv(V, WG_KTILE)
    want = max(1, min(kt, sms // dx_tiles))
    ranges = _cdiv(kt, _cdiv(kt, want))
    return dict(dlogits_tiles=_cdiv(cap, WG_TILE) * _cdiv(V, WG_TILE),
                dx_tiles=dx_tiles,
                dw_tiles=_cdiv(D, WG_TILE) * _cdiv(V, WG_TILE),
                ranges=ranges, range_ktiles=_cdiv(kt, ranges))


def lm_head_fwd_plain(x, w, labels):
    """(loss [N], lse [N]) in f32 (f64 for f64 inputs): the full-logits
    composition of what the kernel streams."""
    _check(x, w, labels)
    acc = torch.promote_types(x.dtype, torch.float32)
    logits = torch.matmul(x.to(acc), w.to(acc))
    lse = torch.logsumexp(logits, dim=1)
    y = labels.long()
    gold = torch.gather(logits, 1, y.clamp(min=0)[:, None])[:, 0]
    return (lse - gold) * (y >= 0).to(acc), lse


def lm_head_bwd_plain(x, w, labels, lse, g, chunk: int = DEFAULT_CHUNK):
    """(dx, dw) from the saved (x, w, labels, lse) and the loss cotangent g
    [N]: dlogits = (softmax - onehot) * g, with g zeroed at ignored labels,
    recomputed chunk by chunk as the kernel does.  For bf16 x the dlogits
    are rounded to bf16 before the products, dw is summed in f32 and dx and
    dw are rounded once."""
    _check(x, w, labels)
    acc = torch.promote_types(x.dtype, torch.float32)
    N = x.shape[0]
    wf = w.to(acc)
    y = labels.long()
    gm = g.to(acc) * (y >= 0).to(acc)
    dx = torch.empty(x.shape, dtype=acc, device=x.device)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    for r0 in range(0, N, chunk):
        sl = slice(r0, min(r0 + chunk, N))
        xs = x[sl].to(acc)
        dl = torch.exp(torch.matmul(xs, wf) - lse[sl].to(acc)[:, None])
        rows = torch.arange(dl.shape[0], device=x.device)
        dl[rows, y[sl].clamp(min=0)] -= (y[sl] >= 0).to(acc)
        dl = dl * gm[sl, None]
        if x.dtype == torch.bfloat16:   # dlogits enter the products as bf16
            dl = dl.to(torch.bfloat16).to(acc)
        dx[sl] = torch.matmul(dl, wf.t())
        dw += torch.matmul(xs.t(), dl)
    return dx.to(x.dtype), dw.to(w.dtype)


def _require(name, ts, labels, contiguous, stats=()):
    """The card kernels' contract: CUDA, one device, x and W (ts) of one
    dtype, f32 or bf16, the stats (lse, g) f32, integer labels."""
    every = tuple(ts) + tuple(stats)
    if not (all(t.is_cuda for t in every) and labels.is_cuda):
        raise RuntimeError(f"{name} kernel: every tensor must lie on a CUDA "
                           f"device")
    if len({t.device for t in every} | {labels.device}) != 1:
        raise ValueError(f"{name} kernel: inputs on different devices")
    kinds = {t.dtype for t in ts}
    if len(kinds) != 1 or not kinds <= {torch.float32, torch.bfloat16} \
            or not all(t.dtype == torch.float32 for t in stats):
        raise ValueError(f"{name} kernel: f32 or bf16 x and w of one dtype "
                         f"(f32 lse and g) only, got "
                         f"{[str(t.dtype) for t in every]}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} kernel: integer labels only, got "
                         f"{labels.dtype}")
    if not all(t.is_contiguous() for t in contiguous):
        raise ValueError(f"{name} kernel: inputs must be contiguous")


def _fn(name):
    """The library entry `name`, bound on first use."""
    if name not in _fns:
        _fns[name] = _build.bind(name, *_SIGNATURES[name])
    return _fns[name]


def _workspace(name, dims, device):
    nbytes = int(_fn(name)(*dims))
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _sm_count(device):
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def fwd_bf16_plan_of_library(N: int, D: int, V: int) -> dict:
    """The wgmma forward's plan as the library makes it on the current
    card (ptt_lm_head_fwd_bf16_wgmma_plan): fwd_bf16_plan's ctas, slots,
    x_resident and stages, and `begins`, each CTA's first flat tile and the
    tile count last.  For checking fwd_bf16_plan and fwd_bf16_segments,
    which the CPU tests hold the schedule to, against the kernel's own."""
    out = (ctypes.c_int * 6)()
    begins = (ctypes.c_int * (_sm_count(torch.device("cuda")) + 1))()
    err = _fn("ptt_lm_head_fwd_bf16_wgmma_plan")(
        N, D, V, ctypes.addressof(out), ctypes.addressof(begins),
        len(begins))
    if err:
        raise ValueError(f"lm_head_fwd_bf16: no wgmma plan for N {N}, D {D}, "
                         f"V {V} (CUDA error {err})")
    ctas = out[0]
    return dict(ctas=ctas, slots=out[1], x_resident=bool(out[3]),
                stages=out[4], begins=list(begins[:ctas + 1]))


def _bf16_path(name, x, w, path):
    """The path of a bf16 call: the operands' (``bf16_path``), or
    `path`, which may not be "wgmma" where TMA cannot describe them."""
    D, V = w.shape
    shape_path = bf16_path(x.data_ptr(), w.data_ptr(), D, V)
    if path not in (None, "sync", "wgmma"):
        raise ValueError(f"{name} kernel: no path {path!r}")
    if path == "wgmma" != shape_path:
        raise ValueError(f"{name} kernel: the wgmma path needs "
                         f"16-byte-aligned x and w and D, V multiples of 8 "
                         f"(D {D}, V {V})")
    return path or shape_path


def _launch_fwd(x, w, labels, path=None):
    _check(x, w, labels)
    bf16 = x.dtype == torch.bfloat16
    name = "lm_head_fwd" + ("_bf16" if bf16 else "")
    _require(name, (x, w), labels, (x, w))
    N, D = x.shape
    V = w.shape[1]
    if bf16:
        path = _bf16_path(name, x, w, path)
    y = labels.to(torch.int64).contiguous()
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return loss, lse
    entry = "ptt_" + name + ("_wgmma" if path == "wgmma" else "")
    work = _workspace(entry + "_workspace", (N, D, V), x.device)
    err = _fn(entry)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), work.data_ptr(), N, D, V,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed "
                           f"({path or 'f32'} path): CUDA error {err}")
    if bf16:
        lm_head_fwd_bf16.launches += 1
        if path == "wgmma":
            lm_head_fwd_bf16.launches_wgmma += 1
        else:
            lm_head_fwd_bf16.launches_sync += 1
    else:
        lm_head_fwd.launches += 1
    return loss, lse


def _launch_bwd(x, w, labels, lse, g, chunk, path=None):
    _check(x, w, labels)
    bf16 = x.dtype == torch.bfloat16
    name = "lm_head_bwd" + ("_bf16" if bf16 else "")
    # g may be any layout (autograd hands an expanded 1/N): the wrapper
    # makes its masked copy below
    _require(name, (x, w), labels, (x, w, lse), stats=(lse, g))
    N, D = x.shape
    V = w.shape[1]
    if tuple(lse.shape) != (N,) or tuple(g.shape) != (N,):
        raise ValueError(f"{name} kernel: lse {tuple(lse.shape)} and g "
                         f"{tuple(g.shape)} must be [{N}]")
    if bf16:
        path = _bf16_path(name, x, w, path)
    y = labels.to(torch.int64).contiguous()
    gm = (g * (y >= 0)).contiguous()
    dx = torch.empty(N, D, dtype=x.dtype, device=x.device)
    dw = torch.zeros(D, V, dtype=x.dtype, device=x.device)
    chunk = max(1, min(int(chunk), N))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    extra = []
    if path == "wgmma":
        ranges = bwd_bf16_plan(chunk, D, V, _sm_count(x.device))["ranges"]
        work = _workspace("ptt_lm_head_bwd_bf16_wgmma_workspace",
                          (chunk, D, V, ranges), x.device)
        fn = _fn("ptt_lm_head_bwd_chunk_bf16_wgmma")
        extra = [ranges]
    elif bf16:
        # dW is summed in f32 in the workspace and written, rounded to
        # bf16, by the last chunk
        work = _workspace("ptt_lm_head_bwd_bf16_workspace", (chunk, D, V),
                          x.device)
        fn = _fn("ptt_lm_head_bwd_chunk_bf16")
    else:
        work = _workspace("ptt_lm_head_bwd_workspace", (chunk, D, V),
                          x.device)
        fn = _fn("ptt_lm_head_bwd_chunk")
    for ci, r0 in enumerate(range(0, N, chunk)):
        rows = min(chunk, N - r0)
        args = [x[r0:].data_ptr(), w.data_ptr(), y[r0:].data_ptr(),
                lse[r0:].data_ptr(), gm[r0:].data_ptr(), work.data_ptr(),
                dx[r0:].data_ptr(), dw.data_ptr(), rows, chunk, D, V,
                int(ci > 0)]
        if bf16:
            args.append(int(r0 + rows == N))   # the last chunk writes dW
        err = fn(*args, *extra, stream)
        if err:
            raise RuntimeError(f"{name} kernel launch failed "
                               f"({path or 'f32'} path): CUDA error {err}")
        if bf16:
            lm_head_bwd_bf16.launches += 1
            if path == "wgmma":
                lm_head_bwd_bf16.launches_wgmma += 1
            else:
                lm_head_bwd_bf16.launches_sync += 1
        else:
            lm_head_bwd.launches += 1
    return dx, dw


def lm_head_fwd(x, w, labels):
    """(loss [N], lse [N]) f32 of the LM head x [N, D] . w [D, V] with
    softmax cross-entropy against labels [N] (negative = ignored)."""
    if x.device.type == "cuda":
        return _launch_fwd(x, w, labels)
    return lm_head_fwd_plain(x, w, labels)


def lm_head_bwd(x, w, labels, lse, g, chunk: int = DEFAULT_CHUNK):
    """(dx, dw) of the LM head for the loss cotangent g [N]; the tokens go
    through in chunks of `chunk` rows."""
    if x.device.type == "cuda":
        return _launch_bwd(x, w, labels, lse, g, chunk)
    return lm_head_bwd_plain(x, w, labels, lse, g, chunk)


def lm_head_fwd_bf16(x, w, labels, path=None):
    """The bf16 forward kernels (csrc/lm_head_bf16.cu) on bf16 CUDA x and
    w: (loss, lse) f32.  The path is ``bf16_path`` of the operands, or
    `path` ("sync" runs on any operands, "wgmma" raises where TMA cannot
    describe them).  ``lm_head_fwd_bf16.launches`` counts its calls,
    ``.launches_wgmma`` and ``.launches_sync`` those of each path."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"lm_head_fwd_bf16 kernel: bf16 inputs only, got "
                         f"{x.dtype}")
    return _launch_fwd(x, w, labels, path)


def lm_head_bwd_bf16(x, w, labels, lse, g, chunk: int = DEFAULT_CHUNK,
                     path=None):
    """The bf16 backward kernels (csrc/lm_head_bf16.cu) on bf16 CUDA x and
    w: (dx, dw) bf16.  The path is ``bf16_path`` of the operands, or
    `path` ("sync" runs on any operands, "wgmma" raises where TMA cannot
    describe them).  ``lm_head_bwd_bf16.launches`` counts one per token
    chunk, ``.launches_wgmma`` and ``.launches_sync`` those of each path."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"lm_head_bwd_bf16 kernel: bf16 inputs only, got "
                         f"{x.dtype}")
    return _launch_bwd(x, w, labels, lse, g, chunk, path)


class _LmHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        loss, lse = lm_head_fwd(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = lm_head_bwd(x, w, labels, lse, g, ctx.chunk)
        return dx, dw, None, None


def lm_head_xent(x, w, labels, chunk: int = DEFAULT_CHUNK):
    """Per-token softmax cross-entropy through the streamed LM head:
    x [N, D], w [D, V], labels [N] int (negative = ignored) -> loss [N] f32
    (0 at ignored positions).  Differentiable in x and w."""
    return _LmHead.apply(x, w, labels, int(chunk))


lm_head_fwd.launches = 0
lm_head_bwd.launches = 0
lm_head_fwd_bf16.launches = 0
lm_head_fwd_bf16.launches_wgmma = 0
lm_head_fwd_bf16.launches_sync = 0
lm_head_bwd_bf16.launches = 0
lm_head_bwd_bf16.launches_wgmma = 0
lm_head_bwd_bf16.launches_sync = 0

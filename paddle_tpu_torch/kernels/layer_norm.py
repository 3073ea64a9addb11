"""Row layer norm forward: the hand-written CUDA kernel and its plain
torch version.

Replaces the Pallas TPU kernel ``paddle_tpu/kernels/layer_norm.py:_ln_fwd``
(body ``_ln_kernel``), called there by ``fused_layer_norm``.  The kernel
source is ``csrc/layer_norm.cu``; its header says what bounds it on the
H100 (memory: x read once, y written once) and how the design keeps the
row on chip (in registers, or in shared memory on the v16 path's TMA
form) between the statistics and the output so x is read from device
memory once.

``layer_norm`` decides by the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU or meta tensor takes ``layer_norm_plain``.
``layer_norm.launches`` counts kernel launches.

bf16 rows have two paths, chosen on the host before the launch
(``bf16_path``): "v16" (16-byte accesses, a persistent grid, gamma and
beta in registers: ``ln_fwd_v16_tma_kernel``, rows streamed through
shared memory by TMA bulk copies, up to D 1024; ``ln_fwd_v16_row_kernel``
above) where D % 8 == 0, 8 <= D <= 8192 and x and y are 16-byte aligned,
else "scalar" (the f32 rows' ``ln_fwd_kernel``).
``layer_norm(..., path="scalar")`` forces the scalar path;
``path="v16"`` raises before any launch on rows it cannot take.
``layer_norm.launches_v16`` and ``.launches_scalar`` count the bf16
launches by path; a failed launch raises and is never retried on the
other path.  ``bf16_plan`` mirrors the library's plan of the v16 grid
(``bf16_plan_of_library``).

``layer_norm_train`` is the differentiable entry (a
``torch.autograd.Function`` over ``layer_norm``).  Its backward,
``layer_norm_bwd_plain``, is the JAX package's analytic VJP
(``_make_ln.bwd``, paddle_tpu/kernels/layer_norm.py:84-103), cotangents
through the mean and rstd outputs included.  That VJP is XLA math there,
not a Pallas kernel, so it is plain torch on both devices here.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_D = 8192
BF16_PATHS = ("v16", "scalar")
# the v16 kernels: up to V16_WARP_MAX_D a warp a row, V16_TMA_CONSUMERS
# rows (one per consumer warp, beside a producer warp) a CTA at a time; a
# CTA of V16_ROW_THREADS a row above; at most V16_MAX_WORDS 16-byte words
# (8 bf16) a lane
V16_WARP_MAX_D = 1024
V16_TMA_CONSUMERS = 4
V16_ROW_THREADS = 256
V16_MAX_WORDS = 4
_fns = {}


def layer_norm_plain(x2d: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5):
    """(y, mean, rstd) of x2d [N, D]: f32 statistics (f64 for f64 input),
    centred variance, y in x's dtype — the arithmetic of the JAX package's
    _ln_kernel."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    x = x2d.to(acc)
    mu = torch.mean(x, dim=1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.to(acc) + beta.to(acc)
    return y.to(x2d.dtype), mu[:, 0], rstd[:, 0]


def layer_norm_bwd_plain(x2d, gamma, mean, rstd, gy, gmean=None,
                         grstd=None):
    """(dx, dgamma, dbeta) from the saved (x, gamma, mean, rstd) and the
    cotangents of (y, mean, rstd); a None cotangent counts as zero."""
    acc = mean.dtype
    xf = x2d.to(acc)
    gyf = gy.to(acc)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    gf = gamma.to(acc)
    dgamma = torch.sum(gyf * xhat, dim=0).to(gamma.dtype)
    dbeta = torch.sum(gyf, dim=0).to(gamma.dtype)
    wg = gyf * gf
    D = x2d.shape[1]
    dx = (wg - torch.mean(wg, dim=1, keepdim=True)
          - xhat * torch.mean(wg * xhat, dim=1, keepdim=True))
    dx = dx * rstd[:, None]
    # cotangents through the stats outputs:
    #   dmean/dx_j = 1/D;  drstd/dx_j = -rstd^3 * (x_j - mu) / D
    if gmean is not None:
        dx = dx + gmean.to(acc)[:, None] / D
    if grstd is not None:
        dx = dx - (grstd.to(acc) * rstd ** 3)[:, None] \
            * (xf - mean[:, None]) / D
    return dx.to(x2d.dtype), dgamma, dbeta


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        args = {"ptt_layer_norm_fwd": [p, p, p, p, p, p, i, i, f, p],
                "ptt_layer_norm_fwd_bf16": [p, p, p, p, p, p, i, i, f, i, p],
                "ptt_layer_norm_bf16_plan": [i, i, p]}[name]
        fn = _fns[name] = _build.bind(name, args)
    return fn


def bf16_path(x2d: torch.Tensor, y: torch.Tensor) -> str:
    """The path of bf16 rows x2d -> y: "v16" where D % 8 == 0,
    8 <= D <= MAX_D and both are 16-byte aligned, else "scalar" (any
    width).  csrc/layer_norm.cu refuses v16 where this is "scalar"
    (ptt_layer_norm_bf16_path, the same rule, which the bf16 block's C
    entry applies to its two layer norms)."""
    if x2d.dtype != torch.bfloat16:
        raise ValueError(f"layer_norm: bf16_path is for bf16 rows, got "
                         f"{x2d.dtype}")
    D = x2d.shape[-1]
    ok = D % 8 == 0 and 8 <= D <= MAX_D and x2d.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0
    return "v16" if ok else "scalar"


def bf16_plan(N: int, D: int, sms: int, ctas_per_sm: int) -> dict:
    """The v16 grid for N bf16 rows of width D on `sms` SMs that hold
    `ctas_per_sm` of its CTAs each, as csrc/layer_norm.cu's v16_plan makes
    it: `lanes` threads a row (a warp up to V16_WARP_MAX_D, the TMA form;
    a CTA of V16_ROW_THREADS above), `words_per_lane` 16-byte words a lane,
    `warps_per_cta` (the TMA form's consumers and its producer),
    `rows_per_cta` a CTA takes at a time (a block of V16_TMA_CONSUMERS
    rows, or one), and `ctas` = min(CTAs the rows need, sms x ctas_per_sm)
    persistent CTAs."""
    if N < 1 or D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"layer_norm: no v16 plan for N {N}, D {D}")
    tma = D <= V16_WARP_MAX_D
    lanes = 32 if tma else V16_ROW_THREADS
    rows = V16_TMA_CONSUMERS if tma else 1
    return dict(lanes=lanes, words_per_lane=-(-(D // 8) // lanes),
                warps_per_cta=V16_TMA_CONSUMERS + 1 if tma
                else V16_ROW_THREADS // 32,
                rows_per_cta=rows, ctas=min(-(-N // rows), sms * ctas_per_sm),
                sms=sms, ctas_per_sm=ctas_per_sm)


def bf16_rows(plan: dict, N: int, group: int) -> range:
    """The rows group `group` of a v16 plan takes, in order, where group
    r of CTA c is group c x rows_per_cta + r (the TMA form's consumer warp
    r, or the CTA itself): row r of the CTA's blocks of rows_per_cta rows
    c, c + ctas, ... (< N)."""
    rows = plan["rows_per_cta"]
    cta, r = divmod(group, rows)
    return range(cta * rows + r, N, plan["ctas"] * rows)


def bf16_words(plan: dict, D: int, lane: int) -> list:
    """The 16-byte words (8 columns each) of a row that lane `lane` of a v16
    group takes: lane, lane + lanes, ... < D / 8, at most words_per_lane."""
    return [w for w in range(lane, lane + plan["words_per_lane"]
                             * plan["lanes"], plan["lanes"]) if w < D // 8]


def bf16_plan_of_library(N: int, D: int) -> dict:
    """The v16 plan as the library makes it on the current card
    (ptt_layer_norm_bf16_plan), with bf16_plan's keys: for holding
    bf16_plan, which the CPU tests check, to the kernel's own."""
    out = (ctypes.c_int * 7)()
    err = _kernel("ptt_layer_norm_bf16_plan")(N, D, ctypes.addressof(out))
    if err:
        raise ValueError(f"layer_norm: no v16 plan for N {N}, D {D} (CUDA "
                         f"error {err})")
    keys = ("lanes", "words_per_lane", "warps_per_cta", "rows_per_cta",
            "ctas", "sms", "ctas_per_sm")
    return dict(zip(keys, out))


def _launch(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float, path=None):
    if not (x2d.is_cuda and gamma.is_cuda and beta.is_cuda):
        raise RuntimeError("layer_norm kernel: every tensor must lie on a "
                           "CUDA device")
    if x2d.ndim != 2 or x2d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layer_norm kernel: x must be 2-D f32 or bf16, "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    N, D = x2d.shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"layer_norm kernel: D={D} outside [1, {MAX_D}]")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (D,)
                or t.device != x2d.device):
            raise ValueError(f"layer_norm kernel: {name} must be f32 [{D}] "
                             f"on {x2d.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if not (x2d.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("layer_norm kernel: inputs must be contiguous")
    bf16 = x2d.dtype == torch.bfloat16
    if path is not None and (not bf16 or path not in BF16_PATHS):
        raise ValueError(f"layer_norm kernel: path {path!r}: bf16 rows take "
                         f"{BF16_PATHS}, f32 rows no path")
    y = torch.empty_like(x2d)
    mean = torch.empty(N, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(N, dtype=torch.float32, device=x2d.device)
    if N == 0:
        return y, mean, rstd
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    ptrs = (x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr())
    if bf16:
        own = bf16_path(x2d, y)
        if path == "v16" != own:
            raise ValueError(f"layer_norm kernel: the v16 path needs D % 8 "
                             f"== 0, 8 <= D <= {MAX_D} and 16-byte-aligned "
                             f"x and y (D {D}, x at {ptrs[0]:#x})")
        path = path or own
        err = _kernel("ptt_layer_norm_fwd_bf16")(
            *ptrs, N, D, float(eps), int(path == "v16"), stream)
    else:
        err = _kernel("ptt_layer_norm_fwd")(*ptrs, N, D, float(eps), stream)
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed"
                           f"{f' ({path} path)' if bf16 else ''}: CUDA error "
                           f"{err}")
    layer_norm.launches += 1
    if path == "v16":
        layer_norm.launches_v16 += 1
    elif bf16:
        layer_norm.launches_scalar += 1
    return y, mean, rstd


def layer_norm(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5, path=None):
    """Layer norm over the last axis of x2d [N, D] with gamma/beta [D]:
    returns (y [N, D] in x's dtype, mean [N] f32, rstd [N] f32).  `path`
    (bf16 rows on the card only): None, the operands' choice
    (``bf16_path``), or "v16" / "scalar" forced."""
    if x2d.device.type == "cuda":
        return _launch(x2d, gamma, beta, eps, path)
    return layer_norm_plain(x2d, gamma, beta, eps)


layer_norm.launches = 0
layer_norm.launches_v16 = 0
layer_norm.launches_scalar = 0


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        y, mean, rstd = layer_norm(x2d, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, gy, gmean, grstd):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x2d)
        dx, dgamma, dbeta = layer_norm_bwd_plain(x2d, gamma, mean, rstd, gy,
                                                 gmean, grstd)
        return dx, dgamma, dbeta, None


def layer_norm_train(x2d: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5):
    """``layer_norm`` with a backward: (y, mean, rstd), each
    differentiable."""
    return _LayerNorm.apply(x2d, gamma, beta, eps)

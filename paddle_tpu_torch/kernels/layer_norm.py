"""Row layer norm forward: the hand-written CUDA kernel and its plain
torch version.

Replaces the Pallas TPU kernel ``paddle_tpu/kernels/layer_norm.py:_ln_fwd``
(body ``_ln_kernel``), called there by ``fused_layer_norm``.  The kernel
source is ``csrc/layer_norm.cu``; its header says what bounds it on the
H100 (memory: x read once, y written once) and how the design keeps the
row in registers between the statistics and the output so x is read from
device memory once.

``layer_norm`` decides by the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU or meta tensor takes ``layer_norm_plain``.
``layer_norm.launches`` counts kernel launches.

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
_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = _build.bind("ptt_layer_norm_fwd",
                          [p, p, p, p, p, p, i, i, f, i, p])
    return _fn


def _launch(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float):
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
    y = torch.empty_like(x2d)
    mean = torch.empty(N, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(N, dtype=torch.float32, device=x2d.device)
    if N == 0:
        return y, mean, rstd
    err = _kernel()(x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), N, D,
                    float(eps), int(x2d.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x2d.device).cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    layer_norm.launches += 1
    return y, mean, rstd


def layer_norm(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5):
    """Layer norm over the last axis of x2d [N, D] with gamma/beta [D]:
    returns (y [N, D] in x's dtype, mean [N] f32, rstd [N] f32)."""
    if x2d.device.type == "cuda":
        return _launch(x2d, gamma, beta, eps)
    return layer_norm_plain(x2d, gamma, beta, eps)


layer_norm.launches = 0


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

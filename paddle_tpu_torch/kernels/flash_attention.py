"""Flash attention in the head-major layout, forward and backward: the
hand-written CUDA kernels and their plain torch versions.

Replaces the Pallas TPU kernels
``paddle_tpu/kernels/flash_attention.py:_flash_fwd_hdt`` (body
``_fwd_kernel_hdt``, entry ``flash_attention_hdt``) and ``_flash_bwd_hdt``
(bodies ``_bwd_fused1_kernel_hdt``, ``_bwd_fused_kernel_hdt``,
``_bwd_dkv_kernel_hdt`` and ``_bwd_dq_kernel_hdt``), called by the
``fused_mha`` op.  The kernel sources are ``csrc/flash_attention_hdt.cu``
and ``csrc/flash_attention_hdt_bwd.cu``; their headers say what bounds
them on the H100 (operations, on the f32 CUDA cores) and how each design
stages tiles in shared memory, stops at the causal diagonal and at
``kv_len``, and masks ragged tiles itself, so the caller pads nothing
(the JAX entry needs 128-token granules).

``flash_attention_hdt`` is differentiable (a ``torch.autograd.Function``):
its forward saves (q, k, v, o, lse); its backward takes
``delta = rowsum(do * o)`` in f32 in torch, as the JAX package does
(flash_attention.py:763), and calls ``flash_attention_hdt_bwd``.  Both
entries decide by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU or meta tensors take the ``_plain`` version.
``flash_attention_hdt.launches`` and ``flash_attention_hdt_bwd.launches``
count kernel launches.  The card kernels take f32 inputs with d in
{64, 128} and dv == d; bf16 comes with the mixed-precision work.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
_fn = None
_bwd_fn = None


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


def flash_attention_hdt_plain(q, k, v, batch, causal=False, scale=None,
                              kv_len=None):
    """(o [H, dv, B*Tq], lse [H, 1, B*Tq] f32): a full-softmax composition
    in f32 (f64 for f64 inputs) of what the kernel computes."""
    H, d, _ = q.shape
    dv = v.shape[1]
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q4, k4, v4, s = _scores(q, k, v, batch, causal, scale, kv_len, Tq, Tk)
    lse = torch.logsumexp(s, dim=-1)                      # [B, H, Tq]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,hdbk->hdbq", p, v4).reshape(H, dv, batch * Tq)
    lse = lse.permute(1, 0, 2).reshape(H, 1, batch * Tq)
    return o.to(q.dtype), lse


def _kernel():
    global _fn
    if _fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        _fn = _build.bind("ptt_flash_fwd_hdt",
                          [p, p, p, p, p, i, i, i, i, i, i, i, f,
                           ll, ll, ll, ll, ll, ll, ll, ll, ll, p])
    return _fn


def _launch(q, k, v, batch, causal, scale, kv_len):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise RuntimeError("flash_attention_hdt kernel: every tensor must "
                           "lie on a CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_hdt kernel: q, k, v on different "
                         "devices")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise ValueError(f"flash_attention_hdt kernel: f32 inputs only, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    H, d, Nq = q.shape
    if d not in KERNEL_HEAD_DIMS or v.shape[1] != d:
        raise ValueError(f"flash_attention_hdt kernel: head dims d={d}, "
                         f"dv={v.shape[1]}; the kernel takes d == dv in "
                         f"{KERNEL_HEAD_DIMS}")
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    o = torch.empty(H, d, Nq, dtype=torch.float32, device=q.device)
    lse = torch.empty(H, 1, Nq, dtype=torch.float32, device=q.device)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), H, d, batch, Tq, Tk,
                    Tk if kv_len is None else int(kv_len), int(causal),
                    float(scale), *q.stride(), *k.stride(), *v.stride(),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_hdt kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_hdt.launches += 1
    return o, lse


def _forward(q, k, v, batch, causal, scale, kv_len):
    if q.device.type == "cuda":
        return _launch(q, k, v, batch, causal, scale, kv_len)
    return flash_attention_hdt_plain(q, k, v, batch, causal, scale, kv_len)


def flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, batch,
                                  causal=False, scale=None, kv_len=None):
    """(dq, dk, dv) from the forward's inputs, its lse [H, 1, B*Tq], delta
    = rowsum(do * o) [H, 1, B*Tq] and do [H, dv, B*Tq]: the full-matrix
    composition of the FlashAttention-2 backward that the kernel tiles
    (p = exp(s - lse), ds = p * (do.v - delta))."""
    H, d, _ = q.shape
    dv = v.shape[1]
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q4, k4, v4, s = _scores(q, k, v, batch, causal, scale, kv_len, Tq, Tk)
    acc = s.dtype

    def rows(t):                             # [H, 1, B*Tq] -> [B, H, Tq, 1]
        return t.to(acc).reshape(H, batch, Tq).permute(1, 0, 2)[..., None]

    p = torch.exp(s - rows(lse))
    do4 = do.to(acc).reshape(H, dv, batch, Tq)
    dp = torch.einsum("hdbq,hdbk->bhqk", do4, v4)
    ds = p * (dp - rows(delta))
    dq = scale * torch.einsum("bhqk,hdbk->hdbq", ds, k4)
    dk = torch.einsum("bhqk,hdbq->hdbk", ds, q4)
    dvv = torch.einsum("bhqk,hdbq->hdbk", p, do4)
    return (dq.reshape(H, d, batch * Tq).to(q.dtype),
            dk.reshape(H, d, batch * Tk).to(k.dtype),
            dvv.reshape(H, dv, batch * Tk).to(v.dtype))


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        _bwd_fn = _build.bind("ptt_flash_bwd_hdt",
                              [p] * 9 + [i] * 7 + [f] + [ll] * 12 + [p])
    return _bwd_fn


def _launch_bwd(q, k, v, lse, delta, do, batch, causal, scale, kv_len):
    ts = (q, k, v, lse, delta, do)
    if not all(t.is_cuda for t in ts):
        raise RuntimeError("flash_attention_hdt_bwd kernel: every tensor "
                           "must lie on a CUDA device")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention_hdt_bwd kernel: inputs on "
                         "different devices")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"flash_attention_hdt_bwd kernel: f32 inputs "
                         f"only, got {[str(t.dtype) for t in ts]}")
    H, d, Nq = q.shape
    if d not in KERNEL_HEAD_DIMS or v.shape[1] != d:
        raise ValueError(f"flash_attention_hdt_bwd kernel: head dims d={d}, "
                         f"dv={v.shape[1]}; the kernel takes d == dv in "
                         f"{KERNEL_HEAD_DIMS}")
    if tuple(do.shape) != (H, d, Nq):
        raise ValueError(f"flash_attention_hdt_bwd kernel: do "
                         f"{tuple(do.shape)} != {(H, d, Nq)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (H, 1, Nq) or not t.is_contiguous():
            raise ValueError(f"flash_attention_hdt_bwd kernel: {name} must "
                             f"be contiguous {(H, 1, Nq)}, got "
                             f"{tuple(t.shape)}")
    Tq, Tk = _check(q, k, v, batch, causal, kv_len)
    dq = torch.empty(H, d, Nq, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dvv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvv.data_ptr(), H, d, batch, Tq, Tk,
        Tk if kv_len is None else int(kv_len), int(causal), float(scale),
        *q.stride(), *k.stride(), *v.stride(), *do.stride(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_hdt_bwd kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_hdt_bwd.launches += 1
    return dq, dk, dvv


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

"""Fused pre-norm transformer block: the hand-written CUDA forward and its
plain torch version (counterpart of paddle_tpu/kernels/fused_block.py).

Replaces the Pallas TPU kernel ``paddle_tpu/kernels/fused_block.py:
_block_fwd_pallas`` (body ``_block_kernel``), entry ``transformer_block``,
called by the ``fused_transformer_block`` op.  The kernel source is
``csrc/fused_block.cu``; its header says what bounds it on the H100
(operations: every product runs on the TF32 tensor cores in three passes,
the projections on ``csrc/gemm_tc.cuh``'s tile loop) and why its design is
a chain of nine launches (the weights split into 3xTF32 operand pairs,
LN1, one q/k/v GEMM, the flash forward through strides, o split, Wo plus
residual, LN2, W1 plus relu, W2 plus residual) instead of the Pallas
kernel's VMEM-resident block: no SM holds the weights, and the Pallas
kernel's per-(query, key)-block recompute of LN1 and the K/V projections
buys nothing here.

``block_reference`` is the composition the kernel must match and the
source of its gradients, as in the JAX package: LN in f32, the projections
as ``torch.matmul`` (they are ``dot_general``s outside any Pallas kernel
there), and attention through ``flash_attention`` (the ``[B, H, T, d]``
kernels) with ``use_flash``.  ``transformer_block_plain`` is that
composition with plain attention: the plain version of the kernel.

``transformer_block`` is a ``torch.autograd.Function``.  Its forward
launches the kernel for CUDA tensors (or raises) and runs the plain version
for CPU and meta tensors; it saves only (x, params).  Its backward
recomputes ``block_reference(use_flash=x.is_cuda)`` from them and returns
``torch.autograd.grad`` for x and all 12 params, as the JAX custom VJP does
(fused_block.py:272-282): gradients are exact for the reference math, and
on the card its attention runs on the flash kernels.
``transformer_block.launches`` counts kernel forwards (one per call,
nine device launches inside).  The card kernel takes f32 with
head dim 64 or 128; its workspace (the weights' pairs and the chain's
intermediates, 505 MiB at B 32, T 512, D = E 512, F 2048) lives for one
call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import KERNEL_HEAD_DIMS, NEG_INF, flash_attention
from .layer_norm import MAX_D

PARAM_NAMES = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "ln2_scale",
               "ln2_bias", "w1", "b1", "w2", "b2")
_fns = {}


def _ln_affine(x, g, b, eps):
    """Layer norm over the last axis with affine params, f32 statistics
    (f64 for f64 input): JAX's ``_ln_affine``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g.to(acc) + b.to(acc)


def _mlp_hidden(f, w1, b1):
    """The block's MLP hidden layer, relu(f W1 + b1)."""
    return torch.relu(torch.matmul(f, w1) + b1)


def block_reference(x, p, n_head, causal, eps1=1e-5, eps2=1e-5,
                    use_flash=False):
    """x [B, T, D] through one pre-norm block with params p (PARAM_NAMES
    order): LN1 -> q/k/v -> attention -> Wo + x -> LN2 -> relu MLP ->
    + residual.  ``use_flash`` routes the attention through
    ``flash_attention`` (on the card, its kernels)."""
    ln1g, ln1b, wq, wk, wv, wo, ln2g, ln2b, w1, b1, w2, b2 = p
    cd = x.dtype
    B, T, _ = x.shape
    E = wq.shape[1]
    dh = E // n_head

    def split(t):                    # [B, T, E] -> a [B, H, T, dh] view
        return t.reshape(B, T, n_head, dh).transpose(1, 2)

    a = _ln_affine(x, ln1g, ln1b, eps1).to(cd)
    q, k, v = (split(torch.matmul(a, w)) for w in (wq, wk, wv))
    if use_flash:
        o = flash_attention(q, k, v, causal=causal)
    else:
        s = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
        if causal:
            keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            s = s.masked_fill(~keep, NEG_INF)
        acc = torch.promote_types(cd, torch.float32)
        o = torch.matmul(torch.softmax(s.to(acc), dim=-1).to(cd), v)
    o = o.transpose(1, 2).reshape(B, T, E)
    h = x + torch.matmul(o, wo)
    f = _ln_affine(h, ln2g, ln2b, eps2).to(cd)
    y = torch.matmul(_mlp_hidden(f, w1, b1), w2) + b2
    return h + y


def transformer_block_plain(x, params, n_head, causal=False, eps1=1e-5,
                            eps2=1e-5):
    """The plain version of the block kernel: ``block_reference`` with
    plain attention."""
    return block_reference(x, tuple(params), n_head, causal, eps1, eps2)


def _kernel(name="ptt_transformer_block_fwd"):
    """The C entry of the block forward, or its workspace size."""
    if name not in _fns:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "ptt_transformer_block_fwd":
            _fns[name] = _build.bind(name, [p] * 15 + [i] * 7 + [f, f, p])
        else:
            _fns[name] = _build.bind(name, [i] * 6, ctypes.c_longlong)
    return _fns[name]


def _launch(x, params, n_head, causal, eps1, eps2):
    ts = (x,) + tuple(params)
    if not all(t.is_cuda for t in ts):
        raise RuntimeError("transformer_block kernel: every tensor must lie "
                           "on a CUDA device")
    if len({t.device for t in ts}) != 1:
        raise ValueError("transformer_block kernel: inputs on different "
                         "devices")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"transformer_block kernel: f32 inputs only, got "
                         f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("transformer_block kernel: inputs must be "
                         "contiguous")
    if x.ndim != 3:
        raise ValueError(f"transformer_block kernel: x must be [B, T, D], "
                         f"got {tuple(x.shape)}")
    B, T, D = x.shape
    E, F = params[2].shape[1], params[8].shape[1]
    want = ((D,), (D,), (D, E), (D, E), (D, E), (E, D), (D,), (D,), (D, F),
            (F,), (F, D), (D,))
    got = tuple(tuple(t.shape) for t in params)
    if got != want:
        raise ValueError(f"transformer_block kernel: param shapes {got} != "
                         f"{want} ({', '.join(PARAM_NAMES)})")
    if E % n_head or E // n_head not in KERNEL_HEAD_DIMS:
        raise ValueError(f"transformer_block kernel: head dim {E}/{n_head}; "
                         f"the kernel takes {KERNEL_HEAD_DIMS}")
    if D > MAX_D:
        raise ValueError(f"transformer_block kernel: D={D} > {MAX_D}")
    out = torch.empty_like(x)
    nbytes = _kernel("ptt_transformer_block_fwd_workspace")(B, T, D, E, F,
                                                             n_head)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    err = _kernel()(*(t.data_ptr() for t in ts), out.data_ptr(),
                    work.data_ptr(), B, T, D, E, F, n_head, int(causal),
                    float(eps1), float(eps2),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"transformer_block kernel launch failed: CUDA "
                           f"error {err}")
    transformer_block.launches += 1
    return out


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_head, causal, eps1, eps2, *params):
        if x.device.type == "cuda":
            out = _launch(x, params, n_head, causal, eps1, eps2)
        else:
            out = transformer_block_plain(x, params, n_head, causal, eps1,
                                          eps2)
        ctx.save_for_backward(x, *params)
        ctx.args = (n_head, causal, eps1, eps2)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, *params)]
            out = block_reference(ins[0], ins[1:], *ctx.args,
                                  use_flash=x.is_cuda)
            grads = torch.autograd.grad(out, ins, g.to(x.dtype))
        return (grads[0], None, None, None, None, *grads[1:])


def transformer_block(x, params, n_head, causal: bool = False,
                      eps1: float = 1e-5, eps2: float = 1e-5):
    """One fused pre-norm transformer block.

    x [B, T, D]; params = (ln1_scale, ln1_bias, wq, wk, wv, wo, ln2_scale,
    ln2_bias, w1, b1, w2, b2) with wq/wk/wv [D, E], wo [E, D], w1 [D, F],
    w2 [F, D].  Any T (ragged tiles are masked in the kernel).
    Differentiable in x and every param.
    """
    return _Block.apply(x, int(n_head), bool(causal), float(eps1),
                        float(eps2), *params)


transformer_block.launches = 0

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

Under FLAGS_amp_bf16 the op hands the block bf16 x and matrices (f32
layer-norm params and biases).  Those go to the bf16 block kernel,
``csrc/fused_block_bf16.cu`` (wrapper ``transformer_block_bf16``, its own
``.launches``): seven launches (LN1, one q/k/v GEMM whose epilogue scales
q, the bf16 flash forward through ``[B, T, H, d]`` strides at scale 1,
Wo plus x, LN2, W1 plus b1 and relu, W2 plus b2 and h), rounding where
``_block_kernel`` rounds.  Its four GEMMs take one of two paths, chosen
here before the launch (``block_gemm_path``): "wgmma", a persistent
TMA-fed ``wgmma`` kernel on ``csrc/wgmma_bf16.cuh``'s pieces with two
consumer warpgroups taking alternate 128 x 128 tiles, where TMA and
16-byte accesses can describe every operand (16-byte-aligned x, out,
matrices and workspace; D, E and F multiples of 8); "sync",
``csrc/gemm_bf16.cuh``'s ``mma.sync`` loop, for the rest.  The wgmma
schedule is mirrored here (``block_gemm_plan``, ``block_gemm_tiles``) and
exported by the library (``block_gemm_plan_of_library``).

``block_reference`` is the composition the kernel must match and the
source of its gradients, as in the JAX package, with its casts
(fused_block.py:78-114): LN in f32 with the result in x's dtype, every
projection an f32 product of the operands (``_mm_f32``, JAX's
``preferred_element_type=f32``) rounded once, at q, k and v, at h = x +
o Wo, at u = relu(f W1 + b1) and at out = h + (u W2 + b2); softmax in f32
with its weights in x's dtype.  In f32 the casts are no-ops.  The
projections are not the kernel's work (they are ``dot_general``s outside
any Pallas kernel in JAX): on the card a bf16 projection runs on the bf16
tensor cores with an f32 result (``torch.mm(..., out_dtype=float32)``,
``_MmF32``), elsewhere as the f32 product of the upcast operands, which
is exact per product.  Attention goes through ``flash_attention`` (the
``[B, H, T, d]`` kernels) with ``use_flash``.  ``transformer_block_plain``
is that composition with plain attention: the plain version of both
kernels, and the op's CPU path.

``transformer_block`` is a ``torch.autograd.Function``.  Its forward
launches the kernel of x's dtype for CUDA tensors (or raises) and runs the
plain version for CPU and meta tensors; it saves only (x, params).  Its
backward recomputes ``block_reference(use_flash=x.is_cuda)`` from them and
returns ``torch.autograd.grad`` for x and all 12 params, as the JAX custom
VJP does (fused_block.py:272-282): gradients are exact for the reference
math, and on the card its attention runs on the flash kernels.
``transformer_block.launches`` counts f32 kernel forwards (one per call,
nine device launches inside), ``transformer_block_bf16.launches`` bf16 ones
(seven inside).  The card kernels take head dim 64 or 128; their workspace
(505 MiB in f32, 161 MiB in bf16 at B 32, T 512, D = E 512, F 2048) lives
for one call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._wgmma import WG_KTILE, WG_TILE
from .flash_attention import (KERNEL_HEAD_DIMS, NEG_INF, flash_attention,
                              fwd_path)
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


class _MmF32(torch.autograd.Function):
    """a [..., K] . b [K, N] of bf16 CUDA operands on the bf16 tensor cores
    with f32 accumulation and an f32 result.  The backward rounds the
    cotangent to bf16, which is exact where it flows from a bf16 cast
    (every site of block_reference), and returns bf16(g b^T) and
    bf16(a^T g), the products of JAX's transpose rule rounded once."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        a2 = a.reshape(-1, a.shape[-1])
        return torch.mm(a2, b, out_dtype=torch.float32).reshape(
            *a.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(a.dtype)
        da = torch.mm(g2, b.t()).reshape(a.shape)
        db = torch.mm(a.reshape(-1, a.shape[-1]).t(), g2)
        return da, db


def _mm_f32(a, b):
    """a [..., K] . b [K, N] with f32 accumulation and an f32 result (f64
    for f64): dot_general with preferred_element_type=f32.  bf16 on the
    card: the bf16 tensor cores (_MmF32); elsewhere the f32 product of
    the upcast operands, exact per product."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return _MmF32.apply(a, b)
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.matmul(a.to(acc), b.to(acc))


def _mlp_pre(f, w1, b1):
    """The block's MLP pre-activation f W1 + b1, in f32 (f64 for f64)."""
    return _mm_f32(f, w1) + b1.to(torch.promote_types(f.dtype,
                                                      torch.float32))


def _mlp_hidden(f, w1, b1):
    """The block's MLP hidden layer relu(f W1 + b1), in f32 (f64 for
    f64); the caller rounds it to f's dtype."""
    return torch.relu(_mlp_pre(f, w1, b1))


def block_reference(x, p, n_head, causal, eps1=1e-5, eps2=1e-5,
                    use_flash=False):
    """x [B, T, D] through one pre-norm block with params p (PARAM_NAMES
    order): LN1 -> q/k/v -> attention -> Wo + x -> LN2 -> relu MLP ->
    + residual, with JAX's casts to x's dtype (fused_block.py:78-114).
    ``use_flash`` routes the attention through ``flash_attention`` (on the
    card, its kernels)."""
    ln1g, ln1b, wq, wk, wv, wo, ln2g, ln2b, w1, b1, w2, b2 = p
    cd = x.dtype
    acc = torch.promote_types(cd, torch.float32)
    B, T, _ = x.shape
    E = wq.shape[1]
    dh = E // n_head

    def split(t):                    # [B, T, E] -> a [B, H, T, dh] view
        return t.reshape(B, T, n_head, dh).transpose(1, 2)

    a = _ln_affine(x, ln1g, ln1b, eps1).to(cd)
    q, k, v = (split(_mm_f32(a, w).to(cd)) for w in (wq, wk, wv))
    if use_flash:
        o = flash_attention(q, k, v, causal=causal)
    else:
        s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) \
            * dh ** -0.5
        if causal:
            keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            s = s.masked_fill(~keep, NEG_INF)
        w_att = torch.softmax(s, dim=-1).to(cd)
        o = torch.matmul(w_att.to(acc), v.to(acc)).to(cd)
    o = o.transpose(1, 2).reshape(B, T, E)
    h = (x.to(acc) + _mm_f32(o, wo)).to(cd)
    f = _ln_affine(h, ln2g, ln2b, eps2).to(cd)
    u = _mlp_hidden(f, w1, b1).to(cd)
    y = _mm_f32(u, w2) + b2.to(acc)
    return (h.to(acc) + y).to(cd)


def transformer_block_plain(x, params, n_head, causal=False, eps1=1e-5,
                            eps2=1e-5):
    """The plain version of the block kernels, f32 and bf16:
    ``block_reference`` with plain attention."""
    return block_reference(x, tuple(params), n_head, causal, eps1, eps2)


# the params the bf16 kernel takes in f32: the layer norms' and the biases
VECTORS = (0, 1, 6, 7, 9, 11)


def _kernel(name="ptt_transformer_block_fwd"):
    """A C entry of a block forward (f32 or bf16), its workspace size, or
    the bf16 wgmma path's plan of one product."""
    if name not in _fns:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name.endswith("_workspace"):
            _fns[name] = _build.bind(name, [i] * 6, ctypes.c_longlong)
        elif name.endswith("_plan"):
            _fns[name] = _build.bind(name, [i] * 4 + [p])
        else:   # the bf16 entry takes its flash launch's and GEMMs' paths
            paths = [i, i] if "_bf16" in name else []
            _fns[name] = _build.bind(name, [p] * 15 + [i] * 7 + [f, f]
                                     + paths + [p])
    return _fns[name]


def _align256(n):
    return -(-n // 256) * 256


def flash_path_in_block(work_ptr, B, T, D, E, H):
    """The path of the bf16 block kernel's flash launch (step 3 of
    csrc/fused_block_bf16.cu): flash_attention.fwd_path of q, k and v, the
    [B, T, H, E/H] views of qkv [N, 3E], and o, the same view of [N, E],
    where that source's work() puts them in the workspace at work_ptr (a
    [N, D] bf16, then qkv, then o, each region 256-byte aligned)."""
    N, dh = B * T, E // H
    qkv = work_ptr + _align256(2 * N * D)
    o = qkv + _align256(2 * N * 3 * E)

    def view(ptr, ld):
        return ptr, (T * ld, dh, 1, ld), (B, H, dh, T)

    return fwd_path([view(qkv, 3 * E), view(qkv + 2 * E, 3 * E),
                     view(qkv + 4 * E, 3 * E), view(o, E)], dh)


def block_gemm_path(ptrs, D, E, F):
    """The path of the bf16 block's four GEMMs, given the addresses of x,
    the six matrices (wq, wk, wv, wo, w1, w2), out and the workspace:
    "wgmma" where TMA and the 16-byte epilogue can describe every operand
    (each address 16-byte aligned, D, E and F multiples of 8, so that every
    row of every operand and workspace region is too), else "sync" (the
    mma.sync loop, any shape).  csrc/fused_block_bf16.cu refuses wgmma
    where this is "sync"."""
    aligned = all(p % 16 == 0 for p in ptrs) and D % 8 == 0 \
        and E % 8 == 0 and F % 8 == 0
    return "wgmma" if aligned else "sync"


def block_gemm_launches(B, T, D, E, F):
    """The bf16 block's four products as (rows M, columns N of each
    weight, depth K, weights): q/k/v, Wo, W1, W2."""
    N = B * T
    return {"qkv": (N, E, D, 3), "wo": (N, D, E, 1), "w1": (N, F, D, 1),
            "w2": (N, D, F, 1)}


def block_gemm_plan(M, N, K, weights, sms):
    """The wgmma path's schedule of one product, A [M, K] . `weights`
    weights [K, N], on `sms` SMs, as csrc/fused_block_bf16.cu's
    blk_wg::plan makes it: 128 x 128 tiles, row tiles x weights x column
    tiles of a weight, over min(sms, tiles) persistent CTAs; k-tiles of
    64."""
    mt, nt = -(-M // WG_TILE), -(-N // WG_TILE)
    tiles = mt * weights * nt
    return dict(m_tiles=mt, n_tiles=nt, weights=weights, tiles=tiles,
                ctas=min(sms, tiles), k_tiles=-(-K // WG_KTILE))


def block_gemm_tiles(plan, cta):
    """The tiles CTA `cta` takes, in order, as (row tile, weight, column
    tile of that weight): flat tiles cta, cta + ctas, ..., the columns
    fastest, then the weight, then the rows (the kernel's tile_of)."""
    nt = plan["n_tiles"]
    per_m = plan["weights"] * nt
    return [(t // per_m, t % per_m // nt, t % nt)
            for t in range(cta, plan["tiles"], plan["ctas"])]


def block_gemm_plan_of_library(M, N, K, weights):
    """The wgmma path's plan of one product as the library makes it on the
    current card (ptt_block_gemm_bf16_wgmma_plan), with block_gemm_plan's
    keys: for holding block_gemm_plan, which the CPU tests check, to the
    kernel's own."""
    out = (ctypes.c_int * 6)()
    err = _kernel("ptt_block_gemm_bf16_wgmma_plan")(
        M, N, K, weights, ctypes.addressof(out))
    if err:
        raise ValueError(f"transformer_block_bf16: no wgmma plan for M {M}, "
                         f"N {N}, K {K}, {weights} weights (CUDA error "
                         f"{err})")
    keys = ("m_tiles", "n_tiles", "weights", "tiles", "ctas", "k_tiles")
    return dict(zip(keys, out))


def _launch(x, params, n_head, causal, eps1, eps2, gemm_path=None):
    """The block kernel of x's dtype: f32 throughout, or bf16 x and
    matrices with f32 vectors (bf16 vectors are widened, which is exact)."""
    bf16 = x.dtype == torch.bfloat16
    name = "transformer_block" + ("_bf16" if bf16 else "")
    ts = (x,) + tuple(params)
    if not all(t.is_cuda for t in ts):
        raise RuntimeError(f"{name} kernel: every tensor must lie on a CUDA "
                           f"device")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name} kernel: inputs on different devices")
    if bf16:
        params = tuple(t.float() if i in VECTORS else t
                       for i, t in enumerate(params))
        want = [torch.float32 if i in VECTORS else torch.bfloat16
                for i in range(len(params))]
        if [t.dtype for t in params] != want:
            raise ValueError(f"{name} kernel: bf16 x and matrices, f32 or "
                             f"bf16 vectors only, got "
                             f"{[str(t.dtype) for t in ts]}")
        ts = (x,) + params
    elif not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"{name} kernel: f32 inputs, or bf16 x and "
                         f"matrices, only, got {[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    if x.ndim != 3:
        raise ValueError(f"transformer_block kernel: x must be [B, T, D], "
                         f"got {tuple(x.shape)}")
    B, T, D = x.shape
    E, F = params[2].shape[1], params[8].shape[1]
    want = ((D,), (D,), (D, E), (D, E), (D, E), (E, D), (D,), (D,), (D, F),
            (F,), (F, D), (D,))
    got = tuple(tuple(t.shape) for t in params)
    if got != want:
        raise ValueError(f"{name} kernel: param shapes {got} != {want} "
                         f"({', '.join(PARAM_NAMES)})")
    if E % n_head or E // n_head not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel: head dim {E}/{n_head}; the kernel "
                         f"takes {KERNEL_HEAD_DIMS}")
    if D > MAX_D:
        raise ValueError(f"{name} kernel: D={D} > {MAX_D}")
    entry = "ptt_transformer_block_bf16_fwd" if bf16 \
        else "ptt_transformer_block_fwd"
    out = torch.empty_like(x)
    nbytes = _kernel(entry + "_workspace")(B, T, D, E, F, n_head)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    extra = ()
    if bf16:
        path = flash_path_in_block(work.data_ptr(), B, T, D, E, n_head)
        ptrs = [t.data_ptr() for t in (x,) + params[2:6] + params[8:11:2]]
        own = block_gemm_path(ptrs + [out.data_ptr(), work.data_ptr()], D,
                              E, F)
        if gemm_path not in (None, "sync", "wgmma"):
            raise ValueError(f"{name} kernel: no GEMM path {gemm_path!r}")
        if gemm_path == "wgmma" != own:
            raise ValueError(f"{name} kernel: the wgmma GEMM path needs "
                             f"16-byte-aligned x and matrices and D, E, F "
                             f"multiples of 8 (D {D}, E {E}, F {F})")
        gemm_path = gemm_path or own
        extra = (int(path == "wgmma"), int(gemm_path == "wgmma"))
    err = _kernel(entry)(*(t.data_ptr() for t in ts), out.data_ptr(),
                         work.data_ptr(), B, T, D, E, F, n_head, int(causal),
                         float(eps1), float(eps2), *extra,
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if bf16:
        transformer_block_bf16.launches += 1
        for attr in ("launches_flash_" + path, "launches_gemm_" + gemm_path):
            setattr(transformer_block_bf16, attr,
                    getattr(transformer_block_bf16, attr) + 1)
    else:
        transformer_block.launches += 1
    return out


def transformer_block_bf16(x, params, n_head, causal=False, eps1=1e-5,
                           eps2=1e-5, gemm_path=None):
    """The bf16 block kernel (csrc/fused_block_bf16.cu) on bf16 CUDA x and
    matrices, f32 (or bf16) vectors: out bf16.  Its launches (one per call,
    seven kernels) are counted in ``transformer_block_bf16.launches``; by
    the path of its flash launch (``flash_path_in_block``) in
    ``.launches_flash_wgmma`` and ``.launches_flash_sync``; by the path of
    its four GEMMs (``block_gemm_path``, or `gemm_path`: "sync" runs on
    any operands, "wgmma" raises before any launch where TMA cannot
    describe them) in ``.launches_gemm_wgmma`` and ``.launches_gemm_sync``.
    """
    if x.dtype != torch.bfloat16:
        raise ValueError(f"transformer_block_bf16 kernel: bf16 x only, got "
                         f"{x.dtype}")
    return _launch(x, tuple(params), int(n_head), bool(causal), float(eps1),
                   float(eps2), gemm_path)


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
transformer_block_bf16.launches = 0
transformer_block_bf16.launches_flash_wgmma = 0
transformer_block_bf16.launches_flash_sync = 0
transformer_block_bf16.launches_gemm_wgmma = 0
transformer_block_bf16.launches_gemm_sync = 0

"""Per-op compile-time shape/dtype inference rules.

Counterpart of paddle_tpu/analysis/infer_rules.py, for the ops the port
registers: ``mul``, ``matmul``, ``lookup_table``, the sparse plane's
``sparse_embedding_lookup`` and ``sparse_scatter_update`` (:141-187),
``autodiff``, ``fused_transformer_block`` and the frozen programs'
``quantized_matmul`` and ``quantized_conv2d`` (:234-262).  The rules
register alongside the OpDef via
framework/registry.py ``register_shape_infer``.  Only the op families
whose mismatch diagnostics matter get explicit rules; everything else is
covered by the meta evaluation in shape_inference.py (the op's own
lowering on ``meta`` tensors, the layer_helper build-time trick), and
ops where neither applies degrade to "unknown shape".  The JAX package's
rules for the collective and pipeline ops come with those ops.

Rule contract: ``rule(op, ins, attrs) -> {slot: [(shape, dtype)]}``
with shape a tuple (-1 = dynamic) or None, dtype a canonical string or
None; raise InferError on a provable mismatch; return None to defer to
the generic fallback.
"""
from __future__ import annotations

import numpy as np

from ..framework.registry import register_shape_infer


class InferError(Exception):
    """A provable compile-time shape/dtype mismatch."""


def _fmt(shape):
    return "?" if shape is None else list(shape)


def _prod_known(dims):
    """Product of dims; None when any dim is dynamic (-1)."""
    p = 1
    for d in dims:
        if d == -1:
            return None
        p *= int(d)
    return p


def _dims_conflict(a, b) -> bool:
    """Two dims provably differ (dynamic -1 matches anything)."""
    return a != -1 and b != -1 and int(a) != int(b)


def _first(ins, slot):
    vs = ins.get(slot) or [(None, None)]
    return vs[0]


# --- matmul family --------------------------------------------------------

@register_shape_infer("mul")
def _infer_mul(op, ins, attrs):
    (xs, xd) = _first(ins, "X")
    (ws, wd) = _first(ins, "Y")
    nc = int(attrs.get("x_num_col_dims", 1))
    if ws is not None and len(ws) != 2:
        raise InferError(
            f"mul weight {op.inputs.get('Y', ['?'])[0]!r} must be 2-D, "
            f"got {_fmt(ws)}")
    if xs is None or ws is None:
        out = None
        if xs is not None:
            out = tuple(xs[:nc]) + (-1,)
        return {"Out": [(out, xd)]}
    k = _prod_known(xs[nc:])
    if k is not None and _dims_conflict(k, ws[0]):
        raise InferError(
            f"mul contraction mismatch: X {op.inputs['X'][0]!r} "
            f"{_fmt(xs)} flattens to [.., {k}] at x_num_col_dims={nc} "
            f"but W {op.inputs['Y'][0]!r} is {_fmt(ws)} "
            f"(expects leading dim {k})")
    return {"Out": [(tuple(xs[:nc]) + (ws[1],), xd)]}


@register_shape_infer("matmul")
def _infer_matmul(op, ins, attrs):
    (xs, xd) = _first(ins, "X")
    (ys, yd) = _first(ins, "Y")
    if xs is None or ys is None or len(xs) < 1 or len(ys) < 1:
        return {"Out": [(None, xd or yd)]}
    tx = bool(attrs.get("transpose_X", False))
    ty = bool(attrs.get("transpose_Y", False))
    if len(xs) == 1 or len(ys) == 1:
        return None                 # vector cases: defer to generic
    xk = xs[-2] if tx else xs[-1]
    xm = xs[-1] if tx else xs[-2]
    yk = ys[-1] if ty else ys[-2]
    yn = ys[-2] if ty else ys[-1]
    if _dims_conflict(xk, yk):
        raise InferError(
            f"matmul contraction mismatch: X {op.inputs['X'][0]!r} "
            f"{_fmt(xs)} (contract dim {xk}) vs Y "
            f"{op.inputs['Y'][0]!r} {_fmt(ys)} (contract dim {yk})"
            + (" with transpose attrs" if (tx or ty) else ""))
    batch_x, batch_y = xs[:-2], ys[:-2]
    for a, b in zip(reversed(batch_x), reversed(batch_y)):
        if _dims_conflict(a, b) and 1 not in (a, b):
            raise InferError(
                f"matmul batch dims incompatible: {_fmt(xs)} vs "
                f"{_fmt(ys)}")
    # numpy-style broadcast, aligned from the right: size-1 dims defer
    # to the other side, dynamic (-1) defers to a concrete non-1 dim
    batch = []
    for i in range(max(len(batch_x), len(batch_y))):
        a = batch_x[-1 - i] if i < len(batch_x) else 1
        b = batch_y[-1 - i] if i < len(batch_y) else 1
        if a == b:
            batch.append(a)
        elif a == 1:
            batch.append(b)
        elif b == 1:
            batch.append(a)
        else:                   # one side is -1 (conflicts raised above)
            batch.append(a if b == -1 else b)
    batch.reverse()
    return {"Out": [(tuple(batch) + (xm, yn), xd or yd)]}


@register_shape_infer("lookup_table")
def _infer_lookup_table(op, ins, attrs):
    (ids, idt) = _first(ins, "Ids")
    (ws, wd) = _first(ins, "W")
    if idt is not None and not np.issubdtype(np.dtype(idt), np.integer):
        raise InferError(
            f"lookup_table ids {op.inputs['Ids'][0]!r} must be integer, "
            f"got {idt}")
    if ws is not None and len(ws) != 2:
        raise InferError(
            f"lookup_table table {op.inputs['W'][0]!r} must be 2-D "
            f"[vocab, dim], got {_fmt(ws)}")
    if ids is None or ws is None:
        return {"Out": [(None, wd)]}
    base = ids[:-1] if (len(ids) >= 2 and ids[-1] == 1) else ids
    return {"Out": [(tuple(base) + (ws[1],), wd)]}


# --- sparse plane (sparse/; ops/nn_ops.py) -------------------------------

@register_shape_infer("sparse_embedding_lookup")
def _infer_sparse_embedding_lookup(op, ins, attrs):
    """lookup_table's contract plus hash bucketing: ids may exceed the
    vocab when hash_bucket is on, so only type/rank are checkable."""
    (ids, idt) = _first(ins, "Ids")
    (ws, wd) = _first(ins, "W")
    if idt is not None and not np.issubdtype(np.dtype(idt), np.integer):
        raise InferError(
            f"sparse_embedding_lookup ids {op.inputs['Ids'][0]!r} must "
            f"be integer, got {idt}")
    if ws is not None and len(ws) != 2:
        raise InferError(
            f"sparse_embedding_lookup table {op.inputs['W'][0]!r} must "
            f"be 2-D [buckets, dim], got {_fmt(ws)}")
    if ids is None or ws is None:
        return {"Out": [(None, wd)]}
    base = ids[:-1] if (len(ids) >= 2 and ids[-1] == 1) else ids
    return {"Out": [(tuple(base) + (ws[1],), wd)]}


@register_shape_infer("sparse_scatter_update")
def _infer_sparse_scatter_update(op, ins, attrs):
    """Out mirrors W; Grad's trailing dim must match the table's (a
    transposed grad surfaces here, where an overwrite in place of an add
    would only show as wrong numbers)."""
    (ws, wd) = _first(ins, "W")
    (ids, idt) = _first(ins, "Ids")
    (gs, gd) = _first(ins, "Grad")
    if idt is not None and not np.issubdtype(np.dtype(idt), np.integer):
        raise InferError(
            f"sparse_scatter_update ids {op.inputs['Ids'][0]!r} must "
            f"be integer, got {idt}")
    if ws is not None and len(ws) != 2:
        raise InferError(
            f"sparse_scatter_update table {op.inputs['W'][0]!r} must "
            f"be 2-D [rows, dim], got {_fmt(ws)}")
    if ws is not None and gs is not None and len(gs) >= 1:
        # trailing dims must agree when both are concrete
        if gs[-1] not in (-1, ws[1]) and ws[1] != -1:
            raise InferError(
                f"sparse_scatter_update grad {op.inputs['Grad'][0]!r} "
                f"trailing dim {gs[-1]} != table dim {ws[1]}")
    return {"Out": [(ws, wd)]}


# --- structural / executor-interpreted ops -------------------------------

@register_shape_infer("autodiff")
def _infer_autodiff(op, ins, attrs):
    """Grads mirror Params exactly (the vjp contract)."""
    params = ins.get("Params", [])
    return {"Grads": [(s, d) for (s, d) in params]}


# --- fused consumers ---------------------------------------------------

@register_shape_infer("fused_transformer_block")
def _infer_fused_block(op, ins, attrs):
    (xs, xd) = _first(ins, "X")
    (w1s, _) = _first(ins, "W1")
    (w2s, _) = _first(ins, "W2")
    if (w1s is not None and w2s is not None
            and _dims_conflict(w1s[-1], w2s[0])):
        raise InferError(
            f"fused_transformer_block MLP mismatch: W1 {_fmt(w1s)} vs "
            f"W2 {_fmt(w2s)}")
    if xs is not None and w1s is not None \
            and _dims_conflict(xs[-1], w1s[0]):
        raise InferError(
            f"fused_transformer_block width mismatch: X {_fmt(xs)} "
            f"model dim {xs[-1]} vs W1 {_fmt(w1s)}")
    return {"Out": [(xs, xd)]}


# --- the frozen programs' quantized ops -----------------------------------

@register_shape_infer("quantized_matmul")
def _infer_quantized_matmul(op, ins, attrs):
    (xs, xd) = _first(ins, "X")
    (ws, _) = _first(ins, "W")
    nc = int(attrs.get("x_num_col_dims", 1))
    if xs is None or ws is None:
        return {"Out": [(None, "float32")]}
    k = _prod_known(xs[nc:])
    if k is not None and len(ws) == 2 and _dims_conflict(k, ws[0]):
        raise InferError(
            f"quantized_matmul contraction mismatch: X {_fmt(xs)} "
            f"flattens to [.., {k}], W {op.inputs['W'][0]!r} is "
            f"{_fmt(ws)}")
    return {"Out": [(tuple(xs[:nc]) + (ws[1],), "float32")]}


@register_shape_infer("quantized_conv2d")
def _infer_quantized_conv2d(op, ins, attrs):
    (xs, _) = _first(ins, "Input")
    (fs, _) = _first(ins, "Filter")
    if xs is not None and fs is not None and len(xs) == 4 \
            and len(fs) == 4:
        groups = int(attrs.get("groups", 1) or 1)
        if _dims_conflict(xs[1], fs[1] * groups):
            raise InferError(
                f"quantized_conv2d channel mismatch: Input {_fmt(xs)} "
                f"C={xs[1]} vs Filter {_fmt(fs)} "
                f"(expects C={fs[1] * groups})")
    return {"Output": [(None, "float32")]}

"""Miscellaneous ops (counterpart of paddle_tpu/ops/misc_ops.py):
sequence_context :49 and sequence_conv :60 over ``_context_columns``
:32; shuffle_channel :74; unique :100 and unique_with_counts :110 over
``_unique_static`` :84; hash :118; similarity_focus :137; conv_shift
:160; spp :175; random_crop :198; lstmp :235 and cudnn_lstm :253 over
``_lstm_scan`` :219; pool3d :308; conv3d_transpose :321; the LoD and
SelectedRows plumbing lod_rank_table :345, lookup_sparse_table :356,
split_ids :366, merge_ids :377, merge_selected_rows :390,
split_selected_rows :403, get_tensor_from_selected_rows :421; label_smooth
:435; the host ops fill :447, print :456 and delete_var :465;
max_sequence_len :471, reorder_lod_tensor_by_rank :479,
tensor_array_to_tensor :488, split_lod_tensor :503, merge_lod_tensor
:516, unpool :527, lod_array_length :543, lod_tensor_to_array :550,
array_to_lod_tensor :562, shrink_rnn_memory :575 and scale_sub_region
:589.

As in the JAX package, what the reference sizes by its data keeps a
static shape: unique's outputs are the input's length with -1 or 0
pads and explicit counts; a SelectedRows is an (Ids, Values) pair of
dense tensors, its shards keep every position (-1 ids, zero rows), so a
merge is a sum; a tensor array is a list of inputs or an [N, ...]
tensor.  Integer outputs JAX casts to int32 are int32 here; its
``index_dtype()`` outputs are int64 (ROADMAP C).  Every lowering
evaluates on ``meta`` tensors (no host read of a value), and an
update's index follows ``.at[]``: a negative one wraps once, one still
out of range is dropped (``wrap_or_drop``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import to_torch_dtype
from ..framework.registry import register_op, single_input
from .nn_ops import _pair, _pool_nd
from .sequence_ops import wrap_or_drop


def _context_columns(x, ctx_len, ctx_start):
    """[B, T, D] -> [B, T, ctx_len * D]: step t's row concatenates x at
    steps t + ctx_start ... t + ctx_start + ctx_len - 1, zeros beyond the
    ends (the reference's ContextProjection, sequence_conv_op.cc's
    im2col)."""
    B, T, D = x.shape
    steps = torch.arange(T, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(x, -off, dims=1)
        valid = ((steps + off >= 0) & (steps + off < T))[None, :, None]
        cols.append(torch.where(valid, shifted, 0.0))
    return torch.cat(cols, dim=-1)


@register_op("sequence_context")
def _sequence_context(ctx, ins, attrs):
    """The raw sliding-window concat (v2's context_projection without
    weights): [B, T, D] -> [B, T, context_length * D]; the start defaults
    to the reference's Py2 floor -(len - 1) / 2 (-2 at length 4)."""
    x = single_input(ins, "X")
    ctx_len = int(attrs["context_length"])
    ctx_start = int(attrs.get("context_start", (-(ctx_len - 1)) // 2))
    return {"Out": [_context_columns(x, ctx_len, ctx_start)]}


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (ref sequence_conv_op.cc): X
    [B, T, D], Filter [ctx_len * D, M], zero-padded context; the product
    in X's dtype, as the JAX lowering casts the filter to it."""
    x = single_input(ins, "X")
    w = single_input(ins, "Filter")
    ctx_len = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    ctx_start = int(attrs.get("contextStart",
                              attrs.get("context_start", -(ctx_len // 2))))
    col = _context_columns(x, ctx_len, ctx_start)
    out = torch.matmul(col, w.to(col.dtype))
    return {"Out": [out.to(x.dtype)]}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """ref pool_op.cc 3-D: NCDHW max / avg on the shared ``_pool_nd``
    (global_pooling, ceil_mode, exclusive avg); ksize 2 and strides =
    ksize where the attrs leave them out."""
    attrs = dict(attrs)
    if "ksize" not in attrs and not attrs.get("global_pooling", False):
        attrs["ksize"] = 2
    if "strides" not in attrs:
        attrs["strides"] = attrs.get("ksize", 2)
    return {"Out": [_pool_nd(single_input(ins, "X"), attrs, 3)]}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """ref conv_transpose_op.cc 3-D: IODHW filter [C_in, C_out, kd, kh,
    kw], strides and paddings, no groups or dilations (JAX's lowering
    takes none); F.conv_transpose3d computes JAX's gradient-of-conv
    function.  JAX's lowering makes no AMP casts: the operands must
    share a dtype, and Output takes Input's."""
    x = single_input(ins, "Input")
    w = single_input(ins, "Filter")
    out = F.conv_transpose3d(x, w, None, _pair(attrs.get("strides", 1), 3),
                             _pair(attrs.get("paddings", 0), 3))
    return {"Output": [out.to(x.dtype)]}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """ref label_smooth_op.cc: (1 - eps) * x + eps * prior, the prior
    ``PriorDist`` where it is given, else uniform over the last dim."""
    x = single_input(ins, "X")
    eps = float(attrs.get("epsilon", 0.1))
    prior = ins["PriorDist"][0] if ins.get("PriorDist") else (
        1.0 / x.shape[-1])
    return {"Out": [(1.0 - eps) * x + eps * prior]}


@register_op("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    """[N, g * c, H, W] with the g groups' channels interleaved (ref
    shuffle_channel_op.cc)."""
    x = single_input(ins, "X")
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    y = x.reshape(n, g, c // g, h, w).transpose(1, 2)
    return {"Out": [y.reshape(n, c, h, w)]}


def _unique_static(x):
    """(values -1-padded, each entry's rank among them, counts 0-padded,
    the count of unique values) of a 1-D x, every output x's length: a
    stable sort, the first of each run of equal values marked, the ranks
    a cumulative sum of the marks."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    xs = x[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       xs[1:] != xs[:-1]])
    rank = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_uniq = rank[-1:] + 1
    vals = torch.full((n,), -1, dtype=x.dtype, device=x.device).scatter(
        0, rank.long(), xs)
    index = torch.zeros(n, dtype=torch.int32, device=x.device).scatter(
        0, order, rank)
    counts = torch.zeros(n, dtype=torch.int32, device=x.device).index_add(
        0, rank.long(), torch.ones_like(rank))
    return vals, index, counts, n_uniq


@register_op("unique")
def _unique(ctx, ins, attrs):
    """ref unique_op.cc with static shapes: Out is X's length, the sorted
    unique values then -1; Index (int32) each entry's position in Out;
    Count [1] (int32) the number of unique values."""
    vals, index, _, n_uniq = _unique_static(single_input(ins).reshape(-1))
    return {"Out": [vals], "Index": [index], "Count": [n_uniq]}


@register_op("unique_with_counts")
def _unique_with_counts(ctx, ins, attrs):
    """unique, with Count each unique value's occurrences (0-padded) and
    UniqueCount [1] the number of them."""
    vals, index, counts, n_uniq = _unique_static(
        single_input(ins).reshape(-1))
    return {"Out": [vals], "Index": [index], "Count": [counts],
            "UniqueCount": [n_uniq]}


_U32 = 0xFFFFFFFF


def _mul_u32(a, b):
    """(a * b) mod 2^32 of uint32 values held in int64, b a Python int:
    in two products by b's 16-bit halves, so that none passes 2^48 (a
    whole 32 x 32-bit product would overflow int64)."""
    lo = (a * (b & 0xFFFF)) & _U32
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


@register_op("hash")
def _hash(ctx, ins, attrs):
    """ref hash_op.cc: num_hash hashes of each int row, each modulo
    mod_by: X [N, k] -> Out [N, num_hash, 1] int32.  JAX's uint32
    xor-multiply arithmetic (per-hash odd seeds, then 0x85EBCA6B and a
    xor-shift by 13 per column) in int64 held to 32 bits, so the shift is
    a logical one; X's low 32 bits are what JAX's int32 feed and uint32
    cast keep of an int64 id."""
    x = single_input(ins, "X").long() & _U32
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 100000))
    seeds = [int(v) for v in (np.arange(1, num_hash + 1, dtype=np.uint32)
                              * np.uint32(0x9E3779B1)) | np.uint32(1)]
    h = torch.zeros((x.shape[0], num_hash), dtype=torch.int64,
                    device=x.device)
    for j in range(x.shape[1]):
        col = torch.stack([_mul_u32(x[:, j], s) for s in seeds], dim=1)
        h = _mul_u32(h ^ col, 0x85EBCA6B)
        h = h ^ (h >> 13)
    return {"Out": [(h % mod_by).to(torch.int32)[:, :, None]]}


@register_op("similarity_focus")
def _similarity_focus(ctx, ins, attrs):
    """ref similarity_focus_op.cc: for each listed channel of the
    ``axis``, the cells that hold their row's or their column's max of
    that [A, B] map (every tied one); the union of those masks over all
    listed channels, broadcast over every channel."""
    x = single_input(ins, "X")
    axis = int(attrs.get("axis", 1))
    if axis != 1:
        x = torch.movedim(x, axis, 1)
    n, _, a, b = x.shape
    mask = torch.zeros((n, a, b), dtype=x.dtype, device=x.device)
    for idx in list(attrs.get("indexes", [0])):
        m = x[:, idx]
        hit = ((m == m.amax(dim=2, keepdim=True))
               | (m == m.amax(dim=1, keepdim=True)))
        mask = torch.maximum(mask, hit.to(x.dtype))
    out = mask[:, None].expand(x.shape).contiguous()
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return {"Out": [out]}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """ref conv_shift_op.cc: circular correlation, out[b, i] = sum_j
    x[b, (i + j - M // 2) mod N] * y[b, j], summed over j in order."""
    x = single_input(ins, "X")
    y = single_input(ins, "Y")
    half = y.shape[1] // 2
    return {"Out": [sum(torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
                        for j in range(y.shape[1]))]}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling (ref spp_op.cc): levels 0 .. H - 1 of
    2^l x 2^l bins, their edges numpy's linspace truncated, as JAX's
    (a bin at least one pixel wide); max or mean of each, concatenated
    to [N, C * sum(4^l)]."""
    x = single_input(ins, "X")
    levels = int(attrs.get("pyramid_height", 1))
    pool_max = attrs.get("pooling_type", "max") == "max"
    _, _, h, w = x.shape
    outs = []
    for level in range(levels):
        bins = 2 ** level
        ys = np.linspace(0, h, bins + 1).astype(int)
        xs = np.linspace(0, w, bins + 1).astype(int)
        for i in range(bins):
            for j in range(bins):
                patch = x[:, :, ys[i]:max(ys[i + 1], ys[i] + 1),
                          xs[j]:max(xs[j + 1], xs[j] + 1)]
                outs.append(patch.amax(dim=(2, 3)) if pool_max
                            else patch.mean(dim=(2, 3)))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("random_crop")
def _random_crop(ctx, ins, attrs):
    """ref random_crop_op.cc: the trailing dims cropped to ``shape`` at
    offsets drawn uniformly from [0, size - crop] by the op's generator
    (torch's Philox, not JAX's threefry: ROADMAP C).  The offsets stay on
    the device (the crop is index_select along each dim), so nothing
    syncs; a meta evaluation crops at 0."""
    x = single_input(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    lead = x.ndim - len(shape)
    gen = ctx.rng()
    out = x
    for i, s in enumerate(shape):
        dim = lead + i
        steps = torch.arange(s, device=x.device)
        if gen is not None:
            hi = max(x.shape[dim] - s, 0) + 1
            steps = steps + torch.randint(0, hi, (1,), generator=gen,
                                          device=x.device)
        out = out.index_select(dim, steps)
    return {"Out": [out]}


# -- the fused and projected recurrences ----------------------------------

def _lstm_scan(x_seq, wh, h0, c0, proj=None):
    """x_seq [T, B, 4H] already projected; wh [P or H, 4H]; gates i, f,
    g, o; an optional proj [H, P] (LSTMP, ref lstmp_op.cc) maps each
    step's hidden to the recurrent state.  Returns ((h_T, c_T), (hs, cs))
    with hs and cs stacked over T."""
    h, c = h0, c0
    hs, cs = [], []
    for t in range(x_seq.shape[0]):
        i, f, g, o = torch.chunk(x_seq[t] + h @ wh, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hid = torch.sigmoid(o) * torch.tanh(c)
        h = hid @ proj if proj is not None else hid
        hs.append(h)
        cs.append(c)
    return (h, c), (torch.stack(hs), torch.stack(cs))


@register_op("lstmp")
def _lstmp(ctx, ins, attrs):
    """LSTM with a recurrent projection (ref lstmp_op.cc): Input [B, T,
    4H] already projected, Weight [P, 4H], ProjWeight [H, P], optional H0
    [B, P] and C0 [B, H].  Projection [B, T, P], Cell [B, T, H], LastH,
    LastC."""
    x = single_input(ins, "Input")
    w = single_input(ins, "Weight")
    pw = single_input(ins, "ProjWeight")
    B, _, H4 = x.shape
    h0 = ins["H0"][0] if ins.get("H0") else x.new_zeros((B, pw.shape[1]))
    c0 = ins["C0"][0] if ins.get("C0") else x.new_zeros((B, H4 // 4))
    (h, c), (hs, cs) = _lstm_scan(x.transpose(0, 1), w, h0, c0, proj=pw)
    return {"Projection": [hs.transpose(0, 1)], "Cell": [cs.transpose(0, 1)],
            "LastH": [h], "LastC": [c]}


@register_op("cudnn_lstm")
def _cudnn_lstm(ctx, ins, attrs):
    """Multi-layer, optionally bidirectional LSTM (ref cudnn_lstm_op.cc):
    Input [B, T, D]; W one flat parameter, sliced per (layer, direction)
    as wx [in, 4H] | wh [H, 4H] | b [4H]; optional InitH / InitC [L *
    ndir, B, H].  The reverse direction runs over the whole padded
    sequence flipped; a layer's directions concatenate into the next
    layer's input.  Out [B, T, ndir * H], LastH and LastC [L * ndir, B,
    H]."""
    x = single_input(ins, "Input")
    w = single_input(ins, "W").reshape(-1)
    H = int(attrs["hidden_size"])
    L = int(attrs.get("num_layers", 1))
    ndir = 2 if bool(attrs.get("is_bidirec", False)) else 1
    B, _, D = x.shape
    init_h = ins["InitH"][0] if ins.get("InitH") else None
    init_c = ins["InitC"][0] if ins.get("InitC") else None
    off = 0

    def take(n, shape):
        nonlocal off
        v = w[off:off + n].reshape(shape)
        off += n
        return v

    def init(state, li):
        if state is None:
            return x.new_zeros((B, H))
        return state[li] if state.ndim == 3 else state

    seq = x.transpose(0, 1)                                  # [T, B, .]
    last_h, last_c = [], []
    for layer in range(L):
        din = D if layer == 0 else H * ndir
        outs = []
        for d in range(ndir):
            wx = take(din * 4 * H, (din, 4 * H))
            wh = take(H * 4 * H, (H, 4 * H))
            b = take(4 * H, (4 * H,))
            s = torch.flip(seq, dims=[0]) if d == 1 else seq
            li = layer * ndir + d
            (h_t, c_t), (hs, _) = _lstm_scan(s @ wx + b, wh,
                                             init(init_h, li),
                                             init(init_c, li))
            outs.append(torch.flip(hs, dims=[0]) if d == 1 else hs)
            last_h.append(h_t)
            last_c.append(c_t)
        seq = torch.cat(outs, dim=-1) if ndir == 2 else outs[0]
    return {"Out": [seq.transpose(0, 1)], "LastH": [torch.stack(last_h)],
            "LastC": [torch.stack(last_c)]}


# -- LoD and SelectedRows plumbing (dense redesigns) -----------------------

def _lengths(x):
    """Lengths from a [B, T] 0/1 mask (its row sums) or a [B] vector, as
    int32."""
    return (x.sum(dim=1) if x.ndim > 1 else x).to(torch.int32)


@register_op("lod_rank_table")
def _lod_rank_table(ctx, ins, attrs):
    """ref lod_rank_table_op.cc: the rows sorted by length, longest first
    (a stable sort, so ties keep their order).  X a [B, T] mask or [B]
    lengths; Out the order, Lengths the sorted lengths (both int32)."""
    lens = _lengths(single_input(ins, "X"))
    order = torch.argsort(-lens, stable=True).to(torch.int32)
    return {"Out": [order], "Lengths": [lens[order.long()]]}


@register_op("lookup_sparse_table")
def _lookup_sparse_table(ctx, ins, attrs):
    """ref lookup_sparse_table_op.cc: the pserver's growing table is a
    dense parameter here, so this is lookup_table: W's rows at Ids."""
    w = single_input(ins, "W")
    ids = single_input(ins, "Ids").reshape(-1).to(torch.int32)
    return {"Out": [w.index_select(0, ids)]}


@register_op("split_ids")
def _split_ids(ctx, ins, attrs):
    """ref split_ids_op.cc: ids routed to num_shards shards by id %
    num_shards (a floor modulo); each shard keeps the input's length,
    -1 where it does not own the id (int32)."""
    ids = single_input(ins, "Ids").reshape(-1).to(torch.int32)
    n = int(attrs.get("num_shards", 1))
    minus = torch.full_like(ids, -1)
    return {"Out": [torch.where(ids % n == i, ids, minus) for i in range(n)]}


@register_op("merge_ids")
def _merge_ids(ctx, ins, attrs):
    """ref merge_ids_op.cc: the shards' rows back in place, a sum (a
    shard's row is zero where it did not own the position)."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("merge_selected_rows")
def _merge_selected_rows(ctx, ins, attrs):
    """ref merge_selected_rows_op.cc: the rows of repeated ids summed.
    OutIds the unique ids (int32, -1 past their count), Out each unique
    id's row sum in the same order (zero rows after; on the card the
    adds are atomics)."""
    ids = single_input(ins, "Ids").reshape(-1).to(torch.int32)
    vals = single_input(ins, "Values")
    uniq, index, _, _ = _unique_static(ids)
    summed = vals.new_zeros(vals.shape).index_add(0, index.long(), vals)
    return {"OutIds": [uniq], "Out": [summed]}


@register_op("split_selected_rows")
def _split_selected_rows(ctx, ins, attrs):
    """ref split_selected_rows_op.cc: rows split into the pserver blocks
    of ``height_sections``; each block's ids are local (-1 where another
    block owns the row), its values zero there."""
    ids = single_input(ins, "Ids").reshape(-1).to(torch.int32)
    vals = single_input(ins, "Values")
    outs_ids, outs_vals = [], []
    off = 0
    for h in attrs["height_sections"]:
        own = (ids >= off) & (ids < off + int(h))
        outs_ids.append(torch.where(own, ids - off, torch.full_like(ids, -1)))
        outs_vals.append(torch.where(own[:, None], vals,
                                     torch.zeros_like(vals)))
        off += int(h)
    return {"OutIds": outs_ids, "Out": outs_vals}


@register_op("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    """ref get_tensor_from_selected_rows_op.cc: (Ids, Values) summed into
    a dense [height, ...] tensor; a negative id (the shards' pad) or one
    past height adds nothing, as JAX's masked scatter gives it."""
    ids = single_input(ins, "Ids").reshape(-1).long()
    vals = single_input(ins, "Values")
    height = int(attrs["height"])
    keep = (ids >= 0) & (ids < height)
    idx = torch.where(keep, ids, torch.zeros_like(ids))
    kept = torch.where(keep.reshape((-1,) + (1,) * (vals.ndim - 1)), vals,
                       torch.zeros_like(vals))
    out = vals.new_zeros((height,) + tuple(vals.shape[1:]))
    return {"Out": [out.index_add(0, idx, kept)]}


@register_op("fill")
def _fill(ctx, ins, attrs):
    """ref fill_op.cc: the constant data of the attrs, made on the host
    with numpy in the attr's dtype (f32, then a round-to-nearest cast,
    for the types numpy lacks: bf16 and fp8) and copied to the op's
    device."""
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    host = (torch.float32 if dtype in (torch.bfloat16, torch.float8_e4m3fn,
                                       torch.float8_e5m2) else dtype)
    value = np.asarray(attrs["value"], dtype=torch.empty(
        (), dtype=host).numpy().dtype)
    out = torch.from_numpy(value.copy()).reshape(list(attrs["shape"]))
    return {"Out": [out.to(ctx.device, dtype)]}


@register_op("print")
def _print(ctx, ins, attrs):
    """ref print_op.cc: In (or X) passes through, and the host prints the
    message and the tensor (a sync on the card; torch's text, not
    jax.debug.print's).  A meta evaluation prints nothing."""
    x = single_input(ins, "In" if ins.get("In") else "X")
    if x.device.type != "meta":
        print(f"{attrs.get('message', '')}{x}")
    return {"Out": [x]}


@register_op("delete_var")
def _delete_var(ctx, ins, attrs):
    """ref delete_var_op.cc: the allocator frees what no op reads, so
    this is a no-op."""
    return {}


@register_op("max_sequence_len")
def _max_sequence_len(ctx, ins, attrs):
    """ref max_sequence_len_op.cc: the longest length, [1] int32, of a
    rank table's lengths or a [B, T] mask."""
    x = single_input(ins, "RankTable" if ins.get("RankTable") else "X")
    return {"Out": [_lengths(x).amax().reshape(1)]}


@register_op("reorder_lod_tensor_by_rank")
def _reorder_by_rank(ctx, ins, attrs):
    """ref reorder_lod_tensor_by_rank_op.cc: X's rows in the rank table's
    order (RankTable the order indices)."""
    x = single_input(ins, "X")
    order = single_input(ins, "RankTable").reshape(-1).to(torch.int32)
    return {"Out": [x.index_select(0, order)]}


@register_op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, ins, attrs):
    """ref tensor_array_to_tensor_op.cc: the array (the X input list)
    stacked or concatenated along ``axis``; OutIndex [n] int32 each
    entry's extent along it."""
    xs = list(ins["X"])
    axis = int(attrs.get("axis", 0))
    out = (torch.stack(xs, dim=axis) if attrs.get("use_stack", False)
           else torch.cat(xs, dim=axis))
    sizes = [x.shape[axis] for x in xs]
    return {"Out": [out], "OutIndex": [torch.tensor(
        sizes, dtype=torch.int32, device=out.device)]}


def _row_mask(mask, like):
    """A [B] mask as a bool broadcastable over `like`'s rows."""
    return mask.reshape(-1).to(torch.bool).reshape(
        (-1,) + (1,) * (like.ndim - 1))


@register_op("split_lod_tensor")
def _split_lod_tensor(ctx, ins, attrs):
    """ref split_lod_tensor_op.cc: rows routed by a bool mask; both
    outputs keep every row, zeroed where the other branch has it."""
    x = single_input(ins, "X")
    m = _row_mask(single_input(ins, "Mask"), x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"OutTrue": [torch.where(m, x, zero)],
            "OutFalse": [torch.where(m, zero, x)]}


@register_op("merge_lod_tensor")
def _merge_lod_tensor(ctx, ins, attrs):
    """ref merge_lod_tensor_op.cc: split_lod_tensor undone, each row from
    the branch its mask names."""
    in_true = single_input(ins, "InTrue")
    m = _row_mask(single_input(ins, "Mask"), in_true)
    return {"Out": [torch.where(m, in_true, single_input(ins, "InFalse"))]}


@register_op("unpool")
def _unpool(ctx, ins, attrs):
    """ref unpool_op.cc: max-unpooling: X [N, C, h, w] added into [N, C,
    unpooled_height, unpooled_width] at Indices (flat positions, as
    pool2d_with_index gives them); a repeated index sums (atomics on the
    card), a negative one wraps once and one out of range is dropped."""
    x = single_input(ins, "X")
    n, c = x.shape[:2]
    uh, uw = int(attrs["unpooled_height"]), int(attrs["unpooled_width"])
    idx, keep = wrap_or_drop(single_input(ins, "Indices").long().reshape(
        n, c, -1), uh * uw)
    src = torch.where(keep, x.reshape(n, c, -1), torch.zeros(
        (), dtype=x.dtype, device=x.device))
    out = x.new_zeros((n, c, uh * uw)).scatter_add(2, idx, src)
    return {"Out": [out.reshape(n, c, uh, uw)]}


@register_op("lod_array_length")
def _lod_array_length(ctx, ins, attrs):
    """ref lod_array_length_op.cc: the array is the X input list, so its
    length is static: [1] int64."""
    return {"Out": [torch.tensor([len(ins["X"])], dtype=torch.int64,
                                 device=ctx.device)]}


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ctx, ins, attrs):
    """ref lod_tensor_to_array_op.cc: X [B, T, ...] with its rows in the
    rank table's order, one [B, ...] entry a step (array_to_lod_tensor
    undoes it)."""
    x = single_input(ins, "X")
    order = single_input(ins, "RankTable").reshape(-1).to(torch.int32)
    xs = x.index_select(0, order)
    return {"Out": [xs[:, t] for t in range(x.shape[1])]}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ctx, ins, attrs):
    """ref array_to_lod_tensor_op.cc: the per-step entries stacked to [B,
    T, ...] and the rank table's permutation undone."""
    order = single_input(ins, "RankTable").reshape(-1).long()
    stacked = torch.stack(list(ins["X"]), dim=1)
    inv = torch.zeros_like(order).scatter(
        0, order, torch.arange(order.shape[0], device=order.device))
    return {"Out": [stacked.index_select(0, inv)]}


@register_op("shrink_rnn_memory")
def _shrink_rnn_memory(ctx, ins, attrs):
    """ref shrink_rnn_memory_op.cc: at step I, the rows whose sequence
    has ended are zeroed (the reference slices them off; the shape stays
    [B, ...] here).  RankTable the lengths (lod_rank_table's Lengths), I
    a [1] step."""
    x = single_input(ins, "X")
    lens = single_input(ins, "RankTable").reshape(-1).to(torch.int32)
    step = single_input(ins, "I").reshape(()).to(torch.int32)
    active = (lens > step).to(x.dtype)
    return {"Out": [x * active.reshape((-1,) + (1,) * (x.ndim - 1))]}


@register_op("scale_sub_region")
def _scale_sub_region(ctx, ins, attrs):
    """``value`` times X inside each instance's CHW box (ref
    scale_sub_region_op): X [B, C, H, W], Indices [B, 6], 1-based and
    inclusive (C0, C1, H0, H1, W0, W1)."""
    x = single_input(ins, "X")
    idx = single_input(ins, "Indices").long()
    value = float(attrs.get("value", 1.0))
    _, C, H, W = x.shape

    def dim_mask(lo, hi, n):
        r = torch.arange(n, device=x.device)[None, :]
        return (r >= lo[:, None] - 1) & (r <= hi[:, None] - 1)

    m = (dim_mask(idx[:, 0], idx[:, 1], C)[:, :, None, None]
         & dim_mask(idx[:, 2], idx[:, 3], H)[:, None, :, None]
         & dim_mask(idx[:, 4], idx[:, 5], W)[:, None, None, :])
    return {"Out": [torch.where(m, x * torch.full((), value, dtype=x.dtype,
                                                  device=x.device), x)]}

"""The bf16 LM-head forward's wgmma path, as far as the CPU can hold it.

The wgmma kernel (csrc/lm_head_bf16.cu, lm_head_fwd_bf16_wg_kernel and
its merge) runs only on the card (tests/test_torch_cuda.py).  Here:

- the path choice, a pure function of the operands' addresses and row
  lengths (``bf16_path``, the backward's condition; the wrapper's
  ``_bf16_path`` on real tensors): TMA needs
  16-byte-aligned bases and rows of a multiple of 16 bytes, else the sync
  path;
- the schedule the kernel runs on 132 SMs (``fwd_bf16_plan``,
  ``fwd_bf16_segments``): every (token tile, vocab tile) is covered once,
  each CTA takes its share within one tile of the mean, a token tile's
  segments fit the workspace's slots (at most 3 at the training shape,
  2 on 132 SMs, where a CTA loads x at most twice), and x stays in shared
  memory exactly where D <= 640;
- the wgmma path's summation order, emulated in f32 at small sizes
  (chip_smoke.segmented_fwd: per-segment online states merged in
  vocabulary order): held to the JAX ``lm_head_xent`` forward (Pallas in
  interpret mode, as its own tests run it) and to ``lm_head_fwd_plain`` at
  chip_smoke's HEAD_TOL, on ragged V, ignored labels, int32 labels and a
  peaked softmax;
- chip_smoke's planted fault for this compare (a merge that drops one
  segment's state) is refused by more than 4x HEAD_TOL.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import HEAD_TOL, fault_segment, segmented_fwd
from paddle_tpu_torch.kernels import lm_head as tlm

# the package re-exports a function under the module's name
jlm = importlib.import_module("paddle_tpu.kernels.lm_head")

SMS = 132   # the H100 SXM's SMs
TRAIN = (16384, 512, 32000)   # the training step's N, D, V


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("x_ptr,w_ptr,D,V,want", [
    (0x7f0000000000, 0x7f0000100000, 512, 32000, "wgmma"),  # training
    (0x7f0000000000, 0x7f0000100000, 264, 4104, "wgmma"),   # ragged tiles
    (0x7f0000000000, 0x7f0000100000, 1024, 4104, "wgmma"),  # x streamed
    (0x7f0000000000, 0x7f0000100000, 8, 8, "wgmma"),
    (0x7f0000000002, 0x7f0000100000, 512, 32000, "sync"),   # x off 16 B
    (0x7f0000000000, 0x7f0000100008, 512, 32000, "sync"),   # W off 16 B
    (0x7f0000000000, 0x7f0000100000, 201, 3000, "sync"),    # odd D
    (0x7f0000000000, 0x7f0000100000, 12, 100, "sync"),      # D 24 bytes
    (0x7f0000000000, 0x7f0000100000, 512, 1001, "sync"),    # odd V
    (0x7f0000000000, 0x7f0000100000, 512, 32004, "sync"),   # V 8 bytes off
])
def test_fwd_bf16_path_choice(x_ptr, w_ptr, D, V, want):
    assert tlm.bf16_path(x_ptr, w_ptr, D, V) == want


def test_fwd_bf16_path_of_real_tensors():
    """The forward wrapper's choice on real tensors: a slice one element in
    is 2 bytes off the storage's 16-byte alignment, and takes the sync
    path; forcing "wgmma" on it raises, and an unknown path too."""
    x = torch.zeros(4 * 512 + 1, dtype=torch.bfloat16)
    w = torch.zeros(512, 32000, dtype=torch.bfloat16)
    name = "lm_head_fwd_bf16"
    assert tlm._bf16_path(name, x[:-1].view(4, 512), w, None) == "wgmma"
    assert tlm._bf16_path(name, x[1:].view(4, 512), w, None) == "sync"
    assert tlm._bf16_path(name, x[:-1].view(4, 512), w, "sync") == "sync"
    with pytest.raises(ValueError, match="wgmma path"):
        tlm._bf16_path(name, x[1:].view(4, 512), w, "wgmma")
    with pytest.raises(ValueError, match="no path"):
        tlm._bf16_path(name, x[:-1].view(4, 512), w, "tma")


@pytest.mark.parametrize("N,D,V,want", [
    # the training shape: 32000 tiles, 242-243 a CTA; token tiles cut in
    # at most two segments; x resident beside 6 stages of W
    (*TRAIN, dict(token_tiles=128, vocab_tiles=250, tiles=32000, ctas=132,
                  slots=2, x_resident=True, stages=6)),
    # chip_smoke's peaked case: 30-31 tiles a CTA, 250 a token tile
    (2048, 512, 32000, dict(token_tiles=16, vocab_tiles=250, tiles=4000,
                            ctas=132, slots=9, x_resident=True, stages=6)),
    # aligned and a multiple of no tile: 6 tiles a CTA
    (3001, 264, 4104, dict(token_tiles=24, vocab_tiles=33, tiles=792,
                           ctas=132, slots=6, x_resident=True, stages=8)),
    # D above the resident limit: x streams beside W, 7 stages of 32 KiB
    (1000, 1024, 4104, dict(token_tiles=8, vocab_tiles=33, tiles=264,
                            ctas=132, slots=17, x_resident=False, stages=7)),
    # the largest resident D (4 stages) and the smallest streamed one
    (4096, 640, 32000, dict(token_tiles=32, vocab_tiles=250, tiles=8000,
                            ctas=132, slots=5, x_resident=True, stages=4)),
    (4096, 648, 32000, dict(token_tiles=32, vocab_tiles=250, tiles=8000,
                            ctas=132, slots=5, x_resident=False, stages=7)),
    # fewer tiles than SMs: one CTA a tile
    (5, 16, 104, dict(token_tiles=1, vocab_tiles=1, tiles=1, ctas=1,
                      slots=1, x_resident=True, stages=8)),
])
def test_fwd_bf16_plan_on_132_sms(N, D, V, want):
    assert tlm.fwd_bf16_plan(N, D, V, SMS) == want


SPLIT_CASES = [TRAIN, (2048, 512, 32000), (3001, 264, 4104),
               (1000, 1024, 4104), (5, 16, 104), (16384, 512, 50264),
               (128, 64, 128 * 200), (300, 8, 8)]


@pytest.mark.parametrize("N,D,V", SPLIT_CASES)
def test_fwd_bf16_split_covers_every_tile_once(N, D, V):
    """Every (token tile, vocab tile) lies in exactly one segment; the
    CTAs' ranges differ in length by at most one tile; each token tile's
    segments take slots 0, 1, ... in vocabulary order, no more than the
    plan's (the workspace's) slots."""
    p = tlm.fwd_bf16_plan(N, D, V, SMS)
    segs = tlm.fwd_bf16_segments(N, V, p["ctas"])
    seen = np.zeros((p["token_tiles"], p["vocab_tiles"]), np.int64)
    per_cta = np.zeros(p["ctas"], np.int64)
    by_tile = {}
    for c, m, v0, v1, slot in segs:
        assert 0 <= v0 < v1 <= p["vocab_tiles"]
        seen[m, v0:v1] += 1
        per_cta[c] += v1 - v0
        by_tile.setdefault(m, []).append((v0, v1, slot, c))
    assert (seen == 1).all()
    assert per_cta.sum() == p["tiles"]
    assert per_cta.max() - per_cta.min() <= 1
    assert abs(per_cta.mean() - p["tiles"] / p["ctas"]) < 1e-9
    for m, parts in by_tile.items():
        parts.sort()
        assert [s for _, _, s, _ in parts] == list(range(len(parts)))
        assert [c for _, _, _, c in parts] == list(
            range(parts[0][3], parts[0][3] + len(parts)))
        assert len(parts) <= p["slots"]
    assert max(len(v) for v in by_tile.values()) == p["slots"]


def test_fwd_bf16_training_split_reloads_x_at_most_once():
    """At the training shape a range (242-243 tiles) is shorter than a
    token tile (250): it crosses at most one token-tile boundary, so a CTA
    has at most two segments (x loaded at most twice) and a token tile at
    most three (two on this split)."""
    p = tlm.fwd_bf16_plan(*TRAIN, SMS)
    segs = tlm.fwd_bf16_segments(TRAIN[0], TRAIN[2], p["ctas"])
    per_cta = np.bincount([c for c, *_ in segs], minlength=p["ctas"])
    assert per_cta.max() == 2 and per_cta.min() >= 1
    counts = {242, 243}
    assert {sum(v1 - v0 for c2, _, v0, v1, _ in segs if c2 == c)
            for c in range(p["ctas"])} == counts
    assert p["slots"] <= 3


def test_x_resident_exactly_below_the_limit():
    """x's 128 x D tile stays in shared memory where its cdiv(D, 64) boxes
    of 16 KiB leave room for 4 stages of W: D <= 640."""
    for D in range(8, 2049, 8):
        p = tlm.fwd_bf16_plan(4096, D, 32000, SMS)
        assert p["x_resident"] == (D <= 640), D
        assert 4 <= p["stages"] <= 8
        box = tlm.FWD_BOX
        used = tlm.FWD_FIXED + p["stages"] * box * (1 if p["x_resident"]
                                                    else 2)
        used += _cdiv(D, 64) * box if p["x_resident"] else 0
        assert used <= tlm.FWD_SMEM


def _inputs(N, D, V, n_ign, amp, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, D) * amp).astype("float32")
    w = (rng.randn(D, V) * 0.05).astype("float32")
    y = rng.randint(0, V, N).astype("int64")
    y[rng.choice(N, n_ign, replace=False)] = -1
    return x, w, y


def _tbf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _pallas_fwd(x, w, y):
    """(loss, lse) of the JAX package's forward on bf16 x and w: loss from
    the public ``lm_head_xent``, lse from its ``_fwd`` (the same Pallas
    call, interpret mode, the same blocks and vocabulary padding)."""
    N, V = x.shape[0], w.shape[1]
    xb, wb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    yj = jnp.asarray(y.astype("int32"))
    loss = jlm.lm_head_xent(xb, wb, yj, interpret=True)
    bv = jlm._pick_block_v(V) or 512
    vp = _cdiv(V, bv) * bv
    bn = min(1024, N)
    while N % bn:
        bn //= 2
    _, lse = jlm._fwd(xb, jnp.pad(wb, ((0, 0), (0, vp - V))),
                      yj.reshape(N, 1), True, bn, bv,
                      V if vp != V else None)
    return np.asarray(loss), np.asarray(lse)[:, 0]


# (N, D, V, SMs, ignored labels, scale of x, label dtype): D and V
# multiples of 8 (the wgmma path's shapes); SMs few enough that token
# tiles are cut in segments, and ranges longer than a token tile
ORDER_CASES = [
    (384, 64, 1000, 5, 7, 1, "int64"),     # ragged V, 3 token tiles
    (512, 128, 2048, 3, 0, 12, "int32"),   # peaked; ranges span 2 tiles
    (256, 32, 304, 132, 5, 1, "int64"),    # one CTA a tile
]


@pytest.mark.parametrize("case", ORDER_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_segment_order_matches_pallas_and_plain(case):
    N, D, V, sms, n_ign, amp, ydt = case
    x, w, y = _inputs(N, D, V, n_ign, amp, N + D + V)
    tx, tw = _tbf(x), _tbf(w)
    ty = torch.from_numpy(y.astype(ydt))
    ctas = tlm.fwd_bf16_plan(N, D, V, sms)["ctas"]
    assert tlm.fwd_bf16_plan(N, D, V, sms)["slots"] >= 2
    loss, lse = segmented_fwd(tlm, tx, tw, ty, ctas)
    ploss, plse = tlm.lm_head_fwd_plain(tx, tw, ty)
    jloss, jlse = _pallas_fwd(x, w, y)
    assert loss.dtype == lse.dtype == torch.float32
    assert (loss[ty < 0] == 0).all()
    for got, plain, pallas in ((loss, ploss, jloss), (lse, plse, jlse)):
        assert float((got - plain).abs().max()) <= HEAD_TOL
        assert float(np.abs(got.numpy() - pallas).max()) <= HEAD_TOL


@pytest.mark.parametrize("case", ORDER_CASES[:2], ids=lambda c: "-".join(
    str(v) for v in c))
def test_dropped_segment_is_refused(case):
    """chip_smoke's planted fault, a merge without one segment's state
    (slot 1 of the first token tile that has two): loss and lse move by
    more than 4x HEAD_TOL."""
    N, D, V, sms, n_ign, amp, ydt = case
    x, w, y = _inputs(N, D, V, n_ign, amp, N + D + V)
    tx, tw = _tbf(x), _tbf(w)
    ty = torch.from_numpy(y.astype(ydt))
    ctas = tlm.fwd_bf16_plan(N, D, V, sms)["ctas"]
    drop = fault_segment(tlm, N, V, ctas)
    assert drop is not None
    floss, flse = segmented_fwd(tlm, tx, tw, ty, ctas, drop=drop)
    ploss, plse = tlm.lm_head_fwd_plain(tx, tw, ty)
    fault = max(float((floss - ploss).abs().max()),
                float((flse - plse).abs().max()))
    assert fault > 4 * HEAD_TOL


def test_fault_segment_at_the_training_shape():
    """On 132 SMs the fault drops the 8 vocab tiles (1024 columns) that
    CTA 1 takes of token tile 0."""
    ctas = tlm.fwd_bf16_plan(*TRAIN, SMS)["ctas"]
    assert fault_segment(tlm, TRAIN[0], TRAIN[2], ctas) == (0, 1)
    segs = tlm.fwd_bf16_segments(TRAIN[0], TRAIN[2], ctas)
    assert (1, 0, 242, 250, 1) in segs

"""The bf16 LM-head backward's wgmma path, as far as the CPU can hold it.

The wgmma kernels (csrc/wgmma_bf16.cuh, csrc/lm_head_bf16.cu) run only on
the card (tests/test_torch_cuda.py).  Here:

- the path choice, a pure function of the operands' addresses and row
  lengths (``bf16_path``): TMA needs 16-byte-aligned bases and rows of
  a multiple of 16 bytes, else the sync path;
- the plan the kernels run on 132 SMs (``bwd_bf16_plan``): each product's
  tile count and the dx product's K ranges, which must cover the
  vocabulary's k-tiles in ranges of the count the kernel's schedule
  (ptt_wg::sched) derives from them;
- the wgmma path's summation order, emulated in f32 at small sizes: dlogits
  rounded to bf16, dx the sum of its K ranges' products in range order
  rounded once a chunk, dW the f32 sum of the chunks' products rounded
  once.  The emulation is held to the JAX ``lm_head_xent`` backward (Pallas
  in interpret mode, as its own tests run it) and to ``lm_head_bwd_plain``
  at chip_smoke's BF16_RTOL of max |reference|;
- chip_smoke's planted fault for this compare (dlogits missing the onehot
  term in one vocab tile) is refused by more than 4x that tolerance.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_RTOL, FAULT_TILE, dropped_onehot_tile
from paddle_tpu_torch.kernels import lm_head as tlm

# the package re-exports a function under the module's name
jlm = importlib.import_module("paddle_tpu.kernels.lm_head")

SMS = 132   # the H100 SXM's SMs


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("x_ptr,w_ptr,D,V,want", [
    (0x7f0000000000, 0x7f0000100000, 512, 32000, "wgmma"),  # training
    (0x7f0000000000, 0x7f0000100000, 264, 4104, "wgmma"),   # ragged tiles
    (0x7f0000000000, 0x7f0000100000, 8, 8, "wgmma"),
    (0x7f0000000002, 0x7f0000100000, 512, 32000, "sync"),   # x off 16 B
    (0x7f0000000000, 0x7f0000100008, 512, 32000, "sync"),   # W off 16 B
    (0x7f0000000000, 0x7f0000100000, 201, 3000, "sync"),    # odd D
    (0x7f0000000000, 0x7f0000100000, 12, 100, "sync"),      # D 24 bytes
    (0x7f0000000000, 0x7f0000100000, 512, 1001, "sync"),    # odd V
    (0x7f0000000000, 0x7f0000100000, 512, 32004, "sync"),   # V 8 bytes off
])
def test_bwd_bf16_path_choice(x_ptr, w_ptr, D, V, want):
    assert tlm.bf16_path(x_ptr, w_ptr, D, V) == want


def test_bwd_bf16_path_of_real_tensors():
    """A slice one element in is 2 bytes off the storage's 16-byte
    alignment, and takes the sync path."""
    x = torch.zeros(4 * 512 + 1, dtype=torch.bfloat16)
    w = torch.zeros(512, 32000, dtype=torch.bfloat16)
    assert tlm.bf16_path(x.data_ptr(), w.data_ptr(), 512, 32000) \
        == "wgmma"
    assert tlm.bf16_path(x[1:].data_ptr(), w.data_ptr(), 512, 32000) \
        == "sync"


@pytest.mark.parametrize("cap,D,V,want", [
    # the training shape: 128 dx tiles nearly fill 132 SMs, one K range
    (4096, 512, 32000, dict(dlogits_tiles=8000, dx_tiles=128, dw_tiles=1000,
                            ranges=1, range_ktiles=500)),
    # chip_smoke's peaked case: 32 dx tiles, 4 ranges of 125 k-tiles
    (1024, 512, 32000, dict(dlogits_tiles=2000, dx_tiles=32, dw_tiles=1000,
                            ranges=4, range_ktiles=125)),
    # the ragged aligned case: 24 tiles, 5 ranges of 13 of 65 k-tiles
    (1000, 264, 4104, dict(dlogits_tiles=264, dx_tiles=24, dw_tiles=99,
                           ranges=5, range_ktiles=13)),
    # one dx tile: a range per k-tile
    (128, 64, 1000, dict(dlogits_tiles=8, dx_tiles=1, dw_tiles=8,
                         ranges=16, range_ktiles=1)),
])
def test_bwd_bf16_plan_on_132_sms(cap, D, V, want):
    assert tlm.bwd_bf16_plan(cap, D, V, SMS) == want


@pytest.mark.parametrize("cap", [1, 100, 128, 1000, 4096])
@pytest.mark.parametrize("D,V", [(8, 8), (64, 1000), (264, 4104),
                                 (512, 32000), (2048, 50264)])
def test_bwd_bf16_plan_ranges_cover_k(cap, D, V):
    """The ranges cover every k-tile, none empty, in the count that the
    kernel's schedule derives from the range count it is given."""
    p = tlm.bwd_bf16_plan(cap, D, V, SMS)
    kt = _cdiv(V, tlm.WG_KTILE)
    per, n = p["range_ktiles"], p["ranges"]
    assert 1 <= n <= kt and (n - 1) * per < kt <= n * per
    assert _cdiv(kt, _cdiv(kt, n)) == n and _cdiv(kt, n) == per
    assert n == 1 or p["dx_tiles"] * n <= SMS


def wgmma_order_bwd(x, w, labels, lse, g, chunk, sms=SMS):
    """(dx, dW) bf16 in the wgmma path's order, in f32 on the CPU: per
    chunk, dlogits rounded to bf16; dx the f32 sum, in range order, of each
    K range's product, rounded to bf16; dW summed in f32 chunk by chunk
    and rounded once."""
    N, D = x.shape
    V = w.shape[1]
    plan = tlm.bwd_bf16_plan(min(chunk, N), D, V, sms)
    span = plan["range_ktiles"] * tlm.WG_KTILE
    xf, wf = x.float(), w.float()
    y = labels.long()
    gm = g.float() * (y >= 0).float()
    dx = torch.empty(N, D, dtype=torch.bfloat16)
    dw = torch.zeros(D, V)
    for r0 in range(0, N, chunk):
        sl = slice(r0, min(r0 + chunk, N))
        dl = torch.exp(xf[sl] @ wf - lse[sl][:, None])
        rows = torch.arange(dl.shape[0])
        dl[rows, y[sl].clamp(min=0)] -= (y[sl] >= 0).float()
        dl = (dl * gm[sl, None]).to(torch.bfloat16).float()
        acc = torch.zeros(dl.shape[0], D)
        for k0 in range(0, V, span):
            acc += dl[:, k0:k0 + span] @ wf[:, k0:k0 + span].t()
        dx[sl] = acc.to(torch.bfloat16)
        dw += xf[sl].t() @ dl
    return dx, dw.to(torch.bfloat16)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def _inputs(N, D, V, n_ign, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype("float32")
    w = (rng.randn(D, V) * 0.2).astype("float32")
    y = rng.randint(0, V, N).astype("int64")
    y[rng.choice(N, n_ign, replace=False)] = -1
    g = (rng.rand(N) / N).astype("float32")
    return x, w, y, g


def _tbf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


# (N, D, V, chunk, ignored labels, the plan's K ranges): D and V multiples
# of 8 (the wgmma path's shapes); the JAX side takes chunks of 128 (its
# chunks must divide N), which moves only its f32 sums' order
ORDER_CASES = [
    (384, 64, 1000, 100, 7, 16),     # ragged chunks and tiles
    (1024, 1024, 256, 1024, 0, 2),   # 64 dx tiles: 2 ranges of 2 k-tiles
    (1024, 2048, 256, 1024, 3, 1),   # 128 dx tiles: one range
]


@pytest.mark.parametrize("case", ORDER_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_wgmma_order_matches_pallas_and_plain(case):
    N, D, V, chunk, n_ign, ranges = case
    x, w, y, g = _inputs(N, D, V, n_ign, N + D + V)
    assert tlm.bwd_bf16_plan(min(chunk, N), D, V, SMS)["ranges"] == ranges
    tx, tw, ty = _tbf(x), _tbf(w), torch.from_numpy(y)
    _, tlse = tlm.lm_head_fwd_plain(tx, tw, ty)
    dx, dw = wgmma_order_bwd(tx, tw, ty, tlse, torch.from_numpy(g), chunk)
    pdx, pdw = tlm.lm_head_bwd_plain(tx, tw, ty, tlse, torch.from_numpy(g),
                                     chunk)
    _, vjp = jax.vjp(
        lambda a, b: jlm.lm_head_xent(a, b, jnp.asarray(y.astype("int32")),
                                      interpret=True, chunk=128),
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(w).astype(jnp.bfloat16))
    jdx, jdw = (np.asarray(t.astype(jnp.float32)) for t in vjp(
        jnp.asarray(g)))
    for got, plain, pallas in ((dx, pdx, jdx), (dw, pdw, jdw)):
        assert got.dtype == torch.bfloat16
        assert _rel(got.float().numpy(), plain.float().numpy()) <= BF16_RTOL
        assert _rel(got.float().numpy(), pallas) <= BF16_RTOL


def test_wgmma_order_of_ranges_moves_dx_by_f32_sums_only():
    """dx's K ranges are summed in f32 and rounded once: 16 ranges and one
    range over all of K agree within one bf16 step of the largest entry,
    and most entries carry the same bits."""
    N, D, V, chunk = 300, 64, 1000, 128
    x, w, y, g = _inputs(N, D, V, 0, 5)
    tx, tw, ty = _tbf(x), _tbf(w), torch.from_numpy(y)
    _, lse = tlm.lm_head_fwd_plain(tx, tw, ty)
    dx, _ = wgmma_order_bwd(tx, tw, ty, lse, torch.from_numpy(g), chunk)
    one, _ = wgmma_order_bwd(tx, tw, ty, lse, torch.from_numpy(g), chunk,
                             sms=1)   # one range
    assert tlm.bwd_bf16_plan(chunk, D, V, 1)["ranges"] == 1
    assert tlm.bwd_bf16_plan(chunk, D, V, SMS)["ranges"] == 16
    ranged_gap = (dx.float() - one.float()).abs().max()
    assert ranged_gap <= 2.0 ** -7 * one.float().abs().max()
    assert float((dx == one).float().mean()) >= 0.9


def test_dropped_onehot_tile_is_refused():
    """chip_smoke's planted fault, at a small size with labels in the
    faulty vocab tile: dx and dW move by more than 4x BF16_RTOL of max
    |plain|."""
    N, D, V, chunk = 256, 64, FAULT_TILE + 512, 128
    x, w, y, g = _inputs(N, D, V, 0, 11)
    y[:64] = FAULT_TILE + np.arange(64)
    tx, tw, ty = _tbf(x), _tbf(w), torch.from_numpy(y)
    tg = torch.from_numpy(g)
    _, lse = tlm.lm_head_fwd_plain(tx, tw, ty)
    pdx, pdw = tlm.lm_head_bwd_plain(tx, tw, ty, lse, tg, chunk)
    fdx, fdw = dropped_onehot_tile(tlm, tx, tw, ty, lse, tg, chunk)
    assert _rel(fdx.float(), pdx.float()) > 4 * BF16_RTOL
    assert _rel(fdw.float(), pdw.float()) > 4 * BF16_RTOL
    y[(y >= FAULT_TILE) & (y < FAULT_TILE + 128)] = 0
    # no label in the tile: the fault changes nothing
    ty = torch.from_numpy(y)
    _, lse = tlm.lm_head_fwd_plain(tx, tw, ty)
    pdx, pdw = tlm.lm_head_bwd_plain(tx, tw, ty, lse, tg, chunk)
    fdx, fdw = dropped_onehot_tile(tlm, tx, tw, ty, lse, tg, chunk)
    assert torch.equal(fdx, pdx) and torch.equal(fdw, pdw)

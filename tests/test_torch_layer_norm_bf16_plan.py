"""The layer norm on bf16 rows, as far as the CPU can hold its v16 path.

The v16 kernels (csrc/layer_norm.cu, ln_fwd_v16_tma_kernel and
ln_fwd_v16_row_kernel) run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here:

- the path choice (``bf16_path``), a pure function of the dtype, D and
  the addresses of x and y: 16-byte words need D % 8 == 0 and 16-byte
  aligned rows, else the scalar path;
- the grid (``bf16_plan``, ``bf16_rows``, ``bf16_words``): every row is
  taken by exactly one group (a consumer warp of the TMA form, or a CTA)
  and every 16-byte word of a row by exactly one lane of it, for N in
  (1, 31, 4095, 16384, 65537), every D from 8 to 8192 in steps of 8 and
  several (SMs, resident CTAs); the grid never exceeds the resident CTAs
  or the CTAs the rows need;
- the wrapper on CPU tensors takes the plain version, whatever the path.
The kernel's float order is not emulated here: only the card's compares
see it.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import layer_norm as tln

NS = (1, 31, 4095, 16384, 65537)
DS = range(8, tln.MAX_D + 1, 8)
# (SMs, resident CTAs an SM): the H100 SXM's 132 at several occupancies,
# and small cards
GRIDS = ((132, 8), (132, 3), (132, 1), (114, 16), (1, 1), (7, 2))


def _bf16(n, d, off=0):
    """An [n, d] bf16 CPU view `off` elements into a fresh buffer."""
    buf = torch.zeros(n * d + 8, dtype=torch.bfloat16)
    return buf[off:off + n * d].view(n, d)


@pytest.mark.parametrize("d,x_off,y_off,want", [
    (512, 0, 0, "v16"),        # the training rows
    (8, 0, 0, "v16"),
    (264, 0, 0, "v16"),        # a multiple of 8, not of 64
    (520, 0, 0, "v16"),
    (2048, 0, 0, "v16"),       # a CTA a row
    (8192, 0, 0, "v16"),
    (201, 0, 0, "scalar"),     # odd
    (4, 0, 0, "scalar"),       # under one 16-byte word
    (516, 0, 0, "scalar"),     # rows 8 bytes off
    (512, 1, 0, "scalar"),     # x 2 bytes off
    (512, 4, 0, "scalar"),     # x 8 bytes off
    (512, 0, 1, "scalar"),     # y 2 bytes off
    (512, 8, 8, "v16"),        # both 16 bytes in
])
def test_bf16_path_choice(d, x_off, y_off, want):
    x, y = _bf16(3, d, x_off), _bf16(3, d, y_off)
    assert x.data_ptr() % 16 == 2 * x_off % 16
    assert tln.bf16_path(x, y) == want


def test_bf16_path_refuses_other_dtypes():
    for dt in (torch.float32, torch.float16, torch.float64):
        x = torch.zeros(4, 512, dtype=dt)
        with pytest.raises(ValueError, match="bf16"):
            tln.bf16_path(x, x)


def test_bf16_plan_at_the_training_shape():
    plan = tln.bf16_plan(16384, 512, 132, 8)
    assert plan == dict(lanes=32, words_per_lane=2, warps_per_cta=5,
                        rows_per_cta=4, ctas=1056, sms=132, ctas_per_sm=8)
    # rows need 4096 CTAs of 4 rows; fewer resident: each CTA walks blocks
    assert tln.bf16_plan(16384, 512, 132, 64)["ctas"] == 4096
    wide = tln.bf16_plan(333, 2048, 132, 2)
    assert (wide["lanes"], wide["words_per_lane"], wide["warps_per_cta"],
            wide["rows_per_cta"], wide["ctas"]) == (256, 1, 8, 1, 264)
    assert tln.bf16_plan(7, 8192, 132, 1)["words_per_lane"] == 4


@pytest.mark.parametrize("n,d", [(0, 512), (4, 0), (4, 4), (4, 201),
                                 (4, 8200)])
def test_bf16_plan_refuses_what_v16_cannot_take(n, d):
    with pytest.raises(ValueError, match="no v16 plan"):
        tln.bf16_plan(n, d, 132, 8)


def _groups(plan):
    return plan["ctas"] * plan["rows_per_cta"]


@pytest.mark.parametrize("sms,ctas_per_sm", GRIDS)
def test_bf16_plan_takes_every_row_once(sms, ctas_per_sm):
    seen = set()
    for n in NS:
        for d in DS:
            plan = tln.bf16_plan(n, d, sms, ctas_per_sm)
            assert plan["ctas"] <= sms * ctas_per_sm
            assert plan["ctas"] <= -(-n // plan["rows_per_cta"])
            key = (n, plan["ctas"], plan["rows_per_cta"])
            if key in seen:   # the rows depend on no more
                continue
            seen.add(key)
            taken = np.zeros(n, dtype=np.int64)
            for grp in range(_groups(plan)):
                rows = tln.bf16_rows(plan, n, grp)
                assert rows.step == _groups(plan)
                taken[rows.start:n:rows.step] += 1
            assert (taken == 1).all(), (n, d, sms, ctas_per_sm)
            # every CTA has work: its first block starts below N
            assert tln.bf16_rows(plan, n, _groups(plan) - plan[
                "rows_per_cta"]).start < n


def test_bf16_plan_takes_every_word_once():
    seen = set()
    for d in DS:
        plan = tln.bf16_plan(4095, d, 132, 8)
        key = (plan["lanes"], plan["words_per_lane"], d // 8)
        assert plan["lanes"] == (32 if d <= tln.V16_WARP_MAX_D
                                 else tln.V16_ROW_THREADS)
        assert 1 <= plan["words_per_lane"] <= tln.V16_MAX_WORDS
        if key in seen:
            continue
        seen.add(key)
        words = [w for lane in range(plan["lanes"])
                 for w in tln.bf16_words(plan, d, lane)]
        assert sorted(words) == list(range(d // 8)), d
        # no lane's last word slot is idle in every lane: W is the fewest
        assert (plan["words_per_lane"] - 1) * plan["lanes"] < d // 8, d
        # neighbouring lanes take neighbouring words
        for lane in range(plan["lanes"] - 1):
            a = tln.bf16_words(plan, d, lane)
            b = tln.bf16_words(plan, d, lane + 1)
            assert all(y == x + 1 for x, y in zip(a, b))


def test_layer_norm_on_cpu_takes_the_plain_version_on_any_path():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, 264).astype("float32")).to(
        torch.bfloat16)
    g = torch.from_numpy(rng.randn(264).astype("float32"))
    b = torch.from_numpy(rng.randn(264).astype("float32"))
    before = (tln.layer_norm.launches, tln.layer_norm.launches_v16,
              tln.layer_norm.launches_scalar)
    want = tln.layer_norm_plain(x, g, b, 1e-5)
    for path in (None, "v16", "scalar"):
        got = tln.layer_norm(x, g, b, 1e-5, path=path)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    assert (tln.layer_norm.launches, tln.layer_norm.launches_v16,
            tln.layer_norm.launches_scalar) == before

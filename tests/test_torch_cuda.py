"""The port's CUDA kernels and its predictor on the card.

Run on a machine with a CUDA card (no JAX needed there):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Without a card every test skips; the card is looked for inside a fixture,
never at import.  This file imports only torch, numpy, pytest, the port
and the repo's chip_smoke.py (stdlib only at import).
"""
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_block as fb
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import lm_head as lmh
from paddle_tpu_torch.models import transformer as tr

pytestmark = pytest.mark.gpu

F32_TOL = 2e-4   # abs: the same f32 math, summed in another order
REL_TOL = 1e-4   # of max |plain|: sums over thousands of f32 products


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


@pytest.mark.parametrize("n,d,dtype,tol", [
    (16384, 512, torch.float32, F32_TOL),   # the training step's rows
    (4096, 512, torch.float32, F32_TOL),    # the serving path's rows
    (4095, 512, torch.float32, F32_TOL),
    (1, 1, torch.float32, F32_TOL),
    (333, 2048, torch.float32, F32_TOL),    # one CTA per row
    (4096, 512, torch.bfloat16, 2e-2),      # one bf16 rounding of |y| < 4
])
def test_layer_norm_kernel_matches_plain(cuda, n, d, dtype, tol):
    x = (_randn(cuda, n, d, seed=1) * 2 + 0.5).to(dtype)
    g, b = _randn(cuda, d, seed=2), _randn(cuda, d, seed=3)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, g, b, 1e-5)
    want = ln.layer_norm_plain(x, g, b, 1e-5)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == before + 1
    assert got[0].dtype == dtype
    for a, w in zip(got, want):
        assert (a.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("n,d,mu", [(n, d, mu) for n, d, mu, _ in
                                    chip_smoke.LN_BF16_CASES])
def test_layer_norm_bf16_v16_and_scalar_match_plain(cuda, n, d, mu):
    """bf16 rows on the path they choose (v16 for every case here: D a
    multiple of 8, fresh tensors) and forced onto the scalar path: y
    within LN_BF16_TOL, mean and rstd within LN_TOL of the plain version;
    two calls of each path give the same bits; the counters name the
    path of every call."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, g, b = chip_smoke.ln_bf16_inputs(
        lambda *s: torch.randn(*s, generator=gen, device=cuda), n, d, mu)
    want = ln.layer_norm_plain(x, g, b, 1e-5)
    assert ln.bf16_path(x, torch.empty_like(x)) == "v16"
    for path in (None, "scalar"):
        before = (ln.layer_norm.launches_v16, ln.layer_norm.launches_scalar)
        got = ln.layer_norm(x, g, b, 1e-5, path=path)
        again = ln.layer_norm(x, g, b, 1e-5, path=path)
        torch.cuda.synchronize()
        moved = (ln.layer_norm.launches_v16 - before[0],
                 ln.layer_norm.launches_scalar - before[1])
        assert moved == ((2, 0) if path is None else (0, 2))
        assert got[0].dtype == torch.bfloat16
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        assert (got[0].float() - want[0].float()).abs().max().item() \
            <= chip_smoke.LN_BF16_TOL
        for a, w in zip(got[1:], want[1:]):
            assert (a - w).abs().max().item() <= chip_smoke.LN_TOL


def test_layer_norm_bf16_scalar_for_what_v16_cannot_take(cuda):
    """D 201 and an x 2 bytes off 16-byte alignment take the scalar path
    with no v16 launch; v16 forced on them raises before any launch and
    moves no counter, and the C entry refuses them
    (cudaErrorInvalidValue); an unknown path, or a path for f32 rows,
    raises."""
    bf = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(14)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=cuda)

    fn = ln.layer_norm
    for d, off in ((201, 0), (512, 1)):
        x, g, b = chip_smoke.ln_bf16_inputs(rnd, 64 + off, d)
        x = x.view(-1)[off:off + 64 * d].view(64, d)
        before = (fn.launches, fn.launches_v16, fn.launches_scalar)
        with pytest.raises(ValueError, match="v16 path"):
            fn(x, g, b, 1e-5, path="v16")
        assert (fn.launches, fn.launches_v16, fn.launches_scalar) == before
        got = fn(x, g, b, 1e-5)
        want = ln.layer_norm_plain(x, g, b, 1e-5)
        torch.cuda.synchronize()
        assert (fn.launches_v16, fn.launches_scalar) == (before[1],
                                                          before[2] + 1)
        assert (got[0].float() - want[0].float()).abs().max().item() \
            <= chip_smoke.LN_BF16_TOL
        y, m, r = torch.empty_like(x), torch.empty(64, device=cuda), \
            torch.empty(64, device=cuda)
        err = ln._kernel("ptt_layer_norm_fwd_bf16")(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            m.data_ptr(), r.data_ptr(), 64, d, 1e-5, 1,
            torch.cuda.current_stream().cuda_stream)
        assert err == 1   # cudaErrorInvalidValue
    x = _randn(cuda, 8, 512, seed=18)
    g, b = _randn(cuda, 512, seed=19), _randn(cuda, 512, seed=20)
    with pytest.raises(ValueError, match="path"):
        fn(x.to(bf), g, b, 1e-5, path="tma")
    with pytest.raises(ValueError, match="path"):
        fn(x, g, b, 1e-5, path="scalar")


@pytest.mark.parametrize("n,d", sorted({(n, d) for n, d, _, _ in
                                        chip_smoke.LN_BF16_CASES}))
def test_layer_norm_bf16_plan_is_the_librarys(cuda, n, d):
    """The v16 grid in Python (bf16_plan), which the CPU tests hold, is
    the one the library launches on this card."""
    assert chip_smoke.ln_plan_drift(ln, n, d) == ""


@pytest.mark.parametrize("H,d,B,Tq,Tk,causal,kv_len", [
    (8, 64, 32, 512, 512, True, None),      # the training step's shape
    (8, 64, 8, 512, 512, True, None),       # the serving path's shape
    (8, 64, 2, 300, 300, False, 250),
    (8, 64, 2, 200, 333, False, None),
    (4, 128, 2, 300, 300, True, None),
    (2, 64, 1, 1, 1, True, None),
    (8, 64, 2, 65, 65, True, None),         # one query past a tile
])
def test_flash_kernel_matches_plain(cuda, H, d, B, Tq, Tk, causal, kv_len):
    q = _randn(cuda, H, d, B * Tq, seed=4)
    k = _randn(cuda, H, d, B * Tk, seed=5)
    v = _randn(cuda, H, d, B * Tk, seed=6)
    before = fa.flash_attention_hdt.launches
    got = fa.flash_attention_hdt(q, k, v, B, causal=causal, kv_len=kv_len)
    want = fa.flash_attention_hdt_plain(q, k, v, B, causal=causal,
                                        kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.flash_attention_hdt.launches == before + 1
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert (a - w).abs().max().item() <= F32_TOL


def test_flash_kernel_reads_strided_inputs(cuda):
    H, d, B, T = 4, 64, 3, 130
    q = _randn(cuda, H, B * T, d, seed=7).transpose(1, 2)
    k = _randn(cuda, H, d, B * T, seed=8)
    got = fa.flash_attention_hdt(q, k, k, B, causal=True)
    want = fa.flash_attention_hdt_plain(q.contiguous(), k, k, B,
                                        causal=True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert (a - w).abs().max().item() <= F32_TOL


def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    q = torch.zeros(2, 32, 64, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_hdt(q, q, q, 1)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention_hdt(q.half(), q.half(), q.half(), 1)
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="gamma"):
        ln.layer_norm(x, torch.ones(8, device=cuda, dtype=torch.float64),
                      torch.zeros(8, device=cuda), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm(torch.zeros(8, 4, device=cuda).t(),
                      torch.ones(8, device=cuda),
                      torch.zeros(8, device=cuda), 1e-5)


def test_predictor_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small LM (head dim 64, which the kernel takes) built and served
    by the port on CUDAPlace(0) against the same model dir on the CPU."""
    cfg = tr.TransformerConfig(src_vocab_size=256, max_length=72,
                               n_layer=2, n_head=2, d_model=128,
                               d_inner=256, dropout=0.0)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 5
    with ptt.program_guard(main, startup):
        _, _, logits = tr.build_lm_net(cfg, 72, is_test=True)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    ptt.io.save_inference_model(str(tmp_path), ["tokens"], [logits], exe,
                                main_program=main)
    toks = tr.make_fake_lm_batch(cfg, 3, 72, seed=2)["tokens"]
    n_ln, n_fa = ln.layer_norm.launches, fa.flash_attention_hdt.launches
    gpu, = create_predictor(AnalysisConfig(str(tmp_path))).run(
        {"tokens": toks})
    assert ln.layer_norm.launches - n_ln == 2 * cfg.n_layer + 1
    assert fa.flash_attention_hdt.launches - n_fa == cfg.n_layer
    cpu, = create_predictor(AnalysisConfig(str(tmp_path),
                                           use_gpu=False)).run(
        {"tokens": toks})
    assert np.isfinite(gpu).all()
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4,
                               atol=1e-4 * np.abs(cpu).max())


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("H,d,B,Tq,Tk,causal,kv_len", [
    (8, 64, 4, 512, 512, True, None),       # the training path's shape
    (8, 64, 2, 300, 300, False, 250),
    (8, 64, 2, 200, 333, False, None),
    (4, 128, 2, 300, 300, True, None),
    (2, 64, 1, 1, 1, True, None),
    (8, 64, 2, 65, 65, True, None),
])
def test_flash_bwd_kernel_matches_plain(cuda, H, d, B, Tq, Tk, causal,
                                        kv_len):
    q = _randn(cuda, H, d, B * Tq, seed=9)
    k = _randn(cuda, H, d, B * Tk, seed=10)
    v = _randn(cuda, H, d, B * Tk, seed=11)
    do = _randn(cuda, H, d, B * Tq, seed=12)
    o, lse = fa.flash_attention_hdt_plain(q, k, v, B, causal=causal,
                                          kv_len=kv_len)
    delta = (do * o).sum(1, keepdim=True)
    before = fa.flash_attention_hdt_bwd.launches
    got = fa.flash_attention_hdt_bwd(q, k, v, lse, delta, do, B,
                                     causal=causal, kv_len=kv_len)
    again = fa.flash_attention_hdt_bwd(q, k, v, lse, delta, do, B,
                                       causal=causal, kv_len=kv_len)
    want = fa.flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, B,
                                            causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.flash_attention_hdt_bwd.launches == before + 2
    # relative to the largest gradient: dq and dk vanish where one key is
    # all a query sees (ds = p * (do.v - do.o) = 0 up to rounding)
    scale = max(w.abs().max().item() for w in want)
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape
        assert torch.equal(a, b)               # deterministic: same bits
        assert (a - w).abs().max().item() <= REL_TOL * scale


def test_flash_autograd_on_the_card_takes_strided_inputs(cuda):
    """Through the autograd Function: a token-strided q (as a transposed
    view) and the token-strided do that autograd hands the backward."""
    H, d, B, T = 4, 64, 3, 130
    q = _randn(cuda, H, B * T, d, seed=13).transpose(1, 2).requires_grad_()
    k = _randn(cuda, H, d, B * T, seed=14).requires_grad_()
    v = _randn(cuda, H, d, B * T, seed=15).requires_grad_()
    wo = _randn(cuda, H * d, 32, seed=16)
    o, _ = fa.flash_attention_hdt(q, k, v, B, causal=True)
    out = o.reshape(H * d, B * T).t() @ wo
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    qc, kc, vc = (t.detach().cpu().contiguous().requires_grad_()
                  for t in (q, k, v))
    oc, _ = fa.flash_attention_hdt_plain(qc, kc, vc, B, causal=True)
    outc = oc.reshape(H * d, B * T).t() @ wo.cpu()
    want = torch.autograd.grad(outc.square().sum(), (qc, kc, vc))
    for a, w in zip(got, want):
        assert _rel_err(a.cpu(), w) <= REL_TOL


@pytest.mark.parametrize("N,D,V,chunk,n_ignored,amp,ydtype", [
    (4096, 512, 32000, 4096, 0, 1, torch.int64),   # one chunk of the path
    (1000, 512, 1001, 256, 37, 1, torch.int64),    # ragged N and V, 4 chunks
    (1, 8, 1, 4096, 0, 1, torch.int64),
    (777, 201, 3000, 300, 11, 1, torch.int32),     # odd D: 8-byte copies
    (5, 12, 100, 4096, 1, 1, torch.int64),         # below one tile
    (2048, 512, 32000, 1024, 5, 12, torch.int64),  # peaked, |logit| ~ 80
])
def test_lm_head_kernels_match_plain(cuda, N, D, V, chunk, n_ignored, amp,
                                     ydtype):
    x = _randn(cuda, N, D, seed=17) * amp
    w = _randn(cuda, D, V, seed=18) * 0.05
    g = torch.Generator(device=cuda).manual_seed(19)
    y = torch.randint(0, V, (N,), generator=g, device=cuda)
    y[torch.randperm(N, generator=g, device=cuda)[:n_ignored]] = -1
    y = y.to(ydtype)
    gl = torch.rand(N, generator=g, device=cuda) / N
    nf, nb = lmh.lm_head_fwd.launches, lmh.lm_head_bwd.launches
    loss, lse = lmh.lm_head_fwd(x, w, y)
    loss2, lse2 = lmh.lm_head_fwd(x, w, y)
    dx, dw = lmh.lm_head_bwd(x, w, y, lse, gl, chunk)
    dx2, dw2 = lmh.lm_head_bwd(x, w, y, lse, gl, chunk)
    ploss, plse = lmh.lm_head_fwd_plain(x, w, y)
    pdx, pdw = lmh.lm_head_bwd_plain(x, w, y, plse, gl, chunk)
    torch.cuda.synchronize()
    assert lmh.lm_head_fwd.launches == nf + 2
    assert lmh.lm_head_bwd.launches == nb + 2 * -(-N // chunk)
    assert (loss - ploss).abs().max().item() <= F32_TOL
    assert (lse - plse).abs().max().item() <= F32_TOL
    assert (loss[y < 0] == 0).all()
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert _rel_err(dx, pdx) <= REL_TOL
    assert _rel_err(dw, pdw) <= REL_TOL


def test_backward_wrappers_refuse_what_they_cannot_take(cuda):
    q = torch.zeros(2, 32, 64, device=cuda)
    lse = torch.zeros(2, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_hdt_bwd(q, q, q, lse, lse, q, 1)
    q = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention_hdt_bwd(q.double(), q, q, lse, lse, q, 1)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_hdt_bwd(q, q, q, lse[:, :, :10], lse, q, 1)
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 16, device=cuda)
    y = torch.zeros(4, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        lmh.lm_head_fwd(x.double(), w.double(), y)
    with pytest.raises(ValueError, match="contiguous"):
        lmh.lm_head_fwd(x, torch.zeros(16, 8, device=cuda).t(), y)
    with pytest.raises(ValueError, match="integer"):
        lmh.lm_head_fwd(x, w, y.float())
    with pytest.raises(RuntimeError, match="CUDA"):
        lmh.lm_head_fwd(x, w, y.cpu())


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step of the flagship training program at full width, L 2,
    batch 2, on CUDAPlace(0) and on the CPU (the plain versions) from the
    same weights: chip_smoke's check, which raises where the losses
    differ or where an @GRAD entry differs once the CPU takes the card's
    relu branches."""
    import chip_smoke
    chip_smoke.train_match(torch)


# --- the fuse-block slice ----------------------------------------------------

def _bthd(dev, B, H, T, d, seed, offset=0):
    """A [B, H, T, d] view of a [B, T, H*d] tensor (token stride H*d), as
    the fused block's recompute hands flash_attention; with offset 1 the
    view starts 1 float into its storage, not 16-byte aligned."""
    x = _randn(dev, B * T * H * d + offset, seed=seed)[offset:]
    return x.view(B, T, H, d).transpose(1, 2)


@pytest.mark.parametrize("B,H,T,Tk,d,causal,layout", [
    (4, 8, 512, 512, 64, True, "bthd"),      # the path's layout, B 4
    (2, 8, 300, 300, 64, False, "bhtd"),
    (2, 8, 200, 333, 64, False, "bthd"),
    (2, 4, 300, 300, 128, True, "bthd"),
    (1, 2, 1, 1, 64, True, "bhtd"),
    (2, 8, 65, 65, 64, True, "bthd"),
    (2, 8, 300, 300, 64, True, "bthd+1"),    # 4-byte staging
    (2, 4, 200, 333, 128, False, "bthd+1"),
])
def test_flash_bhtd_matches_plain_and_the_head_major_bits(
        cuda, B, H, T, Tk, d, causal, layout):
    """The [B, H, T, d] entry runs the head-major kernels through strides:
    against the plain versions, and the same bits as the head-major call
    on the same data (same kernels, same order of sums)."""
    def make(t, seed):
        if layout.startswith("bthd"):
            return _bthd(cuda, B, H, t, d, seed,
                         offset=1 if layout == "bthd+1" else 0)
        return _randn(cuda, B, H, t, d, seed=seed)

    q, k, v, do = make(T, 20), make(Tk, 21), make(Tk, 22), make(T, 23)
    nf, nb = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    o, lse = fa._launch_bhtd(q, k, v, causal, d ** -0.5)
    delta = (do * o).sum(-1)
    got = fa.flash_attention_bwd(q, k, v, lse, delta, do, causal)
    again = fa.flash_attention_bwd(q, k, v, lse, delta, do, causal)
    po, plse = fa.flash_attention_plain(q, k, v, causal)
    want = fa.flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)

    def hm(t):
        return t.permute(1, 3, 0, 2).reshape(H, d, -1)

    def rows(t):
        return t.permute(1, 0, 2).reshape(H, 1, -1).contiguous()

    oh, lseh = fa.flash_attention_hdt(hm(q), hm(k), hm(v), B, causal=causal)
    gh = fa.flash_attention_hdt_bwd(hm(q), hm(k), hm(v), rows(lse),
                                    rows(delta), hm(do), B, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (nf + 1, nb + 2)
    assert o.stride() == q.stride()             # o takes q's layout
    assert (o - po).abs().max().item() <= F32_TOL
    assert (lse - plse).abs().max().item() <= F32_TOL
    scale = max(w.abs().max().item() for w in want)
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape
        assert torch.equal(a, b)                # deterministic
        assert (a - w).abs().max().item() <= REL_TOL * scale
    assert torch.equal(hm(o), oh) and torch.equal(rows(lse), lseh)
    for a, b in zip(got, gh):
        assert torch.equal(hm(a), b)


@pytest.mark.parametrize("H,d,B,T,causal,kv_len", [
    (8, 64, 4, 512, True, None),
    (4, 128, 2, 300, False, 250),
])
def test_flash_kernels_on_a_peaked_softmax(cuda, H, d, B, T, causal,
                                           kv_len):
    """q and k times 4 (|s| up to ~80): the lo terms of the 3xTF32 split
    matter most here; forward and backward against the plain versions."""
    q = _randn(cuda, H, d, B * T, seed=24) * 4
    k = _randn(cuda, H, d, B * T, seed=25) * 4
    v = _randn(cuda, H, d, B * T, seed=26)
    do = _randn(cuda, H, d, B * T, seed=27)
    got = fa.flash_attention_hdt(q, k, v, B, causal=causal, kv_len=kv_len)
    want = fa.flash_attention_hdt_plain(q, k, v, B, causal=causal,
                                        kv_len=kv_len)
    o, lse = want
    delta = (do * o).sum(1, keepdim=True)
    gb = fa.flash_attention_hdt_bwd(q, k, v, lse, delta, do, B,
                                    causal=causal, kv_len=kv_len)
    wb = fa.flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, B,
                                          causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert (a - w).abs().max().item() <= F32_TOL
    scale = max(w.abs().max().item() for w in wb)
    for a, w in zip(gb, wb):
        assert (a - w).abs().max().item() <= REL_TOL * scale


def test_fused_attention_op_on_a_btE_input(cuda):
    """The op hands the kernel [B, H, T, d] views of [B, T, E] and gets o
    back in [B, T, E] with no copy; its gradients match the CPU's."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    B, T, E, H = 2, 130, 256, 4
    ins = {s: [_randn(cuda, B, T, E, seed=30 + i).requires_grad_()]
           for i, s in enumerate("QKV")}
    n = fa.flash_attention.launches
    out, = get_op_def("fused_attention").lower(
        LowerContext(0, cuda), ins, {"n_head": H, "causal": True})["Out"]
    assert fa.flash_attention.launches == n + 1
    assert out.shape == (B, T, E) and out.is_contiguous()
    cpu = {s: [t[0].detach().cpu().requires_grad_()] for s, t in ins.items()}
    ref, = get_op_def("fused_attention").lower(
        LowerContext(0, torch.device("cpu")), cpu,
        {"n_head": H, "causal": True})["Out"]
    assert _rel_err(out.detach().cpu(), ref.detach()) <= REL_TOL
    cot = _randn(cuda, B, T, E, seed=40)
    got = torch.autograd.grad(out, [t[0] for t in ins.values()], cot)
    want = torch.autograd.grad(ref, [t[0] for t in cpu.values()], cot.cpu())
    for a, w in zip(got, want):
        assert _rel_err(a.cpu(), w) <= REL_TOL


def _block_inputs(dev, B, T, D, F, seed, E=None, w1_scale=1.0):
    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(seed)
    return chip_smoke.block_inputs(
        lambda *s: torch.randn(*s, generator=g, device=dev), B, T, D, F, E,
        w1_scale)


@pytest.mark.parametrize("B,T,H,D,E,F,causal,w1_scale", [
    (4, 512, 8, 512, 512, 2048, True, 1.0),   # the path's widths at batch 4
    (2, 300, 8, 512, 512, 2048, False, 1.0),
    (2, 300, 4, 512, 512, 2048, True, 1.0),   # head dim 128
    (1, 1, 2, 128, 128, 64, True, 1.0),
    (2, 67, 2, 201, 128, 333, True, 1.0),     # odd D, F: 8-byte staging
    (2, 512, 8, 512, 512, 2048, True, 8.0),   # large W2 sums over K 2048
])
def test_block_kernel_matches_plain(cuda, B, T, H, D, E, F, causal,
                                    w1_scale):
    x, params = _block_inputs(cuda, B, T, D, F, seed=50, E=E,
                              w1_scale=w1_scale)
    n = fb.transformer_block.launches
    got = fb.transformer_block(x, params, H, causal)
    again = fb.transformer_block(x, params, H, causal)
    want = fb.transformer_block_plain(x, params, H, causal)
    torch.cuda.synchronize()
    assert fb.transformer_block.launches == n + 2
    assert _rel_err(got, want) <= REL_TOL
    assert torch.equal(got, again)


def test_block_backward_on_the_card_matches_the_cpu(cuda):
    """The recompute backward runs the [B, H, T, d] flash kernels on the
    card and the plain attention on the CPU."""
    x, params = _block_inputs(cuda, 2, 130, 128, 256, seed=60)
    ins = [t.clone().requires_grad_() for t in (x, *params)]
    nf, nb = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = fb.transformer_block(ins[0], tuple(ins[1:]), 2, True)
    cot = _randn(cuda, *out.shape, seed=61)
    got = torch.autograd.grad(out, ins, cot)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (nf + 1, nb + 1)
    cins = [t.detach().cpu().requires_grad_() for t in ins]
    cout = fb.transformer_block(cins[0], tuple(cins[1:]), 2, True)
    want = torch.autograd.grad(cout, cins, cot.cpu())
    for name, a, w in zip(("x",) + fb.PARAM_NAMES, got, want):
        assert _rel_err(a.cpu(), w) <= 1e-3, name


def test_fuse_block_wrappers_refuse_what_they_cannot_take(cuda):
    q = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_attention_bwd(q, q.cpu(), q, q[..., 0], q[..., 0], q)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q[..., 0].transpose(1, 2), q[..., 0],
                               q)
    x, params = _block_inputs(cuda, 1, 8, 128, 64, seed=70)
    with pytest.raises(ValueError, match="head dim"):
        fb.transformer_block(x, params, 4)                 # dh 32
    with pytest.raises(ValueError, match="f32"):
        fb.transformer_block(x.double(), tuple(p.double() for p in params),
                             2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fb.transformer_block(x, tuple(p.cpu() for p in params), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fb.transformer_block(x.transpose(1, 2).contiguous().transpose(1, 2),
                             params, 2)


def test_fused_training_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step of the fuse_block training program at full width,
    L 2, batch 2, on CUDAPlace(0) and on the CPU: chip_smoke's check,
    which raises where the losses differ or where an @GRAD entry differs
    once the CPU takes the card's relu branches inside the blocks."""
    import chip_smoke
    chip_smoke.train_match_fused(torch)


# --- the AMP slice: the bf16 kernels -----------------------------------------

def _bf16_tol():
    import chip_smoke
    return chip_smoke.BF16_RTOL


def _rel_max(got, want):
    """max |got - want| over max |want|, over several tensors."""
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    return err / max(float(b.float().abs().max()) for b in want)


@pytest.mark.parametrize("force", [None, "sync"])
@pytest.mark.parametrize("H,d,B,Tq,Tk,causal,kv_len,amp,path", [
    (8, 64, 4, 512, 512, True, None, 1, "wgmma"),   # the path's layout, B 4
    (8, 64, 2, 300, 300, False, 250, 1, "sync"),    # T no multiple of 8
    (8, 64, 2, 200, 333, False, None, 1, "sync"),
    (4, 128, 2, 300, 300, True, None, 1, "sync"),
    (8, 64, 2, 65, 65, True, None, 4, "sync"),
    (8, 64, 2, 304, 304, False, 250, 1, "wgmma"),
    (4, 128, 2, 296, 296, True, None, 4, "wgmma"),
    (8, 64, 2, 520, 520, True, None, 1, "wgmma"),   # a ragged tile
])
def test_bf16_flash_kernels_match_plain(cuda, H, d, B, Tq, Tk, causal,
                                        kv_len, amp, path, force):
    """The bf16 head-major forward and backward (each on the path its
    operands choose, or forced onto the sync path) against their plain
    versions in bf16, each output at chip_smoke's BF16_RTOL of the max
    |plain| of each head's 64-token tile (lse at the f32 tolerance), the
    same bits on two calls; the path counters name the path taken."""
    import chip_smoke
    bf = torch.bfloat16
    q = (_randn(cuda, H, d, B * Tq, seed=80) * amp).to(bf)
    k = (_randn(cuda, H, d, B * Tk, seed=81) * amp).to(bf)
    v = _randn(cuda, H, d, B * Tk, seed=82).to(bf)
    do = _randn(cuda, H, d, B * Tq, seed=83).to(bf)
    kw = dict(causal=causal, kv_len=kv_len)
    fwd = fa.flash_attention_hdt_bf16
    before = (fwd.launches_wgmma, fwd.launches_sync)
    o, lse = fwd(q, k, v, B, path=force, **kw)
    o2, _ = fwd(q, k, v, B, path=force, **kw)
    took = force or path
    assert (fwd.launches_wgmma - before[0], fwd.launches_sync - before[1]) \
        == ((2, 0) if took == "wgmma" else (0, 2))
    assert fa.fwd_bf16_path(q, k, v, o, batch=B) == path
    assert torch.equal(o, o2)
    po, plse = fa.flash_attention_hdt_plain(q, k, v, B, **kw)
    assert o.dtype == bf and lse.dtype == torch.float32
    assert chip_smoke.tile_rel_err([o], [po]) <= _bf16_tol()
    assert (lse - plse).abs().max().item() <= F32_TOL
    delta = (do.float() * po.float()).sum(1, keepdim=True)
    args = (q, k, v, plse, delta, do, B)
    bwd = fa.flash_attention_hdt_bwd_bf16
    before = (bwd.launches_wgmma, bwd.launches_sync)
    if force is None:   # the public entry chooses by dtype, then by shape
        got = fa.flash_attention_hdt_bwd(*args, **kw)
        again = fa.flash_attention_hdt_bwd(*args, **kw)
    else:
        got = bwd(*args, path=force, **kw)
        again = bwd(*args, path=force, **kw)
    want = fa.flash_attention_hdt_bwd_plain(*args, **kw)
    assert (bwd.launches_wgmma - before[0], bwd.launches_sync - before[1]) \
        == ((2, 0) if took == "wgmma" else (0, 2))
    assert fa.bwd_bf16_path(q, k, v, do, *got, plse, delta, batch=B) == path
    assert all(t.dtype == bf for t in got)
    assert chip_smoke.tile_rel_err(got, want) <= _bf16_tol()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("force", [None, "sync"])
@pytest.mark.parametrize("N,D,V,chunk,n_ignored,amp,path", [
    (4096, 512, 32000, 1024, 3, 1, "wgmma"),
    (1000, 512, 1001, 256, 37, 1, "sync"),     # element copies of W
    (777, 201, 3000, 300, 11, 1, "sync"),      # element copies of x
    (2048, 512, 32000, 1024, 5, 12, "wgmma"),  # a peaked softmax
    (3001, 264, 4104, 1000, 23, 1, "wgmma"),   # aligned, no tile multiple
    (1000, 1024, 4104, 256, 9, 1, "wgmma"),    # the forward streams x
])
def test_bf16_lm_head_kernels_match_plain(cuda, N, D, V, chunk, n_ignored,
                                          amp, path, force):
    """The bf16 LM head forward (loss and lse f32, at the f32 tolerance)
    and backward (dx and dW bf16, at BF16_RTOL of max |plain|), the same
    bits on two calls; both on the path their operands choose (path), and
    again forced onto the sync path, each counted apart."""
    bf = torch.bfloat16
    x = (_randn(cuda, N, D, seed=90) * amp).to(bf)
    w = (_randn(cuda, D, V, seed=91) * 0.05).to(bf)
    g = torch.Generator(device=cuda).manual_seed(92)
    y = torch.randint(0, V, (N,), generator=g, device=cuda)
    y[torch.randperm(N, generator=g, device=cuda)[:n_ignored]] = -1
    gl = torch.rand(N, generator=g, device=cuda) * (2.0 / N)
    assert lmh.bf16_path(x.data_ptr(), w.data_ptr(), D, V) == path
    took = force or path
    fwd = lmh.lm_head_fwd_bf16
    before = (fwd.launches_wgmma, fwd.launches_sync)
    if force is None:   # the public entry chooses by dtype, then by shape
        loss, lse = lmh.lm_head_fwd(x, w, y)
        loss2, lse2 = lmh.lm_head_fwd(x, w, y)
    else:
        loss, lse = fwd(x, w, y, path=force)
        loss2, lse2 = fwd(x, w, y, path=force)
    assert (fwd.launches_wgmma - before[0], fwd.launches_sync - before[1]) \
        == ((2, 0) if took == "wgmma" else (0, 2))
    ploss, plse = lmh.lm_head_fwd_plain(x, w, y)
    assert (loss - ploss).abs().max().item() <= F32_TOL
    assert (lse - plse).abs().max().item() <= F32_TOL
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    assert (loss[y < 0] == 0).all()
    bwd = lmh.lm_head_bwd_bf16
    before = (bwd.launches_wgmma, bwd.launches_sync)
    if force is None:   # the public entry chooses by dtype, then by shape
        got = lmh.lm_head_bwd(x, w, y, lse, gl, chunk)
        again = lmh.lm_head_bwd(x, w, y, lse, gl, chunk)
    else:
        got = bwd(x, w, y, lse, gl, chunk, path=force)
        again = bwd(x, w, y, lse, gl, chunk, path=force)
    want = lmh.lm_head_bwd_plain(x, w, y, plse, gl, chunk)
    chunks = 2 * -(-N // chunk)
    assert (bwd.launches_wgmma - before[0], bwd.launches_sync - before[1]) \
        == ((chunks, 0) if took == "wgmma" else (0, chunks))
    assert all(t.dtype == bf for t in got)
    assert max(_rel_max([a], [b]) for a, b in zip(got, want)) <= _bf16_tol()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bf16_lm_head_wgmma_path_refuses_misaligned_operands(cuda):
    """Asking for the wgmma path where TMA cannot describe the operands
    raises before any launch; nothing falls back to the sync path."""
    bf = torch.bfloat16
    x = _randn(cuda, 64, 201, seed=93).to(bf)
    w = _randn(cuda, 201, 300, seed=94).to(bf)
    y = torch.zeros(64, dtype=torch.int64, device=cuda)
    lse = torch.zeros(64, device=cuda)
    before = (lmh.lm_head_bwd_bf16.launches_wgmma,
              lmh.lm_head_bwd_bf16.launches_sync)
    with pytest.raises(ValueError, match="wgmma path"):
        lmh.lm_head_bwd_bf16(x, w, y, lse, lse, 64, path="wgmma")
    assert (lmh.lm_head_bwd_bf16.launches_wgmma,
            lmh.lm_head_bwd_bf16.launches_sync) == before


@pytest.mark.parametrize("N,D,V", sorted({c[:3] for c in
                                          chip_smoke.HEAD_BF16_CASES}))
def test_bf16_lm_head_fwd_plan_is_the_librarys(cuda, N, D, V):
    """The wgmma forward's schedule in Python (fwd_bf16_plan,
    fwd_bf16_segments), which the CPU tests and chip_smoke's segmented
    emulation and planted fault hold, is the one the library runs on this
    card: CTAs, slots, x resident, stages, each CTA's range, each
    segment's slot and the workspace size."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert chip_smoke.fwd_plan_drift(lmh, N, D, V, sms) == ""


def test_bf16_lm_head_fwd_wgmma_path_refuses_what_tma_cannot_describe(
        cuda):
    """Forcing the forward onto the wgmma path where TMA cannot describe
    the operands (x 2 bytes off alignment, an odd D) raises before any
    launch and moves no counter; path None takes sync.  The C entry
    refuses such operands too (cudaErrorInvalidValue)."""
    bf = torch.bfloat16
    raw = _randn(cuda, 64 * 512 + 1, seed=95).to(bf)
    w = _randn(cuda, 512, 304, seed=96).to(bf)
    odd_x = _randn(cuda, 64, 201, seed=97).to(bf)
    odd_w = _randn(cuda, 201, 304, seed=98).to(bf)
    y = torch.zeros(64, dtype=torch.int64, device=cuda)
    fwd = lmh.lm_head_fwd_bf16
    for x, ww in ((raw[1:].view(64, 512), w), (odd_x, odd_w)):
        before = (fwd.launches, fwd.launches_wgmma, fwd.launches_sync)
        with pytest.raises(ValueError, match="wgmma path"):
            fwd(x, ww, y, path="wgmma")
        assert (fwd.launches, fwd.launches_wgmma,
                fwd.launches_sync) == before
        fwd(x, ww, y)
        assert fwd.launches_sync == before[2] + 1
        out = torch.empty(2, 64, device=cuda)
        work = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
        err = lmh._fn("ptt_lm_head_fwd_bf16_wgmma")(
            x.data_ptr(), ww.data_ptr(), y.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), work.data_ptr(), 64, x.shape[1], ww.shape[1],
            torch.cuda.current_stream().cuda_stream)
        assert err == 1   # cudaErrorInvalidValue
    with pytest.raises(ValueError, match="path"):
        fwd(odd_x, odd_w, y, path="tma")


def test_bf16_flash_wgmma_path_refuses_what_tma_cannot_describe(cuda):
    """Forced onto the wgmma path, operands 2 bytes off alignment (or a
    head-major T no multiple of 8) make the C entry refuse the launch: the
    wrapper raises and no counter moves; path None takes sync."""
    bf = torch.bfloat16
    x = _randn(cuda, 8 * 64 * 2 * 256 + 1, seed=84).to(bf)
    q = x[1:].view(8, 64, 2 * 256)
    k = _randn(cuda, 8, 64, 2 * 256, seed=85).to(bf)
    r = _randn(cuda, 8, 64, 2 * 300, seed=86).to(bf)
    fwd = fa.flash_attention_hdt_bf16
    for args in ((q, k, k), (r, r, r)):
        before = (fwd.launches, fwd.launches_wgmma, fwd.launches_sync)
        with pytest.raises(RuntimeError, match="wgmma"):
            fwd(*args, 2, causal=True, path="wgmma")
        assert (fwd.launches, fwd.launches_wgmma,
                fwd.launches_sync) == before
        fwd(*args, 2, causal=True)
        assert fwd.launches_sync == before[2] + 1
    with pytest.raises(ValueError, match="path"):
        fwd(k, k, k, 2, path="tma")


def test_bf16_flash_bwd_wgmma_path_refuses_what_tma_cannot_describe(cuda):
    """Forced onto the wgmma path, a backward whose q is 2 bytes off
    alignment, whose head-major T is no multiple of 8, or whose q, k and v
    lie in two orientations makes the C entry refuse the launch: the
    wrapper raises and no counter moves; path None takes sync."""
    bf = torch.bfloat16
    x = _randn(cuda, 8 * 64 * 2 * 256 + 1, seed=87).to(bf)
    q = x[1:].view(8, 64, 2 * 256)
    k = _randn(cuda, 8, 64, 2 * 256, seed=88).to(bf)
    qt = _randn(cuda, 8, 2 * 256, 64, seed=89).to(bf).transpose(1, 2)
    r = _randn(cuda, 8, 64, 2 * 300, seed=90).to(bf)
    bwd = fa.flash_attention_hdt_bwd_bf16
    for args in ((q, k, k, k), (r, r, r, r), (qt, k, k, k)):
        N = args[0].shape[2]
        lse = torch.zeros(8, 1, N, device=cuda)
        full = (*args[:3], lse, lse, args[3], 2)
        before = (bwd.launches, bwd.launches_wgmma, bwd.launches_sync)
        with pytest.raises(RuntimeError, match="wgmma"):
            bwd(*full, causal=True, path="wgmma")
        assert (bwd.launches, bwd.launches_wgmma,
                bwd.launches_sync) == before
        bwd(*full, causal=True)
        assert bwd.launches_sync == before[2] + 1
    with pytest.raises(ValueError, match="path"):
        bwd(k, k, k, lse, lse, k, 2, path="tma")


def test_bf16_wrappers_refuse_what_they_cannot_take(cuda):
    """fp16 and mixed dtypes raise on the card; nothing falls back to the
    plain version."""
    q = torch.zeros(2, 64, 64, device=cuda)
    lse = torch.zeros(2, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention_hdt(q.half(), q.half(), q.half(), 1)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention_hdt(q.bfloat16(), q, q, 1)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention_hdt_bwd(q.half(), q.half(), q.half(), lse, lse,
                                   q.half(), 1)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention_hdt_bwd(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                                   lse.bfloat16(), lse, q.bfloat16(), 1)
    b4 = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention(b4.half(), b4.half(), b4.half())
    with pytest.raises(ValueError, match="f32"):
        fa.flash_attention(b4, b4.float(), b4)
    x, params = _block_inputs(cuda, 1, 8, 128, 64, seed=71)
    with pytest.raises(ValueError, match="bf16"):
        fb.transformer_block(x.half(), tuple(p.half() for p in params), 2)
    with pytest.raises(ValueError, match="bf16"):
        fb.transformer_block(x.bfloat16(), params, 2)      # f32 matrices
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 16, device=cuda)
    y = torch.zeros(4, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        lmh.lm_head_fwd(x.half(), w.half(), y)
    with pytest.raises(ValueError, match="f32"):
        lmh.lm_head_fwd(x.bfloat16(), w, y)


def test_amp_training_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step of the flagship training program under FLAGS_amp_bf16
    at full width, L 2, batch 2, on CUDAPlace(0) and on the CPU (the bf16
    plain versions): chip_smoke's check at its AMP tolerances."""
    import chip_smoke
    with chip_smoke.amp_bf16():
        chip_smoke.train_match(torch, amp=True)


# --- the AMP fuse_block slice: the bf16 [B, H, T, d] flash and block ---------

def _bhtd_bf16(dev, B, H, T, d, seed, layout, mul=1.0):
    """bf16 [B, H, T, d]: contiguous, the block's [B, T, H, d] view, or
    that view 2 bytes off 16-byte alignment."""
    bf = torch.bfloat16
    if layout == "bhtd":
        return (_randn(dev, B, H, T, d, seed=seed) * mul).to(bf)
    x = (_randn(dev, B * T * H * d + 1, seed=seed) * mul).to(bf)
    x = x[1:] if layout == "bthd+1" else x[:-1]
    return x.view(B, T, H, d).transpose(1, 2)


@pytest.mark.parametrize("force", [None, "sync"])
@pytest.mark.parametrize("B,H,T,Tk,d,causal,layout,amp,path", [
    (4, 8, 512, 512, 64, True, "bthd", 1, "wgmma"),   # the path's layout
    (2, 8, 300, 300, 64, False, "bhtd", 1, "wgmma"),
    (2, 8, 200, 333, 64, False, "bthd", 1, "wgmma"),
    (2, 4, 300, 300, 128, True, "bthd", 1, "wgmma"),
    (2, 8, 300, 300, 64, True, "bthd+1", 1, "sync"),   # element copies
    (2, 8, 65, 65, 64, True, "bthd", 4, "wgmma"),      # a peaked softmax
    (2, 8, 256, 256, 64, True, "bthd:do-t1", 1, "wgmma"),   # do token 1
])
def test_bf16_bhtd_flash_kernels_match_plain(cuda, B, H, T, Tk, d, causal,
                                             layout, amp, path, force):
    """The bf16 [B, H, T, d] forward and backward (each on the path its
    operands choose, or forced onto the sync path) against their plain
    versions in bf16 at chip_smoke's BF16_RTOL by tile (lse at the f32
    tolerance), the same bits on two calls, and against the head-major
    bf16 call on the same data: its bits wherever both calls take one
    path, within BF16_RTOL by tile where their choices cross."""
    import chip_smoke
    base, _, do_layout = layout.partition(":")
    q = _bhtd_bf16(cuda, B, H, T, d, 100, base, amp)
    k = _bhtd_bf16(cuda, B, H, Tk, d, 101, base, amp)
    v = _bhtd_bf16(cuda, B, H, Tk, d, 102, base)
    if do_layout == "do-t1":   # the rows of a [H d, B T] gradient
        do = _randn(cuda, H * d, B * T, seed=103).to(torch.bfloat16).view(
            H, d, B, T).permute(2, 0, 3, 1)
    else:
        do = _bhtd_bf16(cuda, B, H, T, d, 103, base)
    fwd, bwd = fa.flash_attention_bf16, fa.flash_attention_bwd_bf16
    before = (fwd.launches, bwd.launches, bwd.launches_wgmma,
              bwd.launches_sync)
    o, lse = fwd(q, k, v, causal, path=force)
    po, plse = fa.flash_attention_plain(q, k, v, causal)
    hm = chip_smoke.head_major
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert chip_smoke.tile_rel_err([hm(o)], [hm(po)]) <= _bf16_tol()
    assert (lse - plse).abs().max().item() <= F32_TOL
    delta = (do.float() * po.float()).sum(-1)
    args = (q, k, v, plse, delta, do, causal)
    got = bwd(*args, path=force)
    again = bwd(*args, path=force)
    want = fa.flash_attention_bwd_plain(*args)
    took = force or path
    assert fa.bwd_bf16_path(q, k, v, do, *got, plse, delta) == path
    assert chip_smoke.tile_rel_err([hm(t) for t in got],
                                   [hm(t) for t in want]) <= _bf16_tol()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (fwd.launches, bwd.launches, bwd.launches_wgmma - before[2],
            bwd.launches_sync - before[3]) == (
        before[0] + 1, before[1] + 2, 2 * (took == "wgmma"),
        2 * (took == "sync"))
    # the head-major call on a copy: the same bits on the same path; where
    # the copy takes the other path (its T no multiple of 8), within
    # BF16_RTOL by tile
    oh, _ = fa.flash_attention_hdt_bf16(hm(q), hm(k), hm(v), B,
                                        causal=causal, path=force)
    lh = plse.permute(1, 0, 2).reshape(H, 1, B * T).contiguous()
    dh = delta.permute(1, 0, 2).reshape(H, 1, B * T).contiguous()
    gh = fa.flash_attention_hdt_bwd_bf16(hm(q), hm(k), hm(v), lh, dh, hm(do),
                                         B, causal=causal, path=force)
    took_fh = force or fa.fwd_bf16_path(hm(q), hm(k), hm(v), oh, batch=B)
    took_bh = force or fa.bwd_bf16_path(hm(q), hm(k), hm(v), hm(do), *gh,
                                        lh, dh, batch=B)
    if (force or fa.fwd_bf16_path(q, k, v, o)) == took_fh:
        assert torch.equal(hm(o), oh)
    else:
        assert chip_smoke.tile_rel_err([hm(o)], [oh]) <= _bf16_tol()
    if took == took_bh:
        assert all(torch.equal(hm(a), b) for a, b in zip(got, gh))
    else:
        assert chip_smoke.tile_rel_err([hm(t) for t in got],
                                       gh) <= _bf16_tol()


@pytest.mark.parametrize("force", [None, "sync"])
@pytest.mark.parametrize("B,T,H,D,E,F,causal,w1_scale,vectors", [
    (4, 512, 8, 512, 512, 2048, True, 1.0, "f32"),   # the path's widths
    (2, 300, 8, 512, 512, 2048, False, 1.0, "f32"),
    (2, 300, 4, 512, 512, 2048, True, 1.0, "f32"),   # head dim 128
    (2, 300, 3, 264, 192, 520, True, 1.0, "f32"),    # wgmma, ragged tiles
    (2, 67, 2, 201, 128, 333, True, 1.0, "bf16"),    # element copies
    (2, 512, 8, 512, 512, 2048, True, 8.0, "f32"),   # large W2 sums
])
def test_bf16_block_kernel_matches_plain(cuda, B, T, H, D, E, F, causal,
                                         w1_scale, vectors, force):
    """The bf16 block kernel, its GEMMs on the path its operands choose
    (wgmma where D, E and F are multiples of 8) or forced onto sync,
    against its plain version in bf16 at chip_smoke's BLOCK_BF16_RTOL of
    max |plain|, the same bits twice, one count a call by path."""
    import chip_smoke
    x, params = _block_inputs(cuda, B, T, D, F, seed=110, E=E,
                              w1_scale=w1_scale)
    x = x.to(torch.bfloat16)
    params = chip_smoke.bf16_block_params(params, vectors)
    blk = fb.transformer_block_bf16
    took = force or ("wgmma" if all(n % 8 == 0 for n in (D, E, F))
                     else "sync")
    before = (blk.launches, blk.launches_flash_wgmma,
              blk.launches_gemm_wgmma, blk.launches_gemm_sync)
    if force is None:
        got = fb.transformer_block(x, params, H, causal)
    else:
        got = blk(x, params, H, causal, gemm_path=force)
    again = blk(x, params, H, causal, gemm_path=force)
    want = fb.transformer_block_plain(x, params, H, causal)
    # its flash launch on the wgmma path (the q, k, v views of its qkv)
    assert (blk.launches, blk.launches_flash_wgmma,
            blk.launches_gemm_wgmma, blk.launches_gemm_sync) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * (took == "wgmma"),
        before[3] + 2 * (took == "sync"))
    assert got.dtype == torch.bfloat16
    assert _rel_max([got], [want]) <= chip_smoke.BLOCK_BF16_RTOL
    assert torch.equal(got, again)


def test_bf16_block_gemm_wgmma_path_refuses_what_tma_cannot_describe(cuda):
    """Forcing the wgmma GEMMs on operands TMA cannot describe raises
    before any launch and moves no counter: D and F not multiples of 8, x
    2 bytes off 16-byte alignment; the C entry itself refuses odd D with
    cudaErrorInvalidValue (1)."""
    import chip_smoke
    blk = fb.transformer_block_bf16
    x, params = _block_inputs(cuda, 2, 67, 201, 333, seed=111, E=128)
    odd = (x.to(torch.bfloat16), chip_smoke.bf16_block_params(params), 2)
    x, params = _block_inputs(cuda, 2, 64, 512, 2048, seed=112)
    flat = torch.zeros(2 * 64 * 512 + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = x.to(torch.bfloat16).reshape(-1)
    shifted = (flat[1:].view(2, 64, 512),
               chip_smoke.bf16_block_params(params), 8)
    for xb, pb, H in (odd, shifted):
        before = (blk.launches, blk.launches_gemm_wgmma,
                  blk.launches_gemm_sync)
        with pytest.raises(ValueError, match="wgmma GEMM path"):
            blk(xb, pb, H, True, gemm_path="wgmma")
        with pytest.raises(ValueError, match="no GEMM path"):
            blk(xb, pb, H, True, gemm_path="tma")
        assert (blk.launches, blk.launches_gemm_wgmma,
                blk.launches_gemm_sync) == before
    # the C entry, given a valid flash path and gemm_path 1 on D 201
    xb, pb, _ = odd
    B, T, D = xb.shape
    E, F = pb[2].shape[1], pb[8].shape[1]
    out = torch.empty_like(xb)
    work = torch.empty(fb._kernel("ptt_transformer_block_bf16_fwd_workspace")(
        B, T, D, E, F, 2), dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()
    err = fb._kernel("ptt_transformer_block_bf16_fwd")(
        *(t.data_ptr() for t in (xb,) + pb), out.data_ptr(),
        work.data_ptr(), B, T, D, E, F, 2, 1, 1e-5, 1e-5, 0, 1,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1


@pytest.mark.parametrize("B,T,D,E,F", [
    (32, 512, 512, 512, 2048), (2, 300, 264, 192, 520),
    (2, 300, 512, 512, 2048), (1, 8, 64, 64, 128)])
def test_bf16_block_gemm_plan_is_the_librarys(cuda, B, T, D, E, F):
    """fused_block.block_gemm_plan, which the CPU tests hold, is the
    library's plan of each of the four launches on this card."""
    import chip_smoke
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert chip_smoke.block_plan_drift(fb, B, T, D, E, F, sms) == ""


def test_amp_fused_training_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step of the fuse_block training program under
    FLAGS_amp_bf16 at full width, L 2, batch 2, on CUDAPlace(0) and on the
    CPU: chip_smoke's check at its AMP tolerances, the card's relu masks
    replayed inside the blocks."""
    import chip_smoke
    with chip_smoke.amp_bf16():
        chip_smoke.train_match_fused(torch, amp=True)


def _decode_lm():
    """A tiny unfused LM (the CPU serving tests' widths, head dim 8)
    initialised on the CPU: (cfg, role-keyed params)."""
    from paddle_tpu_torch import serving
    cfg = tr.TransformerConfig(src_vocab_size=97, max_length=32, n_layer=2,
                               n_head=2, d_model=16, d_inner=32,
                               dropout=0.0)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 3
    with ptt.program_guard(main, startup):
        tr.build_lm_net(cfg, 24, is_test=True, fused_attention=False)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    return cfg, serving.extract_lm_params(main, exe.scope, cfg)


def _decode(engine, prompts, n_new, temps=None):
    gen = {s: [engine.start_sequence(s, p, (temps or {}).get(s, 0.0))]
           for s, p in enumerate(prompts)}
    for _ in range(n_new - 1):
        for s, t in engine.decode_step().items():
            gen[s].append(t)
    return [gen[s] for s in range(len(prompts))]


def test_decode_engine_captures_replays_and_resets(cuda):
    """prepare() captures a graph per bucket and one for the step; the
    replays give the CPU engine's greedy tokens on the same weights;
    reset() zeros the slabs in place (same storage, so the graphs stay
    valid) and a second run gives the same tokens."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.observability import metrics as obs_metrics
    cfg, params = _decode_lm()
    kw = dict(max_batch=4, max_len=32, prompt_buckets=(8, 16))
    gpu = serving.DecodeEngine(cfg, params, place=ptt.CUDAPlace(0), **kw)
    cpu = serving.DecodeEngine(cfg, params, place=ptt.CPUPlace(), **kw)
    m = obs_metrics.REGISTRY.get("serving_compiles_total")
    before = m.total() if m is not None else 0.0
    gpu.prepare()
    cpu.prepare()
    assert obs_metrics.REGISTRY.get("serving_compiles_total").total() \
        == before + 6
    assert gpu.device.type == "cuda"
    assert isinstance(gpu._step.graph, torch.cuda.CUDAGraph)
    assert all(isinstance(run.graph, torch.cuda.CUDAGraph)
               for _, run in gpu._prefill.values())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 97, n).tolist() for n in (5, 8, 13, 16)]
    want = _decode(cpu, prompts, 6)
    slab = gpu._kv_k.data_ptr()
    assert _decode(gpu, prompts, 6) == want
    gpu.reset()
    assert gpu._kv_k.data_ptr() == slab
    assert float(gpu._kv_k.abs().max()) == 0.0
    assert _decode(gpu, prompts, 6) == want
    # sampling slots beside greedy ones, on the engine's generator
    gpu.reset()
    mixed = _decode(gpu, prompts, 6, temps={1: 1.0, 3: 0.7})
    assert mixed[0] == want[0] and mixed[2] == want[2]
    assert all(0 <= t < 97 for seq in mixed for t in seq)


def test_decode_step_before_prepare_raises_on_the_card(cuda):
    from paddle_tpu_torch import serving
    cfg, params = _decode_lm()
    e = serving.DecodeEngine(cfg, params, max_batch=2, max_len=32,
                             prompt_buckets=(8,), place=ptt.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="prepare"):
        e.decode_step()
    with pytest.raises(ValueError, match="not prepared"):
        e.start_sequence(0, [1, 2, 3])


def test_predictor_readback_survives_the_next_run(cuda, tmp_path):
    """The card's logits come back through pinned host memory; the array
    a run returns is not overwritten by a later run."""
    cfg = tr.TransformerConfig(src_vocab_size=256, max_length=72,
                               n_layer=1, n_head=2, d_model=128,
                               d_inner=256, dropout=0.0)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 5
    with ptt.program_guard(main, startup):
        _, _, logits = tr.build_lm_net(cfg, 72, is_test=True)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    ptt.io.save_inference_model(str(tmp_path), ["tokens"], [logits], exe,
                                main_program=main)
    p = create_predictor(AnalysisConfig(str(tmp_path)))
    a, = p.run({"tokens": tr.make_fake_lm_batch(cfg, 2, 72, 1)["tokens"]})
    kept = a.copy()
    b, = p.run({"tokens": tr.make_fake_lm_batch(cfg, 2, 72, 2)["tokens"]})
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, kept)
    assert isinstance(a.base, torch.Tensor) and a.base.is_pinned()


# --- the training loops: run_steps, accumulation, the Trainer ---------------

def _loops_cfg(dropout):
    return tr.TransformerConfig(src_vocab_size=1000, max_length=128,
                                n_layer=2, n_head=2, d_model=128,
                                d_inner=256, dropout=dropout)


@pytest.mark.parametrize("amp", [False, True])
def test_run_steps_on_the_card_matches_sequential_runs(cuda, amp):
    """chip_smoke's run_steps check at L 2, head dim 64, batch 2, T 128,
    3 steps (f32, and under AMP as bench.py's row runs): the stacked
    losses and the final state against 3 runs from the same state, and
    every launch counter 3 times one run's."""
    res = chip_smoke.run_steps_match(torch, _loops_cfg(0.0), 2, 3, amp=amp,
                                     T=128)
    flash = "flash_attention_hdt_bf16" if amp else "flash_attention_hdt"
    assert res["counts"][(flash, "launches")] == 3 * 2
    assert res["counts"][("layer_norm", "launches")] == 3 * 5


def test_trainer_accumulates_to_the_boundary_on_the_card(cuda):
    """chip_smoke's Trainer check on the unfused build with dropout 0.1,
    accumulate_steps 2, prefetch depth 2, 4 micro-batches of 2 x 128:
    params frozen until each boundary, the counter 1, 0, 1, 0, the
    kernels' launches per micro-step."""
    res = chip_smoke.trainer_boundary(torch, _loops_cfg(0.1), 2, 4, 2, 2,
                                      T=128)
    assert res["counts"][("layer_norm", "launches")] == 4 * 5
    assert 0.8 < res["keep"] < 1.0


# --- int8 and fp8: the library products and the frozen programs -------------

@pytest.mark.parametrize("qd", ["int8", "e4m3", "e5m2"])
@pytest.mark.parametrize("xs,ys", [((16384, 512), (512, 2048)),
                                   ((5, 13), (13, 3)),
                                   ((2, 3, 9, 20), (2, 3, 20, 7))])
def test_low_precision_products_match_plain_on_the_card(cuda, qd, xs, ys):
    """torch._int_mm / _scaled_mm / the bf16 product through the padding
    and the batch loop against the plain version on the card (f64 for
    int8: equal) and on the CPU, and the codes of the same inputs equal
    on both devices."""
    from paddle_tpu_torch.ops import quantize_ops as qo
    x, y = _randn(cuda, *xs, seed=60), _randn(cuda, *ys, seed=61)
    xq = qo.quantize_array(x, x.abs().max(), qd)
    yq = qo.quantize_array(y, y.abs().amax(0, keepdim=True), qd)
    xc = qo.quantize_array(x.cpu(), x.abs().max().cpu(), qd)
    raw = (lambda t: t.view(torch.uint8)) if qd != "int8" else (lambda t: t)
    assert torch.equal(raw(xq).cpu(), raw(xc))
    route = {"int8": "int_mm", "e4m3": "scaled_mm", "e5m2": "bf16_mm"}[qd]
    before = qo.lp_product.launches[route]
    acc = qo.lp_product(xq, yq, qd)
    n = int(np.prod(xs[:-2])) if len(ys) > 2 else 1
    assert qo.lp_product.launches[route] - before == n
    plain = qo.lp_product_plain(xq, yq, qd)
    cpu = qo.lp_product_plain(xq.cpu(), yq.cpu(), qd)
    if qd == "int8":
        assert acc.dtype == torch.int32
        assert torch.equal(acc, plain) and torch.equal(acc.cpu(), cpu)
    else:
        tol = chip_smoke.FP8_RTOL[qd]
        assert _rel_err(acc.double(), plain.double()) <= tol
        assert _rel_err(acc.cpu().double(), cpu.double()) <= tol


@pytest.mark.parametrize("qd", ["int8", "e4m3"])
@pytest.mark.parametrize("case", ["stem", "1x1_s2", "grouped", "dilated",
                                  "depthwise"])
def test_quantized_conv2d_lowering_matches_plain_on_the_card(cuda, qd, case):
    """The im2col lowering at chip_smoke's QUANT_CONVS shapes (the stem
    and the downsample at batch 2) against F.conv2d of the same codes in
    f64 on the card."""
    from paddle_tpu_torch.ops import quantize_ops as qo
    _, C, H, W, O, k, s, p, d, g = chip_smoke.QUANT_CONVS[case]
    x = _randn(cuda, 2, C, H, W, seed=62)
    w = _randn(cuda, O, C // g, k, k, seed=63)
    xq = qo.quantize_array(x, x.abs().max(), qd)
    wq = qo.quantize_array(w, qo.channel_scales(w, 0).reshape(-1, 1, 1, 1),
                           qd)
    geo = ((s, s), (p, p), (d, d), g)
    acc = qo.lp_conv2d(xq, wq, qd, *geo)
    plain = qo.lp_conv2d_plain(xq, wq, qd, *geo)
    assert acc.shape == plain.shape
    if qd == "int8":
        assert torch.equal(acc, plain)
    else:
        assert _rel_err(acc.double(), plain.double()) <= \
            chip_smoke.FP8_RTOL[qd]


@pytest.mark.parametrize("qd", ["int8", "e4m3"])
def test_frozen_program_on_the_card_matches_the_cpu(cuda, qd, tmp_path):
    """A small conv + fc QAT net trained on the card, frozen to `qd`,
    saved and served by the card's and the CPU's Predictors: the card's
    codes replayed on the CPU give its outputs within the smoke's bound,
    and the Predictor equals the executor bit for bit."""
    from paddle_tpu_torch.transpiler import QuantizeTranspiler
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 6
    qt = QuantizeTranspiler(activation_quantize_type="moving_average_abs_max")
    with ptt.program_guard(main, startup):
        img = ptt.layers.data("img", [3, 16, 16], dtype="float32")
        y = ptt.layers.data("y", [1], dtype="float32")
        c = ptt.layers.conv2d(img, 8, 3, padding=1, act="relu")
        c = ptt.layers.conv2d(c, 8, 3, stride=2, padding=1, groups=2)
        pred = ptt.layers.fc(ptt.layers.reshape(c, [-1, 512]), size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        qt.training_transpile(main, startup)
        test = main.clone(for_test=True)
        ptt.optimizer.SGD(0.01).minimize(loss)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(8, 3, 16, 16).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    frozen = qt.freeze_program(test.prune(["img"], [pred.name]),
                               scope=exe.scope, quantize_dtype=qd)
    ptt.io.save_inference_model(str(tmp_path), ["img"], [pred], exe,
                                main_program=frozen)
    direct, = exe.run(frozen, feed={"img": feed["img"]},
                      fetch_list=[pred.name])
    served, = create_predictor(AnalysisConfig(str(tmp_path))).run(
        {"img": feed["img"]})
    np.testing.assert_array_equal(served, direct)
    codes = []
    with chip_smoke.quant_codes(record=codes):
        create_predictor(AnalysisConfig(str(tmp_path))).run(
            {"img": feed["img"]})
    cpu = create_predictor(AnalysisConfig(str(tmp_path), use_gpu=False))
    with chip_smoke.quant_codes(replay=codes) as left:
        replayed, = cpu.run({"img": feed["img"]})
    assert not left
    tol = (chip_smoke.QUANT_PRED_RTOL if qd == "int8"
           else chip_smoke.QAT_FP8_PRED_RTOL)
    assert np.abs(served - replayed).max() <= tol * np.abs(replayed).max()

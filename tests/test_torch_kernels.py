"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain torch version (the arithmetic the CUDA kernel implements, and
what the wrapper runs for CPU tensors) is held against the Pallas kernel
run in interpret mode on the CPU, on the same seeded numpy inputs.
Tolerance 1e-5: the same f32 math, summed in another order.  The
backward kernels' plain versions are held to the Pallas backward kernels
(through ``jax.vjp`` where the entry is differentiable) the same way, and
to torch autograd and finite differences in f64.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_layer_norm
# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")
jlm = importlib.import_module("paddle_tpu.kernels.lm_head")
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tflash
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.kernels import lm_head as tlm

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [7, 128, 300])
@pytest.mark.parametrize("d", [32, 512])
def test_layer_norm_plain_matches_pallas(n, d):
    rng = np.random.RandomState(n * 1000 + d)
    x = (rng.randn(n, d) * 2 + 0.5).astype("float32")
    g = rng.randn(d).astype("float32")
    b = rng.randn(d).astype("float32")
    eps = 1e-5
    jy, jmean, jvar = fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), eps=eps,
                                       interpret=True, return_stats=True)
    ty, tmean, trstd = tln.layer_norm_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), eps)
    tvar = 1.0 / torch.square(trstd) - eps
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), **TOL)


def _bf16_step(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a.astype("float64")), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("n", [7, 128, 300])
@pytest.mark.parametrize("d", [32, 264, 512])
def test_layer_norm_plain_matches_pallas_bf16(n, d):
    """bf16 rows (the AMP programs' layer norms): y bf16 within one bf16
    step of the Pallas kernel's (the same f32 value may round the other
    way), or within TOL's atol where y is near 0 (there xhat * gamma and
    beta cancel, and their f32 rounding outweighs a bf16 step); mean and
    variance f32 at TOL."""
    rng = np.random.RandomState(n * 1000 + d + 7)
    x = (rng.randn(n, d) * 2 + 0.5).astype("float32")
    g = rng.randn(d).astype("float32")
    b = rng.randn(d).astype("float32")
    eps = 1e-5
    jy, jmean, jvar = fused_layer_norm(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g), jnp.asarray(b),
        eps=eps, interpret=True, return_stats=True)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ty, tmean, trstd = tln.layer_norm_plain(
        xt, torch.from_numpy(g), torch.from_numpy(b), eps)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    jy32 = np.asarray(jy.astype(jnp.float32))
    ty32 = ty.float().numpy()
    assert (np.abs(ty32 - jy32)
            <= np.maximum(_bf16_step(jy32), TOL["atol"])).all()
    tvar = 1.0 / torch.square(trstd) - eps
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), **TOL)


# (H, d, B, Tq, Tk, causal, kv_len)
FLASH_CASES = [
    (2, 16, 2, 128, 128, True, None),
    (2, 64, 2, 256, 256, True, None),
    (2, 16, 2, 128, 128, False, 100),
    (2, 64, 2, 256, 256, False, 200),
    (2, 16, 2, 128, 256, False, None),     # cross-attention, Tq != Tk
    (2, 64, 2, 256, 128, False, 90),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_flash_hdt_plain_matches_pallas(case):
    H, d, B, Tq, Tk, causal, kv_len = case
    rng = np.random.RandomState(H * 7 + d + Tq + Tk)
    q = rng.randn(H, d, B * Tq).astype("float32")
    k = rng.randn(H, d, B * Tk).astype("float32")
    v = rng.randn(H, d, B * Tk).astype("float32")
    scale = 1.0 / np.sqrt(d)
    jo = jflash.flash_attention_hdt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), batch=B,
        causal=causal, kv_len=kv_len, interpret=True)
    # the entry returns o only; lse is the forward's residual
    jo2, jlse = jflash._flash_fwd_hdt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), B, scale, causal,
        True, None, None, kv_len)
    to, tlse = tflash.flash_attention_hdt_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), B,
        causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo2), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(5, 64).astype("float32"))
    g, b = torch.ones(64), torch.zeros(64)
    n_ln = tln.layer_norm.launches
    got = tln.layer_norm(x, g, b, 1e-5)
    want = tln.layer_norm_plain(x, g, b, 1e-5)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert tln.layer_norm.launches == n_ln

    q = torch.from_numpy(rng.randn(2, 64, 2 * 40).astype("float32"))
    n_fa = tflash.flash_attention_hdt.launches
    o, lse = tflash.flash_attention_hdt(q, q, q, batch=2, causal=True)
    wo, wl = tflash.flash_attention_hdt_plain(q, q, q, 2, causal=True)
    assert torch.equal(o, wo) and torch.equal(lse, wl)
    assert tflash.flash_attention_hdt.launches == n_fa


def test_launch_without_a_card_raises(tmp_path, monkeypatch):
    x = torch.zeros(4, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tln._launch(x, torch.ones(64), torch.zeros(64), 1e-5)
    q = torch.zeros(2, 64, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        tflash._launch(q, q, q, 2, False, 0.125, None)
    # no nvcc: the build raises instead of falling back
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_flash_hdt_argument_contract():
    q = torch.zeros(2, 16, 2 * 8)
    k = torch.zeros(2, 16, 2 * 12)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attention_hdt(q, k, k, batch=2, causal=True)
    with pytest.raises(ValueError, match="kv_len"):
        tflash.flash_attention_hdt(q, k, k, batch=2, kv_len=0)
    with pytest.raises(ValueError, match="divisible"):
        tflash.flash_attention_hdt(q, k, k, batch=5)


# --- backward kernels (the training slice) ---------------------------------

# (H, d, B, Tq, Tk, causal, kv_len)
BWD_SHAPES = {
    # JAX's one-pass nk == 1 kernel (block_k = Tk = 128)
    "nk1": [(2, 16, 2, 128, 128, True, None),
            (2, 16, 2, 128, 128, False, 100),
            (2, 16, 2, 256, 128, False, None)],
    # 1 < nk <= 16: the general one-pass kernel, block_k 128 at T 256
    "multi_k": [(2, 16, 2, 256, 256, True, None),
                (2, 16, 2, 256, 256, False, 200),
                (2, 16, 2, 128, 256, False, None)],
    # the two-kernel (dk/dv, then dq) path
    "two_kernel": [(2, 16, 2, 256, 256, True, None),
                   (2, 16, 2, 256, 256, False, 170),
                   (2, 16, 2, 128, 256, False, 90)],
}
BWD_CASES = [(path, c) for path, cs in BWD_SHAPES.items() for c in cs]


@pytest.mark.parametrize("path,case", BWD_CASES, ids=lambda c: (
    c if isinstance(c, str) else "-".join(str(v) for v in c)))
def test_flash_hdt_bwd_plain_matches_pallas(path, case, monkeypatch):
    H, d, B, Tq, Tk, causal, kv_len = case
    rng = np.random.RandomState(H * 11 + d + Tq + 3 * Tk + (kv_len or 0))
    q, do = (rng.randn(H, d, B * Tq).astype("float32") for _ in range(2))
    k, v = (rng.randn(H, d, B * Tk).astype("float32") for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    block_k = None if path == "nk1" else 128
    if path == "two_kernel":
        monkeypatch.setattr(jflash, "_FUSED_BWD_MULTI_K", False)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jflash._flash_fwd_hdt(jq, jk, jv, B, scale, causal, True,
                                     None, None, kv_len)
    jgrads = jflash._flash_bwd_hdt(B, scale, causal, kv_len, True,
                                   (jq, jk, jv, jo, jlse), jdo,
                                   block_k=block_k)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tlse = tflash.flash_attention_hdt_plain(tq, tk, tv, B, causal=causal,
                                                kv_len=kv_len)
    delta = torch.sum(tdo * to, dim=1, keepdim=True)
    tgrads = tflash.flash_attention_hdt_bwd_plain(
        tq, tk, tv, tlse, delta, tdo, B, causal=causal, kv_len=kv_len)
    for name, t, j in zip("dq dk dv".split(), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


# (N, D, V, chunk, ignored labels)
LM_HEAD_CASES = [
    (256, 32, 300, 256, 5),      # V not a multiple of a vocab block
    (256, 16, 256, 128, 0),      # two backward chunks
    (512, 24, 640, 256, 17),
]


def _lm_head_inputs(N, D, V, n_ignored, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype("float32")
    w = (rng.randn(D, V) * 0.2).astype("float32")
    y = rng.randint(0, V, N).astype("int64")
    y[rng.choice(N, n_ignored, replace=False)] = -1
    g = (rng.rand(N) / N).astype("float32")
    return x, w, y, g


@pytest.mark.parametrize("case", LM_HEAD_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_lm_head_plain_matches_pallas(case):
    N, D, V, chunk, n_ignored = case
    x, w, y, g = _lm_head_inputs(N, D, V, n_ignored, N + D + V)
    jloss, vjp = jax.vjp(
        lambda a, b: jlm.lm_head_xent(a, b, jnp.asarray(y.astype("int32")),
                                      interpret=True, chunk=chunk),
        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    # the kernel's lse residual, as lm_head_xent pads the vocab
    bv = jlm._pick_block_v(V) or 512
    Vp = -(-V // bv) * bv
    wp = jnp.pad(jnp.asarray(w), ((0, 0), (0, Vp - V)))
    _, jlse = jlm._fwd(jnp.asarray(x), wp,
                       jnp.asarray(y.astype("int32")).reshape(N, 1), True,
                       min(1024, N), bv, V if Vp != V else None)
    tx, tw, ty, tg = map(torch.from_numpy, (x, w, y, g))
    tloss, tlse = tlm.lm_head_fwd_plain(tx, tw, ty)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, 0], **TOL)
    assert (tloss.numpy()[y < 0] == 0).all()
    tdx, tdw = tlm.lm_head_bwd_plain(tx, tw, ty, tlse, tg, chunk)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("n,d", [(7, 32), (128, 512)])
def test_layer_norm_bwd_matches_jax_vjp_with_stats_cotangents(n, d):
    rng = np.random.RandomState(n + d)
    x = (rng.randn(n, d) * 2 + 0.5).astype("float32")
    g, b = rng.randn(d).astype("float32"), rng.randn(d).astype("float32")
    gy = rng.randn(n, d).astype("float32")
    gmean, gvar = rng.randn(n).astype("float32"), rng.randn(n).astype(
        "float32")
    eps = 1e-5
    _, vjp = jax.vjp(
        lambda a, s, t: fused_layer_norm(a, s, t, eps=eps, interpret=True,
                                         return_stats=True),
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gmean), jnp.asarray(gvar)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y, mean, rstd = tln.layer_norm_train(tx, tg, tb, eps)
    var = 1.0 / torch.square(rstd) - eps
    tgrads = torch.autograd.grad(
        (y, mean, var), (tx, tg, tb),
        tuple(map(torch.from_numpy, (gy, gmean, gvar))))
    for name, t, j in zip(("dx", "dgamma", "dbeta"), tgrads, jgrads):
        # dx through the variance output scales with rstd^3/D: relative
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   rtol=1e-5, atol=1e-5)


def _f64(rng, *shape):
    return torch.from_numpy(rng.randn(*shape)).requires_grad_()


@pytest.mark.parametrize("which", ["layer_norm", "flash_causal",
                                   "flash_kv_len", "lm_head"])
def test_plain_backward_gradcheck_f64(which):
    """Each plain backward against torch autograd through its plain forward
    in f64, and against finite differences (gradcheck)."""
    rng = np.random.RandomState(len(which))
    if which == "layer_norm":
        ins = (_f64(rng, 5, 8), _f64(rng, 8), _f64(rng, 8))
        fn = lambda x, g, b: tln.layer_norm_train(x, g, b, 1e-5)  # noqa
        ref = lambda x, g, b: tln.layer_norm_plain(x, g, b, 1e-5)  # noqa
    elif which.startswith("flash"):
        causal = which == "flash_causal"
        kv_len = None if causal else 4
        ins = (_f64(rng, 2, 4, 2 * 5), _f64(rng, 2, 4, 2 * 5),
               _f64(rng, 2, 4, 2 * 5))
        fn = lambda q, k, v: tflash.flash_attention_hdt(  # noqa
            q, k, v, 2, causal=causal, kv_len=kv_len)[0]
        ref = lambda q, k, v: tflash.flash_attention_hdt_plain(  # noqa
            q, k, v, 2, causal=causal, kv_len=kv_len)[0]
    else:
        y = torch.tensor([0, 8, -1, 3, 3, 5, -1])
        ins = (_f64(rng, 7, 4), _f64(rng, 4, 9))
        fn = lambda x, w: tlm.lm_head_xent(x, w, y, chunk=3)  # noqa
        ref = lambda x, w: tlm.lm_head_fwd_plain(x, w, y)[0]  # noqa
    assert torch.autograd.gradcheck(fn, ins)
    outs, want = fn(*ins), ref(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    want = want if isinstance(want, tuple) else (want,)
    cots = tuple(torch.from_numpy(rng.randn(*o.shape)) for o in outs)
    got = torch.autograd.grad(outs, ins, cots)
    exp = torch.autograd.grad(want, ins, cots)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_cpu_tensors_take_the_plain_backward_paths():
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, 2 * 40).astype("float32"))
               .requires_grad_() for _ in range(3))
    counts = (tflash.flash_attention_hdt.launches,
              tflash.flash_attention_hdt_bwd.launches,
              tlm.lm_head_fwd.launches, tlm.lm_head_bwd.launches)
    o, _ = tflash.flash_attention_hdt(q, k, v, batch=2, causal=True)
    o.sum().backward()
    x = torch.from_numpy(rng.randn(10, 8).astype("float32")).requires_grad_()
    w = torch.from_numpy(rng.randn(8, 13).astype("float32")).requires_grad_()
    y = torch.from_numpy(rng.randint(-1, 13, 10))
    tlm.lm_head_xent(x, w, y, chunk=4).sum().backward()
    assert q.grad is not None and x.grad is not None and w.grad is not None
    assert counts == (tflash.flash_attention_hdt.launches,
                      tflash.flash_attention_hdt_bwd.launches,
                      tlm.lm_head_fwd.launches, tlm.lm_head_bwd.launches)


def test_backward_launches_without_a_card_raise():
    q = torch.zeros(2, 64, 128)
    lse = torch.zeros(2, 1, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        tflash._launch_bwd(q, q, q, lse, lse, q, 2, False, 0.125, None)
    x, w, y = torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(4).long()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm._launch_fwd(x, w, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm._launch_bwd(x, w, y, torch.zeros(4), torch.zeros(4), 2)
    with pytest.raises(ValueError, match="chain"):
        tlm.lm_head_fwd(x, torch.zeros(9, 16), y)


# --- flash attention in [B, H, T, d] (the fuse-block slice) -----------------

# (B, H, T, d, JAX block_k): T 64 and 256 as test_pallas_kernels.py:25; the
# ragged T 7, 100 and 129 of :145 (JAX pads them to 128, the port masks);
# T 256 with block_k 128, so JAX takes its dk/dv + dq kernels (:379, :397)
# rather than the one-pass nk == 1 kernel (:346)
BHTD_SHAPES = [(2, 3, 64, 32, None), (2, 3, 256, 32, None),
               (1, 2, 7, 16, None), (1, 2, 100, 16, None),
               (1, 2, 129, 16, None), (1, 2, 256, 16, 128)]
BHTD_CASES = [(c, s) for s in BHTD_SHAPES for c in (False, True)]


@pytest.mark.parametrize("causal,shape", BHTD_CASES, ids=lambda c: (
    ("causal" if c else "full") if isinstance(c, bool)
    else "-".join(str(v) for v in c)))
def test_flash_bhtd_plain_matches_pallas(causal, shape):
    B, H, T, d, block_k = shape
    rng = np.random.RandomState(B * 1000 + T + d + int(causal))
    q, k, v, do = (rng.randn(B, H, T, d).astype("float32")
                   for _ in range(4))
    jo, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, interpret=True, block_k=block_k),
        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tlse = tflash.flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    if T % 128 == 0 or T == 64:
        # the unpadded kernel's lse residual (no padding at these T)
        _, jlse = jflash._flash_fwd(
            *(jnp.asarray(a.reshape(B * H, T, d)) for a in (q, k, v)),
            1.0 / np.sqrt(d), causal, True, None, block_k)
        np.testing.assert_allclose(tlse.numpy().reshape(B * H, T),
                                   np.asarray(jlse), **TOL)
    delta = torch.sum(tdo * to, dim=-1)
    tgrads = tflash.flash_attention_bwd_plain(tq, tk, tv, tlse, delta, tdo,
                                              causal=causal)
    # and through the autograd entry, which takes the plain versions here
    ins = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    agrads = torch.autograd.grad(
        tflash.flash_attention(*ins, causal=causal), ins, tdo)
    for name, t, a, j in zip("dq dk dv".split(), tgrads, agrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_flash_bhtd_takes_bh_t_d_and_any_strides_on_cpu():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 40, 3 * 4 * 16).astype("float32"))
    # q, k, v as [B, H, T, d] views of one [B, T, 3E] projection
    q, k, v = (x[..., i * 64:(i + 1) * 64].reshape(2, 40, 4, 16)
               .transpose(1, 2) for i in range(3))
    n = (tflash.flash_attention.launches, tflash.flash_attention_bwd.launches)
    o = tflash.flash_attention(q, k, v, causal=True)
    want, _ = tflash.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True)
    assert torch.equal(o, want)
    o3 = tflash.flash_attention(*(t.reshape(8, 40, 16) for t in (q, k, v)),
                                causal=True)
    assert o3.shape == (8, 40, 16)
    assert torch.equal(o3, want.reshape(8, 40, 16))
    assert (tflash.flash_attention.launches,
            tflash.flash_attention_bwd.launches) == n
    with pytest.raises(RuntimeError, match="CUDA"):
        tflash._launch_bhtd(q, k, v, True, 0.25)
    with pytest.raises(RuntimeError, match="CUDA"):
        tflash._check_card("flash_attention_bwd", (q, k, v), 64, 64)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attention(q[:, :, :7], k, v, causal=True)

"""While, Switch and the control-flow ops (ops/control_flow.py ``while``,
``conditional_block``, ``scan``, ``increment_loop_counter``;
layers/control_flow.py ``While``, ``Switch``) and the Variable operators
(layers/math_op_patch.py) through both packages, on the CPU.

The JAX package's own programs (tests/test_control_flow.py: the ``While``
that sums 0..4, a ``Switch`` on each side of its threshold) run in both
packages and give the same values exactly (f32 sums of small integers,
a constant picked), and every block of every program serializes alike.
A ``conditional_block`` whose condition is false passes its outputs'
values through, or zeros shaped like the branch's where the var has no
value before it; the ``scan`` op's carries and stacked outputs match JAX's
at rtol 1e-5 (a tanh recurrence, f32 products in another order).  A
``Switch`` inside a training program sends the gradient through the
taken branch only, as ``lax.cond`` does: the loss and every @GRAD match
JAX's at ``tests/test_torch_train.py``'s rtol 1e-5 / 1e-4 (atol 1e-6),
on each side of the threshold.  A loss that depends on a ``while``
output that depends on a parameter makes both packages raise before any
update (JAX's jax.vjp has no reverse-mode rule for lax.while_loop; the
port raises EnforceNotMet naming the op), and a ``while`` beside the loss
trains in both.  ``verify_program`` on a program with a While, a Switch
and a schedule gives JAX's findings, less the warning JAX's 32-bit plane
gives the schedule's int64 counter.  Each Variable operator builds JAX's
op list for the same expression.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import verify_program as jverify
from paddle_tpu_torch.analysis import verify_program as tverify
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.framework.registry import get_op_def
from paddle_tpu_torch.ops import control_flow as tcf
from test_torch_seq2seq import blocks_view

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PKGS = (pt, ptt)


@pytest.fixture(autouse=True)
def fresh_programs():
    for pkg in PKGS:
        pkg.reset_default_programs()
    yield
    for pkg in PKGS:
        pkg.reset_default_programs()


def fresh(pkg):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    return main, startup


def run(pkg, main, startup=None, feed=None, fetch=()):
    exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
    if startup is not None:
        exe.run(startup)
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=list(fetch))]


def both(build, feed=None, startup=True):
    """build(pkg) -> (main, startup, fetches) in each package; the two
    programs' blocks alike, and each package's fetched values."""
    out, progs = {}, {}
    for pkg in PKGS:
        main, start = fresh(pkg)
        with pkg.program_guard(main, start):
            fetches = build(pkg)
        progs[pkg] = (main, start)
        out[pkg] = run(pkg, main, start if startup else None, feed, fetches)
    for t, j in zip(progs[ptt], progs[pt]):
        assert blocks_view(t) == blocks_view(j)
    return out[ptt], out[pt], progs


def while_sum(pkg):
    L = pkg.layers
    i = L.fill_constant([1], "float32", 0.0, name="i")
    n = L.fill_constant([1], "float32", 5.0, name="n")
    acc = L.fill_constant([1], "float32", 0.0, name="acc")
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        L.assign(L.elementwise_add(acc, i), acc)
        L.assign(L.increment(i, value=1.0, in_place=False), i)
        L.less_than(i, n, cond=cond)
    return [acc, i]


def test_while_accumulates_as_in_jax():
    t, j, progs = both(while_sum)
    assert [float(v.ravel()[0]) for v in t] == [10.0, 5.0]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    op = progs[ptt][0].global_block().ops[-1]
    assert op.type == "while" and op.attrs["out_vars"][-1] == op.attrs[
        "condition"]


def switch_lr(step):
    def build(pkg):
        L = pkg.layers
        s = L.fill_constant([1], "float32", step)
        thresh = L.fill_constant([1], "float32", 5.0)
        lr = L.fill_constant([1], "float32", 0.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(s, thresh)):
                L.assign(L.fill_constant([1], "float32", 0.1), lr)
            with switch.case(L.less_than(s, L.fill_constant(
                    [1], "float32", 8.0))):
                L.assign(L.fill_constant([1], "float32", 0.05), lr)
            with switch.default():
                L.assign(L.fill_constant([1], "float32", 0.01), lr)
        return [lr]
    return build


@pytest.mark.parametrize("step,want", [(2.0, 0.1), (7.0, 0.05),
                                       (9.0, 0.01)])
def test_switch_picks_jax_branch(step, want):
    t, j, progs = both(switch_lr(step))
    np.testing.assert_array_equal(t[0], j[0])
    assert float(t[0].ravel()[0]) == pytest.approx(want)
    types = [op.type for op in progs[ptt][0].global_block().ops]
    assert types.count("conditional_block") == 3
    # the second case ANDs the negation of the first; default negates both
    assert types.count("logical_not") == 3
    assert types.count("logical_and") == 2


def cond_program(pkg, flag, with_value):
    """A conditional_block over sub-block ops writing `t` (fill 3.0, its
    shape [2, 3]) and `u` (t * 2); `u` has a value before the block, `t`
    one only `with_value`."""
    main = pkg.Program()
    g = main.global_block()
    g.create_var(name="c", shape=[1], dtype="bool")
    g.create_var(name="t", shape=[2, 3], dtype="float32")
    g.create_var(name="u", shape=[2, 3], dtype="float32")
    g.append_op("fill_constant", {}, {"Out": ["c"]},
                {"shape": [1], "dtype": "bool", "value": float(flag)})
    g.append_op("fill_constant", {}, {"Out": ["u"]},
                {"shape": [2, 3], "dtype": "float32", "value": -1.0})
    if with_value:
        g.append_op("fill_constant", {}, {"Out": ["t"]},
                    {"shape": [2, 3], "dtype": "float32", "value": 7.0})
    sub = main.create_block()
    sub.append_op("fill_constant", {}, {"Out": ["t"]},
                  {"shape": [2, 3], "dtype": "float32", "value": 3.0})
    sub.append_op("scale", {"X": ["t"]}, {"Out": ["u"]}, {"scale": 2.0})
    main.rollback()
    g.append_op("conditional_block", {"Cond": ["c"]}, {"Out": ["t", "u"]},
                {"sub_block": sub.idx, "out_vars": ["t", "u"]})
    return main


@pytest.mark.parametrize("flag,with_value,want_t,want_u", [
    (True, False, 3.0, 6.0), (False, True, 7.0, -1.0),
    (False, False, 0.0, -1.0)])
def test_conditional_block_runs_the_taken_branch(flag, with_value, want_t,
                                                 want_u):
    """A false condition passes the values before the block through, or
    zeros shaped like the branch's (its t [2, 3]) where there is none."""
    res = {pkg: run(pkg, cond_program(pkg, flag, with_value),
                    fetch=["t", "u"]) for pkg in PKGS}
    for a, b in zip(res[ptt], res[pt]):
        assert a.shape == b.shape == (2, 3) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res[ptt][0], np.full((2, 3), want_t))
    np.testing.assert_array_equal(res[ptt][1], np.full((2, 3), want_u))


def test_false_branch_is_not_run():
    """lax.cond runs one branch: a false block's ops never lower (a NaN
    or an out-of-range gather there cannot leak into the result)."""
    ran = []
    opdef = get_op_def("scale")
    lower = opdef.lower
    opdef.lower = lambda ctx, ins, attrs: (ran.append(1),
                                           lower(ctx, ins, attrs))[1]
    try:
        run(ptt, cond_program(ptt, False, True), fetch=["t", "u"])
        assert ran == []
        run(ptt, cond_program(ptt, True, True), fetch=["t", "u"])
        assert ran == [1]
    finally:
        opdef.lower = lower


def scan_program(pkg):
    """A scan over x [T 5, B 3, D 4]: h = tanh(x_t W + h), y_t = h * 2."""
    main = pkg.Program()
    g = main.global_block()
    sub = main.create_block()
    sub.append_op("mul", {"X": ["x_t"], "Y": ["W"]}, {"Out": ["a"]}, {})
    sub.append_op("elementwise_add", {"X": ["a"], "Y": ["h"]},
                  {"Out": ["s"]}, {"axis": -1})
    sub.append_op("tanh", {"X": ["s"]}, {"Out": ["h"]}, {})
    sub.append_op("scale", {"X": ["h"]}, {"Out": ["y"]}, {"scale": 2.0})
    main.rollback()
    g.append_op("assign", {"X": ["x"]}, {"Out": ["x_t"]}, {})
    g.append_op("scan", {}, {"CarryOut": ["h_last"], "Ys": ["ys"]},
                {"sub_block": sub.idx, "carry_vars": ["h"],
                 "x_vars": ["x_t"], "y_vars": ["y"]})
    return main


def test_scan_matches_jax():
    r = np.random.RandomState(3)
    feed = {"x": r.randn(5, 3, 4).astype("float32"),
            "W": (r.randn(4, 6) * 0.5).astype("float32"),
            "h": r.randn(3, 6).astype("float32")}
    res = {pkg: run(pkg, scan_program(pkg), feed=feed,
                    fetch=["h_last", "ys"]) for pkg in PKGS}
    for a, b in zip(res[ptt], res[pt]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert res[ptt][1].shape == (5, 3, 6)
    h = feed["h"]
    for t in range(5):
        h = np.tanh(feed["x"][t] @ feed["W"] + h)
    np.testing.assert_allclose(res[ptt][0], h, rtol=1e-5, atol=1e-6)


def test_increment_loop_counter_and_step_counter():
    """autoincreased_step_counter reads begin on the first run and moves
    by step a run (JAX's int32 counter, the port's int64)."""
    got = {}
    for pkg in PKGS:
        main, startup = fresh(pkg)
        with pkg.program_guard(main, startup):
            c = pkg.layers.autoincreased_step_counter(begin=5, step=3)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        got[pkg] = [int(np.asarray(exe.run(main, fetch_list=[c])[0])[0])
                    for _ in range(3)]
    assert got[ptt] == got[pt] == [5, 8, 11]


def switch_train(step):
    """A fc loss scaled by 2 below the threshold, by 0.5 from it on, the
    branch chosen in the graph by a Switch; SGD on the scaled loss."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4])
        base = L.mean(L.fc(x, size=3, act="tanh"))
        loss = L.scale(base, 0.0)
        s = L.fill_constant([1], "float32", step)
        with L.Switch() as switch:
            with switch.case(L.less_than(s, L.fill_constant(
                    [1], "float32", 5.0))):
                L.assign(L.scale(base, 2.0), loss)
            with switch.default():
                L.assign(L.scale(base, 0.5), loss)
        _, pg = pkg.optimizer.SGD(0.1).minimize(loss)
        return [loss] + [g for _, g in pg]
    return build


@pytest.mark.parametrize("step", [2.0, 8.0])
def test_switch_trains_through_the_taken_branch_like_jax(step):
    """From the same initial weights: the loss and each @GRAD against
    JAX's; the taken branch's factor shows in the gradient."""
    feed = {"x": np.random.RandomState(1).randn(6, 4).astype("float32")}
    res = {}
    for pkg in PKGS:
        main, startup = fresh(pkg)
        with pkg.program_guard(main, startup):
            fetches = switch_train(step)(pkg)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        if pkg is pt:
            init = {p.name: np.asarray(exe.scope.find_var(p.name))
                    for p in main.all_parameters()}
        else:
            ptt.io.params_from_numpy(exe.scope, init, ptt.CPUPlace())
        res[pkg] = [np.asarray(v) for v in exe.run(main, feed=feed,
                                                   fetch_list=fetches)]
    (tl, *tg), (jl, *jg) = res[ptt], res[pt]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        assert np.abs(a).max() > 0


def while_loss(case):
    """A fc loss and a While that adds it (case 'in_loss' / 'beside') or
    the counter ('independent') to acc 3 times; the optimized loss is acc
    in case 'in_loss', the fc loss otherwise."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4])
        base = L.mean(L.fc(x, size=1))
        acc = L.fill_constant([1], "float32", 0.0)
        i = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", 3.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            src = i if case == "independent" else base
            L.assign(L.elementwise_add(acc, src), acc)
            L.assign(L.increment(i, value=1.0, in_place=False), i)
            L.less_than(i, n, cond=cond)
        loss = L.mean(acc if case == "in_loss" else base)
        pkg.optimizer.SGD(0.1).minimize(loss)
        return [loss, acc]
    return build


@pytest.mark.parametrize("case", ["in_loss", "beside", "independent"])
def test_while_in_the_loss_raises_as_jax_does(case):
    """lax.while_loop has no reverse-mode rule: a loss through the loop's
    parameter-dependent output raises in both packages, before the
    update (the port's scope keeps its weights); a loop beside the loss
    or independent of the parameters trains in both, alike."""
    feed = {"x": np.ones((2, 4), "float32")}
    out = {}
    for pkg in PKGS:
        main, startup = fresh(pkg)
        with pkg.program_guard(main, startup):
            fetches = while_loss(case)(pkg)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        if pkg is pt:
            init = {p.name: np.asarray(exe.scope.find_var(p.name))
                    for p in main.all_parameters()}
        else:
            ptt.io.params_from_numpy(exe.scope, init, ptt.CPUPlace())
        try:
            out[pkg] = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetches)]
        except Exception as e:  # noqa: BLE001 — compared below
            out[pkg] = e
            after = {p.name: np.asarray(exe.scope.find_var(p.name))
                     for p in main.all_parameters()}
            for n, a in init.items():
                np.testing.assert_array_equal(after[n], a)
    if case == "in_loss":
        assert isinstance(out[pt], ValueError)
        assert "while_loop" in str(out[pt])
        assert isinstance(out[ptt], EnforceNotMet)
        assert "'while'" in str(out[ptt])
        return
    for a, b in zip(out[ptt], out[pt]):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)


def test_while_carry_keeps_its_type():
    """lax.while_loop's rule: a carried var that changes dtype in the body
    raises (the port never casts quietly)."""
    main, startup = fresh(ptt)
    with ptt.program_guard(main, startup):
        L = ptt.layers
        i = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", 2.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.cast(L.increment(i, 1.0, in_place=False),
                            "float64"), i)
            L.less_than(i, n, cond=cond)
    with pytest.raises(EnforceNotMet, match="while: carry"):
        run(ptt, main, fetch=[i])


def test_condition_reads_are_counted():
    """One host read of the condition per iteration, plus the last."""
    before = tcf._read_cond.cond_reads
    main, startup = fresh(ptt)
    with ptt.program_guard(main, startup):
        fetches = while_sum(ptt)
    run(ptt, main, fetch=fetches)
    assert tcf._read_cond.cond_reads - before == 6


def verifiable(pkg):
    L = pkg.layers
    x = L.data("x", [4])
    loss = L.mean(L.fc(x, size=2))
    lr = L.piecewise_decay([2, 4], [0.1, 0.01, 0.001])
    i = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "float32", 3.0)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        L.assign(L.elementwise_add(acc, i), acc)
        L.increment(i, value=1.0)
        L.less_than(i, n, cond=cond)
    scale = L.fill_constant([1], "float32", 1.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(acc, n)):
            L.assign(L.fill_constant([1], "float32", 2.0), scale)
        with switch.default():
            L.assign(L.fill_constant([1], "float32", 0.5), scale)
    total = L.elementwise_mul(loss, scale)
    pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(total)
    return [total, acc, lr]


def test_verify_program_gives_jax_findings():
    findings = {}
    for pkg, verify in ((pt, jverify), (ptt, tverify)):
        main, startup = fresh(pkg)
        with pkg.program_guard(main, startup):
            fetches = verifiable(pkg)
        res = verify(main, feed=["x"], fetch_list=fetches)
        sres = verify(startup)
        findings[pkg] = [sorted((f.code, f.severity, f.op_index, f.op_type,
                                 f.var_names) for f in r.findings)
                         for r in (res, sres)]
        assert not res.errors, res.report()
    # JAX's 32-bit plane makes the int64 counter's startup fill int32, a
    # dtype warning the port (int64 throughout) does not have
    x32 = [f for f in findings[pt][1] if f[0] == "dtype_mismatch"
           and f[4] == ("@lr_global_step@",)]
    assert len(x32) == 1 and x32[0][1] == "warn"
    assert findings[ptt] == [findings[pt][0],
                             [f for f in findings[pt][1] if f not in x32]]
    # and the program runs: the While, the Switch and the schedule
    main, startup = fresh(ptt)
    with ptt.program_guard(main, startup):
        fetches = verifiable(ptt)
    got = run(ptt, main, startup, {"x": np.ones((2, 4), "float32")},
              fetches)
    assert float(got[1].ravel()[0]) == 3.0
    assert float(got[2].ravel()[0]) == pytest.approx(0.1)


# ---------------------------------------------------------------------
# the Variable operators (layers/math_op_patch.py)
# ---------------------------------------------------------------------

EXPRESSIONS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2.0 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 1.5 - a,
    "mul": lambda a, b: a * 3.0, "rmul": lambda a, b: 3.0 * b,
    "truediv": lambda a, b: a / b, "rtruediv": lambda a, b: 1.0 / a,
    "pow": lambda a, b: a ** 2.0, "mod": lambda a, b: a % b,
    "floordiv": lambda a, b: a // b, "neg": lambda a, b: -a,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != 0.5,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= 1.0,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "chain": lambda a, b: (a + b) * (a - 1.0) / 2.0,
}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_variable_operator_builds_jax_ops(name):
    """The same expression on two data vars: JAX's op list (types,
    slots, attrs, var names) and JAX's values."""
    r = np.random.RandomState(5)
    feed = {"a": (r.rand(3, 4) * 4 + 0.5).astype("float32"),
            "b": (r.rand(3, 4) * 2 + 0.5).astype("float32")}

    def build(pkg):
        a = pkg.layers.data("a", [3, 4], append_batch_size=False)
        b = pkg.layers.data("b", [3, 4], append_batch_size=False)
        return [EXPRESSIONS[name](a, b)]

    t, j, _ = both(build, feed=feed, startup=False)
    assert t[0].dtype == j[0].dtype
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6)


def test_variables_hash_by_identity():
    main, startup = fresh(ptt)
    with ptt.program_guard(main, startup):
        a = ptt.layers.data("a", [2])
        b = ptt.layers.data("b", [2])
        n_ops = len(main.global_block().ops)
        d = {a: 1, b: 2}
        assert d[a] == 1 and d[b] == 2 and len({a, b, a}) == 2
        assert len(main.global_block().ops) == n_ops

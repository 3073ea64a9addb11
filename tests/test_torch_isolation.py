"""The port stands alone: it imports neither JAX nor paddle_tpu, and its
entry points refuse to run on the CPU unless asked to."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)(\.|\s|$)", re.M)

_CHILD = """
import json, sys
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
p = create_predictor(AnalysisConfig(sys.argv[1], use_gpu=False))
toks = np.random.RandomState(0).randint(1, 256, (2, 72)).astype("int64")
out, = p.run({"tokens": toks})
print(json.dumps({
    "shape": list(out.shape), "finite": bool(np.isfinite(out).all()),
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def _port_files():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, n)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = list(_port_files())
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            src = f.read()
        hit = _FORBIDDEN_IMPORT.search(src)
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_port_runs_a_jax_saved_model_in_a_process_without_jax(tmp_path):
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    cfg = jtr.TransformerConfig(src_vocab_size=256, max_length=72,
                                n_layer=2, n_head=4, d_model=64,
                                d_inner=128, dropout=0.0)
    with pt.program_guard(main, startup):
        _, _, logits = jtr.build_lm_net(cfg, 72, is_test=True)
    exe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    exe.run(startup)
    pt.io.save_inference_model(str(tmp_path), ["tokens"], [logits], exe,
                               main_program=main)
    res = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"shape": [2, 72, 256], "finite": True, "leaked": []}


_SERVING_CHILD = """
import json, sys
import paddle_tpu_torch.serving as serving
from paddle_tpu_torch.serving import loadgen
from paddle_tpu_torch.observability import goodput, memscope, perfscope
print(json.dumps({
    "engine": serving.DecodeEngine.__name__,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def test_serving_plane_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _SERVING_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"engine": "DecodeEngine", "leaked": []}


_ANALYSIS_CHILD = """
import json, sys
import paddle_tpu_torch.analysis as analysis
from paddle_tpu_torch import nets
from paddle_tpu_torch.analysis import lint
from paddle_tpu_torch.models import bert, lenet, resnet, transformer, vgg
from paddle_tpu_torch.ops import metric_ops, misc_ops, reduce_ops
rc = lint.main([])
selftest = lint.main(["--self-test"])
print(json.dumps({
    "rc": rc, "self_test": selftest, "schema": analysis.SCHEMA,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def test_analysis_plane_and_lint_cli_run_without_jax():
    """The verifier's shape inference runs the port's lowerings on meta
    tensors: the lint CLI verifies its models (the image classifiers and
    the conv plane's ops and nets, the NMT and BERT builds and their ops
    among them) with no JAX loaded."""
    res = subprocess.run([sys.executable, "-c", _ANALYSIS_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    for model in ("lenet", "vgg", "resnet", "transformer",
                  "transformer_lm", "bert"):
        assert f"[lint] {model}: ok" in res.stdout
    report = json.loads(lines[-1])
    assert report == {"rc": 0, "self_test": 1,
                      "schema": "paddle_tpu.analysis.v1", "leaked": []}


_CTR_CHILD = """
import json, sys
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch import metrics, sparse
from paddle_tpu_torch.analysis import lint
from paddle_tpu_torch.models import deepfm
from paddle_tpu_torch.sparse import selected_rows, table
rc = lint.main(["--models", "deepfm,deepfm_sparse"])
main, startup = ptt.Program(), ptt.Program()
with ptt.program_guard(main, startup):
    cfg = deepfm.DeepFMConfig(num_field=4, vocab_size=50, embed_dim=4,
                              fc_sizes=(8, 8))
    _, loss, prob = deepfm.build_sparse_train_net(cfg)
    ptt.optimizer.Adagrad(learning_rate=0.05).minimize(loss)
    ma = ptt.optimizer.ModelAverage()
exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
exe.run(startup)
batch = deepfm.make_fake_batch(cfg, 16, seed=1)
out, p = exe.run(main, feed=batch, fetch_list=[loss, prob])
with ma.apply(exe):
    pass
auc = metrics.Auc()
auc.update(p, batch["label"])
shard = table.EmbeddingShard(table.TableConfig("t", rows=8, dim=2,
                                               optimizer="adagrad"))
shard.apply(selected_rows.SelectedRows([1, 1, 3], np.ones((3, 2)), 8))
print(json.dumps({
    "rc": rc, "finite": bool(np.isfinite(out).all()),
    "auc": 0.0 <= auc.eval() <= 1.0, "version": shard.version,
    "buckets": sparse.hash_bucket(np.array([-3, 2**40], np.int64),
                                  50).tolist(),
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def test_ctr_plane_runs_without_jax():
    """DeepFM's sparse build with Adagrad and ModelAverage, the lint CLI's
    DeepFM builders, sparse/ (selected_rows, table) and metrics.py run on
    the CPU with no JAX loaded."""
    res = subprocess.run([sys.executable, "-c", _CTR_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    for model in ("deepfm", "deepfm_sparse"):
        assert f"[lint] {model}: ok" in res.stdout
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"rc": 0, "finite": True, "auc": True, "version": 1,
                      "buckets": [int(b) for b in
                                  ptt.sparse.hash_bucket(np.array(
                                      [-3, 2**40], np.int64), 50)],
                      "leaked": []}


_CONVNETS_LSTM_CHILD = """
import json, sys
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch.analysis import lint
from paddle_tpu_torch.layers import rnn
from paddle_tpu_torch.models import alexnet, googlenet, se_resnext, stacked_lstm
from paddle_tpu_torch.ops import rnn_ops
rc = lint.main(["--models", "alexnet,googlenet,se_resnext,stacked_lstm"])
losses = {}
for name, build, feed, opt in (
        ("stacked_lstm",
         lambda: stacked_lstm.build_train_net(dict_dim=50, seq_len=8,
                                              emb_dim=8, hidden_dim=8),
         stacked_lstm.make_fake_batch(4, dict_dim=50, seq_len=8, seed=1),
         lambda: ptt.optimizer.Adam(learning_rate=1e-2)),
        ("alexnet",
         lambda: alexnet.build_train_net(class_dim=10,
                                         img_shape=(3, 64, 64)),
         se_resnext.make_fake_batch(2, img_shape=(3, 64, 64), class_dim=10),
         lambda: ptt.optimizer.Momentum(learning_rate=0.01, momentum=0.9))):
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        _, loss, _, _ = build()
        opt().minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    losses[name] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                    for _ in range(3)]
print(json.dumps({
    "rc": rc,
    "finite": all(np.isfinite(v).all() for v in losses.values()),
    "lstm_fell": losses["stacked_lstm"][-1] < losses["stacked_lstm"][0],
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def test_convnets_and_lstm_run_without_jax():
    """ops/rnn_ops.py, layers/rnn.py and the four builders (AlexNet,
    GoogLeNet, SE-ResNeXt, the stacked LSTM): the lint CLI's four models,
    and three steps of the stacked LSTM (Adam; its loss falls) and of
    AlexNet (Momentum) on the CPU with no JAX loaded."""
    res = subprocess.run([sys.executable, "-c", _CONVNETS_LSTM_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    for model in ("alexnet", "googlenet", "se_resnext", "stacked_lstm"):
        assert f"[lint] {model}: ok" in res.stdout
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"rc": 0, "finite": True, "lstm_fell": True,
                      "leaked": []}


_SEQ2SEQ_BOOK_CHILD = """
import json, sys, tempfile
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch import nets
from paddle_tpu_torch.analysis import lint
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.layers import control_flow, sequence
from paddle_tpu_torch.models import book, machine_translation as mt
from paddle_tpu_torch.ops import beam_search_ops, control_flow as cf_ops
from paddle_tpu_torch.ops import crf_ops, sequence_ops
rc = lint.main(["--models", "nmt,mt_beam_decode,book_fit_a_line,"
                "book_word2vec,book_recommender,book_rnn_enc_dec,"
                "book_db_lstm"])
main, startup = ptt.Program(), ptt.Program()
with ptt.program_guard(main, startup):
    _, loss = mt.build_train_net(20, 20, 5, 5, emb_dim=8, hidden_dim=8)
    ptt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
exe.run(startup)
feed = mt.make_copy_task_batch(4, 5, 20, seed=1)
losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
          for _ in range(5)]
dec, dstart = ptt.Program(), ptt.Program()
with ptt.program_guard(dec, dstart):
    _, sent, scores = mt.build_decode_net(20, 20, 5, beam_size=3,
                                          max_len=6, emb_dim=8,
                                          hidden_dim=8)
ids, sc = exe.run(dec, feed={"src": feed["src"]},
                  fetch_list=[sent, scores])
with tempfile.TemporaryDirectory() as d:
    ptt.io.save_inference_model(d, ["src"], [sent, scores], exe,
                                main_program=dec)
    p_ids, p_sc = create_predictor(AnalysisConfig(d, use_gpu=False)).run(
        {"src": feed["src"]})
book_losses = {}
for name in ("fit_a_line", "db_lstm"):
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        feeds, bloss, _ = getattr(book, name)()
        ptt.optimizer.SGD(learning_rate=1e-2).minimize(bloss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    rng = np.random.RandomState(0)
    bfeed = {v.name: (rng.randint(0, 2, (2,) + tuple(v.shape[1:]))
                      if v.dtype == "int64" else
                      rng.randn(2, *v.shape[1:]).astype("float32"))
             for v in feeds}
    book_losses[name] = float(exe.run(main, feed=bfeed,
                                      fetch_list=[bloss])[0])
print(json.dumps({
    "rc": rc, "mt_fell": losses[-1] < losses[0],
    "decode": [list(ids.shape), str(ids.dtype),
               bool(np.array_equal(ids, p_ids)),
               bool(np.array_equal(sc, p_sc))],
    "book_finite": all(np.isfinite(v) for v in book_losses.values()),
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def test_seq2seq_and_book_run_without_jax():
    """The sub-block plumbing, the control-flow, beam-search, CRF and
    sequence ops, layers/control_flow.py and layers/sequence.py, and the
    two new builders: the lint CLI's seven new models, five Adam steps
    of a small MT model (its loss falls), its beam decode run and served
    by the Predictor from a saved directory (the same ids and scores),
    and a step of fit_a_line and db_lstm, on the CPU with no JAX
    loaded."""
    res = subprocess.run([sys.executable, "-c", _SEQ2SEQ_BOOK_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[lint] 7 models: 0 errors, 0 warnings" in res.stdout
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"rc": 0, "mt_fell": True,
                      "decode": [[4, 3, 6], "int32", True, True],
                      "book_finite": True, "leaked": []}


_CONTROL_FLOW_CONV_CHILD = """
import json, sys
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers
from paddle_tpu_torch.layers import learning_rate_scheduler, math_op_patch
from paddle_tpu_torch.ops import control_flow, elementwise, fused_ops
from paddle_tpu_torch.ops import misc_ops, nn_ops
main, startup = ptt.Program(), ptt.Program()
with ptt.program_guard(main, startup):
    img = layers.data("img", [3, 8, 8])
    vol = layers.data("vol", [2, 4, 4, 4])
    up = layers.conv2d_transpose(img, num_filters=4, filter_size=4,
                                 stride=2, padding=1)
    g = layers.group_norm(up, groups=2)
    c3 = layers.pool3d(layers.conv3d(vol, num_filters=2, filter_size=3,
                                     padding=1), pool_size=2)
    t3 = layers.conv3d_transpose(c3, num_filters=2, filter_size=2, stride=2)
    loss = layers.mean(g) + layers.mean(t3) * 0.5
    lr = layers.noam_decay(16, 4)
    i = layers.fill_constant([1], "float32", 0.0)
    n = layers.fill_constant([1], "float32", 3.0)
    acc = layers.fill_constant([1], "float32", 0.0)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.assign(acc + i, acc)
        layers.increment(i, value=1.0)
        layers.less_than(i, n, cond=cond)
    scale = layers.fill_constant([1], "float32", 1.0)
    with layers.Switch() as switch:
        with switch.case(acc < n):
            layers.assign(layers.fill_constant([1], "float32", 2.0), scale)
        with switch.default():
            layers.assign(layers.fill_constant([1], "float32", 0.5), scale)
    ptt.optimizer.Adam(learning_rate=lr).minimize(loss * scale)
exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
exe.run(startup)
rng = np.random.RandomState(0)
feed = {"img": rng.randn(2, 3, 8, 8).astype("float32"),
        "vol": rng.randn(2, 2, 4, 4, 4).astype("float32")}
out = [exe.run(main, feed=feed, fetch_list=[loss, lr, acc, scale])
       for _ in range(3)]
print(json.dumps({
    "finite": all(bool(np.isfinite(o[0]).all()) for o in out),
    "lrs": [round(float(o[1][0]), 7) for o in out],
    "acc": float(out[-1][2][0]), "scale": float(out[-1][3][0]),
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


def test_control_flow_schedules_and_conv_family_run_without_jax():
    """While, Switch, the schedules, the Variable operators and the rest
    of the conv family: three Adam steps under noam_decay of a program
    holding all of them, on the CPU with no JAX loaded."""
    res = subprocess.run([sys.executable, "-c", _CONTROL_FLOW_CONV_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    lrs = [round(16 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5), 7)
           for s in (1, 2, 3)]
    assert report == {"finite": True, "lrs": lrs, "acc": 3.0, "scale": 0.5,
                      "leaked": []}


def test_no_file_of_the_port_imports_ml_dtypes():
    """The card's machine has no ml_dtypes: fp8 arrays are recognised by
    their dtype's name and moved as bytes (io.py)."""
    pattern = re.compile(r"^\s*(import|from)\s+ml_dtypes(\.|\s|$)", re.M)
    for path in _port_files():
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


_QUANTIZE_CHILD = """
import json, sys, tempfile
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.transpiler import InferenceTranspiler, QuantizeTranspiler
main, startup = ptt.Program(), ptt.Program()
main.random_seed = startup.random_seed = 2
qt = QuantizeTranspiler(activation_quantize_type="moving_average_abs_max")
with ptt.program_guard(main, startup):
    img = ptt.layers.data("img", [3, 8, 8], dtype="float32")
    y = ptt.layers.data("y", [1], dtype="float32")
    c = ptt.layers.conv2d(img, 4, 3, padding=1, act="relu")
    q = ptt.layers.data("q", [6, 8], dtype="float32")
    a = ptt.layers.fused_multihead_attention(q, q, q, 2)
    h = ptt.layers.fc(ptt.layers.reshape(c, [-1, 256]), size=8, act="relu")
    pred = ptt.layers.fc(h, size=1)
    loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y)) \\
        + ptt.layers.mean(a)
    qt.training_transpile(main, startup)
    test = main.clone(for_test=True)
    ptt.optimizer.SGD(0.01).minimize(loss)
exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
exe.run(startup)
rng = np.random.RandomState(0)
feed = {"img": rng.randn(4, 3, 8, 8).astype("float32"),
        "y": rng.randn(4, 1).astype("float32"),
        "q": rng.randn(4, 6, 8).astype("float32")}
ptt.flags.set_flag("quantize_dtype", "int8")
losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0].reshape(-1)[0])
          for _ in range(3)]
ptt.flags.set_flag("quantize_dtype", "")
out = {}
for qd in ("int8", "e4m3", "e5m2"):
    frozen = qt.freeze_program(test.clone().prune(["img"], [pred.name]),
                               scope=exe.scope, quantize_dtype=qd)
    InferenceTranspiler().transpile(frozen, scope=exe.scope)
    d = tempfile.mkdtemp()
    ptt.io.save_inference_model(d, ["img"], [pred], exe, main_program=frozen)
    got, = create_predictor(AnalysisConfig(d, use_gpu=False)).run(
        {"img": feed["img"]})
    out[qd] = [list(got.shape), bool(np.isfinite(got).all())]
print(json.dumps({
    "finite": all(np.isfinite(losses)), "frozen": out,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                            "ml_dtypes")),
}))
"""


def test_quantize_plane_runs_without_jax():
    """QAT under quantize_dtype int8 (a conv, fused_multihead_attention,
    two fc), then freeze_program to int8, e4m3 and e5m2, the conv + BN
    fold, save_inference_model and the Predictor: on the CPU with no JAX
    and no ml_dtypes loaded."""
    res = subprocess.run([sys.executable, "-c", _QUANTIZE_CHILD],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"finite": True,
                      "frozen": {qd: [[4, 1], True]
                                 for qd in ("int8", "e4m3", "e5m2")},
                      "leaked": []}


def test_entry_points_refuse_the_cpu_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults are valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.default_place()
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.CUDAPlace(0).torch_device()
    # a model dir the predictor could otherwise serve
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        y = ptt.layers.fc(x, size=3)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    ptt.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                main_program=main)
    cfg = AnalysisConfig(str(tmp_path))
    assert cfg.use_gpu is True
    with pytest.raises(RuntimeError, match="CUDA"):
        create_predictor(cfg)
    out, = create_predictor(AnalysisConfig(str(tmp_path), use_gpu=False)).run(
        {"x": np.ones((2, 4), "float32")})
    assert out.shape == (2, 3)

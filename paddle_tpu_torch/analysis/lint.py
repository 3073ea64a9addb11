"""Static-analysis gate CLI: build and verify the bundled models.

    python -m paddle_tpu_torch.analysis.lint [--models a,b,...] [-v] [--list]

Counterpart of paddle_tpu/analysis/lint.py.  Builds each model (small
configs, program construction only: nothing runs), attaches an optimizer,
and runs the full verifier (shape inference + dataflow + hazard lints)
over the main AND startup programs with the model's natural fetch set.
Exit codes: 0 clean, 1 error-severity findings (or a build crash), 2 bad
usage.

The port builds all nineteen of the JAX package's bundled models, at
the JAX CLI's shapes and with its optimizer, SGD(0.01) (JAX
lint.py:26-29, :45-87, :90-119): ``lenet``, ``alexnet``, ``vgg``,
``googlenet``, ``resnet``, ``se_resnext``, ``transformer`` (the NMT
build), ``transformer_lm``, ``bert``, ``deepfm``, ``deepfm_sparse`` (the
hash-bucketed build), ``nmt`` (the GRU machine-translation model),
``stacked_lstm``, the five ``book_*`` models and ``mt_beam_decode`` (the
beam decode program, linted without an optimizer).
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Tuple

from .passes import verify_program


def _optimize(loss):
    from .. import optimizer
    optimizer.SGD(learning_rate=0.01).minimize(loss)


def _simple(builder, train=True):
    def build():
        feeds, loss, *rest = builder()
        if train:
            _optimize(loss)
        return feeds, [loss] + [r for r in rest if r is not None]
    return build


def model_builders() -> Dict[str, Callable[[], Tuple[list, list]]]:
    """name -> zero-arg builder running inside a fresh program_guard;
    returns (feed vars, fetch vars)."""
    from ..models import bert as bert_model
    from ..models import deepfm as deepfm_model
    from ..models import (alexnet, book, googlenet, lenet,
                          machine_translation, resnet, se_resnext,
                          stacked_lstm, transformer, vgg)

    def transformer_cfg(T=16, dropout=0.1):
        return transformer.TransformerConfig(
            src_vocab_size=64, tgt_vocab_size=64, max_length=T,
            n_layer=2, n_head=2, d_model=16, d_inner=32,
            dropout=dropout)

    def lm():
        # flash-attention contract: no attention-prob dropout
        feeds, cost, logits = transformer.build_lm_net(
            transformer_cfg(dropout=0.0), seq_len=16)
        _optimize(cost)
        return feeds, [cost, logits]

    def bert():
        cfg = bert_model.BertConfig(
            vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position=32, dropout=0.1)
        feeds, loss, (mlm, nsp) = bert_model.build_pretrain_net(
            cfg, seq_len=16)
        _optimize(loss)
        return feeds, [loss, mlm, nsp]

    def deepfm():
        cfg = deepfm_model.DeepFMConfig(
            num_field=4, vocab_size=50, embed_dim=4, fc_sizes=(8, 8))
        feeds, cost, prob = deepfm_model.build_train_net(cfg)
        _optimize(cost)
        return feeds, [cost, prob]

    def nmt():
        feeds, cost = machine_translation.build_train_net(
            src_vocab=50, tgt_vocab=50, src_len=8, tgt_len=8)
        _optimize(cost)
        return feeds, [cost]

    def deepfm_sparse():
        # the hash-bucketed sparse_embedding_lookup build
        cfg = deepfm_model.DeepFMConfig(
            num_field=4, vocab_size=50, embed_dim=4, fc_sizes=(8, 8))
        feeds, cost, prob = deepfm_model.build_sparse_train_net(cfg)
        _optimize(cost)
        return feeds, [cost, prob]

    return {
        "lenet": _simple(lenet.build_train_net),
        "alexnet": _simple(lambda: alexnet.build_train_net(
            class_dim=10, img_shape=(3, 64, 64))),
        "vgg": _simple(vgg.build_train_net),
        "googlenet": _simple(lambda: googlenet.build_train_net(
            class_dim=10, img_shape=(3, 64, 64))),
        "resnet": _simple(lambda: resnet.build_train_net(
            class_dim=10, img_shape=(3, 32, 32), depth=18)),
        "se_resnext": _simple(lambda: se_resnext.build_train_net(
            class_dim=10, img_shape=(3, 32, 32), depth=50,
            stage_blocks=(1, 1, 1, 1))),
        "transformer": _simple(lambda: transformer.build_train_net(
            transformer_cfg(), src_len=8, tgt_len=8)),
        "transformer_lm": lm,
        "bert": bert,
        "deepfm": deepfm,
        "deepfm_sparse": deepfm_sparse,
        "nmt": nmt,
        "stacked_lstm": _simple(stacked_lstm.build_train_net),
        "book_fit_a_line": _simple(book.fit_a_line),
        "book_word2vec": _simple(lambda: book.word2vec(dict_size=50)),
        "book_recommender": _simple(book.recommender_system),
        "book_rnn_enc_dec": _simple(book.rnn_encoder_decoder),
        "book_db_lstm": _simple(book.db_lstm),
        "mt_beam_decode": _simple(
            lambda: machine_translation.build_decode_net(
                src_vocab=50, tgt_vocab=50, src_len=8),
            train=False),
    }


def lint_model(name: str, build, verbose: bool = False) -> Tuple[int, int]:
    """Build one model in fresh programs and verify; returns
    (#errors, #warnings).  Build crashes count as one error."""
    from ..framework.program import Program, program_guard
    main, startup = Program(), Program()
    try:
        with program_guard(main, startup):
            feeds, fetches = build()
    except Exception as e:
        print(f"[lint] {name}: BUILD FAILED: {e!r}")
        return 1, 0
    res = verify_program(main, feed=[v.name for v in feeds],
                         fetch_list=fetches)
    sres = verify_program(startup)
    errs = len(res.errors) + len(sres.errors)
    warns = len(res.warnings) + len(sres.warnings)
    status = "FAIL" if errs else "ok"
    print(f"[lint] {name}: {status} ({len(main.global_block().ops)} ops, "
          f"{errs} errors, {warns} warnings)")
    if verbose or errs:
        for scope_name, r in (("main", res), ("startup", sres)):
            for f in r.sorted():
                if f.severity == "error" or verbose:
                    print(f"  {scope_name}: {f}")
        if verbose and res.unknown_shape_ops:
            uniq = sorted(set(res.unknown_shape_ops))
            print(f"  unknown-shape ops: {uniq}")
    return errs, warns


def _self_test() -> int:
    """--self-test: the gate must CATCH a deliberately broken program
    (exit 1) — validates the exit-code contract end to end."""
    from ..framework.program import Program, program_guard
    from .. import layers
    main = Program()
    with program_guard(main, Program()):
        x = layers.data("x", [4], dtype="float32")
        y = layers.scale(x, scale=2.0)
        # sever the dataflow: rewire the op to a var nothing produces
        main.global_block().ops[-1].inputs["X"] = ["missing_input"]
    res = verify_program(main, feed=["x"], fetch_list=[y])
    if res.by_code("undefined_read"):
        print("[lint] self-test: broken program caught (exit 1)")
        return 1
    print("[lint] self-test: verifier MISSED the broken program")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis.lint",
        description="Build and statically verify the bundled models.")
    ap.add_argument("--models", default="",
                    help="comma list of model names (default: all)")
    ap.add_argument("--list", action="store_true",
                    help="print the model names and exit")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--self-test", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.self_test:
        return _self_test()
    builders = model_builders()
    if args.list:
        print("\n".join(builders))
        return 0
    names = ([n.strip() for n in args.models.split(",") if n.strip()]
             or list(builders))
    unknown = [n for n in names if n not in builders]
    if unknown:
        print(f"[lint] unknown model(s): {unknown}; see --list")
        return 2
    total_e = total_w = 0
    for n in names:
        e, w = lint_model(n, builders[n], verbose=args.verbose)
        total_e += e
        total_w += w
    print(f"[lint] {len(names)} models: {total_e} errors, "
          f"{total_w} warnings")
    return 1 if total_e else 0


if __name__ == "__main__":
    sys.exit(main())

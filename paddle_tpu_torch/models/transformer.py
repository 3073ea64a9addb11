"""Decoder-only causal LM on the transformer encoder stack.

Counterpart of paddle_tpu/models/transformer.py for the flagship LM:
TransformerConfig, position_encoding_table, prepare_embedding,
encoder_layer, build_lm_net and make_fake_lm_batch.  Only the fused
attention build (``fused_attention=True``, attention through the
projection-fused ``fused_mha`` op) is ported, with either head: the
``fc`` logits head (serving) or the streamed ``fused_lm_head_loss``
(``fused_head=True``, training).  The unfused attention, dropout and
pipeline stages raise NotImplementedError naming their ROADMAP entry.

The position table is a parameter named per sequence length
(``src_pos_enc_<T>``), so a saved model serves one T: requests are
right-padded to it, causal attention keeps the pad out of earlier
positions, and a client reads each prompt's logits at its last real
position.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..framework.initializer import NumpyArrayInitializer
from ..framework.layer_helper import LayerHelper, ParamAttr


def position_encoding_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoid table (ref dist_transformer.py position_encoding_init)."""
    pos = np.arange(max_len)[:, None].astype("float64")
    div = np.power(10000.0, 2 * (np.arange(d_model) // 2) / d_model)[None, :]
    ang = pos / div
    table = np.zeros((max_len, d_model), dtype="float32")
    table[:, 0::2] = np.sin(ang[:, 0::2])
    table[:, 1::2] = np.cos(ang[:, 1::2])
    return table


def _no_dropout(rate):
    if rate:
        raise NotImplementedError(
            "dropout is not ported yet (ROADMAP queue A.5; the fused "
            "attention path refuses it in the JAX package too); build "
            "with dropout 0 or is_test=True")


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0,
                         causal=False, fused=False):
    """Attention sublayer; only the projection-fused op is ported (the
    JAX function's ``fused=True`` branch)."""
    if not fused:
        raise NotImplementedError(
            "the unfused attention composition (matmul/softmax/transpose "
            "ops) is not ported yet (ROADMAP queue A.5)")
    self_attn = (keys is None or keys is queries) and (
        values is None or values is keys or values is queries)
    keys = queries if keys is None else keys
    values = keys if values is None else values
    if values is not keys:
        raise ValueError("fused attention path projects V from the "
                         "same source as K (one kv input)")
    if attn_bias is not None:
        raise ValueError("fused attention path cannot apply an "
                         "additive attn_bias; pass dense batches")
    _no_dropout(dropout_rate)
    if d_key != d_value:
        raise ValueError("fused attention path requires d_key == d_value")
    return layers.fused_mha(queries, n_head, causal=causal,
                            kv=None if self_attn else keys,
                            size=d_key * n_head, out_size=d_model)


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0):
    hidden = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu")
    _no_dropout(dropout_rate)
    return layers.fc(hidden, size=d_model, num_flatten_dims=2)


def pre_post_process(prev_out, out, cmd, dropout_rate=0.0):
    """a=add, n=norm, d=drop."""
    for c in cmd:
        if c == "a":
            if prev_out is not None:
                out = layers.elementwise_add(out, prev_out)
        elif c == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif c == "d":
            _no_dropout(dropout_rate)
    return out


def encoder_layer(x, attn_bias, n_head, d_key, d_value, d_model, d_inner,
                  dropout_rate=0.0, causal=False, fused=False):
    attn = multi_head_attention(
        pre_post_process(None, x, "n"), None, None, attn_bias,
        d_key, d_value, d_model, n_head, dropout_rate,
        causal=causal, fused=fused)
    attn_out = pre_post_process(x, attn, "da", dropout_rate)
    ffn = positionwise_ffn(pre_post_process(None, attn_out, "n"),
                           d_inner, d_model, dropout_rate)
    return pre_post_process(attn_out, ffn, "da", dropout_rate)


def prepare_embedding(ids, vocab_size, d_model, max_len, dropout_rate=0.0,
                      name="src"):
    """Token embedding * sqrt(d_model) + sinusoid position encoding."""
    emb = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=f"{name}_word_emb"))
    emb = layers.scale(emb, scale=float(d_model) ** 0.5)
    seq_len = int(ids.shape[1])
    if seq_len > max_len:
        raise ValueError(f"sequence length {seq_len} exceeds the model's "
                         f"max_length {max_len}")
    pos_table = position_encoding_table(max_len, d_model)[:seq_len]
    helper_attr = ParamAttr(
        name=f"{name}_pos_enc_{seq_len}", trainable=False,
        initializer=NumpyArrayInitializer(pos_table))
    helper = LayerHelper("pos_enc")
    pos = helper.create_parameter(helper_attr, shape=[seq_len, d_model],
                                  dtype="float32")
    pos_var = layers.unsqueeze(pos, [0])                 # [1,T,D]
    out = layers.elementwise_add(emb, pos_var)
    _no_dropout(dropout_rate)
    return out


class TransformerConfig:
    """Transformer-base hyperparameters."""

    def __init__(self, src_vocab_size=30000, tgt_vocab_size=30000,
                 max_length=256, n_layer=6, n_head=8, d_model=512,
                 d_inner=2048, dropout=0.1, label_smooth_eps=0.1):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.max_length = max_length
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.d_key = d_model // n_head
        self.d_value = d_model // n_head
        self.d_inner = d_inner
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps


def build_lm_net(cfg: TransformerConfig, seq_len: int, is_test: bool = False,
                 fused_attention: bool = True, fused_head: bool = False,
                 pp_stages: int = 1):
    """Decoder-only causal LM.  Feeds: tokens [B,T] int64, labels [B,T]
    int64 — dense batches, causal masking inside the attention op.
    Returns (feeds, avg_cost, logits); with fused_head=True the logits
    are never materialized, so the third element is None."""
    if not fused_attention:
        raise NotImplementedError(
            "build_lm_net(fused_attention=False) needs the unfused "
            "attention ops (ROADMAP queue A.5)")
    if pp_stages != 1:
        raise NotImplementedError(
            "pipeline stages are not ported yet (ROADMAP queue A.7)")
    dropout = 0.0 if is_test else cfg.dropout
    tokens = layers.data("tokens", [seq_len], dtype="int64")
    labels = layers.data("labels", [seq_len], dtype="int64")
    x = prepare_embedding(tokens, cfg.src_vocab_size, cfg.d_model,
                          cfg.max_length, dropout, name="src")
    for _ in range(cfg.n_layer):
        x = encoder_layer(x, None, cfg.n_head, cfg.d_key, cfg.d_value,
                          cfg.d_model, cfg.d_inner, dropout, causal=True,
                          fused=True)
    x = pre_post_process(None, x, "n")
    if fused_head:
        # streamed head: no [N, V] logits in device memory (fwd or bwd)
        x2d = layers.reshape(x, [-1, cfg.d_model])
        label1d = layers.reshape(labels, [-1])
        avg_cost = layers.fused_lm_head_loss(x2d, cfg.src_vocab_size,
                                             label1d)
        return [tokens, labels], avg_cost, None
    logits = layers.fc(x, size=cfg.src_vocab_size, num_flatten_dims=2,
                       bias_attr=False)
    logits2d = layers.reshape(logits, [-1, cfg.src_vocab_size])
    label2d = layers.reshape(labels, [-1, 1])
    cost = layers.softmax_with_cross_entropy(logits2d, label2d)
    avg_cost = layers.mean(cost)
    return [tokens, labels], avg_cost, logits


def make_fake_lm_batch(cfg: TransformerConfig, batch_size: int,
                       seq_len: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, cfg.src_vocab_size,
                         (batch_size, seq_len)).astype("int64")
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}

"""Transformer-base NMT and the decoder-only causal LM on its stack.

Counterpart of paddle_tpu/models/transformer.py: TransformerConfig,
position_encoding_table, prepare_embedding, the encoder and decoder
layers and stacks with the padding bias (pad_bias), the encoder-decoder
training build (build_train_net, bench.py's ``bench_nmt`` row, and its
``is_test`` build) with make_fake_batch, and the flagship LM
(build_lm_net, lm_program_spec, make_fake_lm_batch).

The NMT build attends through the unfused composition (q/k/v
projections, split heads, matmul, an additive bias, softmax, matmul):
self-attention projects q, k and v in one [D, 3E] product, the
decoder's cross-attention in three (k and v from the encoder's output).
The biases are built in-graph from the [B, T] masks (1 = token, 0 =
pad): -1e9 at pads, [B, 1, 1, T]; the decoder's self-attention adds the
[1, 1, Tt, Tt] causal constant to its own.  The loss is the
label-smoothed soft-label softmax cross-entropy (a hard-label one at
``is_test`` or eps 0), weighted by tgt_mask and divided by the token
count.

The LM takes either attention build: the fused one
(``fused_attention=True``, attention through the projection-fused
``fused_mha`` op) and the unfused composition with the causal bias built
in-graph, whose parameters ``lm_program_spec`` maps to their roles for
the serving engine (serving/kv_cache.py).  Either takes the ``fc``
logits head (serving) or the streamed ``fused_lm_head_loss``
(``fused_head=True``, training).  Dropout (``TransformerConfig.dropout``,
0.1 by default; none at ``is_test``) goes where the JAX build puts it:
after the embedding, on the attention probabilities, on the FFN hidden
layer and on each sublayer's output before its residual add, all
``upscale_in_train``.  The fused attention path has no attention-prob
dropout and raises the JAX build's ValueError at a nonzero rate.
Pipeline stages raise NotImplementedError naming their ROADMAP entry.

The position table is a parameter named per sequence length
(``src_pos_enc_<T>``, ``tgt_pos_enc_<T>``), so a saved model serves one
T: requests are right-padded to it, and a client reads each prompt's
logits at its last real position.
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


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0,
                         causal=False, fused=False):
    """Attention sublayer (JAX :35-107): q/k/v projections, split heads,
    scaled-dot-product with an additive bias, combine, out-projection;
    or, with ``fused``, the projection-fused op (causal masking inside
    the kernel, no attn_bias)."""
    self_attn = (keys is None or keys is queries) and (
        values is None or values is keys or values is queries)
    keys = queries if keys is None else keys
    values = keys if values is None else values

    if fused:
        if values is not keys:
            raise ValueError("fused attention path projects V from the "
                             "same source as K (one kv input)")
        if attn_bias is not None:
            raise ValueError("fused attention path cannot apply an "
                             "additive attn_bias; pass dense batches")
        if dropout_rate:
            raise ValueError("fused attention path has no attention-prob "
                             "dropout (FlashAttention contract); use "
                             "fused=False or dropout_rate=0")
        if d_key != d_value:
            raise ValueError("fused attention path requires "
                             "d_key == d_value")
        return layers.fused_mha(queries, n_head, causal=causal,
                                kv=None if self_attn else keys,
                                size=d_key * n_head, out_size=d_model)

    if self_attn and d_key == d_value:
        # one [B,T,D]@[D,3E] projection instead of three
        qkv = layers.fc(queries, size=(2 * d_key + d_value) * n_head,
                        num_flatten_dims=2, bias_attr=False)
        q, k, v = layers.split(qkv, num_or_sections=3, dim=-1)
    else:
        q = layers.fc(queries, size=d_key * n_head, num_flatten_dims=2,
                      bias_attr=False)
        k = layers.fc(keys, size=d_key * n_head, num_flatten_dims=2,
                      bias_attr=False)
        v = layers.fc(values, size=d_value * n_head, num_flatten_dims=2,
                      bias_attr=False)

    def split_heads(x, d):
        # [B,T,nh*d] -> [B,nh,T,d]
        y = layers.reshape(x, [0, 0, n_head, d])
        return layers.transpose(y, [0, 2, 1, 3])

    q, k, v = split_heads(q, d_key), split_heads(k, d_key), split_heads(
        v, d_value)
    scores = layers.matmul(q, k, transpose_y=True,
                           alpha=float(d_key) ** -0.5)
    if attn_bias is not None:
        scores = layers.elementwise_add(scores, attn_bias)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_rate,
                                 dropout_implementation="upscale_in_train")
    ctx = layers.matmul(weights, v)                     # [B,nh,T,dv]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, n_head * d_value])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False)


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0):
    hidden = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu")
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_rate,
                                dropout_implementation="upscale_in_train")
    return layers.fc(hidden, size=d_model, num_flatten_dims=2)


def pre_post_process(prev_out, out, cmd, dropout_rate=0.0):
    """a=add, n=norm, d=drop."""
    for c in cmd:
        if c == "a":
            if prev_out is not None:
                out = layers.elementwise_add(out, prev_out)
        elif c == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif c == "d" and dropout_rate:
            out = layers.dropout(out, dropout_rate,
                                 dropout_implementation="upscale_in_train")
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


def decoder_layer(x, enc_out, slf_attn_bias, dec_enc_attn_bias, n_head,
                  d_key, d_value, d_model, d_inner, dropout_rate=0.0):
    slf = multi_head_attention(
        pre_post_process(None, x, "n"), None, None, slf_attn_bias,
        d_key, d_value, d_model, n_head, dropout_rate)
    slf_out = pre_post_process(x, slf, "da", dropout_rate)
    cross = multi_head_attention(
        pre_post_process(None, slf_out, "n"), enc_out, enc_out,
        dec_enc_attn_bias, d_key, d_value, d_model, n_head, dropout_rate)
    cross_out = pre_post_process(slf_out, cross, "da", dropout_rate)
    ffn = positionwise_ffn(pre_post_process(None, cross_out, "n"),
                           d_inner, d_model, dropout_rate)
    return pre_post_process(cross_out, ffn, "da", dropout_rate)


def pad_bias(mask, neg: float = -1e9):
    """[B,T] {0,1} padding mask -> [B,1,1,T] additive attention bias
    (0 where attendable, `neg` at pads)."""
    b = layers.scale(mask, scale=-neg, bias=neg)
    return layers.unsqueeze(b, [1, 2])


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
    if dropout_rate:
        out = layers.dropout(out, dropout_rate,
                             dropout_implementation="upscale_in_train")
    return out


def encoder(src_ids, src_attn_bias, n_layer, n_head, d_key, d_value,
            d_model, d_inner, vocab_size, max_len, dropout_rate=0.0):
    x = prepare_embedding(src_ids, vocab_size, d_model, max_len,
                          dropout_rate, name="src")
    for _ in range(n_layer):
        x = encoder_layer(x, src_attn_bias, n_head, d_key, d_value,
                          d_model, d_inner, dropout_rate)
    return pre_post_process(None, x, "n")


def decoder(tgt_ids, enc_out, slf_attn_bias, dec_enc_attn_bias, n_layer,
            n_head, d_key, d_value, d_model, d_inner, vocab_size, max_len,
            dropout_rate=0.0):
    x = prepare_embedding(tgt_ids, vocab_size, d_model, max_len,
                          dropout_rate, name="tgt")
    for _ in range(n_layer):
        x = decoder_layer(x, enc_out, slf_attn_bias, dec_enc_attn_bias,
                          n_head, d_key, d_value, d_model, d_inner,
                          dropout_rate)
    return pre_post_process(None, x, "n")


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


def build_train_net(cfg: TransformerConfig, src_len: int, tgt_len: int,
                    is_test: bool = False):
    """Feeds: src_ids [B,Ts] int64, tgt_ids [B,Tt] int64, lbl_ids [B,Tt]
    int64, src_mask [B,Ts] float32 (1=token, 0=pad), tgt_mask [B,Tt].
    Attention biases are derived in-graph from the masks.  Returns
    (feeds, avg_cost, logits)."""
    dropout = 0.0 if is_test else cfg.dropout
    src_ids = layers.data("src_ids", [src_len], dtype="int64")
    tgt_ids = layers.data("tgt_ids", [tgt_len], dtype="int64")
    lbl_ids = layers.data("lbl_ids", [tgt_len], dtype="int64")
    src_mask = layers.data("src_mask", [src_len], dtype="float32")
    tgt_mask = layers.data("tgt_mask", [tgt_len], dtype="float32")

    neg_inf = -1e9
    src_attn_bias = pad_bias(src_mask)
    tgt_pad_bias = pad_bias(tgt_mask)
    # causal bias [1,1,Tt,Tt]
    causal = np.triu(np.full((tgt_len, tgt_len), neg_inf, dtype="float32"), 1)
    causal_var = layers.assign(causal[None, None, :, :])
    tgt_slf_bias = layers.elementwise_add(tgt_pad_bias, causal_var)

    enc_out = encoder(src_ids, src_attn_bias, cfg.n_layer, cfg.n_head,
                      cfg.d_key, cfg.d_value, cfg.d_model, cfg.d_inner,
                      cfg.src_vocab_size, cfg.max_length, dropout)
    dec_out = decoder(tgt_ids, enc_out, tgt_slf_bias, src_attn_bias,
                      cfg.n_layer, cfg.n_head, cfg.d_key, cfg.d_value,
                      cfg.d_model, cfg.d_inner, cfg.tgt_vocab_size,
                      cfg.max_length, dropout)

    logits = layers.fc(dec_out, size=cfg.tgt_vocab_size, num_flatten_dims=2,
                       bias_attr=False)
    logits2d = layers.reshape(logits, [-1, cfg.tgt_vocab_size])
    label2d = layers.reshape(lbl_ids, [-1, 1])
    if cfg.label_smooth_eps and not is_test:
        soft = layers.label_smooth(
            layers.one_hot(label2d, cfg.tgt_vocab_size),
            epsilon=cfg.label_smooth_eps)
        soft = layers.reshape(soft, [-1, cfg.tgt_vocab_size])
        cost = layers.softmax_with_cross_entropy(logits2d, soft,
                                                 soft_label=True)
    else:
        cost = layers.softmax_with_cross_entropy(logits2d, label2d)
    weights2d = layers.reshape(tgt_mask, [-1, 1])
    weighted = layers.elementwise_mul(cost, weights2d)
    sum_cost = layers.reduce_sum(weighted)
    token_count = layers.reduce_sum(weights2d)
    avg_cost = layers.elementwise_div(sum_cost, token_count)

    feeds = [src_ids, tgt_ids, lbl_ids, src_mask, tgt_mask]
    return feeds, avg_cost, logits


def build_lm_net(cfg: TransformerConfig, seq_len: int, is_test: bool = False,
                 fused_attention: bool = True, fused_head: bool = False,
                 pp_stages: int = 1):
    """Decoder-only causal LM.  Feeds: tokens [B,T] int64, labels [B,T]
    int64 — dense batches, causal masking inside the attention op.
    Returns (feeds, avg_cost, logits); with fused_head=True the logits
    are never materialized, so the third element is None.  The unfused
    build (``fused_attention=False``) adds the causal bias in-graph."""
    if pp_stages != 1:
        raise NotImplementedError(
            "pipeline stages are not ported yet (ROADMAP queue A.7)")
    dropout = 0.0 if is_test else cfg.dropout
    tokens = layers.data("tokens", [seq_len], dtype="int64")
    labels = layers.data("labels", [seq_len], dtype="int64")
    x = prepare_embedding(tokens, cfg.src_vocab_size, cfg.d_model,
                          cfg.max_length, dropout, name="src")
    if fused_attention:
        attn_bias = None
    else:
        # the causal bias built IN-GRAPH from a [T] iota (JAX :306-316)
        r = layers.assign(np.arange(seq_len, dtype="float32"))
        row = layers.reshape(r, [seq_len, 1])
        col = layers.reshape(r, [1, seq_len])
        future = layers.cast(layers.greater_than(col, row), "float32")
        attn_bias = layers.reshape(layers.scale(future, scale=-1e9),
                                   [1, 1, seq_len, seq_len])
    for _ in range(cfg.n_layer):
        x = encoder_layer(x, attn_bias, cfg.n_head, cfg.d_key, cfg.d_value,
                          cfg.d_model, cfg.d_inner, dropout, causal=True,
                          fused=fused_attention)
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


def lm_program_spec(program):
    """Parameter-name structure of an UNFUSED ``build_lm_net`` program.

    Walks the op list of a program built with ``fused_attention=False,
    fused_head=False`` and maps each trained parameter to its role in
    the decoder stack — the binding the serving decode engine
    (serving/kv_cache.py) uses to run the SAME weights through an
    incremental KV-cache step without re-tracing the program.  The op
    topology per layer is fixed by :func:`encoder_layer`:

      layer_norm -> mul(qkv) -> ... -> mul(out_proj) -> residual ->
      layer_norm -> mul(ffn1)+bias -> relu -> mul(ffn2)+bias -> residual

    followed by one final layer_norm and the mul LM head.  Returns::

        {"emb": name, "layers": [{"ln1": (scale, bias), "w_qkv": name,
          "w_o": name, "ln2": (scale, bias), "w_fc1": name,
          "b_fc1": name, "w_fc2": name, "b_fc2": name}, ...],
         "ln_f": (scale, bias), "w_head": name, "n_layer": L}

    Raises ValueError when the program does not look like that build
    (e.g. the fused_mha path, whose projections live inside one op).
    """
    from ..framework.program import Parameter
    block = program.global_block()

    def _is_param(name: str) -> bool:
        try:
            return isinstance(block.var(name), Parameter)
        except KeyError:
            return False

    fused = sorted({op.type for op in block.ops} & {
        "fused_mha", "fused_lm_head_loss", "fused_transformer_block"})
    if fused:
        # the reference's op census alone can mistake a fused build for a
        # mismatched unfused one (2 FFN weights a layer + the head)
        raise ValueError(
            f"lm_program_spec: program is not an unfused build_lm_net "
            f"graph (it holds {fused}); build with fused_attention=False, "
            f"fused_head=False")
    emb = None
    muls, lns, biases = [], [], []
    for op in block.ops:
        if op.type == "lookup_table" and emb is None:
            emb = op.inputs["W"][0]
        elif op.type == "layer_norm":
            lns.append((op.inputs["Scale"][0], op.inputs["Bias"][0]))
        elif op.type == "mul" and _is_param(op.inputs["Y"][0]):
            muls.append(op.inputs["Y"][0])
        elif op.type == "elementwise_add" and _is_param(op.inputs["Y"][0]):
            biases.append(op.inputs["Y"][0])
    if emb is None or not muls or (len(muls) - 1) % 4:
        raise ValueError(
            "lm_program_spec: program is not an unfused build_lm_net "
            f"graph (found {len(muls)} fc weights, embedding="
            f"{emb!r}); build with fused_attention=False, "
            "fused_head=False")
    n_layer = (len(muls) - 1) // 4
    if len(lns) != 2 * n_layer + 1 or len(biases) != 2 * n_layer:
        raise ValueError(
            f"lm_program_spec: op census mismatch — {len(muls)} fc "
            f"weights imply {n_layer} layers but found {len(lns)} "
            f"layer_norms (want {2 * n_layer + 1}) and {len(biases)} "
            f"fc biases (want {2 * n_layer})")
    layers = []
    for li in range(n_layer):
        w_qkv, w_o, w_fc1, w_fc2 = muls[4 * li:4 * li + 4]
        layers.append({
            "ln1": lns[2 * li], "w_qkv": w_qkv, "w_o": w_o,
            "ln2": lns[2 * li + 1],
            "w_fc1": w_fc1, "b_fc1": biases[2 * li],
            "w_fc2": w_fc2, "b_fc2": biases[2 * li + 1]})
    return {"emb": emb, "layers": layers, "ln_f": lns[-1],
            "w_head": muls[-1], "n_layer": n_layer}


def make_fake_lm_batch(cfg: TransformerConfig, batch_size: int,
                       seq_len: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, cfg.src_vocab_size,
                         (batch_size, seq_len)).astype("int64")
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def make_fake_batch(cfg: TransformerConfig, batch_size: int, src_len: int,
                    tgt_len: int, seed: int = 0):
    """Synthetic WMT-like batch for tests/benchmarks (no padding)."""
    rng = np.random.RandomState(seed)
    feed = {
        "src_ids": rng.randint(1, cfg.src_vocab_size,
                               (batch_size, src_len)).astype("int64"),
        "tgt_ids": rng.randint(1, cfg.tgt_vocab_size,
                               (batch_size, tgt_len)).astype("int64"),
        "lbl_ids": rng.randint(1, cfg.tgt_vocab_size,
                               (batch_size, tgt_len)).astype("int64"),
        "src_mask": np.ones((batch_size, src_len), dtype="float32"),
        "tgt_mask": np.ones((batch_size, tgt_len), dtype="float32"),
    }
    return feed

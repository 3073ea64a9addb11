"""Decoder-only causal LM on the transformer encoder stack.

Counterpart of paddle_tpu/models/transformer.py for the flagship LM:
TransformerConfig, position_encoding_table, prepare_embedding,
encoder_layer, build_lm_net, lm_program_spec and make_fake_lm_batch.
Both attention builds are ported: the fused one (``fused_attention=True``,
attention through the projection-fused ``fused_mha`` op) and the unfused
composition (one [D, 3E] projection, split, transpose, matmul, softmax,
matmul, with the causal bias built in-graph), whose parameters
``lm_program_spec`` maps to their roles for the serving engine
(serving/kv_cache.py).  Either takes the ``fc`` logits head (serving) or
the streamed ``fused_lm_head_loss`` (``fused_head=True``, training).
Dropout (``TransformerConfig.dropout``, 0.1 by default; none at
``is_test``) goes where the JAX build puts it: after the embedding, on
the attention probabilities, on the FFN hidden layer and on each
sublayer's output before its residual add, all ``upscale_in_train``.
The fused attention path has no attention-prob dropout and raises the
JAX build's ValueError at a nonzero rate.  Pipeline stages raise
NotImplementedError naming their ROADMAP entry.

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

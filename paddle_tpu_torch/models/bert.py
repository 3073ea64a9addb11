"""BERT-base pretraining: the masked-LM and next-sentence heads on the
transformer encoder.

Counterpart of paddle_tpu/models/bert.py: BertConfig (BERT-base's
widths by default), bert_embeddings (word, token-type and learned
position embeddings, summed and normalised), bert_encoder (the
encoder_layer stack of models/transformer.py under a padding bias from
input_mask), build_pretrain_net (the MLM head over the gathered masked
positions, weighted by mask_weight; the NSP head on the first token)
and make_fake_batch.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..framework.layer_helper import LayerHelper, ParamAttr
from .transformer import encoder_layer, pad_bias, pre_post_process


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout


def bert_embeddings(input_ids, token_type_ids, cfg: BertConfig,
                    dropout_rate: float):
    seq_len = int(input_ids.shape[1])
    if seq_len > cfg.max_position:
        raise ValueError(f"sequence length {seq_len} exceeds max_position "
                         f"{cfg.max_position}")
    word = layers.embedding(input_ids, [cfg.vocab_size, cfg.hidden_size],
                            param_attr=ParamAttr(name="word_embedding"))
    ttype = layers.embedding(token_type_ids,
                             [cfg.type_vocab_size, cfg.hidden_size],
                             param_attr=ParamAttr(name="token_type_embedding"))
    helper = LayerHelper("pos_emb")
    pos = helper.create_parameter(ParamAttr(name="position_embedding"),
                                  shape=[cfg.max_position, cfg.hidden_size],
                                  dtype="float32")
    pos_slice = layers.slice(pos, axes=[0], starts=[0], ends=[seq_len])
    pos_b = layers.unsqueeze(pos_slice, [0])
    x = layers.elementwise_add(layers.elementwise_add(word, ttype), pos_b)
    x = layers.layer_norm(x, begin_norm_axis=2)
    if dropout_rate:
        x = layers.dropout(x, dropout_rate,
                           dropout_implementation="upscale_in_train")
    return x


def bert_encoder(input_ids, token_type_ids, input_mask, cfg: BertConfig,
                 is_test=False):
    dropout = 0.0 if is_test else cfg.dropout
    attn_bias = pad_bias(input_mask)
    x = bert_embeddings(input_ids, token_type_ids, cfg, dropout)
    d_key = cfg.hidden_size // cfg.num_heads
    for _ in range(cfg.num_layers):
        x = encoder_layer(x, attn_bias, cfg.num_heads, d_key, d_key,
                          cfg.hidden_size, cfg.intermediate_size, dropout)
    return pre_post_process(None, x, "n")


def build_pretrain_net(cfg: BertConfig, seq_len: int,
                       is_test: bool = False):
    """MLM (gathered masked positions) + NSP heads.

    Feeds: input_ids [B,T] i64, token_type_ids [B,T] i64, input_mask [B,T]
    f32, mask_pos [B*P] i64 (flattened positions into [B*T]), mask_label
    [B*P,1] i64, mask_weight [B*P,1] f32, nsp_label [B,1] i64.
    """
    input_ids = layers.data("input_ids", [seq_len], dtype="int64")
    token_type_ids = layers.data("token_type_ids", [seq_len], dtype="int64")
    input_mask = layers.data("input_mask", [seq_len], dtype="float32")
    # flattened masked-position feeds: [B*max_preds(,1)]
    mask_pos = layers.data("mask_pos", [-1], dtype="int64",
                           append_batch_size=False)
    mask_label = layers.data("mask_label", [-1, 1], dtype="int64",
                             append_batch_size=False)
    mask_weight = layers.data("mask_weight", [-1, 1], dtype="float32",
                              append_batch_size=False)
    nsp_label = layers.data("nsp_label", [1], dtype="int64")

    enc = bert_encoder(input_ids, token_type_ids, input_mask, cfg,
                       is_test=is_test)                      # [B,T,H]

    # --- MLM head ---------------------------------------------------------
    flat = layers.reshape(enc, [-1, cfg.hidden_size])        # [B*T,H]
    picked = layers.gather(flat, mask_pos)                   # [B*P,H]
    h = layers.fc(picked, size=cfg.hidden_size, act="gelu")
    h = layers.layer_norm(h, begin_norm_axis=1)
    mlm_logits = layers.fc(h, size=cfg.vocab_size)           # [B*P,V]
    mlm_cost = layers.softmax_with_cross_entropy(mlm_logits, mask_label)
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(mlm_cost, mask_weight)),
        layers.elementwise_add(layers.reduce_sum(mask_weight),
                               layers.assign(np.array(1e-6, "float32"))))

    # --- NSP head ---------------------------------------------------------
    cls = layers.slice(enc, axes=[1], starts=[0], ends=[1])  # [B,1,H]
    cls = layers.reshape(cls, [-1, cfg.hidden_size])
    pooled = layers.fc(cls, size=cfg.hidden_size, act="tanh")
    nsp_logits = layers.fc(pooled, size=2)
    nsp_cost = layers.softmax_with_cross_entropy(nsp_logits, nsp_label)
    nsp_loss = layers.mean(nsp_cost)

    total_loss = layers.elementwise_add(mlm_loss, nsp_loss)
    feeds = [input_ids, token_type_ids, input_mask, mask_pos, mask_label,
             mask_weight, nsp_label]
    return feeds, total_loss, (mlm_loss, nsp_loss)


def make_fake_batch(cfg: BertConfig, batch_size: int, seq_len: int,
                    max_preds: int = 20, seed: int = 0):
    rng = np.random.RandomState(seed)
    n = batch_size * max_preds
    # positions index into the flattened [B*T] token axis
    pos = (np.arange(n) % seq_len
           + (np.arange(n) // max_preds) * seq_len).astype("int64")
    return {
        "input_ids": rng.randint(0, cfg.vocab_size,
                                 (batch_size, seq_len)).astype("int64"),
        "token_type_ids": rng.randint(0, cfg.type_vocab_size,
                                      (batch_size, seq_len)).astype("int64"),
        "input_mask": np.ones((batch_size, seq_len), dtype="float32"),
        "mask_pos": pos,
        "mask_label": rng.randint(0, cfg.vocab_size, (n, 1)).astype("int64"),
        "mask_weight": np.ones((n, 1), dtype="float32"),
        "nsp_label": rng.randint(0, 2, (batch_size, 1)).astype("int64"),
    }

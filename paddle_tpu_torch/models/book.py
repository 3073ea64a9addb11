"""The remaining book examples as model builders (counterpart of
paddle_tpu/models/book.py): fit_a_line, word2vec, recommender_system,
rnn_encoder_decoder and db_lstm (label semantic roles with a CRF).

The reference's LoD-level-1 inputs are padded [B, T] int tensors, as in
the JAX package; the builds are the JAX package's op for op.
"""
from __future__ import annotations

import numpy as np

from .. import layers, nets
from ..framework.layer_helper import ParamAttr


# --- fit_a_line (test_fit_a_line.py:30) -----------------------------------

def fit_a_line(x_dim: int = 13):
    """Linear regression on UCI housing: fc(1) + square_error_cost."""
    x = layers.data("x", [x_dim], dtype="float32")
    y = layers.data("y", [1], dtype="float32")
    y_predict = layers.fc(x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    return [x, y], avg_cost, y_predict


# --- word2vec (test_word2vec.py:35) ---------------------------------------

def word2vec(dict_size: int, embed_size: int = 32, hidden_size: int = 256,
             n_gram: int = 4):
    """N-gram LM: per-position embeddings over ONE shared table
    ('shared_w', as the reference shares via param_attr name), concat,
    fc sigmoid, softmax over the vocab."""
    words = [layers.data(f"word_{i}", [1], dtype="int64")
             for i in range(n_gram)]
    next_word = layers.data("next_word", [1], dtype="int64")
    embeds = [layers.embedding(w, size=[dict_size, embed_size],
                               param_attr=ParamAttr(name="shared_w"))
              for w in words]
    concat = layers.concat(embeds, axis=-1)
    concat = layers.reshape(concat, [-1, n_gram * embed_size])
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    predict = layers.fc(hidden, size=dict_size, act="softmax")
    cost = layers.cross_entropy(input=predict, label=next_word)
    avg_cost = layers.mean(cost)
    return words + [next_word], avg_cost, predict


# --- recommender_system (test_recommender_system.py:34,93,143) ------------

def recommender_system(user_dict=100, gender_dict=2, age_dict=7,
                       job_dict=21, movie_dict=200, category_dict=10,
                       title_dict=500, title_len=8, categories_len=3):
    """Dual-tower CTR: user tower (id/gender/age/job embeddings -> fcs ->
    concat -> fc200 tanh) x movie tower (id emb fc + category sum-pool +
    title sequence_conv_pool -> fc200 tanh), cos_sim scaled to [0,5],
    square error vs score."""
    def emb_fc(data_name, vocab, emb_dim, fc_dim, table):
        v = layers.data(data_name, [1], dtype="int64")
        e = layers.embedding(v, size=[vocab, emb_dim],
                             param_attr=ParamAttr(name=table))
        e = layers.reshape(e, [-1, emb_dim])
        return v, layers.fc(e, size=fc_dim)

    uid, usr_fc = emb_fc("user_id", user_dict, 32, 32, "user_table")
    gid, gender_fc = emb_fc("gender_id", gender_dict, 16, 16,
                            "gender_table")
    aid, age_fc = emb_fc("age_id", age_dict, 16, 16, "age_table")
    jid, job_fc = emb_fc("job_id", job_dict, 16, 16, "job_table")
    usr_combined = layers.fc(
        layers.concat([usr_fc, gender_fc, age_fc, job_fc], axis=1),
        size=200, act="tanh")

    mid, mov_fc = emb_fc("movie_id", movie_dict, 32, 32, "movie_table")
    cat = layers.data("category_id", [categories_len], dtype="int64")
    cat_emb = layers.embedding(cat, size=[category_dict, 32],
                               param_attr=ParamAttr(name="category_table"))
    cat_pool = layers.sequence_pool(cat_emb, "sum")
    title = layers.data("movie_title", [title_len], dtype="int64")
    title_emb = layers.embedding(title, size=[title_dict, 32],
                                 param_attr=ParamAttr(name="title_table"))
    title_conv = nets.sequence_conv_pool(title_emb, num_filters=32,
                                         filter_size=3, act="tanh",
                                         pool_type="sum")
    mov_combined = layers.fc(
        layers.concat([mov_fc, cat_pool, title_conv], axis=1),
        size=200, act="tanh")

    inference = layers.cos_sim(usr_combined, mov_combined)
    scale_infer = layers.scale(inference, scale=5.0)
    score = layers.data("score", [1], dtype="float32")
    cost = layers.square_error_cost(input=scale_infer, label=score)
    avg_cost = layers.mean(cost)
    feeds = [uid, gid, aid, jid, mid, cat, title, score]
    return feeds, avg_cost, scale_infer


# --- rnn_encoder_decoder (test_rnn_encoder_decoder.py:42,87,121) ----------

def rnn_encoder_decoder(src_dict=100, tgt_dict=100, embed_dim=16,
                        encoder_size=32, decoder_size=32, src_len=8,
                        tgt_len=8):
    """Seq2seq without attention: bi-LSTM encoder; the backward-direction
    first step boots the decoder (fc tanh), the forward last step is the
    per-step context (reference concatenates context each step; dense
    redesign: context is tiled over decoder time and concatenated with
    the target embedding before one dynamic_lstm)."""
    src = layers.data("src_word", [src_len], dtype="int64")
    tgt = layers.data("tgt_word", [tgt_len], dtype="int64")
    label = layers.data("label", [tgt_len], dtype="int64")

    src_emb = layers.embedding(src, size=[src_dict, embed_dim])
    fwd, _ = layers.lstm_layer(src_emb, encoder_size)
    bwd, _ = layers.lstm_layer(src_emb, encoder_size, is_reverse=True)
    src_forward_last = layers.sequence_last_step(fwd)
    src_backward_first = layers.sequence_first_step(bwd)
    context = layers.concat([src_forward_last, src_backward_first], axis=1)
    decoder_boot = layers.fc(src_backward_first, size=decoder_size,
                             act="tanh")

    tgt_emb = layers.embedding(tgt, size=[tgt_dict, embed_dim])
    ctx = layers.reshape(context, [-1, 1, 2 * encoder_size])
    ctx = layers.expand(ctx, [1, tgt_len, 1])
    dec_in = layers.concat([tgt_emb, ctx], axis=2)
    boot_c = layers.fill_constant_batch_size_like(
        decoder_boot, shape=[-1, decoder_size], dtype="float32", value=0.0)
    proj = layers.fc(dec_in, size=4 * decoder_size, num_flatten_dims=2)
    hidden, _ = layers.dynamic_lstm(proj, 4 * decoder_size,
                                    h_0=decoder_boot, c_0=boot_c)
    predict = layers.fc(hidden, size=tgt_dict, act="softmax",
                        num_flatten_dims=2)
    cost = layers.cross_entropy(
        input=layers.reshape(predict, [-1, tgt_dict]),
        label=layers.reshape(label, [-1, 1]))
    avg_cost = layers.mean(cost)
    return [src, tgt, label], avg_cost, predict


# --- label_semantic_roles (test_label_semantic_roles.py:53) ---------------

def db_lstm(word_dict=100, label_dict=10, pred_dict=50, mark_dict=2,
            word_dim=32, mark_dim=5, hidden_dim=64, depth=4, seq_len=8,
            emb_lr=2.0):
    """SRL deep bidirectional LSTM + CRF: 6 word-feature slots share one
    embedding table, predicate + mark have their own; per-slot fcs are
    summed; `depth` alternating-direction LSTM layers; final fc pair
    feeds linear_chain_crf (train) / crf_decoding (predict)."""
    word_slots = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2"]
    datas = [layers.data(f"{s}_data", [seq_len], dtype="int64")
             for s in word_slots]
    predicate = layers.data("verb_data", [seq_len], dtype="int64")
    mark = layers.data("mark_data", [seq_len], dtype="int64")
    target = layers.data("target", [seq_len], dtype="int64")

    pred_emb = layers.embedding(predicate, size=[pred_dict, word_dim],
                                param_attr=ParamAttr(name="vemb"))
    mark_emb = layers.embedding(mark, size=[mark_dict, mark_dim])
    emb_layers = [
        layers.embedding(x, size=[word_dict, word_dim],
                         param_attr=ParamAttr(name="emb",
                                              learning_rate=emb_lr))
        for x in datas]
    emb_layers += [pred_emb, mark_emb]

    hidden_0 = layers.sequence.sum(
        [layers.fc(e, size=hidden_dim, num_flatten_dims=2)
         for e in emb_layers])
    lstm_0, _ = layers.dynamic_lstm(
        layers.fc(hidden_0, size=4 * hidden_dim, num_flatten_dims=2),
        size=4 * hidden_dim)

    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sequence.sum([
            layers.fc(input_tmp[0], size=hidden_dim, num_flatten_dims=2),
            layers.fc(input_tmp[1], size=hidden_dim, num_flatten_dims=2)])
        lstm, _ = layers.dynamic_lstm(
            layers.fc(mix_hidden, size=4 * hidden_dim, num_flatten_dims=2),
            size=4 * hidden_dim, is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    feature_out = layers.sequence.sum([
        layers.fc(input_tmp[0], size=label_dict, act="tanh",
                  num_flatten_dims=2),
        layers.fc(input_tmp[1], size=label_dict, act="tanh",
                  num_flatten_dims=2)])

    crf_cost = layers.linear_chain_crf(
        feature_out, target,
        param_attr=ParamAttr(name="crfw", learning_rate=1.0))
    avg_cost = layers.mean(layers.scale(crf_cost, scale=-1.0))
    crf_decode = layers.crf_decoding(feature_out,
                                     param_attr=ParamAttr(name="crfw"))
    feeds = datas + [predicate, mark, target]
    return feeds, avg_cost, crf_decode

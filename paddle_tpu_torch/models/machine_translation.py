"""Seq2seq machine translation with attention, and its beam-search
decode (counterpart of paddle_tpu/models/machine_translation.py).

A GRU encoder and a decoder step of dot-product attention and a GRU cell,
trained with teacher forcing; the decode runs the same step inside a
beam search.  Dense [B, T] batches; the decoder step is a layers.StaticRNN
(one ``static_rnn_scan`` op, a loop over the target steps), and the beam
loop is another, max_len steps long.

Both programs name every parameter explicitly, so a decode program built
after training reads the trained weights from the scope.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..framework.layer_helper import ParamAttr


def _attr(name):
    return ParamAttr(name=name)


def _attention(h, enc_states):
    """Dot-product attention: h [N, H], enc_states [N, Ts, H] ->
    context [N, H] (the reference book example's simple_attention)."""
    scores = layers.matmul(enc_states, layers.unsqueeze(h, [2]))  # [N,Ts,1]
    w = layers.softmax(scores, axis=1)
    ctx = layers.reduce_sum(layers.elementwise_mul(enc_states, w), dim=[1])
    return ctx


def _encoder(src, vocab_size, emb_dim, hidden_dim):
    emb = layers.embedding(src, size=[vocab_size, emb_dim],
                           param_attr=_attr("src_emb"))
    proj = layers.fc(emb, size=hidden_dim * 3, num_flatten_dims=2,
                     param_attr=_attr("enc_fc.w"), bias_attr=False)
    states = layers.dynamic_gru(proj, size=hidden_dim,
                                param_attr=_attr("enc_gru.w"),
                                bias_attr=_attr("enc_gru.b"))   # [B,Ts,H]
    Ts = int(states.shape[1])
    last = layers.squeeze(
        layers.slice(states, axes=[1], starts=[Ts - 1], ends=[Ts]), [1])
    return states, last


def _decoder_step(tok_emb, h_prev, enc_states, hidden_dim):
    """One decoder step: attention, then a GRU cell.  The teacher-forced
    training loop and the beam decode loop share it, and so its
    parameter names."""
    ctx = _attention(h_prev, enc_states)
    inp = layers.fc(layers.concat([tok_emb, ctx], axis=1),
                    size=hidden_dim * 3,
                    param_attr=_attr("dec_fc.w"), bias_attr=False)
    h, _, _ = layers.gru_unit(inp, h_prev, hidden_dim * 3,
                              param_attr=_attr("dec_gru.w"),
                              bias_attr=_attr("dec_gru.b"))
    return h


def build_train_net(src_vocab, tgt_vocab, src_len, tgt_len, emb_dim=32,
                    hidden_dim=32):
    """Feeds: src [B,Ts] int64, tgt [B,Tt] int64 (decoder input,
    start-token shifted), lbl [B,Tt] int64.  Returns (feeds, avg_cost)."""
    src = layers.data("src", [src_len], dtype="int64")
    tgt = layers.data("tgt", [tgt_len], dtype="int64")
    lbl = layers.data("lbl", [tgt_len], dtype="int64")

    enc_states, enc_last = _encoder(src, src_vocab, emb_dim, hidden_dim)
    tgt_emb = layers.embedding(tgt, size=[tgt_vocab, emb_dim],
                               param_attr=_attr("tgt_emb"))

    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(tgt_emb)                 # [B, E]
        h_prev = rnn.memory(init=enc_last)            # [B, H]
        h = _decoder_step(x_t, h_prev, enc_states, hidden_dim)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    dec_out = rnn()                                   # [B, Tt, H]

    logits = layers.fc(dec_out, size=tgt_vocab, num_flatten_dims=2,
                       param_attr=_attr("out_fc.w"),
                       bias_attr=_attr("out_fc.b"))
    cost = layers.softmax_with_cross_entropy(
        layers.reshape(logits, [-1, tgt_vocab]),
        layers.reshape(lbl, [-1, 1]))
    avg_cost = layers.mean(cost)
    return [src, tgt, lbl], avg_cost


def build_decode_net(src_vocab, tgt_vocab, src_len, beam_size=4,
                     max_len=8, start_id=0, end_id=1, emb_dim=32,
                     hidden_dim=32):
    """The beam-search decode program (built after training, run in its
    scope).  The token and beam tensors are declared int32.

    Returns (feeds, sentence_ids [B,K,Tmax], sentence_scores [B,K])."""
    from ..framework.layer_helper import LayerHelper
    K = beam_size
    src = layers.data("src", [src_len], dtype="int64")
    enc_states, enc_last = _encoder(src, src_vocab, emb_dim, hidden_dim)

    # tile encoder outputs across beams: [B,Ts,H] -> [B*K,Ts,H]
    Ts, H = int(enc_states.shape[1]), hidden_dim
    enc_k = layers.reshape(
        layers.expand(layers.unsqueeze(enc_states, [1]), [1, K, 1, 1]),
        [-1, Ts, H])
    h0 = layers.reshape(
        layers.expand(layers.unsqueeze(enc_last, [1]), [1, K, 1]), [-1, H])

    # beam state: scores [B,K] (row 0 live, others -inf), tokens [B,K]
    scores0 = layers.fill_constant_batch_size_like(src, [-1, K], "float32",
                                                   0.0)
    mask_row = np.full((1, K), -1e9, "float32")
    mask_row[0, 0] = 0.0
    scores0 = layers.elementwise_add(scores0, layers.assign(mask_row))
    tok0 = layers.fill_constant_batch_size_like(src, [-1, K], "int32",
                                                start_id)
    dummy = layers.fill_constant_batch_size_like(src, [-1, max_len, 1],
                                                 "float32", 0.0)

    helper = LayerHelper("beam_decode")
    rnn = layers.StaticRNN()
    with rnn.step():
        rnn.step_input(dummy)                          # drives the length
        h_prev = rnn.memory(init=h0)                   # [B*K, H]
        sc_prev = rnn.memory(init=scores0)             # [B, K]
        tok_prev = rnn.memory(init=tok0)               # [B, K]

        emb = layers.reshape(
            layers.embedding(tok_prev, size=[tgt_vocab, emb_dim],
                             param_attr=_attr("tgt_emb")),
            [-1, emb_dim])                             # [B*K, E]
        h = _decoder_step(emb, h_prev, enc_k, hidden_dim)
        logits = layers.fc(h, size=tgt_vocab,
                           param_attr=_attr("out_fc.w"),
                           bias_attr=_attr("out_fc.b"))
        logp = layers.reshape(layers.log_softmax(logits),
                              [-1, K, tgt_vocab])      # [B, K, V]

        sc = helper.create_variable_for_type_inference("float32")
        ids = helper.create_variable_for_type_inference("int32")
        parents = helper.create_variable_for_type_inference("int32")
        h_re = helper.create_variable_for_type_inference("float32")
        helper.main_program.current_block().append_op(
            "beam_search",
            {"PreScores": [sc_prev.name], "PreIds": [tok_prev.name],
             "LogProbs": [logp.name],
             "State": [layers.reshape(h, [-1, K, H]).name]},
            {"Scores": [sc.name], "Ids": [ids.name],
             "Parents": [parents.name], "StateOut": [h_re.name]},
            {"beam_size": K, "end_id": end_id})

        rnn.update_memory(h_prev, layers.reshape(h_re, [-1, H]))
        rnn.update_memory(sc_prev, sc)
        rnn.update_memory(tok_prev, ids)
        rnn.step_output(ids)
        rnn.step_output(parents)
        rnn.step_output(sc)
    ids_t, parents_t, scores_t = rnn.outputs()         # each [Tmax, B, K]

    final_scores = layers.squeeze(
        layers.slice(scores_t, axes=[0], starts=[max_len - 1],
                     ends=[max_len]), [0])             # [B, K]
    sent = helper.create_variable_for_type_inference("int32")
    sent_scores = helper.create_variable_for_type_inference("float32")
    helper.main_program.current_block().append_op(
        "beam_search_decode",
        {"Ids": [ids_t.name], "Parents": [parents_t.name],
         "Scores": [final_scores.name]},
        {"SentenceIds": [sent.name], "SentenceScores": [sent_scores.name]},
        {})
    return [src], sent, sent_scores


def make_copy_task_batch(batch, src_len, vocab, seed=0, start_id=0,
                         end_id=1):
    """A synthetic copy task: the target is the source (ids >= 2), the
    decoder's input the source shifted right behind start_id.  A few
    hundred steps make a greedy decode echo it."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, vocab, (batch, src_len)).astype("int64")
    tgt_in = np.concatenate(
        [np.full((batch, 1), start_id, "int64"), src[:, :-1]], axis=1)
    lbl = src.copy()
    return {"src": src, "tgt": tgt_in, "lbl": lbl}

"""Stacked-LSTM text classification (counterpart of
paddle_tpu/models/stacked_lstm.py: stacked_lstm_net, build_train_net and
make_fake_batch): embedding -> [fc(4H) -> dynamic_lstm] x n_layers ->
max pool over time -> fc softmax.  Sequences are dense [B, T] int64 with
a float mask [B, T] (1 = token); the recurrence is ops/rnn_ops.py's."""
from __future__ import annotations

import numpy as np

from .. import layers


def stacked_lstm_net(words, mask, dict_dim, num_classes=2, emb_dim=128,
                     hidden_dim=128, num_layers=2):
    """words [B, T] int64, mask [B, T] float32.  Returns the softmax
    prediction: each level feeds the previous hidden sequence through an
    fc to the 4H gates and an LSTM; the last level's hidden states are
    max-pooled over the tokens the mask keeps."""
    emb = layers.embedding(words, size=[dict_dim, emb_dim])
    x = emb
    for _ in range(num_layers):
        proj = layers.fc(x, size=hidden_dim * 4, num_flatten_dims=2,
                         bias_attr=False)
        x, _ = layers.dynamic_lstm(proj, size=hidden_dim * 4, mask=mask)
    # masked max pool over time: padded steps pushed to -1e9
    neg = layers.scale(mask, scale=-1.0, bias=1.0)        # 1 at pad
    neg = layers.scale(neg, scale=-1e9)                   # -1e9 at pad
    x = layers.elementwise_add(x, layers.unsqueeze(neg, [2]))
    pooled = layers.reduce_max(x, dim=1)                  # [B, H]
    return layers.fc(pooled, size=num_classes, act="softmax")


def build_train_net(dict_dim=1000, seq_len=32, num_classes=2,
                    emb_dim=64, hidden_dim=64, num_layers=2):
    """Builds (feeds, avg_loss, acc, prediction) in the default program."""
    words = layers.data("words", [seq_len], dtype="int64")
    mask = layers.data("mask", [seq_len], dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    pred = stacked_lstm_net(words, mask, dict_dim, num_classes=num_classes,
                            emb_dim=emb_dim, hidden_dim=hidden_dim,
                            num_layers=num_layers)
    cost = layers.cross_entropy(input=pred, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=pred, label=label)
    return [words, mask, label], avg_loss, acc, pred


def make_fake_batch(batch_size, dict_dim=1000, seq_len=32, num_classes=2,
                    seed=0):
    """A separable task: each class owns a band of the vocabulary; the
    lengths are uniform in [seq_len // 2, seq_len], pads id 0."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, num_classes, (batch_size, 1)).astype("int64")
    band = dict_dim // num_classes
    words = rng.randint(0, band, (batch_size, seq_len)).astype("int64")
    words = words + band * label
    lens = rng.randint(seq_len // 2, seq_len + 1, (batch_size,))
    mask = (np.arange(seq_len)[None, :] < lens[:, None]).astype("float32")
    words = (words * mask).astype("int64")
    return {"words": words, "mask": mask, "label": label}

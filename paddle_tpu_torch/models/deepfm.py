"""DeepFM CTR, BASELINE config 4 (high-dim sparse embedding).

Counterpart of paddle_tpu/models/deepfm.py:19-122: ``DeepFMConfig``,
``deepfm``, ``build_train_net``, ``make_fake_batch`` and
``build_sparse_train_net``, building the same program (op list, slots,
attrs, var and parameter names: ``fm_w1``, ``fm_emb``, the ``fc_*``) as
the JAX package.  The tables' gradients are dense, as JAX's autodiff of
its gather gives them: F.embedding's backward writes a [V, K] tensor
that is 0 on every row no id named, and the optimizer updates the whole
table.  A sharded table (``sparse_shard_axis``) needs the parallel
planes (ROADMAP queue A.7): ``ParamAttr`` refuses it.  The criteo
helpers of the JAX module (:125-186) belong to the streaming sparse
trainer, which is not ported.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..framework.layer_helper import ParamAttr


class DeepFMConfig:
    def __init__(self, num_field=39, vocab_size=1000001, embed_dim=10,
                 fc_sizes=(400, 400, 400), sparse_shard_axis=None):
        self.num_field = num_field
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.fc_sizes = tuple(fc_sizes)
        # the axis to row-shard the big tables over; None = one table
        self.sparse_shard_axis = sparse_shard_axis


def deepfm(feat_ids, feat_vals, cfg: DeepFMConfig, embed=None):
    """feat_ids [B,F] int64, feat_vals [B,F] float32 -> the click logit
    [B,1]: FM first order + second order + a deep MLP (Guo et al. 2017).
    ``embed(input, size, name)`` builds the table lookups: by default
    :func:`layers.embedding`; the sparse build swaps in the hash-bucketed
    :func:`layers.sparse_embedding`, so one forward serves both."""
    if embed is None:
        shard = ((cfg.sparse_shard_axis, None)
                 if cfg.sparse_shard_axis else None)

        def embed(input, size, name):
            return layers.embedding(
                input, size=size,
                param_attr=ParamAttr(name=name, sharding=shard))

    # first-order weights: [V,1] table
    w1 = embed(feat_ids, [cfg.vocab_size, 1], "fm_w1")           # [B,F,1]
    first_order = layers.reduce_sum(
        layers.elementwise_mul(layers.squeeze(w1, [2]), feat_vals),
        dim=[1], keep_dim=True)                                   # [B,1]

    # second-order: embeddings [V,K]
    emb = embed(feat_ids, [cfg.vocab_size, cfg.embed_dim],
                "fm_emb")                                         # [B,F,K]
    vals = layers.unsqueeze(feat_vals, [2])                       # [B,F,1]
    xv = layers.elementwise_mul(emb, vals)                        # [B,F,K]
    sum_sq = layers.square(layers.reduce_sum(xv, dim=[1]))        # [B,K]
    sq_sum = layers.reduce_sum(layers.square(xv), dim=[1])        # [B,K]
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum),
                          dim=[1], keep_dim=True), scale=0.5)     # [B,1]

    # deep part
    deep = layers.reshape(xv, [-1, cfg.num_field * cfg.embed_dim])
    for size in cfg.fc_sizes:
        deep = layers.fc(deep, size=size, act="relu")
    deep_out = layers.fc(deep, size=1, act=None)                  # [B,1]

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, second_order), deep_out)
    return logit


def build_train_net(cfg: DeepFMConfig, embed=None):
    """Feeds feat_ids [B,F] int64, feat_vals [B,F] f32, label [B,1] f32;
    returns (feeds, mean sigmoid cross-entropy, prob = sigmoid(logit))."""
    feat_ids = layers.data("feat_ids", [cfg.num_field], dtype="int64")
    feat_vals = layers.data("feat_vals", [cfg.num_field], dtype="float32")
    label = layers.data("label", [1], dtype="float32")
    logit = deepfm(feat_ids, feat_vals, cfg, embed=embed)
    cost = layers.sigmoid_cross_entropy_with_logits(logit, label)
    avg_cost = layers.mean(cost)
    prob = layers.sigmoid(logit)
    return [feat_ids, feat_vals, label], avg_cost, prob


def make_fake_batch(cfg: DeepFMConfig, batch_size: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, cfg.vocab_size,
                                (batch_size, cfg.num_field)).astype("int64"),
        "feat_vals": rng.rand(batch_size, cfg.num_field).astype("float32"),
        "label": rng.randint(0, 2, (batch_size, 1)).astype("float32"),
    }


def build_sparse_train_net(cfg: DeepFMConfig):
    """The same :func:`deepfm` forward over ``sparse_embedding_lookup``
    with hash bucketing on, so raw ids of any magnitude fold into the
    ``vocab_size`` buckets (the host-side twin is
    sparse/table.hash_bucket)."""
    def embed(input, size, name):
        return layers.sparse_embedding(
            input, size=size, param_attr=ParamAttr(name=name))

    return build_train_net(cfg, embed=embed)

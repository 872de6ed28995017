"""PinSage training glue: batch assembly + margin-loss task.

Replaces the eager-only loop of ``pinsage/train/train.py:40-91`` with a
host sampler producing fixed-shape block batches and a fully jitted train
step (margin loss ``max(0, neg + δ - pos)``, δ=1 — ``train.py:17-20``).
"""
from __future__ import annotations

from typing import Iterator

import jax.numpy as jnp
import numpy as np

from recommender_tpu.graph.bipartite import BipartiteGraph, sample_block_batch
from recommender_tpu.nn.losses import margin_loss


def pinsage_train_batches(
    g: BipartiteGraph,
    batch_size: int,
    seed: int = 0,
    **sampler_kw,
) -> Iterator[dict]:
    """Endless {block tensors for [heads; pos; neg]} batches.

    Leakage parity (``data_loader.py:34-39``): each head's sampled frontier
    excludes its pos/neg tail and vice versa."""
    rng = np.random.default_rng(seed)
    while True:
        heads, pos, neg = g.item2item_pairs(batch_size, rng)
        n = len(heads)
        if n < batch_size:  # pad dropped -1 walks to keep shapes static
            extra = batch_size - n
            heads = np.concatenate([heads, heads[:1].repeat(extra)])
            pos = np.concatenate([pos, pos[:1].repeat(extra)])
            neg = np.concatenate([neg, neg[:1].repeat(extra)])
        nodes = np.concatenate([heads, pos, neg]).astype(np.int32)
        exclude = np.concatenate(
            [
                np.stack([pos, neg], axis=1),  # heads exclude their tails
                np.stack([heads, heads], axis=1),  # pos tails exclude head
                np.stack([heads, heads], axis=1),  # neg tails exclude head
            ],
            axis=0,
        )
        block = sample_block_batch(g, nodes, rng, exclude=exclude, **sampler_kw)
        yield block.as_dict()


def make_pinsage_task(model, delta: float = 1.0):
    def loss_fn(params, model_state, batch, rng, train):
        (pos_score, neg_score), new_ms, diag = model.apply(
            params, model_state, batch, train=train, rng=rng
        )
        per_ex = margin_loss(pos_score, neg_score, delta)
        aux = {
            "pos_score": jnp.mean(pos_score),
            "neg_score": jnp.mean(neg_score),
            **diag,
        }
        return per_ex, aux, new_ms

    return loss_fn

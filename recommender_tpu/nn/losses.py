"""Losses used across the model zoo.

* ``binary_cross_entropy`` / ``bce_with_logits`` — keras BCE parity
  (``ctr/train.py:85``, ``dien/train.py:14-24``, ``esmm/train.py``).
* ``sampled_sigmoid_ce`` — skip-gram sampled-softmax sigmoid CE over
  [1 pos, k neg] logits (``eges/train.py:14-23``).
* ``margin_loss`` — PinSage max-margin ranking loss
  (``pinsage/train/train.py:17-20``).
* ``masked_auxiliary_loss`` — DIEN per-example masked-mean auxiliary BCE
  (``dien/layers.py:89-108``).

All are pure, jittable, and return **per-example** losses unless noted, so
callers control global-batch scaling explicitly (the analogue of
``tf.nn.compute_average_loss``, ``dien/distribute_train.py:53``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-7


def binary_cross_entropy(probs: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """BCE on probabilities in (0,1). Matches keras BinaryCrossentropy."""
    p = jnp.clip(probs, EPS, 1.0 - EPS)
    labels = labels.astype(p.dtype)
    return -(labels * jnp.log(p) + (1.0 - labels) * jnp.log1p(-p))


def bce_with_logits(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Numerically-stable sigmoid CE (tf.nn.sigmoid_cross_entropy_with_logits)."""
    labels = labels.astype(logits.dtype)
    return jnp.maximum(logits, 0.0) - logits * labels + jnp.log1p(
        jnp.exp(-jnp.abs(logits))
    )


def sampled_sigmoid_ce(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Mean sigmoid-CE over the candidate axis: [B, 1+k] logits/labels → [B]."""
    return jnp.mean(bce_with_logits(logits, labels), axis=-1)


def margin_loss(
    pos_score: jnp.ndarray, neg_score: jnp.ndarray, delta: float = 1.0
) -> jnp.ndarray:
    """Max-margin: max(0, neg + delta - pos), per example."""
    return jnp.maximum(0.0, neg_score + delta - pos_score)


def masked_auxiliary_loss(
    pos_logits: jnp.ndarray,  # [B, T-1]
    neg_logits: jnp.ndarray,  # [B, T-1]
    mask: jnp.ndarray,  # [B, T-1] (1 = real step)
) -> jnp.ndarray:
    """DIEN auxiliary loss: per-example mean over valid steps of
    BCE(pos→1) and BCE(neg→0). Returns [B]."""
    m = mask.astype(jnp.float32)
    pos_l = bce_with_logits(pos_logits, jnp.ones_like(pos_logits)) * m
    neg_l = bce_with_logits(neg_logits, jnp.zeros_like(neg_logits)) * m
    denom = jnp.maximum(jnp.sum(m, axis=-1) * 2.0, 1.0)
    return (jnp.sum(pos_l, axis=-1) + jnp.sum(neg_l, axis=-1)) / denom

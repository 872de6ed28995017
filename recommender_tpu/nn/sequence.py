"""Behavior-sequence layers: masked pooling, DIN attention, DIEN attention.

Parity targets (behavioral, not structural):
* ``masked_mean_pool``      — ``dien/layers.py:5-17``  (pad-aware average).
* ``LocalActivationUnit``   — ``dien/layers.py:34-59`` (DIN: target⊕hist⊕diff⊕
  prod → sigmoid MLP 80→40→1 weights, mask-multiplied, *non-normalized*
  weighted sum of history).
* ``AuxiliaryNet``          — ``dien/layers.py:62-73`` (sigmoid 80→40→1 head).
* ``DIENAttention``         — ``dien/layers.py:136-158`` (bilinear h·W·target,
  additive -1e9 mask, softmax over time).

All layers take an explicit ``mask`` [B, T] (True = real step), computed
upstream from ``item_id != 0`` (the analogue of keras ``mask_zero=True``,
``dien/model.py:11-12``). Everything is batched matmul / elementwise —
no per-step host loops.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.nn.layers import dense, dense_init, lecun_normal


def masked_mean_pool(his: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """[B, T, D], [B, T] → [B, D]: average over real (unmasked) steps."""
    m = mask.astype(his.dtype)[..., None]  # [B, T, 1]
    s = jnp.sum(his * m, axis=1)
    n = jnp.maximum(jnp.sum(m, axis=1), 1.0)
    return s / n


def _sigmoid_tower_init(key, in_dim: int, units: Sequence[int]) -> dict:
    keys = jax.random.split(key, len(units))
    dims = (in_dim, *units)
    return {f"Dense_{i}": dense_init(keys[i], dims[i], dims[i + 1]) for i in range(len(units))}


def _sigmoid_tower(params: dict, x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Dense_0..Dense_{n-1}, sigmoid between layers, linear last layer."""
    for i in range(n - 1):
        x = jax.nn.sigmoid(dense(params[f"Dense_{i}"], x))
    return dense(params[f"Dense_{n - 1}"], x)


@dataclasses.dataclass(frozen=True)
class AuxiliaryNet:
    """Sigmoid-activated MLP head producing one logit per step."""

    units: Sequence[int] = (80, 40, 1)

    def init(self, key, x: jnp.ndarray) -> dict:
        return _sigmoid_tower_init(key, x.shape[-1], self.units)

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.squeeze(_sigmoid_tower(params, x, len(self.units)), axis=-1)


@dataclasses.dataclass(frozen=True)
class LocalActivationUnit:
    """DIN attention: returns the weighted history representation [B, D].

    Weights are raw MLP outputs (not softmaxed) zeroed at padded steps —
    the reference deliberately skips normalization (DIN paper §) and so do we.
    """

    hidden: Sequence[int] = (80, 40)

    def init(self, key, target, history, mask) -> dict:
        return _sigmoid_tower_init(key, 4 * history.shape[-1], (*self.hidden, 1))

    def apply(
        self, params: dict, target: jnp.ndarray, history: jnp.ndarray, mask: jnp.ndarray
    ) -> jnp.ndarray:
        # target [B, D] (or [B, 1, D]), history [B, T, D], mask [B, T]
        if target.ndim == 2:
            target = target[:, None, :]
        t = jnp.broadcast_to(target, history.shape)
        x = jnp.concatenate([t, history, t - history, t * history], axis=-1)
        w = _sigmoid_tower(params, x, len(self.hidden) + 1)  # [B, T, 1]
        w = w * mask.astype(w.dtype)[..., None]
        return jnp.einsum("btd,bto->bd", history, w)


@dataclasses.dataclass(frozen=True)
class DIENAttention:
    """Bilinear attention scores softmaxed over time. Returns [B, T, 1]."""

    def init(self, key, target, hidden, mask) -> dict:
        return {"kernel": lecun_normal(key, (hidden.shape[-1], target.shape[-1]))}

    def apply(
        self, params: dict, target: jnp.ndarray, hidden: jnp.ndarray, mask: jnp.ndarray
    ) -> jnp.ndarray:
        # target [B, D_t] or [B, 1, D_t]; hidden [B, T, H]; mask [B, T]
        if target.ndim == 3:
            target = jnp.squeeze(target, axis=1)
        trans = jnp.einsum("bth,hd->btd", hidden, params["kernel"])
        score = jnp.einsum("btd,bd->bt", trans, target)
        score = score + (1.0 - mask.astype(score.dtype)) * -1e9
        score = jax.nn.softmax(score, axis=1)
        return score[..., None]

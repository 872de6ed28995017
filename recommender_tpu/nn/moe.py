"""Mixture-of-experts gating (MMOE).

Re-design of ``esmm/mmoe.py:8-46``: the reference runs its
8 experts as a serial Python loop of small MLPs; here the expert params are
stacked on a leading expert axis and ``jax.vmap`` runs all experts as ONE
batched contraction per layer. The per-task softmax gates then mix expert
outputs with one more einsum.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.nn.layers import dense, dense_init
from recommender_tpu.nn.mlp import MLP


@dataclasses.dataclass(frozen=True)
class ExpertBank:
    """num_experts parallel MLPs with stacked params ``experts/Dense_i``
    ([E, ...] leaves). [B, D] → [B, E, H]."""

    num_experts: int
    units: Sequence[int]

    @property
    def mlp(self) -> MLP:
        return MLP(tuple(self.units), final_activation=jax.nn.relu)

    def init(self, key, x: jnp.ndarray) -> dict:
        keys = jax.random.split(key, self.num_experts)
        in_dim = x.shape[-1]
        return {"experts": jax.vmap(lambda k: self.mlp.init(k, in_dim))(keys)}

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        return jax.vmap(lambda p: self.mlp.apply(p, x), out_axes=1)(params["experts"])


@dataclasses.dataclass(frozen=True)
class MMOEGate:
    """Per-task softmax gate over experts: [B, D], [B, E, H] → [B, H]."""

    num_experts: int

    def init(self, key, x: jnp.ndarray) -> dict:
        return {"Dense_0": dense_init(key, x.shape[-1], self.num_experts)}

    def apply(self, params: dict, x: jnp.ndarray, expert_out: jnp.ndarray) -> jnp.ndarray:
        w = jax.nn.softmax(dense(params["Dense_0"], x), axis=-1)  # [B, E]
        return jnp.einsum("be,beh->bh", w, expert_out)

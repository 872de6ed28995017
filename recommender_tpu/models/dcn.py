"""DCNv2 — cross network ∥ deep tower over the shared Criteo embedding.

Beyond-reference model (the reference's CTR zoo stops at DeepFM + DLRM;
DCNv2 is the third standard interaction family). Same pipeline contract
as ``deepfm.py``/``dlrm.py``: one shared table for the 26 categorical
features (``ctr/model.py:6-31`` shape conventions), 13 log-transformed
dense ints, ``batch['label']`` CTR task — so every existing knob
(``partition``/``lookup_mode``/``embed_param_dtype`` + stochastic
rounding, dedup plans, the planner) applies unchanged, and
``cli/train_ctr --model_type DCN`` trains it on the same shards.

Structure (Wang et al. 2021, the "parallel" variant):
x0 = [flat embeddings ∥ ints] → CrossNetwork(x0) ∥ MLP(x0) → concat →
Dense(1) → sigmoid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.cross import CrossNetwork
from recommender_tpu.nn.layers import dense, dense_init
from recommender_tpu.nn.mlp import MLP
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class DCN:
    """Params: ``embedding/embedding``, ``cross/cross_i``, ``deep/Dense_i``, ``head``."""

    vocab_size: int
    embed_dim: int = 16
    num_int: int = 13
    num_cat: int = 26
    cross_layers: int = 3
    deep_units: Sequence[int] = (512, 256)
    partition: Optional[str] = None

    lookup_mode: str = "gspmd"
    mesh: Optional[object] = None
    capacity_factor: float = 2.0
    embed_compute_dtype: Optional[jnp.dtype] = None
    embed_param_dtype: jnp.dtype = jnp.float32  # bf16 + SR: see DLRM.embed_param_dtype

    @property
    def embedding(self) -> Embedding:
        return Embedding(
            self.vocab_size, self.embed_dim, partition=self.partition,
            lookup_mode=self.lookup_mode, mesh=self.mesh,
            capacity_factor=self.capacity_factor,
            compute_dtype=self.embed_compute_dtype,
            param_dtype=self.embed_param_dtype,
        )

    @property
    def cross(self) -> CrossNetwork:
        return CrossNetwork(self.cross_layers)

    @property
    def deep(self) -> MLP:
        return MLP(tuple(self.deep_units), final_activation=jax.nn.relu)

    def sharded_params(self) -> dict:
        return table_specs({"embedding": self.embedding})

    def init(self, key, example: dict):
        k_emb, k_cross, k_deep, k_head = jax.random.split(key, 4)
        d = self.num_cat * self.embed_dim + self.num_int
        x0 = jax.ShapeDtypeStruct((1, d), jnp.float32)
        params = {
            "embedding": self.embedding.init(k_emb),
            "cross": self.cross.init(k_cross, x0),
            "deep": self.deep.init(k_deep, d),
            "head": dense_init(k_head, d + self.deep_units[-1], 1),
        }
        return params, {}

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        ints = batch["int_features"].reshape(-1, self.num_int)
        cats = batch["cat_features"].reshape(-1, self.num_cat)
        emb, diag = self.embedding.apply(
            params["embedding"], cats, dedup_plan=batch.get("cat_dedup")
        )
        x0 = jnp.concatenate(
            [emb.reshape(emb.shape[0], -1).astype(jnp.float32), ints], axis=1
        )
        out = jnp.concatenate(
            [self.cross.apply(params["cross"], x0), self.deep.apply(params["deep"], x0)],
            axis=1,
        )
        prob = jax.nn.sigmoid(jnp.squeeze(dense(params["head"], out), axis=-1))
        return prob, model_state, diag

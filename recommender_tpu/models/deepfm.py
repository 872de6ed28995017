"""DeepFM — FM second-order cross + deep tower over a shared embedding.

Behavioral parity with ``ctr/model.py:6-31``:
* one shared table for all categorical features;
* FM 2nd-order term via the sum-square/square-sum identity
  (``ctr/model.py:21-23``; no 1st-order linear term, as in the reference);
* deep tower on [flattened embeddings ∥ 13 dense ints];
* output = sigmoid(fm + deep).

Hidden activations are ReLU (see divergence note in ``dlrm.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.interactions import fm_cross
from recommender_tpu.nn.mlp import MLP
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class DeepFM:
    """Params: ``embedding/embedding``, ``mlp/Dense_i``."""

    vocab_size: int
    embed_dim: int = 16
    num_int: int = 13
    num_cat: int = 26
    mlp_units: Sequence[int] = (512, 256, 1)
    partition: Optional[str] = None

    lookup_mode: str = "gspmd"  # 'a2a' = explicit all-to-all exchange (needs mesh)
    mesh: Optional[object] = None
    capacity_factor: float = 2.0  # a2a bucket size; see Embedding.capacity_factor
    embed_compute_dtype: Optional[jnp.dtype] = None  # see Embedding.compute_dtype
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
    def mlp(self) -> MLP:
        return MLP(tuple(self.mlp_units), final_activation=None)

    def sharded_params(self) -> dict:
        return table_specs({"embedding": self.embedding})

    def init(self, key, example: dict):
        k_emb, k_mlp = jax.random.split(key)
        in_dim = self.num_cat * self.embed_dim + self.num_int
        params = {
            "embedding": self.embedding.init(k_emb),
            "mlp": self.mlp.init(k_mlp, in_dim),
        }
        return params, {}

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        ints = batch["int_features"].reshape(-1, self.num_int)
        cats = batch["cat_features"].reshape(-1, self.num_cat)
        # Optional host-precomputed dedup plan (data.pipeline.with_dedup_plans).
        emb, diag = self.embedding.apply(
            params["embedding"], cats, dedup_plan=batch.get("cat_dedup")
        )  # [B, F, D]
        fm = fm_cross(emb)  # [B]
        deep_in = jnp.concatenate(
            [emb.reshape(emb.shape[0], -1), ints], axis=1
        )
        deep = jnp.squeeze(self.mlp.apply(params["mlp"], deep_in), axis=-1)  # [B]
        return jax.nn.sigmoid(fm + deep), model_state, diag

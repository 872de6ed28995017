"""DLRM — dense-bottom MLP + sharded embeddings + dot interaction + top MLP.

Behavioral parity with ``ctr/model.py:34-58``:
* single shared embedding table over all 26 categorical features;
* bottom MLP on the 13 dense ints, its output treated as a 27th embedding
  (``ctr/model.py:51-52``);
* DotInteraction(self_interaction=False, skip_gather=True) → dense
  ``(26+1)^2`` output (``ctr/model.py:55`` top-MLP width contract);
* top MLP on [interaction ∥ bottom-MLP output] → sigmoid prob.

Deliberate divergence (documented per SURVEY.md §7): the reference's
``ctr/layers.py:5-14`` MLP has **linear** hidden layers (keras Dense default);
we use ReLU hidden activations as in the DLRM paper — strictly more
expressive, parity target is AUC, not bug-for-bug math.

The embedding table may be row-sharded over the ``model`` mesh axis
(``partition='model'``); interaction + MLPs run in bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.interactions import DotInteraction
from recommender_tpu.nn.mlp import MLP
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class DLRM:
    """Params: ``embedding/embedding``, ``bottom_mlp/Dense_i``, ``top_mlp/Dense_i``."""

    vocab_size: int
    embed_dim: int = 16
    num_int: int = 13
    num_cat: int = 26
    bottom_units: Sequence[int] = (512, 256, 64, 16)
    top_units: Sequence[int] = (512, 256, 1)
    partition: Optional[str] = None  # 'model' → row-sharded table
    lookup_mode: str = "gspmd"  # 'a2a' = explicit all-to-all exchange (needs mesh)
    mesh: Optional[object] = None
    capacity_factor: float = 2.0  # a2a bucket size; see Embedding.capacity_factor
    embed_compute_dtype: Optional[jnp.dtype] = None  # see Embedding.compute_dtype
    # Storage dtype of the table param itself. bf16 halves the table's
    # bytes in the scatter backward and the Adam update; the Trainer
    # auto-enables stochastic rounding for low-precision params
    # (core/optim.py adam_sr + SR param writes), which keeps the bf16 table
    # at the f32 table's quality (plain round-to-nearest loses AUC early in
    # training). f32 stays the default for parity with the reference's
    # replicated f32 tables.
    embed_param_dtype: jnp.dtype = jnp.float32

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
    def bottom_mlp(self) -> MLP:
        return MLP(tuple(self.bottom_units), final_activation=jax.nn.relu)

    @property
    def top_mlp(self) -> MLP:
        return MLP(tuple(self.top_units), final_activation=jax.nn.sigmoid)

    interaction = DotInteraction(self_interaction=False, skip_gather=True)

    def sharded_params(self) -> dict:
        return table_specs({"embedding": self.embedding})

    def init(self, key, example: dict):
        k_emb, k_bot, k_top = jax.random.split(key, 3)
        f = self.num_cat + 1
        top_in = f * f + self.bottom_units[-1]
        params = {
            "embedding": self.embedding.init(k_emb),
            "bottom_mlp": self.bottom_mlp.init(k_bot, self.num_int),
            "top_mlp": self.top_mlp.init(k_top, top_in),
        }
        return params, {}

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        ints = batch["int_features"].reshape(-1, self.num_int)
        cats = batch["cat_features"].reshape(-1, self.num_cat)
        # Optional host-precomputed dedup plan for the id stream (attached
        # by data.pipeline.with_dedup_plans; see embedding.table.Embedding).
        cat_emb, diag = self.embedding.apply(
            params["embedding"], cats, dedup_plan=batch.get("cat_dedup")
        )  # [B, 26, D]
        bottom = self.bottom_mlp.apply(params["bottom_mlp"], ints)  # [B, D]
        feats = jnp.concatenate([cat_emb, bottom[:, None, :]], axis=1)  # [B, 27, D]
        inter = self.interaction(feats)  # [B, 27*27]
        top_in = jnp.concatenate([inter, bottom], axis=1)
        prob = self.top_mlp.apply(params["top_mlp"], top_in)
        return jnp.squeeze(prob, axis=-1), model_state, diag

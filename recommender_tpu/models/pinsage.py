"""PinSage — importance-pooling graph convolution for item retrieval.

Behavioral parity with ``pinsage/train``:
* ``FeatureProjector`` — id/year/genre embeddings gathered for sampled
  nodes, concat dim 3*E (``layers.py:49-81``). Divergence (documented):
  the reference *embeds the 0/1 values* of the genre multi-hot through a
  ``num_genres``-row table (``layers.py:66-70``); we compute the intended
  multi-hot **mean of genre embeddings** (``multihot @ table / count``).
* ``Convolve`` — neighbor FC → importance-weighted mean with weight-sum
  clipped to ≥1 (``layers.py:23`` parity trap) → concat dst → FC → L2
  normalize. Divergence (documented, SURVEY.md §7 quirks): the reference
  normalizes by the norm of the whole batch tensor (``layers.py:28-29``);
  we L2-normalize **per row**, the PinSage paper semantics.
* ``SageNet`` — stacked Convolves + two output FCs (``layers.py:33-46``).
* scorer — per-pair dot product (``model.py:14-19`` ``u_dot_v``).

The ragged DGL blocks are replaced by the dense ``BlockBatch`` tree
(``recommender_tpu.graph.bipartite``): every op below is a batched matmul /
weighted segment mean with static shapes — the whole step jits (the
reference could not even ``tf.function`` its train step,
``pinsage/train/train.py:39``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.layers import dense, dense_init, embedding_init, merge_diagnostics
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class ItemFeatures:
    """Static per-item features (MovieLens: id implicit, year idx, genre multi-hot)."""

    year: np.ndarray  # [V] int32
    genre: np.ndarray  # [V, G] float32 multi-hot

    @property
    def num_items(self) -> int:
        return len(self.year)

    def __hash__(self):  # models are frozen dataclasses holding this
        return hash((self.year.shape, self.genre.shape, int(self.year.sum())))

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class FeatureProjector:
    """Params: ``year/embedding``, ``genre_embedding``, ``id/embedding``."""

    features: ItemFeatures
    embed_dim: int = 8
    # 'model' row-shards the ITEM id table (the only vocab that grows with
    # the corpus) over the model mesh axis; the year/genre tables are tiny
    # and stay replicated (the planner's replicate-below-threshold call).
    partition: str | None = None
    lookup_mode: str = "gspmd"  # 'psum'/'a2a' need mesh (Embedding.lookup_mode)
    mesh: object | None = None

    @property
    def year(self) -> Embedding:
        return Embedding(int(self.features.year.max()) + 1, self.embed_dim)

    @property
    def id(self) -> Embedding:
        return Embedding(
            self.features.num_items, self.embed_dim, partition=self.partition,
            lookup_mode=self.lookup_mode, mesh=self.mesh,
        )

    def init(self, key, ids=None) -> dict:
        k_year, k_genre, k_id = jax.random.split(key, 3)
        num_genres = self.features.genre.shape[1]
        return {
            "year": self.year.init(k_year),
            "genre_embedding": embedding_init(k_genre, (num_genres, self.embed_dim)),
            "id": self.id.init(k_id),
        }

    def apply(self, params: dict, ids: jnp.ndarray) -> tuple[jnp.ndarray, dict]:
        f = self.features
        year_emb, d_y = self.year.apply(params["year"], jnp.asarray(f.year)[ids])
        multihot = jnp.asarray(f.genre)[ids]  # [..., G]
        genre_emb = jnp.matmul(multihot, params["genre_embedding"]) / jnp.maximum(
            jnp.sum(multihot, axis=-1, keepdims=True), 1.0
        )
        id_emb, d_i = self.id.apply(params["id"], ids)
        out = jnp.concatenate([year_emb, genre_emb, id_emb], axis=-1)
        return out, merge_diagnostics(d_y, d_i)


@dataclasses.dataclass(frozen=True)
class Convolve:
    """Params: ``Dense_0`` (neighbor transform), ``Dense_1`` (output)."""

    hidden: int
    out: int

    def init(self, key, dst_h, nbr_h, w) -> dict:
        k0, k1 = jax.random.split(key)
        return {
            "Dense_0": dense_init(k0, nbr_h.shape[-1], self.hidden),
            "Dense_1": dense_init(k1, self.hidden + dst_h.shape[-1], self.out),
        }

    def apply(
        self, params: dict, dst_h: jnp.ndarray, nbr_h: jnp.ndarray, w: jnp.ndarray
    ) -> jnp.ndarray:
        """dst_h [..., D], nbr_h [..., T, D], w [..., T] → [..., out]."""
        u = jax.nn.relu(dense(params["Dense_0"], nbr_h))  # neighbor transform
        ws = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)  # clip ≥ 1
        pooled = jnp.einsum("...td,...t->...d", u, w) / ws  # importance pooling
        new = jax.nn.relu(dense(params["Dense_1"], jnp.concatenate([pooled, dst_h], axis=-1)))
        norm = jnp.maximum(jnp.linalg.norm(new, axis=-1, keepdims=True), 1e-12)
        return new / norm  # per-row L2 (paper semantics; see module docstring)


@dataclasses.dataclass(frozen=True)
class PinSage:
    """Params: ``projector``, ``conv_i``, ``fc1``, ``fc2``."""

    features: ItemFeatures
    embed_dim: int = 8
    conv_hidden: int = 64
    conv_out: int = 32
    num_layers: int = 2
    partition: str | None = None  # see FeatureProjector.partition
    lookup_mode: str = "gspmd"
    mesh: object | None = None

    @property
    def projector(self) -> FeatureProjector:
        return FeatureProjector(
            self.features, self.embed_dim, partition=self.partition,
            lookup_mode=self.lookup_mode, mesh=self.mesh,
        )

    @property
    def conv(self) -> Convolve:
        return Convolve(self.conv_hidden, self.conv_out)

    def sharded_params(self) -> dict:
        return table_specs({"projector/id": self.projector.id})

    def init(self, key, example: dict):
        keys = jax.random.split(key, self.num_layers + 3)
        d0 = 3 * self.embed_dim
        params = {"projector": self.projector.init(keys[0])}
        for i in range(self.num_layers):
            d_in = d0 if i == 0 else self.conv_out
            x = jax.ShapeDtypeStruct((1, d_in), jnp.float32)
            params[f"conv_{i}"] = self.conv.init(keys[1 + i], x, x, None)
        params["fc1"] = dense_init(keys[-2], self.conv_out, self.conv_hidden)
        params["fc2"] = dense_init(keys[-1], self.conv_hidden, self.conv_out)
        return params, {}

    def get_repr(self, params, block: dict) -> jnp.ndarray:
        """Dense 2-layer tree → final reprs for ``block['nodes']`` [N, out]."""
        return self._repr(params, block)[0]

    def _repr(self, params, block: dict):
        nodes = block["nodes"]  # [N]
        nbr1, w1 = block["nbr1"], block["w1"]  # [N, T]
        flat1 = block["flat1"]  # [N*(1+T)]
        nbr2, w2 = block["nbr2"], block["w2"]  # [N*(1+T), T]
        n = nodes.shape[0]
        t = nbr1.shape[1]

        h0_dst, d_dst = self.projector.apply(params["projector"], flat1)  # [N*(1+T), 3E]
        h0_nbr, d_nbr = self.projector.apply(params["projector"], nbr2)  # [N*(1+T), T, 3E]
        h1 = self.conv.apply(params["conv_0"], h0_dst, h0_nbr, w2)  # [N*(1+T), out]

        h1 = h1.reshape(n, 1 + t, -1)
        h1_nodes = h1[:, 0, :]
        h1_nbr1 = h1[:, 1:, :]
        h2 = self.conv.apply(params["conv_1"], h1_nodes, h1_nbr1, w1)  # [N, out]
        out = dense(params["fc2"], jax.nn.relu(dense(params["fc1"], h2)))
        return out, merge_diagnostics(d_dst, d_nbr)

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        """batch: block tensors for the stacked [heads; pos; neg] node list.

        Returns (pos_score, neg_score) per pair (``model.py:21-30``)."""
        reprs, diag = self._repr(params, batch)
        n = reprs.shape[0] // 3
        h, p, ng = reprs[:n], reprs[n : 2 * n], reprs[2 * n :]
        pos_score = jnp.sum(h * p, axis=-1)
        neg_score = jnp.sum(h * ng, axis=-1)
        return (pos_score, neg_score), model_state, diag

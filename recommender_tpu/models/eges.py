"""Graph item-embedding models: DeepWalk (BGE), GES, EGES.

Behavioral parity with ``eges/model.py``:
* ``DeepWalk`` — input/output tables; logits = context-embs · hidden
  (sampled-softmax dot products, ``eges/model.py:26-36``).
* ``GES``     — hidden = mean(id, cat, brand embeddings)
  (``eges/model.py:58-80``).
* ``EGES``    — per-item softmax weights over the [id, cat, brand]
  embeddings via a ``[V, num_side]`` weight table (``eges/model.py:83-102``).

Batch schema (from ``recommender_tpu.graph.walks.skipgram_batches``):
``target`` [B], ``context`` [B, 1+k] (1 positive + k Zipf negatives),
``label`` [B, 1+k]; GES/EGES add ``target_cat``/``target_brand`` [B].
``get_hidden`` is the retrieval-side representation used for link-prediction
eval and cold-start (side-info-only) inference (``eges/README.md:16-17``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.layers import merge_diagnostics
from recommender_tpu.parallel.partitioning import table_specs


class _SkipGram:
    """Shared protocol: subclasses define ``tables`` ({name: Embedding})
    and ``_hidden(params, batch) -> (hidden, diagnostics)``; logits are
    context embeddings · hidden."""

    def sharded_params(self) -> dict:
        return table_specs(self.tables)

    def init(self, key, example: dict):
        keys = jax.random.split(key, len(self.tables))
        return {name: emb.init(k) for k, (name, emb) in zip(keys, self.tables.items())}, {}

    def _lookup(self, params, name, ids):
        return self.tables[name].apply(params[name], ids)

    def get_hidden(self, params, batch: dict) -> jnp.ndarray:
        return self._hidden(params, batch)[0]

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        hidden, d_h = self._hidden(params, batch)  # [B, D]
        ctx, d_c = self._lookup(params, "output_embedding", batch["context"])  # [B, 1+k, D]
        logits = jnp.einsum("bkd,bd->bk", ctx, hidden)
        return logits, model_state, merge_diagnostics(d_h, d_c)


@dataclasses.dataclass(frozen=True)
class DeepWalk(_SkipGram):
    vocab_size: int
    embed_dim: int = 128
    partition: str | None = None  # 'model' → row-shard the big id tables
    lookup_mode: str = "gspmd"  # 'psum'/'a2a' need mesh (Embedding.lookup_mode)
    mesh: object | None = None

    @property
    def tables(self) -> dict:
        t = Embedding(self.vocab_size, self.embed_dim, partition=self.partition,
                      lookup_mode=self.lookup_mode, mesh=self.mesh)
        return {"input_embedding": t, "output_embedding": t}

    def _hidden(self, params, batch):
        return self._lookup(params, "input_embedding", batch["target"])


@dataclasses.dataclass(frozen=True)
class GES(_SkipGram):
    vocab_size: int
    cat_vocab: int
    brand_vocab: int
    embed_dim: int = 128
    partition: str | None = None
    lookup_mode: str = "gspmd"  # see DeepWalk
    mesh: object | None = None

    @property
    def tables(self) -> dict:
        ids = Embedding(self.vocab_size, self.embed_dim, partition=self.partition,
                        lookup_mode=self.lookup_mode, mesh=self.mesh)
        return {
            "id_embedding": ids,
            "cat_embedding": Embedding(self.cat_vocab, self.embed_dim),
            "brand_embedding": Embedding(self.brand_vocab, self.embed_dim),
            "output_embedding": ids,
        }

    def side_stack(self, params, batch: dict):
        """[B, 3, D]: id, cat, brand embeddings (and their diagnostics)."""
        outs = [
            self._lookup(params, "id_embedding", batch["target"]),
            self._lookup(params, "cat_embedding", batch["target_cat"]),
            self._lookup(params, "brand_embedding", batch["target_brand"]),
        ]
        return jnp.stack([o for o, _ in outs], axis=1), merge_diagnostics(*(d for _, d in outs))

    def _hidden(self, params, batch):
        stack, diag = self.side_stack(params, batch)
        return jnp.mean(stack, axis=1), diag


@dataclasses.dataclass(frozen=True)
class EGES(GES):
    num_side: int = 3

    @property
    def tables(self) -> dict:
        return {**super().tables,
                "weight_embedding": Embedding(self.vocab_size, self.num_side)}

    def _hidden(self, params, batch):
        stack, diag = self.side_stack(params, batch)  # [B, 3, D]
        w, d_w = self._lookup(params, "weight_embedding", batch["target"])
        w = jax.nn.softmax(w, axis=-1)  # [B, 3]
        return jnp.einsum("bs,bsd->bd", w, stack), merge_diagnostics(diag, d_w)

"""Two-tower retrieval — in-batch-softmax dual encoders.

Beyond-reference model (the reference's only retrieval trainer is the
PinSage GNN): the two-tower + in-batch sampled softmax is the standard
industrial retrieval baseline (YouTube DNN / dual-encoder family): one
dense [B, D]×[D, B] matmul per step — every other example in the global
batch is a negative, free.

Pipeline fit: the ITEM tower exports a corpus exactly like PinSage's
reprs, so the whole serving stack applies unchanged
(``retrieval/export.py`` bundles, int8 quantization, ``cli/serve``,
seen-exclusion ``recommend_topk`` — the user tower produces the query
vectors). Training scales with GSPMD data parallelism: the logits matmul
over batch-sharded towers makes XLA all-gather the item-side reprs, i.e.
cross-device in-batch negatives come from the GLOBAL batch for free.

Loss: softmax cross-entropy on the [B, B] similarity matrix with the
diagonal as labels, temperature-scaled; returns the per-example CE
vector (Trainer means it — repo convention). A duplicate item appearing
twice in a batch is a standard false negative of this loss family; at
recommendation-scale vocabularies and batch ≤8k the collision rate is
negligible (documented, not corrected — logQ correction is a sampling-
bias fix for non-uniform samplers, out of scope for uniform streams).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.layers import merge_diagnostics
from recommender_tpu.nn.mlp import MLP
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class TwoTower:
    """Params: ``user_embedding``, ``item_embedding``, [``cat_embedding``],
    ``user_tower``, ``item_tower``. ``apply`` returns ``(u, v)`` reprs."""

    user_vocab: int
    item_vocab: int
    cat_vocab: int = 0  # 0 = no item category feature
    embed_dim: int = 32
    repr_dim: int = 32
    tower_units: Sequence[int] = (64,)
    temperature: float = 0.05
    partition: Optional[str] = None
    lookup_mode: str = "gspmd"
    mesh: Optional[object] = None
    embed_param_dtype: jnp.dtype = jnp.float32

    @property
    def tables(self) -> dict:
        kw = dict(partition=self.partition, lookup_mode=self.lookup_mode,
                  mesh=self.mesh, param_dtype=self.embed_param_dtype)
        tables = {
            "user_embedding": Embedding(self.user_vocab, self.embed_dim, **kw),
            "item_embedding": Embedding(self.item_vocab, self.embed_dim, **kw),
        }
        if self.cat_vocab:
            tables["cat_embedding"] = Embedding(self.cat_vocab, self.embed_dim, **kw)
        return tables

    @property
    def tower(self) -> MLP:
        return MLP((*self.tower_units, self.repr_dim))

    def sharded_params(self) -> dict:
        return table_specs(self.tables)

    def init(self, key, example: dict):
        keys = jax.random.split(key, len(self.tables) + 2)
        params = {name: emb.init(k) for k, (name, emb) in zip(keys, self.tables.items())}
        item_in = self.embed_dim * (2 if self.cat_vocab else 1)
        params["user_tower"] = self.tower.init(keys[-2], self.embed_dim)
        params["item_tower"] = self.tower.init(keys[-1], item_in)
        return params, {}

    def _user(self, params, user_id):
        x, diag = self.tables["user_embedding"].apply(params["user_embedding"], user_id)
        r = self.tower.apply(params["user_tower"], x.astype(jnp.float32))
        return r / jnp.linalg.norm(r, axis=-1, keepdims=True).clip(1e-6), diag

    def _item(self, params, item_id, item_cat=None):
        tables = self.tables
        x, diag = tables["item_embedding"].apply(params["item_embedding"], item_id)
        x = x.astype(jnp.float32)
        if self.cat_vocab:
            if item_cat is None:
                raise ValueError("model built with cat_vocab needs item_cat")
            c, d_c = tables["cat_embedding"].apply(params["cat_embedding"], item_cat)
            x = jnp.concatenate([x, c.astype(jnp.float32)], axis=-1)
            diag = merge_diagnostics(diag, d_c)
        r = self.tower.apply(params["item_tower"], x)
        return r / jnp.linalg.norm(r, axis=-1, keepdims=True).clip(1e-6), diag

    def user_repr(self, params, user_id: jnp.ndarray) -> jnp.ndarray:
        """[B] user ids → [B, repr_dim], L2-normalized (cosine scoring —
        the bounded-logit convention of the dual-encoder family)."""
        return self._user(params, user_id)[0]

    def item_repr(self, params, item_id: jnp.ndarray,
                  item_cat: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        return self._item(params, item_id, item_cat)[0]

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        u, d_u = self._user(params, batch["user_id"])
        v, d_v = self._item(params, batch["item_id"], batch.get("item_cat"))
        return (u, v), model_state, merge_diagnostics(d_u, d_v)


def make_two_tower_task(model: TwoTower):
    """(loss_fn, eval_fn) for the Trainer: in-batch softmax CE.

    eval_fn returns (diagonal-is-top1 indicator, ones) — an in-batch
    retrieval accuracy proxy for train-time monitoring; certified quality
    uses the full-corpus hit-rate protocol (retrieval/eval.py) offline."""

    def loss_fn(params, model_state, batch, rng, train):
        (u, v), new_ms, diag = model.apply(params, model_state, batch, train=train, rng=rng)
        logits = (u @ v.T) / model.temperature  # [B, B]
        labels = jnp.arange(u.shape[0])
        per_ex = -jax.nn.log_softmax(logits, axis=-1)[labels, labels]
        top1 = jnp.mean((jnp.argmax(logits, axis=-1) == labels))
        return per_ex, {"inbatch_top1": top1, **diag}, new_ms

    def eval_fn(params, model_state, batch):
        (u, v), _, _ = model.apply(params, model_state, batch)
        logits = (u @ v.T) / model.temperature
        labels = jnp.arange(u.shape[0])
        hit = (jnp.argmax(logits, axis=-1) == labels).astype(jnp.float32)
        return hit, jnp.ones_like(hit)

    return loss_fn, eval_fn


def interaction_batches(graph, batch_size: int, seed: int = 0,
                        item_cat=None):
    """Infinite iid stream of (user_id, item_id[, item_cat]) training
    pairs sampled uniformly over a ``BipartiteGraph``'s edges — the
    two-tower input contract (fixed-shape batches, repo convention)."""
    import numpy as np

    users = np.repeat(
        np.arange(graph.num_users, dtype=np.int32),
        np.diff(graph.u2i_indptr),
    )
    items = graph.u2i_indices.astype(np.int32)
    cats = None if item_cat is None else np.asarray(item_cat, np.int32)
    rng = np.random.default_rng(seed)
    n = len(items)
    while True:
        sel = rng.integers(0, n, batch_size)
        batch = {"user_id": users[sel], "item_id": items[sel]}
        if cats is not None:
            batch["item_cat"] = cats[items[sel]]
        yield batch


def corpus_item_reprs(model: TwoTower, params, num_items: int,
                      item_cat=None, batch_size: int = 8192):
    """[V, repr_dim] item-tower corpus — the serving export input
    (``export_serving_bundle``); computed in jitted batches."""
    import numpy as np

    @jax.jit
    def reprs(ids, cats):
        return model.item_repr(params, ids, cats)

    out = []
    for s in range(0, num_items, batch_size):
        ids = np.arange(s, min(s + batch_size, num_items), dtype=np.int32)
        pad = batch_size - len(ids)
        ids_p = np.concatenate([ids, np.zeros(pad, np.int32)]) if pad else ids
        cats = None if item_cat is None else jnp.asarray(
            np.asarray(item_cat)[ids_p])
        r = jax.device_get(reprs(jnp.asarray(ids_p), cats))
        out.append(r[: len(ids)])
    return np.concatenate(out, axis=0)

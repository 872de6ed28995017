"""Behavior-sequence CTR models: BASE (mean-pool), DIN, DIEN.

Behavioral parity with ``dien/model.py:7-80``:
* shared item + category embedding tables (``mask_zero`` parity: id 0 = pad,
  masks are ``item_id != 0``), embeddings concatenated per step;
* BASE: masked mean-pool of history ∥ target → MLP(sigmoid)
  (``dien/model.py:24-34``);
* DIN: LocalActivationUnit attention pooling (``dien/model.py:37-53``);
* DIEN: masked GRU interest extractor + per-step auxiliary loss on
  pos/neg next-item (``dien/layers.py:76-133``), bilinear attention
  (``dien/layers.py:136-158``), AUGRU interest evolution
  (``dien/layers.py:161-204``); returns ``(prob, aux_loss)``
  (``dien/model.py:56-80``).

The head applies BatchNorm to its input (``dien/layers.py:22``; running
statistics in ``model_state["batch_stats"]["mlp"]["BatchNorm_0"]``); both
recurrences are single ``lax.scan``s with fused gate matmuls
(SURVEY.md §3.2).

Batch schema (``dien/data_loader.py:35-63``): target_item, target_cat,
pos_his_item, pos_his_cat, [neg_his_item, neg_his_cat], label; histories
post-padded with 0 to a fixed max length.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.layers import (
    batch_norm,
    batch_norm_stats_init,
    merge_diagnostics,
    norm_init,
)
from recommender_tpu.nn.losses import masked_auxiliary_loss
from recommender_tpu.nn.mlp import MLP
from recommender_tpu.nn.recurrent import AUGRU, GRU
from recommender_tpu.nn.sequence import (
    AuxiliaryNet,
    DIENAttention,
    LocalActivationUnit,
    masked_mean_pool,
)
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class SequenceBase:
    """Shared embeddings + helpers for the BASE/DIN/DIEN family.

    Params: ``item_embedding/embedding``, ``cat_embedding/embedding``,
    ``mlp/{BatchNorm_0, Dense_i}`` plus each subclass's own. Subclasses
    implement ``_init_extra(key)`` and ``_forward(params, target,
    his_sets, mask) -> (target_repr, history_repr, extra)``; the head
    scores [target_repr ∥ history_repr] and ``extra`` (if not None) is
    returned beside the probability.
    """

    item_vocab: int
    cat_vocab: int
    item_dim: int = 18
    cat_dim: int = 18
    mlp_units: Sequence[int] = (200, 80, 1)
    partition: Optional[str] = None
    # Sharded-table exchange for partitioned tables ('gspmd'|'psum'|'a2a';
    # see embedding/table.py::Embedding.lookup_mode — 'psum' keeps the
    # history scatters shard-local, the gspmd backward replicates them).
    # 'psum'/'a2a' need ``mesh``.
    lookup_mode: str = "gspmd"
    mesh: Optional[object] = None
    # One gather per table for ALL id sets of the step (target + pos
    # history + neg history concatenated) instead of one per set. Identical
    # math, and on paper one scatter-add backward per table instead of
    # three — but it was measured SLOWER at the DIEN b1024 T100 shape on
    # earlier hardware, so it is OFF by default: the per-set scatters let
    # XLA fuse each pad+scatter into its own cotangent producer, while the
    # combined path materializes the concatenated [2BT+B, D] cotangent
    # before one big scatter. Kept as a measurable A/B knob.
    shared_gather: bool = False
    # bf16-stored tables + auto stochastic rounding (core/optim.py): DIEN is
    # embedding-bound, so halving table bytes is the direct lever.
    embed_param_dtype: jnp.dtype = jnp.float32

    # sets of (item, cat) ids the model embeds: target + positive history
    id_sets = (("target_item", "target_cat"), ("pos_his_item", "pos_his_cat"))

    def _table(self, vocab, dim) -> Embedding:
        return Embedding(vocab, dim, partition=self.partition,
                         lookup_mode=self.lookup_mode, mesh=self.mesh,
                         param_dtype=self.embed_param_dtype)

    @property
    def item_embedding(self) -> Embedding:
        return self._table(self.item_vocab, self.item_dim)

    @property
    def cat_embedding(self) -> Embedding:
        return self._table(self.cat_vocab, self.cat_dim)

    @property
    def mlp(self) -> MLP:
        return MLP(tuple(self.mlp_units), final_activation=jax.nn.sigmoid)

    @property
    def dim(self) -> int:
        return self.item_dim + self.cat_dim

    def sharded_params(self) -> dict:
        return table_specs({"item_embedding": self.item_embedding,
                            "cat_embedding": self.cat_embedding})

    def _head_in_dim(self) -> int:
        return 2 * self.dim

    def init(self, key, example: dict):
        k_item, k_cat, k_mlp, k_extra = jax.random.split(key, 4)
        head_in = self._head_in_dim()
        params = {
            "item_embedding": self.item_embedding.init(k_item),
            "cat_embedding": self.cat_embedding.init(k_cat),
            "mlp": {"BatchNorm_0": norm_init(head_in), **self.mlp.init(k_mlp, head_in)},
        }
        params.update(self._init_extra(k_extra))
        state = {"batch_stats": {"mlp": {"BatchNorm_0": batch_norm_stats_init(head_in)}}}
        return params, state

    def _init_extra(self, key) -> dict:
        return {}

    def embed(self, params, item, cat):
        # bf16-stored tables: upcast the GATHERED activations to f32 so the
        # downstream scans/MLPs keep their f32 carries — a [B,T,D]-sized
        # cast, not the per-step whole-table cast that makes
        # Embedding.compute_dtype a loss. The astype's transpose rounds
        # the cotangent back to bf16 before the scatter, keeping the
        # half-byte backward.
        ei, di = self.item_embedding.apply(params["item_embedding"], item)
        ec, dc = self.cat_embedding.apply(params["cat_embedding"], cat)
        out = jnp.concatenate([ei, ec], axis=-1)
        return out.astype(jnp.float32), merge_diagnostics(di, dc)

    def embed_sets(self, params, items, cats):
        """Embed several (item_ids, cat_ids) sets — [B] target, [B, T]
        histories — with ONE lookup per table (see ``shared_gather``).
        Returns one [..., item_dim+cat_dim] array per input set, and the
        lookups' diagnostics."""
        if not self.shared_gather:
            outs = [self.embed(params, i, c) for i, c in zip(items, cats)]
            return [o for o, _ in outs], merge_diagnostics(*(d for _, d in outs))
        shapes = [tuple(i.shape) for i in items]
        flat_i = jnp.concatenate([i.reshape(-1) for i in items])
        flat_c = jnp.concatenate([c.reshape(-1) for c in cats])
        emb_i, di = self.item_embedding.apply(params["item_embedding"], flat_i)
        emb_c, dc = self.cat_embedding.apply(params["cat_embedding"], flat_c)
        out, off = [], 0
        for shp in shapes:
            n = int(np.prod(shp))
            out.append(
                jnp.concatenate(
                    [
                        emb_i[off : off + n].reshape(*shp, -1),
                        emb_c[off : off + n].reshape(*shp, -1),
                    ],
                    axis=-1,
                ).astype(jnp.float32)
            )
            off += n
        return out, merge_diagnostics(di, dc)

    def head(self, params, model_state, target_emb, history_repr, train):
        x = jnp.concatenate([target_emb, history_repr], axis=-1)
        bn_stats = model_state["batch_stats"]["mlp"]["BatchNorm_0"]
        x, bn_stats = batch_norm(params["mlp"]["BatchNorm_0"], bn_stats, x, train=train)
        prob = self.mlp.apply(params["mlp"], x)
        new_state = {"batch_stats": {"mlp": {"BatchNorm_0": bn_stats}}}
        return jnp.squeeze(prob, axis=-1), new_state

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        mask = (batch["pos_his_item"] != 0).astype(jnp.float32)  # [B, T]
        embs, diag = self.embed_sets(
            params,
            [batch[i] for i, _ in self.id_sets],
            [batch[c] for _, c in self.id_sets],
        )
        t_repr, h_repr, extra = self._forward(params, embs[0], embs[1:], mask)
        prob, new_state = self.head(params, model_state, t_repr, h_repr, train)
        out = prob if extra is None else (prob, extra)
        return out, new_state, diag


class BaseModel(SequenceBase):
    def _forward(self, params, target, his, mask):
        return target, masked_mean_pool(his[0], mask), None


class DIN(SequenceBase):
    local_activation_unit = LocalActivationUnit()

    def _init_extra(self, key) -> dict:
        his = jax.ShapeDtypeStruct((1, 1, self.dim), jnp.float32)
        return {"local_activation_unit": self.local_activation_unit.init(key, None, his, None)}

    def _forward(self, params, target, his, mask):
        pooled = self.local_activation_unit.apply(
            params["local_activation_unit"], target, his[0], mask
        )
        return target, pooled, None


@dataclasses.dataclass(frozen=True)
class DIEN(SequenceBase):
    """Returns ``(prob, aux_loss)``. Extra params: ``extract_gru``,
    ``auxiliary_net``, ``attention``, ``evolve``."""

    extract_hidden: int = 36
    evolve_hidden: int = 36
    # rematerialize scan steps: None = auto (on for T > 256 —
    # nn/recurrent.py REMAT_MIN_T)
    remat: bool | None = None

    id_sets = (
        ("target_item", "target_cat"),
        ("pos_his_item", "pos_his_cat"),
        ("neg_his_item", "neg_his_cat"),
    )

    @property
    def extract_gru(self) -> GRU:
        return GRU(hidden=self.extract_hidden, remat=self.remat)

    @property
    def evolve(self) -> AUGRU:
        return AUGRU(hidden=self.evolve_hidden, remat=self.remat)

    auxiliary_net = AuxiliaryNet()
    attention = DIENAttention()

    def _head_in_dim(self) -> int:
        return self.dim + self.evolve_hidden

    def _init_extra(self, key) -> dict:
        k_gru, k_aux, k_att, k_evo = jax.random.split(key, 4)
        h = self.extract_hidden
        seq = jax.ShapeDtypeStruct((1, 1, self.dim), jnp.float32)
        hidden = jax.ShapeDtypeStruct((1, 1, h), jnp.float32)
        target = jax.ShapeDtypeStruct((1, self.dim), jnp.float32)
        return {
            "extract_gru": self.extract_gru.init(k_gru, seq, None),
            "auxiliary_net": self.auxiliary_net.init(
                k_aux, jax.ShapeDtypeStruct((1, h + self.dim), jnp.float32)
            ),
            "attention": self.attention.init(k_att, target, hidden, None),
            "evolve": self.evolve.init(k_evo, hidden, None, None),
        }

    def _forward(self, params, target, his, mask):
        pos_his, neg_his = his  # [B, T, D] each
        hidden = self.extract_gru.apply(params["extract_gru"], pos_his, mask)  # [B, T, H]
        # auxiliary loss: h(t) vs pos/neg item at t+1 (dien/layers.py:89-108)
        h_t = hidden[:, :-1, :]
        aux_p = params["auxiliary_net"]
        pos_logits = self.auxiliary_net.apply(
            aux_p, jnp.concatenate([h_t, pos_his[:, 1:, :]], axis=-1))
        neg_logits = self.auxiliary_net.apply(
            aux_p, jnp.concatenate([h_t, neg_his[:, 1:, :]], axis=-1))
        aux_loss = masked_auxiliary_loss(pos_logits, neg_logits, mask[:, 1:])

        score = self.attention.apply(params["attention"], target, hidden, mask)  # [B, T, 1]
        final = self.evolve.apply(params["evolve"], hidden, score, mask)  # [B, H]
        return target, final, aux_loss

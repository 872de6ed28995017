"""Multi-task CTR/CVR models: BASE, ESMM, MMOE (Ali-CCP).

Behavioral parity:
* ``MultiTaskBase``  — ``esmm/base.py:7-19``: per-feature embedding tables
  (18 tables, dim 18) → concat → MLP; one binary head. Used twice in the
  reference's Base protocol (a CTR model on impressions + a CVR model on
  clicks; CTCVR prob = product of both — ``esmm/train.py:49-54``).
* ``ESMM``           — ``esmm/esmm.py:7-44``: shared embedding, CTR + CVR
  towers, pCTCVR = pCTR·pCVR; probe heads ``compute_cvr/ctr/ctcvr``.
* ``MMOE``           — ``esmm/mmoe.py:8-109``: expert bank + per-task
  softmax gates + task towers, ESMM-style coupling of head 1 by head 0
  (``outputs[1] = outputs[0]*outputs[1]``, ``esmm/mmoe.py:44``). The
  reference's three probe methods each re-run the full forward; here one
  forward returns everything.

Batch schema (``esmm/tfrecord_io.py:116-138``): ``features`` [B, 18] int32
(one column per categorical field), labels ``click`` / ``purchase`` [B].
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.embedding.table import Embedding
from recommender_tpu.nn.layers import embedding_init, merge_diagnostics
from recommender_tpu.nn.mlp import MLP
from recommender_tpu.nn.moe import ExpertBank, MMOEGate
from recommender_tpu.parallel.partitioning import table_specs


@dataclasses.dataclass(frozen=True)
class FeatureEmbedder:
    """Per-feature embedding tables → concatenated [B, F*D].

    Params: ``feat_j/embedding`` per feature, or one ``stacked_embedding``.

    ``stack=True`` enables **table stacking**: all F same-width tables live
    as one ``[ΣV, D]`` param, feature ``j``'s rows at offset
    ``Σ_{i<j} V_i``; the whole batch takes ONE gather of ``[B, F]`` shifted
    ids (one scatter-add gradient) instead of F per-table pairs. Per-row
    semantics (lookup, Adam update, init distribution) are unchanged: each
    segment is initialized exactly as its standalone table would be, and
    elementwise optimizers never couple rows.

    Stacking is **off by default**: on earlier hardware it lost at both
    reference scales (MMOE, 18×100k×18 tables, b512 and b8192) — one big
    scatter into a big narrow table serialized against a single fat Adam
    update, while 18 small per-table scatter→Adam chains pipelined. Stack
    only when the per-table dispatch overhead dominates instead — many
    genuinely tiny vocabs at small batch.

    ``partition``, ``lookup_modes`` and ``capacity_factors`` may each be a
    single policy for every table or a per-feature tuple — the rendered
    output of ``embedding.planner.plan_tables`` via ``planner.module_kwargs``
    (replicate the tiny tables; row-shard the large ones and give each its
    planned exchange + skew-aware a2a bucket capacity). A per-feature tuple
    needs per-table params, so it always disables stacking; a uniform
    policy (including ``"model"`` — GSPMD row-shards the stacked table as a
    whole) may stack. ``mesh`` is required by any ``"a2a"`` lookup
    (``Embedding.lookup_mode``).
    """

    vocab_sizes: Sequence[int]
    embed_dim: int = 18
    partition: str | None | Sequence[str | None] = None
    stack: bool = False
    lookup_modes: str | Sequence[str] = "gspmd"
    capacity_factors: float | Sequence[float] = 2.0
    mesh: object | None = None
    # bf16-stored tables + auto stochastic rounding: the MMOE step is
    # embedding-dominated, so bf16 halves the dominant bytes. Per-table
    # path only (the stacked path stays f32).
    param_dtype: jnp.dtype = jnp.float32

    def _per_feat(self, v):
        n = len(self.vocab_sizes)
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n

    @property
    def stacked(self) -> bool:
        per_table_cfg = any(
            isinstance(v, (list, tuple))
            for v in (self.partition, self.lookup_modes, self.capacity_factors)
        )
        return self.stack and not per_table_cfg

    @property
    def tables(self) -> dict:
        """``{feat_j: Embedding}`` of the per-table path."""
        per_feat = self._per_feat(self.partition)
        lookups = self._per_feat(self.lookup_modes)
        caps = self._per_feat(self.capacity_factors)
        return {
            f"feat_{j}": Embedding(
                v, self.embed_dim, partition=per_feat[j],
                lookup_mode=lookups[j], capacity_factor=float(caps[j]),
                mesh=self.mesh if lookups[j] in ("a2a", "psum") else None,
                param_dtype=self.param_dtype,
            )
            for j, v in enumerate(self.vocab_sizes)
        }

    def sharded_params(self) -> dict:
        if self.stacked:
            if self.partition is None:
                return {}
            return {"stacked_embedding": jax.sharding.PartitionSpec(self.partition, None)}
        return table_specs(self.tables)

    def init(self, key, features=None) -> dict:
        if not self.stacked:
            keys = jax.random.split(key, len(self.vocab_sizes))
            return {name: emb.init(k) for k, (name, emb) in zip(keys, self.tables.items())}
        if self.lookup_modes != "gspmd":
            raise ValueError(
                "stacked tables support only the gspmd lookup; use per-table "
                f"mode (stack=False) for lookup_modes={self.lookup_modes!r}"
            )
        if jnp.dtype(self.param_dtype) != jnp.float32:
            raise ValueError(
                "stacked tables are f32-only; use per-table mode (stack=False) "
                f"for param_dtype={self.param_dtype}"
            )
        # per-segment init == each standalone table's init (fan depends on
        # the table shape, so one call over [ΣV, D] would differ)
        keys = jax.random.split(key, len(self.vocab_sizes))
        segs = [
            embedding_init(k, (int(v), self.embed_dim), jnp.float32)
            for k, v in zip(keys, self.vocab_sizes)
        ]
        return {"stacked_embedding": jnp.concatenate(segs, axis=0)}

    def apply(self, params: dict, features: jnp.ndarray) -> tuple[jnp.ndarray, dict]:
        if not self.stacked:
            cols, diags = [], []
            for j, (name, emb) in enumerate(self.tables.items()):
                col, d = emb.apply(params[name], features[:, j])
                cols.append(col)
                diags.append(d)
            # bf16-stored tables: upcast gathered activations (cheap) so
            # towers/experts keep f32 math; the astype transpose rounds
            # the cotangent to bf16, and each table's backward accumulates
            # it in f32.
            return jnp.concatenate(cols, axis=-1).astype(jnp.float32), merge_diagnostics(*diags)

        vocab_sizes = tuple(int(v) for v in self.vocab_sizes)
        table = params["stacked_embedding"]
        offsets = jnp.asarray(
            np.cumsum([0] + list(vocab_sizes[:-1])), dtype=features.dtype
        )
        # clamp within each feature's own segment BEFORE offsetting: an
        # out-of-range id must hit its own table's last row (jnp.take's
        # per-table clip semantics), not bleed into the next feature's rows
        maxima = jnp.asarray(
            np.asarray(vocab_sizes) - 1, dtype=features.dtype
        )
        local = jnp.clip(features, 0, maxima[None, :])
        ids = local + offsets[None, :]  # [B, F] global rows
        # NOTE: the stacked path supports only the default precision /
        # gspmd lookup config (param f32, no compute cast, no a2a) — route
        # per-table via Embedding for the full knob surface.
        from recommender_tpu.ops.embedding_kernels import (
            embedding_lookup,
            use_padded_backward,
        )

        if use_padded_backward(table.shape, ids.size):
            emb = embedding_lookup(table, ids)
        else:
            emb = jnp.take(table, ids, axis=0)
        return emb.reshape(features.shape[0], len(vocab_sizes) * self.embed_dim), {}


@dataclasses.dataclass(frozen=True)
class _MultiTaskConfig:
    vocab_sizes: Sequence[int]
    embed_dim: int = 18
    partition: str | None | Sequence[str | None] = None  # see FeatureEmbedder
    stack_tables: bool = False
    lookup_modes: str | Sequence[str] = "gspmd"  # see FeatureEmbedder
    capacity_factors: float | Sequence[float] = 2.0
    mesh: object | None = None
    embed_param_dtype: jnp.dtype = jnp.float32  # see FeatureEmbedder.param_dtype

    @property
    def embedder(self) -> FeatureEmbedder:
        return FeatureEmbedder(
            tuple(self.vocab_sizes), self.embed_dim, self.partition, self.stack_tables,
            lookup_modes=self.lookup_modes,
            capacity_factors=self.capacity_factors, mesh=self.mesh,
            param_dtype=self.embed_param_dtype,
        )

    @property
    def _feat_dim(self) -> int:
        return len(self.vocab_sizes) * self.embed_dim

    def sharded_params(self) -> dict:
        name = self._embedder_name
        return {f"{name}/{k}": v for k, v in self.embedder.sharded_params().items()}

    _embedder_name = "embedder"


@dataclasses.dataclass(frozen=True)
class MultiTaskBase(_MultiTaskConfig):
    """Single-head model (used as CTR-only or CVR-only in the Base protocol).
    Params: ``FeatureEmbedder_0``, ``MLP_0``."""

    mlp_units: Sequence[int] = (360, 200, 80, 2)

    _embedder_name = "FeatureEmbedder_0"

    @property
    def mlp(self) -> MLP:
        return MLP(tuple(self.mlp_units), final_activation=jax.nn.softmax)

    def init(self, key, example: dict):
        k_emb, k_mlp = jax.random.split(key)
        return {
            "FeatureEmbedder_0": self.embedder.init(k_emb),
            "MLP_0": self.mlp.init(k_mlp, self._feat_dim),
        }, {}

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        x, diag = self.embedder.apply(params["FeatureEmbedder_0"], batch["features"])
        out = self.mlp.apply(params["MLP_0"], x)
        # reference uses a 2-unit softmax head; prob of class 1
        prob = out[:, 1] if out.shape[-1] == 2 else jnp.squeeze(jax.nn.sigmoid(out), -1)
        return prob, model_state, diag


@dataclasses.dataclass(frozen=True)
class ESMM(_MultiTaskConfig):
    """Params: ``embedder``, ``ctr_tower``, ``cvr_tower``."""

    mlp_units: Sequence[int] = (360, 200, 80, 1)

    @property
    def tower(self) -> MLP:
        return MLP(tuple(self.mlp_units), final_activation=jax.nn.sigmoid)

    def init(self, key, example: dict):
        k_emb, k_ctr, k_cvr = jax.random.split(key, 3)
        return {
            "embedder": self.embedder.init(k_emb),
            "ctr_tower": self.tower.init(k_ctr, self._feat_dim),
            "cvr_tower": self.tower.init(k_cvr, self._feat_dim),
        }, {}

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        x, diag = self.embedder.apply(params["embedder"], batch["features"])
        p_ctr = jnp.squeeze(self.tower.apply(params["ctr_tower"], x), -1)
        p_cvr = jnp.squeeze(self.tower.apply(params["cvr_tower"], x), -1)
        return {"ctr": p_ctr, "cvr": p_cvr, "ctcvr": p_ctr * p_cvr}, model_state, diag


@dataclasses.dataclass(frozen=True)
class MMOE(_MultiTaskConfig):
    """Params: ``embedder``, ``expert_bank/experts``, ``gate_i``, ``tower_i``."""

    num_tasks: int = 2
    num_experts: int = 8
    expert_units: Sequence[int] = (200, 80)
    tower_units: Sequence[int] = (40, 1)

    @property
    def expert_bank(self) -> ExpertBank:
        return ExpertBank(self.num_experts, tuple(self.expert_units))

    @property
    def gate(self) -> MMOEGate:
        return MMOEGate(self.num_experts)

    @property
    def tower(self) -> MLP:
        return MLP(tuple(self.tower_units), final_activation=jax.nn.sigmoid)

    def init(self, key, example: dict):
        keys = jax.random.split(key, 2 + 2 * self.num_tasks)
        x = jax.ShapeDtypeStruct((1, self._feat_dim), jnp.float32)
        params = {
            "embedder": self.embedder.init(keys[0]),
            "expert_bank": self.expert_bank.init(keys[1], x),
        }
        for i in range(self.num_tasks):
            params[f"gate_{i}"] = self.gate.init(keys[2 + 2 * i], x)
            params[f"tower_{i}"] = self.tower.init(keys[3 + 2 * i], self.expert_units[-1])
        return params, {}

    def apply(self, params, model_state, batch: dict, *, train: bool = False, rng=None):
        x, diag = self.embedder.apply(params["embedder"], batch["features"])
        experts = self.expert_bank.apply(params["expert_bank"], x)  # [B, E, H]
        heads = []
        for i in range(self.num_tasks):
            mixed = self.gate.apply(params[f"gate_{i}"], x, experts)
            heads.append(jnp.squeeze(self.tower.apply(params[f"tower_{i}"], mixed), -1))
        p_ctr, p_cvr = heads[0], heads[1]
        return {"ctr": p_ctr, "cvr": p_cvr, "ctcvr": p_ctr * p_cvr}, model_state, diag

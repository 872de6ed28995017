"""Embedding tables.

Replaces ``keras.layers.Embedding`` everywhere the reference uses it
(``ctr/model.py:10,42``, ``dien/model.py:11-12``, ``esmm/base.py:9-11``,
``eges/model.py:20-102``, ``pinsage/train/layers.py:49-81``).

Design notes:
* The table is a plain f32 param; lookups cast activations to bf16 only
  downstream (gathers are bandwidth-bound; the table dtype is the knob).
* ``partition="model"`` makes ``spec`` row-shard the table over the
  ``model`` mesh axis (the model's ``sharded_params`` collects it); under
  ``jit`` XLA/GSPMD then compiles the gather into the canonical
  masked-local-gather + all-reduce exchange. Its BACKWARD, however, is a
  replicated full-table scatter per device (the SPMD partitioner cannot
  row-split a scatter with arbitrary indices — compiled-HLO witness in
  tests/test_sharded_10m.py), so big sharded tables should take an
  explicit ``shard_map`` exchange instead: ``lookup_mode="psum"`` (same
  comm as gspmd, shard-local per-shard-gated backward) or ``"a2a"``
  (bandwidth-optimal at large batch). The planner picks between them.
* ``mask_zero`` parity: row 0 is the pad/OOV bucket by convention
  (``dien/model.py:11``, ``eges/data_loader.py:8-9``); masks are computed
  by callers as ``ids != 0`` — the table itself never masks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from recommender_tpu.nn.layers import embedding_init


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Declarative spec used by planners/checkpointing."""

    name: str
    vocab_size: int
    features: int
    combiner: Optional[str] = None  # None | 'sum' | 'mean'
    sharded: bool = False


@dataclasses.dataclass(frozen=True)
class Embedding:
    """One table: params ``{"embedding": [vocab_size, features]}``.

    ``apply`` returns ``(vectors, diagnostics)``; diagnostics is ``{}``
    except on the all-to-all path, which reports ``a2a_overflow``."""

    vocab_size: int
    features: int
    partition: Optional[str] = None  # None → replicated; "model" → row-sharded
    param_dtype: jnp.dtype = jnp.float32
    # Sharded-lookup exchange for partitioned tables:
    # * "gspmd" (default): XLA compiles the gather into masked-local-gather
    #   + all-reduce. CAVEAT: its BACKWARD materializes a replicated
    #   full-table scatter on every device (the SPMD partitioner cannot
    #   row-split a scatter with arbitrary indices — verified from compiled
    #   HLO, tests/test_sharded_10m.py) — fine for small sharded tables,
    #   wasteful for big ones.
    # * "psum": the same masked-gather+all-reduce exchange built explicitly
    #   with shard_map (embedding.sharded.sharded_lookup) — identical comm,
    #   but the cotangent scatter stays SHARD-LOCAL ([V/m, D] per device)
    #   with the per-shard backward gate. The planner's choice for big
    #   sharded tables at small batch. Requires ``mesh``.
    # * "a2a": ids routed to the owning shard and vectors back
    #   (embedding.sharded.all_to_all_lookup — comm drops from B·F·D to
    #   ≈2·B·F·D/m per device; the planner picks it for large batches).
    #   Requires ``mesh``. Routing buckets are fixed-size: ids beyond a
    #   destination shard's capacity (``capacity_factor`` × fair share) are
    #   served a 0 vector, so size it for the id-frequency skew you expect
    #   (``planner.plan_tables`` computes a skew-aware value;
    #   ``sharded.a2a_overflow_fraction`` measures one). capacity_factor ==
    #   num model shards is always lossless (degenerates to psum-grade
    #   communication).
    lookup_mode: str = "gspmd"
    mesh: Optional[object] = None
    capacity_factor: float = 2.0  # jax.sharding.Mesh (hashable, static)
    # Mixed-precision lookup: cast the table to this dtype before the
    # gather (master param stays ``param_dtype`` — the optimizer never sees
    # reduced precision). The cast materializes a whole-table copy every
    # step, so keep None (f32) for big tables; the knob exists for
    # activation-dtype uniformity with bf16 MLP stacks on small tables,
    # not as a speed lever.
    compute_dtype: Optional[jnp.dtype] = None

    @property
    def spec(self) -> P:
        """Sharding of the table: rows over ``partition``, or replicated."""
        return P(self.partition, None) if self.partition is not None else P()

    def init(self, key, ids=None) -> dict:
        shape = (self.vocab_size, self.features)
        return {"embedding": embedding_init(key, shape, self.param_dtype)}

    def apply(
        self, params: dict, ids: jnp.ndarray, dedup_plan: Optional[dict] = None
    ) -> tuple[jnp.ndarray, dict]:
        table = params["embedding"]
        if self.compute_dtype is not None and table.dtype != self.compute_dtype:
            table = table.astype(self.compute_dtype)
        if (
            self.lookup_mode == "a2a"
            and self.partition is not None
            and self.mesh is not None
            and self.mesh.shape.get("model", 1) > 1
        ):
            from recommender_tpu.embedding.sharded import all_to_all_lookup

            vecs, dropped = all_to_all_lookup(
                table, ids, self.mesh, capacity_factor=self.capacity_factor,
                return_overflow=True,
            )
            # One psum'd scalar: ids served a 0 vector this step because a
            # destination bucket overflowed (skewed batch). Rides the
            # train metrics dict as ``a2a_overflow``.
            return vecs, {"a2a_overflow": dropped}
        if (
            self.lookup_mode == "psum"
            and self.partition is not None
            and self.mesh is not None
            and self.mesh.shape.get("model", 1) > 1
        ):
            from recommender_tpu.embedding.sharded import sharded_lookup

            return sharded_lookup(table, ids, self.mesh), {}
        # Narrow tables take the custom-VJP lookup (plain gather forward,
        # padded-width scatter backward) when THIS call scatters enough
        # rows — volume-gated at PADDED_BWD_MIN_IDS; small lookups keep the
        # native take (the padded backward's pad/slice copies cost more
        # than they save there). Every other lookup takes ``embedding_take``,
        # whose backward accumulates in f32 for bf16 tables too. Design:
        # docs/DESIGN.md.
        from recommender_tpu.ops.embedding_kernels import (
            embedding_lookup,
            embedding_lookup_dedup,
            embedding_take,
            use_padded_backward,
        )

        # Host-precomputed dedup plan riding in the batch (data/dedup.py):
        # Zipf-skewed ids collapse ~6x to unique rows, and the plan-driven
        # backward (segment-sum into unique slots + small table scatter)
        # can undercut the padded scatter. Replicated tables only — the
        # plan indexes the device-resident flat id stream (see
        # ops.embedding_kernels.embedding_lookup_dedup scope note).
        if dedup_plan is not None and self.partition is None:
            return embedding_lookup_dedup(
                table, ids,
                dedup_plan["perm"], dedup_plan["slot"], dedup_plan["uniq"],
            ), {}
        if use_padded_backward(table.shape, ids.size):
            return embedding_lookup(table, ids), {}
        return embedding_take(table, ids), {}


def bag_combine(emb: jnp.ndarray, weights: jnp.ndarray, combiner: str) -> jnp.ndarray:
    """Combine a bag of embeddings [..., K, D] with weights [..., K] → [..., D].

    ``mean`` divides by the weight sum clipped to >= 1 (multi-hot pooling as in
    ``pinsage/train/layers.py:76-78``).
    """
    w = weights.astype(emb.dtype)[..., None]
    s = jnp.sum(emb * w, axis=-2)
    if combiner == "sum":
        return s
    if combiner == "mean":
        return s / jnp.maximum(jnp.sum(w, axis=-2), 1.0)
    raise ValueError(f"unknown combiner {combiner}")

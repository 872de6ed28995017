"""Embedding backward paths (scatter-add gradients) in plain JAX.

The embedding gradient is a scatter-add of the lookup cotangent into the
table: DLRM at batch 8192 scatters 8192 × 26 = 212,992 rows of width 16
into a 1M × 16 table every step. This module holds the variants the
lookups choose between; every one is plain JAX left to XLA:

* native ``jnp.zeros((V, D)).at[ids].add(cot)`` — what AD gives for
  ``jnp.take``;
* ``native_scatter_add`` — the same, accumulated in at least f32;
* ``padded_scatter_add`` — the scatter done 64 lanes wide and sliced back
  (XLA scatters narrow rows slowly on some backends);
* ``sorted_scatter_add`` — ``jax.ops.segment_sum`` over ids sorted
  ascending (the dedup backward's two segment-sums and the 2-5M-row
  window of the lookup backward).

``embedding_lookup`` is ``jnp.take`` with the padded scatter as its
``custom_vjp`` backward; ``embedding_lookup_dedup`` drives the backward
from a host-precomputed dedup plan; ``embedding_take`` serves every other
lookup. Every backward accumulates in f32 whatever the table dtype. ``chip_smoke.py`` (phase ``kernels``)
compares every variant with the plain reference on the card and times it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("vocab_size",))
def sorted_scatter_add(
    sorted_ids: jnp.ndarray,
    updates: jnp.ndarray,
    vocab_size: int,
    order: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Σ updates into a fresh [vocab_size, D] f32 table.

    ``sorted_ids`` [N] ascending int32 (entries ≥ vocab_size are dropped).
    ``updates`` [N, D]: already in sorted order when ``order`` is None;
    otherwise in original order and ``order`` [N] is the permutation such
    that ``updates[order]`` is sorted (one materialized ``jnp.take`` here).
    A host-precomputed argsort (``data/pipeline.py``) thus skips the
    device sort and pays only the reorder. Accumulates in f32.
    """
    if order is not None:
        updates = jnp.take(updates, order, axis=0)
    return jax.ops.segment_sum(
        updates.astype(jnp.float32), sorted_ids, num_segments=vocab_size,
        indices_are_sorted=True,
    )


def scatter_add_dense(ids: jnp.ndarray, updates: jnp.ndarray, vocab_size: int):
    """Device argsort + ``sorted_scatter_add``: the sorted table gradient
    for ids of any shape (f32)."""
    flat = ids.reshape(-1).astype(jnp.int32)
    upd = updates.reshape(-1, updates.shape[-1])
    order = jnp.argsort(flat).astype(jnp.int32)
    return sorted_scatter_add(flat[order], upd, vocab_size, order=order)


def native_scatter_add(ids: jnp.ndarray, updates: jnp.ndarray, vocab_size: int):
    """XLA's own scatter-add (what AD gives for ``jnp.take``), accumulated
    in at least f32: on the GPU a bf16 scatter-add runs as compare-and-swap
    atomics, far slower than f32, and rounds away most of the sum on the
    Zipf head rows."""
    flat = ids.reshape(-1)
    upd = updates.reshape(-1, updates.shape[-1])
    upd = upd.astype(jnp.promote_types(upd.dtype, jnp.float32))
    return jnp.zeros((vocab_size, upd.shape[-1]), upd.dtype).at[flat].add(upd)


# ------------------------------------------------- fast narrow-width scatter
_FAST_WIDTH = 64  # rows narrower than this are scattered 64 lanes wide


def padded_scatter_add(ids: jnp.ndarray, updates: jnp.ndarray, vocab_size: int):
    """Scatter-add that sidesteps a slow narrow-row scatter: zero-pad the
    update rows to 64 lanes, scatter wide, slice back.

    Accumulates in at least f32, as ``native_scatter_add`` does."""
    flat = ids.reshape(-1)
    upd = updates.reshape(-1, updates.shape[-1])
    upd = upd.astype(jnp.promote_types(upd.dtype, jnp.float32))
    d = upd.shape[-1]
    if d >= _FAST_WIDTH:
        return native_scatter_add(flat, upd, vocab_size)
    wide = jnp.concatenate(
        [upd, jnp.zeros((upd.shape[0], _FAST_WIDTH - d), upd.dtype)], axis=1
    )
    grad = jnp.zeros((vocab_size, _FAST_WIDTH), upd.dtype).at[flat].add(wide)
    return grad[:, :d]


# ----------------------------------------------------------------- lookup VJP
# Tables in this shape class (a) can trip XLA's fused-graph layout
# assignment (column-major flip -> slow gather), so the Trainer splits the
# step (TrainConfig.split_step), and (b) want the padded-width scatter
# backward. Smaller/wider tables keep XLA's native take/scatter inside one
# fused step. The thresholds below were tuned on earlier hardware; tuning
# them on the current GPU is open work (ROADMAP.md).
BIG_NARROW_MIN_ELEMS = 8_000_000
NARROW_MAX_COLS = 32


def is_big_narrow_table(shape) -> bool:
    return (
        len(shape) == 2
        and shape[1] <= NARROW_MAX_COLS
        and shape[0] * shape[1] >= BIG_NARROW_MIN_ELEMS
    )


# Below this many ids per lookup the padded backward's extra pad/slice
# copies outweigh the scatter win.
PADDED_BWD_MIN_IDS = 32_768

# Row-count windows for the custom backward: the 64-lane padded scatter up
# to PADDED_BWD_MAX_ROWS (its padded destination grows with the table), the
# sorted scatter up to SORTED_BWD_MAX_ROWS, and XLA's native scatter fused
# into the step above that.
PADDED_BWD_MAX_ROWS = 2_000_000
SORTED_BWD_MAX_ROWS = 5_000_000


def use_padded_backward(table_shape, n_ids: int) -> bool:
    """Static per-lookup choice of the custom-VJP backward (padded scatter
    for tables ≤ PADDED_BWD_MAX_ROWS rows; sorted scatter in the
    2-5M-row window — ``_lookup_bwd`` picks by row count).

    Narrow tables (cols < 64) take it when this call scatters at least
    PADDED_BWD_MIN_IDS rows (the Trainer's split step is gated on the same
    threshold via ``_batch_id_volume``): a small batch into a big narrow
    table keeps the native scatter fused into one step. Tables above
    SORTED_BWD_MAX_ROWS rows keep the native fused scatter."""
    if len(table_shape) != 2 or table_shape[1] >= _FAST_WIDTH:
        return False
    if table_shape[0] > SORTED_BWD_MAX_ROWS:
        return False
    return n_ids >= PADDED_BWD_MIN_IDS


@jax.custom_vjp
def embedding_lookup(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """``jnp.take(table, ids, axis=0)`` with a row-count-gated scatter-add
    backward (``padded_scatter_add`` up to PADDED_BWD_MAX_ROWS rows, else
    ``scatter_add_dense``)."""
    return jnp.take(table, ids, axis=0)


def _lookup_fwd(table, ids):
    # zero-size exemplar carries the table dtype into the bwd (a raw dtype
    # object is not a valid pytree leaf for residuals)
    proto = jnp.zeros((0,), table.dtype)
    return jnp.take(table, ids, axis=0), (ids, table.shape[0], proto)


def _lookup_bwd(res, cot):
    ids, vocab, proto = res
    if vocab <= PADDED_BWD_MAX_ROWS:
        grad = padded_scatter_add(ids, cot, vocab)
    else:
        grad = scatter_add_dense(ids, cot, vocab)
    return grad.astype(proto.dtype), None


embedding_lookup.defvjp(_lookup_fwd, _lookup_bwd)


@jax.custom_vjp
def _take_f32_grad(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(table, ids, axis=0)


def _take_f32_grad_bwd(res, cot):
    ids, vocab, proto = res
    return native_scatter_add(ids, cot, vocab).astype(proto.dtype), None


_take_f32_grad.defvjp(_lookup_fwd, _take_f32_grad_bwd)


def embedding_take(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """``jnp.take(table, ids, axis=0)`` whose backward accumulates in f32.

    The lookup for tables outside the custom-backward windows. f32 tables
    keep AD's own scatter, fused into the step; narrower tables (bf16) get
    ``native_scatter_add`` into an f32 gradient, cast once to the table
    dtype, instead of AD's scatter in the table dtype."""
    if jnp.dtype(table.dtype).itemsize >= 4:
        return jnp.take(table, ids, axis=0)
    return _take_f32_grad(table, ids)


# ------------------------------------------------------------ dedup'd lookup
# Zipf-skewed CTR ids are repetitive (DLRM b8192: 213k rows -> ~36k unique);
# scatters pay per ROW, so with a host-precomputed dedup plan
# (data/dedup.py — perm / slot_sorted / uniq, built in the producer thread)
# the backward collapses to
#
#   d_uniq = sorted_scatter_add(slot_sorted, cot[perm], U_cap)  # segment-sum
#   grad   = sorted_scatter_add(uniq, d_uniq, V)                # ~36k rows
#
# Scope: replicated tables with the batch resident on one device. Under a
# data-sharded mesh, ``perm`` indexes the GLOBAL flat id stream, so GSPMD
# would turn the reorder into a cross-device gather — per-shard plans via
# shard_map are the growth path.


@jax.custom_vjp
def embedding_lookup_dedup(table, ids, perm, slot_sorted, uniq):
    """``jnp.take(table, ids, axis=0)`` with a dedup'd scatter-add backward
    driven by a host-precomputed plan (``data.dedup.build_plan``):
    ``perm``/``slot_sorted`` [N = ids.size], ``uniq`` [U_cap] ascending,
    padded with ids ≥ 2^30 (dropped by the segment-sum)."""
    return jnp.take(table, ids, axis=0)


def _lookup_dedup_fwd(table, ids, perm, slot_sorted, uniq):
    proto = jnp.zeros((0,), table.dtype)
    res = (perm, slot_sorted, uniq, table.shape[0], proto)
    return jnp.take(table, ids, axis=0), res


def _lookup_dedup_bwd(res, cot):
    perm, slot_sorted, uniq, vocab, proto = res
    cot2 = cot.reshape(-1, cot.shape[-1])
    d_uniq = sorted_scatter_add(slot_sorted, cot2, uniq.shape[0], order=perm)
    grad = sorted_scatter_add(uniq, d_uniq, vocab)
    return grad.astype(proto.dtype), None, None, None, None


embedding_lookup_dedup.defvjp(_lookup_dedup_fwd, _lookup_dedup_bwd)

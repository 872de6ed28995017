"""Explicit row-sharded embedding exchange over the ``model`` mesh axis.

This is the manual (shard_map) counterpart to GSPMD-partitioned gathers:
the table lives row-sharded ([V/m, D] per device along ``model``), lookup
ids are replicated along ``model`` (they are batch-sharded along ``data``),
and each device contributes the rows it owns:

    local  = take(shard, clamp(ids - lo))        # in-shard gather
    masked = where(lo <= ids < hi, local, 0)
    out    = psum(masked, 'model')               # all-reduce over 'model'

The backward pass falls out of AD as a shard-local scatter-add of the
masked output cotangent — exactly the "model-parallel embedding" gradient
(no gradient all-reduce over ``model`` is needed; each shard owns its rows).
This replaces the reference's replicated 1M×16 table under MirroredStrategy
(``ctr/train.py:64-65``, SURVEY.md §2.6 "Embedding-table parallel").

``all_to_all_lookup`` is the bandwidth-optimal exchange (ids routed to the
owning shard, vectors routed back); ``sort_coalesced_lookup`` feeds the
backward pass sorted cotangents so duplicate updates coalesce per tile.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from recommender_tpu.core.mesh import DATA_AXIS, MODEL_AXIS


def shard_table(table: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a [V, D] table row-sharded over the ``model`` axis."""
    return jax.device_put(table, NamedSharding(mesh, P(MODEL_AXIS, None)))


@jax.custom_vjp
def _local_gather(shard: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray):
    """Masked in-shard gather with a FAST shard-local scatter-add backward.

    Forward: ``where(valid, take(shard, clip(idx)), 0)`` over flat ``idx``.
    Backward: the transpose is a shard-local scatter-add. This VJP routes
    the cotangent through the same row-count-gated backward as
    ``ops.embedding_kernels.embedding_lookup`` (``padded_scatter_add`` up
    to PADDED_BWD_MAX_ROWS rows, else the sorted scatter), with invalid
    positions zeroed so clamped indices add nothing. Callers go through
    ``_masked_gather``, which applies this VJP only when the shard has ≥
    ``PADDED_BWD_MIN_SHARD_ROWS`` rows; smaller shards keep XLA's native
    scatter (``embedding_take``).
    """
    rows = shard.shape[0]
    out = jnp.take(shard, jnp.clip(idx, 0, rows - 1), axis=0)
    return jnp.where(valid[:, None], out, 0.0)


def _local_gather_fwd(shard, idx, valid):
    proto = jnp.zeros((0,), shard.dtype)
    return _local_gather(shard, idx, valid), (idx, valid, shard.shape[0], proto)


def _local_gather_bwd(res, cot):
    from recommender_tpu.ops.embedding_kernels import (
        PADDED_BWD_MAX_ROWS,
        padded_scatter_add,
        scatter_add_dense,
    )

    idx, valid, rows, proto = res
    upd = jnp.where(valid[:, None], cot, 0.0)
    safe = jnp.clip(idx, 0, rows - 1)
    if rows <= PADDED_BWD_MAX_ROWS:
        grad = padded_scatter_add(safe, upd, rows)
    else:
        # huge shards (> 2M rows): the 64-lane padded destination stops
        # paying; sort the ids and segment-sum instead
        grad = scatter_add_dense(safe, upd, rows)
    return grad.astype(proto.dtype), None, None


_local_gather.defvjp(_local_gather_fwd, _local_gather_bwd)


# Destination-size gates for the custom scatter-add backward at the
# per-shard shapes (a 213k-id cotangent into V/m x 16): the padded path in
# [300k, 2M] rows, the sorted scatter in the 2-5M window, XLA's native
# scatter fused into the step outside them (accumulated in f32 for bf16
# shards: ``embedding_take``). Tuned on earlier hardware; not yet re-tuned
# on the current GPU.
PADDED_BWD_MIN_SHARD_ROWS = 300_000


def _masked_gather(shard: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray):
    """Shape-gated masked gather: custom VJP (padded scatter ≤2M rows,
    sorted scatter in the 2-5M window) only where the per-shard
    destination sits in a regime the custom paths win (gates above);
    ``embedding_take`` elsewhere."""
    from recommender_tpu.ops.embedding_kernels import (
        SORTED_BWD_MAX_ROWS,
        embedding_take,
    )

    if PADDED_BWD_MIN_SHARD_ROWS <= shard.shape[0] <= SORTED_BWD_MAX_ROWS:
        return _local_gather(shard, idx, valid)
    out = embedding_take(shard, jnp.clip(idx, 0, shard.shape[0] - 1))
    return jnp.where(valid[:, None], out, 0.0)


def _local_masked_lookup(shard: jnp.ndarray, ids: jnp.ndarray, axis: str):
    """Inside shard_map: gather the rows this shard owns, zero the rest, psum."""
    rows = shard.shape[0]
    lo = jax.lax.axis_index(axis) * rows
    local_idx = (ids - lo).reshape(-1)
    valid = (local_idx >= 0) & (local_idx < rows)
    contrib = _masked_gather(shard, local_idx, valid)
    contrib = contrib.reshape(*ids.shape, shard.shape[1])
    return jax.lax.psum(contrib, axis)


def sharded_lookup(table: jnp.ndarray, ids: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Lookup ``ids`` [...] in a row-sharded ``table`` [V, D] → [..., D].

    Works under jit; differentiable — and this is the point of using it
    over letting GSPMD compile the gather on a partitioned param: the
    cotangent scatter-add stays SHARD-LOCAL ([V/m, D] per device, with the
    per-shard backward gate in ``_masked_gather``), whereas XLA's SPMD
    partitioner cannot row-split a scatter with arbitrary indices and
    compiles the gspmd route's backward as a REPLICATED full-table scatter
    on every device (verified from compiled HLO on the 8-device mesh,
    tests/test_sharded_10m.py::test_psum_lookup_shard_local_backward —
    [V, 64] padded dest per device vs this path's [V/m, ·]).

    On a ``(data × model)`` mesh the ids stay batch-sharded over ``data``
    (each data-replica group looks up only its own rows; the table
    cotangent is psum'd over ``data`` by the shard_map transpose of the
    replicated-over-data table spec); ids are only replicated when the
    leading dim doesn't divide the data axis.
    """
    data = mesh.shape.get(DATA_AXIS, 1)
    batch_sharded = ids.ndim >= 1 and data > 1 and ids.shape[0] % data == 0
    ids_spec = P(DATA_AXIS) if batch_sharded else P()
    fn = shard_map(
        partial(_local_masked_lookup, axis=MODEL_AXIS),
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), ids_spec),
        out_specs=ids_spec,
        check_vma=False,
    )
    return fn(table, ids)


def _a2a_local(shard, ids, axis: str, capacity: int, count_axes: tuple = ()):
    """Per-device body of the all-to-all exchange (see ``all_to_all_lookup``).

    ``count_axes``: when non-empty, also return the GLOBAL number of ids
    dropped to overflow (psum over these axes) — one scalar, ~free, so
    train-time skew is observable instead of silently corrupting training."""
    m = jax.lax.axis_size(axis)
    rows = shard.shape[0]
    d = shard.shape[1]
    flat = ids.reshape(-1)
    n = flat.shape[0]

    owner = jnp.clip(flat // rows, 0, m - 1)  # owning shard per id
    # stable pack: sort by owner, slot positions within each owner bucket
    order = jnp.argsort(owner)  # [n]
    sorted_owner = owner[order]
    sorted_ids = flat[order]
    # position within bucket = index - start_of_bucket
    start = jnp.searchsorted(sorted_owner, jnp.arange(m))  # [m]
    within = jnp.arange(n) - start[sorted_owner]
    ok = within < capacity  # overflow ids fall back to 0-vector (see docstring)
    send_ids = jnp.full((m, capacity), rows * m, jnp.int32)  # pad = out-of-range
    # overflow entries scatter out of range and are dropped (never clobber)
    send_ids = send_ids.at[sorted_owner, jnp.where(ok, within, capacity)].set(
        sorted_ids.astype(jnp.int32), mode="drop"
    )

    # exchange: row j of send_ids goes to device j
    recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0, tiled=False)  # [m, C]
    # serve local rows (pad/foreign-range ids → clamp, zero later)
    my = jax.lax.axis_index(axis)
    local_idx = recv_ids - my * rows
    valid = (local_idx >= 0) & (local_idx < rows)
    # shape-gated gather: padded-scatter backward only where the per-shard
    # destination sits on XLA's narrow-scatter cliff (see PADDED_BWD_MIN_SHARD_ROWS)
    served = _masked_gather(shard, local_idx.reshape(-1), valid.reshape(-1))
    served = served.reshape(m, capacity, d)
    # send results back
    recv_vecs = jax.lax.all_to_all(served, axis, 0, 0, tiled=False)  # [m, C, D]

    # unpack: vector for sorted position i lives at [owner_i, within_i];
    # overflow positions index out of range and read 0. Both gathers read
    # each slot at most once (unique_indices), so their AD transposes are
    # plain stores, not atomic adds in the table dtype.
    got = recv_vecs.at[sorted_owner, jnp.where(ok, within, capacity)].get(
        mode="fill", fill_value=0, unique_indices=True)
    # inverse permutation back to original id order
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(n))
    out = jnp.take(got, inv, axis=0, unique_indices=True)
    out = out.reshape(*ids.shape, d)
    if count_axes:
        dropped = jax.lax.psum(jnp.sum(~ok).astype(jnp.int32), count_axes)
        return out, dropped
    return out


def all_to_all_lookup(
    table: jnp.ndarray,
    ids: jnp.ndarray,
    mesh: Mesh,
    capacity_factor: float = 2.0,
    return_overflow: bool = False,
) -> jnp.ndarray:
    """Row-sharded lookup via all-to-all ID/vector exchange over ``model``.

    The bandwidth-optimal exchange for large batches (BASELINE.json north
    star; the DLRM-paper model-parallel embedding pattern): instead of every
    shard psum-ing a full [B, F, D] contribution (``sharded_lookup``), each
    device routes each id to its owning shard (ids all-to-all), the owner
    gathers the rows, and vectors ride back (vectors all-to-all). Comm per
    device drops from ``B·F·D`` (psum) to ``≈2·(B·F/m)·D`` plus the id
    exchange.

    Fixed-shape routing: per-destination capacity is
    ``ceil(n_local/m · capacity_factor)``; ids beyond a destination's
    capacity (pathological skew) are served a 0 vector — size
    ``capacity_factor`` for the skew you expect, or keep the psum path for
    tiny batches. Differentiable end-to-end (AD transposes the all_to_alls
    and the local gather's scatter-add stays shard-local).

    On a ``(data × model)`` mesh the ids stay **batch-sharded over data**
    (each data-replica group exchanges only its own rows; the table
    cotangent is psum'd over ``data`` by the shard_map transpose) — ids are
    only replicated when the leading dim doesn't divide the data axis.
    """
    data = mesh.shape.get(DATA_AXIS, 1)
    batch_sharded = ids.ndim >= 1 and data > 1 and ids.shape[0] % data == 0
    n_local = ids.size // (data if batch_sharded else 1)
    ids_spec = P(DATA_AXIS) if batch_sharded else P()
    out_spec = P(DATA_AXIS) if batch_sharded else P()
    # the overflow count is psum'd over every mesh axis the ids span, so it
    # is globally replicated (a valid P() output even when ids are
    # data-sharded) and reads as "ids dropped this step, whole mesh"
    count_axes = ()
    if return_overflow:
        count_axes = (DATA_AXIS, MODEL_AXIS) if batch_sharded else (MODEL_AXIS,)
    fn = shard_map(
        partial(
            _a2a_local,
            axis=MODEL_AXIS,
            capacity=int(np.ceil(n_local / mesh.shape[MODEL_AXIS] * capacity_factor)),
            count_axes=count_axes,
        ),
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), ids_spec),
        out_specs=(out_spec, P()) if return_overflow else out_spec,
        check_vma=False,
    )
    return fn(table, ids)


def a2a_overflow_fraction(
    ids: np.ndarray, num_shards: int, vocab_size: int, capacity_factor: float
) -> float:
    """Host-side diagnostic: fraction of lookups the all-to-all exchange
    would drop (serve a 0 vector) at this capacity, given a sample of real
    ids. Use while sizing ``capacity_factor``; 0.0 means lossless for this
    sample. ``capacity_factor >= num_shards`` is always 0."""
    flat = np.asarray(ids).reshape(-1)
    rows = vocab_size // num_shards
    owner = np.clip(flat // max(rows, 1), 0, num_shards - 1)
    capacity = int(np.ceil(flat.size / num_shards * capacity_factor))
    counts = np.bincount(owner, minlength=num_shards)
    return float(np.maximum(counts - capacity, 0).sum() / max(flat.size, 1))


def sort_coalesced_lookup(
    table: jnp.ndarray, ids: jnp.ndarray, mesh: Mesh | None = None
) -> jnp.ndarray:
    """Gather through a sorted id order (duplicates become adjacent).

    NOT a payload-reducing dedup: all N positions are still gathered (and,
    in the sharded case, psum'd) — static shapes under jit rule out a true
    unique(). What sorting buys is *backward* locality: the scatter-add
    cotangent arrives sorted, so adjacent duplicate updates coalesce into
    the same table rows (the precondition for
    ``ops.embedding_kernels.sorted_scatter_add``). Use ``all_to_all_lookup``
    when communication reduction is the goal.
    """
    flat = ids.reshape(-1)
    order = jnp.argsort(flat)
    sorted_ids = flat[order]
    if mesh is not None and mesh.shape[MODEL_AXIS] > 1:
        gathered = sharded_lookup(table, sorted_ids, mesh)
    else:
        from recommender_tpu.ops.embedding_kernels import embedding_take

        gathered = embedding_take(table, sorted_ids)
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    out = jnp.take(gathered, inv, axis=0, unique_indices=True)
    return out.reshape(*ids.shape, table.shape[-1])

"""Retrieval: full-corpus inference, top-k recommendation, hit-rate.

Replaces ``pinsage/train/evaluation.py`` (numpy argpartition
on host) and the Spark map-reduce serving path (``pinsage/inference/*``,
which never even loads trained weights — ``inference.py:57-64``) with
on-chip batched matmul + ``lax.top_k`` under jit.

Multi-chip serving: pass ``mesh=`` and both the corpus inference and the
top-k scoring shard their BATCH dimension over the ``data`` axis (blocks /
query rows split across chips, item matrix replicated; each chip scores
its user rows against the full corpus — embarrassingly parallel, no
collective in the hot loop). Tested on the 8-virtual-device mesh
(tests/test_pinsage.py::test_sharded_corpus_eval_matches_single_device).

* ``full_corpus_reprs``  — every item id through sampled blocks → reprs
  (``evaluation.py:6-24``).
* ``recommend_topk``     — each user's latest item repr vs all items,
  seen-item masking with -inf, top-k (``evaluation.py:27-51``; exact
  ``lax.top_k`` instead of unordered ``argpartition``).
* ``hit_rate``           — any-hit mean over users (``evaluation.py:54-65``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def _data_shard(x, mesh):
    """Place ``x`` split on dim 0 over the mesh's ``data`` axis."""
    nd = jnp.asarray(x).ndim
    return jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P("data", *([None] * (nd - 1))))
    )


def full_corpus_reprs(
    model, params, graph, rng: np.random.Generator, batch_size: int = 512,
    mesh=None, **sampler_kw
) -> np.ndarray:
    """Compute reprs for every item (PinSage: fresh sampled blocks per batch).

    ``mesh``: shard each block batch over the ``data`` axis (every leaf's
    leading dim is a multiple of the node count N, so a batch_size divisible
    by the data-axis size shards evenly)."""
    from recommender_tpu.graph.bipartite import sample_block_batch

    if mesh is not None and batch_size % mesh.shape["data"]:
        raise ValueError(
            f"batch_size {batch_size} must divide by the data axis "
            f"({mesh.shape['data']}) for sharded corpus inference"
        )

    @jax.jit
    def reprs(block):
        return model.get_repr(params, block)

    def put(block):
        if mesh is None:
            return {k: jnp.asarray(v) for k, v in block.items()}
        return {k: _data_shard(v, mesh) for k, v in block.items()}

    out = []
    n = graph.num_items
    for s in range(0, n, batch_size):
        ids = np.arange(s, min(s + batch_size, n), dtype=np.int32)
        pad = batch_size - len(ids)
        if pad:
            ids = np.concatenate([ids, np.zeros(pad, np.int32)])
        block = sample_block_batch(graph, ids, rng, **sampler_kw).as_dict()
        r = jax.device_get(reprs(put(block)))
        out.append(r[: batch_size - pad])
    return np.concatenate(out, axis=0)


def resolve_seen_format(seen, num_items: int, seen_format: str = "auto") -> bool:
    """True ⇔ ``seen`` is padded per-user id lists, False ⇔ a [U, V] mask.

    ``seen_format='auto'`` sniffs by dtype/ndim ATTRIBUTES (no ``np.asarray``
    — that would force a full device fetch of a device-resident ``seen``):
    bool / sparse (``toarray``) → mask; 2-D integer → id lists. A 2-D
    integer array whose width equals the corpus size is AMBIGUOUS — it
    could be a 0/1 int mask (accepted pre-r5) or S==V id lists — and is
    rejected with instructions to pass ``seen_format`` explicitly, instead
    of being silently reinterpreted."""
    if seen_format in ("mask", "ids"):
        return seen_format == "ids"
    if seen_format != "auto":
        raise ValueError(f"seen_format must be 'auto'|'mask'|'ids', got {seen_format!r}")
    if hasattr(seen, "toarray"):  # scipy sparse: always a mask
        return False
    dtype = getattr(seen, "dtype", None)
    ndim = getattr(seen, "ndim", None)
    if dtype is None or ndim is None:
        a = np.asarray(seen)
        dtype, ndim = a.dtype, a.ndim
        seen = a
    id_lists = bool(np.issubdtype(dtype, np.integer) and ndim == 2)
    if id_lists and seen.shape[1] == num_items:
        raise ValueError(
            f"ambiguous integer [U, {num_items}] `seen` with width == corpus "
            "size: could be a 0/1 mask or S==V padded id lists — pass "
            "seen_format='mask' or seen_format='ids' explicitly"
        )
    return id_lists


def _reduce_topk(sim, k: int, exact: bool):
    if exact:
        _, idx = jax.lax.top_k(sim, k)
    else:
        # serving-scale corpora: a partial reduction XLA may fuse with the
        # scoring matmul (exact on backends without an approximate kernel);
        # quality evals keep the exact sort so hit-rate numbers are
        # reduction-independent
        _, idx = jax.lax.approx_max_k(sim, k, recall_target=0.95)
    return idx


@partial(jax.jit, static_argnames=("k", "exact"))
def _topk_scores(query_reprs, item_reprs, seen_mask, k: int, exact: bool = True):
    sim = jnp.matmul(query_reprs, item_reprs.T)  # [U, V]
    sim = jnp.where(seen_mask, -jnp.inf, sim)
    return _reduce_topk(sim, k, exact)


@partial(jax.jit, static_argnames=("k", "exact"))
def _topk_scores_idmask(query_reprs, item_reprs, seen_ids, k: int,
                        exact: bool = True):
    """Seen-exclusion by PADDED ID LISTS ([B, S] int32, pad = -1) instead
    of a dense [B, V] bool mask — at serving-scale corpora the dense mask
    is the memory wall (1024 users × 10M items = 10 GB per block), while
    real per-user histories are a few hundred ids.

    Exclusion is by candidate OVER-FETCH (k+S) + filtering on the tiny
    candidate list, never by scattering -inf into the [B, V] score matrix:
    a scatter there breaks XLA's matmul→reduction fusion and materializes
    the full score matrix (131 GB at 16k×2M — found by OOM, see
    retrieval/quantize.py::_drop_excluded)."""
    from recommender_tpu.retrieval.quantize import _drop_excluded

    sim = jnp.matmul(query_reprs, item_reprs.T)  # [B, V]
    # clamp the over-fetch to the corpus (top_k fails on kk > V for small
    # corpora / wide histories); k <= V still required — when fewer than k
    # unseen candidates exist the tail degrades to seen ids (graceful)
    kk = min(k + seen_ids.shape[1], item_reprs.shape[0])
    idx = _reduce_topk(sim, kk, exact)
    return _drop_excluded(idx, seen_ids, k)


def recommend_topk(
    item_reprs: np.ndarray,
    latest_items: np.ndarray,
    seen: "np.ndarray | object",
    k: int = 10,
    batch_size: int = 1024,
    mesh=None,
    exact: bool = True,
    seen_format: str = "auto",
) -> np.ndarray:
    """[U] users' latest item ids → [U, k] recommended items (the PinSage
    protocol: the query vector is the user's latest item's repr).

    ``seen``: items already interacted, excluded from recommendations —
    EITHER a [U, V] bool matrix (dense or scipy sparse; the quality-eval
    form) OR a [U, S] int array of PADDED per-user seen-id lists (pad =
    -1; the serving-scale form — a dense mask block is 10 GB at 1024
    users × 10M items while real histories are a few hundred ids).
    ``seen_format``: 'mask' | 'ids' | 'auto' (sniff; rejects the ambiguous
    integer-width-V case — ``resolve_seen_format``).
    ``mesh``: shard the user rows of each scoring batch over the ``data``
    axis (items replicated); the tail batch is padded up so it still
    shards evenly."""
    queries = np.asarray(item_reprs)[np.asarray(latest_items)]
    return recommend_topk_from_queries(
        queries, item_reprs, seen, k=k, batch_size=batch_size, mesh=mesh,
        exact=exact, seen_format=seen_format,
    )


def recommend_topk_from_queries(
    query_reprs: np.ndarray,
    item_reprs: np.ndarray,
    seen: "np.ndarray | object",
    k: int = 10,
    batch_size: int = 1024,
    mesh=None,
    exact: bool = True,
    seen_format: str = "auto",
) -> np.ndarray:
    """[U, D] arbitrary query vectors → [U, k] recommended items — the
    general form behind ``recommend_topk``, used directly by dual-encoder
    retrieval (the two-tower USER reprs are queries that are not any
    item's repr). Same ``seen``/``mesh``/``exact`` contract."""
    item_reprs = jnp.asarray(item_reprs)
    query_reprs = np.asarray(query_reprs)
    id_lists = resolve_seen_format(seen, item_reprs.shape[0], seen_format)
    if mesh is not None:
        item_reprs = jax.device_put(item_reprs, NamedSharding(mesh, P()))
    out = []
    U = len(query_reprs)
    for s in range(0, U, batch_size):
        users = slice(s, min(s + batch_size, U))
        qb = query_reprs[users]
        seen_block = seen[users]
        if not id_lists:
            if hasattr(seen_block, "toarray"):
                seen_block = seen_block.toarray()
            seen_block = np.asarray(seen_block, bool)
        n_real = len(qb)
        if mesh is not None:
            ndata = mesh.shape["data"]
            pad = (-n_real) % ndata
            if pad:
                qb = np.concatenate([qb, qb[:1].repeat(pad, axis=0)])
                seen_block = np.concatenate(
                    [seen_block, seen_block[:1].repeat(pad, axis=0)]
                )
            q = _data_shard(qb, mesh)
            mask = _data_shard(seen_block, mesh)
        else:
            q = jnp.asarray(qb)
            mask = jnp.asarray(seen_block)
        if id_lists:
            idx = _topk_scores_idmask(q, item_reprs, mask, k, exact)
        else:
            idx = _topk_scores(q, item_reprs, mask.astype(bool), k, exact)
        out.append(np.asarray(idx)[:n_real])
    return np.concatenate(out, axis=0)


def hit_rate(recommendations: np.ndarray, ground_truth) -> float:
    """[U, k] recs vs [U, V] 0/1 ground truth → mean any-hit."""
    U, K = recommendations.shape
    user_idx = np.repeat(np.arange(U), K)
    item_idx = recommendations.reshape(-1)
    rel = np.asarray(ground_truth[user_idx, item_idx]).reshape(U, K)
    return float(rel.any(axis=1).mean())

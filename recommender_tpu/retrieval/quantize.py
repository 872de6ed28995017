"""Int8-quantized corpus scoring — a serving-side optimization.

The retrieval hot loop is a [Q, D] × [D, V] matmul over the full corpus
(``retrieval/eval.py::_topk_scores``; the reference's Spark re-scoring
path, ``pinsage/inference/inference.py``, never even loads trained
weights). At production corpus sizes (millions of items) the matmul is
compute-bound and the corpus residency is HBM-bound — both are what an
int8 path improves: accelerators run int8 matmuls at twice their bf16
rate, and the resident corpus is 4× smaller (int8 rows + one f32 scale
per item).

Scheme: symmetric per-row max-abs quantization.

    q_v = round(127 · r_v / s_v),   s_v = max|r_v| / 127

Scores factor as ``(q_u · q_v) · s_u · s_v``. For a single query row the
query scale ``s_u > 0`` is a positive constant — it cannot change that
query's top-k order — so serving computes the int8 matmul in int32 (one
matmul), applies the per-ITEM scale column-wise in f32, and never
dequantizes the corpus. Quantization error is bounded by the per-row
resolution (~s_v/2 per coordinate): top-k overlap vs f32 scoring is
measured in ``tests/test_export.py``. The throughput on the GPU is not
measured yet.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def quantize_reprs(reprs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[V, D] f32 → ([V, D] int8, [V] f32 per-row scales).

    Zero rows get scale 0 (their scores are exactly 0 — same as f32)."""
    r = np.asarray(reprs, np.float32)
    amax = np.abs(r).max(axis=1)
    scale = amax / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(r / safe[:, None]), -127, 127).astype(np.int8)
    q[scale == 0] = 0
    return q, scale.astype(np.float32)


@jax.jit
def _scores_int8(q_queries, q_items, item_scale):
    """[Q, D] int8 × [V, D] int8 → [Q, V] f32 item-scaled scores.

    One int8→int32 matmul; the query scale is per-ROW positive so it
    is dropped (rank-invariant per query). ``item_scale`` re-weights
    columns — required for cross-item comparability."""
    acc = jax.lax.dot_general(
        q_queries, q_items,
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * item_scale[None, :]


def recommend_topk_quantized(
    q_items: np.ndarray,
    item_scale: np.ndarray,
    latest_items: np.ndarray,
    seen: "np.ndarray | object",
    k: int = 10,
    batch_size: int = 1024,
    exact: bool = False,
    recall_target: float = 0.95,
    seen_format: str = "auto",
) -> np.ndarray:
    """Int8 counterpart of ``retrieval.eval.recommend_topk``: [U] users'
    latest item ids → [U, k] recommendations, seen items masked, scored
    from the quantized corpus. Used to certify serving-quantization
    task-metric neutrality (hit-rate, benchmarks/quality_runs.py).

    ``seen``: [U, V] bool (dense/sparse; masked with an elementwise
    ``where`` — fusion-safe) or padded [U, S] seen-id lists (pad -1; the
    serving-scale form, excluded by candidate over-fetch).
    ``seen_format``: 'mask' | 'ids' | 'auto' (sniff; rejects the ambiguous
    integer-width-V case — ``retrieval.eval.resolve_seen_format``)."""
    from recommender_tpu.retrieval.eval import resolve_seen_format

    qi = jnp.asarray(q_items)
    sc = jnp.asarray(item_scale)
    id_lists = resolve_seen_format(seen, qi.shape[0], seen_format)
    out = []
    U = len(latest_items)
    for s in range(0, U, batch_size):
        users = slice(s, min(s + batch_size, U))
        seen_block = seen[users]
        latest = jnp.asarray(np.asarray(latest_items[users]))
        if id_lists:
            idx = _recommend_int8_idmask(
                qi, sc, latest, jnp.asarray(np.asarray(seen_block)),
                k=k, exact=exact, recall_target=recall_target,
            )
        else:
            if hasattr(seen_block, "toarray"):
                seen_block = seen_block.toarray()
            idx = _recommend_int8(
                qi, sc, latest, jnp.asarray(np.asarray(seen_block, bool)),
                k=k, exact=exact, recall_target=recall_target,
            )
        out.append(np.asarray(idx))
    return np.concatenate(out, axis=0)


def _reduce(sim, kk, exact, recall_target):
    if exact:
        _, idx = jax.lax.top_k(sim, kk)
    else:
        _, idx = jax.lax.approx_max_k(sim, kk, recall_target=recall_target)
    return idx


@functools.partial(jax.jit, static_argnames=("k", "exact", "recall_target"))
def _recommend_int8(qi, sc, latest, mask, *, k, exact, recall_target):
    sim = _scores_int8(qi[latest], qi, sc)
    sim = jnp.where(mask, -jnp.inf, sim)  # elementwise: fusion-safe
    return _reduce(sim, k, exact, recall_target)


@functools.partial(jax.jit, static_argnames=("k", "exact", "recall_target"))
def _recommend_int8_idmask(qi, sc, latest, seen_ids, *, k, exact, recall_target):
    sim = _scores_int8(qi[latest], qi, sc)
    # clamp the over-fetch to the corpus size (see eval._topk_scores_idmask)
    idx = _reduce(sim, min(k + seen_ids.shape[1], qi.shape[0]), exact, recall_target)
    return _drop_excluded(idx, seen_ids, k)


def topk_quantized(
    q_items: np.ndarray,
    item_scale: np.ndarray,
    query_ids: np.ndarray,
    k: int = 10,
    mask_self: bool = True,
    exact: bool = False,
    recall_target: float = 0.95,
) -> np.ndarray:
    """Item-to-item top-k over an int8 corpus: [Q] ids → [Q, k] ids.

    Serving default is ``jax.lax.approx_max_k`` — a partial reduction that
    XLA may fuse with the scoring matmul instead of materializing (and
    sorting) the full [Q, V] score matrix; backends without an approximate
    kernel compute it exactly. ``exact=True`` restores ``lax.top_k``
    (bit-exact order, the quality-eval path)."""
    # module-level jit (statics: k/exact/...) — a per-call closure would
    # RETRACE on every invocation and re-transfer the corpus; callers that
    # loop (cli/serve --all) pass device-resident arrays and reuse one
    # compiled program
    return np.asarray(_topk_int8(
        jnp.asarray(q_items), jnp.asarray(item_scale), jnp.asarray(query_ids),
        k=k, exact=exact, recall_target=recall_target, mask_self=mask_self,
    ))


def _drop_excluded(idx, excluded, k):
    """[Q, k+pad] candidate ids → first ``k`` per row not in ``excluded``
    ([Q, E]). Always returns width ``k``: a candidate list narrower than
    ``k`` (over-fetch clamped to a corpus smaller than k) is padded with
    the ``-1`` no-candidate sentinel, which sorts after real kept ids but
    before excluded ones — the output shape contract never silently
    shrinks. Score order is preserved (stable argsort on
    the keep flag).
    The SCATTER-free exclusion pattern: masking the [Q, V] score matrix
    with ``.at[rows, ids].set(-inf)`` breaks XLA's matmul→reduction fusion
    and materializes the full score matrix (131 GB at Q=16k, V=2M — found
    by OOM driving cli/serve --all); over-fetching k+E candidates keeps
    the scoring fused and filters on the tiny candidate list instead."""
    if idx.shape[1] < k:
        idx = jnp.concatenate(
            [idx, jnp.full((idx.shape[0], k - idx.shape[1]), -1, idx.dtype)],
            axis=1,
        )
    keep = ~(idx[:, :, None] == excluded[:, None, :]).any(-1)
    order = jnp.argsort(~keep, axis=1, stable=True)
    return jnp.take_along_axis(idx, order[:, :k], axis=1)


@functools.partial(
    jax.jit, static_argnames=("k", "exact", "recall_target", "mask_self")
)
def _topk_int8(qi, sc, ids, *, k, exact, recall_target, mask_self):
    sim = _scores_int8(qi[ids], qi, sc)
    kk = min(k + 1 if mask_self else k, qi.shape[0])
    if exact:
        _, idx = jax.lax.top_k(sim, kk)
    else:
        _, idx = jax.lax.approx_max_k(sim, kk, recall_target=recall_target)
    if mask_self:
        idx = _drop_excluded(idx, ids[:, None], k)
    return idx

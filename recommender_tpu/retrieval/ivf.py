"""IVF (clustered) retrieval — the serving lever past brute force.

Brute-force scoring streams the WHOLE corpus per query batch
(`quantize.topk_quantized`): at V=2M int8 that is 0.26 GB per batch —
shared across all Q queries, so it is hard to beat at large Q. But
latency-bound serving runs SMALL Q, where each
batch still pays the full corpus stream: V=16M, Q=32 → 2.2 GB read for
32 queries. An inverted-file index reads only the probed clusters:
Q × probes × cap rows — at V=16M, Q≤64 that is ~30× less HBM traffic.

Design (no reference counterpart; the reference's serving is a
random-weights Spark job, `pinsage/inference/inference.py:57-64`):

* **k-means on device** — `lax.scan` over Lloyd iterations; the assign
  step is one [V, D]×[D, C] matmul, the update a `segment_sum`.
  Empty clusters re-seed from the largest cluster's members.
* **Fixed-shape padded buckets + spill** (the same capacity pattern as
  the all-to-all embedding exchange, `embedding/sharded.py`): clusters
  are stored as a dense [C, cap, D] int8 block (pad rows score 0 and
  carry id −1 → masked −inf). Items overflowing `cap` go to a flat SPILL
  block that every query scans — bounded memory (capacity_factor × V
  rows) with zero dropped items, and overflow cost is proportional to
  skew, not worst-case cluster size.
* **Query = two matmul passes under one jit**: queries × centroids → top-P
  probe ids; gather the P padded buckets; int8 einsum over [Q, P, cap]
  candidates + the spill; single `top_k` over the concatenation.
  Per-query candidate count is static (P × cap + S) — XLA-friendly, no
  ragged anything.

Quantization follows `retrieval/quantize.py`: symmetric per-row max-abs,
query scale dropped (rank-invariant per query), per-item scales applied
column-wise. Recall vs brute force is a measured trade (tests/test_ivf.py),
controlled by `probes`.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np


@dataclasses.dataclass
class IVFIndex:
    """Device-resident after `jnp.asarray` of the array fields."""

    centroids: np.ndarray    # [C, D] f32 (unit-normed not required)
    bucket_ids: np.ndarray   # [C, cap] int32 item ids, pad = -1
    bucket_q: np.ndarray     # [C, cap, D] int8 quantized rows, pad = 0
    bucket_scale: np.ndarray  # [C, cap] f32 per-row scales, pad = 0
    spill_ids: np.ndarray    # [S] int32
    spill_q: np.ndarray      # [S, D] int8
    spill_scale: np.ndarray  # [S] f32

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.bucket_ids.shape[1]

    def nbytes(self) -> int:
        return sum(
            getattr(self, f.name).nbytes for f in dataclasses.fields(self)
        )


def _chunk_rows_for(V: int, num_clusters: int) -> int:
    """Row-chunk size keeping the [chunk, C] similarity block ≤128 MB —
    a full [V, C] f32 block at production scale (8M × 8k = 256 GB) can
    never materialize."""
    return max(1024, min(V, (128 << 20) // max(4 * num_clusters, 1)))


def kmeans(reprs, num_clusters: int, iters: int = 10, seed: int = 0,
           chunk_rows: int | None = None):
    """Lloyd's k-means on device: returns ([C, D] f32 centroids,
    [V] int32 assignments). Each iteration scans row CHUNKS: per chunk
    one [chunk, D]×[D, C] matmul (argmax of q·c − ‖c‖²/2 ≡ L2-nearest
    in the scoring geometry we serve with) and a `segment_sum`
    accumulation — peak memory is one chunk's similarity block, never
    [V, C]. Empty clusters reseed to a perturbed copy of the heaviest
    cluster's centroid (deterministic Lloyd repair)."""
    import jax
    import jax.numpy as jnp

    r = jnp.asarray(reprs, jnp.float32)
    V, D = r.shape
    C = num_clusters
    chunk = chunk_rows or _chunk_rows_for(V, C)
    pad = (-V) % chunk
    rp = jnp.pad(r, ((0, pad), (0, 0)))
    valid = jnp.pad(jnp.ones((V,), jnp.float32), (0, pad))
    chunks = rp.reshape(-1, chunk, D)
    vchunks = valid.reshape(-1, chunk)
    key = jax.random.PRNGKey(seed)
    init = r[jax.random.choice(key, V, (C,), replace=False)]

    @jax.jit
    def sweep(cent, chunks, vchunks):
        """One pass over all rows → (per-cluster sums, weighted counts).
        The row data rides as ARGUMENTS: closed-over device arrays embed
        as jaxpr constants in the compiled program (a 512 MB corpus
        would be baked into every compile)."""
        cnorm = 0.5 * jnp.sum(cent * cent, axis=1)

        def body(carry, cv):
            sums, counts = carry
            rc, vc = cv
            a = jnp.argmax(rc @ cent.T - cnorm[None, :], axis=1)
            sums = sums + jax.ops.segment_sum(
                rc * vc[:, None], a, num_segments=C)
            counts = counts + jax.ops.segment_sum(vc, a, num_segments=C)
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            body,
            (jnp.zeros((C, D), jnp.float32), jnp.zeros((C,), jnp.float32)),
            (chunks, vchunks),
        )
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        # deterministic tiny offset per cluster id so several simultaneous
        # restarts don't collapse onto one point
        big = new[jnp.argmax(counts)]
        jitter = (jnp.arange(C, dtype=jnp.float32)[:, None] % 97.0) * 1e-4
        return jnp.where((counts > 0)[:, None], new, big[None, :] + jitter)

    cent = init
    for _ in range(iters):
        cent = sweep(cent, chunks, vchunks)

    assign = assign_clusters(cent, r, chunk_rows=chunk)
    return np.asarray(cent), assign


def assign_clusters(centroids, reprs, chunk_rows: int | None = None) -> np.ndarray:
    """[V] int32 nearest-centroid assignment, chunked like `kmeans`."""
    import jax
    import jax.numpy as jnp

    cent = jnp.asarray(centroids, jnp.float32)
    r = jnp.asarray(reprs, jnp.float32)
    V, D = r.shape
    C = cent.shape[0]
    chunk = chunk_rows or _chunk_rows_for(V, C)
    pad = (-V) % chunk
    rp = jnp.pad(r, ((0, pad), (0, 0))).reshape(-1, chunk, D)

    @jax.jit
    def go(cent, rp):
        cnorm = 0.5 * jnp.sum(cent * cent, axis=1)

        def body(_, rc):
            return None, jnp.argmax(
                rc @ cent.T - cnorm[None, :], axis=1).astype(jnp.int32)

        _, a = jax.lax.scan(body, None, rp)
        return a.reshape(-1)

    return np.asarray(go(cent, rp))[:V]


def build_ivf(
    reprs: np.ndarray,
    num_clusters: int,
    capacity_factor: float = 1.5,
    iters: int = 10,
    seed: int = 0,
) -> IVFIndex:
    """Cluster `reprs` [V, D] f32 and pack the int8 index.

    ``capacity_factor``: bucket cap = factor × mean cluster size (rounded
    up to 8 for lane alignment). Items past a bucket's cap spill to the
    always-scanned flat block — memory stays bounded at ~factor × V rows
    while skewed clusters lose nothing."""
    from recommender_tpu.retrieval.quantize import quantize_reprs

    reprs = np.asarray(reprs, np.float32)
    V, D = reprs.shape
    cent, assign = kmeans(reprs, num_clusters, iters=iters, seed=seed)
    cap = int(np.ceil(capacity_factor * V / num_clusters / 8.0) * 8)

    q, scale = quantize_reprs(reprs)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    start = np.searchsorted(sorted_assign, np.arange(num_clusters))
    end = np.searchsorted(sorted_assign, np.arange(num_clusters) + 1)

    bucket_ids = np.full((num_clusters, cap), -1, np.int32)
    bucket_q = np.zeros((num_clusters, cap, D), np.int8)
    bucket_scale = np.zeros((num_clusters, cap), np.float32)
    spill: list[np.ndarray] = []
    for c in range(num_clusters):
        members = order[start[c]:end[c]]
        take, rest = members[:cap], members[cap:]
        n = len(take)
        bucket_ids[c, :n] = take
        bucket_q[c, :n] = q[take]
        bucket_scale[c, :n] = scale[take]
        if len(rest):
            spill.append(rest)
    spill_idx = (np.concatenate(spill) if spill
                 else np.empty((0,), np.int64))
    # pad the spill to a lane multiple so its score block tiles cleanly
    S = int(np.ceil(max(len(spill_idx), 1) / 8.0) * 8)
    spill_ids = np.full((S,), -1, np.int32)
    spill_q = np.zeros((S, D), np.int8)
    spill_scale = np.zeros((S,), np.float32)
    spill_ids[: len(spill_idx)] = spill_idx
    spill_q[: len(spill_idx)] = q[spill_idx]
    spill_scale[: len(spill_idx)] = scale[spill_idx]
    return IVFIndex(cent, bucket_ids, bucket_q, bucket_scale,
                    spill_ids, spill_q, spill_scale)


@functools.partial(jax.jit, static_argnames=("k", "probes", "exact"))
def _search(centroids, bucket_ids, bucket_q, bucket_scale,
            spill_ids, spill_q, spill_scale, queries, *,
            k: int, probes: int, exact: bool):
    import jax.numpy as jnp

    qf = jnp.asarray(queries, jnp.float32)
    # pass 1: probe selection (tiny [Q, C] matmul)
    csim = qf @ centroids.T - 0.5 * jnp.sum(
        centroids * centroids, axis=1)[None, :]
    _, probe = jax.lax.top_k(csim, probes)            # [Q, P]

    # pass 2: score the probed buckets. Quantize the query per row
    # (scale dropped — rank-invariant per query, quantize.py).
    qmax = jnp.max(jnp.abs(qf), axis=1, keepdims=True)
    qq = jnp.clip(jnp.round(qf / jnp.maximum(qmax / 127.0, 1e-30)),
                  -127, 127).astype(jnp.int8)
    cand_q = bucket_q[probe]                           # [Q, P, cap, D] int8
    cand_scale = bucket_scale[probe]                   # [Q, P, cap]
    cand_ids = bucket_ids[probe]                       # [Q, P, cap]
    scores = jax.lax.dot_general(
        qq, cand_q,
        (((1,), (3,)), ((0,), (0,))),                  # contract D, batch Q
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * cand_scale                 # [Q, P, cap]
    Q = qf.shape[0]
    scores = scores.reshape(Q, -1)
    ids = cand_ids.reshape(Q, -1)

    # spill block: scanned by every query (bounded by capacity_factor)
    s_scores = jax.lax.dot_general(
        qq, spill_q, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * spill_scale[None, :]       # [Q, S]
    scores = jnp.concatenate(
        [scores, s_scores], axis=1)
    ids = jnp.concatenate(
        [ids, jnp.broadcast_to(spill_ids[None, :], (Q, spill_ids.shape[0]))],
        axis=1)

    scores = jnp.where(ids < 0, -jnp.inf, scores)      # mask pads
    if exact:
        top, idx = jax.lax.top_k(scores, k)
    else:
        top, idx = jax.lax.approx_max_k(scores, k, recall_target=0.95)
    return jnp.take_along_axis(ids, idx, axis=1), top


def search_ivf(index: IVFIndex, queries: np.ndarray, k: int = 10,
               probes: int = 8, exact_reduce: bool = True):
    """[Q, D] f32 queries → ([Q, k] item ids, [Q, k] scores).

    ``probes`` is the recall/traffic dial: candidates = probes × cap +
    spill; values above the cluster count clamp to it (probes == C is
    exhaustive — the int8-brute ranking). ``exact_reduce`` keeps the
    final small top-k exact (the candidate list is tiny; approx only
    pays on the full corpus).

    When the probed buckets + spill hold fewer than ``k`` real items,
    the tail of a row is the ``-1`` no-candidate sentinel (with -inf
    score) — callers must treat -1 as "no result", the repo-wide pad
    convention, not as item 0."""
    return _search(
        index.centroids, index.bucket_ids, index.bucket_q,
        index.bucket_scale, index.spill_ids, index.spill_q,
        index.spill_scale, queries, k=k,
        probes=min(probes, index.num_clusters), exact=exact_reduce,
    )

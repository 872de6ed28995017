"""Offline serving export — the Spark map-reduce replacement.

The reference serves PinSage by exporting every item's sampled neighbors +
projector features to JSON (``pinsage/inference/data_prepare.py:16-56``) and
re-implementing the Convolve forward as a PySpark job with numpy UDFs and
*random placeholder weights* (``pinsage/inference/inference.py:57-64``,
README: "not so efficient"). Replacement:

* ``export_serving_bundle`` — run the full-corpus **trained** model on device
  (``retrieval.eval.full_corpus_reprs``) and write a compact npz bundle:
  item reprs, the importance-neighbor tables used, and metadata. The JSON
  per-row format dies with Spark; anything downstream reads one npz.
* ``load_serving_bundle`` / ``serve_topk`` — load + answer top-k queries
  with the on-chip matmul/top_k path (usable under pjit across a slice for
  corpus sharding).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def export_serving_bundle(
    path: str,
    item_reprs: np.ndarray,
    neighbor_ids: np.ndarray | None = None,
    neighbor_weights: np.ndarray | None = None,
    metadata: dict | None = None,
    quantize: bool = False,
    ivf_clusters: int = 0,
    ivf_capacity_factor: float = 1.5,
):
    """``quantize=True`` stores the corpus int8 + per-row f32 scales
    (retrieval.quantize) instead of f32 reprs: ~4x smaller bundle and the
    int8 serving path in ``serve_topk`` (recall in tests/test_export.py).

    ``ivf_clusters > 0`` additionally packs an IVF index
    (retrieval.ivf: on-device k-means, padded capacity buckets + spill)
    into the bundle; ``serve_topk(..., probes=N)`` then serves through the
    clustered path — the small-Q latency lever at large corpora."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if quantize:
        from recommender_tpu.retrieval.quantize import quantize_reprs

        q, scale = quantize_reprs(item_reprs)
        arrays = {"item_reprs_int8": q, "item_scale": scale}
    else:
        arrays = {"item_reprs": np.asarray(item_reprs, np.float32)}
    if ivf_clusters > 0:
        import dataclasses

        from recommender_tpu.retrieval.ivf import build_ivf

        index = build_ivf(np.asarray(item_reprs, np.float32), ivf_clusters,
                          capacity_factor=ivf_capacity_factor)
        for f in dataclasses.fields(index):
            arrays[f"ivf_{f.name}"] = getattr(index, f.name)
    if neighbor_ids is not None:
        arrays["neighbor_ids"] = np.asarray(neighbor_ids, np.int32)
        arrays["neighbor_weights"] = np.asarray(neighbor_weights, np.float32)
    arrays["metadata_json"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8
    )
    np.savez_compressed(p, **arrays)


def load_serving_bundle(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    out = {k: data[k] for k in data.files if k != "metadata_json"}
    out["metadata"] = json.loads(bytes(data["metadata_json"]).decode() or "{}")
    return out


def serve_topk(bundle: dict, query_item_ids: np.ndarray, k: int = 10,
               exact: bool = False, recall_target: float = 0.95,
               probes: int = 0) -> np.ndarray:
    """Item-to-item retrieval from an exported bundle: [Q] ids → [Q, k] ids.

    Dispatches on the bundle contents: an int8 bundle (``quantize=True``
    export) scores through the int8 path without dequantizing. The
    serving default reduction is ``jax.lax.approx_max_k`` (a partial
    reduce XLA may fuse with the scoring matmul; backends without an
    approximate kernel compute it exactly); ``exact=True`` restores the
    full sort (bit-exact order).

    ``probes > 0`` (bundle exported with ``ivf_clusters``): serve through
    the IVF clustered path — scores only the probed buckets + spill
    instead of streaming the whole corpus; the small-Q latency lever
    (recall dial = probes)."""
    import jax
    import jax.numpy as jnp

    if probes > 0:
        if "ivf_centroids" not in bundle:
            raise ValueError(
                "probes > 0 needs an IVF bundle — export with "
                "export_serving_bundle(..., ivf_clusters=N)"
            )
        return _serve_ivf(bundle, np.asarray(query_item_ids), k, probes)
    if "item_reprs_int8" in bundle:
        from recommender_tpu.retrieval.quantize import topk_quantized

        return topk_quantized(
            bundle["item_reprs_int8"], bundle["item_scale"],
            np.asarray(query_item_ids), k=k, exact=exact,
            recall_target=recall_target,
        )
    # module-level jit: keeps compilation cached across the cli/serve
    # --all loop; convert the corpus once so looping callers stay resident
    return np.asarray(_topk_f32(
        jnp.asarray(bundle["item_reprs"]), jnp.asarray(query_item_ids),
        k=k, exact=exact, recall_target=recall_target,
    ))


def _serve_ivf(bundle: dict, ids: np.ndarray, k: int, probes: int) -> np.ndarray:
    """IVF serving path: query reprs looked up from the flat corpus
    (dequantized if int8), self excluded by over-fetch (same scatter-free
    pattern as every other exclusion here)."""
    import jax.numpy as jnp

    from recommender_tpu.retrieval.ivf import IVFIndex, search_ivf
    from recommender_tpu.retrieval.quantize import _drop_excluded

    index = IVFIndex(**{
        k_[4:]: bundle[k_] for k_ in (
            "ivf_centroids", "ivf_bucket_ids", "ivf_bucket_q",
            "ivf_bucket_scale", "ivf_spill_ids", "ivf_spill_q",
            "ivf_spill_scale",
        )
    })
    if "item_reprs" in bundle:
        q = jnp.asarray(bundle["item_reprs"])[jnp.asarray(ids)]
    else:
        rows = jnp.asarray(bundle["item_reprs_int8"])[jnp.asarray(ids)]
        q = rows.astype(jnp.float32) * jnp.asarray(
            bundle["item_scale"])[jnp.asarray(ids)][:, None]
    cand, _ = search_ivf(index, q, k=k + 1, probes=probes)
    return np.asarray(_drop_excluded(
        jnp.asarray(cand), jnp.asarray(ids)[:, None], k))


_TOPK_F32 = None  # built on first use (keeps `import export` jax-free)


def _topk_f32(reprs, ids, *, k, exact, recall_target):
    global _TOPK_F32
    if _TOPK_F32 is None:
        import functools

        import jax
        import jax.numpy as jnp

        from recommender_tpu.retrieval.quantize import _drop_excluded

        @functools.partial(
            jax.jit, static_argnames=("k", "exact", "recall_target")
        )
        def f(reprs, ids, *, k, exact, recall_target):
            q = reprs[ids]
            sim = jnp.matmul(q, reprs.T)
            # self-exclusion by candidate over-fetch, NOT a score scatter
            # (which would break the matmul→reduction fusion and
            # materialize [Q, V] — see quantize._drop_excluded); clamped
            # to the corpus so tiny corpora don't fail the reduction
            kk = min(k + 1, reprs.shape[0])
            if exact:
                _, idx = jax.lax.top_k(sim, kk)
            else:
                _, idx = jax.lax.approx_max_k(
                    sim, kk, recall_target=recall_target
                )
            return _drop_excluded(idx, ids[:, None], k)

        _TOPK_F32 = f
    return _TOPK_F32(reprs, ids, k=k, exact=exact, recall_target=recall_target)

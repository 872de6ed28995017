"""Offline item-to-item retrieval from an exported serving bundle.

The endpoint that replaces the reference's PySpark map-reduce
Convolve job (``pinsage/inference/inference.py``): the bundle already holds
trained on-chip reprs; serving is one matmul + top-k.

Usage:
  python -m recommender_tpu.cli.serve --bundle bundle.npz --items 3,17,42
  python -m recommender_tpu.cli.serve --bundle bundle.npz --all --out recs.npz
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.retrieval.export import load_serving_bundle, serve_topk


def main(argv=None):
    ap = argparse.ArgumentParser(description="serve top-k from a bundle")
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--items", type=str, default="",
                    help="comma-separated query item ids")
    ap.add_argument("--all", action="store_true", help="recommend for every item")
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--out", type=str, default="", help="npz output (with --all)")
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--exact", action="store_true",
                    help="bit-exact lax.top_k ordering instead of the "
                         "serving default approx_max_k")
    ap.add_argument("--recall_target", type=float, default=0.95,
                    help="approx_max_k per-call recall target (ignored "
                         "with --exact)")
    ap.add_argument("--probes", type=int, default=0,
                    help="IVF clustered serving: score only this many "
                         "probed buckets (+ spill) per query instead of "
                         "the full corpus — needs a bundle exported with "
                         "ivf_clusters (retrieval/ivf.py); the small-Q "
                         "latency lever at large corpora")
    args = ap.parse_args(argv)
    enable_compile_cache()  # before the first compile
    topk_kw = dict(exact=args.exact, recall_target=args.recall_target,
                   probes=args.probes)

    bundle = load_serving_bundle(args.bundle)
    n = len(bundle.get("item_reprs", bundle.get("item_reprs_int8", [])))
    # device-resident corpus: jnp.asarray once, so the --all loop's
    # serve_topk calls reuse the same buffers (re-converting numpy per
    # batch would re-transfer the corpus host-to-device every call)
    import jax.numpy as jnp

    # only the arrays the serving path reads: bundles also carry neighbor
    # tables that would pointlessly cross the (slow) host->device link
    for key, v in list(bundle.items()):
        if key in ("item_reprs", "item_reprs_int8", "item_scale") or \
                key.startswith("ivf_"):
            bundle[key] = jnp.asarray(v)
    if args.probes > 0 and "ivf_bucket_ids" in bundle:
        # the IVF candidate gather materializes [Q, probes, cap, D]; cap
        # the per-dispatch size so large Q × probes cannot run the device
        # out of memory
        cap, d = bundle["ivf_bucket_q"].shape[1], bundle["ivf_bucket_q"].shape[2]
        limit = (1536 << 20) // max(args.probes * cap * d, 1)
        if args.batch_size > limit:
            print(json.dumps({"batch_size_capped": limit,
                              "was": args.batch_size,
                              "reason": "ivf candidate gather > 1.5GB"}))
            args.batch_size = max(limit, 1)
    if args.all:
        recs = np.concatenate(
            [
                serve_topk(bundle, np.arange(s, min(s + args.batch_size, n)),
                           args.top_k, **topk_kw)
                for s in range(0, n, args.batch_size)
            ],
            axis=0,
        )
        if args.out:
            np.savez_compressed(args.out, recommendations=recs)
            print(json.dumps({"items": n, "top_k": args.top_k, "out": args.out}))
        else:
            print(json.dumps({"items": n, "top_k": args.top_k}))
        return recs
    ids = np.array([int(x) for x in args.items.split(",") if x != ""], np.int64)
    recs = serve_topk(bundle, ids, args.top_k, **topk_kw)
    for i, r in zip(ids.tolist(), recs.tolist()):
        print(json.dumps({"item": i, "recommendations": r}))
    return recs


if __name__ == "__main__":
    main()

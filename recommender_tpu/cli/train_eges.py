"""Graph item-embedding entry: BGE(DeepWalk) / GES / EGES
(``eges/train.py`` + ``eges/distribute_train.py`` parity).

Usage:
  python -m recommender_tpu.cli.train_eges --model_type EGES --synthetic
  python -m recommender_tpu.cli.train_eges --model_type EGES \
      --meta_file meta_Electronics.json
"""
from __future__ import annotations

import numpy as np

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.cli.common import (
    base_parser,
    build_mesh,
    build_trainer,
    host_batch_size,
    make_logger,
    setup_distributed,
)
from recommender_tpu.data import amazon_meta
from recommender_tpu.graph.store import WeightedGraph
from recommender_tpu.graph.walks import skipgram_batches
from recommender_tpu.models.eges import EGES, GES, DeepWalk
from recommender_tpu.models.tasks import init_model, link_prediction_auc, make_skipgram_task


def _synthetic_graph(num_nodes=2000, num_comm=16, seed=0):
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_comm, num_nodes)
    src, dst = [], []
    for v in range(1, num_nodes):
        pool = np.where(comm == comm[v])[0]
        for _ in range(10):
            u = int(rng.choice(pool)) if rng.random() < 0.9 else int(rng.integers(1, num_nodes))
            if u not in (0, v):
                src += [v, u]
                dst += [u, v]
    g = WeightedGraph.from_edges(src, dst, num_nodes=num_nodes)
    side = {
        "cat": (comm + 1).astype(np.int32),
        "brand": rng.integers(1, 50, num_nodes).astype(np.int32),
    }
    side["cat"][0] = 0
    return g, side, comm


def main(argv=None):
    p = base_parser("Graph item-embedding training (BGE/GES/EGES)")
    p.add_argument("--model_type", choices=["BGE", "GES", "EGES"], default="EGES")
    p.add_argument("--embedding_size", type=int, default=128)
    p.add_argument("--random_walk_length", type=int, default=10)
    p.add_argument("--window_size", type=int, default=5)
    p.add_argument("--num_negatives", type=int, default=5)
    p.add_argument("--meta_file", type=str, default="")
    p.add_argument("--export", type=str, default="",
                   help="write a serving bundle (npz) of trained item embeddings")
    p.add_argument("--export_int8", action="store_true",
                   help="quantize the exported corpus to int8 + per-row "
                        "scales (4x smaller bundle, int8 serving path)")
    p.add_argument("--shared_lr_scale", type=float, default=1.0,
                   help="GES/EGES: multiply the SHARED side tables' (cat, "
                        "brand) post-Adam updates by this factor. Their early "
                        "aligned gradients destabilize training (AUC collapses "
                        "mid-run and re-converges ~4x slower than BGE); 0.5 "
                        "both stabilizes and accelerates — measured 0.992 AUC "
                        "at 2k steps vs plain GES's collapse to 0.72 "
                        "(benchmarks/quality_runs.py; up-scaling, the "
                        "opposite, is strictly worse). 1.0 = reference "
                        "semantics (eges/model.py:58-102).")
    args = p.parse_args(argv)
    enable_compile_cache()  # before the first compile
    host_id, num_hosts = setup_distributed(args)  # before any device use
    if args.shared_lr_scale != 1.0 and args.model_type != "BGE":
        args.lr_scales = {
            "cat_embedding": args.shared_lr_scale,
            "brand_embedding": args.shared_lr_scale,
        }
    log = make_logger(args)

    mesh = build_mesh(args)
    use_side = args.model_type in ("GES", "EGES")

    if args.synthetic or not args.meta_file:
        g, side, _ = _synthetic_graph(seed=args.seed)
        cat_vocab_size = int(side["cat"].max()) + 1
        brand_vocab_size = int(side["brand"].max()) + 1
        triples = None
    else:
        with open(args.meta_file) as f:
            pairs, i2c, i2b = amazon_meta.load_metadata(f)
        train_pairs, test_pairs = amazon_meta.train_test_split(pairs, seed=args.seed)
        item2idx, cat_vocab, brand_vocab = amazon_meta.build_vocab(
            train_pairs, pairs, i2c, i2b
        )
        side = amazon_meta.side_info_arrays(item2idx, cat_vocab, brand_vocab, i2c, i2b)
        g = amazon_meta.build_train_graph(train_pairs, pairs, item2idx)
        cat_vocab_size, brand_vocab_size = len(cat_vocab), len(brand_vocab)
        rng = np.random.default_rng(args.seed)
        triples = amazon_meta.link_prediction_triples(
            test_pairs, item2idx, rng, side if use_side else None
        )

    if args.model_type == "BGE":
        model = DeepWalk(vocab_size=g.num_nodes, embed_dim=args.embedding_size)
    else:
        cls = GES if args.model_type == "GES" else EGES
        model = cls(
            vocab_size=g.num_nodes, cat_vocab=cat_vocab_size,
            brand_vocab=brand_vocab_size, embed_dim=args.embedding_size,
        )

    loss_fn, eval_fn = make_skipgram_task(model)
    # per-host input sharding for sampler-driven streams: every host runs
    # an iid walk sampler with a distinct seed at global_batch/num_hosts
    # rows per step (disjoint-by-construction random streams — the walk
    # analogue of shard_for_host's row striping)
    it = skipgram_batches(
        g, walk_length=args.random_walk_length, window=args.window_size,
        num_negatives=args.num_negatives,
        batch_size=host_batch_size(args.train_batch_size),
        walks_per_round=max(64, args.train_batch_size // 8),
        side_info=side if use_side else None, seed=args.seed + host_id,
    )
    trainer = build_trainer(args, loss_fn, eval_fn, mesh)
    example = next(it)
    state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)
    if triples is not None:
        auc = link_prediction_auc(model, state.params, triples)
        log({"final": 1, "link_prediction_auc": auc})
    if args.export:
        import jax.numpy as jnp

        from recommender_tpu.retrieval.export import export_serving_bundle

        # chunked corpus export: ONE jitted get_hidden over fixed-size id
        # blocks (padded tail), results assembled on host — an all-nodes
        # single apply would materialize [V, 3, D] side stacks (~15 GB at
        # a 10M vocab); this keeps peak device memory at one block
        import jax

        block = min(1 << 20, g.num_nodes)
        hidden_fn = jax.jit(
            lambda p, b: model.get_hidden(p, b)
        )
        chunks = []
        for s0 in range(0, g.num_nodes, block):
            n = min(block, g.num_nodes - s0)
            ids = np.arange(s0, s0 + n, dtype=np.int32)
            pad = block - n
            ids_p = np.pad(ids, (0, pad))  # pad with node 0 (row-0 bucket)
            b = {"target": jnp.asarray(ids_p)}
            if use_side:
                b["target_cat"] = jnp.asarray(side["cat"][ids_p])
                b["target_brand"] = jnp.asarray(side["brand"][ids_p])
            chunks.append(jax.device_get(hidden_fn(state.params, b))[:n])
        export_serving_bundle(
            args.export, np.concatenate(chunks, axis=0),
            metadata={"model": args.model_type, "embed_dim": args.embedding_size},
            quantize=args.export_int8,
        )
        log({"exported": args.export})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()

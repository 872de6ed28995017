"""PinSage entry: GNN retrieval on MovieLens (``pinsage/train/train.py``
parity — hyperparameters exposed as flags instead of hard-coded).

Usage:
  python -m recommender_tpu.cli.train_pinsage --synthetic
  python -m recommender_tpu.cli.train_pinsage --data_dir ml-1m/
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
from recommender_tpu.data.movielens import ground_truth_matrix, parse_movielens
from recommender_tpu.graph.bipartite import BipartiteGraph
from recommender_tpu.models.pinsage import ItemFeatures, PinSage
from recommender_tpu.models.pinsage_task import make_pinsage_task, pinsage_train_batches
from recommender_tpu.models.tasks import init_model
from recommender_tpu.retrieval.eval import full_corpus_reprs, hit_rate, recommend_topk


def _synthetic(seed=0):
    rng = np.random.default_rng(seed)
    num_users, num_items, num_comm = 400, 200, 8
    u_comm = rng.integers(0, num_comm, num_users)
    blocks = np.array_split(np.arange(num_items), num_comm)
    us, its = [], []
    for u in range(num_users):
        pool = blocks[u_comm[u]]
        for _ in range(12):
            it = int(rng.choice(pool)) if rng.random() < 0.9 else int(rng.integers(num_items))
            us.append(u)
            its.append(it)
    g = BipartiteGraph(us, its, num_users, num_items)
    feats = ItemFeatures(
        year=rng.integers(0, 10, num_items).astype(np.int32),
        genre=(rng.random((num_items, 8)) < 0.3).astype(np.float32),
    )
    latest = np.array([int(rng.choice(blocks[u_comm[u]])) for u in range(num_users)])
    test_item = np.array([int(rng.choice(blocks[u_comm[u]])) for u in range(num_users)])
    seen = np.zeros((num_users, num_items), bool)
    seen[np.asarray(us), np.asarray(its)] = True
    return g, feats, latest, test_item, seen


def main(argv=None):
    p = base_parser("PinSage training (MovieLens)")
    p.add_argument("--data_dir", type=str, default="", help="dir with ratings.dat/movies.dat")
    p.add_argument("--embedding_size", type=int, default=8)
    p.add_argument("--conv_hidden_size", type=int, default=64)
    p.add_argument("--conv_output_size", type=int, default=32)
    p.add_argument("--num_neighbors", type=int, default=3)
    p.add_argument("--num_random_walks", type=int, default=4)
    p.add_argument("--random_walk_length", type=int, default=2)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--export", type=str, default="",
                   help="write a serving bundle (npz) of trained item reprs")
    p.add_argument("--export_int8", action="store_true",
                   help="quantize the exported corpus to int8 + per-row "
                        "scales (4x smaller bundle, int8 serving path)")
    p.add_argument("--export_ivf_clusters", type=int, default=0,
                   help="also pack an IVF index (k-means buckets + spill) "
                        "into the bundle; cli/serve --probes N then serves "
                        "the clustered small-Q latency path")
    p.set_defaults(train_batch_size=32)
    args = p.parse_args(argv)
    enable_compile_cache()  # before the first compile
    host_id, num_hosts = setup_distributed(args)  # before any device use
    log = make_logger(args)

    mesh = build_mesh(args)
    if args.synthetic or not args.data_dir:
        g, feats, latest, test_item, seen = _synthetic(args.seed)
    else:
        with open(f"{args.data_dir}/ratings.dat", encoding="latin-1") as f:
            ratings = f.readlines()
        with open(f"{args.data_dir}/movies.dat", encoding="latin-1") as f:
            movies = f.readlines()
        data = parse_movielens(ratings, movies)
        g, feats = data.graph, data.features
        latest, test_item, seen = data.latest_train_item, data.test_user_item, data.train_seen

    model = PinSage(
        features=feats, embed_dim=args.embedding_size,
        conv_hidden=args.conv_hidden_size, conv_out=args.conv_output_size,
    )
    loss_fn = make_pinsage_task(model)
    sampler_kw = dict(
        num_neighbors=args.num_neighbors, num_walks=args.num_random_walks,
        walk_length=args.random_walk_length,
    )
    # per-host input: each host samples iid blocks with a distinct seed at
    # global_batch/num_hosts pairs per step (see train_eges)
    it = pinsage_train_batches(
        g, host_batch_size(args.train_batch_size),
        seed=args.seed + host_id, **sampler_kw,
    )
    trainer = build_trainer(args, loss_fn, None, mesh)
    example = next(it)
    state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)

    rng = np.random.default_rng(args.seed + 1)
    reprs = full_corpus_reprs(model, state.params, g, rng, **sampler_kw)
    recs = recommend_topk(reprs, latest, seen, k=args.top_k)
    gt = ground_truth_matrix(test_item, g.num_items)
    log({"final": 1, "hit_rate": hit_rate(recs, gt)})
    if args.export:
        from recommender_tpu.retrieval.export import export_serving_bundle

        nbr, w = g.importance_neighbors(
            np.arange(g.num_items), rng=rng,
            num_neighbors=args.num_neighbors, num_walks=args.num_random_walks,
            walk_length=args.random_walk_length,
        )
        export_serving_bundle(
            args.export, reprs, nbr, w,
            metadata={"model": "pinsage", "conv_out": args.conv_output_size},
            quantize=args.export_int8,
            ivf_clusters=args.export_ivf_clusters,
        )
        log({"exported": args.export})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()

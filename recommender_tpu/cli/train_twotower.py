"""Two-tower retrieval entry: dual encoders with in-batch softmax.

Beyond-reference trainer (``models/two_tower.py``): the standard
industrial retrieval baseline, sharing the MovieLens data path with
PinSage and the full serving stack (bundles / int8 / ``cli/serve``).

Usage:
  python -m recommender_tpu.cli.train_twotower --synthetic
  python -m recommender_tpu.cli.train_twotower --data_dir ml-1m/ \
      --export bundle.npz --export_int8
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
from recommender_tpu.models.tasks import init_model
from recommender_tpu.models.two_tower import (
    TwoTower,
    corpus_item_reprs,
    interaction_batches,
    make_two_tower_task,
)
from recommender_tpu.retrieval.eval import hit_rate, recommend_topk_from_queries


def _synthetic(seed=0, num_users=400, num_items=200, num_comm=8):
    """Community-structured interactions (same planted shape as the
    PinSage synthetic path: intra-community positives, held-out
    intra-community test item per user)."""
    from recommender_tpu.graph.bipartite import BipartiteGraph

    rng = np.random.default_rng(seed)
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
    test_item = np.array([int(rng.choice(blocks[u_comm[u]])) for u in range(num_users)])
    seen = np.zeros((num_users, num_items), bool)
    seen[np.asarray(us), np.asarray(its)] = True
    return g, test_item, seen


def main(argv=None):
    p = base_parser("Two-tower retrieval training")
    p.add_argument("--data_dir", type=str, default="",
                   help="dir with ratings.dat/movies.dat (MovieLens)")
    p.add_argument("--embedding_size", type=int, default=32)
    p.add_argument("--repr_size", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--export", type=str, default="",
                   help="write a serving bundle (npz) of item-tower reprs")
    p.add_argument("--export_int8", action="store_true")
    p.add_argument("--export_ivf_clusters", type=int, default=0)
    p.set_defaults(train_batch_size=1024)
    args = p.parse_args(argv)
    enable_compile_cache()  # before the first compile
    host_id, num_hosts = setup_distributed(args)
    log = make_logger(args)
    mesh = build_mesh(args)

    if args.synthetic or not args.data_dir:
        g, test_item, seen = _synthetic(args.seed)
    else:
        with open(f"{args.data_dir}/ratings.dat", encoding="latin-1") as f:
            ratings = f.readlines()
        with open(f"{args.data_dir}/movies.dat", encoding="latin-1") as f:
            movies = f.readlines()
        data = parse_movielens(ratings, movies)
        g, test_item, seen = data.graph, data.test_user_item, data.train_seen

    model = TwoTower(
        user_vocab=g.num_users, item_vocab=g.num_items,
        embed_dim=args.embedding_size, repr_dim=args.repr_size,
        temperature=args.temperature,
        partition="model" if args.mesh_model > 1 else None,
    )
    loss_fn, eval_fn = make_two_tower_task(model)
    # per-host input: iid pair stream with a distinct seed per host
    it = interaction_batches(
        g, host_batch_size(args.train_batch_size),
        seed=args.seed + 1000 * host_id,
    )
    trainer = build_trainer(args, loss_fn, eval_fn, mesh)
    example = next(it)
    state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)

    # full-corpus hit-rate: user-tower queries vs item-tower corpus,
    # train interactions excluded (the dual-encoder eval protocol)
    import jax

    reprs = corpus_item_reprs(model, state.params, g.num_items)
    uq = np.asarray(jax.jit(
        lambda p, u: model.user_repr(p, u)
    )(state.params, np.arange(g.num_users, dtype=np.int32)))
    recs = recommend_topk_from_queries(uq, reprs, seen, k=args.top_k)
    gt = ground_truth_matrix(test_item, g.num_items)
    log({"final": 1, "hit_rate": hit_rate(recs, gt)})
    if args.export:
        from recommender_tpu.retrieval.export import export_serving_bundle

        export_serving_bundle(
            args.export, reprs,
            metadata={"model": "two_tower", "repr_dim": args.repr_size},
            quantize=args.export_int8,
            ivf_clusters=args.export_ivf_clusters,
        )
        log({"exported": args.export})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()

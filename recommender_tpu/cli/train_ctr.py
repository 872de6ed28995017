"""CTR training entry: DLRM / DeepFM on Criteo (``ctr/train.py`` parity).

Usage:
  python -m recommender_tpu.cli.train_ctr --model_type DLRM --synthetic
  python -m recommender_tpu.cli.train_ctr --model_type DeepFM \
      --data_dir /path/to/criteo_shards --vocab /path/to/vocab.pkl
"""
from __future__ import annotations

import glob

import jax.numpy as jnp

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.cli.common import (
    base_parser,
    build_mesh,
    build_trainer,
    host_batch_size,
    host_local_data,
    make_logger,
    setup_distributed,
)
from recommender_tpu.data.criteo import load_shards, load_vocab, shard_batches
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.deepfm import DeepFM
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import init_model, make_ctr_task
from recommender_tpu.parallel.partitioning import model_shardings


def main(argv=None):
    p = base_parser("CTR training (DLRM/DeepFM/DCN)")
    p.add_argument("--model_type", choices=["DLRM", "DeepFM", "DCN"],
                   default="DLRM",
                   help="DCN = DCNv2 cross network (beyond-reference "
                        "third CTR interaction family, models/dcn.py)")
    p.add_argument("--vocab_size", type=int, default=1_000_000)
    p.add_argument("--embedding_size", type=int, default=16)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--vocab", type=str, default="")
    p.add_argument("--lr_schedule", choices=["none", "dlrm"], default="none",
                   help="'dlrm' = warmup+cosine (ctr/util.py:7-37)")
    p.add_argument("--warmup_steps", type=int, default=2000)
    p.add_argument("--decay_steps", type=int, default=40000)
    p.add_argument("--early_stop_patience", type=int, default=0,
                   help="stop after N evals without val-AUC improvement")
    p.add_argument("--lookup_mode", choices=["auto", "gspmd", "psum", "a2a"], default="auto",
                   help="sharded-table exchange (a2a needs --mesh_model > 1); "
                        "auto = planner-chosen by comm volume "
                        "(embedding.planner.plan_tables)")
    p.add_argument("--a2a_capacity_factor", type=float, default=0.0,
                   help="all-to-all bucket size vs fair share (= mesh_model is "
                        "lossless); 0 = measure the lossless factor on a real "
                        "batch (planner.capacity_factor_from_ids)")
    p.add_argument("--replicate_below_mb", type=float, default=32.0,
                   help="planner threshold: tables under this many MB stay "
                        "replicated (auto lookup mode only)")
    p.add_argument("--dedup_lookup", choices=["auto", "on", "off"], default="auto",
                   help="host-precomputed id-dedup plans for the embedding "
                        "backward (data/dedup.py). auto resolves to OFF (it "
                        "lost end to end on the hardware it was tuned on); "
                        "'on' keeps the path exercisable")
    p.add_argument("--prefetch_workers", type=int, default=1,
                   help="parallel host read/slice workers for the on-disk "
                        "shard stream (deterministic round-robin interleave "
                        "— resumable; data/pipeline.interleave_ordered). "
                        "Scale it with the host's cores")
    p.add_argument("--embed_dtype", choices=["f32", "bf16"], default="f32",
                   help="bf16 = store the table param in bfloat16: half the "
                        "table bytes, quality-neutral (stochastic rounding "
                        "auto-enables; see DLRM.embed_param_dtype)")
    args = p.parse_args(argv)
    enable_compile_cache()  # before the first compile
    host_id, num_hosts = setup_distributed(args)  # before any device use
    log = make_logger(args)
    if args.lr_schedule == "dlrm":
        from recommender_tpu.nn.schedules import dlrm_warmup_cosine

        args.learning_rate = dlrm_warmup_cosine(
            args.learning_rate, args.warmup_steps, args.decay_steps, 1e-4
        )

    mesh = build_mesh(args)

    # per-host input sharding (core/distributed.py): each process streams
    # its disjoint slice at global_batch/num_hosts rows per step; identity
    # when single-process
    train_bs = host_batch_size(args.train_batch_size)
    test_bs = host_batch_size(args.test_batch_size)
    # one predicate for every branch that depends on the stream kind
    # (--synthetic with a stray --data_dir previously disagreed between
    # the data branch and the prefetch gate)
    streamed = bool(args.data_dir) and not args.synthetic
    if not streamed:
        gen = SyntheticCTR(vocab_size=args.vocab_size, seed=args.seed)
        train_arrays = host_local_data(
            gen.sample(max(args.steps, 100) * args.train_batch_size // 4, seed=1)
        )
        test_arrays = host_local_data(gen.sample(20 * args.test_batch_size, seed=2))
        train_iter = batch_iterator(train_arrays, train_bs, seed=args.seed, epochs=None)
        eval_iter_fn = lambda: batch_iterator(test_arrays, test_bs, shuffle=False)
    else:
        vocab = load_vocab(args.vocab)
        if len(vocab) + 1 > args.vocab_size:
            # ids are 1..len(vocab) with 0 = OOV (data/criteo.py): a table
            # smaller than the real vocab would silently alias high ids
            log({"vocab_size_raised": len(vocab) + 1, "was": args.vocab_size})
            args.vocab_size = len(vocab) + 1
        shards = sorted(glob.glob(f"{args.data_dir}/train*/*.npz") or glob.glob(f"{args.data_dir}/shard_*.npz"))
        test_shards = sorted(glob.glob(f"{args.data_dir}/test*/*.npz"))
        if num_hosts > 1:
            # whole-shard striping: host p streams shards p::N
            shards = shards[host_id::num_hosts]
            if not shards:
                raise SystemExit(
                    f"host {host_id}: no train shards after {num_hosts}-way "
                    "striping — need at least one shard per host"
                )
        W = max(args.prefetch_workers, 1)

        def _worker_streams(global_start: int = 0):
            """W striped shard streams fast-forwarded so the round-robin
            merge resumes at global batch ``global_start``: worker w has
            already delivered the global indices j < start with j % W == w,
            and the rotation restarts at worker ``start % W``."""
            return [
                shard_batches(
                    shards[w::W], train_bs, seed=args.seed + w, epochs=None,
                    start_batch=(
                        (global_start - 1 - w) // W + 1 if global_start > w else 0
                    ),
                )
                for w in range(W)
            ]

        if W > 1:
            if len(shards) < W:
                raise SystemExit(
                    f"--prefetch_workers {W} needs at least {W} shards "
                    f"(found {len(shards)})"
                )
            from recommender_tpu.data.pipeline import interleave_ordered

            train_iter = interleave_ordered(_worker_streams(), size=2)
        else:
            train_iter = shard_batches(shards, train_bs, seed=args.seed, epochs=None)
        if args.checkpoint_dir:
            # the merged stream is a FUNCTION of (workers, seed, shard
            # count): resuming with different values would silently train
            # on an unrelated stream — pin them in a sidecar
            import json as _json
            import os as _os

            meta_path = _os.path.join(args.checkpoint_dir, "data_stream.json")
            meta = {"prefetch_workers": W, "seed": args.seed,
                    "num_shards": len(shards)}
            if args.resume and _os.path.exists(meta_path):
                with open(meta_path) as f:
                    old = _json.load(f)
                if old != meta:
                    raise SystemExit(
                        f"--resume data-stream config mismatch: checkpoint "
                        f"was written with {old}, current flags give {meta} "
                        "— the striped stream is a function of these; "
                        "resume with matching flags"
                    )
            else:
                _os.makedirs(args.checkpoint_dir, exist_ok=True)
                with open(meta_path, "w") as f:
                    _json.dump(meta, f)
        test_arrays = load_shards(test_shards) if test_shards else None
        if test_arrays is not None:
            test_arrays = host_local_data(test_arrays)
        eval_iter_fn = (
            (lambda: batch_iterator(test_arrays, test_bs, shuffle=False))
            if test_arrays is not None else None
        )

    example = next(train_iter)

    # ---- planner-driven table layout + exchange (closes the planner loop:
    # in 'auto' mode plan_tables decides partition AND lookup, and
    # capacity_factor_from_ids measures the lossless a2a bucket on a real
    # batch. Explicit --lookup_mode keeps the hand-set layout ('model' iff
    # --mesh_model > 1) so tiny-table test configs still exercise sharding.
    partition = "model" if args.mesh_model > 1 else None
    lookup_mode, cap = args.lookup_mode, args.a2a_capacity_factor
    if args.mesh_model > 1 and lookup_mode == "auto":
        from recommender_tpu.embedding.planner import (
            TableStats,
            capacity_factor_from_ids,
            plan_summary,
            plan_tables,
        )

        n_feat = example["cat_features"].shape[-1]
        [plan] = plan_tables(
            [TableStats("embedding", args.vocab_size, args.embedding_size,
                        lookups_per_example=n_feat)],
            num_model_shards=args.mesh_model,
            batch_per_device=args.train_batch_size // mesh.shape["data"],
            replicate_below_bytes=int(args.replicate_below_mb * (1 << 20)),
        )
        partition = plan.partition
        lookup_mode = {"all_to_all": "a2a", "psum": "psum"}.get(plan.lookup, "gspmd")
        if lookup_mode == "a2a" and cap <= 0:
            cap = capacity_factor_from_ids(
                example["cat_features"], args.mesh_model, args.vocab_size
            )
        log({"shard_plan": plan_summary([plan]),
             "lookup_mode": lookup_mode, "capacity_factor": round(cap, 3)})
    else:
        if lookup_mode == "auto":
            lookup_mode = "gspmd"
        if lookup_mode == "a2a" and cap <= 0:
            from recommender_tpu.embedding.planner import capacity_factor_from_ids

            cap = capacity_factor_from_ids(
                example["cat_features"], args.mesh_model, args.vocab_size
            )
    lookup_kw = dict(
        lookup_mode=lookup_mode, mesh=mesh if lookup_mode in ("a2a", "psum") else None,
        capacity_factor=cap if cap > 0 else 2.0,
        embed_param_dtype=jnp.bfloat16 if args.embed_dtype == "bf16" else jnp.float32,
    )
    if args.model_type == "DLRM":
        # the bottom MLP's output is the 27th embedding (ctr/model.py:51-52)
        # so its final width must track --embedding_size
        model = DLRM(vocab_size=args.vocab_size, embed_dim=args.embedding_size,
                     bottom_units=(512, 256, 64, args.embedding_size),
                     partition=partition, **lookup_kw)
    elif args.model_type == "DCN":
        from recommender_tpu.models.dcn import DCN

        model = DCN(vocab_size=args.vocab_size, embed_dim=args.embedding_size,
                    partition=partition, **lookup_kw)
    else:
        model = DeepFM(vocab_size=args.vocab_size, embed_dim=args.embedding_size,
                       partition=partition, **lookup_kw)

    loss_fn, eval_fn = make_ctr_task(model)
    # derive shardings from shapes only (no double param materialization)
    pshard = model_shardings(model, example, mesh, seed=args.seed)
    trainer = build_trainer(args, loss_fn, eval_fn, mesh, pshard)
    state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
        # resume the data stream where the restored step left off (+1 for
        # the example batch init consumed from the fresh stream) — BOTH
        # branches: the on-disk shard stream fast-forwards by header-read
        # arithmetic (shard_batches(start_batch=))
        if not streamed:
            train_iter = batch_iterator(
                train_arrays, train_bs, seed=args.seed,
                epochs=None, start_batch=int(state.step) + 1,
            )
        elif args.prefetch_workers > 1:
            from recommender_tpu.data.pipeline import interleave_ordered

            k = int(state.step) + 1
            train_iter = interleave_ordered(
                _worker_streams(k), size=2,
                start_worker=k % args.prefetch_workers,
            )
        else:
            train_iter = shard_batches(
                shards, train_bs, seed=args.seed,
                epochs=None, start_batch=int(state.step) + 1,
            )

    # Host dedup plans for the embedding backward (Zipf ids collapse ~6x;
    # scatter pays per row — ops/embedding_kernels.embedding_lookup_dedup).
    # Replicated-table, single-data-shard scope. Wrapped last so it also
    # covers the resumed stream.
    if args.dedup_lookup == "on":
        # 'on' still fails fast on configs where the plan-driven backward is
        # broken or self-defeating, instead of crashing at first grad /
        # silently corrupting training.
        if args.accum_steps > 1:
            raise SystemExit(
                "--dedup_lookup on is incompatible with --accum_steps > 1 "
                "(plans index the whole-batch id stream)"
            )
        if mesh.shape.get("data", 1) > 1:
            print(
                "WARNING: --dedup_lookup on with a data-sharded mesh turns the "
                "plan reorder into a cross-device gather; expect no win."
            )
        dedup_on = True
    else:
        # auto resolves to OFF: on the hardware it was tuned on, the
        # plan-driven backward lost end to end at the shape it was built
        # for (DLRM b8192, 1M x 16) — the segment-sum + small scatter did
        # not beat XLA's scatter fused into the cotangent producer, and the
        # perm gather adds a materialized reorder. Not yet re-measured on
        # the current GPU. Kept as an explicit 'on'.
        dedup_on = False
    if dedup_on:
        from recommender_tpu.data.pipeline import with_dedup_plans

        train_iter = with_dedup_plans(train_iter)

    state, _ = trainer.fit(
        state, train_iter, steps=args.steps,
        eval_iter_fn=eval_iter_fn, eval_batches=args.eval_batches,
        log_fn=log,
        # interleave_ordered already runs one prefetch thread per worker —
        # wrapping it again would just add a passthrough thread
        prefetch=0 if (streamed and args.prefetch_workers > 1) else 2,
    )
    if streamed and args.prefetch_workers > 1:
        # stop the interleave worker threads promptly. ONLY this case: the
        # interleave generator is consumed by fit's own thread (prefetch=0
        # above), so close() here is safe — a W=1 generator is still held
        # by fit's Prefetcher producer THREAD and closing it from here
        # races ("generator already executing")
        train_iter.close()
    if eval_iter_fn is not None:
        log({"final": 1, **trainer.evaluate(state, eval_iter_fn(), args.eval_batches, exact=True)})
    if args.checkpoint_dir:
        trainer.save(state)
    return trainer, state


if __name__ == "__main__":
    main()

"""Multi-task CTR/CVR entry: BASE / ESMM / MMOE (``esmm/train.py`` parity).

The joint ESMM/MMOE protocol trains on impressions and periodically reports
CVR AUC (clicked subset, purchase label) and CTCVR AUC (impressions,
purchase label). ``--model_type BASE`` runs the two-model protocol: a CTR
model on impressions and a CVR model on clicks, CTCVR = product.
"""
from __future__ import annotations

import jax
import numpy as np

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
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticMultiTask
from recommender_tpu.models.esmm import ESMM, MMOE, MultiTaskBase
from recommender_tpu.models.tasks import (
    evaluate_head,
    init_model,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
)
from recommender_tpu.data.aliccp import click_only


def _round_to(arrays, mult):
    n = (len(next(iter(arrays.values()))) // mult) * mult
    return {k: v[:n] for k, v in arrays.items()}


def main(argv=None):
    p = base_parser("Multi-task CTR/CVR training (BASE/ESMM/MMOE)")
    p.add_argument("--model_type", choices=["BASE", "ESMM", "MMOE"], default="ESMM")
    p.add_argument("--embedding_size", type=int, default=18)
    p.add_argument("--train_npz", type=str, default="", help="npz with features/click/purchase")
    p.add_argument("--test_npz", type=str, default="")
    p.add_argument("--replicate_below_mb", type=float, default=32.0,
                   help="planner threshold: tables under this many MB stay "
                        "replicated (embedding.planner.plan_tables)")
    args = p.parse_args(argv)
    enable_compile_cache()  # before the first compile
    host_id, num_hosts = setup_distributed(args)  # before any device use
    log = make_logger(args)

    mesh = build_mesh(args)
    ndata = mesh.shape["data"]

    if args.synthetic or not args.train_npz:
        gen = SyntheticMultiTask(seed=args.seed)
        train = gen.sample(100_000, seed=1)
        test = gen.sample(20_000, seed=2)
        sizes = list(gen.vocab_sizes)
    else:
        train = dict(np.load(args.train_npz))
        test = dict(np.load(args.test_npz))
        sizes = (train["features"].max(axis=0) + 1).tolist()
    # per-host input sharding (after vocab sizing, which must see the full
    # set); batch sizes below become per-host rows of the global batch
    train = host_local_data(train)
    test = host_local_data(test)
    global_train_bs = args.train_batch_size
    args.train_batch_size = host_batch_size(args.train_batch_size)
    args.test_batch_size = host_batch_size(args.test_batch_size)

    # Per-table layout from the sharding planner: replicate tiny tables,
    # row-shard large ones over the 'model' axis, and take the planner's
    # exchange (psum vs all_to_all) + skew-aware a2a capacity per table
    # (embedding/planner.py). `plan_kwargs` carries ALL of the plan into the
    # model (partition / lookup_modes / capacity_factors / mesh), not just
    # the layout; the a2a_overflow train metric verifies capacity live.
    plan_kwargs = {"partition": None}
    if args.mesh_model > 1:
        import dataclasses

        from recommender_tpu.embedding.planner import (
            TableStats,
            capacity_factor_from_ids,
            module_kwargs,
            plan_summary,
            plan_tables,
        )

        stats = [
            TableStats(
                f"feat_{j}", int(v), args.embedding_size, lookups_per_example=1,
                id_freq=np.bincount(train["features"][:, j], minlength=int(v)),
            )
            for j, v in enumerate(sizes)
        ]
        plans = plan_tables(
            stats, num_model_shards=args.mesh_model,
            batch_per_device=global_train_bs // ndata,
            replicate_below_bytes=int(args.replicate_below_mb * (1 << 20)),
        )
        # refine each a2a bucket to be lossless on the REAL id stream (the
        # frequency heuristic above is row-block mass; this measures the
        # actual per-shard lookup skew on a sample, with headroom)
        plans = [
            dataclasses.replace(
                pl,
                capacity_factor=max(
                    pl.capacity_factor,
                    capacity_factor_from_ids(
                        train["features"][:65536, j], args.mesh_model, int(sizes[j])
                    ),
                ),
            )
            if pl.lookup == "all_to_all"
            else pl
            for j, pl in enumerate(plans)
        ]
        log({"shard_plan": plan_summary(plans)})
        plan_kwargs = module_kwargs(plans, mesh)
    partition = plan_kwargs["partition"]

    if args.model_type == "BASE":
        # two-model protocol (esmm/train.py:14-91)
        results = {}
        models = {}
        for role, label in (("ctr", "click"), ("cvr", "purchase")):
            role_log = make_logger(args, prefix=f"{role}/")
            data = train if role == "ctr" else _round_to(click_only(train), ndata)
            arrays = dict(data)
            arrays["label"] = arrays[label]
            model = MultiTaskBase(vocab_sizes=sizes, embed_dim=args.embedding_size,
                                  **plan_kwargs)
            loss_fn, eval_fn = make_ctr_task(model)
            trainer = build_trainer(args, loss_fn, eval_fn, mesh)
            example = {k: v[: args.train_batch_size] for k, v in arrays.items()}
            state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
            it = batch_iterator(arrays, args.train_batch_size, seed=args.seed, epochs=None)
            state, _ = trainer.fit(state, it, steps=args.steps, log_fn=role_log)
            models[role] = (model, state, trainer)
        # CTCVR eval: product of both models on impressions
        (ctr_m, ctr_s, tr) = models["ctr"]
        (cvr_m, cvr_s, _) = models["cvr"]
        from recommender_tpu.core.metrics import StreamingAUC

        auc = StreamingAUC()
        for batch in batch_iterator(_round_to(test, ndata), args.test_batch_size, shuffle=False):
            b = tr.put_batch(batch)
            p_ctr = ctr_m.apply(ctr_s.params, {}, b)[0]
            p_cvr = cvr_m.apply(cvr_s.params, {}, b)[0]
            auc.update_state(batch["purchase"], jax.device_get(p_ctr * p_cvr))
        log({"final": 1, "ctcvr_auc": auc.result()})
        return models

    model_cls = ESMM if args.model_type == "ESMM" else MMOE
    model = model_cls(vocab_sizes=sizes, embed_dim=args.embedding_size,
                      **plan_kwargs)
    loss_fn, eval_fn = make_multitask_task(model)
    example = {k: v[: args.train_batch_size] for k, v in train.items()}
    pshard = None
    if partition is not None:
        from recommender_tpu.parallel.partitioning import model_shardings

        pshard = model_shardings(model, example, mesh, seed=args.seed)
    trainer = build_trainer(args, loss_fn, eval_fn, mesh, param_shardings=pshard)
    state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    # start_batch resumes the data stream where the restored step left off
    it = batch_iterator(train, args.train_batch_size, seed=args.seed, epochs=None,
                        start_batch=int(state.step))
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)

    clicks = _round_to(click_only(test), ndata)
    n_clicks = len(clicks["click"])
    cvr_bs = min(args.test_batch_size, n_clicks) if n_clicks else ndata
    cvr_bs = max((cvr_bs // ndata) * ndata, ndata)  # keep data-axis divisibility
    cvr_auc = evaluate_head(
        trainer, state, batch_iterator(clicks, cvr_bs, shuffle=False),
        make_head_eval(model, "cvr", "purchase"),
    )
    ctcvr_auc = evaluate_head(
        trainer, state, batch_iterator(_round_to(test, ndata), args.test_batch_size, shuffle=False),
        make_head_eval(model, "ctcvr", "purchase"),
    )
    log({"final": 1, "cvr_auc": cvr_auc, "ctcvr_auc": ctcvr_auc})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()

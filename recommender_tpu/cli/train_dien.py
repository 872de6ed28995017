"""Behavior-sequence CTR entry: BASE / DIN / DIEN (``dien/train.py`` +
``dien/distribute_train.py`` parity — one script, any mesh).

Usage:
  python -m recommender_tpu.cli.train_dien --model_type DIEN --synthetic
  python -m recommender_tpu.cli.train_dien --model_type DIEN \
      --train_file local_train_splitByUser --test_file local_test_splitByUser \
      --vocab_dir ./data
"""
from __future__ import annotations

import jax

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
from recommender_tpu.data import amazon
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticSequence
from recommender_tpu.models.bst import BST
from recommender_tpu.models.dien import DIEN, DIN, BaseModel
from recommender_tpu.models.tasks import init_model, make_aux_loss_task, make_ctr_task

# BST: beyond-reference transformer alternative to the recurrence
MODELS = {"BASE": BaseModel, "DIN": DIN, "DIEN": DIEN, "BST": BST}


def main(argv=None):
    p = base_parser("Behavior-sequence CTR training (BASE/DIN/DIEN)")
    p.add_argument("--model_type", choices=list(MODELS), default="DIEN")
    p.add_argument("--embedding_size", type=int, default=18)
    p.add_argument("--history_max_length", type=int, default=100)
    p.add_argument("--embed_dtype", choices=["f32", "bf16"], default="f32",
                   help="bf16 = store both tables in bfloat16: half the "
                        "table bytes, quality-neutral (stochastic rounding "
                        "auto-enables)")
    p.add_argument("--train_file", type=str, default="")
    p.add_argument("--test_file", type=str, default="")
    p.add_argument("--vocab_dir", type=str, default="")
    args = p.parse_args(argv)
    enable_compile_cache()  # before the first compile
    host_id, num_hosts = setup_distributed(args)  # before any device use
    log = make_logger(args)

    mesh = build_mesh(args)
    need_neg = args.model_type == "DIEN"

    train_bs = host_batch_size(args.train_batch_size)
    test_bs = host_batch_size(args.test_batch_size)
    if args.synthetic or not args.train_file:
        gen = SyntheticSequence(max_len=args.history_max_length, seed=args.seed)
        train_arrays = host_local_data(gen.sample(50_000, seed=1))
        test_arrays = host_local_data(gen.sample(10_000, seed=2))
        item_vocab_size, cat_vocab_size = gen.num_items, gen.num_cats
        train_iter = batch_iterator(train_arrays, train_bs, seed=args.seed, epochs=None)
        eval_iter_fn = lambda: batch_iterator(test_arrays, test_bs, shuffle=False)
    else:
        if args.vocab_dir:
            iv, cv, i2c = amazon.load_vocab(args.vocab_dir)
        else:
            iv, cv, i2c = amazon.build_vocab(args.train_file)
        i2c_arr = amazon.make_item2cat_array(iv, cv, i2c)
        train_arrays = host_local_data(
            amazon.encode_dataset(args.train_file, iv, cv, args.history_max_length)
        )
        test_arrays = host_local_data(
            amazon.encode_dataset(args.test_file, iv, cv, args.history_max_length)
        )
        if need_neg:
            import numpy as np

            rng = np.random.default_rng(args.seed)
            test_arrays = amazon.sample_negative_history(test_arrays, len(iv), i2c_arr, rng)
        item_vocab_size, cat_vocab_size = len(iv), len(cv)
        train_iter = amazon.dien_batches(
            train_arrays, train_bs, len(iv), i2c_arr,
            sample_negative=need_neg, seed=args.seed + host_id, epochs=None,
        )
        eval_iter_fn = lambda: batch_iterator(test_arrays, test_bs, shuffle=False)

    import jax.numpy as jnp

    model = MODELS[args.model_type](
        item_vocab=item_vocab_size,
        cat_vocab=cat_vocab_size,
        item_dim=args.embedding_size,
        cat_dim=args.embedding_size,
        embed_param_dtype=jnp.bfloat16 if args.embed_dtype == "bf16" else jnp.float32,
    )
    task = make_aux_loss_task if args.model_type == "DIEN" else make_ctr_task
    loss_fn, eval_fn = task(model)
    trainer = build_trainer(args, loss_fn, eval_fn, mesh)
    example = next(train_iter)
    state = trainer.init_state(lambda: init_model(model, example, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
        if args.synthetic or not args.train_file:
            # resume the data stream where the restored step left off (+1
            # for the example batch init consumed from the fresh stream)
            train_iter = batch_iterator(
                train_arrays, train_bs, seed=args.seed,
                epochs=None, start_batch=int(state.step) + 1,
            )
    state, _ = trainer.fit(
        state, train_iter, steps=args.steps,
        eval_iter_fn=eval_iter_fn, eval_batches=args.eval_batches, log_fn=log,
    )
    log({"final": 1, **trainer.evaluate(state, eval_iter_fn(), args.eval_batches, exact=True)})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()

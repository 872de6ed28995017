"""Offline batch prediction from a training checkpoint — the ranking-model
serving surface the reference lacks (its only inference path is PinSage's
Spark job; CTR/sequence/multi-task models are never served).

Usage:
  # score an npz of feature arrays with a trained DLRM checkpoint
  python -m recommender_tpu.cli.predict --family ctr --model_type DLRM \
      --checkpoint_dir ckpt/ --vocab_size 1000000 \
      --input features.npz --output scores.npz

  # smoke-run on the built-in synthetic features
  python -m recommender_tpu.cli.predict --family ctr --model_type DLRM \
      --checkpoint_dir ckpt/ --vocab_size 2000 --synthetic --output scores.npz

Model hyperparameter flags must match the training run (same contract as
``--resume``). Output npz: one array per model head ("score" for CTR
models; "ctr"/"cvr"/"ctcvr" for multi-task), row-aligned with the input.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.cli.common import log_jsonl
from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import CheckpointUnavailable, TrainConfig, Trainer
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.models.tasks import init_model
from recommender_tpu.retrieval.scoring import make_scorer, score_batches


def _build_model(args):
    if args.family == "ctr":
        from recommender_tpu.models.deepfm import DeepFM
        from recommender_tpu.models.dlrm import DLRM

        cls = DLRM if args.model_type == "DLRM" else DeepFM
        return cls(vocab_size=args.vocab_size, embed_dim=args.embedding_size)
    if args.family == "dien":
        from recommender_tpu.cli.train_dien import MODELS as DIEN_MODELS

        return DIEN_MODELS[args.model_type](
            item_vocab=args.item_vocab, cat_vocab=args.cat_vocab,
            item_dim=args.embedding_size, cat_dim=args.embedding_size,
        )
    if args.family == "esmm":
        from recommender_tpu.models.esmm import ESMM, MMOE

        cls = ESMM if args.model_type == "ESMM" else MMOE
        sizes = tuple([args.vocab_size] * args.num_features)
        return cls(vocab_sizes=sizes, embed_dim=args.embedding_size)
    raise ValueError(args.family)


def _synthetic_features(args):
    if args.family == "ctr":
        from recommender_tpu.data.synthetic import SyntheticCTR

        return SyntheticCTR(vocab_size=args.vocab_size, seed=1).sample(
            args.batch_size * 4, seed=2
        )
    if args.family == "dien":
        from recommender_tpu.data.synthetic import SyntheticSequence

        return SyntheticSequence(
            num_items=args.item_vocab, num_cats=args.cat_vocab, seed=1
        ).sample(args.batch_size * 4, seed=2)
    from recommender_tpu.data.synthetic import SyntheticMultiTask

    return SyntheticMultiTask(
        vocab_sizes=tuple([args.vocab_size] * args.num_features), seed=1
    ).sample(args.batch_size * 4, seed=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description="batch prediction from a checkpoint")
    ap.add_argument("--family", choices=["ctr", "dien", "esmm"], required=True)
    ap.add_argument("--model_type", type=str, default="DLRM")
    ap.add_argument("--checkpoint_dir", type=str, required=True)
    ap.add_argument("--input", type=str, default="",
                    help="npz of feature arrays (omit with --synthetic)")
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--vocab_size", type=int, default=1_000_000)
    ap.add_argument("--embedding_size", type=int, default=16)
    ap.add_argument("--item_vocab", type=int, default=400_000)
    ap.add_argument("--cat_vocab", type=int, default=1500)
    ap.add_argument("--num_features", type=int, default=18)
    args = ap.parse_args(argv)
    enable_compile_cache()  # before the first compile

    model = _build_model(args)
    arrays = (
        _synthetic_features(args)
        if args.synthetic
        else dict(np.load(args.input, allow_pickle=False))
    )
    n = len(next(iter(arrays.values())))

    # restore through the Trainer (same orbax layout the train CLIs wrote)
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    try:
        trainer = Trainer(
            lambda *a: None,  # no training: loss_fn never called
            TrainConfig(checkpoint_dir=args.checkpoint_dir),
            mesh=mesh,
        )
    except CheckpointUnavailable as e:
        raise SystemExit(f"--checkpoint_dir: {e}") from e
    example = {k: v[: min(args.batch_size, n)] for k, v in arrays.items()}
    state = trainer.init_state(lambda: init_model(model, example))
    restored = trainer.restore(state)
    if int(restored.step) == 0:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")

    scorer = make_scorer(model, restored.params, restored.model_state)
    t0 = time.perf_counter()
    scores = score_batches(
        scorer,
        batch_iterator(arrays, args.batch_size, shuffle=False,
                       drop_remainder=False),
        args.batch_size,
    )
    dt = time.perf_counter() - t0
    np.savez(args.output, **scores)
    log_jsonl({
        "predicted": n,
        "heads": sorted(scores),
        "step": int(restored.step),
        "examples_per_s": n / max(dt, 1e-9),
        "output": args.output,
    })


if __name__ == "__main__":
    main()

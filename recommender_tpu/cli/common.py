"""Shared CLI plumbing for all model families.

Replaces the per-script argparse duplication of the reference (SURVEY.md §1
L7: ``ctr/train.py:12-19``, ``dien/train.py:70-82`` vs
``dien/distribute_train.py:111-125``, etc.) with one flag set + one
mesh/trainer bootstrap. Every entry point runs the same code from 1 device
to a (data × model) mesh — there is no separate "distribute_train".
"""
from __future__ import annotations

import argparse
import json

import jax

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import CheckpointUnavailable, TrainConfig, Trainer


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--train_batch_size", type=int, default=1024)
    p.add_argument("--test_batch_size", type=int, default=4096)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--accum_steps", type=int, default=1,
                   help=">1 = gradient accumulation over that many "
                        "microbatches per optimizer step (memory lever)")
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--eval_batches", type=int, default=0, help="0 = full pass")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=0, help="0 = all devices")
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--checkpoint_dir", type=str, default="")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic dataset (no files needed)")
    p.add_argument("--tensorboard_dir", type=str, default="",
                   help="also write train/eval curves as TensorBoard event "
                        "files (reference: keras TensorBoard callback, "
                        "ctr/train.py:94)")
    # ---- multi-host launch surface (core/distributed.py): run the SAME
    # command on every host with its --process_id (or the JAX_* env vars /
    # --distributed auto-detection under a cluster scheduler JAX knows);
    # single-process with none set. Replaces the reference's single-host-only
    # MirroredStrategy launch (dien/distribute_train.py:132).
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of process 0 for jax.distributed "
                        "rendezvous (or JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="total processes in the multi-host job "
                        "(or JAX_NUM_PROCESSES)")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's id (or JAX_PROCESS_ID)")
    p.add_argument("--log_all_hosts", action="store_true",
                   help="multi-host: every process logs JSONL (tagged with "
                        "its process index) instead of process 0 only")
    p.add_argument("--distributed", action="store_true",
                   help="bare jax.distributed.initialize() — cluster "
                        "auto-detection (e.g. SLURM), no explicit coordinator")
    return p


def setup_distributed(args) -> tuple[int, int]:
    """Initialize the multi-host runtime from the CLI flags (no-op when
    unconfigured). Call FIRST in every entry point, before any jax call
    that touches devices. Returns (host_id, num_hosts)."""
    from recommender_tpu.core.distributed import initialize_from_flags

    return initialize_from_flags(
        getattr(args, "coordinator_address", ""),
        getattr(args, "num_processes", 0),
        getattr(args, "process_id", -1),
        auto=getattr(args, "distributed", False),
    )


def host_local_data(arrays: dict) -> dict:
    """This process's slice of a full data dict (disjoint, deterministic,
    union = whole set); identity when single-process."""
    from recommender_tpu.core.distributed import shard_arrays_for_process

    return shard_arrays_for_process(arrays)


def host_batch_size(global_batch: int) -> int:
    """Rows THIS process feeds per step (global/num_hosts);
    ``Trainer.put_batch`` reassembles the global batch."""
    from recommender_tpu.core.distributed import per_process_batch_size

    return per_process_batch_size(global_batch)


def build_mesh(args):
    n = len(jax.devices())
    if args.mesh_model < 1 or args.mesh_data < 0:
        raise SystemExit(
            f"--mesh_model ({args.mesh_model}) must be >= 1, "
            f"--mesh_data ({args.mesh_data}) >= 0"
        )
    data = args.mesh_data or (n // args.mesh_model)
    return make_mesh(MeshSpec(data=data, model=args.mesh_model))


def build_trainer(args, loss_fn, eval_fn=None, mesh=None, param_shardings=None) -> Trainer:
    """Trainer from the common flags. Exits with a clear message when
    ``--checkpoint_dir`` is set and orbax is not installed."""
    cfg = TrainConfig(
        learning_rate=args.learning_rate,
        log_every=args.log_every,
        eval_every=args.eval_every,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
        early_stop_patience=getattr(args, "early_stop_patience", 0),
        accum_steps=getattr(args, "accum_steps", 1),
        lr_scales=getattr(args, "lr_scales", None) or None,
    )
    try:
        return Trainer(loss_fn, cfg, mesh=mesh, param_shardings=param_shardings, eval_fn=eval_fn)
    except CheckpointUnavailable as e:
        raise SystemExit(f"--checkpoint_dir: {e}") from e


def log_jsonl(metrics: dict):
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()}), flush=True)


def make_logger(args, prefix: str = ""):
    """JSONL logger, plus TensorBoard scalar events when --tensorboard_dir
    is set. Metric dicts without a 'step' key (e.g. final evals) reuse the
    last step seen. ``prefix`` namespaces the run (TB tag prefix + a
    ``role`` field in the JSONL) — used when one CLI invocation trains
    several models (e.g. the ESMM Base two-model protocol), so their
    curves don't conflate under identical tags.

    Multi-host: only process 0 logs (metrics are psum'd on device, so
    every process would print IDENTICAL lines — and N processes appending
    to one TensorBoard event dir would interleave corruptly). Set
    ``--log_all_hosts`` to debug per-process behavior (JSONL only, each
    line tagged with its process index)."""
    import jax

    if jax.process_count() > 1 and jax.process_index() != 0:
        if getattr(args, "log_all_hosts", False):
            pid = {"process": jax.process_index()}
            return lambda metrics: log_jsonl({**pid, **metrics})
        return lambda metrics: None
    role = {"role": prefix.rstrip("/")} if prefix else {}

    if not getattr(args, "tensorboard_dir", ""):
        if not prefix:
            return log_jsonl
        return lambda metrics: log_jsonl({**role, **metrics})

    from recommender_tpu.core.tensorboard import SummaryWriter

    writer = SummaryWriter(args.tensorboard_dir)
    last_step = [0]

    def log(metrics: dict):
        log_jsonl({**role, **metrics})
        step = int(metrics.get("step", last_step[0]))
        last_step[0] = max(last_step[0], step)
        writer.scalars(metrics, step, prefix=prefix)
        writer.flush()

    return log

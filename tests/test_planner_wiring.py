"""The planner loop is CLOSED: plan_tables' lookup + capacity decisions are
consumed by the models, not just its partition column.

Covers: module_kwargs rendering, a planner-planned MMOE whose big table
row-shards with the planned a2a exchange on the (2,4) mesh (a2a_overflow
== 0 at the planner-chosen capacity on a skewed batch, > 0 undersized),
and the CLI planner paths end-to-end.
"""
import dataclasses

import jax
import numpy as np
import pytest

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.embedding.planner import (
    TablePlan,
    TableStats,
    capacity_factor_from_ids,
    module_kwargs,
    plan_tables,
)
from recommender_tpu.models.tasks import init_model, make_multitask_task
from recommender_tpu.parallel.partitioning import model_shardings


def test_module_kwargs_rendering():
    plans = [
        TablePlan("small", None, "local"),
        TablePlan("big_a2a", "model", "all_to_all", capacity_factor=3.0),
        TablePlan("big_psum", "model", "psum"),
    ]
    mesh = make_mesh(MeshSpec(2, 4))
    kw = module_kwargs(plans, mesh)
    assert kw["partition"] == (None, "model", "model")
    # planned psum renders as the explicit shard_map exchange (its backward
    # stays shard-local; the gspmd route's replicates — Embedding.lookup_mode)
    assert kw["lookup_modes"] == ("gspmd", "a2a", "psum")
    assert kw["capacity_factors"] == (2.0, 3.0, 2.0)
    assert kw["mesh"] is mesh
    # psum alone still needs the mesh attached
    kw2 = module_kwargs([plans[0], plans[2]], mesh)
    assert kw2["lookup_modes"] == ("gspmd", "psum")
    assert kw2["mesh"] is mesh
    # without a mesh, planned psum degrades to the gspmd route (a2a keeps
    # its name for the legacy meshless-render path; Embedding falls back)
    kw3 = module_kwargs([plans[0], plans[2]])
    assert kw3["lookup_modes"] == ("gspmd", "gspmd")
    assert kw3["mesh"] is None


def _skewed_batch(rng, n, sizes, hot_feature=0):
    # feature `hot_feature` is Zipf-hot in shard 0's row range; the rest
    # uniform — the shape the skew-aware capacity exists for
    feats = np.stack(
        [
            rng.zipf(1.5, n).clip(max=sizes[j] - 1).astype(np.int32)
            if j == hot_feature
            else rng.integers(0, sizes[j], n).astype(np.int32)
            for j in range(len(sizes))
        ],
        axis=1,
    )
    return {
        "features": feats,
        "click": (rng.random(n) < 0.5).astype(np.float32),
        "purchase": (rng.random(n) < 0.2).astype(np.float32),
    }


def test_planned_mmoe_runs_with_planned_exchange(devices8):
    from recommender_tpu.models.esmm import MMOE

    mesh = make_mesh(MeshSpec(2, 4))
    sizes = [512, 512, 64, 64]
    rng = np.random.default_rng(0)
    batch = _skewed_batch(rng, 64, sizes)

    stats = [
        TableStats(f"feat_{j}", v, 8, id_freq=np.bincount(batch["features"][:, j], minlength=v))
        for j, v in enumerate(sizes)
    ]
    # force the 512-row tables to shard at test scale (512*8*4 = 16 KB)
    plans = plan_tables(stats, num_model_shards=4, batch_per_device=32,
                        replicate_below_bytes=8 * 1024)
    assert [p.partition for p in plans] == ["model", "model", None, None]
    assert all(p.lookup == "all_to_all" for p in plans[:2])

    # refine capacity to be lossless on the observed (skewed) ids — the
    # exact flow the ESMM CLI runs
    plans = [
        dataclasses.replace(
            p, capacity_factor=max(
                p.capacity_factor,
                capacity_factor_from_ids(batch["features"][:, j], 4, sizes[j]),
            ),
        )
        if p.lookup == "all_to_all" else p
        for j, p in enumerate(plans)
    ]

    def run(kw):
        model = MMOE(vocab_sizes=sizes, embed_dim=8, num_experts=2,
                     expert_units=(8, 4), tower_units=(4, 1), **kw)
        loss_fn, _ = make_multitask_task(model)
        pshard = model_shardings(model, batch, mesh)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3), mesh=mesh,
                     param_shardings=pshard)
        state = tr.init_state(lambda: init_model(model, batch))
        state, metrics = tr._train_step(state, tr.put_batch(batch), jax.random.PRNGKey(0))
        # planned tables really are row-sharded
        emb = state.params["embedder"]["feat_0"]["embedding"]
        leaf = emb.value if hasattr(emb, "value") else emb
        assert leaf.sharding.spec[0] == "model"
        return {k: float(v) for k, v in metrics.items()}

    metrics = run(module_kwargs(plans, mesh))
    assert np.isfinite(metrics["loss"])
    # the a2a exchange was actually taken AND the planned capacity is
    # lossless on this skewed batch
    assert metrics.get("a2a_overflow", -1) == 0

    # sanity: an undersized bucket on the same batch DOES overflow — the
    # diagnostic is live, so ==0 above is informative
    tight = [
        dataclasses.replace(p, capacity_factor=1.0)
        if p.lookup == "all_to_all" else p
        for p in plans
    ]
    assert run(module_kwargs(tight, mesh)).get("a2a_overflow", 0) > 0


def test_cli_esmm_planner_path(capsys, devices8, tmp_path):
    """ESMM CLI with --mesh_model 4: the planner plans, the model consumes
    lookup_modes/capacity_factors (not just partition), training runs."""
    from recommender_tpu.cli import train_esmm

    rng = np.random.default_rng(0)
    sizes = [256] * 4  # divisible by the 4 model shards -> shardable
    train = _skewed_batch(rng, 512, sizes)
    test = _skewed_batch(rng, 256, sizes)
    # pin max id so sizes derive exactly (CLI uses features.max(0)+1)
    train["features"][0] = [s - 1 for s in sizes]
    test["features"][0] = [s - 1 for s in sizes]
    np.savez(tmp_path / "train.npz", **train)
    np.savez(tmp_path / "test.npz", **test)
    train_esmm.main([
        "--steps", "4", "--log_every", "2", "--eval_every", "0",
        "--model_type", "ESMM", "--embedding_size", "8",
        "--mesh_model", "4", "--replicate_below_mb", "0.001",
        "--train_npz", str(tmp_path / "train.npz"),
        "--test_npz", str(tmp_path / "test.npz"),
        "--train_batch_size", "64", "--test_batch_size", "128",
    ])
    out = capsys.readouterr().out
    assert "shard_plan" in out and "row-sharded" in out
    assert '"cvr_auc"' in out


def test_cli_ctr_auto_lookup_plans(capsys, devices8):
    """CTR CLI default (--lookup_mode auto) goes through the planner when
    model-sharded: plan logged, capacity measured from a real batch."""
    from recommender_tpu.cli import train_ctr

    train_ctr.main([
        "--synthetic", "--steps", "4", "--log_every", "2", "--eval_every", "0",
        "--model_type", "DLRM", "--vocab_size", "4096",
        "--mesh_model", "4", "--replicate_below_mb", "0.01",
        "--train_batch_size", "64", "--test_batch_size", "128",
        "--eval_batches", "1",
    ])
    out = capsys.readouterr().out
    assert '"shard_plan"' in out and '"capacity_factor"' in out
    assert '"final"' in out

"""Checkpoint/resume: genuine restore of params+opt-state+step (the resume
logic the reference never had — SURVEY.md §5)."""
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import init_model, make_ctr_task


def _setup(tmp_path, mesh):
    gen = SyntheticCTR(vocab_size=256, seed=0)
    train = gen.sample(2048, seed=1)
    model = DLRM(vocab_size=256, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(
        learning_rate=1e-3, log_every=1, checkpoint_dir=str(tmp_path / "ckpt")
    )
    trainer = Trainer(loss_fn, cfg, mesh=mesh, eval_fn=eval_fn)
    example = {k: v[:8] for k, v in train.items()}
    return trainer, model, example, train


def test_save_restore_roundtrip(tmp_path, devices8):
    mesh = make_mesh(MeshSpec(8, 1))
    trainer, model, example, train = _setup(tmp_path, mesh)
    state = trainer.init_state(lambda: init_model(model, example))
    it = batch_iterator(train, 256, seed=0, epochs=None)
    state, _ = trainer.fit(state, it, steps=7)
    assert int(state.step) == 7
    trainer.save(state)

    fresh = trainer.init_state(lambda: init_model(model, example, seed=99))
    restored = trainer.restore(fresh)
    assert int(restored.step) == 7
    # params and opt state match exactly
    import jax

    for a, b in zip(
        jax.tree_util.tree_leaves(state.params),
        jax.tree_util.tree_leaves(restored.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree_util.tree_leaves(state.opt_state),
        jax.tree_util.tree_leaves(restored.opt_state),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # training continues deterministically from the restored state
    it2a = batch_iterator(train, 256, seed=7, epochs=None)
    it2b = batch_iterator(train, 256, seed=7, epochs=None)
    s1, h1 = trainer.fit(state, it2a, steps=3)
    s2, h2 = trainer.fit(restored, it2b, steps=3)
    l1 = [h["loss"] for h in h1 if "loss" in h]
    l2 = [h["loss"] for h in h2 if "loss" in h]
    np.testing.assert_allclose(l1, l2, rtol=1e-6)


def test_save_restore_sharded_state(tmp_path, devices8):
    """Checkpoint round-trip with a row-sharded table on a (2,4) mesh."""
    import jax

    from recommender_tpu.parallel.partitioning import model_shardings

    mesh = make_mesh(MeshSpec(2, 4))
    gen = SyntheticCTR(vocab_size=256, seed=0)
    train = gen.sample(1024, seed=1)
    model = DLRM(vocab_size=256, embed_dim=8, bottom_units=(16, 8),
                 top_units=(16, 1), partition="model")
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=1e-3, log_every=1,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    example = {k: v[:8] for k, v in train.items()}
    pshard = model_shardings(model, example, mesh)
    trainer = Trainer(loss_fn, cfg, mesh=mesh, param_shardings=pshard, eval_fn=eval_fn)
    state = trainer.init_state(lambda: init_model(model, example))
    it = batch_iterator(train, 128, seed=0, epochs=None)
    state, _ = trainer.fit(state, it, steps=3)

    # the table is genuinely sharded (placed by its PartitionSpec)
    table = state.params["embedding"]["embedding"]
    spec = table.sharding.spec
    assert spec and spec[0] == "model"
    trainer.save(state)

    fresh = trainer.init_state(lambda: init_model(model, example, seed=9))
    restored = trainer.restore(fresh)
    assert int(restored.step) == 3
    rtable = restored.params["embedding"]["embedding"]
    np.testing.assert_array_equal(np.asarray(table), np.asarray(rtable))
    # restored table keeps its sharding
    rspec = rtable.sharding.spec
    assert rspec and rspec[0] == "model"


def test_restore_without_checkpoint_is_noop(tmp_path, devices8):
    mesh = make_mesh(MeshSpec(8, 1))
    trainer, model, example, _ = _setup(tmp_path / "empty", mesh)
    state = trainer.init_state(lambda: init_model(model, example))
    restored = trainer.restore(state)
    assert restored is state


def test_cli_interrupt_resume_matches_uninterrupted(tmp_path, capsys, devices8):
    """A run checkpointed at step 4 and resumed for 6 more steps reproduces
    the uninterrupted 10-step run exactly (same params ⇒ same final eval):
    the restore brings back params+opt state+step AND the data stream
    fast-forwards to the batch an uninterrupted run would see next."""
    import json

    from recommender_tpu.cli.train_ctr import main

    base = [
        "--synthetic", "--train_batch_size", "64", "--test_batch_size", "256",
        "--vocab_size", "512", "--embedding_size", "8", "--eval_every", "0",
        "--eval_batches", "2", "--log_every", "100", "--seed", "3",
    ]

    def final_eval(argv):
        main(argv)
        outs = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
        return [o for o in outs if o.get("final")][-1]

    a = final_eval(base + ["--steps", "10",
                           "--checkpoint_dir", str(tmp_path / "a")])

    ckpt = str(tmp_path / "b")
    final_eval(base + ["--steps", "4", "--checkpoint_dir", ckpt])
    b = final_eval(base + ["--steps", "6", "--checkpoint_dir", ckpt,
                           "--resume"])

    assert abs(a["eval_loss"] - b["eval_loss"]) < 1e-6
    assert abs(a["eval_auc"] - b["eval_auc"]) < 1e-6


def _sharded_trainer(tmp_path, mesh_spec, vocab=256):
    """DLRM with a row-sharded table on the given mesh, ckpt dir shared."""
    import jax

    from recommender_tpu.parallel.partitioning import model_shardings

    mesh = make_mesh(MeshSpec(*mesh_spec))
    gen = SyntheticCTR(vocab_size=vocab, seed=0)
    train = gen.sample(2048, seed=1)
    model = DLRM(vocab_size=vocab, embed_dim=8, bottom_units=(16, 8),
                 top_units=(16, 1), partition="model")
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=1e-3, log_every=1,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    example = {k: v[:8] for k, v in train.items()}
    pshard = model_shardings(model, example, mesh)
    tr = Trainer(loss_fn, cfg, mesh=mesh, param_shardings=pshard, eval_fn=eval_fn)
    return tr, model, example, train


def test_restore_across_meshes(tmp_path, devices8):
    """Cross-topology restore: save a row-sharded state on a
    (2,4) mesh, restore onto (1,8), (4,2) and the trivial (8,1) — orbax
    ``StandardRestore`` reshards onto the target state's shardings — and
    training continues matching the uninterrupted same-mesh run. Loss
    trajectories agree to float tolerance only (mesh shape changes the
    psum/reduction order), which is the documented contract; the restored
    ARRAYS are bit-equal."""
    import jax

    tr0, model, example, train = _sharded_trainer(tmp_path, (2, 4))
    state = tr0.init_state(lambda: init_model(model, example))
    state, _ = tr0.fit(state, batch_iterator(train, 256, seed=0, epochs=None),
                       steps=3, prefetch=0)
    tr0.save(state)
    table0 = np.asarray(state.params["embedding"]["embedding"])

    # uninterrupted baseline: 3 more steps on the original mesh
    it = batch_iterator(train, 256, seed=0, epochs=None, start_batch=3)
    base_state, base_hist = tr0.fit(state, it, steps=3, prefetch=0)
    base_losses = [h["loss"] for h in base_hist if "loss" in h]

    for spec, model_axis in (((1, 8), 8), ((4, 2), 2), ((8, 1), 1)):
        tr, model2, example2, _ = _sharded_trainer(tmp_path, spec)
        fresh = tr.init_state(lambda: init_model(model2, example2, seed=77))
        restored = tr.restore(fresh)
        assert int(restored.step) == 3
        rtable = restored.params["embedding"]["embedding"]
        np.testing.assert_array_equal(np.asarray(rtable), table0)
        # restored table lands row-sharded over the TARGET mesh
        assert rtable.sharding.mesh.shape["model"] == model_axis
        assert rtable.sharding.spec[0] == "model"

        it2 = batch_iterator(train, 256, seed=0, epochs=None, start_batch=3)
        _, hist = tr.fit(restored, it2, steps=3, prefetch=0)
        losses = [h["loss"] for h in hist if "loss" in h]
        np.testing.assert_allclose(losses, base_losses, rtol=1e-4, atol=1e-6)


def test_restore_incompatible_divisibility_raises(tmp_path, devices8):
    """vocab=252 shards over model=4 (63 rows) but NOT over model=8: the
    state build on the target mesh fails with a clear error instead of a
    silently GSPMD-padded wrong result."""
    import pytest

    tr0, model, example, train = _sharded_trainer(tmp_path, (2, 4), vocab=252)
    state = tr0.init_state(lambda: init_model(model, example))
    tr0.save(state)

    tr, model2, example2, _ = _sharded_trainer(tmp_path, (1, 8), vocab=252)
    with pytest.raises(ValueError, match="not[ \n]+divisible|divisible"):
        tr.init_state(lambda: init_model(model2, example2))


def test_bf16_sr_resume_matches_uninterrupted(tmp_path, devices8):
    """The stochastic-rounding path is resume-safe: SR keys derive from the
    step counter (and the adam_sr count rides the checkpoint), so
    save-at-5 + restore + 5 more steps is BIT-identical to 10 straight
    steps on a bf16 table."""
    import jax
    import jax.numpy as jnp

    mesh = make_mesh(MeshSpec(8, 1))
    gen = SyntheticCTR(vocab_size=256, seed=0)
    train = gen.sample(2048, seed=1)
    model = DLRM(vocab_size=256, embed_dim=8, bottom_units=(16, 8),
                 top_units=(16, 1), embed_param_dtype=jnp.bfloat16)
    loss_fn, eval_fn = make_ctr_task(model)
    example = {k: v[:8] for k, v in train.items()}

    def run(steps_a, steps_b, ckpt):
        cfg = TrainConfig(learning_rate=1e-3, log_every=10**9,
                          checkpoint_dir=str(tmp_path / ckpt))
        tr = Trainer(loss_fn, cfg, mesh=mesh, eval_fn=eval_fn)
        state = tr.init_state(lambda: init_model(model, example))
        assert tr._sr_apply  # bf16 leaf auto-enabled SR
        state, _ = tr.fit(state, batch_iterator(train, 256, seed=0, epochs=None),
                          steps=steps_a, prefetch=0)
        if steps_b:
            tr.save(state)
            tr2 = Trainer(cfg=cfg, loss_fn=loss_fn, mesh=mesh, eval_fn=eval_fn)
            fresh = tr2.init_state(lambda: init_model(model, example, seed=7))
            state = tr2.restore(fresh)
            assert int(state.step) == steps_a
            it = batch_iterator(train, 256, seed=0, epochs=None,
                                start_batch=int(state.step))
            state, _ = tr2.fit(state, it, steps=steps_b, prefetch=0)
        return state

    straight = run(10, 0, "a")
    resumed = run(5, 5, "b")
    for a, b in zip(jax.tree_util.tree_leaves(straight.params),
                    jax.tree_util.tree_leaves(resumed.params)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


import pytest


@pytest.mark.parametrize("workers", [1, 2])
def test_cli_interrupt_resume_on_disk_shards(tmp_path, capsys, devices8, workers):
    """interrupted == uninterrupted on the REAL-DATA path:
    the on-disk npz shard stream fast-forwards on --resume via
    shard_batches(start_batch=), so a run checkpointed at step 4 and
    resumed for 6 more reproduces the uninterrupted 10-step run's final
    eval exactly — previously only the in-memory synthetic branch held
    this guarantee. workers=2 additionally pins the multi-worker
    round-robin stream (interleave_ordered) to the same contract: the
    merged stream is deterministic and the resume arithmetic fast-forwards
    each worker + the rotation offset."""
    import json
    import pickle

    from recommender_tpu.cli.train_ctr import main

    gen = SyntheticCTR(vocab_size=128, seed=0)
    data_dir = tmp_path / "shards"
    data_dir.mkdir()
    rng_rows = [320, 256]  # uneven shards; b=64 → 5+4 batches/epoch
    for i, rows in enumerate(rng_rows):
        np.savez(data_dir / f"shard_{i:05d}.npz", **gen.sample(rows, seed=10 + i))
    (data_dir / "test0").mkdir()
    np.savez(data_dir / "test0" / "shard_00000.npz", **gen.sample(256, seed=99))
    vocab_path = tmp_path / "vocab.pkl"
    with open(vocab_path, "wb") as f:
        pickle.dump({f"v{i}": i + 1 for i in range(100)}, f)

    base = [
        "--data_dir", str(data_dir), "--vocab", str(vocab_path),
        "--train_batch_size", "64", "--test_batch_size", "256",
        "--vocab_size", "128", "--embedding_size", "8", "--eval_every", "0",
        "--eval_batches", "1", "--log_every", "100", "--seed", "3",
        "--prefetch_workers", str(workers),
    ]

    def final_eval(argv):
        main(argv)
        outs = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
        return [o for o in outs if o.get("final")][-1]

    a = final_eval(base + ["--steps", "10",
                           "--checkpoint_dir", str(tmp_path / "a")])
    ckpt = str(tmp_path / "b")
    final_eval(base + ["--steps", "4", "--checkpoint_dir", ckpt])
    b = final_eval(base + ["--steps", "6", "--checkpoint_dir", ckpt,
                           "--resume"])

    assert abs(a["eval_loss"] - b["eval_loss"]) < 1e-6
    assert abs(a["eval_auc"] - b["eval_auc"]) < 1e-6


def test_cli_resume_rejects_changed_stream_config(tmp_path, capsys, devices8):
    """--resume with a different --prefetch_workers (or seed) than the
    original run fails loudly: the striped multi-worker stream is a
    function of those values, so silently resuming on different striping
    would train on an unrelated stream."""
    import pickle

    from recommender_tpu.cli.train_ctr import main

    gen = SyntheticCTR(vocab_size=128, seed=0)
    data_dir = tmp_path / "shards"
    data_dir.mkdir()
    for i in range(2):
        np.savez(data_dir / f"shard_{i:05d}.npz", **gen.sample(256, seed=i))
    vocab_path = tmp_path / "vocab.pkl"
    with open(vocab_path, "wb") as f:
        pickle.dump({f"v{i}": i + 1 for i in range(50)}, f)
    ckpt = str(tmp_path / "ck")
    base = [
        "--data_dir", str(data_dir), "--vocab", str(vocab_path),
        "--train_batch_size", "64", "--vocab_size", "128",
        "--embedding_size", "8", "--eval_every", "0", "--log_every", "100",
        "--checkpoint_dir", ckpt,
    ]
    main(base + ["--steps", "2", "--seed", "3", "--prefetch_workers", "2"])
    capsys.readouterr()
    for bad in (["--seed", "3", "--prefetch_workers", "1"],
                ["--seed", "4", "--prefetch_workers", "2"]):
        with pytest.raises(SystemExit, match="stream config mismatch"):
            main(base + ["--steps", "2", "--resume"] + bad)
    # matching flags resume fine
    main(base + ["--steps", "2", "--seed", "3", "--prefetch_workers", "2",
                 "--resume"])

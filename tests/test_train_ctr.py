"""End-to-end: DLRM/DeepFM on synthetic Criteo reach an AUC floor, on an
8-device (data×model) mesh — the round-trip the reference only exercises
manually on GPUs."""
import numpy as np
import pytest

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.deepfm import DeepFM
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import init_model, make_ctr_task
from recommender_tpu.parallel.partitioning import model_shardings


def _run_ctr(model, mesh, steps=120, batch=256):
    gen = SyntheticCTR(vocab_size=5000, seed=0)
    train = gen.sample(20000, seed=1)
    test = gen.sample(4096, seed=2)
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=3e-3, eval_every=0, log_every=1000)

    example = {k: v[:8] for k, v in train.items()}
    pshard = model_shardings(model, example, mesh)
    trainer = Trainer(loss_fn, cfg, mesh=mesh, param_shardings=pshard, eval_fn=eval_fn)

    def init_fn():
        params, ms = init_model(model, example)
        return params, ms

    state = trainer.init_state(init_fn)
    it = batch_iterator(train, batch, seed=0, epochs=None)
    state, _ = trainer.fit(state, it, steps=steps)
    ev = trainer.evaluate(state, batch_iterator(test, 512, shuffle=False))
    return ev["eval_auc"]


@pytest.mark.parametrize("mesh_spec", [MeshSpec(8, 1), MeshSpec(4, 2)])
def test_dlrm_learns(devices8, mesh_spec):
    mesh = make_mesh(mesh_spec)
    model = DLRM(
        vocab_size=5000,
        embed_dim=8,
        bottom_units=(32, 8),
        top_units=(32, 1),
        partition="model" if mesh_spec.model > 1 else None,
    )
    auc = _run_ctr(model, mesh)
    assert auc > 0.65, auc


def test_deepfm_learns(devices8):
    mesh = make_mesh(MeshSpec(8, 1))
    model = DeepFM(vocab_size=5000, embed_dim=8, mlp_units=(64, 1))
    auc = _run_ctr(model, mesh)
    assert auc > 0.65, auc


def test_dlrm_sharded_matches_replicated(devices8):
    """Same seed ⇒ row-sharded and replicated tables give the same loss curve."""
    gen = SyntheticCTR(vocab_size=512, seed=0)
    train = gen.sample(2048, seed=1)
    results = []
    for spec, part in [(MeshSpec(8, 1), None), (MeshSpec(2, 4), "model")]:
        mesh = make_mesh(spec)
        model = DLRM(
            vocab_size=512, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1),
            partition=part,
        )
        loss_fn, eval_fn = make_ctr_task(model)
        example = {k: v[:8] for k, v in train.items()}
        pshard = model_shardings(model, example, mesh)
        trainer = Trainer(
            loss_fn, TrainConfig(learning_rate=1e-3, log_every=1),
            mesh=mesh, param_shardings=pshard, eval_fn=eval_fn,
        )
        state = trainer.init_state(lambda: init_model(model, example))
        it = batch_iterator(train, 256, seed=0, epochs=None)
        state, hist = trainer.fit(state, it, steps=5)
        results.append([h["loss"] for h in hist if "loss" in h])
    np.testing.assert_allclose(results[0], results[1], rtol=2e-3, atol=2e-3)


def test_cli_embed_dtype_bf16(capsys, devices8):
    """--embed_dtype bf16 trains end-to-end on the synthetic pipeline."""
    from recommender_tpu.cli.train_ctr import main

    main([
        "--synthetic", "--steps", "30", "--train_batch_size", "64",
        "--test_batch_size", "256", "--vocab_size", "512",
        "--embedding_size", "8", "--eval_every", "0", "--log_every", "10",
        "--embed_dtype", "bf16",
    ])
    out = capsys.readouterr().out
    assert '"final"' in out and "nan" not in out


def _write_tiny_shards(tmp_path, n_shards=2, rows=192, vocab_ids=100):
    import pickle

    import numpy as np

    from recommender_tpu.data.synthetic import SyntheticCTR

    gen = SyntheticCTR(vocab_size=vocab_ids, seed=0)
    data_dir = tmp_path / "shards"
    data_dir.mkdir()
    for i in range(n_shards):
        np.savez(data_dir / f"shard_{i:05d}.npz", **gen.sample(rows, seed=i))
    vocab_path = tmp_path / "vocab.pkl"
    with open(vocab_path, "wb") as f:
        pickle.dump({f"v{i}": i + 1 for i in range(vocab_ids - 1)}, f)
    return data_dir, vocab_path


def test_cli_prefetch_workers_needs_enough_shards(tmp_path, devices8):
    """--prefetch_workers W with fewer than W shards fails fast with a
    clear message instead of spawning starved workers."""
    import pytest

    from recommender_tpu.cli.train_ctr import main

    data_dir, vocab_path = _write_tiny_shards(tmp_path, n_shards=1)
    with pytest.raises(SystemExit, match="prefetch_workers"):
        main([
            "--data_dir", str(data_dir), "--vocab", str(vocab_path),
            "--steps", "2", "--train_batch_size", "64",
            "--vocab_size", "128", "--embedding_size", "8",
            "--eval_every", "0", "--log_every", "10",
            "--prefetch_workers", "4",
        ])


def test_cli_vocab_size_auto_raised(tmp_path, capsys, devices8):
    """A loaded vocab larger than --vocab_size raises the table size
    (ids are 1..len(vocab); a smaller table would alias high ids) and
    logs the adjustment."""
    from recommender_tpu.cli.train_ctr import main

    data_dir, vocab_path = _write_tiny_shards(tmp_path, vocab_ids=100)
    main([
        "--data_dir", str(data_dir), "--vocab", str(vocab_path),
        "--steps", "3", "--train_batch_size", "64",
        "--vocab_size", "16",  # deliberately smaller than the 99-entry vocab
        "--embedding_size", "8", "--eval_every", "0", "--log_every", "10",
    ])
    out = capsys.readouterr().out
    assert '"vocab_size_raised": 100' in out

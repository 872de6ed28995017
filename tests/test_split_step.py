"""The split grads|optimizer step (TrainConfig.split_step, the narrow-table
layout-trap workaround — docs/DESIGN.md) is mathematically identical to the
fused single-jit step, and the auto heuristic picks it only for big narrow
embedding tables."""
import jax
import numpy as np

from recommender_tpu.core.train import TrainConfig, Trainer, _has_big_narrow_table
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import init_model, make_ctr_task


def _losses(split, steps=4):
    gen = SyntheticCTR(vocab_size=128, seed=0)
    train = gen.sample(256, seed=1)
    model = DLRM(vocab_size=128, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(
        loss_fn,
        TrainConfig(learning_rate=1e-2, log_every=1, split_step=split),
        eval_fn=eval_fn,
    )
    example = {k: v[:8] for k, v in train.items()}
    state = trainer.init_state(lambda: init_model(model, example))
    it = batch_iterator(train, 64, seed=3, epochs=None)
    state, hist = trainer.fit(state, it, steps=steps, prefetch=0)
    return [h["loss"] for h in hist if "loss" in h]


def test_split_matches_fused():
    np.testing.assert_allclose(_losses(False), _losses(True), rtol=1e-5, atol=1e-6)


def test_auto_heuristic():
    big = {"emb": jax.numpy.zeros((1_000_000, 16))}
    small = {"emb": jax.numpy.zeros((100_000, 16)), "w": jax.numpy.zeros((745, 512))}
    wide = {"emb": jax.numpy.zeros((1_000_000, 64))}
    assert _has_big_narrow_table(big)
    assert not _has_big_narrow_table(small)
    assert not _has_big_narrow_table(wide)


def test_auto_gate_requires_id_volume():
    """A big narrow table alone doesn't split — the step must also scatter
    enough ids to beat the second-dispatch cost (MMOE b512 stays fused)."""
    from recommender_tpu.core.train import _batch_id_volume, _SPLIT_MIN_IDS

    small_batch = {
        "features": np.zeros((512, 18), np.int32),
        "click": np.zeros((512,), np.float32),
    }
    big_batch = {
        "cat_features": np.zeros((8192, 26), np.int32),
        "label": np.zeros((8192,), np.float32),
    }
    assert _batch_id_volume(small_batch) == 512 * 18 < _SPLIT_MIN_IDS
    assert _batch_id_volume(big_batch) == 8192 * 26 >= _SPLIT_MIN_IDS


def test_auto_split_is_per_batch_shape():
    """A small warm-up batch must not latch the split decision: the auto
    gate re-evaluates per batch structure."""
    import jax
    import jax.numpy as jnp

    from recommender_tpu.core.train import TrainConfig, Trainer

    table = jnp.zeros((1_000_000, 16), jnp.float32)  # big narrow

    def loss_fn(params, ms, batch, rng, train):
        e = jnp.take(params["t"], batch["ids"].reshape(-1), axis=0)
        per_ex = jnp.sum(e, axis=-1)
        return per_ex, {}, ms

    tr = Trainer(loss_fn, TrainConfig(learning_rate=0.0))
    state = tr.init_state(lambda: ({"t": table}, {}))
    rng = jax.random.PRNGKey(0)
    small = {"ids": jnp.zeros((8, 26), jnp.int32)}
    big = {"ids": jnp.zeros((8192, 26), jnp.int32)}
    state, _ = tr._train_step(state, small, rng)  # donated: chain the state
    assert tr._split_by_shape[next(iter(tr._split_by_shape))] is False
    state, _ = tr._train_step(state, big, rng)
    assert True in tr._split_by_shape.values() and False in tr._split_by_shape.values()


def test_grad_accumulation_matches_single_step():
    """accum_steps=A: identical params after one optimizer update as A=1 on
    the same batch (deterministic loss, equal microbatches)."""
    import jax
    import jax.numpy as jnp

    from recommender_tpu.core.train import TrainConfig, Trainer

    def loss_fn(params, ms, batch, rng, train):
        pred = batch["x"] @ params["w"]
        per_ex = (pred - batch["y"]) ** 2
        return per_ex, {}, ms

    rngn = np.random.default_rng(0)
    batch = {
        "x": jnp.asarray(rngn.normal(size=(32, 4)), jnp.float32),
        "y": jnp.asarray(rngn.normal(size=(32,)), jnp.float32),
    }
    w0 = rngn.normal(size=(4,)).astype(np.float32)  # numpy: survives donation
    outs = {}
    for a in (1, 4):
        tr = Trainer(loss_fn, TrainConfig(learning_rate=0.1, optimizer="sgd",
                                          accum_steps=a, split_step=False))
        state = tr.init_state(lambda: ({"w": jnp.asarray(w0)}, {}))
        b = tr.put_batch(batch)
        state, m = tr._train_step(state, b, jax.random.PRNGKey(0))
        outs[a] = (np.asarray(state.params["w"]), float(m["loss"]))
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=1e-5, atol=1e-6)
    assert abs(outs[1][1] - outs[4][1]) < 1e-5


def test_grad_accumulation_on_mesh(devices8):
    """accum_steps works under GSPMD: microbatch scan over a data-sharded
    batch on the 8-device mesh, loss finite and params move."""
    import jax
    import jax.numpy as jnp

    from recommender_tpu.core.mesh import MeshSpec, make_mesh
    from recommender_tpu.core.train import TrainConfig, Trainer
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.models.tasks import init_model, make_ctr_task

    gen = SyntheticCTR(vocab_size=128, seed=0)
    host = gen.sample(64, seed=1)
    model = DLRM(vocab_size=128, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=0.05, accum_steps=4),
                 mesh=make_mesh(MeshSpec(8, 1)), eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, host))
    t0 = np.asarray(state.params["embedding"]["embedding"]).copy()
    state, m = tr._train_step(state, tr.put_batch(host), jax.random.PRNGKey(0))
    assert np.isfinite(float(m["loss"]))
    assert not np.allclose(t0, np.asarray(state.params["embedding"]["embedding"]))


def test_grad_accumulation_rejects_dedup_plans():
    """Dedup plans index the whole-batch id stream; slicing them into
    microbatches silently corrupts the table gradient — the engine must fail loudly instead."""
    import jax
    import jax.numpy as jnp
    import pytest

    from recommender_tpu.core.train import TrainConfig, Trainer

    def loss_fn(params, ms, batch, rng, train):
        pred = batch["x"] @ params["w"]
        return (pred - batch["y"]) ** 2, {}, ms

    batch = {
        "x": jnp.ones((8, 4), jnp.float32),
        "y": jnp.zeros((8,), jnp.float32),
        "cat_dedup": {
            "perm": jnp.arange(8, dtype=jnp.int32),
            "slot": jnp.arange(8, dtype=jnp.int32),
            "uniq": jnp.arange(8, dtype=jnp.int32),
        },
    }
    tr = Trainer(loss_fn, TrainConfig(learning_rate=0.1, optimizer="sgd",
                                      accum_steps=2, split_step=False))
    state = tr.init_state(lambda: ({"w": jnp.zeros((4,), jnp.float32)}, {}))
    with pytest.raises(ValueError, match="dedup plan.*accum_steps"):
        tr._train_step(state, tr.put_batch(batch), jax.random.PRNGKey(0))

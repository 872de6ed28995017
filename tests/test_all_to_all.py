"""All-to-all sharded embedding exchange: parity + gradients on the 8-dev mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.embedding.sharded import (
    all_to_all_lookup,
    shard_table,
    sharded_lookup,
)


def _table(v=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(v, d)).astype(np.float32)


@pytest.mark.parametrize("mesh_spec", [MeshSpec(1, 8), MeshSpec(2, 4)])
def test_all_to_all_matches_take(devices8, mesh_spec):
    mesh = make_mesh(mesh_spec)
    t = _table(v=64, d=8)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, size=(4, 6)).astype(np.int32)
    tbl = shard_table(jnp.asarray(t), mesh)
    out = jax.jit(
        lambda tb, i: all_to_all_lookup(tb, i, mesh, capacity_factor=8.0)
    )(tbl, jnp.asarray(ids))
    np.testing.assert_allclose(np.asarray(out), t[ids], rtol=1e-6)


def test_all_to_all_grad_matches_psum_path(devices8):
    mesh = make_mesh(MeshSpec(1, 8))
    t = _table(v=40, d=4)
    ids = np.array([3, 3, 39, 0, 8, 21], np.int32)
    w = jnp.asarray(np.arange(1.0, 7.0)[:, None])

    def loss_a2a(tb):
        return jnp.sum(
            all_to_all_lookup(tb, jnp.asarray(ids), mesh, capacity_factor=8.0) * w
        )

    def loss_psum(tb):
        return jnp.sum(sharded_lookup(tb, jnp.asarray(ids), mesh) * w)

    tbl = shard_table(jnp.asarray(t), mesh)
    g1 = np.asarray(jax.jit(jax.grad(loss_a2a))(tbl))
    g2 = np.asarray(jax.jit(jax.grad(loss_psum))(tbl))
    np.testing.assert_allclose(g1, g2, rtol=1e-6)


def test_all_to_all_skewed_ids_within_capacity(devices8):
    """All ids owned by one shard — capacity_factor must absorb the skew."""
    mesh = make_mesh(MeshSpec(1, 8))
    t = _table(v=64, d=8)
    ids = np.full((6,), 2, np.int32)  # all rows on shard 0
    tbl = shard_table(jnp.asarray(t), mesh)
    out = jax.jit(
        lambda tb, i: all_to_all_lookup(tb, i, mesh, capacity_factor=8.0)
    )(tbl, jnp.asarray(ids))
    np.testing.assert_allclose(np.asarray(out), t[ids], rtol=1e-6)


def test_all_to_all_data_sharded_grads(devices8):
    """(2×4) mesh, ids batch-sharded over data: forward matches take and the
    table cotangent is correctly psum'd over the data axis."""
    mesh = make_mesh(MeshSpec(2, 4))
    t = _table(v=64, d=8)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, size=(8, 3)).astype(np.int32)  # 8 % 2 == 0
    w = jnp.asarray(rng.normal(size=(8, 3, 8)).astype(np.float32))

    def loss_a2a(tb):
        return jnp.sum(all_to_all_lookup(tb, jnp.asarray(ids), mesh, 8.0) * w)

    def loss_ref(tb):
        return jnp.sum(jnp.take(tb, jnp.asarray(ids), axis=0) * w)

    tbl = shard_table(jnp.asarray(t), mesh)
    out = jax.jit(lambda tb: all_to_all_lookup(tb, jnp.asarray(ids), mesh, 8.0))(tbl)
    np.testing.assert_allclose(np.asarray(out), t[ids], rtol=1e-6)
    g1 = np.asarray(jax.jit(jax.grad(loss_a2a))(tbl))
    g2 = np.asarray(jax.grad(loss_ref)(jnp.asarray(t)))
    np.testing.assert_allclose(g1, g2, rtol=1e-5, atol=1e-6)


def test_overflow_counter_and_planner_capacity(devices8):
    """A skewed batch reports nonzero ``a2a_overflow`` in the train metrics;
    the planner's measured-skew capacity drives it to zero on the same batch."""
    from recommender_tpu.core.train import TrainConfig, Trainer
    from recommender_tpu.embedding.planner import capacity_factor_from_ids
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.models.tasks import init_model, make_ctr_task
    from recommender_tpu.parallel.partitioning import model_shardings

    mesh = make_mesh(MeshSpec(2, 4))
    V, m = 64, 4
    rng = np.random.default_rng(0)
    batch = {
        "int_features": rng.normal(size=(16, 13)).astype(np.float32),
        # every id owned by shard 0 -> worst-case skew
        "cat_features": rng.integers(0, V // m, size=(16, 26)).astype(np.int32),
        "label": (rng.random(16) < 0.5).astype(np.float32),
    }

    def run(capacity_factor):
        model = DLRM(
            vocab_size=V, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1),
            partition="model", lookup_mode="a2a", mesh=mesh,
            capacity_factor=capacity_factor,
        )
        loss_fn, eval_fn = make_ctr_task(model)
        pshard = model_shardings(model, batch, mesh)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=0.01, split_step=False),
                     mesh=mesh, param_shardings=pshard, eval_fn=eval_fn)
        state = tr.init_state(lambda: init_model(model, batch))
        _, metrics = tr._train_step(state, tr.put_batch(batch), jax.random.PRNGKey(0))
        return int(metrics["a2a_overflow"])

    assert run(1.0) > 0  # fair-share capacity drops ids under this skew

    cap = capacity_factor_from_ids(batch["cat_features"], m, V)
    assert cap == float(m)  # max skew -> lossless bound
    assert run(cap) == 0


def test_all_to_all_bf16_table(devices8):
    """The a2a exchange routes bf16 vectors correctly (the bench.py config
    combined with explicit a2a): forward matches take, and a full bf16+SR
    DLRM train step over the a2a route runs finite on the (2,4) mesh."""
    mesh = make_mesh(MeshSpec(2, 4))
    t = _table(v=64, d=8).astype(jnp.bfloat16)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, size=(4, 6)).astype(np.int32)
    tbl = shard_table(jnp.asarray(t), mesh)
    out = jax.jit(
        lambda tb, i: all_to_all_lookup(tb, i, mesh, capacity_factor=4.0)
    )(tbl, jnp.asarray(ids))
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(t, np.float32)[ids], rtol=1e-2
    )

    from recommender_tpu.core.train import TrainConfig, Trainer
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.models.tasks import init_model, make_ctr_task
    from recommender_tpu.parallel.partitioning import model_shardings

    gen = SyntheticCTR(vocab_size=128, seed=0)
    batch = gen.sample(32, seed=1)
    model = DLRM(vocab_size=128, embed_dim=8, bottom_units=(16, 8),
                 top_units=(16, 1), partition="model", lookup_mode="a2a",
                 mesh=mesh, capacity_factor=4.0,
                 embed_param_dtype=jnp.bfloat16)
    loss_fn, _ = make_ctr_task(model)
    pshard = model_shardings(model, batch, mesh)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-2), mesh=mesh,
                 param_shardings=pshard)
    state = tr.init_state(lambda: init_model(model, batch))
    assert tr._sr_apply
    state, metrics = tr._train_step(state, tr.put_batch(batch), jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics.get("a2a_overflow", 0)) == 0

"""Sharded-embedding subsystem: lookup parity and gradient correctness."""
import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.embedding.sharded import (
    shard_table,
    sharded_lookup,
    sort_coalesced_lookup,
)


def _table(v=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(v, d)).astype(np.float32)


def test_sharded_lookup_matches_take(devices8):
    mesh = make_mesh(MeshSpec(data=2, model=4))
    t = _table()
    ids = np.array([[0, 5, 63], [17, 17, 32]], np.int32)
    tbl = shard_table(jnp.asarray(t), mesh)
    out = jax.jit(lambda tb, i: sharded_lookup(tb, i, mesh))(tbl, jnp.asarray(ids))
    np.testing.assert_allclose(np.asarray(out), t[ids], rtol=1e-6)


def test_sharded_lookup_grad_is_scatter_add(devices8):
    mesh = make_mesh(MeshSpec(data=1, model=8))
    t = _table(v=40, d=4)
    ids = np.array([3, 3, 39, 0], np.int32)

    def loss(tb):
        e = sharded_lookup(tb, jnp.asarray(ids), mesh)
        return jnp.sum(e * jnp.arange(1.0, 5.0)[:, None])

    tbl = shard_table(jnp.asarray(t), mesh)
    g = np.asarray(jax.jit(jax.grad(loss))(tbl))
    want = np.zeros_like(t)
    for k, i in enumerate(ids):
        want[i] += k + 1.0
    np.testing.assert_allclose(g, want, rtol=1e-6)


def test_sharded_lookup_grad_batch_sharded_matches_dense(devices8):
    """data>1 + batch-sharded ids: the table cotangent must psum over the
    'data' axis in shard_map's transpose (each data replica-group scatters
    only its own rows). Direct grad-vs-dense assertion pinning that psum
    independent of any train-loop parity test, so a JAX upgrade changing
    check_vma transpose semantics fails HERE."""
    mesh = make_mesh(MeshSpec(data=4, model=2))
    t = _table(v=48, d=4)
    # leading dim 8 divides data=4 → the batch-sharded ids path; duplicate
    # ids across DIFFERENT data shards so a missing data-psum loses terms
    ids = np.array([[3, 47], [3, 0], [12, 3], [12, 12],
                    [5, 5], [3, 41], [0, 0], [47, 12]], np.int32)
    w = np.arange(1.0, 17.0, dtype=np.float32).reshape(8, 2)

    def loss(tb):
        e = sharded_lookup(tb, jnp.asarray(ids), mesh)
        return jnp.sum(e * jnp.asarray(w)[:, :, None])

    g = np.asarray(jax.jit(jax.grad(loss))(shard_table(jnp.asarray(t), mesh)))
    want = np.zeros_like(t)
    np.add.at(want, ids.ravel(), w.ravel()[:, None] * np.ones((1, 4), np.float32))
    np.testing.assert_allclose(g, want, rtol=1e-6)


def test_dedup_lookup_matches_take(devices8):
    mesh = make_mesh(MeshSpec(data=2, model=4))
    t = _table(v=32, d=8)
    ids = np.array([[1, 1, 1, 2], [31, 0, 31, 7]], np.int32)
    out = jax.jit(lambda tb, i: sort_coalesced_lookup(tb, i, mesh))(
        shard_table(jnp.asarray(t), mesh), jnp.asarray(ids)
    )
    np.testing.assert_allclose(np.asarray(out), t[ids], rtol=1e-6)

    # grad parity with plain take
    def loss_dedup(tb):
        return jnp.sum(sort_coalesced_lookup(tb, jnp.asarray(ids)) ** 2)

    def loss_take(tb):
        return jnp.sum(jnp.take(tb, jnp.asarray(ids), axis=0) ** 2)

    g1 = np.asarray(jax.grad(loss_dedup)(jnp.asarray(t)))
    g2 = np.asarray(jax.grad(loss_take)(jnp.asarray(t)))
    np.testing.assert_allclose(g1, g2, rtol=1e-6)


def test_embedding_compute_dtype_bf16():
    """bf16 compute copy: output is bf16, values match f32 within bf16 eps,
    and the gradient lands back on the f32 master param."""
    from recommender_tpu.embedding.table import Embedding

    ids = jnp.asarray([1, 3, 3, 7], jnp.int32)
    f32 = Embedding(16, 8)
    b16 = Embedding(16, 8, compute_dtype=jnp.bfloat16)
    vs = f32.init(jax.random.PRNGKey(0), ids)  # identical param tree
    out32, _ = f32.apply(vs, ids)
    out16, _ = b16.apply(vs, ids)
    assert out16.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out16, np.float32), np.asarray(out32), rtol=1e-2, atol=1e-2
    )

    def loss(v):
        return jnp.sum(b16.apply(v, ids)[0].astype(jnp.float32) ** 2)

    g = jax.grad(loss)(vs)["embedding"]
    assert g.dtype == jnp.float32  # up-cast through the astype transpose
    # duplicate id 3 accumulates 2x its row's cotangent
    t = np.asarray(vs["embedding"])
    np.testing.assert_allclose(np.asarray(g)[3], 4 * t[3], rtol=2e-2, atol=1e-3)
    assert np.all(np.asarray(g)[0] == 0)


def test_bf16_param_table_trains():
    """bf16-stored table (DLRM.embed_param_dtype): the train step runs, the
    table stays bf16 through the optimizer update, and rows change."""
    from recommender_tpu.core.train import TrainConfig, Trainer
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.models.tasks import init_model, make_ctr_task

    gen = SyntheticCTR(vocab_size=64, seed=0)
    host = gen.sample(32, seed=1)
    model = DLRM(vocab_size=64, embed_dim=8, bottom_units=(16, 8),
                 top_units=(16, 1), embed_param_dtype=jnp.bfloat16)
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=0.1),
                 mesh=make_mesh(), eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, host))
    t0 = np.asarray(state.params["embedding"]["embedding"], np.float32)
    assert state.params["embedding"]["embedding"].dtype == jnp.bfloat16
    batch = tr.put_batch(host)
    for _ in range(3):
        state, m = tr._train_step(state, batch, jax.random.PRNGKey(0))
    assert state.params["embedding"]["embedding"].dtype == jnp.bfloat16
    t1 = np.asarray(state.params["embedding"]["embedding"], np.float32)
    assert np.isfinite(m["loss"]).all() and not np.allclose(t0, t1)

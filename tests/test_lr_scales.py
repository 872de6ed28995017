"""TrainConfig.lr_scales: per-parameter-subtree update scaling.

Adam is invariant to uniform *gradient* scaling, so the transform must
multiply the post-optimizer update. These tests pin that behavior and the
whole-component path matching (including on row-sharded params).
"""
import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.train import TrainConfig, make_optimizer


def _one_step(cfg, params, grads):
    opt = make_optimizer(cfg)
    state = opt.init(params)
    updates, _ = opt.update(grads, state, params)
    return updates


def test_scaled_subtree_moves_k_times_faster():
    params = {"id_embedding": {"table": jnp.ones((4, 3))}, "mlp": {"w": jnp.ones((3, 3))}}
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    base = _one_step(TrainConfig(learning_rate=1e-2), params, grads)
    scaled = _one_step(
        TrainConfig(learning_rate=1e-2, lr_scales={"id_embedding": 3.0}), params, grads
    )
    np.testing.assert_allclose(
        scaled["id_embedding"]["table"], 3.0 * base["id_embedding"]["table"], rtol=1e-6
    )
    np.testing.assert_allclose(scaled["mlp"]["w"], base["mlp"]["w"], rtol=1e-6)


def test_gradient_scaling_alone_is_a_noop_under_adam():
    # The reason lr_scales exists: feeding Adam 3x the gradient produces the
    # SAME first-step update (scale invariance), so per-table LR cannot be
    # implemented upstream of the optimizer.
    params = {"t": jnp.ones((4,))}
    g1 = {"t": jnp.full((4,), 0.5)}
    g3 = {"t": jnp.full((4,), 1.5)}
    u1 = _one_step(TrainConfig(), params, g1)
    u3 = _one_step(TrainConfig(), params, g3)
    np.testing.assert_allclose(u1["t"], u3["t"], rtol=1e-5)


def test_component_match_not_substring():
    # 'cat_embedding' must NOT match 'concat_embedding' (whole-component
    # matching); multi-component keys match consecutive component runs.
    params = {
        "cat_embedding": {"table": jnp.ones((4, 2))},
        "concat_embedding": {"table": jnp.ones((4, 2))},
    }
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1.0), params)
    cfg = TrainConfig(optimizer="sgd", learning_rate=1.0,
                      lr_scales={"cat_embedding": 2.0})
    base = _one_step(TrainConfig(optimizer="sgd", learning_rate=1.0), params, grads)
    scaled = _one_step(cfg, params, grads)
    np.testing.assert_allclose(
        scaled["cat_embedding"]["table"], 2.0 * base["cat_embedding"]["table"]
    )
    np.testing.assert_allclose(
        scaled["concat_embedding"]["table"], base["concat_embedding"]["table"]
    )
    multi = _one_step(
        TrainConfig(optimizer="sgd", learning_rate=1.0,
                    lr_scales={"cat_embedding/table": 3.0}),
        params, grads,
    )
    np.testing.assert_allclose(
        multi["cat_embedding"]["table"], 3.0 * base["cat_embedding"]["table"]
    )


def test_matches_through_partitioned_boxes(devices8):
    """A row-sharded table (placed by its PartitionSpec on a model-sharded
    mesh) is matched by path like any other param."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from recommender_tpu.core.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(data=2, model=4))
    sharded = {
        "id_embedding": {"table": jax.device_put(
            jnp.ones((8, 3)), NamedSharding(mesh, P("model", None)))},
        "other": jnp.ones((2,)),
    }
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1.0), sharded)
    base = _one_step(TrainConfig(optimizer="sgd", learning_rate=1.0), sharded, grads)
    scaled = _one_step(
        TrainConfig(optimizer="sgd", learning_rate=1.0, lr_scales={"id_embedding": 2.0}),
        sharded,
        grads,
    )
    np.testing.assert_allclose(
        scaled["id_embedding"]["table"],
        2.0 * base["id_embedding"]["table"],
    )
    np.testing.assert_allclose(scaled["other"], base["other"])

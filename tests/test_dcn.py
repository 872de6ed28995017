"""DCNv2 (models/dcn.py + nn/cross.py): cross-layer math, learning, CLI."""
import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.dcn import DCN
from recommender_tpu.models.tasks import init_model, make_ctr_task
from recommender_tpu.nn.cross import CrossNetwork


def test_cross_layer_math():
    """One cross layer computes x0 * (W x0 + b) + x0 exactly."""
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32))
    m = CrossNetwork(num_layers=1)
    vs = m.init(jax.random.PRNGKey(0), x0)
    out = m.apply(vs, x0)
    W = vs["cross_0"]["kernel"]
    b = vs["cross_0"]["bias"]
    want = x0 * (x0 @ W + b) + x0
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-6)


def test_cross_represents_pairwise_product():
    """The defining property: with one layer, the output depends on
    PRODUCTS of input coordinates — a pure linear model cannot express
    x_i·x_j, a 1-layer cross can (fit y = x1*x2 exactly in 2 dims of a
    frozen random W? simpler: gradient of out wrt x is x0-dependent)."""
    x0 = jnp.asarray([[1.0, 2.0, 3.0]])
    m = CrossNetwork(num_layers=1)
    vs = m.init(jax.random.PRNGKey(1), x0)
    j1 = jax.jacobian(lambda x: m.apply(vs, x).sum())(x0)
    j2 = jax.jacobian(lambda x: m.apply(vs, x).sum())(2.0 * x0)
    # a linear map has constant jacobian; the cross term makes it scale
    assert not np.allclose(np.asarray(j1), np.asarray(j2))


def test_dcn_forward_and_grad():
    gen = SyntheticCTR(vocab_size=64, seed=0)
    batch = gen.sample(16, seed=1)
    model = DCN(vocab_size=64, embed_dim=8, cross_layers=2, deep_units=(32, 16))
    params, ms = model.init(jax.random.PRNGKey(0), batch)
    prob = model.apply(params, ms, batch)[0]
    assert prob.shape == (16,)
    assert ((prob > 0) & (prob < 1)).all()
    # gradient reaches the embedding table AND every cross layer
    g = jax.grad(lambda p: jnp.sum(model.apply(p, ms, batch)[0]))(params)
    assert float(jnp.abs(g["embedding"]["embedding"]).sum()) > 0
    assert float(jnp.abs(g["cross"]["cross_1"]["kernel"]).sum()) > 0


def test_dcn_learns_synthetic_ctr(devices8):
    """Same harness as the zoo's other CTR models: the planted logistic
    structure is learnable well above chance within a few hundred steps."""
    mesh = make_mesh(MeshSpec(8, 1))
    gen = SyntheticCTR(vocab_size=512, seed=0)
    train = gen.sample(20_000, seed=1)
    test = gen.sample(4096, seed=2)
    model = DCN(vocab_size=512, embed_dim=8, cross_layers=2,
                deep_units=(64, 32))
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                 mesh=mesh, eval_fn=eval_fn)
    example = {k: v[:8] for k, v in train.items()}
    state = tr.init_state(lambda: init_model(model, example))
    state, _ = tr.fit(state, batch_iterator(train, 512, seed=0, epochs=None),
                      steps=300)
    ev = tr.evaluate(state, batch_iterator(test, 512, shuffle=False), exact=True)
    assert ev["eval_auc_exact"] > 0.70, ev


def test_cli_dcn_smoke(capsys, devices8):
    from recommender_tpu.cli.train_ctr import main

    main([
        "--synthetic", "--model_type", "DCN", "--steps", "20",
        "--train_batch_size", "64", "--test_batch_size", "256",
        "--vocab_size", "256", "--embedding_size", "8", "--eval_every", "0",
        "--log_every", "10",
    ])
    out = capsys.readouterr().out
    assert '"final"' in out and "nan" not in out

"""Layer unit tests vs pure-NumPy references (SURVEY.md §4 implication)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommender_tpu.nn.interactions import DotInteraction, fm_cross
from recommender_tpu.nn.losses import (
    bce_with_logits,
    binary_cross_entropy,
    margin_loss,
    masked_auxiliary_loss,
)
from recommender_tpu.nn.schedules import dlrm_warmup_cosine
from recommender_tpu.nn.sequence import (
    DIENAttention,
    LocalActivationUnit,
    masked_mean_pool,
)
from recommender_tpu.nn.recurrent import GRU, AUGRU


def test_fm_cross_numpy_parity():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 8)).astype(np.float32)
    want = np.zeros(4, np.float32)
    for b in range(4):
        for i in range(5):
            for j in range(i + 1, 5):
                want[b] += x[b, i] @ x[b, j]
    got = np.asarray(fm_cross(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("self_int,skip", [(False, True), (False, False), (True, False)])
def test_dot_interaction(self_int, skip):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    layer = DotInteraction(self_interaction=self_int, skip_gather=skip)
    out = layer(jnp.asarray(x))
    grid = np.einsum("bfd,bgd->bfg", x, x)
    k = 0 if self_int else 1
    tri = np.triu(np.ones((6, 6), bool), k=k)
    if skip:
        want = np.where(tri[None], grid, 0.0).reshape(3, 36)
    else:
        want = np.stack([grid[b][tri] for b in range(3)])
    # layer computes the pairwise grid in bf16 → ~1e-2 relative error
    np.testing.assert_allclose(np.asarray(out), want, rtol=3e-2, atol=3e-2)
    assert out.shape[1] == (36 if skip else tri.sum())


def test_losses_numpy_parity():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(16,)).astype(np.float32)
    labels = (rng.random(16) < 0.5).astype(np.float32)
    p = 1 / (1 + np.exp(-logits))
    want = -(labels * np.log(p) + (1 - labels) * np.log(1 - p))
    np.testing.assert_allclose(
        np.asarray(bce_with_logits(jnp.asarray(logits), jnp.asarray(labels))),
        want,
        rtol=1e-5,
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(binary_cross_entropy(jnp.asarray(p), jnp.asarray(labels))),
        want,
        rtol=1e-4,
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(margin_loss(jnp.asarray([2.0, 0.0]), jnp.asarray([0.5, 0.5]))),
        [0.0, 1.5],
    )


def test_masked_auxiliary_loss():
    pos = jnp.asarray([[2.0, 2.0, 2.0]])
    neg = jnp.asarray([[-2.0, -2.0, -2.0]])
    mask = jnp.asarray([[1.0, 1.0, 0.0]])
    got = float(masked_auxiliary_loss(pos, neg, mask)[0])
    step = np.log(1 + np.exp(-2.0))
    assert abs(got - step) < 1e-5  # (2*step + 2*step) / 4


def test_masked_mean_pool():
    x = jnp.asarray(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    mask = jnp.asarray([[1, 1, 0], [1, 0, 0]], jnp.float32)
    out = np.asarray(masked_mean_pool(x, mask))
    np.testing.assert_allclose(out[0], (np.arange(4) + np.arange(4, 8)) / 2)
    np.testing.assert_allclose(out[1], np.arange(12, 16))


def test_din_attention_masks_padded_steps():
    layer = LocalActivationUnit()
    rng = np.random.default_rng(3)
    target = jnp.asarray(rng.normal(size=(2, 8)).astype(np.float32))
    hist = jnp.asarray(rng.normal(size=(2, 5, 8)).astype(np.float32))
    mask = jnp.asarray([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), target, hist, mask)
    out1 = layer.apply(params, target, hist, mask)
    # changing padded history steps must not change the output
    hist2 = hist.at[:, 3:, :].set(99.0)
    out2 = layer.apply(params, target, hist2, mask)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-5)


def test_dien_attention_softmax_and_mask():
    layer = DIENAttention()
    rng = np.random.default_rng(4)
    target = jnp.asarray(rng.normal(size=(2, 8)).astype(np.float32))
    hidden = jnp.asarray(rng.normal(size=(2, 5, 6)).astype(np.float32))
    mask = jnp.asarray([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1]], jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), target, hidden, mask)
    score = np.asarray(layer.apply(params, target, hidden, mask))
    np.testing.assert_allclose(score.sum(axis=1).squeeze(-1), [1.0, 1.0], rtol=1e-5)
    assert score[0, 2:].max() < 1e-6  # masked steps get ~0 prob


def _np_gru(x, mask, p, hidden):
    w_g, b_g, w_c, b_c = (np.asarray(p[k]) for k in ("w_gates", "b_gates", "w_cand", "b_cand"))
    B, T, D = x.shape
    h = np.zeros((B, hidden), np.float32)
    hs = []
    for t in range(T):
        zr = 1 / (1 + np.exp(-(np.concatenate([h, x[:, t]], -1) @ w_g + b_g)))
        z, r = zr[:, :hidden], zr[:, hidden:]
        c = np.tanh(np.concatenate([x[:, t], r * h], -1) @ w_c + b_c)
        new = (1 - z) * h + z * c
        m = mask[:, t : t + 1]
        h = m * new + (1 - m) * h
        hs.append(h.copy())
    return np.stack(hs, 1)


def test_gru_scan_vs_numpy():
    layer = GRU(hidden=7)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(3, 6, 4)).astype(np.float32))
    mask = jnp.asarray((rng.random((3, 6)) < 0.8).astype(np.float32))
    variables = layer.init(jax.random.PRNGKey(0), x, mask)
    out = np.asarray(layer.apply(variables, x, mask))
    want = _np_gru(np.asarray(x), np.asarray(mask), variables, 7)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_gru_mask_carries_state():
    layer = GRU(hidden=4)
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(1, 5, 3)).astype(np.float32))
    mask = jnp.asarray([[1, 1, 0, 0, 0]], jnp.float32)
    variables = layer.init(jax.random.PRNGKey(0), x, mask)
    out = np.asarray(layer.apply(variables, x, mask))
    np.testing.assert_allclose(out[0, 2], out[0, 1])  # masked step: carry
    np.testing.assert_allclose(out[0, 4], out[0, 1])


def test_augru_attention_gate():
    """att=0 ⇒ state never updates; att=1 ⇒ plain GRU behavior."""
    layer = AUGRU(hidden=4)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(2, 5, 4)).astype(np.float32))
    mask = jnp.ones((2, 5), jnp.float32)
    att0 = jnp.zeros((2, 5, 1), jnp.float32)
    variables = layer.init(jax.random.PRNGKey(0), x, att0, mask)
    out0 = np.asarray(layer.apply(variables, x, att0, mask))
    np.testing.assert_allclose(out0, 0.0, atol=1e-6)


def test_gru_remat_identical_outputs_and_grads():
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(2, 5, 3)).astype(np.float32))
    mask = jnp.ones((2, 5), jnp.float32)
    plain = GRU(hidden=4)
    remat = GRU(hidden=4, remat=True)
    params = plain.init(jax.random.PRNGKey(0), x, mask)
    out_p = plain.apply(params, x, mask)
    out_r = remat.apply(params, x, mask)
    np.testing.assert_allclose(np.asarray(out_p), np.asarray(out_r), atol=1e-6)
    g_p = jax.grad(lambda p: jnp.sum(plain.apply(p, x, mask) ** 2))(params)
    g_r = jax.grad(lambda p: jnp.sum(remat.apply(p, x, mask) ** 2))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_p), jax.tree_util.tree_leaves(g_r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dlrm_schedule():
    sched = dlrm_warmup_cosine(0.01, 20, 1000, 1e-4)
    assert abs(float(sched(0))) < 1e-9
    assert abs(float(sched(10)) - 0.005) < 1e-9
    assert abs(float(sched(20)) - 0.01) < 1e-6
    assert float(sched(1020)) < 1e-5  # decayed to ~alpha*lr
    assert abs(float(sched(5000)) - float(sched(1020))) < 1e-9

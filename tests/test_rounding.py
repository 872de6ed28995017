"""Stochastic rounding (ops.rounding) + SR-aware Adam (core.optim).

The property chain these pin: sr is unbiased -> sub-ulp updates land in
expectation -> a bf16-stored table trains like f32 (chip_smoke.py phase
``train`` runs both table dtypes on the GPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from recommender_tpu.core.optim import (
    adam_sr,
    apply_updates_sr,
    has_low_precision_leaf,
)
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.ops.rounding import is_low_precision, stochastic_round_to


@pytest.mark.parametrize("fast", [True, False])
def test_sr_unbiased_sub_ulp(fast):
    # 1.0 + delta with delta ~ ulp/4: E[sr(x)] must be x, not round(x).
    # Covers both generators: the murmur3-hash fast path (production) and
    # threefry (reference).
    ulp = 2.0 ** -7  # bf16 ulp at 1.0 (7 mantissa bits)
    x = jnp.full((4096,), 1.0 + ulp / 4, jnp.float32)
    key = jax.random.PRNGKey(0)
    r = stochastic_round_to(x, jnp.bfloat16, key, fast=fast).astype(jnp.float32)
    vals = np.unique(np.asarray(r))
    assert set(float(v) for v in vals) <= {1.0, 1.0 + ulp}  # only the neighbors
    p_up = float(jnp.mean(r > 1.0))
    assert abs(p_up - 0.25) < 0.03  # 4096 draws, 3 sigma ~ 0.02


def test_hash_noise_decorrelated_across_keys():
    from recommender_tpu.ops.rounding import _hash_noise_u16

    k0 = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    k1 = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    a = np.asarray(_hash_noise_u16((1 << 16,), k0), np.float64)
    b = np.asarray(_hash_noise_u16((1 << 16,), k1), np.float64)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.02
    assert abs(a.mean() / 65535 - 0.5) < 0.01  # uniform over [0, 2^16)


def test_sr_exact_values_unchanged():
    x = jnp.array([0.0, 1.0, -2.5, 0.15625], jnp.float32)  # bf16-exact
    for s in range(5):
        r = stochastic_round_to(x, jnp.bfloat16, jax.random.PRNGKey(s))
        np.testing.assert_array_equal(np.asarray(r, np.float32), np.asarray(x))


def test_sr_nonfinite_passthrough():
    x = jnp.array([jnp.inf, -jnp.inf, jnp.nan, 1.5], jnp.float32)
    r = np.asarray(
        stochastic_round_to(x, jnp.bfloat16, jax.random.PRNGKey(7)), np.float32
    )
    assert np.isposinf(r[0]) and np.isneginf(r[1]) and np.isnan(r[2])
    assert r[3] == 1.5


def test_sr_f32_identity():
    x = jnp.array([1.0000001, -3.7], jnp.float32)
    r = stochastic_round_to(x, jnp.float32, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(r), np.asarray(x))


def test_is_low_precision():
    assert is_low_precision(jnp.bfloat16) and is_low_precision(jnp.float16)
    assert not is_low_precision(jnp.float32)
    assert not is_low_precision(jnp.int8)


def test_adam_sr_matches_optax_on_f32():
    params = {"w": jnp.linspace(-1, 1, 32), "b": jnp.ones((4,))}
    ref = optax.adam(1e-2)
    sr = adam_sr(1e-2)
    s_ref, s_sr = ref.init(params), sr.init(params)
    key = jax.random.PRNGKey(3)
    p_ref, p_sr = params, params
    for i in range(5):
        g = jax.tree.map(
            lambda p: jax.random.normal(jax.random.fold_in(key, i), p.shape), params
        )
        u_ref, s_ref = ref.update(g, s_ref, p_ref)
        u_sr, s_sr = sr.update(g, s_sr, p_sr)
        p_ref = optax.apply_updates(p_ref, u_ref)
        p_sr = optax.apply_updates(p_sr, u_sr)
    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_sr)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-7)


def test_adam_sr_moment_dtypes():
    params = {"t": jnp.ones((8, 4), jnp.bfloat16), "w": jnp.ones((3,), jnp.float32)}
    st = adam_sr(1e-3).init(params)[0]  # ScaleByAdamState from the chain
    assert st.mu["t"].dtype == jnp.bfloat16 and st.nu["t"].dtype == jnp.bfloat16
    assert st.mu["w"].dtype == jnp.float32
    st32 = adam_sr(1e-3, moment_dtype="float32").init(params)[0]
    assert st32.mu["t"].dtype == jnp.float32 and st32.nu["t"].dtype == jnp.float32


def test_sub_ulp_updates_land_in_expectation():
    # 2000 SGD-style sub-ulp decrements on a bf16 scalar: plain RTN apply
    # never moves (the defect SR exists to fix); SR accumulates the drift.
    n = 2000
    delta = -1e-4  # ulp(1.0)=7.8e-3 -> each update is ~1/78 ulp
    p0 = {"w": jnp.ones((128,), jnp.bfloat16)}
    u = {"w": jnp.full((128,), delta, jnp.float32)}

    rtn = p0
    for _ in range(20):  # RTN provably fixed-point after one step
        rtn = jax.tree.map(lambda p, du: (p + du.astype(p.dtype)).astype(p.dtype), rtn, u)
    assert float(jnp.mean(rtn["w"].astype(jnp.float32))) == 1.0

    def body(p, k):
        return apply_updates_sr(p, u, k), None

    keys = jax.random.split(jax.random.PRNGKey(0), n)
    sr, _ = jax.lax.scan(body, p0, keys)
    mean = float(jnp.mean(sr["w"].astype(jnp.float32)))
    assert abs(mean - (1.0 + n * delta)) < 0.02  # E = 0.8, 128 iid walks


def test_trainer_auto_enables_sr_for_bf16_params():
    def apply(params, batch):
        t = params["table"]
        return jnp.take(t, batch["ids"], axis=0).astype(jnp.float32).sum(-1)

    def make(dtype):
        batch = {"ids": np.zeros((8,), np.int32), "label": np.zeros((8,), np.float32)}

        def loss_fn(params, ms, b, rng, train):
            out = apply(params, b)
            return (out - b["label"]) ** 2, {}, ms

        tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-2))
        table = 0.01 * jax.random.normal(jax.random.PRNGKey(0), (16, 4), dtype)
        state = tr.init_state(lambda: ({"table": table}, {}))
        return tr, state, batch

    tr16, st16, batch = make(jnp.bfloat16)
    assert tr16._sr_apply
    assert st16.opt_state[0].mu["table"].dtype == jnp.bfloat16
    tr32, st32, _ = make(jnp.float32)
    assert not tr32._sr_apply
    # and the SR step actually runs end-to-end
    st16b, metrics = tr16._train_step(st16, tr16.put_batch(batch), jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["loss"]))
    assert st16b.params["table"].dtype == jnp.bfloat16


def test_has_low_precision_leaf():
    assert has_low_precision_leaf({"a": jnp.ones((2,), jnp.bfloat16)})
    assert not has_low_precision_leaf({"a": jnp.ones((2,)), "i": jnp.zeros((2,), jnp.int32)})


def test_adam_sr_composes_with_lr_scales():
    """make_optimizer(stochastic=True) + lr_scales chain: the damped
    subtree's update is scaled AFTER adam_sr, same as the f32 path."""
    from recommender_tpu.core.train import make_optimizer

    params = {"cat_embedding": jnp.ones((4, 2), jnp.bfloat16),
              "mlp": jnp.ones((3,), jnp.float32)}
    grads = {"cat_embedding": jnp.full((4, 2), 0.5, jnp.bfloat16),
             "mlp": jnp.full((3,), 0.5)}
    cfg = TrainConfig(learning_rate=1e-2, lr_scales={"cat_embedding": 0.5})
    base_cfg = TrainConfig(learning_rate=1e-2)
    opt = make_optimizer(cfg, stochastic=True)
    opt0 = make_optimizer(base_cfg, stochastic=True)
    u, _ = opt.update(grads, opt.init(params), params)
    u0, _ = opt0.update(grads, opt0.init(params), params)
    np.testing.assert_allclose(np.asarray(u["cat_embedding"], np.float32),
                               0.5 * np.asarray(u0["cat_embedding"], np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(u["mlp"]), np.asarray(u0["mlp"]))


def test_accum_grads_accumulate_in_f32_for_bf16_params():
    """accum_steps>1 with a bf16 table: microbatch grads sum in f32 (a
    bf16 accumulator would lose sub-ulp contributions), and the accum step
    tracks the single-batch step closely."""
    def apply(params, batch):
        t = params["table"]
        return jnp.take(t, batch["ids"], axis=0).astype(jnp.float32).sum(-1)

    rng = np.random.default_rng(0)
    batch = {"ids": rng.integers(0, 32, 64).astype(np.int32),
             "label": rng.normal(size=64).astype(np.float32)}
    def init():  # a fresh table per run: the train step donates its state
        table = 0.5 * jax.random.normal(jax.random.PRNGKey(0), (32, 4), jnp.bfloat16)
        return {"table": table}, {}

    def loss_fn(params, ms, b, key, train):
        out = apply(params, b)
        return (out - b["label"]) ** 2, {}, ms

    def run(accum):
        tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-2, accum_steps=accum))
        state = tr.init_state(init)
        state, m = tr._train_step(state, tr.put_batch(batch), jax.random.PRNGKey(1))
        return np.asarray(state.params["table"], np.float32), float(m["loss"])

    p1, l1 = run(1)
    p2, l2 = run(2)
    assert abs(l1 - l2) < 1e-3
    # params differ only by SR draw noise on identical expected updates:
    # within one bf16 ulp of the table scale
    assert np.max(np.abs(p1 - p2)) <= 0.5 * 2.0 ** -6

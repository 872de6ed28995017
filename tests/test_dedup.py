"""Host dedup plans + the dedup'd embedding lookup (sorted segment-sums).

The plan contract (data/dedup.py): perm sorts the flat ids ascending
(stable), slot_sorted is the nondecreasing unique-slot stream, uniq is the
ascending unique list padded with PAD_ID. The C++ radix plan and the numpy
fallback must agree exactly; the plan-driven backward must match the plain
lookup gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommender_tpu.data import dedup
from recommender_tpu.data.dedup import PAD_ID, build_plan


def _check_plan(ids, plan, u_cap):
    flat = ids.reshape(-1)
    uniq_ref, inv = np.unique(flat, return_inverse=True)
    assert plan.n_unique == uniq_ref.size
    np.testing.assert_array_equal(plan.uniq[: uniq_ref.size], uniq_ref)
    assert np.all(plan.uniq[uniq_ref.size :] == PAD_ID)
    # perm sorts the stream; slot_sorted names each sorted position's slot
    np.testing.assert_array_equal(flat[plan.perm], uniq_ref[plan.slot_sorted])
    assert np.all(np.diff(plan.slot_sorted) >= 0)
    # stability: equal ids keep original order
    s = flat[plan.perm]
    for g in range(min(3, uniq_ref.size)):
        pos = plan.perm[s == uniq_ref[g]]
        assert np.all(np.diff(pos) > 0)


@pytest.mark.parametrize("native", [True, False])
def test_build_plan_contract(monkeypatch, native):
    if native:
        if not dedup.is_available():
            pytest.skip("native libdedup not built")
    else:
        monkeypatch.setattr(dedup, "_load", lambda: None)
    rng = np.random.default_rng(0)
    ids = (rng.zipf(1.3, size=(64, 26)) % 500).astype(np.int32)
    plan = build_plan(ids, u_cap=512)
    _check_plan(ids, plan, 512)


def test_build_plan_native_matches_numpy(monkeypatch):
    if not dedup.is_available():
        pytest.skip("native libdedup not built")
    rng = np.random.default_rng(1)
    ids = (rng.zipf(1.2, size=4096) % 10_000).astype(np.int32)
    nat = build_plan(ids, u_cap=4096)
    monkeypatch.setattr(dedup, "_load", lambda: None)
    ref = build_plan(ids, u_cap=4096)
    np.testing.assert_array_equal(nat.perm, ref.perm)
    np.testing.assert_array_equal(nat.slot_sorted, ref.slot_sorted)
    np.testing.assert_array_equal(nat.uniq, ref.uniq)
    assert nat.n_unique == ref.n_unique


def test_build_plan_overflow_returns_none():
    ids = np.arange(100, dtype=np.int32)  # 100 uniques
    assert build_plan(ids, u_cap=50) is None


def test_lookup_dedup_forward_and_grad():
    """embedding_lookup_dedup == plain take forward; grad == scatter-add."""
    from recommender_tpu.ops.embedding_kernels import embedding_lookup_dedup

    rng = np.random.default_rng(2)
    V, D = 3000, 16
    ids = (rng.zipf(1.3, size=(32, 26)) % V).astype(np.int32)
    plan = build_plan(ids, u_cap=1024)
    table = jnp.asarray(rng.normal(size=(V, D)).astype(np.float32))
    args = (
        jnp.asarray(ids),
        jnp.asarray(plan.perm),
        jnp.asarray(plan.slot_sorted),
        jnp.asarray(plan.uniq),
    )

    out = embedding_lookup_dedup(table, *args)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(jnp.take(table, args[0], axis=0))
    )

    def loss(t):
        e = embedding_lookup_dedup(t, *args)
        return jnp.sum(jnp.sin(e) * e)

    def loss_ref(t):
        e = jnp.take(t, args[0], axis=0)
        return jnp.sum(jnp.sin(e) * e)

    g = jax.grad(loss)(table)
    g_ref = jax.grad(loss_ref)(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5, atol=1e-5)


def test_with_dedup_plans_attach_and_overflow():
    from recommender_tpu.data.pipeline import with_dedup_plans

    rng = np.random.default_rng(3)
    skewed = {"cat_features": (rng.zipf(1.2, size=(512, 26)) % 10_000).astype(np.int32)}
    # all-distinct ids overflow the adaptively-sized cap -> cap grows, plan kept
    flat = rng.permutation(512 * 26).astype(np.int32).reshape(512, 26)
    out = list(with_dedup_plans(iter([skewed, {"cat_features": flat}])))
    assert "cat_dedup" in out[0]
    n_uniq0 = int(np.unique(skewed["cat_features"]).size)
    # adaptive cap: first batch's uniques + 25% headroom, rounded to 8192
    assert out[0]["cat_dedup"]["uniq"].size == max(
        8192, -(-int(n_uniq0 * 1.25) // 8192) * 8192
    )
    _check_plan(
        skewed["cat_features"],
        type("P", (), {
            "perm": out[0]["cat_dedup"]["perm"],
            "slot_sorted": out[0]["cat_dedup"]["slot"],
            "uniq": out[0]["cat_dedup"]["uniq"],
            "n_unique": n_uniq0,
        })(),
        out[0]["cat_dedup"]["uniq"].size,
    )
    assert "cat_dedup" in out[1]
    assert out[1]["cat_dedup"]["uniq"].size >= 512 * 26  # grew past the uniques
    _check_plan(
        flat,
        type("P", (), {
            "perm": out[1]["cat_dedup"]["perm"],
            "slot_sorted": out[1]["cat_dedup"]["slot"],
            "uniq": out[1]["cat_dedup"]["uniq"],
            "n_unique": 512 * 26,
        })(),
        out[1]["cat_dedup"]["uniq"].size,
    )
    # an explicit fixed cap keeps the old planless-overflow contract
    out_fixed = list(
        with_dedup_plans(iter([{"cat_features": flat}]), u_cap=8192)
    )
    assert "cat_dedup" not in out_fixed[0]


def test_dlrm_grads_match_with_plan():
    """DLRM loss + grads are identical with and without the dedup plan."""
    from recommender_tpu.data.pipeline import with_dedup_plans
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.models.tasks import init_model, make_ctr_task

    rng = np.random.default_rng(4)
    V = 2000
    batch = {
        "int_features": rng.normal(size=(64, 13)).astype(np.float32),
        "cat_features": (rng.zipf(1.3, size=(64, 26)) % V).astype(np.int32),
        "label": (rng.random(64) < 0.5).astype(np.float32),
    }
    model = DLRM(vocab_size=V, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))
    params, _ = init_model(model, batch)
    loss_fn, _ = make_ctr_task(model)
    (planned,) = list(with_dedup_plans(iter([batch])))
    assert "cat_dedup" in planned

    def mean_loss(p, b):
        per_ex, _, _ = loss_fn(p, {}, b, jax.random.PRNGKey(0), True)
        return jnp.mean(per_ex)

    l0, g0 = jax.value_and_grad(mean_loss)(params, batch)
    l1, g1 = jax.value_and_grad(mean_loss)(params, planned)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        ),
        g0,
        g1,
    )

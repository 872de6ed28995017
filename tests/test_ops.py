"""Embedding backward paths: padded and sorted scatter parity, row/volume gates."""
import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.ops.embedding_kernels import (
    embedding_lookup,
    padded_scatter_add,
)


def test_padded_scatter_matches_dense():
    rng = np.random.default_rng(0)
    V, D, N = 500, 16, 2000
    ids = jnp.asarray(rng.integers(0, V, N).astype(np.int32))
    upd = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    got = padded_scatter_add(ids, upd, V)
    want = jnp.zeros((V, D)).at[ids].add(upd)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_padded_scatter_wide_passthrough():
    rng = np.random.default_rng(1)
    V, D, N = 100, 128, 500
    ids = jnp.asarray(rng.integers(0, V, N).astype(np.int32))
    upd = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    got = padded_scatter_add(ids, upd, V)
    want = jnp.zeros((V, D)).at[ids].add(upd)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_embedding_lookup_fwd_and_grad():
    rng = np.random.default_rng(2)
    V, D = 64, 8
    table = jnp.asarray(rng.normal(size=(V, D)).astype(np.float32))
    ids = jnp.asarray(np.array([[1, 1, 63], [0, 5, 5]], np.int32))
    out = embedding_lookup(table, ids)
    np.testing.assert_allclose(np.asarray(out), np.asarray(table)[np.asarray(ids)])

    def loss(t):
        return jnp.sum(embedding_lookup(t, ids) ** 2)

    def loss_ref(t):
        return jnp.sum(jnp.take(t, ids, axis=0) ** 2)

    g = jax.grad(loss)(table)
    g_ref = jax.grad(loss_ref)(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5)


def test_sorted_scatter_matches_numpy():
    """The sorted scatter (segment-sum over ascending ids) equals np.add.at."""
    import recommender_tpu.ops.embedding_kernels as ek

    rng = np.random.default_rng(3)
    V, D, N = 5000, 16, 3000
    ids = np.sort(rng.integers(0, V, N).astype(np.int32))
    upd = rng.normal(size=(N, D)).astype(np.float32)
    got = ek.sorted_scatter_add(jnp.asarray(ids), jnp.asarray(upd), V)
    want = np.zeros((V, D), np.float32)
    np.add.at(want, ids, upd)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_sorted_scatter_order_and_odd_width():
    """order= path (host argsort folded in as one reorder) at an odd width
    (D=18) and the DLRM width (D=16); out-of-range pad ids are dropped."""
    import recommender_tpu.ops.embedding_kernels as ek

    rng = np.random.default_rng(4)
    for D in (18, 16):
        V, N = 4100, 2500
        ids = rng.integers(0, V, N).astype(np.int32)
        ids[:7] = 2**30  # dedup-plan padding: beyond any vocab
        upd = rng.normal(size=(N, D)).astype(np.float32)
        order = np.argsort(ids, kind="stable").astype(np.int32)
        got = ek.sorted_scatter_add(
            jnp.asarray(ids[order]), jnp.asarray(upd), V, order=jnp.asarray(order)
        )
        want = np.zeros((V, D), np.float32)
        np.add.at(want, ids[7:], upd[7:])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_scatter_add_dense_matches_numpy():
    import recommender_tpu.ops.embedding_kernels as ek

    rng = np.random.default_rng(5)
    V, D, N = 3000, 8, 1700
    ids = rng.integers(0, V, (N,)).astype(np.int32)
    upd = rng.normal(size=(N, D)).astype(np.float32)
    got = ek.scatter_add_dense(jnp.asarray(ids), jnp.asarray(upd), V)
    want = np.zeros((V, D), np.float32)
    np.add.at(want, ids, upd)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_use_padded_backward_gate():
    """Per-lookup padded-backward selection (ops/embedding_kernels.py):
    purely volume-gated for narrow tables — a small scatter into a big
    narrow table keeps the native scatter fused — wide tables never."""
    from recommender_tpu.ops.embedding_kernels import (
        PADDED_BWD_MIN_IDS,
        use_padded_backward,
    )

    # big-narrow but tiny id volume: stays native (fused step wins)
    assert not use_padded_backward((1_000_000, 16), 128)
    assert use_padded_backward((1_000_000, 16), PADDED_BWD_MIN_IDS)
    # mid-size narrow table (DIEN 400k x 18): volume-gated
    assert not use_padded_backward((400_000, 18), PADDED_BWD_MIN_IDS - 1)
    assert use_padded_backward((400_000, 18), PADDED_BWD_MIN_IDS)
    assert not use_padded_backward((400_000, 64), 10_000_000)  # wide: never
    assert not use_padded_backward((400_000,), 10_000_000)  # not a table


def test_row_count_gates_and_sorted_window_backward(monkeypatch):
    """The custom backward is ROW-gated too: padded ≤2M rows, sorted
    scatter in the 2-5M window, native above. Gate logic + the
    sorted-branch gradient (constants shrunk to keep the CPU run small)."""
    import recommender_tpu.ops.embedding_kernels as ek

    # gate: >5M-row narrow tables go native even at huge id volume
    assert not ek.use_padded_backward((10_000_000, 16), 1_000_000)
    assert ek.use_padded_backward((2_500_000, 16), ek.PADDED_BWD_MIN_IDS)

    # steer a small table through the sorted branch of _lookup_bwd
    monkeypatch.setattr(ek, "PADDED_BWD_MAX_ROWS", 100)
    rng = np.random.default_rng(5)
    V, D, N = 4000, 16, 2000
    table = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, V, N), jnp.int32)

    def loss(t):
        return jnp.sum(ek.embedding_lookup(t, ids) ** 2)

    grad = jax.grad(loss)(table)
    want = np.zeros((V, D), np.float32)
    np.add.at(want, np.asarray(ids), 2.0 * np.asarray(table)[np.asarray(ids)])
    np.testing.assert_allclose(np.asarray(grad), want, rtol=1e-4, atol=1e-4)

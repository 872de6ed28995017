"""Grad coverage of the padded-scatter shard-local backward.

`embedding/sharded.py::_masked_gather` routes through the padded custom VJP
only for shards >= PADDED_BWD_MIN_SHARD_ROWS — CPU-mesh tests use tiny shards, so
without forcing the gate the custom path would go untested. These tests
lower the gate to 0 and check both exchange strategies' grads still match
plain AD of a replicated take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import recommender_tpu.embedding.sharded as sh
from recommender_tpu.core.mesh import MeshSpec, make_mesh


@pytest.fixture
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax.devices()[:8]


@pytest.fixture
def force_padded(monkeypatch):
    monkeypatch.setattr(sh, "PADDED_BWD_MIN_SHARD_ROWS", 0)


def _ref_grad(t, ids, w):
    return jax.grad(lambda tb: jnp.sum(jnp.take(tb, ids, axis=0) * w))(t)


def test_sharded_lookup_padded_grad(devices8, force_padded):
    mesh = make_mesh(MeshSpec(2, 4))
    rng = np.random.default_rng(0)
    V, D, N = 64, 8, 40
    t = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, V, N), jnp.int32)
    w = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    tbl = sh.shard_table(t, mesh)

    g = jax.jit(jax.grad(lambda tb: jnp.sum(sh.sharded_lookup(tb, ids, mesh) * w)))(tbl)
    np.testing.assert_allclose(np.asarray(g), np.asarray(_ref_grad(t, ids, w)),
                               rtol=1e-5, atol=1e-5)


def test_a2a_lookup_padded_grad(devices8, force_padded):
    mesh = make_mesh(MeshSpec(2, 4))
    rng = np.random.default_rng(1)
    V, D, N = 64, 8, 48
    t = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, V, N), jnp.int32)
    w = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    tbl = sh.shard_table(t, mesh)

    g = jax.jit(jax.grad(
        lambda tb: jnp.sum(
            sh.all_to_all_lookup(tb, ids, mesh, capacity_factor=4.0) * w)
    ))(tbl)
    np.testing.assert_allclose(np.asarray(g), np.asarray(_ref_grad(t, ids, w)),
                               rtol=1e-5, atol=1e-5)


def test_gate_default_means_plain_ad_on_small_shards(devices8):
    # tiny shards (V=64, m=4 -> 16 rows) sit far below the measured 300k-row
    # crossover: the plain-AD path must be the one compiled by default
    mesh = make_mesh(MeshSpec(2, 4))
    rng = np.random.default_rng(2)
    t = jnp.asarray(rng.normal(size=(64, 8)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, 64, 24), jnp.int32)
    w = jnp.asarray(rng.normal(size=(24, 8)), jnp.float32)
    tbl = sh.shard_table(t, mesh)
    g = jax.jit(jax.grad(lambda tb: jnp.sum(sh.sharded_lookup(tb, ids, mesh) * w)))(tbl)
    np.testing.assert_allclose(np.asarray(g), np.asarray(_ref_grad(t, ids, w)),
                               rtol=1e-5, atol=1e-5)

"""bf16 tables: every lookup's table gradient accumulates in f32.

On the GPU a scatter-add in bf16 runs as compare-and-swap atomics, far
slower than f32, and rounds away most of the sum on the Zipf head rows.
The custom backwards (padded, sorted, dedup) accumulate in f32; every
other lookup goes through ``embedding_take``. The lowered table gradient
at the real DLRM shapes is the witness: no bf16 scatter in it adds
(a bf16 scatter may only store, with ``unique_indices``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.embedding.sharded import _masked_gather, sort_coalesced_lookup
from recommender_tpu.embedding.table import Embedding
from recommender_tpu.ops.embedding_kernels import embedding_take, native_scatter_add

D = 16

# One stablehlo.scatter op: its attributes, then its update region, then
# the type signature "}) : (tensor<...xT>, ...". Captures (attributes,
# operand dtype).
_SCATTER_RE = re.compile(
    r'"stablehlo\.scatter"(.*?)\(\{.*?\}\) : \(tensor<[\dx]+x(\w+)>', re.S
)


def _scatters(hlo: str) -> list[tuple[bool, str]]:
    """(unique_indices, operand dtype) of every scatter in lowered text."""
    return [("unique_indices = true" in attrs, dtype)
            for attrs, dtype in _SCATTER_RE.findall(hlo)]


def _lower_table_grad(emb: Embedding, batch: int, sharded: bool) -> str:
    """Lower (not run) the table gradient of ``emb`` at ``batch`` × 26 ids."""
    sharding = NamedSharding(emb.mesh, P("model", None)) if sharded else None
    params = {"embedding": jax.ShapeDtypeStruct(
        (emb.vocab_size, D), emb.param_dtype, sharding=sharding)}
    ids = jax.ShapeDtypeStruct((batch, 26), jnp.int32)
    out_dtype = emb.compute_dtype or emb.param_dtype
    cot = jax.ShapeDtypeStruct((batch, 26, D), out_dtype)

    def loss(p, i, w):
        return jnp.sum((emb.apply(p, i)[0] * w).astype(jnp.float32))

    return jax.jit(jax.grad(loss)).lower(params, ids, cot).as_text()


def _mesh4():
    return make_mesh(MeshSpec(1, 4), jax.devices()[:4])


# (name, Embedding kwargs, batch, table row-sharded over a (1, 4) mesh)
_CASES = [
    # 1M / 4 = 250k rows per shard: below the shard backward's window
    ("psum_250k_rows_per_shard", dict(partition="model", lookup_mode="psum"), 8192, True),
    ("a2a_250k_rows_per_shard",
     dict(partition="model", lookup_mode="a2a", capacity_factor=4.0), 8192, True),
    # fewer than PADDED_BWD_MIN_IDS ids per lookup
    ("gspmd_row_sharded_small_batch", dict(partition="model"), 64, True),
    ("replicated_small_batch", {}, 64, False),
    ("replicated_in_window", {}, 8192, False),
    ("bf16_compute_over_f32_param",
     dict(param_dtype=jnp.float32, compute_dtype=jnp.bfloat16), 64, False),
]


@pytest.mark.parametrize("name,kw,batch,sharded", _CASES, ids=[c[0] for c in _CASES])
def test_bf16_table_grad_accumulates_in_f32(devices8, name, kw, batch, sharded):
    kw = {"param_dtype": jnp.bfloat16, **kw}
    mesh = _mesh4() if sharded else None
    emb = Embedding(1_000_000, D, mesh=mesh, **kw)
    scatters = _scatters(_lower_table_grad(emb, batch, sharded))
    assert (False, "bf16") not in scatters, scatters
    assert (False, "f32") in scatters, scatters  # the table gradient


def test_bf16_table_above_sorted_window_accumulates_in_f32():
    """A table above SORTED_BWD_MAX_ROWS keeps the native scatter, in f32."""
    emb = Embedding(6_000_000, D, param_dtype=jnp.bfloat16)
    scatters = _scatters(_lower_table_grad(emb, 8192, False))
    assert scatters == [(False, "f32")], scatters


def test_f32_table_keeps_ad_scatter():
    """f32 tables are untouched: embedding_take is jnp.take, AD's scatter."""
    emb = Embedding(1_000_000, D)
    scatters = _scatters(_lower_table_grad(emb, 64, False))
    assert scatters == [(False, "f32")], scatters


def test_embedding_take_bf16_grad_matches_f32_reference():
    """The bf16 gradient is the f32 sum rounded once: Zipf-like repeats of
    one row (1000 updates) would lose most of their sum in bf16."""
    rng = np.random.default_rng(0)
    V, N = 300, 4000
    ids = rng.integers(0, V, N).astype(np.int32)
    ids[:1000] = 7  # a head row
    cot = rng.normal(size=(N, D)).astype(np.float32)
    table = jnp.zeros((V, D), jnp.bfloat16)
    cot_bf = jnp.asarray(cot, jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: embedding_take(t, jnp.asarray(ids)), table)
    (got,) = vjp(cot_bf)
    assert got.dtype == jnp.bfloat16
    want = np.zeros((V, D), np.float32)
    np.add.at(want, ids, np.asarray(cot_bf, np.float32))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=2.0 ** -8, atol=1e-6)
    # the forward is the plain take
    np.testing.assert_array_equal(
        np.asarray(embedding_take(table, jnp.asarray(ids))),
        np.asarray(jnp.take(table, jnp.asarray(ids), axis=0)))


def test_native_scatter_add_promotes_and_matches_numpy():
    rng = np.random.default_rng(1)
    V, N = 50, 600
    ids = rng.integers(0, V, N).astype(np.int32)
    upd = rng.normal(size=(N, D)).astype(np.float32)
    got = native_scatter_add(jnp.asarray(ids), jnp.asarray(upd, jnp.bfloat16), V)
    assert got.dtype == jnp.float32 and got.shape == (V, D)
    want = np.zeros((V, D), np.float32)
    np.add.at(want, ids, np.asarray(jnp.asarray(upd, jnp.bfloat16), np.float32))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_masked_gather_small_bf16_shard_grad():
    """Below the shard window, invalid positions add nothing and the bf16
    shard gradient is the f32 sum rounded once."""
    rng = np.random.default_rng(2)
    rows, N = 200, 3000
    idx = rng.integers(-50, rows + 50, N).astype(np.int32)
    valid = (idx >= 0) & (idx < rows)
    cot = jnp.asarray(rng.normal(size=(N, D)), jnp.bfloat16)
    shard = jnp.zeros((rows, D), jnp.bfloat16)
    _, vjp = jax.vjp(lambda s: _masked_gather(s, jnp.asarray(idx), jnp.asarray(valid)), shard)
    (got,) = vjp(cot)
    assert got.dtype == jnp.bfloat16
    want = np.zeros((rows, D), np.float32)
    np.add.at(want, idx[valid], np.asarray(cot, np.float32)[valid])
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=2.0 ** -8, atol=1e-6)


def test_sort_coalesced_lookup_bf16_grad():
    rng = np.random.default_rng(3)
    V = 100
    ids = rng.integers(0, V, (400, 5)).astype(np.int32)
    ids[:, 0] = 5  # a head row: 400 updates
    table = jnp.asarray(rng.normal(size=(V, D)), jnp.bfloat16)

    def loss(t, fn):
        return jnp.sum(fn(t, jnp.asarray(ids)).astype(jnp.float32))

    got = jax.grad(loss)(table, sort_coalesced_lookup)
    want = jax.grad(loss)(table.astype(jnp.float32), lambda t, i: jnp.take(t, i, axis=0))
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               rtol=2.0 ** -8)

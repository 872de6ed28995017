"""The 10M-vocab row-sharded DLRM configuration end-to-end.

Growth story for the reference's replicated 1M×16 table
(``ctr/train.py:64-65``): at 10M rows (640 MB f32 table + 1.3 GB Adam
moments) replication stops being free. The planner row-shards over
``model`` and picks the all-to-all exchange; the 3-way row-gated shard
backward (``embedding/sharded.py::_masked_gather`` /
``_local_gather_bwd``) then picks its kernel PER SHARD SIZE:

* 10M/8 = 1.25M rows/shard → padded 64-lane scatter (the [300k, 2M] window)
* 10M/4 = 2.5M rows/shard  → sorted scatter (device argsort +
  segment-sum, the 2–5M window)
* 10M/1 = 10M rows        → XLA native scatter fused into the step

The lowered per-shard HLO is the witness for each choice (the gate is a
trace-time Python branch on ``shard.shape[0]``, so lowering text is
faithful); a real (1,8)-mesh train step executes the full config.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import recommender_tpu.embedding.sharded as sh
from recommender_tpu.core.mesh import MeshSpec, make_mesh

V10M, D = 10_000_000, 16


# A stablehlo.scatter op spans lines (it carries an update region); its
# type signature follows the region's closing "}) : (<operand>, ...)".
_SCATTER_RE = re.compile(
    r'"stablehlo\.scatter".*?\}\) : \(tensor<(\d+)x(\d+)xf32>', re.S
)


def _f32_scatter_dests(hlo: str) -> set:
    """(rows, cols) of every f32 scatter destination in the lowered text."""
    return {(int(r), int(c)) for r, c in _SCATTER_RE.findall(hlo)}


def _lower_a2a_grad(mesh, m):
    """Lower (not run) the a2a lookup's table gradient at the REAL 10M
    shapes via ShapeDtypeStructs — no 640 MB array materialized."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    tbl = jax.ShapeDtypeStruct(
        (V10M, D), jnp.float32, sharding=NamedSharding(mesh, P("model", None))
    )
    ids = jax.ShapeDtypeStruct((4096,), jnp.int32)
    cot = jax.ShapeDtypeStruct((4096, D), jnp.float32)

    def loss(tb, i, w):
        return jnp.sum(sh.all_to_all_lookup(tb, i, mesh, capacity_factor=float(m)) * w)

    return jax.jit(jax.grad(loss)).lower(tbl, ids, cot).as_text()


def test_planner_10m_shards_and_a2a():
    """plan_tables on the 10M table: row-shard + all-to-all at the
    production batch, with skew-aware capacity from real ids."""
    from recommender_tpu.embedding.planner import (
        TableStats,
        capacity_factor_from_ids,
        plan_tables,
    )

    for m in (4, 8):
        [plan] = plan_tables(
            [TableStats("embedding", V10M, D, lookups_per_example=26)],
            num_model_shards=m,
            batch_per_device=8192,
        )
        assert plan.partition == "model"
        assert plan.lookup == "all_to_all"
        assert plan.bytes_per_device == V10M * D * 4 // m

    rng = np.random.default_rng(0)
    ids = (rng.zipf(1.2, size=(8192, 26)) - 1).clip(0, V10M - 1)
    cap = capacity_factor_from_ids(ids, 8, V10M)
    assert 1.0 < cap <= 8.0


def test_backward_gate_padded_window_m8(devices8):
    """1.25M rows/shard ∈ [300k, 2M]: the padded 64-lane scatter is chosen
    (visible as a [1250000, 64] scatter destination in the lowered HLO)."""
    mesh = make_mesh(MeshSpec(1, 8))
    dests = _f32_scatter_dests(_lower_a2a_grad(mesh, 8))
    assert (1_250_000, 64) in dests, dests
    assert (1_250_000, D) not in dests, dests


def test_backward_gate_sorted_window_m4(devices8):
    """2.5M rows/shard ∈ (2M, 5M]: the sorted path is chosen on every
    backend — the lowered HLO carries the id sort and NO padded scatter."""
    mesh = make_mesh(MeshSpec(2, 4))
    hlo = _lower_a2a_grad(mesh, 4)
    assert (2_500_000, 64) not in _f32_scatter_dests(hlo)
    assert "sort" in hlo  # the device argsort feeding sorted_scatter_add


def test_backward_gate_native_above_5m(devices8):
    """An unsharded 10M destination (> 5M rows) keeps XLA's native scatter:
    _masked_gather declines the custom VJP entirely."""
    tbl = jax.ShapeDtypeStruct((V10M, D), jnp.float32)
    idx = jax.ShapeDtypeStruct((4096,), jnp.int32)
    val = jax.ShapeDtypeStruct((4096,), jnp.bool_)
    cot = jax.ShapeDtypeStruct((4096, D), jnp.float32)

    def loss(tb, i, v, w):
        return jnp.sum(sh._masked_gather(tb, i, v) * w)

    dests = _f32_scatter_dests(jax.jit(jax.grad(loss)).lower(tbl, idx, val, cot).as_text())
    assert (V10M, D) in dests, dests
    assert (V10M, 64) not in dests, dests


def test_psum_lookup_shard_local_backward(devices8):
    """Why the explicit 'psum' lookup exists (Embedding.lookup_mode): XLA's
    SPMD partitioner cannot row-split a scatter with arbitrary indices, so
    the GSPMD route's backward materializes a REPLICATED full-table scatter
    on every device; the shard_map route keeps it shard-local with the
    per-shard 3-way kernel gate. Witnessed from the compiled (partitioned)
    HLO of the table gradient at the real shapes on the (1,8) mesh:

    * gspmd, V=1M  -> replicated padded dest  f32[1000000,64] per device
    * psum,  V=1M  -> shard-local native      f32[125000,16]  (125k < 300k)
    * psum,  V=10M -> shard-local padded      f32[1250000,64] (in-window)
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from recommender_tpu.embedding.table import Embedding

    mesh = make_mesh(MeshSpec(1, 8))
    B = 2048  # 53k ids >= PADDED_BWD_MIN_IDS

    def scatter_dests(lookup_mode, V):
        model = Embedding(V, D, partition="model", lookup_mode=lookup_mode,
                          mesh=mesh if lookup_mode == "psum" else None)
        tbl_sh = NamedSharding(mesh, P("model", None))
        params = {"embedding": jax.ShapeDtypeStruct((V, D), jnp.float32,
                                                    sharding=tbl_sh)}
        ids = jax.ShapeDtypeStruct((B, 26), jnp.int32)
        cot = jax.ShapeDtypeStruct((B, 26, D), jnp.float32)

        def loss(p, i, w):
            return jnp.sum(model.apply(p, i)[0] * w)

        comp = jax.jit(jax.grad(loss)).lower(params, ids, cot).compile().as_text()
        return {
            (int(r.split(",")[0]), int(r.split(",")[1]))
            for r in re.findall(r"f32\[([\d,]+)\]\{[^}]*\} scatter", comp)
        }

    # gspmd: replicated full-table padded dest (the global volume gate fires)
    assert (1_000_000, 64) in scatter_dests("gspmd", 1_000_000)
    # psum: shard-local, per-shard gate -> native below 300k rows/shard
    assert scatter_dests("psum", 1_000_000) == {(125_000, 16)}
    # psum at 10M: per-shard 1.25M rows -> the padded window
    assert scatter_dests("psum", V10M) == {(1_250_000, 64)}


@pytest.mark.slow
def test_run_one_step_10m_sharded(devices8):
    """The full 10M-vocab config EXECUTES: planner-driven DLRM over the
    (1,8) CPU mesh (80 MB table rows + 160 MB moments per virtual device),
    two real train steps, finite falling loss, table genuinely sharded."""
    from recommender_tpu.core.train import TrainConfig, Trainer
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.embedding.planner import (
        TableStats,
        capacity_factor_from_ids,
        plan_tables,
    )
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.models.tasks import init_model, make_ctr_task
    from recommender_tpu.parallel.partitioning import model_shardings

    mesh = make_mesh(MeshSpec(1, 8))
    gen = SyntheticCTR(vocab_size=V10M, seed=0)
    batch = gen.sample(1024, seed=1)

    [plan] = plan_tables(
        [TableStats("embedding", V10M, D, lookups_per_example=26)],
        num_model_shards=8, batch_per_device=1024,
    )
    assert plan.partition == "model" and plan.lookup == "all_to_all"
    cap = capacity_factor_from_ids(batch["cat_features"], 8, V10M)

    model = DLRM(vocab_size=V10M, embed_dim=D, bottom_units=(32, D),
                 top_units=(32, 1), partition=plan.partition,
                 lookup_mode="a2a", mesh=mesh, capacity_factor=cap)
    loss_fn, eval_fn = make_ctr_task(model)
    pshard = model_shardings(model, batch, mesh)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, split_step=False),
                 mesh=mesh, param_shardings=pshard, eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, batch))

    table = state.params["embedding"]["embedding"]
    table = table.value if hasattr(table, "value") else table
    assert table.sharding.spec[0] == "model"
    assert table.shape == (V10M, D)

    dev_batch = tr.put_batch(batch)
    losses = []
    for i in range(2):
        state, metrics = tr._train_step(state, dev_batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[1] < losses[0]  # same batch twice: loss must fall

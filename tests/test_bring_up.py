"""Bring-up contract: the model layer without flax, orbax off the main path,
the compile-cache placement, and chip_smoke.py's CPU-testable helpers."""
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

# A meta-path finder that makes flax and orbax unimportable, as on a machine
# that has neither.
_BLOCK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax"):
            raise ModuleNotFoundError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, _Block())
import jax
jax.config.update("jax_enable_compilation_cache", False)
"""

_TINY_CTR = [
    "--model_type", "DLRM", "--synthetic", "--steps", "1", "--log_every", "1",
    "--eval_every", "0", "--vocab_size", "512", "--embedding_size", "8",
    "--train_batch_size", "64", "--test_batch_size", "64",
]


def _run_blocked(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-c", _BLOCK + code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_train_ctr_runs_without_flax_or_orbax():
    """With flax and orbax unimportable, cli.train_ctr imports and trains
    one DLRM step."""
    r = _run_blocked(
        "from recommender_tpu.cli import train_ctr\n"
        f"train_ctr.main({_TINY_CTR!r})\n"
        "assert not any(m.split('.')[0] in ('flax', 'orbax') for m in sys.modules)\n"
        "print('TRAINED')\n"
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "TRAINED" in r.stdout and '"step": 1' in r.stdout


def test_checkpoint_dir_without_orbax_stops_before_training(tmp_path):
    r = _run_blocked(
        "from recommender_tpu.cli import train_ctr\n"
        f"train_ctr.main({_TINY_CTR + ['--checkpoint_dir', str(tmp_path / 'ck')]!r})\n"
    )
    assert r.returncode != 0
    assert "orbax-checkpoint" in r.stderr and "--checkpoint_dir" in r.stderr
    assert '"step"' not in r.stdout  # stopped before the first train step


# ------------------------------------------------------------ compile cache
@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_into_checkout(monkeypatch, restore_cache_dir):
    from recommender_tpu.core import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    from recommender_tpu.core import compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env itself


# ------------------------------------------------------------- model layer
def _paths(tree) -> set:
    from recommender_tpu.parallel.partitioning import path_str

    return {path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_dlrm_param_paths_and_init_scales():
    from recommender_tpu.models.dlrm import DLRM

    model = DLRM(vocab_size=4096, embed_dim=16, bottom_units=(64, 16), top_units=(32, 1))
    params, state = model.init(jax.random.PRNGKey(0), {})
    assert state == {}
    assert _paths(params) == {
        "embedding/embedding",
        "bottom_mlp/Dense_0/kernel", "bottom_mlp/Dense_0/bias",
        "bottom_mlp/Dense_1/kernel", "bottom_mlp/Dense_1/bias",
        "top_mlp/Dense_0/kernel", "top_mlp/Dense_0/bias",
        "top_mlp/Dense_1/kernel", "top_mlp/Dense_1/bias",
    }
    table = np.asarray(params["embedding"]["embedding"])
    # variance_scaling(1, fan_in, uniform, out_axis=0): U(±sqrt(3/D))
    bound = math.sqrt(3.0 / 16)
    assert table.shape == (4096, 16) and np.abs(table).max() <= bound
    assert abs(table.std() - bound / math.sqrt(3)) < 0.02
    # lecun normal kernel (std 1/sqrt(fan_in), truncated), zero bias
    k = np.asarray(params["top_mlp"]["Dense_0"]["kernel"])
    assert k.shape == (27 * 27 + 16, 32)
    assert abs(k.std() * math.sqrt(k.shape[0]) - 1.0) < 0.1
    assert not np.any(np.asarray(params["top_mlp"]["Dense_0"]["bias"]))


def test_sequence_and_multitask_param_paths():
    from recommender_tpu.data.synthetic import SyntheticSequence
    from recommender_tpu.models.bst import BST
    from recommender_tpu.models.dien import DIEN
    from recommender_tpu.models.esmm import MMOE

    batch = SyntheticSequence(num_items=50, num_cats=10, max_len=6).sample(4, seed=0)
    dien = DIEN(item_vocab=50, cat_vocab=10, item_dim=4, cat_dim=4,
                extract_hidden=5, evolve_hidden=6)
    params, state = dien.init(jax.random.PRNGKey(0), batch)
    assert {"extract_gru/w_gates", "evolve/w_cand", "attention/kernel",
            "auxiliary_net/Dense_2/kernel", "mlp/BatchNorm_0/scale",
            "item_embedding/embedding"} <= _paths(params)
    bn = state["batch_stats"]["mlp"]["BatchNorm_0"]
    np.testing.assert_array_equal(bn["mean"], 0.0)
    np.testing.assert_array_equal(bn["var"], 1.0)
    # train mode moves the running stats; eval mode leaves them
    apply = jax.jit(dien.apply, static_argnames="train")
    _, new_state, _ = apply(params, state, batch, train=True)
    assert not np.allclose(new_state["batch_stats"]["mlp"]["BatchNorm_0"]["mean"], 0.0)
    _, same, _ = apply(params, state, batch, train=False)
    np.testing.assert_array_equal(same["batch_stats"]["mlp"]["BatchNorm_0"]["mean"], 0.0)

    bst = BST(item_vocab=50, cat_vocab=10, item_dim=4, cat_dim=4, num_heads=2, num_blocks=1)
    bp, _ = bst.init(jax.random.PRNGKey(0), batch)
    assert {"block_0/qkv/kernel", "block_0/out/kernel", "block_0/LayerNorm_1/scale",
            "block_0/Dense_1/bias", "positions/embedding"} <= _paths(bp)
    assert bp["block_0"]["qkv"]["kernel"].shape == (8, 3, 2, 4)
    np.testing.assert_array_equal(bp["block_0"]["LayerNorm_0"]["scale"], 1.0)
    np.testing.assert_array_equal(bp["block_0"]["LayerNorm_0"]["bias"], 0.0)

    mmoe = MMOE(vocab_sizes=(7, 9), embed_dim=4, num_experts=3,
                expert_units=(8, 5), tower_units=(4, 1))
    mp, _ = mmoe.init(jax.random.PRNGKey(0), {})
    # experts stacked on a leading axis (jax.vmap over the expert params)
    assert mp["expert_bank"]["experts"]["Dense_0"]["kernel"].shape == (3, 8, 8)
    assert {"embedder/feat_1/embedding", "gate_1/Dense_0/kernel",
            "tower_0/Dense_1/bias"} <= _paths(mp)


def test_sharded_param_specs_and_divisibility(devices8):
    from jax.sharding import PartitionSpec as P

    from recommender_tpu.core.mesh import MeshSpec, make_mesh
    from recommender_tpu.models.dlrm import DLRM
    from recommender_tpu.parallel.partitioning import (
        param_pspecs,
        validate_divisibility,
    )

    model = DLRM(vocab_size=252, embed_dim=8, bottom_units=(16, 8),
                 top_units=(16, 1), partition="model")
    params, _ = model.init(jax.random.PRNGKey(0), {})
    specs = param_pspecs(params, model.sharded_params())
    assert specs["embedding"]["embedding"] == P("model", None)
    assert specs["top_mlp"]["Dense_0"]["kernel"] == P()
    validate_divisibility(params, specs, make_mesh(MeshSpec(2, 4)))  # 252 % 4 == 0
    with pytest.raises(ValueError, match="not divisible"):
        validate_divisibility(params, specs, make_mesh(MeshSpec(1, 8)))
    with pytest.raises(KeyError, match="not in the param tree"):
        param_pspecs(params, {"embedding/table": P("model", None)})


def test_a2a_overflow_is_returned_as_diagnostic(devices8):
    """The all-to-all lookup reports dropped ids in the diagnostics return
    (and a tight capacity does drop ids of a skewed batch)."""
    from recommender_tpu.core.mesh import MeshSpec, make_mesh
    from recommender_tpu.embedding.table import Embedding

    mesh = make_mesh(MeshSpec(1, 8))
    ids = jnp.zeros((64,), jnp.int32)  # every id owned by shard 0
    for cap, drops in ((8.0, False), (1.0, True)):
        emb = Embedding(64, 4, partition="model", lookup_mode="a2a", mesh=mesh,
                        capacity_factor=cap)
        params = emb.init(jax.random.PRNGKey(0))
        _, diag = jax.jit(emb.apply)(params, ids)
        assert (int(diag["a2a_overflow"]) > 0) == drops


# -------------------------------------------------------------- chip_smoke
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_parses_nvidia_smi():
    cs = _chip_smoke()
    assert cs.parse_nvidia_smi("NVIDIA H100 80GB HBM3, 700.00 W\n") == [
        ("NVIDIA H100 80GB HBM3", "700.00 W")]
    four = "NVIDIA H100 80GB HBM3, 500.00 W\n" * 4
    assert len(cs.parse_nvidia_smi(four)) == 4
    for bad in ("", "no comma here", ", 700 W"):
        with pytest.raises(cs.SmokeFailure):
            cs.parse_nvidia_smi(bad)


def test_chip_smoke_comparison_helpers():
    cs = _chip_smoke()
    want = np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 4.0]])
    assert cs.max_rel_err(want, want) == 0.0 and cs.row_rel_err(want, want) == 0.0
    got = want.copy()
    got[2, 1] = 4.04
    assert cs.max_rel_err(got, want) == pytest.approx(0.01)
    assert cs.row_rel_err(got, want) == pytest.approx(0.01)
    np.testing.assert_allclose(cs.row_rel_errs(got, want), [0.0, 0.01])
    got[1, 0] = 1e-9  # a row the reference never touches
    assert cs.row_rel_err(got, want) == math.inf
    assert cs.row_rel_errs(got, want).size == 3


def test_chip_smoke_run_steps_matches_across_meshes(devices8):
    """The reference/multi comparison path at a tiny size on CPU devices:
    one device vs a row-sharded psum mesh gives the same losses."""
    cs = _chip_smoke()
    from recommender_tpu.core.mesh import MeshSpec, make_mesh
    from recommender_tpu.models.dlrm import DLRM

    batches = cs._data(vocab=256, batch=32, n=2)
    base = DLRM(vocab_size=256, embed_dim=cs.DIM, bottom_units=(16, cs.DIM),
                top_units=(16, 1))
    params, _ = jax.device_get(base.init(jax.random.PRNGKey(0), batches[0]))
    one, grads, _ = cs.run_steps(base, make_mesh(MeshSpec(1, 1), jax.devices()[:1]),
                                 params, batches, table_grads=True)
    mesh = make_mesh(MeshSpec(1, 4), jax.devices()[:4])
    sharded = DLRM(vocab_size=256, embed_dim=cs.DIM, bottom_units=(16, cs.DIM),
                   top_units=(16, 1), partition="model", lookup_mode="psum", mesh=mesh)
    four, grads4, _ = cs.run_steps(sharded, mesh, params, batches, table_grads=True)
    assert max(abs(a - b) for a, b in zip(one, four)) <= cs.LOSS_ATOL
    assert cs.row_rel_err(grads4[0], grads[0]) <= cs.GRAD_RTOL


@pytest.fixture
def gpu_machine():
    """Skip unless this machine has an NVIDIA GPU (decided at run time)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (no nvidia-smi on this machine)")


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_machine):
    """The whole smoke test on the card, in a child process that owns it
    (this test process stays on the CPU)."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"

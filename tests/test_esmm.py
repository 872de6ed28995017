"""ESMM/MMOE multi-task stack: model outputs, eval protocol, learning floors,
Ali-CCP raw-format pipeline."""
import numpy as np
import pytest

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.aliccp import (
    USE_COLUMNS,
    build_feature_vocab,
    click_only,
    encode_rows,
    join_skeleton,
    load_common_features,
    parse_kv_features,
    subsample_impressions,
    vocab_sizes,
)
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticMultiTask
from recommender_tpu.models.esmm import ESMM, MMOE, MultiTaskBase
from recommender_tpu.models.tasks import (
    evaluate_head,
    init_model,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
)


def _train_mt(model_cls, steps=200, **kw):
    gen = SyntheticMultiTask(seed=0)
    train = gen.sample(16000, seed=1)
    test = gen.sample(4000, seed=2)
    model = model_cls(vocab_sizes=list(gen.vocab_sizes), embed_dim=8, **kw)
    loss_fn, eval_fn = make_multitask_task(model)
    mesh = make_mesh(MeshSpec(8, 1))
    example = {k: v[:8] for k, v in train.items()}
    trainer = Trainer(
        loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9),
        mesh=mesh, eval_fn=eval_fn,
    )
    state = trainer.init_state(lambda: init_model(model, example))
    it = batch_iterator(train, 256, seed=0, epochs=None)
    state, _ = trainer.fit(state, it, steps=steps)

    # ESMM protocol: CVR AUC on clicked subset, CTCVR AUC on impressions
    clicks = click_only(test)
    n_click = (len(clicks["click"]) // 8) * 8
    clicks = {k: v[:n_click] for k, v in clicks.items()}
    cvr_auc = evaluate_head(
        trainer, state, batch_iterator(clicks, 8, shuffle=False),
        make_head_eval(model, "cvr", "purchase"),
    )
    ctcvr_auc = evaluate_head(
        trainer, state, batch_iterator(test, 400, shuffle=False),
        make_head_eval(model, "ctcvr", "purchase"),
    )
    return cvr_auc, ctcvr_auc


def test_esmm_learns():
    cvr_auc, ctcvr_auc = _train_mt(ESMM, mlp_units=(64, 32, 1))
    assert ctcvr_auc > 0.6, (cvr_auc, ctcvr_auc)
    assert cvr_auc > 0.52, (cvr_auc, ctcvr_auc)


def test_mmoe_learns():
    cvr_auc, ctcvr_auc = _train_mt(
        MMOE, num_experts=4, expert_units=(32, 16), tower_units=(16, 1)
    )
    assert ctcvr_auc > 0.6, (cvr_auc, ctcvr_auc)


def test_mmoe_output_contract():
    import jax

    gen = SyntheticMultiTask(num_feats=4, vocab_sizes=(10, 10, 10, 10), seed=0)
    batch = gen.sample(16, seed=1)
    model = MMOE(vocab_sizes=[10] * 4, embed_dim=4, num_experts=3,
                 expert_units=(8, 4), tower_units=(4, 1))
    params, ms = init_model(model, batch)
    heads, _, _ = model.apply(params, ms, batch)
    assert set(heads) == {"ctr", "cvr", "ctcvr"}
    np.testing.assert_allclose(
        np.asarray(heads["ctcvr"]),
        np.asarray(heads["ctr"]) * np.asarray(heads["cvr"]),
        rtol=1e-6,
    )
    for v in heads.values():
        assert (np.asarray(v) >= 0).all() and (np.asarray(v) <= 1).all()


def test_base_protocol_two_models():
    """Base protocol: separate CTR (impressions/click) and CVR (clicks/purchase)
    models; CTCVR = product (esmm/train.py:49-54)."""
    gen = SyntheticMultiTask(seed=0)
    train = gen.sample(8000, seed=1)
    model = MultiTaskBase(vocab_sizes=list(gen.vocab_sizes), embed_dim=8,
                          mlp_units=(32, 2))
    mesh = make_mesh(MeshSpec(8, 1))

    # CTR model on impressions
    ctr_batch = dict(train)
    ctr_batch["label"] = train["click"]
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9),
                 mesh=mesh, eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in ctr_batch.items()}))
    state, _ = tr.fit(state, batch_iterator(ctr_batch, 256, epochs=None), steps=60)
    ev = tr.evaluate(state, batch_iterator(ctr_batch, 400, shuffle=False), limit=5)
    assert ev["eval_auc"] > 0.55, ev


def test_aliccp_raw_parsing():
    kv = parse_kv_features("101\x02v1\x031.0\x01205\x02v2\x032.0")
    assert kv == {"101": "v1", "205": "v2"}

    common = load_common_features(["cf1,2,101\x02u9\x031.0"])
    assert common["cf1"] == {"101": "u9"}

    skel = [
        # id, click, buy, common_key, feat_num, kv
        "1,1,0,cf1,1,205\x02a\x031.0",
        "2,0,1,cf1,1,205\x02b\x031.0",  # click=0 & buy=1 → dropped
        "3,0,0,cf1,1,205\x02a\x031.0",
    ]
    rows = list(join_skeleton(skel, common))
    assert len(rows) == 2
    click, buy, values = rows[0]
    assert (click, buy) == (1, 0)
    assert values[USE_COLUMNS.index("101")] == "u9"  # joined from common
    assert values[USE_COLUMNS.index("205")] == "a"
    assert values[USE_COLUMNS.index("301")] == "0"  # missing → '0'

    vocab = build_feature_vocab([r[2] for r in rows] * 12, min_count=12)
    arrays = encode_rows(rows, vocab)
    assert arrays["features"].shape == (2, 18)
    assert arrays["click"].tolist() == [1.0, 0.0]
    sizes = vocab_sizes(vocab)
    assert all(s >= 1 for s in sizes)


def test_aliccp_subsample_ratio():
    n = 1200
    rng = np.random.default_rng(0)
    arrays = {
        "features": rng.integers(0, 5, size=(n, 18)).astype(np.int32),
        "click": (rng.random(n) < 0.1).astype(np.float32),
        "purchase": np.zeros(n, np.float32),
    }
    sub = subsample_impressions(arrays, ratio=5)
    n_click = int(arrays["click"].sum())
    n_nonclick_kept = int((sub["click"] == 0).sum())
    assert abs(n_nonclick_kept - (n - n_click) / 5) <= 1
    assert int(sub["click"].sum()) == n_click  # all clicks kept
    c = click_only(arrays)
    assert (c["click"] == 1).all()


def test_feature_embedder_per_table_partition(devices8):
    """Planner-style mixed layout: shard large tables, replicate tiny ones."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from recommender_tpu.models.esmm import FeatureEmbedder
    from recommender_tpu.parallel.partitioning import param_pspecs

    sizes = (1024, 16)  # first sharded over 'model', second replicated
    emb = FeatureEmbedder(sizes, embed_dim=4, partition=("model", None))
    feats = jnp.asarray(np.random.default_rng(0).integers(0, 16, (8, 2)), jnp.int32)
    variables = emb.init(jax.random.PRNGKey(0), feats)
    specs = param_pspecs(variables, emb.sharded_params())
    assert specs["feat_0"]["embedding"] == P("model", None)
    assert specs["feat_1"]["embedding"] == P()
    out, _ = emb.apply(variables, feats)
    assert out.shape == (8, 8)


def test_cli_esmm_auto_shard_plan(capsys, devices8):
    """--mesh_model 2 engages the planner; synthetic tiny tables replicate."""
    from recommender_tpu.cli import train_esmm

    train_esmm.main([
        "--synthetic", "--steps", "6", "--log_every", "3", "--eval_every", "0",
        "--model_type", "MMOE", "--embedding_size", "8",
        "--train_batch_size", "64", "--test_batch_size", "128",
        "--mesh_model", "2",
    ])
    out = capsys.readouterr().out
    assert '"shard_plan"' in out and '"final"' in out


def test_stacked_embedder_matches_per_table():
    """Stacked [ΣV, D] lookup == per-table lookups with the same rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recommender_tpu.models.esmm import FeatureEmbedder

    sizes = (7, 13, 5)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(
        np.stack([rng.integers(0, v, 16) for v in sizes], axis=1), jnp.int32
    )
    stacked = FeatureEmbedder(sizes, embed_dim=4, partition=None, stack=True)
    unstacked = FeatureEmbedder(sizes, embed_dim=4, partition=(None,) * 3)
    vs = stacked.init(jax.random.PRNGKey(0), feats)
    table = vs["stacked_embedding"]
    # split the stacked param into the per-table layout
    offs = np.cumsum([0] + list(sizes))
    vu = {
        f"feat_{j}": {"embedding": table[offs[j] : offs[j + 1]]}
        for j in range(3)
    }
    np.testing.assert_allclose(
        stacked.apply(vs, feats)[0], unstacked.apply(vu, feats)[0], rtol=0, atol=0
    )
    # init distribution parity: each segment's scale matches a standalone
    # table of the same shape (fan depends on the table, not the stack)
    solo = FeatureEmbedder((13,), embed_dim=4, stack=True).init(
        jax.random.PRNGKey(1), feats[:, 1:2]
    )["stacked_embedding"]
    seg = np.asarray(table[offs[1] : offs[2]])
    assert abs(seg.std() / np.asarray(solo).std() - 1.0) < 0.35


def test_stacked_embedder_clamps_oov_within_segment():
    """An id >= V_j must clamp to feature j's LAST row (jnp.take per-table
    clip semantics), not bleed into feature j+1's segment."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recommender_tpu.models.esmm import FeatureEmbedder

    sizes = (4, 6)
    emb = FeatureEmbedder(sizes, embed_dim=3, stack=True)
    ok = jnp.asarray([[3, 5]], jnp.int32)  # in-range maxima
    oov = jnp.asarray([[9, 99]], jnp.int32)  # both out of range
    vs = emb.init(jax.random.PRNGKey(0), ok)
    np.testing.assert_array_equal(emb.apply(vs, oov)[0], emb.apply(vs, ok)[0])
    # gradient lands on the clamped rows of each segment, nowhere else
    g = jax.grad(lambda v: jnp.sum(emb.apply(v, oov)[0]))(vs)
    g = np.asarray(g["stacked_embedding"])
    touched = set(np.nonzero(np.abs(g).sum(1))[0].tolist())
    assert touched == {3, 4 + 5}

"""Two-tower retrieval (models/two_tower.py): loss math, learning,
corpus export, query-repr top-k, CLI."""
import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.models.tasks import init_model
from recommender_tpu.models.two_tower import (
    TwoTower,
    corpus_item_reprs,
    interaction_batches,
    make_two_tower_task,
)


def _model(**kw):
    return TwoTower(user_vocab=50, item_vocab=40, embed_dim=8, repr_dim=8,
                    tower_units=(16,), **kw)


def test_inbatch_softmax_loss_math():
    """The per-example loss is exactly -log softmax(logits)[i, i]."""
    m = _model()
    batch = {"user_id": np.arange(6, dtype=np.int32),
             "item_id": np.arange(6, dtype=np.int32)}
    params, ms = init_model(m, batch)
    loss_fn, _ = make_two_tower_task(m)
    per_ex, aux, _ = loss_fn(params, ms, batch, jax.random.PRNGKey(0), False)
    (u, v), _, _ = m.apply(params, ms, batch)
    logits = np.asarray(u @ v.T) / m.temperature
    want = -np.log(np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    np.testing.assert_allclose(
        np.asarray(per_ex), np.diag(want), rtol=1e-4)
    assert 0.0 <= float(aux["inbatch_top1"]) <= 1.0


def test_reprs_are_unit_norm():
    m = _model()
    batch = {"user_id": np.arange(5, dtype=np.int32),
             "item_id": np.arange(5, dtype=np.int32)}
    params, ms = init_model(m, batch)
    (u, v), _, _ = m.apply(params, ms, batch)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(u), axis=1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(v), axis=1), 1.0,
                               rtol=1e-5)


def test_corpus_reprs_match_direct_apply():
    m = _model()
    batch = {"user_id": np.zeros(4, np.int32), "item_id": np.zeros(4, np.int32)}
    params, _ = init_model(m, batch)
    corpus = corpus_item_reprs(m, params, 40, batch_size=16)
    direct = np.asarray(m.item_repr(params, jnp.arange(40)))
    # tolerance: the tower MLP computes in bf16 (nn/mlp.py), and matmul
    # tiling differs between batch shapes → ~1e-3 accumulation noise
    np.testing.assert_allclose(corpus, direct, atol=5e-3)
    assert corpus.shape == (40, 8)


def test_two_tower_learns_communities(devices8):
    """Planted user/item communities: after training, full-corpus
    retrieval recovers intra-community items far above random."""
    from recommender_tpu.cli.train_twotower import _synthetic
    from recommender_tpu.data.movielens import ground_truth_matrix
    from recommender_tpu.retrieval.eval import (
        hit_rate,
        recommend_topk_from_queries,
    )

    g, test_item, seen = _synthetic(seed=0)
    mesh = make_mesh(MeshSpec(8, 1))
    m = TwoTower(user_vocab=g.num_users, item_vocab=g.num_items,
                 embed_dim=16, repr_dim=16, tower_units=(32,))
    loss_fn, eval_fn = make_two_tower_task(m)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9),
                 mesh=mesh, eval_fn=eval_fn)
    it = interaction_batches(g, 256, seed=0)
    state = tr.init_state(lambda: init_model(m, next(it)))
    state, _ = tr.fit(state, it, steps=800)

    reprs = corpus_item_reprs(m, state.params, g.num_items)
    uq = np.asarray(m.user_repr(state.params, jnp.arange(g.num_users)))
    recs = recommend_topk_from_queries(uq, reprs, seen, k=10)
    hr = hit_rate(recs, ground_truth_matrix(test_item, g.num_items))
    # ceiling: the held-out item is 1 of ~14 unseen intra-community items,
    # so perfect community recovery gives hit@10 ≈ 10/14 ≈ 0.7; random is
    # ~0.05. 800 steps lands ~0.35 — this asserts LEARNING (7× random),
    # the quality-grade number is the on-device quality run's job
    assert hr > 0.25, hr
    # seen exclusion holds
    for u in range(0, g.num_users, 37):
        assert not (seen[u][recs[u]]).any()


def test_recommend_from_queries_matches_item_query_form():
    """recommend_topk == recommend_topk_from_queries(item_reprs[latest])."""
    from recommender_tpu.retrieval.eval import (
        recommend_topk,
        recommend_topk_from_queries,
    )

    rng = np.random.default_rng(3)
    V, U, D = 60, 20, 8
    reprs = rng.normal(size=(V, D)).astype(np.float32)
    latest = rng.integers(0, V, U)
    seen = rng.random((U, V)) < 0.1
    a = recommend_topk(reprs, latest, seen, k=5)
    b = recommend_topk_from_queries(reprs[latest], reprs, seen, k=5)
    np.testing.assert_array_equal(a, b)


def test_cli_twotower_smoke(capsys, devices8):
    from recommender_tpu.cli.train_twotower import main

    main([
        "--synthetic", "--steps", "30", "--train_batch_size", "128",
        "--eval_every", "0", "--log_every", "10",
    ])
    out = capsys.readouterr().out
    assert '"hit_rate"' in out and "nan" not in out


def test_cli_twotower_export_roundtrip(tmp_path, capsys, devices8):
    """Exported item-tower bundle serves through the standard stack."""
    from recommender_tpu.cli.train_twotower import main
    from recommender_tpu.retrieval.export import load_serving_bundle, serve_topk

    bundle = tmp_path / "tt.npz"
    main([
        "--synthetic", "--steps", "30", "--train_batch_size", "128",
        "--eval_every", "0", "--log_every", "10",
        "--export", str(bundle), "--export_int8",
    ])
    b = load_serving_bundle(str(bundle))
    assert b["metadata"]["model"] == "two_tower"
    assert b["item_reprs_int8"].shape[0] == 200
    recs = serve_topk(b, np.array([0, 5, 9]), k=5)
    assert recs.shape == (3, 5)

"""PinSage: bipartite sampling, dense-block convolution, end-to-end retrieval."""
import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.movielens import ground_truth_matrix, parse_movielens
from recommender_tpu.graph.bipartite import BipartiteGraph, sample_block_batch
from recommender_tpu.models.pinsage import Convolve, ItemFeatures, PinSage
from recommender_tpu.models.pinsage_task import make_pinsage_task, pinsage_train_batches
from recommender_tpu.models.tasks import init_model
from recommender_tpu.retrieval.eval import full_corpus_reprs, hit_rate, recommend_topk


def _toy_graph(num_users=60, num_items=40, num_comm=4, per_user=8, seed=0):
    """Users interact mostly within their community's item block."""
    rng = np.random.default_rng(seed)
    u_comm = rng.integers(0, num_comm, num_users)
    items_by_comm = np.array_split(np.arange(num_items), num_comm)
    us, its = [], []
    for u in range(num_users):
        pool = items_by_comm[u_comm[u]]
        for _ in range(per_user):
            it = int(rng.choice(pool)) if rng.random() < 0.9 else int(rng.integers(num_items))
            us.append(u)
            its.append(it)
    g = BipartiteGraph(us, its, num_users, num_items)
    feats = ItemFeatures(
        year=rng.integers(0, 5, num_items).astype(np.int32),
        genre=(rng.random((num_items, 6)) < 0.3).astype(np.float32),
    )
    item_comm = np.zeros(num_items, np.int64)
    for c, block in enumerate(items_by_comm):
        item_comm[block] = c
    return g, feats, item_comm


def test_item2item_pairs_metapath():
    g, _, item_comm = _toy_graph()
    rng = np.random.default_rng(0)
    heads, pos, neg = g.item2item_pairs(500, rng)
    assert len(heads) == len(pos) == len(neg)
    # metapath positives should be mostly intra-community
    frac = (item_comm[heads] == item_comm[pos]).mean()
    assert frac > 0.7, frac


def test_importance_neighbors_shapes_and_exclusion():
    g, _, _ = _toy_graph()
    rng = np.random.default_rng(0)
    items = np.arange(10)
    nbr, w = g.importance_neighbors(items, rng=rng, num_walks=8)
    assert nbr.shape == (10, 3) and w.shape == (10, 3)
    # padding slots are self with weight 0
    pad = w == 0
    assert (nbr[pad] == np.repeat(items[:, None], 3, axis=1)[pad]).all()
    # exclusion removes the excluded node from neighbor lists
    excl = nbr[:, 0:1].copy()
    nbr2, w2 = g.importance_neighbors(items, rng=rng, num_walks=8, exclude=excl)
    for i in range(10):
        assert excl[i, 0] not in nbr2[i][w2[i] > 0]


def test_convolve_weighted_mean_numpy():
    layer = Convolve(hidden=4, out=4)
    rng = np.random.default_rng(0)
    dst = jnp.asarray(rng.normal(size=(5, 4)).astype(np.float32))
    nbr = jnp.asarray(rng.normal(size=(5, 3, 4)).astype(np.float32))
    w = jnp.asarray(rng.random((5, 3)).astype(np.float32))
    # key 1: no row's ReLU output is all zero (such a row has no direction
    # to normalize, and keeps norm 0 by the 1e-12 clip)
    params = layer.init(jax.random.PRNGKey(1), dst, nbr, w)
    out = np.asarray(layer.apply(params, dst, nbr, w))
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-5)
    # zero weights → pooled term is zeros; output depends only on dst
    w0 = jnp.zeros_like(w)
    out0a = layer.apply(params, dst, nbr, w0)
    out0b = layer.apply(params, dst, nbr * 100.0, w0)
    np.testing.assert_allclose(np.asarray(out0a), np.asarray(out0b), atol=1e-6)


def test_block_batch_shapes():
    g, _, _ = _toy_graph()
    rng = np.random.default_rng(0)
    block = sample_block_batch(g, np.arange(6, dtype=np.int32), rng)
    assert block.nbr1.shape == (6, 3)
    assert block.flat1.shape == (24,)
    assert block.nbr2.shape == (24, 3)


def test_block_batch_excludes_at_both_layers():
    """Leakage exclusion must hold for layer-2 frontiers too
    (reference removes head<->pos/neg edges from EVERY layer's frontier)."""
    g, _, _ = _toy_graph()
    rng = np.random.default_rng(0)
    nodes = np.arange(8, dtype=np.int32)
    # exclude, per seed, two specific nodes
    exclude = np.stack([(nodes + 1) % g.num_items, (nodes + 2) % g.num_items], axis=1)
    block = sample_block_batch(g, nodes, rng, exclude=exclude)
    T = block.nbr1.shape[1]
    for i in range(len(nodes)):
        banned = set(exclude[i].tolist())
        real1 = block.nbr1[i][block.w1[i] > 0]
        assert not banned & set(real1.tolist())
        # every layer-2 frontier in seed i's group is also clean
        for j in range(1 + T):
            row = i * (1 + T) + j
            real2 = block.nbr2[row][block.w2[row] > 0]
            assert not banned & set(real2.tolist())


def test_pinsage_trains_and_retrieves():
    g, feats, item_comm = _toy_graph()
    model = PinSage(features=feats, embed_dim=8, conv_hidden=16, conv_out=16)
    loss_fn = make_pinsage_task(model)
    mesh = make_mesh(MeshSpec(8, 1))
    it = pinsage_train_batches(g, batch_size=32, seed=0)
    example = next(it)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9), mesh=mesh)
    state = trainer.init_state(lambda: init_model(model, example))
    state, hist = trainer.fit(state, it, steps=120)

    rng = np.random.default_rng(1)
    reprs = full_corpus_reprs(model, state.params, g, rng, batch_size=40)
    assert reprs.shape == (g.num_items, 16)
    # items in the same community should be closer than across communities
    sims = reprs @ reprs.T
    intra = sims[item_comm[:, None] == item_comm[None, :]].mean()
    inter = sims[item_comm[:, None] != item_comm[None, :]].mean()
    assert intra > inter, (intra, inter)

    # retrieval path: recommend unseen items for each user's latest item
    latest = np.zeros(g.num_users, np.int64)
    seen = np.zeros((g.num_users, g.num_items), bool)
    recs = recommend_topk(reprs, latest, seen, k=5)
    assert recs.shape == (g.num_users, 5)
    gt = ground_truth_matrix(np.zeros(g.num_users, np.int64), g.num_items)
    hr = hit_rate(recs, gt)
    assert 0.0 <= hr <= 1.0


def test_recommend_topk_idlist_mask_matches_dense():
    """The serving-scale seen form (padded [U, S] id lists, pad -1) gives
    the SAME recommendations as the dense [U, V] bool mask."""
    import numpy as np

    from recommender_tpu.retrieval.eval import recommend_topk

    rng = np.random.default_rng(3)
    U, V, D, S = 64, 200, 16, 12
    reprs = rng.normal(size=(V, D)).astype(np.float32)
    latest = rng.integers(0, V, U)
    dense = np.zeros((U, V), bool)
    lists = np.full((U, S), -1, np.int32)
    for u in range(U):
        ids = rng.choice(V, size=rng.integers(1, S), replace=False)
        dense[u, ids] = True
        lists[u, : len(ids)] = ids
    recs_d = recommend_topk(reprs, latest, dense, k=5, batch_size=17)
    recs_l = recommend_topk(reprs, latest, lists, k=5, batch_size=17)
    np.testing.assert_array_equal(recs_d, recs_l)
    for u in range(U):
        assert not set(recs_l[u]) & set(lists[u][lists[u] >= 0].tolist())


def test_movielens_parsing_and_split():
    movies = [
        "1::Toy Story (1995)::Animation|Children's|Comedy",
        "2::Jumanji (1995)::Adventure|Children's|Fantasy",
        "3::Heat (1995)::Action|Crime|Thriller",
        "4::Old (1911)::Drama",
    ]
    ratings = [
        # user 1: 4 interactions (timestamps ordered oddly on purpose)
        "1::1::5::100", "1::2::4::300", "1::3::3::200", "1::4::5::400",
        # user 2: only 2 interactions → no val/test
        "2::1::4::100", "2::2::3::200",
    ]
    data = parse_movielens(ratings, movies)
    assert data.num_items == 4 and data.num_users == 2
    assert data.features.genre.shape[1] == 9  # distinct genres
    # user 0: ts order 1(100) < 3(200) < 2(300) < 4(400)
    assert data.test_user_item[0] == 3  # movie 4 → idx 3 (last)
    assert data.val_user_item[0] == 1  # movie 2 → idx 1 (second-to-last)
    assert data.latest_train_item[0] == 2  # movie 3 → idx 2
    assert data.test_user_item[1] == -1  # too few interactions
    # train graph excludes held-out edges of user 0
    nbrs = data.graph.u2i_indices[
        data.graph.u2i_indptr[0] : data.graph.u2i_indptr[1]
    ]
    assert set(nbrs.tolist()) == {0, 2}
    gt = ground_truth_matrix(data.test_user_item, data.num_items)
    assert gt[0, 3] == 1 and gt.sum() == 1


def test_sharded_corpus_eval_matches_single_device(devices8):
    """retrieval.eval's mesh= path (corpus blocks / user rows sharded over
    the data axis, items replicated) returns the SAME reprs and top-k as
    the single-device path — the multi-chip serving contract the module
    docstring advertises."""
    g, feats, _ = _toy_graph()
    model = PinSage(features=feats, embed_dim=8, conv_hidden=16, conv_out=8)
    batch = next(pinsage_train_batches(g, 8, seed=0))
    params, _ = init_model(model, batch)

    reprs_1 = full_corpus_reprs(
        model, params, g, np.random.default_rng(1), batch_size=16)
    mesh = make_mesh(MeshSpec(8, 1))
    reprs_8 = full_corpus_reprs(
        model, params, g, np.random.default_rng(1), batch_size=16, mesh=mesh)
    np.testing.assert_allclose(reprs_1, reprs_8, rtol=2e-5, atol=1e-6)

    U = g.num_users
    rng = np.random.default_rng(2)
    latest = rng.integers(0, g.num_items, U)
    seen = np.zeros((U, g.num_items), bool)
    seen[rng.integers(0, U, 50), rng.integers(0, g.num_items, 50)] = True
    # U=60 is NOT a multiple of 8: exercises the tail-padding path
    recs_1 = recommend_topk(reprs_1, latest, seen, k=5, batch_size=32)
    recs_8 = recommend_topk(reprs_1, latest, seen, k=5, batch_size=32, mesh=mesh)
    np.testing.assert_array_equal(recs_1, recs_8)

    import pytest
    with pytest.raises(ValueError, match="must divide"):
        full_corpus_reprs(model, params, g, np.random.default_rng(1),
                          batch_size=12, mesh=mesh)

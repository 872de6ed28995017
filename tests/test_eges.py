"""EGES family: model contracts, metadata prep parity, link-pred learning floor."""
import json

import jax
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.amazon_meta import (
    build_train_graph,
    build_vocab,
    link_prediction_triples,
    load_metadata,
    side_info_arrays,
    train_test_split,
)
from recommender_tpu.graph.store import WeightedGraph
from recommender_tpu.graph.walks import skipgram_batches
from recommender_tpu.models.eges import EGES, GES, DeepWalk
from recommender_tpu.models.tasks import (
    init_model,
    link_prediction_auc,
    make_skipgram_task,
)


def _community_graph(num_nodes=200, num_comm=8, edges_per_node=12, seed=0):
    """Nodes 1..V-1 in communities; ~90% of edges intra-community."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_comm, size=num_nodes)
    by_comm = [np.where(comm == c)[0] for c in range(num_comm)]
    src, dst = [], []
    for v in range(1, num_nodes):
        pool = by_comm[comm[v]]
        for _ in range(edges_per_node):
            if rng.random() < 0.9 and len(pool) > 1:
                u = int(rng.choice(pool))
            else:
                u = int(rng.integers(1, num_nodes))
            if u != v and u != 0:
                src += [v, u]
                dst += [u, v]
    g = WeightedGraph.from_edges(src, dst, num_nodes=num_nodes)
    return g, comm


def test_metadata_prep_parity():
    lines = [
        json.dumps({"asin": "A", "main_cat": "cat1", "brand": "b1", "also_buy": ["B", "C"]}),
        json.dumps({"asin": "B", "main_cat": "cat1", "brand": "b2", "also_buy": ["A"]}),
        json.dumps({"asin": "C", "main_cat": "cat2", "brand": "b1", "also_buy": []}),
        json.dumps({"asin": "D", "main_cat": "cat2", "brand": "b3", "also_buy": ["Z"]}),  # Z unknown → dropped
    ]
    pairs, i2c, i2b = load_metadata(lines)
    # one direction per undirected pair; A-B counted from both sides → max=2
    keys = set(pairs)
    assert ("A", "B") in keys or ("B", "A") in keys
    ab = pairs.get(("A", "B"), pairs.get(("B", "A")))
    assert ab == 2
    ac = pairs.get(("A", "C"), pairs.get(("C", "A")))
    assert ac == 1
    assert not any("Z" in k for k in keys)

    train_p, test_p = train_test_split(pairs, seed=0)
    assert len(train_p) + len(test_p) == len(pairs)

    item2idx, cat_vocab, brand_vocab = build_vocab(list(pairs), pairs, i2c, i2b)
    assert item2idx[""] == 0
    # highest-degree item gets index 1 (in-degree ordering)
    degs = {}
    for (a, b), c in pairs.items():
        degs[a] = degs.get(a, 0) + c
        degs[b] = degs.get(b, 0) + c
    top = max(degs, key=degs.get)
    assert item2idx[top] == 1

    side = side_info_arrays(item2idx, cat_vocab, brand_vocab, i2c, i2b)
    assert side["cat"][0] == 0  # OOV row
    assert side["cat"][item2idx["A"]] == cat_vocab["cat1"]

    g = build_train_graph(list(pairs), pairs, item2idx)
    assert g.num_nodes == len(item2idx)

    rng = np.random.default_rng(0)
    triples = link_prediction_triples(list(pairs), item2idx, rng, side)
    assert set(triples) >= {"query", "pos", "neg", "query_cat", "neg_brand"}


def test_model_contracts():
    batch = {
        "target": np.array([1, 2], np.int32),
        "target_cat": np.array([1, 1], np.int32),
        "target_brand": np.array([2, 0], np.int32),
        "context": np.array([[1, 3, 4], [2, 5, 6]], np.int32),
        "label": np.array([[1, 0, 0], [1, 0, 0]], np.float32),
    }
    for model in [
        DeepWalk(vocab_size=10, embed_dim=4),
        GES(vocab_size=10, cat_vocab=5, brand_vocab=5, embed_dim=4),
        EGES(vocab_size=10, cat_vocab=5, brand_vocab=5, embed_dim=4),
    ]:
        params, ms = init_model(model, batch)
        logits, _, _ = model.apply(params, ms, batch)
        assert logits.shape == (2, 3)
        hidden = model.get_hidden(params, batch)
        assert hidden.shape == (2, 4)

    # EGES with uniform weight table == GES mean when weights are all equal
    ges = GES(vocab_size=10, cat_vocab=5, brand_vocab=5, embed_dim=4)
    g_params, _ = init_model(ges, batch)
    eges = EGES(vocab_size=10, cat_vocab=5, brand_vocab=5, embed_dim=4)
    e_params, _ = init_model(eges, batch)
    e_params = dict(e_params)
    for k in ("id_embedding", "cat_embedding", "brand_embedding", "output_embedding"):
        e_params[k] = g_params[k]
    e_params["weight_embedding"] = jax.tree_util.tree_map(
        lambda x: np.zeros_like(x), e_params["weight_embedding"]
    )
    h_ges = ges.get_hidden(g_params, batch)
    h_eges = eges.get_hidden(e_params, batch)
    np.testing.assert_allclose(np.asarray(h_ges), np.asarray(h_eges), rtol=1e-4, atol=1e-6)


def _train_eges(model, g, side, steps=200):
    loss_fn, eval_fn = make_skipgram_task(model)
    mesh = make_mesh(MeshSpec(8, 1))
    it = skipgram_batches(
        g, walk_length=8, window=3, num_negatives=5, batch_size=512,
        walks_per_round=64, side_info=side, seed=0,
    )
    example = next(it)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=5e-3, log_every=10**9),
                      mesh=mesh, eval_fn=eval_fn)
    state = trainer.init_state(lambda: init_model(model, example))
    state, _ = trainer.fit(state, it, steps=steps)
    return state


def test_deepwalk_link_prediction_learns():
    g, comm = _community_graph()
    model = DeepWalk(vocab_size=g.num_nodes, embed_dim=16)
    state = _train_eges(model, g, side=None, steps=600)
    # held-out "edges": intra-community pairs; negatives: random nodes
    rng = np.random.default_rng(1)
    qs, ps, ns = [], [], []
    for _ in range(2000):
        c = rng.integers(0, 8)
        pool = np.where(comm == c)[0]
        pool = pool[pool > 0]
        if len(pool) < 2:
            continue
        a, b = rng.choice(pool, 2, replace=False)
        qs.append(a)
        ps.append(b)
        ns.append(rng.integers(1, g.num_nodes))
    triples = {
        "query": np.array(qs, np.int32),
        "pos": np.array(ps, np.int32),
        "neg": np.array(ns, np.int32),
    }
    auc = link_prediction_auc(model, state.params, triples)
    assert auc > 0.75, auc

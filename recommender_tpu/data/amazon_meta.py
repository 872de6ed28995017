"""Amazon Electronics metadata → co-occurrence graph + vocabs (EGES prep).

Behavioral parity with ``eges/util.py``:
* ``load_metadata`` — JSON-lines with ``asin``/``main_cat``/``brand``/
  ``also_buy``; symmetric pair counts keeping max(count, reverse count)
  per undirected pair, co-occurrence restricted to items with metadata
  (``eges/util.py:9-51``).
* ``train_test_split`` — shuffled 2/3–1/3 edge split (``:54-60``).
* ``build_vocab`` — items ordered by descending weighted in-degree, index
  0 = '' OOV row (``:63-113``); this ordering is what makes the
  log-uniform negative sampler's Zipf assumption hold (SURVEY.md §7
  parity traps). Cat/brand vocabs from train items, 0 = OOV.
* ``build_train_graph`` — symmetric weighted digraph (``:116-132``) as a
  ``WeightedGraph`` CSR instead of DGL.
"""
from __future__ import annotations

import json
from typing import Iterable

import numpy as np

from recommender_tpu.graph.store import WeightedGraph


def load_metadata(lines: Iterable[str]):
    """Returns (pair_counts {(a,b): max-count, one direction per pair},
    item2cat, item2brand)."""
    item2cat, item2brand = {}, {}
    records = []
    for line in lines:
        ex = json.loads(line)
        item2cat[ex["asin"]] = ex.get("main_cat", "")
        item2brand[ex["asin"]] = ex.get("brand", "")
        records.append((ex["asin"], ex.get("also_buy") or []))
    sym_counts: dict[tuple, int] = {}
    for item, co_items in records:
        for co in co_items:
            if co in item2cat:
                for pair in ((item, co), (co, item)):
                    sym_counts[pair] = sym_counts.get(pair, 0) + 1
    pair_counts: dict[tuple, int] = {}
    for (a, b), count in sym_counts.items():
        if (b, a) not in pair_counts:
            pair_counts[(a, b)] = max(count, sym_counts[(b, a)])
    return pair_counts, item2cat, item2brand


def train_test_split(pair_counts: dict, seed: int = 0):
    pairs = sorted(pair_counts.keys())
    rng = np.random.default_rng(seed)
    rng.shuffle(pairs)
    n_train = len(pairs) * 2 // 3
    return pairs[:n_train], pairs[n_train:]


def build_vocab(train_pairs, pair_counts, item2cat, item2brand):
    """Items ranked by descending weighted degree; '' is index 0 (OOV)."""
    degree: dict[str, int] = {}
    for a, b in train_pairs:
        c = pair_counts[(a, b)]
        degree[a] = degree.get(a, 0) + c
        degree[b] = degree.get(b, 0) + c
    ranked = sorted(degree.items(), key=lambda kv: -kv[1])
    item2idx = {"": 0}
    for idx, (item, _) in enumerate(ranked, start=1):
        item2idx[item] = idx

    cats = sorted({item2cat[i] for i in degree if i in item2cat})
    brands = sorted({item2brand[i] for i in degree if i in item2brand})
    cat_vocab = {"": 0, **{c: i for i, c in enumerate(cats, start=1)}}
    brand_vocab = {"": 0, **{b: i for i, b in enumerate(brands, start=1)}}
    return item2idx, cat_vocab, brand_vocab


def side_info_arrays(item2idx, cat_vocab, brand_vocab, item2cat, item2brand):
    """Dense idx → cat/brand idx arrays for vectorized batch assembly."""
    n = len(item2idx)
    cat_arr = np.zeros(n, np.int32)
    brand_arr = np.zeros(n, np.int32)
    for item, idx in item2idx.items():
        cat_arr[idx] = cat_vocab.get(item2cat.get(item, ""), 0)
        brand_arr[idx] = brand_vocab.get(item2brand.get(item, ""), 0)
    return {"cat": cat_arr, "brand": brand_arr}


def build_train_graph(train_pairs, pair_counts, item2idx) -> WeightedGraph:
    src, dst, w = [], [], []
    for a, b in train_pairs:
        c = float(pair_counts[(a, b)])
        src += [item2idx[a], item2idx[b]]
        dst += [item2idx[b], item2idx[a]]
        w += [c, c]
    return WeightedGraph.from_edges(src, dst, w, num_nodes=len(item2idx))


def link_prediction_triples(
    test_pairs, item2idx, rng: np.random.Generator, side_info: dict | None = None
) -> dict:
    """Held-out edges + 1 uniform negative each → eval triples
    (``eges/data_loader.py:64-83``). Unknown items map to the OOV row 0
    (the cold-start policy, ``eges/README.md:16-17``)."""
    items = [i for i in item2idx if i != ""]
    q = np.array([item2idx.get(a, 0) for a, b in test_pairs], np.int32)
    p = np.array([item2idx.get(b, 0) for a, b in test_pairs], np.int32)
    neg_items = rng.choice(len(items), size=len(test_pairs))
    n = np.array([item2idx[items[j]] for j in neg_items], np.int32)
    out = {"query": q, "pos": p, "neg": n}
    if side_info:
        for name, arr in side_info.items():
            out[f"query_{name}"] = arr[q]
            out[f"pos_{name}"] = arr[p]
            out[f"neg_{name}"] = arr[n]
    return out

"""MovieLens-1M preprocessing for PinSage.

Behavioral parity with ``pinsage/train/process_movielens.py``
+ ``graph_builder.py`` + ``util.py`` without pandas/DGL/pickle:

* parse ``users.dat`` / ``movies.dat`` / ``ratings.dat`` ('::' separated);
* item features: year bucketized to an index, genre multi-hot
  (``process_movielens.py`` feature assignment);
* per-user **leave-last-two** temporal split: last interaction → test,
  second-to-last → validation, rest → train (``util.py:5-24``);
* sparse user×item 0/1 matrices for val/test (``util.py:27-39``);
* the train interactions become a ``BipartiteGraph`` with rating/timestamp
  edge data (the ``dgl.heterograph`` replacement).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from recommender_tpu.graph.bipartite import BipartiteGraph
from recommender_tpu.models.pinsage import ItemFeatures


@dataclasses.dataclass
class MovieLensData:
    graph: BipartiteGraph  # train interactions
    features: ItemFeatures
    num_users: int
    num_items: int
    val_user_item: np.ndarray  # [U] item idx (second-to-last), -1 if none
    test_user_item: np.ndarray  # [U] item idx (last), -1 if none
    latest_train_item: np.ndarray  # [U] most recent train item per user
    train_seen: np.ndarray  # [U, V] bool


def parse_movielens(
    ratings_lines, movies_lines, min_year: int = 1900
) -> MovieLensData:
    # movies.dat: MovieID::Title (Year)::Genre|Genre...
    movie_ids, years, genre_lists = [], [], []
    genre_set = set()
    for line in movies_lines:
        mid, title, genres = line.rstrip("\n").split("::")
        movie_ids.append(int(mid))
        y = title.rstrip()[-5:-1]
        years.append(int(y) if y.isdigit() else min_year)
        gl = genres.split("|")
        genre_lists.append(gl)
        genre_set.update(gl)
    genre_vocab = {g: i for i, g in enumerate(sorted(genre_set))}
    id_map = {m: i for i, m in enumerate(movie_ids)}
    V = len(movie_ids)
    year_arr = np.asarray(years)
    year_idx = (year_arr - year_arr.min()).astype(np.int32)
    genre_mh = np.zeros((V, len(genre_vocab)), np.float32)
    for i, gl in enumerate(genre_lists):
        for g in gl:
            genre_mh[i, genre_vocab[g]] = 1.0
    features = ItemFeatures(year=year_idx, genre=genre_mh)

    # ratings.dat: UserID::MovieID::Rating::Timestamp
    users, items, ratings, ts = [], [], [], []
    for line in ratings_lines:
        u, m, r, t = line.rstrip("\n").split("::")
        if int(m) not in id_map:
            continue
        users.append(int(u) - 1)
        items.append(id_map[int(m)])
        ratings.append(int(r))
        ts.append(int(t))
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    ratings = np.asarray(ratings, np.int32)
    ts = np.asarray(ts, np.int64)
    U = int(users.max()) + 1 if len(users) else 0

    # leave-last-two split per user, by timestamp order
    order = np.lexsort((ts, users))
    users_s, items_s, ratings_s, ts_s = (
        users[order], items[order], ratings[order], ts[order],
    )
    val_item = np.full(U, -1, np.int64)
    test_item = np.full(U, -1, np.int64)
    latest_train = np.zeros(U, np.int64)
    train_mask = np.ones(len(users_s), bool)
    starts = np.searchsorted(users_s, np.arange(U))
    ends = np.searchsorted(users_s, np.arange(U), side="right")
    for u in range(U):
        s, e = starts[u], ends[u]
        cnt = e - s
        if cnt >= 3:
            test_item[u] = items_s[e - 1]
            val_item[u] = items_s[e - 2]
            train_mask[e - 1] = False
            train_mask[e - 2] = False
            latest_train[u] = items_s[e - 3]
        elif cnt > 0:
            latest_train[u] = items_s[e - 1]

    tr_u, tr_i = users_s[train_mask], items_s[train_mask]
    graph = BipartiteGraph(
        tr_u, tr_i, U, V,
        edge_data={"rating": ratings_s[train_mask], "timestamp": ts_s[train_mask]},
    )
    seen = np.zeros((U, V), bool)
    seen[tr_u, tr_i] = True
    return MovieLensData(
        graph=graph,
        features=features,
        num_users=U,
        num_items=V,
        val_user_item=val_item,
        test_user_item=test_item,
        latest_train_item=latest_train,
        train_seen=seen,
    )


def ground_truth_matrix(user_item: np.ndarray, num_items: int) -> np.ndarray:
    """[U] held-out item per user → [U, V] 0/1 matrix (util.py:27-39)."""
    U = len(user_item)
    m = np.zeros((U, num_items), np.int8)
    valid = user_item >= 0
    m[np.nonzero(valid)[0], user_item[valid]] = 1
    return m

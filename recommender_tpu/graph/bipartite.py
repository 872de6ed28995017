"""Bipartite user–item graph store + PinSAGE importance sampling (host side).

Replacement for DGL's heterograph machinery in
``pinsage/train/data_loader.py``:

* ``BipartiteGraph``      — user→item and item→user CSRs with edge data
  (rating/timestamp), replacing ``dgl.heterograph``.
* ``item2item_pairs``     — the item→user→item metapath random walk that
  produces positive co-interaction pairs (``data_loader.py:6-18``);
  -1 walks masked out.
* ``importance_neighbors``/``sample_block_batch`` — the PinSAGE sampler
  (``data_loader.py:21-51``): per dst item, ``num_walks`` random walks of
  ``walk_length`` item→user→item hops with per-hop termination, visit
  counts of encountered items → top-``num_neighbors`` neighbors with the
  counts as importance weights. Leakage parity: the head↔pos-tail and
  head↔neg-tail links are excluded from sampled frontiers
  (``data_loader.py:34-39``) by zero-weighting them.

Output is a **fixed-shape dense block batch** (padded neighbor tensors),
the shape contract the jittable on-chip Convolve needs — no ragged DGL
blocks (SURVEY.md §7 "Dynamic-shape elimination for PinSage").
"""
from __future__ import annotations

import dataclasses

import numpy as np


class BipartiteGraph:
    """CSRs in both directions over (user, item) interactions."""

    def __init__(self, users, items, num_users, num_items, edge_data=None, use_native=None):
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        self.num_users = num_users
        self.num_items = num_items
        self.edge_data = edge_data or {}
        from recommender_tpu.graph import native

        if use_native is None:
            use_native = native.is_available()
        self.native = use_native and native.is_available()

        order = np.argsort(users, kind="stable")
        self.u2i_indptr = _indptr(users[order], num_users)
        self.u2i_indices = items[order].astype(np.int32)
        self._u2i_perm = order  # original edge index per CSR slot

        order_i = np.argsort(items, kind="stable")
        self.i2u_indptr = _indptr(items[order_i], num_items)
        self.i2u_indices = users[order_i].astype(np.int32)
        self._i2u_perm = order_i

    # -------------------------------------------------------------- sampling
    def _step_i2u2i(self, items: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """One item→user→item metapath hop, uniform, vectorized. -1 = dead end."""
        users = _uniform_neighbor(self.i2u_indptr, self.i2u_indices, items, rng)
        nxt = np.full_like(items, -1)
        alive = users >= 0
        if alive.any():
            nxt[alive] = _uniform_neighbor(
                self.u2i_indptr, self.u2i_indices, users[alive], rng
            )
        return nxt

    def item2item_pairs(self, batch_size: int, rng: np.random.Generator):
        """(heads, pos_tails, neg_tails), -1 walks dropped (``data_loader.py:6-18``)."""
        heads = rng.integers(0, self.num_items, size=batch_size)
        pos = self._step_i2u2i(heads, rng)
        neg = rng.integers(0, self.num_items, size=batch_size)
        mask = pos >= 0
        return (
            heads[mask].astype(np.int32),
            pos[mask].astype(np.int32),
            neg[mask].astype(np.int32),
        )

    def importance_neighbors(
        self,
        items: np.ndarray,
        *,
        num_neighbors: int = 3,
        num_walks: int = 4,
        walk_length: int = 2,
        termination_prob: float = 0.5,
        rng: np.random.Generator,
        exclude: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-T visit-count neighbors per item → ([N, T] ids, [N, T] weights).

        Padding: unused slots carry the item itself with weight 0 (so the
        on-chip weighted sum is exact without masking logic).
        ``exclude`` [N, E]: per-item node ids whose visits are discarded
        (leakage-edge removal).
        """
        items = np.asarray(items, np.int64)
        N = len(items)
        if self.native:
            from recommender_tpu.graph import native

            return native.pinsage_importance_neighbors(
                self.i2u_indptr, self.i2u_indices,
                self.u2i_indptr, self.u2i_indices,
                items, num_neighbors, num_walks, walk_length,
                termination_prob, int(rng.integers(1 << 62)),
                exclude=exclude,
            )
        counts: list[dict[int, int]] = [dict() for _ in range(N)]
        for _ in range(num_walks):
            cur = items.copy()
            for _hop in range(walk_length):
                alive = cur >= 0
                if not alive.any():
                    break
                nxt = np.full_like(cur, -1)
                nxt[alive] = self._step_i2u2i(cur[alive], rng)
                visited = (nxt >= 0) & (nxt != items)
                for i in np.nonzero(visited)[0]:
                    v = int(nxt[i])
                    counts[i][v] = counts[i].get(v, 0) + 1
                cur = nxt
                # per-hop termination AFTER the visit is counted
                # (PinSAGESampler restart semantics)
                if termination_prob > 0 and _hop + 1 < walk_length:
                    stop = rng.random(N) < termination_prob
                    cur = np.where(stop, -1, cur)
        nbr = np.repeat(items[:, None], num_neighbors, axis=1).astype(np.int32)
        w = np.zeros((N, num_neighbors), np.float32)
        for i in range(N):
            c = counts[i]
            if exclude is not None:
                for e in np.atleast_1d(exclude[i]):
                    c.pop(int(e), None)
            top = sorted(c.items(), key=lambda kv: -kv[1])[:num_neighbors]
            for j, (v, cnt) in enumerate(top):
                nbr[i, j] = v
                w[i, j] = cnt
        return nbr, w


@dataclasses.dataclass
class BlockBatch:
    """Dense 2-layer PinSAGE computation tree (fixed shapes).

    ``nodes``  [N]        — items whose final repr is wanted
    ``nbr1``   [N, T]     — importance neighbors of ``nodes`` (+ weights ``w1``)
    ``flat1``  [N*(1+T)]  — nodes ∪ nbr1 (the set needing layer-1 reprs)
    ``nbr2``   [N*(1+T), T] — importance neighbors of ``flat1`` (+ ``w2``)
    """

    nodes: np.ndarray
    nbr1: np.ndarray
    w1: np.ndarray
    flat1: np.ndarray
    nbr2: np.ndarray
    w2: np.ndarray

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def sample_block_batch(
    g: BipartiteGraph,
    nodes: np.ndarray,
    rng: np.random.Generator,
    *,
    num_neighbors: int = 3,
    num_walks: int = 4,
    walk_length: int = 2,
    termination_prob: float = 0.5,
    exclude: np.ndarray | None = None,
) -> BlockBatch:
    nodes = np.asarray(nodes, np.int32)
    kw = dict(
        num_neighbors=num_neighbors,
        num_walks=num_walks,
        walk_length=walk_length,
        termination_prob=termination_prob,
        rng=rng,
    )
    nbr1, w1 = g.importance_neighbors(nodes, exclude=exclude, **kw)
    flat1 = np.concatenate([nodes[:, None], nbr1], axis=1).reshape(-1)
    # leakage exclusion must hold at EVERY layer (the reference removes the
    # head↔pos/neg edges from each per-layer frontier,
    # data_loader.py:32-39): broadcast each seed's exclusion set to its
    # whole layer-2 group (seed + its sampled neighbors) — conservative
    # superset of the reference's per-edge removal, zero leakage.
    exclude2 = (
        np.repeat(np.atleast_2d(exclude), 1 + num_neighbors, axis=0)
        if exclude is not None
        else None
    )
    nbr2, w2 = g.importance_neighbors(flat1, exclude=exclude2, **kw)
    return BlockBatch(nodes, nbr1, w1, flat1.astype(np.int32), nbr2, w2)


def _indptr(sorted_keys, n):
    counts = np.bincount(sorted_keys, minlength=n)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _uniform_neighbor(indptr, indices, nodes, rng):
    deg = indptr[nodes + 1] - indptr[nodes]
    u = rng.random(len(nodes))
    j = np.minimum((u * np.maximum(deg, 1)).astype(np.int64), np.maximum(deg - 1, 0))
    pos = np.minimum(indptr[nodes] + j, len(indices) - 1)
    return np.where(deg > 0, indices[pos], -1).astype(np.int64)

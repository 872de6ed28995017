"""Jittable streaming metrics (AUC, accuracy, mean) with cross-host reduction.

Replacement for the reference's ``keras.metrics.AUC`` /
``BinaryAccuracy`` / ``Mean`` C++ kernels (used at ``ctr/train.py:86``,
``dien/train.py:43-44``, ``esmm/train.py:56-61``, ``eges/train.py:96``,
``pinsage/train/train.py:10``). The reference sets ``num_thresholds`` up to
20000 (``dien/train.py:43``); we default to 8192 histogram bins, which matches
keras' interpolated-threshold AUC to ~1e-4 on typical score distributions.

Design: the metric *state* is a tiny pytree of histograms that lives on
device, is updated inside the jitted eval step (so evaluation never leaves
the device), is summed over the ``data`` mesh axis for free by replication
semantics (each device sees the full batch slice; states are added), and is
finalized on host with a closed-form trapezoid.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

DEFAULT_BINS = 8192


class AUCState(NamedTuple):
    """Histogram sufficient statistics for ROC-AUC."""

    pos: jnp.ndarray  # [bins] weight of positive examples per score bin
    neg: jnp.ndarray  # [bins] weight of negative examples per score bin

    @staticmethod
    def init(bins: int = DEFAULT_BINS, dtype=jnp.float32) -> "AUCState":
        z = jnp.zeros((bins,), dtype)
        return AUCState(pos=z, neg=z)

    def merge(self, other: "AUCState") -> "AUCState":
        return AUCState(self.pos + other.pos, self.neg + other.neg)


def auc_update(
    state: AUCState,
    scores: jnp.ndarray,
    labels: jnp.ndarray,
    weights: jnp.ndarray | None = None,
) -> AUCState:
    """Accumulate a batch of ``scores`` in [0, 1] against binary ``labels``.

    Pure and jittable; safe inside ``lax.scan`` eval loops.
    """
    bins = state.pos.shape[0]
    scores = scores.reshape(-1).astype(jnp.float32)
    labels = labels.reshape(-1).astype(jnp.float32)
    w = (
        jnp.ones_like(scores)
        if weights is None
        else weights.reshape(-1).astype(jnp.float32)
    )
    idx = jnp.clip((scores * bins).astype(jnp.int32), 0, bins - 1)
    pos = state.pos.at[idx].add(labels * w)
    neg = state.neg.at[idx].add((1.0 - labels) * w)
    return AUCState(pos, neg)


@jax.jit
def _auc_from_hists(pos: jnp.ndarray, neg: jnp.ndarray) -> jnp.ndarray:
    total_pos = jnp.sum(pos)
    total_neg = jnp.sum(neg)
    # neg mass strictly below each bin
    neg_below = jnp.cumsum(neg) - neg
    wins = jnp.sum(pos * neg_below)
    ties = jnp.sum(pos * neg)
    denom = jnp.maximum(total_pos * total_neg, 1.0)
    return (wins + 0.5 * ties) / denom


def auc_from_state(state: AUCState) -> jnp.ndarray:
    """Closed-form ROC-AUC from score histograms.

    AUC = P(score_pos > score_neg) + 0.5 * P(tie), computed exactly on the
    binned distribution (equivalent to trapezoidal ROC integration over one
    threshold per bin edge). The reduction is jitted rather than eager:
    eager host-side ops have crashed flakily (SIGABRT in the XLA CPU ufunc
    path on the 8-virtual-device mesh).
    """
    return _auc_from_hists(state.pos, state.neg)


class MeanState(NamedTuple):
    total: jnp.ndarray
    count: jnp.ndarray

    @staticmethod
    def init(dtype=jnp.float32) -> "MeanState":
        return MeanState(jnp.zeros((), dtype), jnp.zeros((), dtype))

    def merge(self, other: "MeanState") -> "MeanState":
        return MeanState(self.total + other.total, self.count + other.count)


def mean_update(state: MeanState, values: jnp.ndarray, weights=None) -> MeanState:
    values = values.reshape(-1).astype(jnp.float32)
    w = jnp.ones_like(values) if weights is None else weights.reshape(-1)
    return MeanState(state.total + jnp.sum(values * w), state.count + jnp.sum(w))


def mean_from_state(state: MeanState) -> jnp.ndarray:
    return state.total / jnp.maximum(state.count, 1.0)


def accuracy_update(
    state: MeanState, scores: jnp.ndarray, labels: jnp.ndarray, threshold=0.5
) -> MeanState:
    pred = (scores.reshape(-1) >= threshold).astype(jnp.float32)
    correct = (pred == labels.reshape(-1).astype(jnp.float32)).astype(jnp.float32)
    return mean_update(state, correct)


def exact_auc(scores, labels, weights=None) -> float:
    """Exact (sort-based, tie-averaged) ROC-AUC on the host.

    The histogram ``AUCState`` (8192 bins, error ≲2e-3) is fine for in-loop
    eval but too coarse to certify parity targets whose separations are the
    same order (DIN−BASE = 1.3e-3, BASELINE.md) — the reference uses 20000
    interpolated thresholds (``dien/train.py:43``). Final evals therefore
    gather scores to host and compute the exact Mann-Whitney U statistic:

        AUC = (Σ_pos rank_avg − P(P+1)/2) / (P·N)

    with average ranks over ties — the limit the reference's thresholded
    metric approaches as thresholds → ∞. O(n log n).
    """
    import numpy as np

    s = np.asarray(scores, np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1) > 0.5
    w = None if weights is None else np.asarray(weights, np.float64).reshape(-1)
    if w is None:
        _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
        cum = np.cumsum(counts)
        avg_rank = (cum - counts + 1 + cum) / 2.0  # 1-based average rank
        r = avg_rank[inv]
        p = float(y.sum())
        n = float(y.size - p)
        if p == 0 or n == 0:
            return 0.5
        u = float(r[y].sum()) - p * (p + 1) / 2.0
        return u / (p * n)
    # weighted: P(s_pos > s_neg) + 0.5 P(tie) over example weights
    order = np.argsort(s, kind="mergesort")
    s, y, w = s[order], y[order], w[order]
    wp = np.where(y, w, 0.0)
    wn = np.where(y, 0.0, w)
    # group ties: boundaries where the score changes
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] != s[:-1]
    gid = np.cumsum(new) - 1
    gp = np.bincount(gid, weights=wp)
    gn = np.bincount(gid, weights=wn)
    neg_below = np.cumsum(gn) - gn
    p, n = wp.sum(), wn.sum()
    if p == 0 or n == 0:
        return 0.5
    return float((gp * neg_below).sum() + 0.5 * (gp * gn).sum()) / (p * n)


class StreamingAUC:
    """Stateful host-side wrapper mirroring ``keras.metrics.AUC`` usage.

    ``update_state`` runs a jitted accumulate; ``result`` finalizes;
    ``reset_state`` matches the reference's per-eval reset idiom
    (``dien/train.py:65-66``).
    """

    def __init__(self, bins: int = DEFAULT_BINS):
        self._bins = bins
        self._state = AUCState.init(bins)
        self._update = jax.jit(auc_update)

    def update_state(self, labels, scores, weights=None) -> None:
        self._state = self._update(self._state, jnp.asarray(scores), jnp.asarray(labels), weights)

    def result(self) -> float:
        return float(auc_from_state(self._state))

    def reset_state(self) -> None:
        self._state = AUCState.init(self._bins)

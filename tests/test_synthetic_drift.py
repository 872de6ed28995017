"""SyntheticInterestDrift: the planted ORDER mechanism that makes the
sequence quality benchmark discriminate BASE/DIN/DIEN.

The certification is oracle-based, not training-based: the bag-match
oracle is the ceiling for any permutation-invariant history pooler
(BASE's mean, DIN's attention — both blind to order), the recency oracle
is what an order-aware recurrence can read. The gap between them is the
planted DIEN headroom; training runs that realize it live in
benchmarks/quality_runs.py (run_dien_drift, 3 seeds, mean±band).
"""
import numpy as np
import pytest

from recommender_tpu.data.synthetic import SyntheticInterestDrift


@pytest.fixture(scope="module")
def gen():
    return SyntheticInterestDrift(seed=0)


@pytest.fixture(scope="module")
def batch(gen):
    return gen.sample(20_000, seed=3)


def test_schema_and_padding(gen, batch):
    T = gen.max_len
    n = len(batch["label"])
    assert batch["pos_his_item"].shape == (n, T)
    valid = batch["pos_his_item"] != 0
    # post-padded: valid positions are a prefix
    first_pad = valid.sum(1)
    rows = np.arange(T)[None, :] < first_pad[:, None]
    assert np.array_equal(valid, rows)
    # pad positions carry cat 0; real items carry real cats
    assert (batch["pos_his_cat"][~valid] == 0).all()
    assert (batch["pos_his_cat"][valid] > 0).all()
    assert 0.45 < batch["label"].mean() < 0.55


def test_drift_structure(gen, batch):
    """Non-distractor history items form exactly two topic segments, stale
    then recent, and positives come from the recent segment's topic."""
    his_topic = gen.item_topic[batch["pos_his_item"]]
    valid = batch["pos_his_item"] != 0
    ln = valid.sum(1)
    last_topic = his_topic[np.arange(len(ln)), ln - 1]
    first_topic = his_topic[:, 0]
    tgt_topic = gen.item_topic[batch["target_item"]]
    pos = batch["label"] > 0
    # distractors make single positions unreliable; check in aggregate that
    # positives' targets match the LAST topic far more often than the first
    match_last = (tgt_topic[pos] == last_topic[pos]).mean()
    match_first = (tgt_topic[pos] == first_topic[pos]).mean()
    assert match_last > 0.7  # 1 - noise with slack
    assert match_first < 0.35  # noise + uniform collision

    # hard negatives: target topic == stale (first) topic, never recent
    neg = ~pos
    match_last_neg = (tgt_topic[neg] == last_topic[neg]).mean()
    assert match_last_neg < 0.3  # only distractor collisions


def test_oracle_gap(gen, batch):
    """The planted mechanism: permutation-invariant ceiling (bag) well
    below the order-aware ceiling (recency)."""
    aucs = gen.oracle_aucs(batch)
    assert aucs["recency"] > 0.97, aucs
    assert aucs["bag"] < 0.85, aucs
    assert aucs["recency"] - aucs["bag"] > 0.12, aucs


def test_oracle_gap_vanishes_without_hard_negatives(gen):
    """Control: with easy negatives only, the bag oracle suffices — the
    hard-negative fraction is what plants the order signal."""
    easy = SyntheticInterestDrift(seed=0, hard_neg_frac=0.0)
    aucs = easy.oracle_aucs(easy.sample(20_000, seed=3))
    assert aucs["bag"] > 0.95, aucs

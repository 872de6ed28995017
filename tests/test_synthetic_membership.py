"""SyntheticMultiInterest: the planted SET-MEMBERSHIP mechanism that
separates DIN from BASE (the middle link of the reference's mechanism
ladder, ``dien/layers.py:76-204``).

Unlike the drift regime (information-theoretic separation: poolers are
capped by the bag oracle), here EVERY architecture shares the same perfect
membership oracle — the separation is ARCHITECTURAL: BASE must read a
1-of-K component through a ``cat_dim``-d mean (the mean-readout proxy
oracle quantifies that bottleneck), DIN's LocalActivationUnit sees the
``target*his`` product per position before pooling. Training runs that
realize the split live in benchmarks/quality_runs.py
(run_dien_membership, 3 seeds, mean±band).
"""
import numpy as np
import pytest

from recommender_tpu.data.synthetic import SyntheticMultiInterest


@pytest.fixture(scope="module")
def gen():
    return SyntheticMultiInterest(seed=0)


@pytest.fixture(scope="module")
def batch(gen):
    return gen.sample(20_000, seed=3)


def test_schema_and_padding(gen, batch):
    T = gen.max_len
    n = len(batch["label"])
    assert batch["pos_his_item"].shape == (n, T)
    valid = batch["pos_his_item"] != 0
    first_pad = valid.sum(1)
    rows = np.arange(T)[None, :] < first_pad[:, None]
    assert np.array_equal(valid, rows)
    assert (batch["pos_his_cat"][~valid] == 0).all()
    assert (batch["pos_his_cat"][valid] > 0).all()
    assert 0.45 < batch["label"].mean() < 0.55
    assert (gen.item_cat[batch["target_item"]] == batch["target_cat"]).all()


def test_membership_is_the_label(gen, batch):
    """The planted mechanism is EXACT: target category in the user's
    interest set iff label=1 (no noise — the handicap is the bottleneck,
    not the data)."""
    member = (
        (batch["pos_his_cat"] == batch["target_cat"][:, None])
        & (batch["pos_his_cat"] != 0)
    ).any(1)
    assert np.array_equal(member, batch["label"] > 0)


def test_histories_are_distinct_cats(gen, batch):
    """Each history holds hist_cats DISTINCT categories (one item each):
    fine granularity is what makes the mean readout hard."""
    his = batch["pos_his_cat"]
    valid_counts = (his != 0).sum(1)
    assert (valid_counts == gen.hist_cats).all()
    for row in his[:50]:
        real = row[row != 0]
        assert len(set(real.tolist())) == len(real)


def test_oracle_gap(gen, batch):
    """Membership ceiling is perfect for every architecture; the
    mean-readout proxy (BASE's bottleneck) is far below it."""
    aucs = gen.oracle_aucs(batch)
    assert aucs["membership"] == 1.0, aucs
    assert aucs["mean_readout"] < 0.75, aucs


def test_mean_readout_recovers_with_few_interests(gen):
    """Control: with K=4 interests the mean barely dilutes and the readout
    proxy is strong — hist_cats is the knob that plants the bottleneck."""
    easy = SyntheticMultiInterest(seed=0, hist_cats=4)
    aucs = easy.oracle_aucs(easy.sample(20_000, seed=3))
    assert aucs["mean_readout"] > 0.85, aucs

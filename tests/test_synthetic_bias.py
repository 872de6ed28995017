"""SyntheticMultiTask selection-bias regime: the planted
mechanism checks that make the ESMM quality benchmark discriminate the
Base two-model protocol from full-space multi-task training. Training
runs that realize the separation live in benchmarks/quality_runs.py
(run_esmm_bias, 3 seeds, mean±band)."""
import numpy as np

from recommender_tpu.data.synthetic import SyntheticMultiTask

BIAS_KW = dict(
    vocab_sizes=(50_000,) * 18, zipf_a=1.4,
    click_bias=-4.0, buy_bias=-3.0, confounding=1.5,
)


def test_defaults_unchanged():
    """The default regime (used by the standing esmm/mmoe quality rows and
    the CLI synthetic path) is bit-stable: new knobs must not perturb the
    default rng stream."""
    g = SyntheticMultiTask(seed=0)
    b = g.sample(5000, seed=1)
    assert b["features"].max() < 50
    assert 0.25 < b["click"].mean() < 0.40
    b2 = SyntheticMultiTask(seed=0).sample(5000, seed=1)
    assert np.array_equal(b["features"], b2["features"])
    assert np.array_equal(b["purchase"], b2["purchase"])


def test_bias_regime_rates():
    g = SyntheticMultiTask(seed=0, **BIAS_KW)
    b = g.sample(200_000, seed=1)
    click = b["click"].mean()
    assert 0.02 < click < 0.08  # sparse clicks: CVR-on-clicks sees ~20x less
    assert (b["purchase"] <= b["click"]).all()  # no click => no purchase
    buy_given_click = b["purchase"].sum() / b["click"].sum()
    assert 0.2 < buy_given_click < 0.7


def test_confounder_tilts_click_space():
    """Clicked impressions are selected toward high latent u, so the
    click-conditional buy rate sits ABOVE the no-confounder regime's —
    E[buy | x, click] != E[buy | x], the sample-selection bias."""
    kw = dict(BIAS_KW)
    conf = SyntheticMultiTask(seed=0, **kw)
    kw["confounding"] = 0.0
    plain = SyntheticMultiTask(seed=0, **kw)
    bc = conf.sample(300_000, seed=1)
    bp = plain.sample(300_000, seed=1)
    r_conf = bc["purchase"].sum() / bc["click"].sum()
    r_plain = bp["purchase"].sum() / bp["click"].sum()
    assert r_conf > r_plain + 0.1, (r_conf, r_plain)


def test_tail_undertrained_in_click_space():
    """The data-sparsity mechanism: a sizable share of impression-space
    feature values is (almost) absent from the clicked subset, so a
    click-space-only CVR model cannot have trained their embeddings."""
    g = SyntheticMultiTask(seed=0, **BIAS_KW)
    train = g.sample(1_000_000, seed=1)
    test = g.sample(50_000, seed=9)
    f_clk = train["features"][train["click"] > 0]
    fracs = []
    for c in (0, 6, 12):
        cnt = np.bincount(f_clk[:, c], minlength=g.vocab_sizes[c])
        fracs.append(float((cnt[test["features"][:, c]] < 3).mean()))
    tail = float(np.mean(fracs))
    assert tail > 0.03, tail
    # ...while the impression space itself covers those values well
    f_all = train["features"]
    cnt_all = np.bincount(f_all[:, 0], minlength=g.vocab_sizes[0])
    assert float((cnt_all[test["features"][:, 0]] < 3).mean()) < tail / 2

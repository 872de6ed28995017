"""Quality-evidence runs: train each family on synthetic data with a known
planted structure and report final eval metrics (JSON lines).

These are the framework's "does it actually learn, at scale, on the
device" proof — the reference's dataset-specific AUC targets (BASELINE.md)
need the real downloads; the synthetic ceilings here are known by
construction and must be approached, not just beaten trivially.

Final numbers are certified with the EXACT (sort-based) AUC
(core.metrics.exact_auc / evaluate(exact=True) / link_prediction_auc):
the 8192-bin streaming histogram's ≲2e-3 error is the same order as the
model-to-model deltas these rows exist to rank.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.models.tasks import (
    evaluate_head,
    init_model,
    link_prediction_auc,
    make_aux_loss_task,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
    make_skipgram_task,
)


def report(name, **kw):
    print(json.dumps({"quality_run": name, **{k: round(v, 4) if isinstance(v, float) else v for k, v in kw.items()}}), flush=True)


def mesh1():
    return make_mesh(MeshSpec(len(jax.devices()), 1))


def _run_ctr_family(name, model_cls, steps, seeds):
    """Shared CTR quality runner; multi-seed -> per-seed rows + mean/band
    (the r4 standard: every claim-bearing quality row carries a band)."""
    from recommender_tpu.data.synthetic import SyntheticCTR

    gen = SyntheticCTR(vocab_size=200_000, seed=0)
    test = gen.sample(100_000, seed=2)
    aucs = []
    for s in seeds:
        train = gen.sample(2_000_000, seed=1 + 1000 * s)
        model = model_cls(vocab_size=200_000, embed_dim=16)
        loss_fn, eval_fn = make_ctr_task(model)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                     mesh=mesh1(), eval_fn=eval_fn)
        state = tr.init_state(
            lambda: init_model(model, {k: v[:8] for k, v in train.items()}, seed=s)
        )
        state, _ = tr.fit(state, batch_iterator(train, 4096, epochs=None, seed=s),
                          steps=steps)
        ev = tr.evaluate(state, batch_iterator(test, 8192, shuffle=False), exact=True)
        aucs.append(ev["eval_auc_exact"])
        tag = name if len(seeds) == 1 else f"{name}_seed{s}"
        report(tag, steps=steps, **ev)
    if len(seeds) > 1:
        report(name, steps=steps, auc_mean=float(np.mean(aucs)),
               auc_band=float(np.max(aucs) - np.min(aucs)),
               auc_min=float(np.min(aucs)), auc_max=float(np.max(aucs)))


def run_dlrm(steps=3000, seeds=(0,)):
    from recommender_tpu.models.dlrm import DLRM

    _run_ctr_family("dlrm", DLRM, steps, seeds)


def run_dlrm_band(steps=3000):
    run_dlrm(steps, seeds=(0, 1, 2))


def run_deepfm(steps=3000, seeds=(0,)):
    from recommender_tpu.models.deepfm import DeepFM

    _run_ctr_family("deepfm", DeepFM, steps, seeds)


def run_deepfm_band(steps=3000):
    run_deepfm(steps, seeds=(0, 1, 2))


def run_dcn(steps=3000, seeds=(0,)):
    from recommender_tpu.models.dcn import DCN

    _run_ctr_family("dcn", DCN, steps, seeds)


def run_dcn_band(steps=3000):
    run_dcn(steps, seeds=(0, 1, 2))


def run_dien(steps=3000):
    from recommender_tpu.data.synthetic import SyntheticSequence
    from recommender_tpu.models.dien import DIEN, DIN, BaseModel

    gen = SyntheticSequence(num_items=20_000, num_cats=200, max_len=50, seed=0)
    train = gen.sample(400_000, seed=1)
    test = gen.sample(50_000, seed=2)
    for name, cls, task in (
        ("dien_base", BaseModel, make_ctr_task),
        ("din", DIN, make_ctr_task),
        ("dien", DIEN, make_aux_loss_task),
    ):
        model = cls(item_vocab=gen.num_items, cat_vocab=gen.num_cats)
        loss_fn, eval_fn = task(model)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                     mesh=mesh1(), eval_fn=eval_fn)
        state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in train.items()}))
        state, _ = tr.fit(state, batch_iterator(train, 512, epochs=None), steps=steps)
        ev = tr.evaluate(state, batch_iterator(test, 2048, shuffle=False), exact=True)
        report(name, steps=steps, **ev)


def run_dien_drift(steps=3000, seeds=(0, 1, 2), only=None):
    """Discriminative sequence benchmark: interest-DRIFT
    data where the label depends on history ORDER (recent-topic positives,
    stale-topic hard negatives — data/synthetic.py::SyntheticInterestDrift).
    BASE/DIN are permutation-invariant poolers capped near the bag-match
    oracle; DIEN's recurrence can read the order. 3 seeds per model
    (init + data draw + batch order), mean ± band reported, so the
    BASE < DIN << DIEN ordering is certified against measured run noise
    rather than claimed from single-run deltas (the r3 retraction class).
    """
    from recommender_tpu.data.synthetic import SyntheticInterestDrift
    from recommender_tpu.models.bst import BST
    from recommender_tpu.models.dien import DIEN, DIN, BaseModel

    gen = SyntheticInterestDrift(seed=0)
    test = gen.sample(50_000, seed=999)
    oracles = gen.oracle_aucs(test)
    report("drift_oracles", **oracles)
    # BST rides the same ladder (r5): position-aware attention is the
    # second order-reading mechanism — it must land with DIEN above the
    # permutation-invariant poolers, certifying the transformer path
    # learns order, not just co-occurrence
    for name, cls, task in (
        ("drift_base", BaseModel, make_ctr_task),
        ("drift_din", DIN, make_ctr_task),
        ("drift_dien", DIEN, make_aux_loss_task),
        ("drift_bst", BST, make_ctr_task),
    ):
        if only and name not in only:
            continue
        aucs = []
        for s in seeds:
            train = gen.sample(400_000, seed=100 + s)
            model = cls(item_vocab=gen.num_items, cat_vocab=gen.num_cats)
            loss_fn, eval_fn = task(model)
            tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                         mesh=mesh1(), eval_fn=eval_fn)
            state = tr.init_state(
                lambda: init_model(model, {k: v[:8] for k, v in train.items()}, seed=s)
            )
            state, _ = tr.fit(
                state, batch_iterator(train, 512, epochs=None, seed=s), steps=steps
            )
            ev = tr.evaluate(state, batch_iterator(test, 2048, shuffle=False), exact=True)
            aucs.append(ev["eval_auc_exact"])
            report(f"{name}_seed{s}", steps=steps, **ev)
        report(name, steps=steps, auc_mean=float(np.mean(aucs)),
               auc_band=float(np.max(aucs) - np.min(aucs)),
               auc_min=float(np.min(aucs)), auc_max=float(np.max(aucs)))


def run_drift_bst(steps=3000):
    """BST-only rung of the drift ladder (the base/din/dien rows are
    already banded)."""
    run_dien_drift(steps, only=("drift_bst",))


def run_dien_membership(steps=3000, seeds=(0, 1, 2), only=None):
    """The DIN-over-BASE link of the ladder: fine-grained
    SET MEMBERSHIP (data/synthetic.py::SyntheticMultiInterest). All three
    architectures share a perfect membership oracle; BASE is handicapped
    by its mean-pool bottleneck (mean-readout proxy ~0.65 AUC at 50
    distinct cats / 18 dims), DIN's per-position target*his product reads
    membership before the mean dilutes it. Paired with run_dien_drift
    (which isolates the order link, DIEN >> poolers), the two regimes
    certify the full BASE < DIN < DIEN mechanism ladder with each link
    measured in the regime that isolates it."""
    from recommender_tpu.data.synthetic import SyntheticMultiInterest
    from recommender_tpu.models.bst import BST
    from recommender_tpu.models.dien import DIEN, DIN, BaseModel

    gen = SyntheticMultiInterest(seed=0)
    test = gen.sample(50_000, seed=999)
    report("membership_oracles", **gen.oracle_aucs(test))
    for name, cls, task in (
        ("membership_base", BaseModel, make_ctr_task),
        ("membership_din", DIN, make_ctr_task),
        ("membership_dien", DIEN, make_aux_loss_task),
        ("membership_bst", BST, make_ctr_task),
    ):
        if only and name not in only:
            continue
        aucs = []
        for s in seeds:
            train = gen.sample(400_000, seed=100 + s)
            model = cls(item_vocab=gen.num_items, cat_vocab=gen.num_cats)
            loss_fn, eval_fn = task(model)
            tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                         mesh=mesh1(), eval_fn=eval_fn)
            state = tr.init_state(
                lambda: init_model(model, {k: v[:8] for k, v in train.items()}, seed=s)
            )
            state, _ = tr.fit(
                state, batch_iterator(train, 512, epochs=None, seed=s), steps=steps
            )
            ev = tr.evaluate(state, batch_iterator(test, 2048, shuffle=False), exact=True)
            aucs.append(ev["eval_auc_exact"])
            report(f"{name}_seed{s}", steps=steps, **ev)
        report(name, steps=steps, auc_mean=float(np.mean(aucs)),
               auc_band=float(np.max(aucs) - np.min(aucs)),
               auc_min=float(np.min(aucs)), auc_max=float(np.max(aucs)))


def run_membership_bst(steps=3000):
    """BST-only rung of the membership ladder (base/din/dien banded r4)."""
    run_dien_membership(steps, only=("membership_bst",))


def _train_base_protocol(gen, train, test, *, steps, seed=0, batch=1024,
                         lr=1e-3):
    """The reference's headline Base comparison (``esmm/train.py:14-91``):
    a CTR model on impressions + a separate CVR model on clicks; CTCVR
    score = product of the two models on impressions. Returns
    (cvr_auc_on_clicks, ctcvr_auc_on_impressions), both exact."""
    from recommender_tpu.core.metrics import exact_auc
    from recommender_tpu.data.aliccp import click_only
    from recommender_tpu.models.esmm import MultiTaskBase
    from recommender_tpu.models.tasks import make_ctr_task

    models = {}
    for role, label in (("ctr", "click"), ("cvr", "purchase")):
        data = train if role == "ctr" else click_only(train)
        arrays = dict(data)
        arrays["label"] = arrays[label]
        model = MultiTaskBase(vocab_sizes=list(gen.vocab_sizes))
        loss_fn, eval_fn = make_ctr_task(model)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=lr, log_every=10**9),
                     mesh=mesh1(), eval_fn=eval_fn)
        state = tr.init_state(
            lambda: init_model(model, {k: v[:8] for k, v in arrays.items()}, seed=seed)
        )
        bs = min(batch, len(arrays["label"]))
        state, _ = tr.fit(
            state, batch_iterator(arrays, bs, epochs=None, seed=seed), steps=steps
        )
        models[role] = (model, state, tr)

    clicks = click_only(test)
    clicks = dict(clicks)
    clicks["label"] = clicks["purchase"]
    cvr_m, cvr_s, cvr_tr = models["cvr"]
    cvr_auc = cvr_tr.evaluate(
        cvr_s, batch_iterator(clicks, 1024, shuffle=False), exact=True
    )["eval_auc_exact"]

    ctr_m, ctr_s, ctr_tr = models["ctr"]
    scores, labels = [], []
    for b in batch_iterator(test, 4096, shuffle=False):
        db = ctr_tr.put_batch(b)
        p_ctr = ctr_m.apply(ctr_s.params, {}, db)[0]
        p_cvr = cvr_m.apply(cvr_s.params, {}, db)[0]
        scores.append(jax.device_get(p_ctr * p_cvr))
        labels.append(b["purchase"])
    ctcvr_auc = float(exact_auc(np.concatenate(scores), np.concatenate(labels)))
    return float(cvr_auc), ctcvr_auc


def run_esmm(steps=3000, seeds=(0,)):
    from recommender_tpu.data.aliccp import click_only
    from recommender_tpu.data.synthetic import SyntheticMultiTask
    from recommender_tpu.models.esmm import ESMM, MMOE

    gen = SyntheticMultiTask(seed=0)
    test = gen.sample(100_000, seed=2)
    if len(seeds) == 1:
        train = gen.sample(1_000_000, seed=1)
        cvr_auc, ctcvr_auc = _train_base_protocol(gen, train, test, steps=steps)
        report("esmm_base", steps=steps, cvr_auc=cvr_auc, ctcvr_auc=ctcvr_auc)
    for name, cls in (("esmm", ESMM), ("mmoe", MMOE)):
        cts = []
        for s_ in seeds:
            train = gen.sample(1_000_000, seed=1 + 1000 * s_)
            model = cls(vocab_sizes=list(gen.vocab_sizes))
            loss_fn, eval_fn = make_multitask_task(model)
            tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                         mesh=mesh1(), eval_fn=eval_fn)
            state = tr.init_state(
                lambda: init_model(model, {k: v[:8] for k, v in train.items()}, seed=s_)
            )
            state, _ = tr.fit(state, batch_iterator(train, 1024, epochs=None, seed=s_),
                              steps=steps)
            clicks = click_only(test)
            cvr_auc = evaluate_head(
                tr, state, batch_iterator(clicks, 1024, shuffle=False),
                make_head_eval(model, "cvr", "purchase"), exact=True,
            )
            ctcvr_auc = evaluate_head(
                tr, state, batch_iterator(test, 4096, shuffle=False),
                make_head_eval(model, "ctcvr", "purchase"), exact=True,
            )
            cts.append(ctcvr_auc)
            tag = name if len(seeds) == 1 else f"{name}_seed{s_}"
            report(tag, steps=steps, cvr_auc=cvr_auc, ctcvr_auc=ctcvr_auc)
        if len(seeds) > 1:
            report(name, steps=steps, ctcvr_mean=float(np.mean(cts)),
                   ctcvr_band=float(np.max(cts) - np.min(cts)))


def run_esmm_band(steps=3000):
    run_esmm(steps, seeds=(0, 1, 2))


def run_esmm_bias(steps=3000, seeds=(0, 1, 2)):
    """Selection-bias regime: low click rate + Zipf-sparse
    vocabs + a click/buy confounder (``SyntheticMultiTask`` knobs), the
    published mechanism the ESMM decomposition corrects (esmm/README.md:
    17-23). The Base two-model protocol's click-space CVR model is starved
    of exactly the tail the impression-wide CTCVR eval covers; ESMM/MMOE
    train full-space with shared embeddings. 3 seeds, mean ± band, so the
    Base < ESMM separation is certified against measured run noise."""
    from recommender_tpu.data.aliccp import click_only
    from recommender_tpu.data.synthetic import SyntheticMultiTask
    from recommender_tpu.models.esmm import ESMM, MMOE

    # measured regime (tuning log in git): 4.7% click rate, 48% buy|click,
    # and 6.6% of test id-positions seen <3 times in the 1M-impression
    # train set's ~47k clicks — ~70% of test examples carry at least one
    # click-space-undertrained feature value
    gen = SyntheticMultiTask(
        seed=0, vocab_sizes=(50_000,) * 18, zipf_a=1.4,
        click_bias=-4.0, buy_bias=-3.0, confounding=1.5,
    )
    test = gen.sample(200_000, seed=999)
    report("esmm_bias_regime", click_rate=float(test["click"].mean()),
           buy_rate=float(test["purchase"].mean()))
    rows = {"base": [], "esmm": [], "mmoe": []}
    for s in seeds:
        train = gen.sample(1_000_000, seed=100 + s)
        cvr_auc, ctcvr_auc = _train_base_protocol(
            gen, train, test, steps=steps, seed=s
        )
        rows["base"].append((cvr_auc, ctcvr_auc))
        report(f"esmm_bias_base_seed{s}", steps=steps, cvr_auc=cvr_auc,
               ctcvr_auc=ctcvr_auc)
        for name, cls in (("esmm", ESMM), ("mmoe", MMOE)):
            model = cls(vocab_sizes=list(gen.vocab_sizes))
            loss_fn, eval_fn = make_multitask_task(model)
            tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9),
                         mesh=mesh1(), eval_fn=eval_fn)
            state = tr.init_state(
                lambda: init_model(model, {k: v[:8] for k, v in train.items()}, seed=s)
            )
            state, _ = tr.fit(
                state, batch_iterator(train, 1024, epochs=None, seed=s), steps=steps
            )
            clicks = click_only(test)
            cvr = evaluate_head(
                tr, state, batch_iterator(clicks, 1024, shuffle=False),
                make_head_eval(model, "cvr", "purchase"), exact=True,
            )
            ctcvr = evaluate_head(
                tr, state, batch_iterator(test, 4096, shuffle=False),
                make_head_eval(model, "ctcvr", "purchase"), exact=True,
            )
            rows[name].append((cvr, ctcvr))
            report(f"esmm_bias_{name}_seed{s}", steps=steps, cvr_auc=cvr,
                   ctcvr_auc=ctcvr)
    for name, vals in rows.items():
        cv = [v[0] for v in vals]
        ct = [v[1] for v in vals]
        report(f"esmm_bias_{name}", steps=steps,
               cvr_auc_mean=float(np.mean(cv)),
               cvr_auc_band=float(np.max(cv) - np.min(cv)),
               ctcvr_auc_mean=float(np.mean(ct)),
               ctcvr_auc_band=float(np.max(ct) - np.min(ct)))


def run_eges(steps=16000, seeds=(0,)):
    # GES/EGES average 3 embeddings into the hidden, splitting the gradient
    # ~1/3 per table — they need ~4x BGE's steps to converge (measured:
    # GES auc 0.72@4k, 0.89@8k, 0.98@12k, 0.99@16k on this graph)
    from recommender_tpu.graph.store import WeightedGraph
    from recommender_tpu.graph.walks import skipgram_batches
    from recommender_tpu.models.eges import EGES, GES, DeepWalk

    rng = np.random.default_rng(0)
    V, C = 20_000, 64
    comm = rng.integers(0, C, V)
    src, dst = [], []
    for v in range(1, V):
        pool = np.where(comm == comm[v])[0]
        pool = pool[pool > 0]
        picks = rng.choice(pool, size=8)
        for u in picks:
            if u != v:
                src += [v, int(u)]
                dst += [int(u), v]
    g = WeightedGraph.from_edges(src, dst, num_nodes=V)
    side = {"cat": (comm + 1).astype(np.int32),
            "brand": rng.integers(1, 100, V).astype(np.int32)}
    side["cat"][0] = 0
    # held-out link-pred triples: intra-community pairs vs uniform negatives
    qs = rng.integers(1, V, 20000)
    ps, ns = [], []
    for q in qs:
        pool = np.where(comm == comm[q])[0]
        pool = pool[pool > 0]
        ps.append(int(rng.choice(pool)))
        ns.append(int(rng.integers(1, V)))
    triples = {"query": qs.astype(np.int32), "pos": np.array(ps, np.int32),
               "neg": np.array(ns, np.int32)}
    triples_side = dict(triples)
    for role in ("query", "pos", "neg"):
        for nm, arr in side.items():
            triples_side[f"{role}_{nm}"] = arr[triples[role]]

    # Reference-semantics rows by default; EGES_DAMPED=1 adds the
    # --shared_lr_scale 0.5 rows (converge in ~1/7 the steps to a better
    # stable floor).
    damped = {"cat_embedding": 0.5, "brand_embedding": 0.5}
    variants = [
        ("bge", DeepWalk(vocab_size=V, embed_dim=64), False, None),
        ("ges", GES(vocab_size=V, cat_vocab=C + 1, brand_vocab=100, embed_dim=64), True, None),
        ("eges", EGES(vocab_size=V, cat_vocab=C + 1, brand_vocab=100, embed_dim=64), True, None),
    ]
    if os.environ.get("EGES_DAMPED"):
        variants += [
            ("ges_damped", GES(vocab_size=V, cat_vocab=C + 1, brand_vocab=100, embed_dim=64), True, damped),
            ("eges_damped", EGES(vocab_size=V, cat_vocab=C + 1, brand_vocab=100, embed_dim=64), True, damped),
        ]
    if os.environ.get("EGES_DAMPED_ONLY"):
        # band ONLY the damped rows (the base rows are already banded)
        # without re-paying 3 variants x seeds of training
        variants = [
            ("ges_damped", GES(vocab_size=V, cat_vocab=C + 1, brand_vocab=100, embed_dim=64), True, damped),
            ("eges_damped", EGES(vocab_size=V, cat_vocab=C + 1, brand_vocab=100, embed_dim=64), True, damped),
        ]
    for name, model, use_side, scales in variants:
        aucs = []
        for s_ in seeds:
            loss_fn, eval_fn = make_skipgram_task(model)
            it = skipgram_batches(g, batch_size=2048, walks_per_round=256,
                                  side_info=side if use_side else None, seed=s_)
            tr = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9,
                                              lr_scales=scales),
                         mesh=mesh1(), eval_fn=eval_fn)
            state = tr.init_state(lambda: init_model(model, next(it), seed=s_))
            state, _ = tr.fit(state, it, steps=steps)
            auc = link_prediction_auc(
                model, state.params, triples_side if use_side else triples
            )
            aucs.append(auc)
            tag = name if len(seeds) == 1 else f"{name}_seed{s_}"
            report(tag, steps=steps, link_prediction_auc=auc)
        if len(seeds) > 1:
            report(name, steps=steps, auc_mean=float(np.mean(aucs)),
                   auc_band=float(np.max(aucs) - np.min(aucs)),
                   auc_min=float(np.min(aucs)), auc_max=float(np.max(aucs)))


def run_pinsage(steps=6000, seeds=(0,), eval_every=0):  # the reference's hit-rate peaks at step 6000
    from recommender_tpu.data.movielens import ground_truth_matrix
    from recommender_tpu.graph.bipartite import BipartiteGraph
    from recommender_tpu.models.pinsage import ItemFeatures, PinSage
    from recommender_tpu.models.pinsage_task import make_pinsage_task, pinsage_train_batches
    from recommender_tpu.retrieval.eval import full_corpus_reprs, hit_rate, recommend_topk

    rng = np.random.default_rng(0)
    U, V, C = 6000, 3700, 32
    u_comm = rng.integers(0, C, U)
    blocks = np.array_split(np.arange(V), C)
    us, its = [], []
    for u in range(U):
        pool = blocks[u_comm[u]]
        for _ in range(20):
            it_ = int(rng.choice(pool)) if rng.random() < 0.85 else int(rng.integers(V))
            us.append(u)
            its.append(it_)
    g = BipartiteGraph(us, its, U, V)
    feats = ItemFeatures(year=rng.integers(0, 81, V).astype(np.int32),
                         genre=(rng.random((V, 18)) < 0.2).astype(np.float32))
    latest = np.array([int(np.random.default_rng(u).choice(blocks[u_comm[u]])) for u in range(U)])
    test_item = np.array([int(np.random.default_rng(u + 1).choice(blocks[u_comm[u]])) for u in range(U)])
    seen = np.zeros((U, V), bool)
    seen[np.asarray(us), np.asarray(its)] = True
    gt = ground_truth_matrix(test_item, V)
    # serving-quantization neutrality is certified PER SEED
    from recommender_tpu.retrieval.quantize import (
        quantize_reprs,
        recommend_topk_quantized,
    )

    hrs, peaks, hrs_q = [], [], []
    for s_ in seeds:
        model = PinSage(features=feats)
        loss_fn = make_pinsage_task(model)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9), mesh=mesh1())
        it = pinsage_train_batches(g, 128, seed=s_)
        state = tr.init_state(lambda: init_model(model, next(it), seed=s_))

        def corpus_hr(params):
            reprs = full_corpus_reprs(model, params, g, np.random.default_rng(1))
            return hit_rate(recommend_topk(reprs, latest, seen, k=10), gt), reprs

        # eval-cadence trajectory: the reference's protocol is the PEAK of
        # one trajectory (pinsage/train/logs/log.jpg, hit-rate curve peaks
        # ~step 6000) — reporting peak alongside final quantifies the
        # trajectory variance the final-only number hides
        # segmented fits use prefetch=0: with the default Prefetcher each
        # segment boundary would drop a TIMING-DEPENDENT 1-3 queued
        # batches (fit over-pulls one batch at the break; close() discards
        # the queue), making trajectories irreproducible; prefetch=0 makes
        # the per-segment over-pull exactly one batch, deterministic
        traj = []
        if eval_every:
            for _ in range(max(steps // eval_every, 1)):
                state, _ = tr.fit(state, it, steps=eval_every, prefetch=0)
                hr, reprs = corpus_hr(state.params)
                traj.append(hr)
        else:
            state, _ = tr.fit(state, it, steps=steps)
            hr, reprs = corpus_hr(state.params)
            traj = [hr]
        peak = max(traj)
        qr, sc = quantize_reprs(reprs)
        hr_q = hit_rate(recommend_topk_quantized(qr, sc, latest, seen, k=10), gt)
        hrs.append(hr)
        peaks.append(peak)
        hrs_q.append(hr_q)
        tag = "pinsage" if len(seeds) == 1 else f"pinsage_seed{s_}"
        report(tag, steps=steps, hit_rate_at_10=hr, hit_rate_peak=peak,
               hit_rate_int8=hr_q, trajectory=[round(t, 4) for t in traj])
    if len(seeds) > 1:
        report("pinsage", steps=steps, hr_mean=float(np.mean(hrs)),
               hr_band=float(np.max(hrs) - np.min(hrs)),
               hr_min=float(np.min(hrs)), hr_max=float(np.max(hrs)),
               peak_mean=float(np.mean(peaks)),
               peak_band=float(np.max(peaks) - np.min(peaks)),
               int8_mean=float(np.mean(hrs_q)),
               int8_delta_mean=float(np.mean(np.array(hrs_q) - np.array(hrs))))


def run_twotower(steps=6000, seeds=(0, 1, 2)):
    """Two-tower retrieval on the SAME planted-community setup as the
    PinSage band (6000 users x 3700 items, 32 communities, 85% intra) so
    the two retrieval trainers' hit-rates are directly comparable; int8
    serving neutrality certified per seed like PinSage (r5)."""
    from recommender_tpu.data.movielens import ground_truth_matrix
    from recommender_tpu.graph.bipartite import BipartiteGraph
    from recommender_tpu.models.two_tower import (
        TwoTower,
        corpus_item_reprs,
        interaction_batches,
        make_two_tower_task,
    )
    from recommender_tpu.retrieval.eval import (
        hit_rate,
        recommend_topk_from_queries,
    )
    from recommender_tpu.retrieval.quantize import quantize_reprs

    rng = np.random.default_rng(0)
    U, V, C = 6000, 3700, 32
    u_comm = rng.integers(0, C, U)
    blocks = np.array_split(np.arange(V), C)
    us, its = [], []
    for u in range(U):
        pool = blocks[u_comm[u]]
        for _ in range(20):
            it_ = int(rng.choice(pool)) if rng.random() < 0.85 else int(rng.integers(V))
            us.append(u)
            its.append(it_)
    g = BipartiteGraph(us, its, U, V)
    test_item = np.array([int(np.random.default_rng(u + 1).choice(blocks[u_comm[u]])) for u in range(U)])
    seen = np.zeros((U, V), bool)
    seen[np.asarray(us), np.asarray(its)] = True
    gt = ground_truth_matrix(test_item, V)
    import jax as _jax

    hrs, hrs_q = [], []
    for s_ in seeds:
        model = TwoTower(user_vocab=U, item_vocab=V, embed_dim=32,
                         repr_dim=32, tower_units=(64,))
        loss_fn, eval_fn = make_two_tower_task(model)
        tr = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9),
                     mesh=mesh1(), eval_fn=eval_fn)
        it = interaction_batches(g, 1024, seed=s_)
        state = tr.init_state(lambda: init_model(model, next(it), seed=s_))
        state, _ = tr.fit(state, it, steps=steps)
        reprs = corpus_item_reprs(model, state.params, V)
        uq = _jax.device_get(_jax.jit(model.user_repr)(
            state.params, np.arange(U, dtype=np.int32)))
        hr = hit_rate(recommend_topk_from_queries(uq, reprs, seen, k=10), gt)
        qr, sc = quantize_reprs(reprs)
        # int8 corpus + approx reduction: quantized queries against the
        # quantized corpus via the f32-dequant path (queries stay f32)
        deq = qr.astype(np.float32) * sc[:, None]
        hr_q = hit_rate(
            recommend_topk_from_queries(uq, deq, seen, k=10, exact=False), gt)
        hrs.append(hr)
        hrs_q.append(hr_q)
        report(f"twotower_seed{s_}", steps=steps, hit_rate_at_10=hr,
               hit_rate_int8=hr_q)
    if len(seeds) > 1:
        report("twotower", steps=steps, hr_mean=float(np.mean(hrs)),
               hr_band=float(np.max(hrs) - np.min(hrs)),
               int8_delta_mean=float(np.mean(np.array(hrs_q) - np.array(hrs))))


def run_eges_band(steps=16000):
    run_eges(steps, seeds=(0, 1, 2))


def run_pinsage_band(steps=12000):
    # 8 seeds, eval cadence 2000 for peak-reporting.
    # 12k steps = 2x the reference's peak-at-6000 horizon: the r5 6k-step
    # trajectories were still RISING at 6000 for 7/8 seeds, so the band is
    # measured to the plateau (the step-6000 trajectory point stays
    # directly comparable to the reference's protocol).
    run_pinsage(steps, seeds=tuple(range(8)), eval_every=2000)


if __name__ == "__main__":
    which = sys.argv[1:] or [
        "dlrm", "deepfm", "dien", "dien_drift", "dien_membership",
        "esmm", "esmm_bias",
        "eges", "pinsage",
    ]
    for name in which:
        globals()[f"run_{name}"]()

"""Serving bundle export/load/top-k + profiling utilities."""
import numpy as np

from recommender_tpu.core.profiling import StepTimer
from recommender_tpu.retrieval.export import (
    export_serving_bundle,
    load_serving_bundle,
    serve_topk,
)


def test_serving_bundle_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    reprs = rng.normal(size=(50, 8)).astype(np.float32)
    nbr = rng.integers(0, 50, size=(50, 3)).astype(np.int32)
    w = rng.random((50, 3)).astype(np.float32)
    p = tmp_path / "bundle.npz"
    export_serving_bundle(str(p), reprs, nbr, w, metadata={"model": "pinsage", "k": 3})
    b = load_serving_bundle(str(p))
    np.testing.assert_array_equal(b["item_reprs"], reprs)
    np.testing.assert_array_equal(b["neighbor_ids"], nbr)
    assert b["metadata"]["model"] == "pinsage"

    recs = serve_topk(b, np.array([0, 1, 2]), k=5)
    assert recs.shape == (3, 5)
    for i in range(3):
        assert i not in recs[i]  # self-retrieval masked
    # top-1 is the true nearest neighbor by dot product
    sims = reprs @ reprs.T
    np.fill_diagonal(sims, -np.inf)
    np.testing.assert_array_equal(recs[:, 0], sims[:3].argmax(axis=1))


def test_quantized_bundle_roundtrip_and_recall(tmp_path):
    """Int8 export (retrieval/quantize.py): 4× smaller corpus payload,
    scores through the int8 matmul path, and on clustered reprs the top-k
    agrees with f32 scoring (quantization error ≪ cluster separation)."""
    rng = np.random.default_rng(1)
    C, per, D = 20, 40, 32
    centers = rng.normal(size=(C, D)) * 3
    reprs = (centers.repeat(per, axis=0)
             + rng.normal(size=(C * per, D))).astype(np.float32)
    p = tmp_path / "q.npz"
    export_serving_bundle(str(p), reprs, metadata={"model": "pinsage"},
                          quantize=True)
    b = load_serving_bundle(str(p))
    assert "item_reprs" not in b
    assert b["item_reprs_int8"].dtype == np.int8
    assert b["item_scale"].dtype == np.float32
    # the quantized corpus really is ~4x smaller than the f32 one
    assert b["item_reprs_int8"].nbytes == reprs.nbytes // 4

    # dequantized reconstruction is within one quantization step per coord
    deq = b["item_reprs_int8"].astype(np.float32) * b["item_scale"][:, None]
    assert np.max(np.abs(deq - reprs)) <= np.max(np.abs(reprs)) / 127 + 1e-6

    q_ids = np.arange(0, C * per, 7)
    recs_q = serve_topk(b, q_ids, k=10)
    pf = tmp_path / "f.npz"
    export_serving_bundle(str(pf), reprs)
    recs_f = serve_topk(load_serving_bundle(str(pf)), q_ids, k=10)
    # top-10 overlap >= 90% on average; top-1 identical
    overlap = np.mean([
        len(set(a.tolist()) & set(b_.tolist())) / 10
        for a, b_ in zip(recs_q, recs_f)
    ])
    assert overlap >= 0.9, overlap
    # top-1 may flip between near-ties; it must agree for most queries and
    # ALWAYS land in the query's own cluster (the planted structure)
    top1_agree = np.mean(recs_q[:, 0] == recs_f[:, 0])
    assert top1_agree >= 0.9, top1_agree
    np.testing.assert_array_equal(recs_q[:, 0] // per, q_ids // per)


def test_int8_recommend_idlist_matches_dense():
    """Int8 recommend path: padded seen-id lists (over-fetch exclusion)
    give the same output as the dense bool mask."""
    import numpy as np

    from recommender_tpu.retrieval.quantize import (
        quantize_reprs,
        recommend_topk_quantized,
    )

    rng = np.random.default_rng(5)
    U, V, D, S = 40, 150, 16, 9
    reprs = rng.normal(size=(V, D)).astype(np.float32)
    q, sc = quantize_reprs(reprs)
    latest = rng.integers(0, V, U)
    dense = np.zeros((U, V), bool)
    lists = np.full((U, S), -1, np.int32)
    for u in range(U):
        ids = rng.choice(V, size=rng.integers(1, S), replace=False)
        dense[u, ids] = True
        lists[u, : len(ids)] = ids
    recs_d = recommend_topk_quantized(q, sc, latest, dense, k=5, batch_size=16)
    recs_l = recommend_topk_quantized(q, sc, latest, lists, k=5, batch_size=16)
    np.testing.assert_array_equal(recs_d, recs_l)


def test_seen_format_explicit_and_ambiguity_guard():
    """An integer [U, V] 0/1 mask must not be silently
    reinterpreted as padded id lists. auto-sniff raises on the ambiguous
    width==V integer case; seen_format='mask' restores the pre-r5 coercion
    and matches the bool-mask result."""
    import pytest

    from recommender_tpu.retrieval.eval import recommend_topk, resolve_seen_format

    rng = np.random.default_rng(7)
    U, V, D = 12, 60, 8
    reprs = rng.normal(size=(V, D)).astype(np.float32)
    latest = rng.integers(0, V, U)
    mask_bool = rng.random((U, V)) < 0.1
    mask_int = mask_bool.astype(np.int32)  # the formerly-accepted form

    with pytest.raises(ValueError, match="ambiguous"):
        recommend_topk(reprs, latest, mask_int, k=5)
    with pytest.raises(ValueError, match="ambiguous"):
        resolve_seen_format(mask_int, V)

    recs_b = recommend_topk(reprs, latest, mask_bool, k=5)
    recs_i = recommend_topk(reprs, latest, mask_int, k=5, seen_format="mask")
    np.testing.assert_array_equal(recs_b, recs_i)
    # unambiguous cases still auto-resolve
    assert resolve_seen_format(mask_bool, V) is False
    assert resolve_seen_format(np.full((U, 5), -1, np.int32), V) is True


def test_overfetch_clamped_to_small_corpus():
    """k + seen-width > V (small corpus / wide padded histories): the
    over-fetch clamps to V instead of failing in top_k,
    and still excludes every seen id when enough candidates remain."""
    from recommender_tpu.retrieval.eval import recommend_topk
    from recommender_tpu.retrieval.quantize import (
        quantize_reprs,
        recommend_topk_quantized,
    )

    rng = np.random.default_rng(11)
    U, V, D, S = 6, 20, 8, 18  # k + S = 23 > V
    reprs = rng.normal(size=(V, D)).astype(np.float32)
    latest = rng.integers(0, V, U)
    lists = np.full((U, S), -1, np.int32)
    for u in range(U):
        ids = rng.choice(V, size=4, replace=False)
        lists[u, :4] = ids
    recs = recommend_topk(reprs, latest, lists, k=5)
    assert recs.shape == (U, 5)
    q, sc = quantize_reprs(reprs)
    recs_q = recommend_topk_quantized(q, sc, latest, lists, k=5, exact=True)
    for u in range(U):
        seen = set(lists[u][lists[u] >= 0].tolist())
        assert not seen & set(recs[u].tolist())
        assert not seen & set(recs_q[u].tolist())

    # serve_topk self-exclusion on a tiny corpus (k + 1 > V)
    b = {"item_reprs": reprs[:4]}
    recs_s = serve_topk(b, np.arange(4), k=5, exact=True)
    for i in range(4):
        assert i not in recs_s[i][:3]  # 3 non-self candidates exist


def test_idlist_exclusion_lowering_has_no_scatter():
    """Fusion witness: serving throughput depends on seen-exclusion staying
    OVER-FETCH + candidate filtering. The
    regression mode is scatter-masking the [Q, V] score matrix
    (``sim.at[rows, ids].set(-inf)``), which breaks XLA's matmul→reduction
    fusion and re-materializes the score matrix (131 GB OOM at 16k×2M,
    retrieval/quantize._drop_excluded). A scatter in the LOWERED module is
    the backend-independent signature of that regression — assert none, on
    every id-list exclusion path."""
    import jax.numpy as jnp

    from recommender_tpu.retrieval import eval as reval
    from recommender_tpu.retrieval import export as rexport
    from recommender_tpu.retrieval import quantize as rquant

    Q, V, D, S, k = 16, 512, 32, 8, 10
    q = jnp.zeros((Q, D), jnp.float32)
    items = jnp.zeros((V, D), jnp.float32)
    seen = jnp.full((Q, S), -1, jnp.int32)
    qi = jnp.zeros((V, D), jnp.int8)
    sc = jnp.ones((V,), jnp.float32)
    ids = jnp.arange(Q, dtype=jnp.int32)

    lowered = {
        "f32_idmask": reval._topk_scores_idmask.lower(
            q, items, seen, k, exact=False
        ),
        "int8_idmask": rquant._recommend_int8_idmask.lower(
            qi, sc, ids, seen, k=k, exact=False, recall_target=0.95
        ),
        "int8_self": rquant._topk_int8.lower(
            qi, sc, ids, k=k, exact=False, recall_target=0.95, mask_self=True
        ),
    }
    rexport._topk_f32(items, np.arange(Q), k=k, exact=False, recall_target=0.95)
    lowered["f32_self"] = rexport._TOPK_F32.lower(
        items, ids, k=k, exact=False, recall_target=0.95
    )
    for name, lo in lowered.items():
        text = lo.as_text()
        assert "scatter" not in text, (
            f"{name}: scatter in lowered exclusion path — seen-exclusion "
            "regressed from over-fetch to score-matrix masking"
        )


def test_quantize_zero_rows():
    from recommender_tpu.retrieval.quantize import quantize_reprs

    r = np.zeros((4, 8), np.float32)
    r[1] = 1.0
    q, s = quantize_reprs(r)
    assert (q[0] == 0).all() and s[0] == 0
    assert q[1].max() == 127


def test_step_timer():
    t = StepTimer(warmup=1)
    for _ in range(4):
        with t:
            pass
    s = t.summary()
    assert s["steps"] == 3
    assert s["mean_ms"] >= 0


def test_ivf_bundle_roundtrip_and_serve(tmp_path):
    """ivf_clusters export → load → serve_topk(probes=) matches the
    brute-force serve on clustered reprs, excludes self, and falls back
    loudly when probes is requested without an IVF bundle."""
    import pytest

    rng = np.random.default_rng(21)
    C, per, D = 12, 50, 16
    centers = rng.normal(size=(C, D)) * 3
    reprs = (centers.repeat(per, axis=0)
             + rng.normal(size=(C * per, D)) * 0.3).astype(np.float32)
    p = tmp_path / "ivf.npz"
    export_serving_bundle(str(p), reprs, metadata={"model": "pinsage"},
                          quantize=True, ivf_clusters=C)
    b = load_serving_bundle(str(p))
    assert "ivf_centroids" in b and b["ivf_bucket_q"].dtype == np.int8

    q_ids = np.arange(0, C * per, 13)
    recs_ivf = serve_topk(b, q_ids, k=8, probes=4)
    recs_brute = serve_topk(b, q_ids, k=8, exact=True)
    assert recs_ivf.shape == (len(q_ids), 8)
    for i, qid in enumerate(q_ids):
        assert qid not in recs_ivf[i]  # self excluded
    # probing 4 of 12 well-separated clusters recovers the brute top-8
    overlap = np.mean([
        len(set(a.tolist()) & set(b_.tolist())) / 8
        for a, b_ in zip(recs_ivf, recs_brute)
    ])
    assert overlap >= 0.9, overlap

    pf = tmp_path / "flat.npz"
    export_serving_bundle(str(pf), reprs, quantize=True)
    with pytest.raises(ValueError, match="ivf"):
        serve_topk(load_serving_bundle(str(pf)), q_ids, k=8, probes=4)


def test_ivf_serve_cli_flags(tmp_path, capsys):
    """cli/serve --probes drives the IVF path end-to-end."""
    from recommender_tpu.cli.serve import main

    rng = np.random.default_rng(22)
    reprs = rng.normal(size=(300, 8)).astype(np.float32)
    p = tmp_path / "b.npz"
    export_serving_bundle(str(p), reprs, quantize=True, ivf_clusters=6)
    recs = main(["--bundle", str(p), "--items", "3,17,42", "--top_k", "5",
                 "--probes", "6"])
    assert recs.shape == (3, 5)
    out = capsys.readouterr().out
    assert '"item": 3' in out


def test_drop_excluded_pads_output_to_k():
    """Corpus smaller than k: the exclusion filter pads with -1 instead of
    silently shrinking the [Q, k] output contract."""
    import jax.numpy as jnp

    from recommender_tpu.retrieval.quantize import _drop_excluded

    idx = jnp.asarray([[2, 0, 1], [1, 2, 0]], jnp.int32)  # width 3 < k=5
    out = np.asarray(_drop_excluded(idx, jnp.asarray([[0], [9]]), 5))
    assert out.shape == (2, 5)
    assert out[0].tolist()[:2] == [2, 1]        # excluded 0 dropped
    assert out[0].tolist()[2:4] == [-1, -1]     # sentinel before excluded
    assert out[1].tolist()[:3] == [1, 2, 0]     # nothing excluded

    # end-to-end: serve on a 4-item corpus with k=10 keeps width 10
    rng = np.random.default_rng(30)
    b = {"item_reprs": rng.normal(size=(4, 8)).astype(np.float32)}
    recs = serve_topk(b, np.arange(4), k=10, exact=True)
    assert recs.shape == (4, 10)
    for i in range(4):
        assert i not in recs[i][:3]
        # documented order: real kept ids, then -1 sentinels, then (only
        # when the row runs out of everything else) excluded ids
        assert (recs[i][3:9] == -1).all()

"""Criteo raw-format pipeline: vocab rules, encoding, shard roundtrip."""
import numpy as np

from recommender_tpu.data.criteo import (
    NUM_CAT,
    NUM_INT,
    build_vocab,
    encode_lines,
    load_shards,
    load_vocab,
    save_vocab,
    shard_batches,
    write_shards,
)


def _line(label, ints, cats):
    return "\t".join([str(label)] + [str(i) if i is not None else "" for i in ints] + cats)


def test_vocab_frequency_filter():
    common = ["A"] * NUM_CAT
    rare = ["R"] + ["A"] * (NUM_CAT - 1)
    lines = [_line(1, [1] * NUM_INT, common)] * 12 + [_line(0, [1] * NUM_INT, rare)]
    vocab = build_vocab(lines, min_count=11)
    assert "A" in vocab and vocab["A"] >= 1
    assert "R" not in vocab  # seen once → dropped


def test_encode_rules():
    cats = [f"c{i}" for i in range(NUM_CAT)]
    vocab = {c: i + 1 for i, c in enumerate(cats)}
    ints = [None, -5] + list(range(2, NUM_INT))
    lines = [_line(1, ints, cats)]
    out = encode_lines(lines, vocab)
    # missing and negative ints → 0 → log1p(0)=0
    assert out["int_features"][0, 0] == 0.0
    assert out["int_features"][0, 1] == 0.0
    np.testing.assert_allclose(out["int_features"][0, 2], np.log(3.0), rtol=1e-6)
    assert out["cat_features"].tolist()[0] == [vocab[c] for c in cats]
    # unknown cat value → 0
    out2 = encode_lines([_line(0, [1] * NUM_INT, ["zzz"] * NUM_CAT)], vocab)
    assert (out2["cat_features"] == 0).all()
    # missing cat value → per-column sentinel → 0 unless sentinel in vocab
    line_missing = "0\t" + "\t".join(["1"] * NUM_INT) + "\t" + "\t".join([""] * NUM_CAT)
    out3 = encode_lines([line_missing], vocab)
    assert (out3["cat_features"] == 0).all()


def test_shard_roundtrip(tmp_path):
    cats = [f"c{i}" for i in range(NUM_CAT)]
    lines = [_line(i % 2, list(range(NUM_INT)), cats) for i in range(25)]
    vocab = build_vocab(lines, min_count=1)
    save_vocab(vocab, str(tmp_path / "vocab.pkl"))
    assert load_vocab(str(tmp_path / "vocab.pkl")) == vocab
    paths = write_shards(lines, vocab, str(tmp_path / "shards"), shard_rows=10)
    assert len(paths) == 3
    arrays = load_shards(paths)
    assert arrays["label"].shape == (25,)
    assert arrays["cat_features"].shape == (25, NUM_CAT)
    batches = list(shard_batches(paths, 8, shuffle=False, epochs=1))
    # shards of 10/10/5 rows, batch 8, drop-remainder per shard → 8+8+0
    assert sum(b["label"].shape[0] for b in batches) == 16


def test_shard_batches_start_batch_bit_identical(tmp_path):
    """Resume fast-forward on the ON-DISK stream: a stream
    restarted with start_batch=k yields exactly the batches the original
    stream yields from position k — across shard boundaries, with shuffle
    on, and into the second epoch (skipped shards still consume their seed
    draws, so the rng stream stays aligned)."""
    rng = np.random.default_rng(0)
    paths = []
    for i, rows in enumerate((11, 7, 9)):  # 2+1+2 = 5 batches/epoch at b=4
        p = tmp_path / f"shard_{i:05d}.npz"
        np.savez(
            p,
            int_features=rng.normal(size=(rows, 3)).astype(np.float32),
            cat_features=rng.integers(0, 50, (rows, 2)).astype(np.int32),
            label=rng.random(rows).astype(np.float32),
        )
        paths.append(str(p))

    def take(n, **kw):
        it = shard_batches(paths, 4, seed=5, epochs=None, **kw)
        return [next(it) for _ in range(n)]

    full = take(12)  # well into epoch 3
    for k in (0, 1, 2, 3, 5, 7, 11):
        resumed = take(12 - k, start_batch=k)
        for a, b in zip(full[k:], resumed):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_shard_rows_header_only(tmp_path):
    from recommender_tpu.data.criteo import shard_rows

    p = tmp_path / "s.npz"
    np.savez(p, int_features=np.zeros((37, 13), np.float32),
             cat_features=np.zeros((37, 26), np.int32),
             label=np.zeros(37, np.float32))
    assert shard_rows(str(p)) == 37

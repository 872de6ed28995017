"""BASE/DIN/DIEN: shapes, masking invariants, end-to-end learning floors,
and Amazon-format pipeline parity."""
import os

import jax
import numpy as np
import pytest

from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.amazon import (
    build_vocab,
    encode_dataset,
    make_item2cat_array,
    sample_negative_history,
)
from recommender_tpu.data.pipeline import batch_iterator
from recommender_tpu.data.synthetic import SyntheticSequence
from recommender_tpu.models.dien import DIEN, DIN, BaseModel
from recommender_tpu.models.tasks import init_model, make_aux_loss_task, make_ctr_task


def _mk(model_cls, gen, **kw):
    return model_cls(
        item_vocab=gen.num_items,
        cat_vocab=gen.num_cats,
        item_dim=8,
        cat_dim=8,
        mlp_units=(32, 16, 1),
        **kw,
    )


def _train(model, gen, task_fn, steps=150, batch=128):
    train = gen.sample(8000, seed=1)
    test = gen.sample(2000, seed=2)
    loss_fn, eval_fn = task_fn(model)
    mesh = make_mesh(MeshSpec(8, 1))
    example = {k: v[:8] for k, v in train.items()}
    trainer = Trainer(
        loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9),
        mesh=mesh, eval_fn=eval_fn,
    )
    state = trainer.init_state(lambda: init_model(model, example))
    it = batch_iterator(train, batch, seed=0, epochs=None)
    state, _ = trainer.fit(state, it, steps=steps)
    return trainer.evaluate(state, batch_iterator(test, 400, shuffle=False))["eval_auc"]


def test_base_learns():
    gen = SyntheticSequence(seed=0)
    auc = _train(_mk(BaseModel, gen), gen, make_ctr_task)
    assert auc > 0.62, auc


def test_din_learns():
    gen = SyntheticSequence(seed=0)
    auc = _train(_mk(DIN, gen), gen, make_ctr_task)
    assert auc > 0.62, auc


def test_dien_learns():
    gen = SyntheticSequence(seed=0)
    model = _mk(DIEN, gen, extract_hidden=16, evolve_hidden=16)
    auc = _train(model, gen, make_aux_loss_task, steps=150)
    assert auc > 0.62, auc


def test_dien_padding_invariance():
    """Changing values at padded positions must not change outputs."""
    gen = SyntheticSequence(seed=0)
    model = _mk(DIEN, gen, extract_hidden=16, evolve_hidden=16)
    batch = gen.sample(16, seed=3)
    params, ms = init_model(model, batch)

    def run(b):
        (out, _), _, _ = model.apply(params, ms, b)
        return np.asarray(out)

    p1 = run(batch)
    pad = batch["pos_his_item"] == 0
    b2 = dict(batch)
    b2["pos_his_item"] = np.where(pad, 0, batch["pos_his_item"])
    b2["pos_his_cat"] = np.where(pad, 0, batch["pos_his_cat"])
    # garbage into the *embedded* padded steps via cat ids would break the
    # mask (computed from item==0), so instead verify truncation semantics:
    # appending extra pad steps leaves the prob unchanged
    T = batch["pos_his_item"].shape[1]
    b3 = {
        **batch,
        "pos_his_item": np.pad(batch["pos_his_item"], ((0, 0), (0, 4))),
        "pos_his_cat": np.pad(batch["pos_his_cat"], ((0, 0), (0, 4))),
        "neg_his_item": np.pad(batch["neg_his_item"], ((0, 0), (0, 4)), constant_values=1),
        "neg_his_cat": np.pad(batch["neg_his_cat"], ((0, 0), (0, 4)), constant_values=1),
    }
    p3 = run(b3)
    np.testing.assert_allclose(p1, p3, atol=2e-5)


def test_amazon_format_roundtrip(tmp_path):
    """Write a tiny reference-format TSV, build vocab, encode, check shapes."""
    lines = [
        "1\tu1\titemA\tcatX\titemB\x02itemC\tcatX\x02catY",
        "0\tu2\titemB\tcatY\titemA\tcatX",
    ]
    p = tmp_path / "train.tsv"
    p.write_text("\n".join(lines) + "\n")
    iv, cv, i2c = build_vocab(str(p))
    assert iv["mask"] == 0 and iv["unk"] == len(iv) - 1
    assert set(i2c) >= {"itemA", "itemB", "itemC"}
    arrays = encode_dataset(str(p), iv, cv, max_len=4)
    assert arrays["pos_his_item"].shape == (2, 4)
    assert arrays["label"].tolist() == [1.0, 0.0]
    # row 0: history itemB,itemC then pad
    assert arrays["pos_his_item"][0, 2] == 0
    assert arrays["pos_his_item"][0, 0] == iv["itemB"]
    # pre-truncation keeps the most recent
    arrays2 = encode_dataset(str(p), iv, cv, max_len=1)
    assert arrays2["pos_his_item"][0, 0] == iv["itemC"]

    arr = make_item2cat_array(iv, cv, i2c)
    rng = np.random.default_rng(0)
    nb = sample_negative_history(arrays, len(iv), arr, rng)
    assert nb["neg_his_item"].shape == (2, 4)
    assert (nb["neg_his_item"] > 0).all()
    # negatives carry their true categories
    assert (nb["neg_his_cat"] == arr[nb["neg_his_item"]]).all()

"""Task wrappers: bind a model to the Trainer's (loss_fn, eval_fn) protocol.

The reference repeats this glue in every subproject's train script; here it
is written once per task *shape* (binary CTR, CTR+aux-loss, multi-task).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from recommender_tpu.nn.losses import binary_cross_entropy

# Every model in ``recommender_tpu.models`` has
#   init(key, example_batch) -> (params, model_state)
#   apply(params, model_state, batch, *, train, rng) ->
#       (out, new_model_state, diagnostics)
# over nested-dict pytrees. ``model_state`` holds non-trained state (DIEN's
# ``batch_stats``); ``diagnostics`` holds per-step scalars (the all-to-all
# ``a2a_overflow`` counter) that ride the metrics dict and are never
# stored in the TrainState.


def init_model(model, example_batch: dict, seed: int = 0):
    """``(params, model_state)`` from ``PRNGKey(seed)``, initialized under
    one jit (eager init would compile every initializer op separately)."""
    return jax.jit(model.init)(jax.random.PRNGKey(seed), example_batch)


def _apply(model, params, model_state, batch, train, rng=None):
    return model.apply(params, model_state, batch, train=train, rng=rng)


def make_ctr_task(model) -> tuple[Callable, Callable]:
    """Binary CTR on ``batch['label']`` with model(batch) → prob [B]."""

    def loss_fn(params, model_state, batch, rng, train):
        prob, new_ms, diag = _apply(model, params, model_state, batch, train, rng)
        per_ex = binary_cross_entropy(prob, batch["label"])
        return per_ex, {"prob_mean": jnp.mean(prob), **diag}, new_ms

    def eval_fn(params, model_state, batch):
        prob, _, _ = _apply(model, params, model_state, batch, False)
        return prob, batch["label"]

    return loss_fn, eval_fn


def make_multitask_task(model):
    """ESMM/MMOE joint training: mean of BCE(ctr head, click) and
    BCE(ctcvr head, purchase) — keras ``binary_crossentropy`` on the 2-dim
    label averages the two heads (``esmm/train.py:100-103``)."""

    def loss_fn(params, model_state, batch, rng, train):
        heads, new_ms, diag = _apply(model, params, model_state, batch, train, rng)
        l_ctr = binary_cross_entropy(heads["ctr"], batch["click"])
        l_ctcvr = binary_cross_entropy(heads["ctcvr"], batch["purchase"])
        per_ex = 0.5 * (l_ctr + l_ctcvr)
        aux = {"ctr_loss": jnp.mean(l_ctr), "ctcvr_loss": jnp.mean(l_ctcvr)}
        return per_ex, {**aux, **diag}, new_ms

    def eval_fn(params, model_state, batch):
        heads, _, _ = _apply(model, params, model_state, batch, False)
        return heads["ctcvr"], batch["purchase"]

    return loss_fn, eval_fn


def make_head_eval(model, head: str, label_key: str):
    """Eval fn scoring one named head of a dict-output model against a label —
    the ESMM protocol's CVR-on-clicks / CTCVR-on-impressions evals
    (``esmm/train.py:114-127``)."""

    def eval_fn(params, model_state, batch):
        heads, _, _ = _apply(model, params, model_state, batch, False)
        return heads[head], batch[label_key]

    return eval_fn


def evaluate_head(trainer, state, batches, head_eval_fn, exact: bool = False):
    """Run a one-off AUC eval with a custom (scores, labels) fn.

    ``exact=True`` gathers scores/labels for the sort-based exact AUC —
    use for certified final numbers (histogram error ≲2e-3, same order as
    the deltas being certified); the streaming histogram stays the cheap
    in-loop default."""
    import jax as _jax
    import numpy as np

    from recommender_tpu.core.metrics import AUCState, auc_from_state, auc_update

    @_jax.jit
    def step(params, model_state, batch, auc):
        scores, labels = head_eval_fn(params, model_state, batch)
        return auc_update(auc, scores, labels), scores, labels

    auc = AUCState.init()
    all_s, all_l = [], []
    for batch in batches:
        auc, scores, labels = step(
            state.params, state.model_state, trainer.put_batch(batch), auc
        )
        if exact:
            all_s.append(_jax.device_get(scores).reshape(-1))
            all_l.append(_jax.device_get(labels).reshape(-1))
    if exact:
        from recommender_tpu.core.metrics import exact_auc

        return float(exact_auc(np.concatenate(all_s), np.concatenate(all_l)))
    return float(auc_from_state(auc))


def make_skipgram_task(model):
    """EGES-family sampled-softmax training: model(batch) → logits [B, 1+k],
    loss = sigmoid CE against ``batch['label']`` (``eges/train.py:14-23``)."""
    from recommender_tpu.nn.losses import bce_with_logits

    def loss_fn(params, model_state, batch, rng, train):
        logits, new_ms, diag = _apply(model, params, model_state, batch, train, rng)
        per_ex = jnp.mean(bce_with_logits(logits, batch["label"]), axis=-1)
        return per_ex, dict(diag), new_ms

    def eval_fn(params, model_state, batch):
        logits, _, _ = _apply(model, params, model_state, batch, False)
        return jax.nn.sigmoid(logits.reshape(-1)), batch["label"].reshape(-1)

    return loss_fn, eval_fn


def link_prediction_auc(
    model, params, triples: dict, batch_size: int = 4096,
    exact: bool = True,
) -> float:
    """EGES link-prediction protocol (``eges/train.py:26-40``): score held-out
    edges and uniform negatives by sigmoid(hidden_q · hidden_x), AUC over
    pos-vs-neg. Uses ``model.get_hidden`` on each role.

    ``exact=True`` (default) computes the sort-based exact AUC on host —
    the 8192-bin histogram's ≲2e-3 error is the same order as the
    BGE/GES/EGES deltas being certified; pass
    ``exact=False`` only for in-loop progress numbers."""
    import numpy as np

    from recommender_tpu.core.metrics import AUCState, auc_from_state, auc_update

    def hidden_for(role, batch):
        sub = {"target": batch[role]}
        for k, v in batch.items():
            if k.startswith(f"{role}_"):
                sub["target_" + k[len(role) + 1 :]] = v
        return model.get_hidden(params, sub)

    @jax.jit
    def score(batch):
        q = hidden_for("query", batch)
        p = hidden_for("pos", batch)
        n = hidden_for("neg", batch)
        pos = jax.nn.sigmoid(jnp.sum(q * p, axis=-1))
        neg = jax.nn.sigmoid(jnp.sum(q * n, axis=-1))
        return pos, neg

    auc = AUCState.init()
    all_pos, all_neg = [], []
    total = len(triples["query"])
    for s in range(0, total, batch_size):
        batch = {k: jnp.asarray(v[s : s + batch_size]) for k, v in triples.items()}
        pos, neg = score(batch)
        if exact:
            all_pos.append(jax.device_get(pos))
            all_neg.append(jax.device_get(neg))
        else:
            auc = auc_update(auc, pos, jnp.ones_like(pos))
            auc = auc_update(auc, neg, jnp.zeros_like(neg))
    if not exact:
        return float(auc_from_state(auc))
    from recommender_tpu.core.metrics import exact_auc

    pos = np.concatenate(all_pos)
    neg = np.concatenate(all_neg)
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
    return float(exact_auc(scores, labels))


def make_aux_loss_task(model, aux_weight: float = 1.0):
    """CTR where model returns (prob, per-example aux loss) — DIEN."""

    def loss_fn(params, model_state, batch, rng, train):
        (prob, aux_loss), new_ms, diag = _apply(model, params, model_state, batch, train, rng)
        per_ex = binary_cross_entropy(prob, batch["label"]) + aux_weight * aux_loss
        return per_ex, {"aux_loss": jnp.mean(aux_loss), **diag}, new_ms

    def eval_fn(params, model_state, batch):
        (prob, _), _, _ = _apply(model, params, model_state, batch, False)
        return prob, batch["label"]

    return loss_fn, eval_fn

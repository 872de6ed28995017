"""Offline batch scoring for ranking models (DLRM/DeepFM/DIN/DIEN/ESMM/MMOE).

The reference serves its ranking models only implicitly — eval inside the
training scripts (`ctr/train.py:85-97`, `esmm/train.py:137-149`); there is
no standalone inference path. This module adds one: restore a training
checkpoint, jit the forward once, and stream fixed-shape feature batches
through it at full device throughput (`cli/predict.py` is the entry point).

One compiled forward reused across batches (static shapes — the
last partial batch is padded up and sliced back), batches device_put ahead
through the same prefetcher the Trainer uses, scores fetched per batch (the
D2H copy overlaps the next batch's compute through the async dispatch
queue).
"""
from __future__ import annotations

from typing import Callable, Iterable

import jax
import numpy as np


def make_scorer(model, params, model_state=None) -> Callable:
    """Jitted ``batch -> scores`` over restored weights.

    The weights are passed as a jit ARGUMENT, not closed over: closure
    arrays become graph constants, and XLA may pick degenerate layouts for
    a constant 1M×16 table.

    ``model.apply`` output passes through unchanged: [B] probs for CTR
    models, a dict of heads for multi-task models.
    """
    model_state = model_state or {}

    @jax.jit
    def fwd(params, model_state, batch):
        return model.apply(params, model_state, batch, train=False)[0]

    return lambda batch: fwd(params, model_state, batch)


def score_batches(
    scorer: Callable,
    batches: Iterable[dict],
    batch_size: int,
) -> dict[str, np.ndarray]:
    """Run ``scorer`` over host batches; returns stacked score arrays.

    Every batch is padded to ``batch_size`` rows (repeating the last row)
    so the jitted forward compiles exactly once, then sliced back — the
    standard static-shape serving idiom under jit.
    """
    chunks: dict[str, list[np.ndarray]] = {}
    for batch in batches:
        n = len(next(iter(batch.values())))
        if n < batch_size:
            batch = {
                k: np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)])
                for k, v in batch.items()
            }
        out = scorer(batch)
        if isinstance(out, tuple):  # DIEN returns (prob, aux_loss) — keep prob
            out = out[0]
        if not isinstance(out, dict):
            out = {"score": out}
        for k, v in out.items():
            chunks.setdefault(k, []).append(jax.device_get(v)[:n])
    return {k: np.concatenate(v) for k, v in chunks.items()}

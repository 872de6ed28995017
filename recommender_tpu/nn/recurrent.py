"""Recurrent sequence layers as ``lax.scan`` — GRU and attention-gated AUGRU.

Re-design of the reference's two hot sequential loops
(``dien/distribute_train.py`` call stack, SURVEY.md §3.2):

* ``GRU``    — ``keras.layers.GRU(return_sequences=True)`` used by
  InterestExtract (``dien/layers.py:76-133``). Gates are fused into one
  [D+H, 3H] matmul per step so each scan iteration is a single matmul.
* ``AUGRU``  — the attention-gated GRU cell (``dien/layers.py:161-188``):
  the update gate is scaled by the per-step attention score before the
  convex combination. The reference smuggles the score through the last
  input column to fit the keras RNN API (``dien/layers.py:179-180``); here
  the scan carries ``(x_t, a_t)`` tuples directly — no hack needed.

Masking matches ``keras.layers.RNN(mask=...)`` semantics: masked steps carry
the previous state through unchanged (``dien/layers.py:131,203``).

Everything is time-major inside the scan ([T, B, ...]) for friendly XLA
layout; the public API is batch-major [B, T, ...].
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from recommender_tpu.nn.layers import lecun_normal

# Sequences up to this length unroll fully (no loop at all); longer ones
# keep the scan (window of 8) to bound compile time and code size. The
# policy is binary because partial unrolls beyond ~20 steps regressed
# before full unroll won. Not yet re-tuned on the current GPU.
FULL_UNROLL_MAX_T = 128

# Above this length each scan step is rematerialized (jax.checkpoint):
# recomputing the step is cheaper than storing and re-reading its
# activations from HBM. Not yet re-tuned on the current GPU.
REMAT_MIN_T = 256


def _effective_unroll(unroll, t: int) -> int:
    return t if (unroll is None and t <= FULL_UNROLL_MAX_T) else (unroll or 8)


def _effective_remat(remat, t: int) -> bool:
    return (t > REMAT_MIN_T) if remat is None else remat


def _gru_step_hoisted(h, zr_x, c_x, wh_gates, wh_cand):
    """One GRU step with the input projections precomputed. h [B,H];
    ``zr_x = x @ w_gates[h:] + b_gates`` and ``c_x = x @ w_cand[:d] + b_cand``
    are hoisted out of the scan as single [B·T, D] matmuls (the classic
    RNN-on-accelerator optimization: only the h-dependent half of each gate
    matmul is inherently sequential). Identical math to
    ``concat([h, x]) @ w_gates`` — pure reassociation of the same params.

    z = sigma(W_z [h,x]), r = sigma(W_r [h,x]),
    c = tanh(W_c [x, r*h]), h' = (1-z)*h + z*c.
    """
    zr = jnp.dot(h, wh_gates) + zr_x
    z, r = jnp.split(jax.nn.sigmoid(zr), 2, axis=-1)
    c = jnp.tanh(jnp.dot(r * h, wh_cand) + c_x)
    return (1.0 - z) * h + z * c


def _gru_params(key, d: int, h: int) -> dict:
    kg, kc = jax.random.split(key)
    return {
        "w_gates": lecun_normal(kg, (h + d, 2 * h)),
        "b_gates": jnp.zeros((2 * h,)),
        "w_cand": lecun_normal(kc, (h + d, h)),
        "b_cand": jnp.zeros((h,)),
    }


@dataclasses.dataclass(frozen=True)
class GRU:
    """Masked GRU over [B, T, D]; returns all hidden states [B, T, H].

    ``remat`` rematerializes each scan step on the backward pass
    (``jax.checkpoint``): O(T) → O(1) activation memory per step, and past
    a few hundred steps it can also be faster (see REMAT_MIN_T). ``None``
    (default) = auto: on for T > REMAT_MIN_T; a bool forces it.

    ``unroll`` replicates the step body inside the scan loop: at DIEN scale
    (B=128, H=36) each step is a single tiny matmul and the loop is
    bound by per-iteration overhead. ``None`` (default) = auto: unroll
    FULLY for T ≤ FULL_UNROLL_MAX_T (see module constants), else window
    of 8; an int forces that window."""

    hidden: int
    remat: bool | None = None
    unroll: int | None = None

    def init(self, key, x: jnp.ndarray, mask: jnp.ndarray) -> dict:
        return _gru_params(key, x.shape[-1], self.hidden)

    def apply(self, params: dict, x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        b, t, d = x.shape
        h = self.hidden
        w_gates, b_gates = params["w_gates"], params["b_gates"]
        w_cand, b_cand = params["w_cand"], params["b_cand"]

        xs = jnp.swapaxes(x, 0, 1)  # [T, B, D]
        ms = jnp.swapaxes(mask.astype(x.dtype), 0, 1)[..., None]  # [T, B, 1]
        # hoist input projections: one big matmul over all T·B rows
        # (w_gates rows 0..h-1 multiply h, rows h.. multiply x — see
        # _gru_step_hoisted; param layout matches concat([h, x]) @ w_gates)
        zr_x = jnp.einsum("tbd,dk->tbk", xs, w_gates[h:]) + b_gates
        c_x = jnp.einsum("tbd,dk->tbk", xs, w_cand[:d]) + b_cand

        def step(carry, inp):
            zr_t, c_t, mt = inp
            new = _gru_step_hoisted(carry, zr_t, c_t, w_gates[:h], w_cand[d:])
            carry = mt * new + (1.0 - mt) * carry
            return carry, carry

        if _effective_remat(self.remat, t):
            step = jax.checkpoint(step)
        h0 = jnp.zeros((b, h), x.dtype)
        unroll = _effective_unroll(self.unroll, t)
        _, hs = jax.lax.scan(step, h0, (zr_x, c_x, ms), unroll=unroll)
        return jnp.swapaxes(hs, 0, 1)  # [B, T, H]


@dataclasses.dataclass(frozen=True)
class AUGRU:
    """Attention-gated GRU; consumes hidden states + scores, returns final state.

    ``x``: [B, T, D] (interest-extractor hidden states),
    ``att``: [B, T, 1] (DIENAttention softmax scores),
    ``mask``: [B, T]. Returns [B, H].
    """

    hidden: int
    remat: bool | None = None  # see GRU.remat
    unroll: int | None = None  # see GRU.unroll

    def init(self, key, x: jnp.ndarray, att: jnp.ndarray, mask: jnp.ndarray) -> dict:
        return _gru_params(key, x.shape[-1], self.hidden)

    def apply(
        self, params: dict, x: jnp.ndarray, att: jnp.ndarray, mask: jnp.ndarray
    ) -> jnp.ndarray:
        b, t, d = x.shape
        h = self.hidden
        w_gates, b_gates = params["w_gates"], params["b_gates"]
        w_cand, b_cand = params["w_cand"], params["b_cand"]

        xs = jnp.swapaxes(x, 0, 1)  # [T, B, D]
        as_ = jnp.swapaxes(att, 0, 1)  # [T, B, 1]
        ms = jnp.swapaxes(mask.astype(x.dtype), 0, 1)[..., None]  # [T, B, 1]
        # hoisted input projections — see _gru_step_hoisted
        zr_x = jnp.einsum("tbd,dk->tbk", xs, w_gates[h:]) + b_gates
        c_x = jnp.einsum("tbd,dk->tbk", xs, w_cand[:d]) + b_cand

        def step(carry, inp):
            zr_t, c_t, at, mt = inp
            zr = jnp.dot(carry, w_gates[:h]) + zr_t
            z, r = jnp.split(jax.nn.sigmoid(zr), 2, axis=-1)
            c = jnp.tanh(jnp.dot(r * carry, w_cand[d:]) + c_t)
            za = z * at  # attention-scaled update gate (AUGRU)
            new = za * c + (1.0 - za) * carry
            carry = mt * new + (1.0 - mt) * carry
            return carry, None

        if _effective_remat(self.remat, t):
            step = jax.checkpoint(step)
        h0 = jnp.zeros((b, h), x.dtype)
        unroll = _effective_unroll(self.unroll, t)
        final, _ = jax.lax.scan(step, h0, (zr_x, c_x, as_, ms), unroll=unroll)
        return final

"""Low-precision-aware optimizers (bf16 embedding tables).

``adam_sr`` is Adam with three properties that make a bf16-STORED param
(e.g. the DLRM 1M×16 table, `--embed_dtype bf16`) quality-neutral while
keeping its halved HBM traffic:

* moment math runs in f32 regardless of storage dtype (a bf16 ``nu`` with
  round-to-nearest writes goes STALE: the (1-b2)·g² increment is ~1e-3
  relative — below bf16's 2⁻⁸ ulp — so most increments round away);
* moments are STORED in the param's dtype by default (same HBM traffic as
  plain bf16 Adam) but written back with stochastic rounding, which keeps
  the expected moment trajectory exact; ``moment_dtype='float32'`` opts
  into full-precision storage instead (2× optimizer-state traffic);
* the returned updates stay f32 so the final param write — the Trainer's
  ``apply_updates_sr`` — is the ONLY rounding the update ever takes.

For an all-f32 param tree every stochastic round is an identity cast, and
the math matches ``optax.adam`` to f32 roundoff (pinned by
tests/test_rounding.py), so the Trainer can swap this in whenever a
low-precision leaf exists without changing f32 behavior.

RNG: derived from a seed + the Adam step count held in the optimizer state
(optax ``update_fn`` has no rng argument), folded per-leaf — deterministic
and resume-safe (the count rides the checkpoint).
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax

from recommender_tpu.ops.rounding import is_low_precision, stochastic_round_to


def _flatten_with(treedef, tree):
    return treedef.flatten_up_to(tree)


def scale_by_adam_sr(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    seed: int = 0,
    moment_dtype: Optional[Any] = None,
) -> optax.GradientTransformation:
    """``optax.scale_by_adam`` with f32 moment math, param-dtype (or
    ``moment_dtype``) moment storage, and stochastic-rounded state writes.
    State is ``optax.ScaleByAdamState`` (checkpoint-compatible)."""
    mdt = None if moment_dtype is None else jnp.dtype(moment_dtype)

    def store_dtype(p):
        return mdt if mdt is not None else p.dtype

    def init_fn(params):
        mu = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, dtype=store_dtype(p)), params
        )
        nu = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, dtype=store_dtype(p)), params
        )
        return optax.ScaleByAdamState(
            count=jnp.zeros([], jnp.int32), mu=mu, nu=nu
        )

    def update_fn(updates, state, params=None):
        del params
        count = optax.safe_int32_increment(state.count)
        base_key = jax.random.fold_in(jax.random.PRNGKey(seed), state.count)
        g_leaves, treedef = jax.tree_util.tree_flatten(updates)
        mu_leaves = _flatten_with(treedef, state.mu)
        nu_leaves = _flatten_with(treedef, state.nu)
        c1 = 1.0 - b1 ** count.astype(jnp.float32)
        c2 = 1.0 - b2 ** count.astype(jnp.float32)
        out, new_mu, new_nu = [], [], []
        for i, (g, m, n) in enumerate(zip(g_leaves, mu_leaves, nu_leaves)):
            gf = g.astype(jnp.float32)
            mf = b1 * m.astype(jnp.float32) + (1.0 - b1) * gf
            nf = b2 * n.astype(jnp.float32) + (1.0 - b2) * gf * gf
            out.append((mf / c1) / (jnp.sqrt(nf / c2) + eps))
            if is_low_precision(m.dtype):
                new_mu.append(
                    stochastic_round_to(
                        mf, m.dtype, jax.random.fold_in(base_key, 2 * i)
                    )
                )
                new_nu.append(
                    stochastic_round_to(
                        nf, n.dtype, jax.random.fold_in(base_key, 2 * i + 1)
                    )
                )
            else:
                new_mu.append(mf.astype(m.dtype))
                new_nu.append(nf.astype(n.dtype))
        return (
            jax.tree_util.tree_unflatten(treedef, out),
            optax.ScaleByAdamState(
                count=count,
                mu=jax.tree_util.tree_unflatten(treedef, new_mu),
                nu=jax.tree_util.tree_unflatten(treedef, new_nu),
            ),
        )

    return optax.GradientTransformation(init_fn, update_fn)


def adam_sr(
    learning_rate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    seed: int = 0,
    moment_dtype: Optional[Any] = None,
) -> optax.GradientTransformation:
    """Adam whose moment writes stochastically round into low-precision
    storage; returns f32 updates (see module docstring)."""
    return optax.chain(
        scale_by_adam_sr(b1=b1, b2=b2, eps=eps, seed=seed, moment_dtype=moment_dtype),
        optax.scale_by_learning_rate(learning_rate),
    )


def apply_updates_sr(params, updates, key: jax.Array):
    """``optax.apply_updates`` with an f32 add + stochastic-rounded write
    for low-precision leaves (unbiased: sub-ulp Adam updates land in
    expectation instead of rounding away — ops.rounding docstring)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    upd = _flatten_with(treedef, updates)
    out = []
    for i, (p, u) in enumerate(zip(leaves, upd)):
        if u is None:
            out.append(p)
        elif is_low_precision(p.dtype):
            summed = p.astype(jnp.float32) + u.astype(jnp.float32)
            out.append(
                stochastic_round_to(summed, p.dtype, jax.random.fold_in(key, i))
            )
        else:
            out.append((p + u.astype(p.dtype)).astype(p.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def has_low_precision_leaf(params) -> bool:
    return any(
        is_low_precision(getattr(l, "dtype", jnp.float32))
        for l in jax.tree_util.tree_leaves(params)
    )

"""Stochastic rounding f32 → bf16 for low-precision parameter updates.

Why: a bf16-STORED embedding table halves the table's bytes in the Adam
update (chip_smoke.py phase ``train`` times both table dtypes), but
deterministic round-to-nearest loses tiny Adam updates: at DLRM init scale the per-step
update (~lr ≈ 1e-3) sits right at the table's bf16 ulp (~0.25·2⁻⁷), so a
large fraction of every update rounds away and early training slows
(eval AUC 0.736 → 0.700 at 300 steps). Stochastic rounding makes the
rounded write UNBIASED — E[sr(x)] = x — so the expected parameter
trajectory matches f32 and accumulated updates land in expectation even
when each individual one is sub-ulp. This is the standard fix for
low-precision optimizer states (the reference never needs it: its tables
are replicated f32, ``ctr/train.py:64-65``).

Mechanics (bf16 is the upper 16 bits of f32, so truncation IS round-down):
add a uniform 16-bit integer to the f32 bit pattern, then truncate the low
16 bits. The carry promotes the value to the next-representable bf16 with
probability = (x - down) / (up - down); exactly-representable values are
untouched (low bits zero → the random add never carries). Non-finite
values bypass the integer add (adding to an inf/NaN pattern corrupts it).

Runs elementwise over the full tensor; the noise bits cost far less than
the table's own HBM read/write.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _hash_noise_u16(shape, key: jax.Array) -> jnp.ndarray:
    """Cheap uniform 16-bit noise: murmur3 finalizer over (element index ⊕
    key material). SR needs decorrelated-uniform bits, not crypto-grade
    randomness, and threefry over the full param+moment tree is a
    noticeable share of a DLRM step where this ~10-op finalizer is not.
    Deterministic per (key, element index)."""
    n = int(np.prod(shape)) if shape else 1
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    x = jax.lax.iota(jnp.uint32, n) * jnp.uint32(0x9E3779B9) + kd[0]
    x = x ^ kd[-1]
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x & jnp.uint32(0xFFFF)).reshape(shape)


def stochastic_round_to(
    x: jnp.ndarray, dtype, key: jax.Array, fast: bool = True
) -> jnp.ndarray:
    """Round f32 ``x`` to ``dtype`` stochastically (unbiased); identity cast
    for f32/f64 targets. Only bfloat16 is supported as a low-precision
    target (it is the truncation of f32 — f16 is not).

    ``fast=True`` (default) draws the rounding bits from the murmur3-hash
    generator above; ``fast=False`` uses threefry (``jax.random.bits``) —
    kept for A/B-ing the generator quality."""
    dtype = jnp.dtype(dtype)
    if dtype != jnp.bfloat16:
        if dtype in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
            return x.astype(dtype)
        raise ValueError(f"stochastic_round_to: unsupported target {dtype}")
    x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    if fast:
        noise = _hash_noise_u16(x.shape, key)
    else:
        noise = jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF)
    rounded = (bits + noise) & jnp.uint32(0xFFFF0000)
    sr = jax.lax.bitcast_convert_type(rounded, jnp.float32)
    out = jnp.where(jnp.isfinite(x), sr, x)
    return out.astype(jnp.bfloat16)


def is_low_precision(dtype) -> bool:
    """True for floating dtypes narrower than f32 (SR-apply candidates)."""
    dtype = jnp.dtype(dtype)
    return jnp.issubdtype(dtype, jnp.floating) and dtype.itemsize < 4

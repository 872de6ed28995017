"""Parameter primitives: dense, layer norm and batch norm over dict pytrees.

Every layer in the package is a frozen dataclass of static configuration
with explicit ``init(key, ...) -> params`` and ``apply(params, ...)``
methods; params are nested dicts whose keys are written out by the layer
that owns them. The names (``Dense_0``, ``BatchNorm_0``, ``LayerNorm_1``,
``kernel``/``bias``/``scale``/``mean``/``var``) are part of the checkpoint
and ``lr_scales`` contract, so they are spelled the same everywhere.

Initializers: dense kernels lecun-normal with zero bias, norms scale 1 and
bias 0, batch-norm running stats mean 0 and var 1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

lecun_normal = jax.nn.initializers.lecun_normal()
# embedding tables: uniform with variance 1/features (fan over the row)
embedding_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "uniform", out_axis=0
)


def dense_init(key, in_dim: int, out_dim: int, dtype=jnp.float32) -> dict:
    return {
        "kernel": lecun_normal(key, (in_dim, out_dim), dtype),
        "bias": jnp.zeros((out_dim,), dtype),
    }


def dense(p: dict, x: jnp.ndarray, dtype=None) -> jnp.ndarray:
    """``x @ kernel + bias`` over the last axis of ``x``. Inputs and params
    are cast to ``dtype`` (default: their promoted type), so a bf16
    ``dtype`` runs the matmul in bf16 on f32-stored params."""
    kernel, bias = p["kernel"], p["bias"]
    if dtype is None:
        dtype = jnp.result_type(x, kernel, bias)
    x, kernel, bias = x.astype(dtype), kernel.astype(dtype), bias.astype(dtype)
    y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias


def norm_init(dim: int) -> dict:
    return {"scale": jnp.ones((dim,), jnp.float32), "bias": jnp.zeros((dim,), jnp.float32)}


def _normalize(p, x, mean, var, eps):
    y = (x - mean) * jax.lax.rsqrt(var + eps)
    return y * p["scale"] + p["bias"]


def layer_norm(p: dict, x: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """Normalize over the last axis (statistics in f32)."""
    x32 = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(x32 * x32, axis=-1, keepdims=True) - mean * mean, 0.0)
    return _normalize(p, x32, mean, var, eps)


def batch_norm_stats_init(dim: int) -> dict:
    return {"mean": jnp.zeros((dim,), jnp.float32), "var": jnp.ones((dim,), jnp.float32)}


def batch_norm(
    p: dict, stats: dict, x: jnp.ndarray, *, train: bool,
    momentum: float = 0.99, eps: float = 1e-5,
) -> tuple[jnp.ndarray, dict]:
    """Batch norm over every axis but the last, in f32. ``train`` normalizes
    by the batch's statistics and returns running stats moved toward them;
    otherwise the running stats normalize and come back unchanged."""
    x = x.astype(jnp.float32)
    if not train:
        return _normalize(p, x, stats["mean"], stats["var"], eps), stats
    axes = tuple(range(x.ndim - 1))
    mean = jnp.mean(x, axis=axes)
    var = jnp.maximum(jnp.mean(x * x, axis=axes) - mean * mean, 0.0)
    new_stats = {
        "mean": momentum * stats["mean"] + (1.0 - momentum) * mean,
        "var": momentum * stats["var"] + (1.0 - momentum) * var,
    }
    return _normalize(p, x, mean, var, eps), new_stats


def merge_diagnostics(*diags: dict) -> dict:
    """Sum per-step diagnostic scalars (e.g. ``a2a_overflow``) from several
    layers; entries with the same name add up."""
    out: dict = {}
    for d in diags:
        for k, v in d.items():
            out[k] = out[k] + v if k in out else v
    return out

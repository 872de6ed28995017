"""Dense towers.

Covers the reference's four per-subproject ``MLP`` layers
(``ctr/layers.py:5-14``, ``dien/layers.py:20-31``, ``esmm/layers.py:4-13``)
as one configurable layer. The DIEN variant's input BatchNorm
(``dien/layers.py:22``) is applied by its owner (``models/dien.py``), which
also holds the running statistics.

Hidden matmuls run in bf16 on f32-stored params; the final activation runs
in f32 for numerically clean sigmoids.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from recommender_tpu.nn.layers import dense, dense_init


@dataclasses.dataclass(frozen=True)
class MLP:
    """Stack of dense layers ``Dense_0 .. Dense_{n-1}``.

    ``units[:-1]`` use ``activation``; the last layer uses
    ``final_activation`` (None = linear).
    """

    units: Sequence[int]
    activation: Callable = jax.nn.relu
    final_activation: Optional[Callable] = None
    compute_dtype: jnp.dtype = jnp.bfloat16

    def init(self, key, in_dim: int) -> dict:
        keys = jax.random.split(key, len(self.units))
        dims = (in_dim, *self.units)
        return {
            f"Dense_{i}": dense_init(keys[i], dims[i], dims[i + 1])
            for i in range(len(self.units))
        }

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        orig_dtype = x.dtype
        for i in range(len(self.units)):
            x = dense(params[f"Dense_{i}"], x, self.compute_dtype)
            if i < len(self.units) - 1:
                x = self.activation(x)
            elif self.final_activation is not None:
                x = self.final_activation(x.astype(jnp.float32))
        return x.astype(jnp.float32) if x.dtype != orig_dtype else x

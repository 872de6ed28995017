"""DCNv2 cross network — explicit bounded-degree feature crosses.

No reference counterpart (the reference's CTR zoo is DeepFM + DLRM);
added because the cross network is the third standard CTR interaction
family and it drops into the existing shared-embedding pipeline
unchanged. Wang et al. 2021 ("DCN V2"), full-rank W form:

    x_{l+1} = x_0 ⊙ (W_l x_l + b_l) + x_l

Each layer multiplies the ORIGINAL input element-wise against a dense
projection of the current state, so layer l represents all crosses up to
degree l+1 with d² parameters — one [d, d] matmul per layer, no dynamic
shapes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from recommender_tpu.nn.layers import dense, dense_init


@dataclasses.dataclass(frozen=True)
class CrossNetwork:
    """Stack of DCNv2 cross layers ``cross_0..`` over a fixed-width input [B, d]."""

    num_layers: int = 3

    def init(self, key, x0: jnp.ndarray) -> dict:
        d = x0.shape[-1]
        keys = jax.random.split(key, self.num_layers)
        return {f"cross_{i}": dense_init(keys[i], d, d) for i in range(self.num_layers)}

    def apply(self, params: dict, x0: jnp.ndarray) -> jnp.ndarray:
        x = x0
        for i in range(self.num_layers):
            # Dense = W_l x + b_l; the residual keeps lower-degree crosses
            x = x0 * dense(params[f"cross_{i}"], x) + x
        return x

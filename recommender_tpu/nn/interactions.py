"""Feature-interaction layers: FM second-order cross and DLRM dot interaction.

Parity targets:
* ``fm_cross`` — the sum-square/square-sum identity at ``ctr/model.py:21-23``.
* ``DotInteraction`` — pairwise dots at ``ctr/layers.py:17-43`` with the
  ``self_interaction`` and ``skip_gather`` flags. With ``skip_gather=True``
  the upper-triangle values are kept in a zero-filled dense ``F*F`` output
  (the variant DLRM actually uses; its top-MLP input width depends on it,
  ``ctr/model.py:55``): one batched matmul plus a static mask, no gather.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


def fm_cross(embeddings: jnp.ndarray) -> jnp.ndarray:
    """FM 2nd-order term. ``embeddings``: [B, F, D] → [B].

    0.5 * sum_d ((sum_f e)^2 - sum_f e^2): O(B·F·D), no pairwise matmul.
    """
    sum_sq = jnp.square(jnp.sum(embeddings, axis=1))  # [B, D]
    sq_sum = jnp.sum(jnp.square(embeddings), axis=1)  # [B, D]
    return 0.5 * jnp.sum(sum_sq - sq_sum, axis=1)  # [B]


@dataclasses.dataclass(frozen=True)
class DotInteraction:
    """Pairwise dot products between feature embeddings (no params).

    Input [B, F, D] → output:
      * ``skip_gather=True``:  [B, F*F] (upper triangle kept, rest zeros)
      * ``skip_gather=False``: [B, F*(F±1)/2] (compact, gathered)
    """

    self_interaction: bool = False
    skip_gather: bool = True

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        b, f, d = x.shape
        xc = x.astype(jnp.bfloat16)
        grid = jnp.einsum(
            "bfd,bgd->bfg", xc, xc, preferred_element_type=jnp.float32
        )  # [B, F, F]
        # static (trace-time) triangle mask — no device gather needed
        k = 0 if self.self_interaction else 1
        tri = np.triu(np.ones((f, f), dtype=bool), k=k)
        if self.skip_gather:
            out = jnp.where(tri[None, :, :], grid, 0.0)
            return out.reshape(b, f * f)
        flat = grid.reshape(b, f * f)
        idx = np.nonzero(tri.reshape(-1))[0]  # static index set
        return flat[:, idx]

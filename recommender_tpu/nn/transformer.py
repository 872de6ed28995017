"""Post-LN transformer encoder block for behavior sequences (BST).

No reference counterpart (the reference's sequence zoo stops at DIEN);
added because self-attention is the standard modern alternative to the
AUGRU recurrence: the whole block is batched matmuls with NO sequential
scan — one attention over [B, L, D] instead of T dependent steps.

Masking contract matches the rest of the sequence stack: pad positions
(id 0) are excluded as KEYS; their own outputs are dropped by the
caller's masked pooling (they attend freely — garbage-in positions whose
outputs are never read).

Attention materializes the [B, H, L, L] scores and lets XLA fuse the
softmax chain. At BST's head dim (9) no fused attention kernel applies.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from recommender_tpu.nn.layers import dense, dense_init, layer_norm, lecun_normal, norm_init


@dataclasses.dataclass(frozen=True)
class TransformerBlock:
    """MHSA + FFN, each with residual + LayerNorm (post-LN, BST-style).

    Params: ``qkv`` (kernel [D, 3, H, Dh]), ``out`` (kernel [H, Dh, D]),
    ``LayerNorm_0``, ``Dense_0``/``Dense_1`` (the FFN), ``LayerNorm_1``."""

    dim: int
    num_heads: int = 2
    ffn_mult: int = 4

    def init(self, key, x: jnp.ndarray, valid: jnp.ndarray) -> dict:
        H = self.num_heads
        Dh = self.dim // H
        d_in = x.shape[-1]
        kq, ko, k0, k1 = jax.random.split(key, 4)
        return {
            # lecun fan over the flattened kernel, as for a [d_in, 3·H·Dh] dense
            "qkv": {
                "kernel": lecun_normal(kq, (d_in, 3 * H * Dh)).reshape(d_in, 3, H, Dh),
                "bias": jnp.zeros((3, H, Dh)),
            },
            "out": {
                "kernel": lecun_normal(ko, (H * Dh, self.dim)).reshape(H, Dh, self.dim),
                "bias": jnp.zeros((self.dim,)),
            },
            "LayerNorm_0": norm_init(self.dim),
            "Dense_0": dense_init(k0, self.dim, self.dim * self.ffn_mult),
            "Dense_1": dense_init(k1, self.dim * self.ffn_mult, self.dim),
            "LayerNorm_1": norm_init(self.dim),
        }

    def apply(self, params: dict, x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        """x: [B, L, D]; valid: [B, L] (1 = real position, 0 = pad —
        pads are masked out as attention KEYS)."""
        Dh = self.dim // self.num_heads
        qkv = jnp.einsum("bld,dthe->blthe", x, params["qkv"]["kernel"]) + params["qkv"]["bias"]
        q, k, v = (qkv[..., i, :, :] for i in range(3))  # [B, L, H, Dh]
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / (Dh ** 0.5)
        s = jnp.where(valid[:, None, None, :] > 0, s, -1e30)
        o = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)
        a = jnp.einsum("blhd,hde->ble", o, params["out"]["kernel"]) + params["out"]["bias"]
        x = layer_norm(params["LayerNorm_0"], x + a)
        f = jax.nn.relu(dense(params["Dense_0"], x))
        f = dense(params["Dense_1"], f)
        return layer_norm(params["LayerNorm_1"], x + f)

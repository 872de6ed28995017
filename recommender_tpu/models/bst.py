"""BST — Behavior Sequence Transformer over the DIEN batch schema.

Beyond-reference model (Chen et al. 2019, Alibaba; the reference's
sequence zoo stops at DIEN): self-attention with learned positions over
[history ∥ target], the modern replacement for the GRU/AUGRU recurrence.
Drops into the existing family unchanged — same shared item/cat tables
and batch schema as BASE/DIN/DIEN (``dien/data_loader.py:35-63``:
target_item/cat, pos_his_item/cat padded with 0, label), same
``partition``/``lookup_mode``/``embed_param_dtype`` knobs via
``SequenceBase``, trained by ``cli/train_dien --model_type BST``.

The whole forward is batched matmuls — no ``lax.scan`` at
all — so unlike DIEN there is no sequential dependency to unroll or
remat; T=100 costs one [B, 101, 101] attention instead of 100 dependent
GRU steps.

Readout divergence from the paper (documented): the paper flattens every
position into the final MLP; with variable-length zero-padded histories
that feeds pad positions to the head, so instead the head gets
[target-position output ∥ masked mean of history outputs] — the same
fixed-shape, pad-robust readout contract as the rest of the family
(``SequenceBase.head``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from recommender_tpu.models.dien import SequenceBase
from recommender_tpu.nn.sequence import masked_mean_pool
from recommender_tpu.nn.transformer import TransformerBlock


@dataclasses.dataclass(frozen=True)
class BST(SequenceBase):
    """Extra params: ``block_i`` (TransformerBlock), ``positions/embedding``."""

    # 2 blocks / 4 heads is the smallest setting that passes BOTH mechanism
    # ladders (tests/test_synthetic_drift.py, test_synthetic_membership.py):
    # 1 block learns the order (drift) regime but stalls at 0.63 AUC on
    # fine-grained membership (50 distractor categories), while 2 blocks
    # reach 1.0 by 3k steps.
    num_heads: int = 4
    num_blocks: int = 2
    ffn_mult: int = 4
    max_len: int = 512  # position table size; histories up to max_len-1

    @property
    def block(self) -> TransformerBlock:
        return TransformerBlock(dim=self.dim, num_heads=self.num_heads, ffn_mult=self.ffn_mult)

    def _init_extra(self, key) -> dict:
        keys = jax.random.split(key, self.num_blocks + 1)
        x = jax.ShapeDtypeStruct((1, 1, self.dim), jnp.float32)
        params = {f"block_{i}": self.block.init(keys[i], x, None) for i in range(self.num_blocks)}
        # learned positions: normal with variance 1/dim
        params["positions"] = {
            "embedding": jax.nn.initializers.variance_scaling(
                1.0, "fan_in", "normal", out_axis=0
            )(keys[-1], (self.max_len, self.dim))
        }
        return params

    def _forward(self, params, target, his, mask):
        his = his[0]  # [B, T, D]
        B, T = mask.shape
        # sequence = history steps 0..T-1, target at position T
        seq = jnp.concatenate([his, target[:, None, :]], axis=1)  # [B, T+1, D]
        valid = jnp.concatenate(
            [mask, jnp.ones((B, 1), jnp.float32)], axis=1)  # [B, T+1]
        x = seq + params["positions"]["embedding"][: T + 1][None]
        # keys masked to valid positions; pad QUERIES produce garbage that
        # the masked readout never reads (nn/transformer.py contract)
        for i in range(self.num_blocks):
            x = self.block.apply(params[f"block_{i}"], x, valid)
        h_target = x[:, -1]
        pooled = masked_mean_pool(x[:, :-1], mask)
        # head input: [target-position output ∥ pooled history outputs]
        return h_target, pooled, None

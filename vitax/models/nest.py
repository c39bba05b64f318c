"""NesT — nested/blocked transformer hierarchy (reference: nest.py:134-193).

The image is patchified, split into 4^k non-overlapping blocks which run a
shared transformer with sequence length held constant across hierarchies
(nest.py:152), then blocks are merged and aggregated (conv+LN+maxpool,
nest.py:91-99). Block attention folds the blocks into the flash kernel's
batch axis.

Fix-or-match: the reference's per-hierarchy positional embedding is a 1-D
scalar-per-token parameter broadcast over channels (nest.py:114,124-126);
this build learns the standard per-(token, channel) embedding.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.core.utils import cast_tuple
from vitax.nn.conv import Aggregate, ConvMLP


class _BlockAttention(nn.Module):
    """Full attention inside one block fmap (nest.py:60-89);
    heads = dim // dim_head with dim_head fixed by the hierarchy."""

    dim: int
    heads: int
    dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        b, h, w, _ = x.shape
        dim_head = self.dim // self.heads
        inner = dim_head * self.heads
        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="norm")(x)
        qkv = nn.Dense(inner * 3, use_bias=False, dtype=self.dtype, name="to_qkv")(x)
        out = ops.qkv_attention(
            qkv.reshape(b, h * w, inner * 3), self.heads, scale=dim_head**-0.5
        )
        out = out.reshape(b, h, w, inner)
        out = nn.Dense(self.dim, use_bias=False, dtype=self.dtype, name="to_out")(out)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=deterministic)


class NesT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    heads: int
    num_hierarchies: int
    block_repeats: tuple
    mlp_mult: int = 4
    dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        assert self.image_size % self.patch_size == 0
        fmap_size = self.image_size // self.patch_size
        top_blocks = 2 ** (self.num_hierarchies - 1)
        seq_len = (fmap_size // top_blocks) ** 2

        # dims/heads double per hierarchy going up (nest.py:153-157)
        mults = [2**i for i in range(self.num_hierarchies)]
        layer_dims = [m * self.dim for m in mults]
        layer_heads = [m * self.heads for m in mults]
        block_repeats = cast_tuple(self.block_repeats, self.num_hierarchies)

        # patchify + conv1x1 projection (nest.py:176-177)
        x = ops.patchify(img, self.patch_size)
        b = x.shape[0]
        x = x.reshape(b, fmap_size, fmap_size, -1)
        x = nn.Dense(layer_dims[0], dtype=self.dtype, name="proj")(x)

        for li in range(self.num_hierarchies):
            level = self.num_hierarchies - 1 - li  # top-down: most blocks first
            dim = layer_dims[li]
            heads = layer_heads[li]
            n_blocks = 2**level

            x = ops.block_partition(x, n_blocks)
            bh, bw = x.shape[1], x.shape[2]
            assert bh * bw == seq_len

            pos = self.param(
                f"pos_emb_{li}",
                nn.initializers.truncated_normal(0.02),
                (1, bh, bw, dim),
                jnp.float32,
            )
            x = x + pos.astype(x.dtype)

            for d in range(block_repeats[li]):
                x = x + _BlockAttention(
                    dim, heads, self.dropout, dtype=self.dtype, name=f"attn_{li}_{d}"
                )(x, deterministic=det)
                x = x + ConvMLP(
                    dim, self.mlp_mult, self.dropout, dtype=self.dtype, name=f"ff_{li}_{d}"
                )(x, deterministic=det)

            x = ops.block_unpartition(x, n_blocks)
            if li + 1 < self.num_hierarchies:
                x = Aggregate(layer_dims[li + 1], dtype=self.dtype, name=f"agg_{li}")(x)

        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="head_norm")(x)
        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

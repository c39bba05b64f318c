"""PiT — Pooling-based Vision Transformer (reference: pit.py:167-240).

Overlapping patchify (stride = patch/2) feeds a cls-token encoder; between
stages a Pool layer halves the spatial tokens with a stride-2 depthwise conv
while doubling the dim, projecting the cls token with a Dense
(pit.py:130-148).

Fixes over the reference: the host-side ``tf.image.extract_patches`` call
(pit.py:212-218) is replaced with the in-graph overlapping-patch gather, so
the whole model jits; and the ``not_last`` bug (pit.py:199 — always False,
so the reference never pools and never doubles dims, bug register #2) is
corrected: pooling actually runs, as the paper intends.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.core.utils import cast_tuple, conv_output_size
from vitax.nn.blocks import Transformer
from vitax.nn.conv import Pool


class PiT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: tuple
    heads: int
    mlp_dim: int
    dim_head: int = 64
    dropout: float = 0.0
    emb_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        assert self.image_size % self.patch_size == 0
        assert isinstance(self.depth, tuple), (
            "depth must be a tuple: blocks per stage before each downsize"
        )
        heads = cast_tuple(self.heads, len(self.depth))

        out_side = conv_output_size(self.image_size, self.patch_size, self.patch_size // 2)
        num_patches = out_side**2

        # overlapping patchify, in-graph (replaces pit.py:212-218 TF host call)
        x = ops.extract_patches(img, self.patch_size, self.patch_size // 2, padding="VALID")
        b = x.shape[0]
        x = x.reshape(b, num_patches, -1)
        x = nn.Dense(self.dim, dtype=self.dtype, name="proj")(x)

        cls = self.param(
            "cls", nn.initializers.truncated_normal(0.02), (1, 1, self.dim), jnp.float32
        )
        pos = self.param(
            "pos_embedding",
            nn.initializers.truncated_normal(0.02),
            (1, num_patches + 1, self.dim),
            jnp.float32,
        )
        x = jnp.concatenate([jnp.broadcast_to(cls.astype(x.dtype), (b, 1, self.dim)), x], axis=1)
        x = x + pos.astype(x.dtype)
        x = nn.Dropout(self.emb_dropout, name="emb_drop")(x, deterministic=det)

        dim = self.dim
        for s, (stage_depth, stage_heads) in enumerate(zip(self.depth, heads)):
            x = Transformer(
                dim=dim,
                depth=stage_depth,
                heads=stage_heads,
                dim_head=self.dim_head,
                mlp_dim=self.mlp_dim,
                dropout=self.dropout,
                norm_eps=1e-5,
                dtype=self.dtype,
                name=f"stage_{s}",
            )(x, deterministic=det)
            if s + 1 < len(self.depth):
                dim *= 2
                x = Pool(dim, dtype=self.dtype, name=f"pool_{s}")(x)

        x = x[:, 0]
        x = nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=self.dtype, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

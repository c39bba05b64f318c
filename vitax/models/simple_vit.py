"""SimpleViT — Beyer et al. "Better plain ViT baselines" (reference:
simple_vit.py:99-134, which crashes at init on modern JAX — bug register #12).

Differences from ViT: no cls token, no dropout, fixed 2-D sin-cos positional
embedding, mean pooling, norm-first bias-free feed-forward. The reference
takes NCHW input unlike every other model (bug register #16); this build is
NHWC like the rest of the framework and accepts ``channels_first=True`` for
reference-snippet compatibility.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.core.utils import pair
from vitax.nn.blocks import Transformer
from vitax.nn.embed import PatchEmbed


class SimpleViT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: int
    heads: int
    mlp_dim: int
    channels: int = 3
    dim_head: int = 64
    channels_first: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        if self.channels_first:
            img = img.transpose(0, 2, 3, 1)
        ih, iw = pair(self.image_size)
        ph, pw = pair(self.patch_size)

        x = PatchEmbed(self.dim, ph, dtype=self.dtype, name="patch_embed")(img)
        pe = ops.posemb_sincos_2d(ih // ph, iw // pw, self.dim, dtype=x.dtype)
        x = x + pe[None]

        x = Transformer(
            dim=self.dim,
            depth=self.depth,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_dim=self.mlp_dim,
            norm_eps=1e-5,
            dtype=self.dtype,
            name="encoder",
        )(x, deterministic=not train)

        x = jnp.mean(x, axis=1)
        x = nn.LayerNorm(
            epsilon=1e-5, use_bias=False, dtype=jnp.float32, name="head_norm"
        )(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

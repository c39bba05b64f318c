"""PatchMerger-ViT — mid-stack learned token merging (reference:
patch_merger.py:132-185, which crashes at init on modern JAX — bug register
#12; its merger queries were also drawn from a fixed PRNG instead of learned,
bug register #4 — learned here).

``PatchMerger`` itself is exported standalone as in the reference README
(README.md:464-476).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import default, pair
from vitax.nn.attention import Attention
from vitax.nn.blocks import FeedForward
from vitax.nn.embed import PatchEmbed, PatchMerger


class PatchMergerViT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: int
    heads: int
    mlp_dim: int
    patch_merge_layer: Optional[int] = None
    patch_merge_num_tokens: int = 8
    dim_head: int = 64
    dropout: float = 0.0
    emb_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        ih, iw = pair(self.image_size)
        ph, pw = pair(self.patch_size)
        num_patches = (ih // ph) * (iw // pw)
        merge_at = default(self.patch_merge_layer, self.depth // 2)

        x = PatchEmbed(self.dim, ph, dtype=self.dtype, name="patch_embed")(img)

        pos = self.param(
            "pos_embedding",
            nn.initializers.truncated_normal(0.02),
            (1, num_patches, self.dim),
            jnp.float32,
        )
        x = x + pos.astype(x.dtype)
        x = nn.Dropout(self.emb_dropout, name="emb_drop")(x, deterministic=not train)

        for i in range(self.depth):
            x = x + Attention(
                dim=self.dim,
                heads=self.heads,
                dim_head=self.dim_head,
                dropout=self.dropout,
                norm_eps=1e-5,
                dtype=self.dtype,
                name=f"attn_{i}",
            )(x, deterministic=not train)
            x = x + FeedForward(
                self.dim, self.mlp_dim, self.dropout, ln_eps=1e-5,
                dtype=self.dtype, name=f"ff_{i}"
            )(x, deterministic=not train)
            if i + 1 == merge_at:
                x = PatchMerger(
                    self.dim, self.patch_merge_num_tokens, dtype=self.dtype, name="merger"
                )(x)

        x = jnp.mean(x, axis=1)
        x = nn.LayerNorm(dtype=jnp.float32, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

"""ViT for small datasets — SPT + LSA (reference: vit_small_datasets.py:155-224).

Shifted Patch Tokenization expands the input with four 1-px diagonal shifts
before patchify (vit_small_datasets.py:134-153); Locality Self-Attention
masks the diagonal and uses a learnable temperature. The reference froze the
temperature to a constant (bug register #7) and carried a dead torch import
(#8); the temperature is a learned parameter here (initialized to the same
value, so init-time parity holds).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.blocks import Transformer
from vitax.nn.embed import SPT


class ViTSmallDatasets(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: int
    heads: int
    mlp_dim: int
    pool: str = "cls"
    dim_head: int = 64
    dropout: float = 0.0
    emb_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        ih, iw = pair(self.image_size)
        ph, pw = pair(self.patch_size)
        num_patches = (ih // ph) * (iw // pw)
        assert self.pool in {"cls", "mean"}

        x = SPT(self.dim, ph, dtype=self.dtype, name="spt")(img)
        b = x.shape[0]

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
        x = nn.Dropout(self.emb_dropout, name="emb_drop")(x, deterministic=not train)

        x = Transformer(
            dim=self.dim,
            depth=self.depth,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_dim=self.mlp_dim,
            dropout=self.dropout,
            mask_self=True,
            learned_temperature=True,
            norm_eps=1e-5,
            dtype=self.dtype,
            name="encoder",
        )(x, deterministic=not train)

        x = x[:, 0] if self.pool == "cls" else jnp.mean(x, axis=1)
        x = nn.LayerNorm(dtype=jnp.float32, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

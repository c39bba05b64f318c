"""EfficientViT — the dependency-injected ViT shell (reference:
efficient.py:15-59, broken as-is by an undefined attribute, bug register #1;
fixed here with a real ``emb_dropout`` field).

Any encoder with signature ``transformer(x, deterministic=...)`` (e.g. a
``vitax.nn.Transformer`` instance, or any custom efficient-attention
stack) plugs into the standard embed/pool/head shell.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.embed import PatchEmbed


class EfficientViT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    transformer: Any
    pool: str = "cls"
    emb_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        ih, iw = pair(self.image_size)
        ph, pw = pair(self.patch_size)
        num_patches = (ih // ph) * (iw // pw)
        assert self.pool in {"cls", "mean"}

        x = PatchEmbed(self.dim, ph, dtype=self.dtype, name="patch_embed")(img)
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

        try:
            x = self.transformer(x, deterministic=not train)
        except TypeError:
            x = self.transformer(x)

        x = x[:, 0] if self.pool == "cls" else jnp.mean(x, axis=1)
        x = nn.LayerNorm(dtype=jnp.float32, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

"""ParallelViT — "Three things everyone should know about ViTs"
(reference: parallel_vit.py:110-164, which crashes at init on modern JAX —
bug register #12).

Each depth runs ``num_parallel_branches`` independent attention branches
summed into the residual, then the same for feed-forward
(parallel_vit.py:99-107). The summed branches are independent GEMMs over the
same input; the module layer expresses this
as N submodules whose outputs XLA fuses into one residual add.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.blocks import Transformer
from vitax.nn.embed import PatchEmbed


class ParallelViT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: int
    heads: int
    mlp_dim: int
    pool: str = "cls"
    num_parallel_branches: int = 2
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

        x = Transformer(
            dim=self.dim,
            depth=self.depth,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_dim=self.mlp_dim,
            dropout=self.dropout,
            parallel_branches=self.num_parallel_branches,
            norm_eps=1e-5,
            dtype=self.dtype,
            name="encoder",
        )(x, deterministic=not train)

        x = x[:, 0] if self.pool == "cls" else jnp.mean(x, axis=1)
        x = nn.LayerNorm(dtype=jnp.float32, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

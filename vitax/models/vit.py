"""ViT — the vanilla Dosovitskiy encoder (reference: vit.py:114-166).

Constructor signature matches the reference ``ViT`` dataclass
(vit.py:115-125) for drop-in use; unlike the reference this model uses
deterministic inference by
default (``train=True`` enables dropout — reference hardcodes
``deterministic=False``, bug register #10), and initializes ``pos_embedding``
and ``cls`` with truncated normal rather than zeros (bug register #15).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.blocks import Transformer
from vitax.nn.embed import PatchEmbed


class ViT(nn.Module):
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
    # Interop knobs (HF/timm ViT checkpoints, utils/interop.py): bias on
    # the qkv projections, erf GELU, and the checkpoint's LayerNorm eps.
    qkv_bias: bool = False
    activation: str = "gelu"
    norm_eps: float = 1e-6
    dtype: Optional[jnp.dtype] = None
    # Mixed precision: keep the residual stream in this dtype while the
    # GEMMs run in ``dtype`` (set fp32 + bf16 for near-fp32 logits at
    # bf16 matrix-product speed). None = residual stream follows ``dtype``.
    residual_dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        ih, iw = pair(self.image_size)
        ph, pw = pair(self.patch_size)
        assert ih % ph == 0 and iw % pw == 0, "image size must divide by patch size"
        assert self.pool in {"cls", "mean"}
        num_patches = (ih // ph) * (iw // pw)

        x = PatchEmbed(
            self.dim, ph, dtype=self.dtype,
            out_dtype=self.residual_dtype or self.dtype,
            name="patch_embed",
        )(img)
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
            qkv_bias=self.qkv_bias,
            activation=self.activation,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
            name="encoder",
        )(x, deterministic=not train)

        x = x[:, 0] if self.pool == "cls" else jnp.mean(x, axis=1)
        x = nn.LayerNorm(epsilon=self.norm_eps, dtype=jnp.float32, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

"""CrossViT — dual-branch multi-scale ViT (reference: cross_vit.py:224-284).

Two patch scales run parallel encoders; after each encoding round the cls
token of each branch cross-attends the *other* branch's patch tokens
(kv including itself, cross_vit.py:155-157), bridged through Dense
projections when branch dims differ (ProjectInOut, cross_vit.py:105-130).
Logits are the sum of the two branch heads (cross_vit.py:278-284).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.attention import Attention
from vitax.nn.blocks import Transformer
from vitax.nn.embed import PatchEmbed


class _ImageEmbedder(nn.Module):
    """Patchify + cls + learned pos + dropout for one branch
    (cross_vit.py:196-221)."""

    dim: int
    image_size: int
    patch_size: int
    dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img, deterministic: bool = True):
        ih, iw = pair(self.image_size)
        num_patches = (ih // self.patch_size) * (iw // self.patch_size)
        x = PatchEmbed(self.dim, self.patch_size, dtype=self.dtype, name="patch_embed")(img)
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
        return nn.Dropout(self.dropout, name="drop")(x, deterministic=deterministic)


class _CrossAttendBlock(nn.Module):
    """One round of bidirectional cls<->patch cross-attention
    (cross_vit.py:133-163): each branch's cls token is projected into the
    other branch's width (skipped when widths match, cross_vit.py:114-116),
    pre-norm cross-attends the other branch's patch tokens (kv including
    the projected cls itself), projects back, and adds to the unprojected
    cls residually."""

    sm_dim: int
    lg_dim: int
    heads: int
    dim_head: int
    dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    def _attend(self, cls, patches, dim_in, dim_out, name, deterministic):
        q = cls
        if dim_in != dim_out:
            q = nn.Dense(dim_out, dtype=self.dtype, name=f"{name}_proj_in")(q)
        out = Attention(
            dim=dim_out,
            heads=self.heads,
            dim_head=self.dim_head,
            dropout=self.dropout,
            norm_eps=1e-5,
            dtype=self.dtype,
            name=name,
        )(q, context=patches, kv_include_self=True, deterministic=deterministic)
        if dim_in != dim_out:
            out = nn.Dense(dim_in, dtype=self.dtype, name=f"{name}_proj_out")(out)
        return cls + out

    @nn.compact
    def __call__(self, sm, lg, deterministic: bool = True):
        sm_cls, sm_patches = sm[:, :1], sm[:, 1:]
        lg_cls, lg_patches = lg[:, :1], lg[:, 1:]

        sm_cls = self._attend(
            sm_cls, lg_patches, self.sm_dim, self.lg_dim, "sm_attends_lg", deterministic
        )
        lg_cls = self._attend(
            lg_cls, sm_patches, self.lg_dim, self.sm_dim, "lg_attends_sm", deterministic
        )

        sm = jnp.concatenate([sm_cls, sm_patches], axis=1)
        lg = jnp.concatenate([lg_cls, lg_patches], axis=1)
        return sm, lg


class CrossViT(nn.Module):
    image_size: int
    num_classes: int
    sm_dim: int
    lg_dim: int
    sm_patch_size: int = 12
    sm_enc_depth: int = 1
    sm_enc_heads: int = 8
    sm_enc_mlp_dim: int = 2048
    sm_enc_dim_head: int = 64
    lg_patch_size: int = 16
    lg_enc_depth: int = 4
    lg_enc_heads: int = 8
    lg_enc_mlp_dim: int = 2048
    lg_enc_dim_head: int = 64
    cross_attn_depth: int = 2
    cross_attn_heads: int = 8
    cross_attn_dim_head: int = 64
    depth: int = 3
    dropout: float = 0.1
    emb_dropout: float = 0.1
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        sm = _ImageEmbedder(
            self.sm_dim, self.image_size, self.sm_patch_size, self.emb_dropout,
            dtype=self.dtype, name="sm_embedder",
        )(img, deterministic=det)
        lg = _ImageEmbedder(
            self.lg_dim, self.image_size, self.lg_patch_size, self.emb_dropout,
            dtype=self.dtype, name="lg_embedder",
        )(img, deterministic=det)

        for i in range(self.depth):
            sm = Transformer(
                dim=self.sm_dim,
                depth=self.sm_enc_depth,
                heads=self.sm_enc_heads,
                dim_head=self.sm_enc_dim_head,
                mlp_dim=self.sm_enc_mlp_dim,
                dropout=self.dropout,
                final_norm=True,
                norm_eps=1e-5,
                dtype=self.dtype,
                name=f"sm_enc_{i}",
            )(sm, deterministic=det)
            lg = Transformer(
                dim=self.lg_dim,
                depth=self.lg_enc_depth,
                heads=self.lg_enc_heads,
                dim_head=self.lg_enc_dim_head,
                mlp_dim=self.lg_enc_mlp_dim,
                dropout=self.dropout,
                final_norm=True,
                norm_eps=1e-5,
                dtype=self.dtype,
                name=f"lg_enc_{i}",
            )(lg, deterministic=det)
            for j in range(self.cross_attn_depth):
                sm, lg = _CrossAttendBlock(
                    sm_dim=self.sm_dim,
                    lg_dim=self.lg_dim,
                    heads=self.cross_attn_heads,
                    dim_head=self.cross_attn_dim_head,
                    dropout=self.dropout,
                    dtype=self.dtype,
                    name=f"cross_{i}_{j}",
                )(sm, lg, deterministic=det)

        sm_logits = nn.Dense(
            self.num_classes, dtype=jnp.float32, name="sm_head"
        )(nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=jnp.float32, name="sm_head_norm")(sm[:, 0]))
        lg_logits = nn.Dense(
            self.num_classes, dtype=jnp.float32, name="lg_head"
        )(nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=jnp.float32, name="lg_head_norm")(lg[:, 0]))
        return sm_logits + lg_logits

"""CaiT — class-attention image transformer (reference: cait.py:146-185).

Two-stage encoder: ``depth`` layers of patch self-attention with
talking-heads and LayerScale, then ``cls_depth`` layers where the cls token
cross-attends the frozen patch tokens (cait.py:176-179; kv includes the cls
itself, cait.py:90-93).

Fixes over the reference (bug register #5/#6/#20): stochastic layer-dropout
is an in-graph per-sample bernoulli gate with a real rng (the reference
drops layers from the Python list with a fixed PRNGKey(0)); LayerScale is a
learned parameter with the paper's per-model-depth epsilon (the reference
used a frozen constant banded by layer index).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.attention import Attention
from vitax.nn.blocks import FeedForward, scan_unroll_for
from vitax.nn.embed import PatchEmbed


class _CaiTBlock(nn.Module):
    """One talking-heads attention + FF block with LayerScale and in-graph
    stochastic depth — the scan cell of a CaiT stage. ``context`` (broadcast
    through the scan) switches the attention to class-attention."""

    dim: int
    heads: int
    dim_head: int
    mlp_dim: int
    ls_eps: float
    dropout: float = 0.0
    layer_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, context=None, deterministic: bool = True):
        def gated_residual(x, delta, name):
            scale = self.param(
                f"ls_{name}",
                lambda rng, s: jnp.full(s, self.ls_eps, jnp.float32),
                (self.dim,),
            )
            delta = delta * scale.astype(delta.dtype)
            if self.layer_dropout > 0.0 and not deterministic:
                keep = jax.random.bernoulli(
                    self.make_rng("dropout"), 1.0 - self.layer_dropout, (x.shape[0], 1, 1)
                )
                delta = delta * keep.astype(delta.dtype) / (1.0 - self.layer_dropout)
            return x + delta

        a = Attention(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            dropout=self.dropout,
            talking_heads=True,
            norm_eps=1e-5,
            dtype=self.dtype,
            name="attn",
        )(x, context=context, kv_include_self=context is not None, deterministic=deterministic)
        x = gated_residual(x, a, "attn")
        f = FeedForward(
            self.dim, self.mlp_dim, self.dropout, ln_eps=1e-5,
            dtype=self.dtype, name="ff",
        )(x, deterministic=deterministic)
        x = gated_residual(x, f, "ff")
        return x, ()


class _CaiTStage(nn.Module):
    """A stack of CaiT blocks, scanned when homogeneous (depth > 1)."""

    dim: int
    depth: int
    heads: int
    dim_head: int
    mlp_dim: int
    model_depth: int  # for LayerScale epsilon banding (paper §3)
    dropout: float = 0.0
    layer_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, context=None, deterministic: bool = True):
        if self.model_depth <= 18:
            eps = 0.1
        elif self.model_depth <= 24:
            eps = 1e-5
        else:
            eps = 1e-6
        cfg = dict(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_dim=self.mlp_dim,
            ls_eps=eps,
            dropout=self.dropout,
            layer_dropout=self.layer_dropout,
            dtype=self.dtype,
        )
        if self.depth > 1:
            stacked = nn.scan(
                _CaiTBlock,
                variable_axes={"params": 0},
                split_rngs={"params": True, "dropout": True},
                length=self.depth,
                in_axes=nn.broadcast,
                unroll=scan_unroll_for(self.depth),
            )(**cfg, name="blocks")
            x, _ = stacked(x, context, deterministic)
        else:
            x, _ = _CaiTBlock(**cfg, name="blocks")(x, context, deterministic)
        return x


class CaiT(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: int
    cls_depth: int
    heads: int
    mlp_dim: int
    dim_head: int = 64
    dropout: float = 0.0
    emb_dropout: float = 0.0
    layer_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        ih, iw = pair(self.image_size)
        ph, pw = pair(self.patch_size)
        num_patches = (ih // ph) * (iw // pw)

        x = PatchEmbed(self.dim, ph, dtype=self.dtype, name="patch_embed")(img)
        b = x.shape[0]

        pos = self.param(
            "pos_embedding",
            nn.initializers.truncated_normal(0.02),
            (1, num_patches, self.dim),
            jnp.float32,
        )
        x = x + pos.astype(x.dtype)
        x = nn.Dropout(self.emb_dropout, name="emb_drop")(x, deterministic=not train)

        x = _CaiTStage(
            dim=self.dim,
            depth=self.depth,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_dim=self.mlp_dim,
            model_depth=self.depth,
            dropout=self.dropout,
            layer_dropout=self.layer_dropout,
            dtype=self.dtype,
            name="patch_stage",
        )(x, deterministic=not train)

        cls = self.param(
            "cls", nn.initializers.truncated_normal(0.02), (1, 1, self.dim), jnp.float32
        )
        cls_tokens = jnp.broadcast_to(cls.astype(x.dtype), (b, 1, self.dim))
        cls_tokens = _CaiTStage(
            dim=self.dim,
            depth=self.cls_depth,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_dim=self.mlp_dim,
            model_depth=self.depth,
            dropout=self.dropout,
            layer_dropout=self.layer_dropout,
            dtype=self.dtype,
            name="cls_stage",
        )(cls_tokens, context=x, deterministic=not train)

        out = cls_tokens[:, 0]
        out = nn.LayerNorm(dtype=jnp.float32, name="head_norm")(out)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(out)

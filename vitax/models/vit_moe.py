"""ViT-MoE — a V-MoE-style sparse ViT (framework extension, beyond the
reference's 17 families; NOT in MODEL_REGISTRY, which mirrors the
reference surface exactly).

Vanilla ViT trunk (models/vit.py) with the dense MLP of every
``moe_every``-th block replaced by a top-k routed expert MLP
(nn/moe.py). Exists to exercise expert parallelism end-to-end: the
expert axis shards over the ``model`` mesh axis via the standard
partition rules, so the GSPMD train step in ``vitax.train`` runs
dp×ep unchanged (tests/test_moe.py)."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import pair
from vitax.nn.attention import Attention
from vitax.nn.blocks import FeedForward
from vitax.nn.embed import PatchEmbed
from vitax.nn.moe import MoEFeedForward


class ViTMoE(nn.Module):
    image_size: int
    patch_size: int
    num_classes: int
    dim: int
    depth: int
    heads: int
    mlp_dim: int
    num_experts: int = 8
    num_selected: int = 2
    moe_every: int = 2  # every 2nd block is MoE (V-MoE's "last-2"-ish default)
    capacity_factor: float = 1.25
    pool: str = "cls"
    dim_head: int = 64
    dropout: float = 0.0
    norm_eps: float = 1e-6
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        ph, _ = pair(self.patch_size)
        x = PatchEmbed(self.dim, ph, dtype=self.dtype, name="patch_embed")(img)
        b, n = x.shape[0], x.shape[1]
        cls = self.param(
            "cls", nn.initializers.truncated_normal(0.02), (1, 1, self.dim), jnp.float32
        )
        pos = self.param(
            "pos_embedding", nn.initializers.truncated_normal(0.02),
            (1, n + 1, self.dim), jnp.float32,
        )
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(x.dtype), (b, 1, self.dim)), x], axis=1
        )
        x = x + pos.astype(x.dtype)

        for i in range(self.depth):
            x = Attention(
                dim=self.dim, heads=self.heads, dim_head=self.dim_head,
                dropout=self.dropout, fuse_residual=True,
                norm_eps=self.norm_eps, dtype=self.dtype, name=f"attn_{i}",
            )(x, deterministic=not train)
            if (i + 1) % self.moe_every == 0:
                x = x + MoEFeedForward(
                    dim=self.dim, hidden_dim=self.mlp_dim,
                    num_experts=self.num_experts,
                    num_selected=self.num_selected,
                    capacity_factor=self.capacity_factor,
                    dropout=self.dropout,
                    ln_eps=self.norm_eps, dtype=self.dtype, name=f"moe_{i}",
                )(x, deterministic=not train)
            else:
                x = x + FeedForward(
                    self.dim, self.mlp_dim, self.dropout, ln_eps=self.norm_eps,
                    dtype=self.dtype, name=f"ff_{i}",
                )(x, deterministic=not train)

        x = x[:, 0] if self.pool == "cls" else jnp.mean(x, axis=1)
        x = nn.LayerNorm(epsilon=self.norm_eps, dtype=jnp.float32, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=jnp.float32, name="head")(x)

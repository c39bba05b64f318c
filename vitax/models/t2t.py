"""T2T-ViT — progressive tokens-to-token aggregation (reference:
t2t.py:155-230).

The tokenizer alternates overlapping soft-splits with tiny 1-head depth-1
transformers (t2t.py:126-153), growing the token dim by kernel^2 per stage;
a Dense projects into the model dim and a standard cls-token encoder follows.

The reference's soft-split is a host-side ``tf.image.extract_patches``
(t2t.py:147 — a device->host->TF round trip inside the forward); replaced
with the in-graph TF-ordered overlapping-patch gather so the whole model
compiles as one XLA program.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.core.utils import conv_output_size, exists
from vitax.nn.blocks import Transformer


class T2TViT(nn.Module):
    image_size: int
    num_classes: int
    dim: int
    depth: Optional[int] = None
    heads: Optional[int] = None
    mlp_dim: Optional[int] = None
    pool: str = "cls"
    channels: int = 3
    dim_head: int = 64
    dropout: float = 0.0
    emb_dropout: float = 0.0
    transformer: Any = None
    t2t_layers: tuple = ((7, 4), (3, 2), (3, 2))
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        assert self.pool in {"cls", "mean"}

        x = img
        layer_dim = self.channels
        side = self.image_size
        b = x.shape[0]
        for i, (kernel, stride) in enumerate(self.t2t_layers):
            layer_dim *= kernel**2
            is_last = i == len(self.t2t_layers) - 1
            side = conv_output_size(side, kernel, stride, stride // 2)
            # soft split: overlapping patches, TF SAME-pad order (t2t.py:147)
            x = ops.extract_patches(x, kernel, stride, padding="SAME")
            x = x.reshape(b, side * side, layer_dim)
            if not is_last:
                x = Transformer(
                    dim=layer_dim,
                    depth=1,
                    heads=1,
                    dim_head=layer_dim,
                    mlp_dim=layer_dim,
                    dropout=self.dropout,
                    norm_eps=1e-5,
                    dtype=self.dtype,
                    name=f"t2t_{i}",
                )(x, deterministic=det)
                x = x.reshape(b, side, side, layer_dim)

        x = nn.Dense(self.dim, dtype=self.dtype, name="proj")(x)

        cls = self.param(
            "cls", nn.initializers.truncated_normal(0.02), (1, 1, self.dim), jnp.float32
        )
        pos = self.param(
            "pos_embedding",
            nn.initializers.truncated_normal(0.02),
            (1, side * side + 1, self.dim),
            jnp.float32,
        )
        x = jnp.concatenate([jnp.broadcast_to(cls.astype(x.dtype), (b, 1, self.dim)), x], axis=1)
        x = x + pos.astype(x.dtype)
        x = nn.Dropout(self.emb_dropout, name="emb_drop")(x, deterministic=det)

        if exists(self.transformer):
            encoder = self.transformer
            try:
                x = encoder(x, deterministic=det)
            except TypeError:
                x = encoder(x)
        else:
            assert all(map(exists, (self.depth, self.heads, self.mlp_dim))), (
                "depth, heads, and mlp_dim must be supplied when no custom "
                "transformer is injected"
            )
            x = Transformer(
                dim=self.dim,
                depth=self.depth,
                heads=self.heads,
                dim_head=self.dim_head,
                mlp_dim=self.mlp_dim,
                dropout=self.dropout,
                norm_eps=1e-5,
                dtype=self.dtype,
                name="encoder",
            )(x, deterministic=det)

        x = jnp.mean(x, axis=1) if self.pool == "mean" else x[:, 0]
        x = nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=self.dtype, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

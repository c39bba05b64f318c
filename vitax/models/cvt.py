"""CvT — Convolutional vision Transformer (reference: cvt.py:138-276).

Three stages of strided conv token embedding + channel LayerNorm + conv-
projection attention: queries from a depthwise conv (stride 1), keys/values
from a depthwise conv with ``kv_proj_stride`` (cvt.py:93-96), no positional
encoding anywhere (the paper's point). The depthwise projections carry
BatchNorm (cvt.py:73) so the model has ``batch_stats`` state: pass
``train=True`` (with ``mutable=['batch_stats']``) for batch-stat updates;
inference uses the running averages — unlike the reference, which hardcodes
training-mode BN at all times (cvt.py:73, ``mutable`` required forever).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.nn.attention import mha_tokens
from vitax.nn.conv import ConvMLP, DepthWiseConv2d


class _ConvAttention(nn.Module):
    dim: int
    proj_kernel: int
    kv_proj_stride: int
    heads: int = 8
    dim_head: int = 64
    dropout: float = 0.0
    fold_bn: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False, deterministic: bool = True) -> jax.Array:
        inner = self.heads * self.dim_head
        b, h, w, _ = x.shape

        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="norm")(x)
        q = DepthWiseConv2d(
            self.dim, inner, self.proj_kernel, stride=1, use_bias=False,
            batch_norm=True, fold_bn=self.fold_bn, dtype=self.dtype, name="to_q",
        )(x, train=train)
        kv = DepthWiseConv2d(
            self.dim, inner * 2, self.proj_kernel, stride=self.kv_proj_stride,
            use_bias=False, batch_norm=True, fold_bn=self.fold_bn,
            dtype=self.dtype, name="to_kv",
        )(x, train=train)
        k, v = jnp.split(kv.reshape(b, -1, inner * 2), 2, axis=-1)

        out = mha_tokens(
            q.reshape(b, h * w, inner), k, v, self.heads, scale=self.dim_head**-0.5
        )
        out = nn.Dense(self.dim, use_bias=False, dtype=self.dtype, name="to_out")(
            out.reshape(b, h, w, inner)
        )
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=deterministic)


class CvT(nn.Module):
    num_classes: int
    s1_emb_dim: int = 64
    s1_emb_kernel: int = 7
    s1_emb_stride: int = 4
    s1_proj_kernel: int = 3
    s1_kv_proj_stride: int = 2
    s1_heads: int = 1
    s1_depth: int = 1
    s1_mlp_mult: int = 4
    s2_emb_dim: int = 192
    s2_emb_kernel: int = 3
    s2_emb_stride: int = 2
    s2_proj_kernel: int = 3
    s2_kv_proj_stride: int = 2
    s2_heads: int = 3
    s2_depth: int = 2
    s2_mlp_mult: int = 4
    s3_emb_dim: int = 384
    s3_emb_kernel: int = 3
    s3_emb_stride: int = 2
    s3_proj_kernel: int = 3
    s3_kv_proj_stride: int = 2
    s3_heads: int = 6
    s3_depth: int = 10
    s3_mlp_mult: int = 4
    dropout: float = 0.0
    # Inference-mode graph after ``utils.fold_batch_norm``: every BN is
    # folded into its producing depthwise conv and vanishes from the graph.
    fold_bn: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        x = img
        for s in (1, 2, 3):
            g = lambda k: getattr(self, f"s{s}_{k}")
            x = nn.Conv(
                g("emb_dim"),
                (g("emb_kernel"), g("emb_kernel")),
                strides=g("emb_stride"),
                padding="SAME",
                dtype=self.dtype,
                name=f"embed_{s}",
            )(x)
            x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name=f"embed_norm_{s}")(x)
            for i in range(g("depth")):
                x = x + _ConvAttention(
                    g("emb_dim"), g("proj_kernel"), g("kv_proj_stride"),
                    heads=g("heads"), dropout=self.dropout, fold_bn=self.fold_bn,
                    dtype=self.dtype, name=f"attn_{s}_{i}",
                )(x, train=train, deterministic=det)
                x = x + ConvMLP(
                    g("emb_dim"), g("mlp_mult"), self.dropout, dtype=self.dtype,
                    name=f"ff_{s}_{i}",
                )(x, deterministic=det)

        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

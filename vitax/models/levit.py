"""LeViT — conv-stem hybrid with downsampling attention and learned
attention bias (reference: levit.py:182-245).

A 4-conv stride-2 stem reduces the image 16x (levit.py:205-210); stages of
attention (q/k/v/out each conv1x1+BatchNorm, levit.py:73-104) alternate with
1-depth downsampling attention blocks (stride-2 queries, heads doubled,
levit.py:219-222). Positional information enters as a learned additive
attention bias indexed by (|dy|, |dx|) (levit.py:107-118). Hard-swish conv
MLP (levit.py:32-44). Optional distillation head returns ``(out, distill)``
(levit.py:235-238).

BatchNorm state: ``train=True`` + ``mutable=['batch_stats']`` updates the
running stats; inference uses them (the reference hardcodes training-mode BN,
levit.py:79). The reference adds its bias as ``bias/scale`` on top of
already-scaled logits (levit.py:133-138); this build adds the bias to the
scaled logits directly (the paper's formulation).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.core.utils import cast_tuple, default, exists
from vitax.nn.attention import mha_tokens
from vitax.nn.bias import LeViTAttentionBias
from vitax.nn.conv import ConvMLP


class _LeViTAttention(nn.Module):
    dim: int
    fmap_size: int
    heads: int = 8
    dim_key: int = 32
    dim_value: int = 64
    dropout: float = 0.0
    dim_out: Optional[int] = None
    downsample: bool = False
    fold_bn: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False, deterministic: bool = True) -> jax.Array:
        assert not (self.fold_bn and train), "BN-folded models are inference-only"
        dim_out = default(self.dim_out, self.dim)
        inner_k = self.dim_key * self.heads
        inner_v = self.dim_value * self.heads
        b = x.shape[0]

        def conv_bn(feat, stride, name):
            def apply(t):
                t = nn.Conv(
                    feat, (1, 1), strides=stride, use_bias=self.fold_bn, dtype=self.dtype,
                    name=f"{name}_conv",
                )(t)
                if self.fold_bn:
                    return t
                return nn.BatchNorm(
                    use_running_average=not train, momentum=0.9, epsilon=1e-5,
                    dtype=self.dtype, name=f"{name}_bn",
                )(t)
            return apply

        q = conv_bn(inner_k, 2 if self.downsample else 1, "to_q")(x)
        k = conv_bn(inner_k, 1, "to_k")(x)
        v = conv_bn(inner_v, 1, "to_v")(x)

        q_side = q.shape[1]
        bias = LeViTAttentionBias(
            self.heads,
            self.fmap_size,
            q_fmap_size=q_side,
            q_stride=2 if self.downsample else 1,
            name="pos_bias",
        )().astype(jnp.float32)

        out = mha_tokens(
            q.reshape(b, -1, inner_k),
            k.reshape(b, -1, inner_k),
            v.reshape(b, -1, inner_v),
            self.heads,
            scale=self.dim_key**-0.5,
            bias=bias,
        )
        out = nn.gelu(out.reshape(b, q_side, q_side, inner_v))
        out = nn.Conv(dim_out, (1, 1), dtype=self.dtype, name="to_out_conv")(out)
        if not self.fold_bn:
            out = nn.BatchNorm(
                use_running_average=not train, momentum=0.9, epsilon=1e-5,
                dtype=self.dtype, name="to_out_bn",
            )(out)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=deterministic)


class LeViT(nn.Module):
    image_size: int
    num_classes: int
    dim: tuple
    depth: int
    heads: tuple
    mlp_mult: int
    stages: int = 3
    dim_key: int = 32
    dim_value: int = 64
    dropout: float = 0.0
    num_distill_classes: Optional[int] = None
    # Inference-mode graph after ``utils.fold_batch_norm``: every conv+BN
    # pair collapses to a biased conv (reference can't: train-mode BN
    # hardcoded, levit.py:79).
    fold_bn: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False):
        det = not train
        dims = cast_tuple(self.dim, self.stages)
        depths = cast_tuple(self.depth, self.stages)
        layer_heads = cast_tuple(self.heads, self.stages)

        x = img
        for i, feat in enumerate((32, 64, 128, dims[0])):
            x = nn.Conv(
                feat, (3, 3), strides=2, padding="SAME", dtype=self.dtype, name=f"stem_{i}"
            )(x)
        fmap_size = self.image_size // 16

        def run_stage(x, dim, depth, heads, fmap, *, dim_out=None, downsample=False, name=""):
            attn_residual = (not downsample) and dim == default(dim_out, dim)
            for d in range(depth):
                a = _LeViTAttention(
                    dim, fmap, heads=heads, dim_key=self.dim_key, dim_value=self.dim_value,
                    dropout=self.dropout, dim_out=dim_out, downsample=downsample,
                    fold_bn=self.fold_bn, dtype=self.dtype, name=f"{name}_attn_{d}",
                )(x, train=train, deterministic=det)
                x = (x + a) if attn_residual else a
                # plain conv/hard-swish/conv MLP — no norm of any kind
                # (levit.py:32-44; the BN lives in the attention projections)
                x = x + ConvMLP(
                    default(dim_out, dim), self.mlp_mult, self.dropout,
                    activation="hard_swish", pre_norm=False,
                    dtype=self.dtype, name=f"{name}_mlp_{d}",
                )(x, deterministic=det)
            return x

        for s in range(self.stages):
            x = run_stage(
                x, dims[s], depths[s], layer_heads[s], fmap_size, name=f"stage_{s}"
            )
            if s + 1 < self.stages:
                x = run_stage(
                    x, dims[s], 1, layer_heads[s] * 2, fmap_size,
                    dim_out=dims[s + 1], downsample=True, name=f"down_{s}",
                )
                fmap_size = math.ceil(fmap_size / 2)

        x = jnp.mean(x, axis=(1, 2))
        out = nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)
        if exists(self.num_distill_classes):
            distill = nn.Dense(self.num_distill_classes, dtype=self.dtype, name="distill_head")(x)
            return out, distill
        return out

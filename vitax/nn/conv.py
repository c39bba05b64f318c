"""Convolutional primitive modules (NHWC, XLA convolutions).

One copy each of the primitives the reference re-declares per file
(SURVEY.md §2.2): depthwise conv, PEG, stage downsampling, cross-scale
embedding, NesT aggregation, PiT pooling, conv-1x1 MLP. XLA hands these to
its convolution library (cuDNN on a GPU).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn



class DepthWiseConv2d(nn.Module):
    """Depthwise conv via ``feature_group_count`` (cvt.py:57, pit.py:107).

    ``batch_norm=True`` reproduces CvT's depthwise->BN->pointwise stack;
    without it, a single depthwise+pointwise pair (PiT flavor).
    ``fold_bn=True`` is the inference-mode graph after
    ``utils.fold_batch_norm``: the BN is folded into the depthwise conv's
    kernel and a new bias, and the BN op disappears entirely — a transform
    the reference cannot express (train-mode BN hardcoded, cvt.py:73).
    """

    dim_in: int
    dim_out: int
    kernel_size: int
    stride: int
    use_bias: bool = True
    batch_norm: bool = False
    fold_bn: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        folded = self.batch_norm and self.fold_bn
        assert not (folded and train), "BN-folded models are inference-only"
        x = nn.Conv(
            self.dim_in,
            (self.kernel_size, self.kernel_size),
            strides=self.stride,
            padding="SAME",
            feature_group_count=self.dim_in,
            use_bias=self.use_bias or folded,
            dtype=self.dtype,
            name="depthwise",
        )(x)
        if self.batch_norm and not folded:
            x = nn.BatchNorm(use_running_average=not train, dtype=self.dtype, name="bn")(x)
        x = nn.Conv(
            self.dim_out, (1, 1), use_bias=self.use_bias, dtype=self.dtype, name="pointwise"
        )(x)
        return x


class PEG(nn.Module):
    """Positional Encoding Generator: residual depthwise 3x3 conv
    (twins_svt.py:79, scalable_vit.py:66, region_vit_flax.py:38)."""

    dim: int
    kernel_size: int = 3
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        return x + nn.Conv(
            self.dim,
            (self.kernel_size, self.kernel_size),
            padding="SAME",
            feature_group_count=self.dim,
            dtype=self.dtype,
            name="proj",
        )(x)


class Downsample(nn.Module):
    """Stage-transition conv 3x3 stride 2 (scalable_vit.py:57, region_vit_flax.py:29)."""

    dim: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        return nn.Conv(
            self.dim, (3, 3), strides=2, padding="SAME", dtype=self.dtype, name="conv"
        )(x)


class PatchEmbedding(nn.Module):
    """Space-to-depth + conv1x1 patch embedding (twins_svt.py:69-77).

    Feature order is channel-major ``(c p1 p2)``, matching the reference's
    rearrange so its trained projection kernels import unchanged."""

    dim_out: int
    patch_size: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c)
        x = x.transpose(0, 1, 3, 5, 2, 4)  # -> (b, h, w, c, p1, p2)
        x = x.reshape(b, h // p, w // p, c * p * p)
        return nn.Dense(self.dim_out, dtype=self.dtype, name="proj")(x)


class CrossEmbedLayer(nn.Module):
    """CrossFormer cross-scale embedding: parallel convs with growing kernels
    and a shared stride, channel-split concat (crossformer.py:17-41)."""

    dim: int
    kernel_sizes: Sequence[int]
    stride: int = 2
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        kernels = sorted(self.kernel_sizes)
        n = len(kernels)
        # Halving channel split per scale; remainder goes to the last kernel.
        dims = [self.dim // (2 ** (i + 1)) for i in range(n)]
        dims[-1] = self.dim - sum(dims[:-1])
        outs = []
        for i, (k, d) in enumerate(zip(kernels, dims)):
            outs.append(
                nn.Conv(
                    d,
                    (k, k),
                    strides=self.stride,
                    padding=[((k - self.stride) // 2, (k - self.stride + 1) // 2)] * 2,
                    dtype=self.dtype,
                    name=f"conv_{i}",
                )(x)
            )
        return jnp.concatenate(outs, axis=-1)


class Aggregate(nn.Module):
    """NesT block aggregation: conv3x3 + LN + maxpool3x3/s2 (nest.py:91-99)."""

    dim: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = nn.Conv(self.dim, (3, 3), padding="SAME", dtype=self.dtype, name="conv")(x)
        x = nn.LayerNorm(dtype=self.dtype, name="norm")(x)
        return nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")


class Pool(nn.Module):
    """PiT token pooling: depthwise stride-2 conv over spatial tokens plus a
    Dense on the cls token, re-concatenated (pit.py:130-148). The reference's
    Pool never executes due to the ``not_last`` bug (pit.py:199); this is the
    correct behavior (bug register #2, fixed)."""

    dim: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        cls, tokens = x[:, :1], x[:, 1:]
        b, n, c = tokens.shape
        side = int(round(n**0.5))
        fmap = tokens.reshape(b, side, side, c)
        fmap = DepthWiseConv2d(
            c, self.dim, kernel_size=3, stride=2, dtype=self.dtype, name="downsample"
        )(fmap)
        tokens = fmap.reshape(b, -1, self.dim)
        cls = nn.Dense(self.dim, dtype=self.dtype, name="cls_proj")(cls)
        return jnp.concatenate([cls, tokens], axis=1)


class ConvMLP(nn.Module):
    """Conv-1x1 MLP over NHWC feature maps (cvt.py:42, nest.py:46,
    twins_svt.py:55, scalable_vit.py:82, crossformer.py:81, levit.py:32).

    A 1x1 conv over NHWC is a GEMM over flattened tokens, so the inference
    path reuses ``ops.mlp`` via the token view.
    """

    dim: int
    mult: int = 4
    dropout: float = 0.0
    activation: str = "gelu"
    pre_norm: bool = True
    batch_norm: bool = False  # LeViT flavor: BN between convs
    fold_bn: bool = False  # inference: BNs folded into the convs (utils.fold_batch_norm)
    dim_out: Optional[int] = None
    ln_eps: float = 1e-5  # the conv-MLP reference files use eps 1e-5 norms
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True, train: bool = False) -> jax.Array:
        from vitax.nn.blocks import FeedForward  # local import to avoid cycle

        dim_out = self.dim_out or self.dim
        if self.batch_norm:
            # Stateful path (LeViT): conv1x1 -> BN -> act -> conv1x1 -> BN.
            folded = self.fold_bn
            assert not (folded and train), "BN-folded models are inference-only"
            h = nn.Conv(self.dim * self.mult, (1, 1), use_bias=folded, dtype=self.dtype, name="up")(x)
            if not folded:
                h = nn.BatchNorm(use_running_average=not train, dtype=self.dtype, name="bn1")(h)
            h = h * nn.relu6(h + 3.0) / 6.0  # hard-swish
            h = nn.Dropout(self.dropout, name="drop")(h, deterministic=deterministic)
            h = nn.Conv(dim_out, (1, 1), use_bias=folded, dtype=self.dtype, name="down")(h)
            if not folded:
                h = nn.BatchNorm(use_running_average=not train, dtype=self.dtype, name="bn2")(h)
            return h
        b, hh, ww, c = x.shape
        tokens = x.reshape(b, hh * ww, c)
        out = FeedForward(
            self.dim,
            self.dim * self.mult,
            dropout=self.dropout,
            pre_norm=self.pre_norm,
            activation=self.activation,
            ln_eps=self.ln_eps,
            dim_out=dim_out,
            dtype=self.dtype,
            name="ff",
        )(tokens, deterministic=deterministic)
        return out.reshape(b, hh, ww, dim_out)

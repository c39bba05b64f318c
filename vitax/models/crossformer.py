"""CrossFormer — cross-scale embedding + long/short distance attention
(reference: crossformer.py:207-260).

Four stages of CrossEmbedLayer -> depth x [SDA, MLP, LDA, MLP]. SDA
partitions the fmap into contiguous windows, LDA into dilated windows
(crossformer.py:139-141); both become static layout transforms feeding
``ops.window_attention_block`` with a DynamicPositionBias additive bias
(crossformer.py:154-158) — the only attention bias in the zoo that is
resolution-independent.

Fix-or-match decisions: the reference's DPB gathers biases with a
mismatched index stride (offsets evaluated on a (2w+1) grid but gathered
with (2w-1) strides, crossformer.py:122-127,154-158) and collapses the bias
to one scalar per offset (Dense(1), crossformer.py:58). By default this
build computes the paper-correct per-head bias on the (2w-1) offset grid;
``reference_quirks=True`` reproduces the reference exactly so its trained
checkpoints import with exact logit parity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.core.utils import cast_tuple
from vitax.nn.bias import DynamicPositionBias
from vitax.nn.blocks import scan_unroll_for
from vitax.nn.conv import ConvMLP, CrossEmbedLayer


class _LSDAttention(nn.Module):
    """Long- or short-distance windowed attention (crossformer.py:95-173)."""

    dim: int
    attn_type: str  # 'short' | 'long'
    window_size: int
    dim_head: int = 32
    dropout: float = 0.0
    reference_quirks: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        assert self.attn_type in {"short", "long"}
        heads = self.dim // self.dim_head
        inner = heads * self.dim_head
        b, h, w, _ = x.shape
        wsz = self.window_size
        dtype = self.dtype or x.dtype

        # raw parameters so the whole block — LN, qkv projection, window
        # partition, block-diagonal attention + DPB bias, out projection —
        # lowers to the single fused multi-window kernel
        norm_scale = self.param("norm_scale", nn.initializers.ones, (self.dim,), jnp.float32)
        norm_bias = self.param("norm_bias", nn.initializers.zeros, (self.dim,), jnp.float32)
        wqkv = self.param(
            "qkv_kernel", nn.initializers.lecun_normal(), (self.dim, inner * 3), jnp.float32
        )
        wout = self.param(
            "out_kernel", nn.initializers.lecun_normal(), (inner, self.dim), jnp.float32
        )
        bout = self.param("out_bias", nn.initializers.zeros, (self.dim,), jnp.float32)

        bias = DynamicPositionBias(
            self.dim // 4, heads, reference_quirks=self.reference_quirks, name="dpb"
        )(wsz)  # (1, 1|H, S, S)

        if self.attn_type == "short":
            xw = ops.window_partition(x, wsz)
        else:
            xw = ops.dilated_partition(x, wsz)

        out = ops.window_attention_block(
            xw, norm_scale, norm_bias,
            wqkv.astype(dtype), wout.astype(dtype), bout,
            heads, bias=bias.astype(jnp.float32),
            scale=self.dim_head**-0.5, ln_eps=1e-5,
        )

        if self.attn_type == "short":
            out = ops.window_unpartition(out, wsz, h, w)
        else:
            out = ops.dilated_unpartition(out, wsz, h, w)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=deterministic)


class _CrossFormerBlock(nn.Module):
    """One [SDA, MLP, LDA, MLP] block — the scan cell for a stage (blocks
    within a stage are homogeneous, so the whole stage compiles once)."""

    dim: int
    local_window_size: int
    global_window_size: int
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    reference_quirks: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = x + _LSDAttention(
            self.dim, "short", self.local_window_size, dropout=self.attn_dropout,
            reference_quirks=self.reference_quirks, dtype=self.dtype, name="sda",
        )(x, deterministic=deterministic)
        x = x + ConvMLP(
            self.dim, dropout=self.ff_dropout, dtype=self.dtype, name="mlp1"
        )(x, deterministic=deterministic)
        x = x + _LSDAttention(
            self.dim, "long", self.global_window_size, dropout=self.attn_dropout,
            reference_quirks=self.reference_quirks, dtype=self.dtype, name="lda",
        )(x, deterministic=deterministic)
        x = x + ConvMLP(
            self.dim, dropout=self.ff_dropout, dtype=self.dtype, name="mlp2"
        )(x, deterministic=deterministic)
        return x, ()


class CrossFormer(nn.Module):
    dim: Tuple[int, ...] = (64, 128, 256, 512)
    depth: Tuple[int, ...] = (2, 2, 8, 2)
    global_window_size: Tuple[int, ...] = (8, 4, 2, 1)
    local_window_size: int = 7
    cross_embed_kernel_sizes: tuple = ((4, 8, 16, 32), (2, 4), (2, 4), (2, 4))
    cross_embed_strides: Tuple[int, ...] = (4, 2, 2, 2)
    num_classes: int = 1000
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    # Reproduce the reference's DPB exactly (scalar bias, misindexed gather
    # — see DynamicPositionBias) for exact-weight parity with reference
    # checkpoints; default is the paper-correct per-head bias.
    reference_quirks: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        n_stages = len(self.dim)
        local_wsz = cast_tuple(self.local_window_size, n_stages)
        global_wsz = cast_tuple(self.global_window_size, n_stages)

        x = img
        for s in range(n_stages):
            x = CrossEmbedLayer(
                self.dim[s],
                self.cross_embed_kernel_sizes[s],
                self.cross_embed_strides[s],
                dtype=self.dtype,
                name=f"embed_{s}",
            )(x)
            block_cfg = dict(
                dim=self.dim[s],
                local_window_size=local_wsz[s],
                global_window_size=global_wsz[s],
                attn_dropout=self.attn_dropout,
                ff_dropout=self.ff_dropout,
                reference_quirks=self.reference_quirks,
                dtype=self.dtype,
            )
            if self.depth[s] > 1:
                # scan the homogeneous stage: compile ONE block per stage
                stacked = nn.scan(
                    _CrossFormerBlock,
                    variable_axes={"params": 0},
                    split_rngs={"params": True, "dropout": True},
                    length=self.depth[s],
                    in_axes=nn.broadcast,
                    unroll=scan_unroll_for(self.depth[s]),
                )(**block_cfg, name=f"stage_{s}")
                x, _ = stacked(x, det)
            else:
                x, _ = _CrossFormerBlock(**block_cfg, name=f"stage_{s}")(x, det)

        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

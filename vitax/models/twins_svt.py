"""Twins-SVT — alternating local/global attention pyramid (reference:
twins_svt.py:208-320).

Per stage: PatchEmbedding -> Transformer(depth) -> PEG -> Transformer(depth),
stage 4 global-only. (Note: running the *full* stage depth both before and
after the PEG matches the reference's structure, twins_svt.py:247-274, which
itself diverges from the upstream Twins layout of 1 block / PEG / rest —
bug register #17, matched here because it defines the reference's capability
surface.)

LocalAttention is 7x7 window partition + per-window MHSA (twins_svt.py:93-135);
GlobalAttention (GSA) subsamples k/v with a k x k strided conv
(twins_svt.py:137-175). Both go through ``ops`` attention.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.nn.attention import mha_tokens
from vitax.nn.blocks import scan_unroll_for
from vitax.nn.conv import ConvMLP, PatchEmbedding, PEG


class _LocalAttention(nn.Module):
    dim: int
    heads: int = 8
    dim_head: int = 64
    dropout: float = 0.0
    patch_size: int = 7
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, fmap: jax.Array, deterministic: bool = True) -> jax.Array:
        inner = self.heads * self.dim_head
        b, h, w, dim = fmap.shape
        p = self.patch_size
        dtype = self.dtype or fmap.dtype

        # raw parameters so the whole block — LN, fused qkv projection,
        # window partition, block-diagonal attention, out projection —
        # lowers to the single fused multi-window kernel (the CrossFormer
        # _LSDAttention pattern). The reference's separate to_q/to_kv 1x1
        # convs concatenate column-wise into the fused [q|k|v] kernel.
        norm_scale = self.param("norm_scale", nn.initializers.ones, (dim,), jnp.float32)
        norm_bias = self.param("norm_bias", nn.initializers.zeros, (dim,), jnp.float32)
        wqkv = self.param(
            "qkv_kernel", nn.initializers.lecun_normal(), (dim, inner * 3), jnp.float32
        )
        wout = self.param(
            "out_kernel", nn.initializers.lecun_normal(), (inner, dim), jnp.float32
        )
        bout = self.param("out_bias", nn.initializers.zeros, (dim,), jnp.float32)

        xw = ops.window_partition(fmap, p)
        out = ops.window_attention_block(
            xw, norm_scale, norm_bias,
            wqkv.astype(dtype), wout.astype(dtype), bout,
            self.heads, scale=self.dim_head**-0.5, ln_eps=1e-5,
        )
        out = ops.window_unpartition(out, p, h, w)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=deterministic)


class _GlobalAttention(nn.Module):
    """GSA: queries from every token, keys/values from a k-strided conv
    subsampling (twins_svt.py:152)."""

    dim: int
    heads: int = 8
    dim_head: int = 64
    dropout: float = 0.0
    k: int = 7
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        inner = self.heads * self.dim_head
        b, h, w, _ = x.shape

        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="norm")(x)
        q = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_q")(x)
        kv = nn.Conv(
            inner * 2, (self.k, self.k), strides=self.k, use_bias=False,
            dtype=self.dtype, name="to_kv",
        )(x)
        k, v = jnp.split(kv.reshape(b, -1, inner * 2), 2, axis=-1)

        out = mha_tokens(
            q.reshape(b, h * w, inner), k, v, self.heads, scale=self.dim_head**-0.5
        )
        out = out.reshape(b, h, w, inner)
        out = nn.Dense(self.dim, dtype=self.dtype, name="to_out")(out)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=deterministic)


class _TwinsLayer(nn.Module):
    """One [local, ff, global, ff] (or global-only) layer — the scan cell."""

    dim: int
    heads: int = 8
    dim_head: int = 64
    mlp_mult: int = 4
    local_patch_size: int = 7
    global_k: int = 7
    dropout: float = 0.0
    has_local: bool = True
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True):
        if self.has_local:
            x = x + _LocalAttention(
                self.dim, self.heads, self.dim_head, self.dropout,
                self.local_patch_size, dtype=self.dtype, name="local",
            )(x, deterministic=deterministic)
            x = x + ConvMLP(
                self.dim, self.mlp_mult, self.dropout, dtype=self.dtype, name="ff1"
            )(x, deterministic=deterministic)
        x = x + _GlobalAttention(
            self.dim, self.heads, self.dim_head, self.dropout, self.global_k,
            dtype=self.dtype, name="global",
        )(x, deterministic=deterministic)
        x = x + ConvMLP(
            self.dim, self.mlp_mult, self.dropout, dtype=self.dtype, name="ff2"
        )(x, deterministic=deterministic)
        return x, ()


class _TwinsBlock(nn.Module):
    dim: int
    depth: int
    heads: int = 8
    dim_head: int = 64
    mlp_mult: int = 4
    local_patch_size: int = 7
    global_k: int = 7
    dropout: float = 0.0
    has_local: bool = True
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        cfg = dict(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            mlp_mult=self.mlp_mult,
            local_patch_size=self.local_patch_size,
            global_k=self.global_k,
            dropout=self.dropout,
            has_local=self.has_local,
            dtype=self.dtype,
        )
        if self.depth > 1:
            stacked = nn.scan(
                _TwinsLayer,
                variable_axes={"params": 0},
                split_rngs={"params": True, "dropout": True},
                length=self.depth,
                in_axes=nn.broadcast,
                unroll=scan_unroll_for(self.depth),
            )(**cfg, name="layers")
            x, _ = stacked(x, deterministic)
        else:
            x, _ = _TwinsLayer(**cfg, name="layers")(x, deterministic)
        return x


class TwinsSVT(nn.Module):
    num_classes: int
    s1_emb_dim: int = 64
    s1_patch_size: int = 4
    s1_local_patch_size: int = 7
    s1_global_k: int = 7
    s1_depth: int = 1
    s2_emb_dim: int = 128
    s2_patch_size: int = 2
    s2_local_patch_size: int = 7
    s2_global_k: int = 7
    s2_depth: int = 1
    s3_emb_dim: int = 256
    s3_patch_size: int = 2
    s3_local_patch_size: int = 7
    s3_global_k: int = 7
    s3_depth: int = 5
    s4_emb_dim: int = 512
    s4_patch_size: int = 2
    s4_local_patch_size: int = 7
    s4_global_k: int = 7
    s4_depth: int = 4
    peg_kernel_size: int = 3
    dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        x = img
        for s in range(1, 5):
            cfg = {
                k[3:]: getattr(self, k)
                for k in (
                    f"s{s}_emb_dim", f"s{s}_patch_size", f"s{s}_local_patch_size",
                    f"s{s}_global_k", f"s{s}_depth",
                )
            }
            has_local = s < 4
            x = PatchEmbedding(
                cfg["emb_dim"], cfg["patch_size"], dtype=self.dtype, name=f"embed_{s}"
            )(x)
            x = _TwinsBlock(
                dim=cfg["emb_dim"],
                depth=cfg["depth"],
                local_patch_size=cfg["local_patch_size"],
                global_k=cfg["global_k"],
                dropout=self.dropout,
                has_local=has_local,
                dtype=self.dtype,
                name=f"block_a_{s}",
            )(x, deterministic=det)
            x = PEG(cfg["emb_dim"], self.peg_kernel_size, dtype=self.dtype, name=f"peg_{s}")(x)
            x = _TwinsBlock(
                dim=cfg["emb_dim"],
                depth=cfg["depth"],
                local_patch_size=cfg["local_patch_size"],
                global_k=cfg["global_k"],
                dropout=self.dropout,
                has_local=has_local,
                dtype=self.dtype,
                name=f"block_b_{s}",
            )(x, deterministic=det)

        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

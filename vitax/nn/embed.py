"""Token-embedding modules: patch embed, SPT, PatchMerger, ProjectInOut."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops


class PatchEmbed(nn.Module):
    """Non-overlapping patchify + linear projection (vit.py:146-147 and
    eight clones). The rearrange is a pure layout transform XLA fuses into
    the projection GEMM."""

    dim: int
    patch_size: int
    norm: bool = False  # SimpleViT applies LN before/after projection
    dtype: Optional[jnp.dtype] = None
    out_dtype: Optional[jnp.dtype] = None  # stream dtype; None = ``dtype``

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        p = self.patch_size
        x = ops.patchify(x, p)
        if self.norm:
            x = nn.LayerNorm(dtype=self.dtype, name="norm_in")(x)
        # fp32 accumulation + fp32 bias add, rounded once at the end:
        # matches the reference's fp32 Dense. <1% of forward FLOPs, so the fp32
        # epilogue costs nothing; rounding the accumulator+bias to bf16 here
        # was a divergence seed amplified through every encoder layer.
        x = nn.Dense(self.dim, dtype=jnp.float32, name="proj")(x)
        if self.norm:
            x = nn.LayerNorm(dtype=self.dtype, name="norm_out")(x)
        out_dtype = self.out_dtype or self.dtype
        return x.astype(out_dtype) if out_dtype is not None else x


class SPT(nn.Module):
    """Shifted Patch Tokenization (vit_small_datasets.py:134-153):
    concat the image with four 1-px shifts, patchify, LN + Dense."""

    dim: int
    patch_size: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = ops.spt_shifts(x)
        x = ops.patchify(x, self.patch_size)
        x = nn.LayerNorm(
            epsilon=1e-5, use_bias=False, dtype=self.dtype, name="norm"
        )(x)
        return nn.Dense(self.dim, dtype=self.dtype, name="proj")(x)


class PatchMerger(nn.Module):
    """Learned-attention token merging (patch_merger.py:26-43).

    The reference draws its queries from a fixed ``PRNGKey(0)`` instead of
    learning them (bug register #4); here they are a real parameter.
    """

    dim: int
    num_tokens_out: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        queries = self.param(
            "queries",
            nn.initializers.normal(1.0),
            (self.num_tokens_out, self.dim),
            jnp.float32,
        )
        xn = nn.LayerNorm(dtype=self.dtype, name="norm")(x)
        scale = self.dim**-0.5
        attn = jnp.einsum("qd,bnd->bqn", queries.astype(xn.dtype) * scale, xn)
        attn = jax.nn.softmax(attn, axis=-1)
        return jnp.einsum("bqn,bnd->bqd", attn.astype(xn.dtype), xn)


class ProjectInOut(nn.Module):
    """Dimension-bridging wrapper used by CrossViT (cross_vit.py:105-130):
    Dense in, run ``fn``, Dense out. Realized here as explicit in/out
    projections around a provided callable."""

    dim_in: int
    dim_out: int
    dtype: Optional[jnp.dtype] = None

    def setup(self):
        self.project_in = nn.Dense(self.dim_out, dtype=self.dtype)
        self.project_out = nn.Dense(self.dim_in, dtype=self.dtype)

    def __call__(self, x, fn, *args, **kwargs):
        x = self.project_in(x)
        x = fn(x, *args, **kwargs)
        return self.project_out(x)

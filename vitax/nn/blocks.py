"""Feed-forward and encoder-stack modules shared by every model family.

The reference copy-pastes ``FeedForward`` into ten files (vit.py:41 clones,
SURVEY.md §2.2 row 3) and a per-file ``Transformer`` loop (vit.py:89-112).
Here: one FeedForward over ``ops.mlp``, one standard pre-norm residual
encoder, and in-graph stochastic depth replacing
the reference's host-side structural layer-dropout (cait.py:16-30, bug
register #5).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.nn.attention import Attention
from vitax.ops.blocks import activate as _activate


class FeedForward(nn.Module):
    """Pre-norm MLP block: ``LN -> Dense -> GELU -> Dense`` (+dropout).

    The deterministic path is ``ops.mlp`` (LayerNorm prologue included);
    the residual add stays with the caller so parity with the reference
    block structure is 1:1.
    """

    dim: int
    hidden_dim: int
    dropout: float = 0.0
    pre_norm: bool = True
    norm_bias: bool = True
    dense_bias: bool = True
    activation: str = "gelu"
    ln_eps: float = 1e-6
    dim_out: Optional[int] = None  # output width; None = dim
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        dim_out = self.dim_out or self.dim
        w1 = self.param(
            "w1", nn.initializers.lecun_normal(), (self.dim, self.hidden_dim), jnp.float32
        )
        b1 = (
            self.param("b1", nn.initializers.zeros, (self.hidden_dim,), jnp.float32)
            if self.dense_bias
            else None
        )
        w2 = self.param(
            "w2", nn.initializers.lecun_normal(), (self.hidden_dim, dim_out), jnp.float32
        )
        b2 = (
            self.param("b2", nn.initializers.zeros, (dim_out,), jnp.float32)
            if self.dense_bias
            else None
        )
        if self.pre_norm:
            ln_scale = self.param("ln_scale", nn.initializers.ones, (self.dim,), jnp.float32)
            ln_bias = (
                self.param("ln_bias", nn.initializers.zeros, (self.dim,), jnp.float32)
                if self.norm_bias
                else None
            )
        else:
            ln_scale = ln_bias = None

        dtype = self.dtype or x.dtype
        cast = lambda p: None if p is None else p.astype(dtype)

        # Only the GEMM operands (weights) are cast to the compute dtype; biases
        # and norm parameters stay fp32 — the reference adds them on the
        # fp32 accumulator, and pre-casting them to bf16 was a systematic
        # per-layer offset (round-2 numerics study).
        if self.dropout > 0.0 and not deterministic:
            # Training path: dropout between the activations (XLA).
            h = x
            if self.pre_norm:
                h = _layer_norm(h, ln_scale, ln_bias, self.ln_eps)
            h = jnp.matmul(h.astype(dtype), cast(w1), preferred_element_type=jnp.float32)
            if b1 is not None:
                h = h + b1
            h = _activate(h, self.activation)
            h = nn.Dropout(self.dropout, name="drop1")(h, deterministic=False)
            h = jnp.matmul(h.astype(dtype), cast(w2), preferred_element_type=jnp.float32)
            if b2 is not None:
                h = h + b2
            h = nn.Dropout(self.dropout, name="drop2")(h, deterministic=False)
            return h.astype(x.dtype)

        out = ops.mlp(
            x,
            cast(w1),
            b1,
            cast(w2),
            b2,
            ln_scale,
            ln_bias,
            activation=self.activation,
            residual=False,
            ln_eps=self.ln_eps,
        )
        return out


def _layer_norm(x, scale, bias, eps=1e-6):
    # flax.linen.LayerNorm's exact op sequence (fast variance, fp32 stats,
    # scale folded into the rsqrt multiplier).
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(
        0.0, jnp.mean(jnp.square(x), axis=-1, keepdims=True) - jnp.square(mean)
    )
    mul = jax.lax.rsqrt(var + eps) * scale
    y = (x - mean) * mul
    if bias is not None:
        y = y + bias
    return y


_remat_enabled: "contextvars.ContextVar[bool]" = None  # set below


def remat_scope():
    """Enable per-block rematerialization for model applies traced inside
    this context (``jax.checkpoint`` on each scanned encoder block): the
    backward pass recomputes block activations instead of keeping them
    alive, trading ~1/3 more FLOPs for O(depth) less live memory. The
    train step uses this by default (``make_train_step(remat=True)``)."""
    return _remat_ctx()


import contextlib
import contextvars

_remat_enabled = contextvars.ContextVar("vitax_remat", default=False)


@contextlib.contextmanager
def _remat_ctx():
    token = _remat_enabled.set(True)
    try:
        yield
    finally:
        _remat_enabled.reset(token)


def scan_unroll_for(depth: int) -> int:
    """Unroll policy for scanned encoder stacks: the scan loop (unroll=1)
    from depth 5 up, full unroll for stacks of depth <= 4, where the loop's
    carry setup is not amortized over its few iterations.
    ``VITAX_SCAN_UNROLL`` overrides."""
    import os

    env = os.environ.get("VITAX_SCAN_UNROLL")
    if env is not None:
        return max(1, min(int(env), depth))
    return depth if depth <= 4 else 1


class EncoderBlock(nn.Module):
    """One pre-norm residual block: attention + feed-forward. The scan cell
    the encoder stacks (one compiled block regardless of depth) — returns
    the ``(carry, ())`` pair nn.scan expects."""

    dim: int
    heads: int
    dim_head: int
    mlp_dim: int
    dropout: float = 0.0
    reattention: bool = False
    mask_self: bool = False
    learned_temperature: bool = False
    qkv_bias: bool = False
    activation: str = "gelu"
    norm_eps: float = 1e-6
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        x = Attention(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            dropout=self.dropout,
            reattention=self.reattention,
            mask_self=self.mask_self,
            learned_temperature=self.learned_temperature,
            qkv_bias=self.qkv_bias,
            fuse_residual=True,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
            name="attn",
        )(x, deterministic=deterministic)
        x = x + FeedForward(
            self.dim, self.mlp_dim, self.dropout, ln_eps=self.norm_eps,
            activation=self.activation,
            dtype=self.dtype, name="ff"
        )(x, deterministic=deterministic)
        return x, ()


class Transformer(nn.Module):
    """Standard pre-norm residual encoder with the zoo's variant hooks.

    Covers the vanilla stack (vit.py:89-112), DeepViT (reattention),
    ParallelViT (``parallel_branches`` summed branches per depth,
    parallel_vit.py:99-107), in-graph stochastic ``layer_dropout``
    (replacing cait.py:16-30's host-side structural dropout), and LSA
    (``mask_self`` + learned temperature). CaiT's LayerScale-gated blocks
    live in models/cait.py (model-depth epsilon banding, paper §3).

    ``scan=True`` (default for homogeneous stacks without context/branch/
    layer-scale hooks) rolls the depth into ``nn.scan`` so XLA traces and
    compiles ONE block — compile time is O(1) in depth instead of O(depth),
    which matters at ViT-L/24 and ScalableViT's 20-deep stage.

    ``scan_unroll`` (default: ``scan_unroll_for``'s policy) keeps the
    stacked parameter layout (checkpoint/importer-compatible) either way.
    """

    dim: int
    depth: int
    heads: int
    dim_head: int
    mlp_dim: int
    dropout: float = 0.0
    reattention: bool = False
    mask_self: bool = False
    learned_temperature: bool = False
    talking_heads: bool = False
    # HF/timm-style blocks (interop): bias on the qkv projections and the
    # erf GELU. qkv_bias takes the flax-submodule attention layout.
    qkv_bias: bool = False
    activation: str = "gelu"
    layer_dropout: float = 0.0
    parallel_branches: int = 1
    final_norm: bool = False
    scan: bool = True
    scan_unroll: Optional[int] = None  # None = scan_unroll_for's policy
    # (the scan loop from depth 5 up; full unroll below)
    norm_eps: float = 1e-6
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        context: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        use_scan = (
            self.scan
            and context is None
            and not self.talking_heads
            and self.layer_dropout == 0.0
            and self.parallel_branches == 1
            and self.depth > 1
        )
        if use_scan:
            unroll = (
                self.scan_unroll
                if self.scan_unroll is not None
                else scan_unroll_for(self.depth)
            )
            cell = EncoderBlock
            if _remat_enabled.get():
                # deterministic is a static python bool. argnums count
                # `self` as 0 (linen's checkpoint subtracts 1 before
                # passing them to jax.checkpoint), so (x, deterministic)
                # are (1, 2) — marking 1 would freeze the scan carry.
                cell = nn.remat(cell, static_argnums=(2,))
            stacked = nn.scan(
                cell,
                variable_axes={"params": 0},
                split_rngs={"params": True, "dropout": True},
                length=self.depth,
                in_axes=nn.broadcast,
                unroll=min(unroll, self.depth),
            )(
                dim=self.dim,
                heads=self.heads,
                dim_head=self.dim_head,
                mlp_dim=self.mlp_dim,
                dropout=self.dropout,
                reattention=self.reattention,
                mask_self=self.mask_self,
                learned_temperature=self.learned_temperature,
                qkv_bias=self.qkv_bias,
                activation=self.activation,
                norm_eps=self.norm_eps,
                dtype=self.dtype,
                name="blocks",
            )
            x, _ = stacked(x, deterministic)
            if self.final_norm:
                x = nn.LayerNorm(epsilon=self.norm_eps, dtype=self.dtype, name="final_norm")(x)
            return x
        attn_kwargs = dict(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            dropout=self.dropout,
            reattention=self.reattention,
            mask_self=self.mask_self,
            learned_temperature=self.learned_temperature,
            talking_heads=self.talking_heads,
            qkv_bias=self.qkv_bias,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
        )

        def residual(x, delta, layer_idx, kind):
            if self.layer_dropout > 0.0 and not deterministic:
                # In-graph stochastic depth: per-sample bernoulli gate
                # (replaces the reference's fixed-key structural dropout,
                # cait.py:21,27).
                rng = self.make_rng("dropout")
                keep = jax.random.bernoulli(
                    rng, 1.0 - self.layer_dropout, (x.shape[0], 1, 1)
                )
                delta = delta * keep.astype(delta.dtype) / (1.0 - self.layer_dropout)
            return x + delta

        for i in range(self.depth):
            if self.parallel_branches == 1:
                a = Attention(**attn_kwargs, name=f"attn_{i}")(
                    x, context=context, deterministic=deterministic
                )
                x = residual(x, a, i, "attn")
                f = FeedForward(
                    self.dim, self.mlp_dim, self.dropout, ln_eps=self.norm_eps,
                    activation=self.activation,
                    dtype=self.dtype, name=f"ff_{i}"
                )(x, deterministic=deterministic)
                x = residual(x, f, i, "ff")
            else:
                # ParallelViT: sum of N attention branches, then sum of N FF
                # branches, each applied to the same input (parallel_vit.py:99-107).
                a = sum(
                    Attention(**attn_kwargs, name=f"attn_{i}_{b}")(
                        x, context=context, deterministic=deterministic
                    )
                    for b in range(self.parallel_branches)
                )
                x = residual(x, a, i, "attn")
                f = sum(
                    FeedForward(
                        self.dim, self.mlp_dim, self.dropout, dtype=self.dtype, name=f"ff_{i}_{b}"
                    )(x, deterministic=deterministic)
                    for b in range(self.parallel_branches)
                )
                x = residual(x, f, i, "ff")

        if self.final_norm:
            x = nn.LayerNorm(epsilon=self.norm_eps, dtype=self.dtype, name="final_norm")(x)
        return x

"""Attention modules — one configurable core covering the zoo's 14 variants.

The reference declares a near-identical ``Attention`` in eleven files
(vit.py:55, deepvit.py:46, cait.py:73, parallel_vit.py:49, patch_merger.py:67,
t2t.py:54, pit.py:46, simple_vit.py:47, region_vit_flax.py:63,
vit_small_datasets.py:71, cross_vit.py:40). Here a single module exposes the
union of their hooks and sends the plain softmax-attention path through
``vitax.ops.qkv_attention``/``ops.attention``; variants whose math needs the
full score map (talking-heads cait.py:105-107, re-attention deepvit.py:69)
materialize it — acceptable at their tiny sequence lengths (SURVEY.md §7.3
item 5).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops


def _layer_norm_f32(x, scale, bias, eps=1e-6):
    # flax.linen.LayerNorm's exact op sequence (fast variance, scale folded
    # into the rsqrt multiplier) so rounding aligns with the reference.
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(
        0.0, jnp.mean(jnp.square(x), axis=-1, keepdims=True) - jnp.square(mean)
    )
    mul = jax.lax.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


class _DenseParams(nn.Module):
    """Owns an ``nn.Dense``-shaped parameter block (``kernel``/``bias``)
    without running the projection. The low-query cross-attention path
    reassociates the kv GEMMs away but must keep the checkpoint/importer
    param tree of the Dense it replaces (``to_kv/kernel``)."""

    features: int
    use_bias: bool = False

    @nn.compact
    def __call__(self, in_features: int):
        kernel = self.param(
            "kernel", nn.initializers.lecun_normal(), (in_features, self.features), jnp.float32
        )
        if not self.use_bias:
            return kernel, None
        bias = self.param("bias", nn.initializers.zeros, (self.features,), jnp.float32)
        return kernel, bias


def split_heads(x: jax.Array, heads: int) -> jax.Array:
    """``[B, N, H*D] -> [B, H, N, D]``."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(0, 2, 1, 3)


def merge_heads(x: jax.Array) -> jax.Array:
    """``[B, H, N, D] -> [B, N, H*D]``."""
    b, h, n, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, n, h * d)


def mha_tokens(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    heads: int,
    *,
    scale: Optional[float] = None,
    bias: Optional[jax.Array] = None,
) -> jax.Array:
    """Functional MHA over token layouts ``[B, N, H*D]`` -> ``[B, N, H*Dv]``.

    Splits heads, runs the dispatching flash kernel, merges heads. Used by
    the window/pyramid model families where q/k/v come from convs with
    differing token counts (Twins GSA, SSA, CvT, windowed attention).
    """
    q = split_heads(q, heads)
    k = split_heads(k, heads)
    v = split_heads(v, heads)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = ops.attention(q, k, v, bias=bias, scale=scale)
    return merge_heads(out)


class Attention(nn.Module):
    """Multi-head self/cross attention with the zoo's variant hooks.

    Attributes:
      dim: model width of the residual stream.
      heads / dim_head: attention geometry.
      dropout: attention-probability and output dropout rate.
      pre_norm: fuse a LayerNorm prologue (the reference's ``PreNorm``).
      qkv_bias: bias on the fused qkv projection (reference: False).
      talking_heads: CaiT pre/post-softmax head mixing (cait.py:87-107).
      reattention: DeepViT re-attention (deepvit.py:68-72).
      mask_self: LSA diagonal masking (vit_small_datasets.py:97-99).
      learned_temperature: LSA learnable logit scale, initialized to
        ``dim_head ** -0.5`` — the reference freezes it (bug register #7);
        here it is a real parameter per the paper.
      project_out: force/skip the output projection; ``None`` mirrors the
        reference rule — skip when ``heads == 1 and dim_head == dim``
        (vit.py:65).
    """

    dim: int
    heads: int = 8
    dim_head: int = 64
    dropout: float = 0.0
    pre_norm: bool = True
    qkv_bias: bool = False
    talking_heads: bool = False
    reattention: bool = False
    mask_self: bool = False
    learned_temperature: bool = False
    project_out: Optional[bool] = None
    fuse_residual: bool = False
    # The reference's PreNorm normalizes only the queries; cross-attention
    # context stays raw (cait.py:96-99, cross_vit.py's PreNorm). Set True
    # for the upstream-lucidrains behavior of norming the context too.
    norm_context: bool = False
    # Reassociated low-query cross-attention: None = auto (FLOP-model gate),
    # True/False force it on/off (False reproduces the materializing order
    # bit-for-bit for parity studies).
    lowq_cross: Optional[bool] = None
    norm_eps: float = 1e-6
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        context: Optional[jax.Array] = None,
        kv_include_self: bool = False,
        bias: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        inner = self.heads * self.dim_head
        project_out = (
            self.project_out
            if self.project_out is not None
            else not (self.heads == 1 and self.dim_head == self.dim)
        )
        is_self = context is None and not kv_include_self
        residual = x
        if self.learned_temperature:
            # LSA: scale = exp(log_tau), a learned scalar initialized so the
            # initial value equals the standard 1/sqrt(d) (parity at init).
            log_tau = self.param(
                "log_temperature",
                lambda rng: jnp.full((), jnp.log(self.dim_head**-0.5), jnp.float32),
            )
            scale = jnp.exp(log_tau)
        else:
            scale = self.dim_head**-0.5

        needs_materialized = (
            self.talking_heads
            or self.reattention
            or (self.dropout > 0.0 and not deterministic)
            or self.learned_temperature  # traced scale -> materialized scores
        )

        if is_self and self.pre_norm and not self.qkv_bias:
            # Self-attention owns raw parameters (checkpoint layout:
            # norm_scale/norm_bias/qkv_kernel/out_kernel/out_bias).
            dtype = self.dtype or x.dtype
            norm_scale = self.param("norm_scale", nn.initializers.ones, (self.dim,), jnp.float32)
            norm_bias = self.param("norm_bias", nn.initializers.zeros, (self.dim,), jnp.float32)
            qkv_kernel = self.param(
                "qkv_kernel", nn.initializers.lecun_normal(), (self.dim, inner * 3), jnp.float32
            )
            if project_out:
                out_kernel = self.param(
                    "out_kernel", nn.initializers.lecun_normal(), (inner, self.dim), jnp.float32
                )
                out_bias = self.param("out_bias", nn.initializers.zeros, (self.dim,), jnp.float32)

            xn = _layer_norm_f32(x, norm_scale, norm_bias, self.norm_eps).astype(dtype)
            # fp32 accumulation, rounded once — identical rounding profile to
            # the reference's fp32 Dense followed by operand rounding at the
            # next matmul (bf16-accumulated `xn @ w` double-rounds).
            qkv = jnp.matmul(
                xn, qkv_kernel.astype(dtype), preferred_element_type=jnp.float32
            ).astype(dtype)
            if not needs_materialized and not self.mask_self:
                out = ops.qkv_attention(qkv, self.heads, bias=bias, scale=scale)
            else:
                q, k, v = jnp.split(qkv, 3, axis=-1)
                out = self._materializing_attention(
                    split_heads(q, self.heads),
                    split_heads(k, self.heads),
                    split_heads(v, self.heads),
                    bias,
                    scale,
                    deterministic,
                )
                out = merge_heads(out)
            if project_out:
                # fp32 accumulation + fp32 bias add (reference Dense
                # semantics), rounded once to the stream dtype.
                out = jnp.matmul(
                    out, out_kernel.astype(dtype), preferred_element_type=jnp.float32
                )
                out = (out + out_bias).astype(residual.dtype)
                out = nn.Dropout(self.dropout, name="out_drop")(out, deterministic=deterministic)
            return out + residual if self.fuse_residual else out

        # cross-attention / post-norm / qkv-bias configurations
        if self.pre_norm:
            x = nn.LayerNorm(epsilon=self.norm_eps, dtype=jnp.float32, name="norm")(x)
        if context is None:
            kv_src = x
        else:
            if self.pre_norm and self.norm_context:
                context = nn.LayerNorm(epsilon=self.norm_eps, dtype=jnp.float32, name="norm_context")(context)
            kv_src = jnp.concatenate([x, context], axis=1) if kv_include_self else context

        out = None
        if is_self:
            qkv = nn.Dense(inner * 3, use_bias=self.qkv_bias, dtype=self.dtype, name="to_qkv")(x)
            q, k, v = jnp.split(qkv, 3, axis=-1)
        else:
            q = nn.Dense(inner, use_bias=self.qkv_bias, dtype=self.dtype, name="to_q")(x)
            n_q, n_kv = q.shape[1], kv_src.shape[1]
            # Low-query reassociation (CaiT class stage cait.py:176-179,
            # CrossViT cls cross-attention cross_vit.py:155-157): the
            # standard order pays two n_kv x d x inner GEMMs projecting the
            # whole context through W_k/W_v to serve n_q queries. When the
            # reassociated cost (everything proportional to n_q) is at
            # least 4x cheaper, skip the kv projection entirely.
            lowq = (
                not self.qkv_bias
                and not self.reattention
                and not self.mask_self
                and bias is None
                and (
                    self.lowq_cross
                    if self.lowq_cross is not None
                    else 4 * n_q * (inner + n_kv) <= n_kv * inner
                )
            )
            if lowq:
                out = self._lowq_cross_attention(q, kv_src, scale, deterministic)
            else:
                kv = nn.Dense(inner * 2, use_bias=self.qkv_bias, dtype=self.dtype, name="to_kv")(kv_src)
                k, v = jnp.split(kv, 2, axis=-1)

        if out is None:
            q = split_heads(q, self.heads)
            k = split_heads(k, self.heads)
            v = split_heads(v, self.heads)

            if not needs_materialized:
                out = ops.attention(q, k, v, bias=bias, scale=scale, mask_self=self.mask_self)
            else:
                out = self._materializing_attention(q, k, v, bias, scale, deterministic)

            out = merge_heads(out)
        if project_out:
            out = nn.Dense(self.dim, dtype=self.dtype, name="to_out")(out)
            out = nn.Dropout(self.dropout, name="out_drop")(out, deterministic=deterministic)
        return out + residual if self.fuse_residual else out

    def _reattn_params(self):
        mix = self.param(
            "reattn_weights", nn.initializers.normal(0.02), (self.heads, self.heads)
        )
        rln_scale = self.param(
            "reattn_scale", nn.initializers.ones, (self.heads,), jnp.float32
        )
        rln_bias = self.param(
            "reattn_bias", nn.initializers.zeros, (self.heads,), jnp.float32
        )
        return mix, rln_scale, rln_bias

    def _lowq_cross_attention(self, q, context, scale, deterministic):
        """Reassociated cross-attention for tiny query counts.

        With ``n_q << n_kv << dim`` (CaiT's 1-token class stage), never
        project the context through W_k/W_v:

          ``q (C W_k)^T = (q W_k^T) C^T``   and   ``p (C W_v) = (p C) W_v``

        makes every op proportional to ``n_q``. Scores stay materialized
        at ``(b, h, n_q, n_kv)``, so the talking-heads mixes and attention
        dropout slot in unchanged. Param tree is identical to the standard
        path (``to_kv/kernel`` via :class:`_DenseParams`)."""
        inner = self.heads * self.dim_head
        d_model = context.shape[-1]
        dtype = self.dtype or context.dtype
        wkv, _ = _DenseParams(features=inner * 2, name="to_kv")(d_model)
        wk, wv = jnp.split(wkv, 2, axis=-1)
        wk = wk.reshape(d_model, self.heads, self.dim_head).astype(dtype)
        wv = wv.reshape(d_model, self.heads, self.dim_head).astype(dtype)
        qh = split_heads(q, self.heads).astype(dtype)  # (b, h, nq, e)
        c = context.astype(dtype)
        t = jnp.einsum(
            "bhqe,dhe->bhqd", qh, wk, preferred_element_type=jnp.float32
        ).astype(dtype)
        s = jnp.einsum("bhqd,bjd->bhqj", t, c, preferred_element_type=jnp.float32)
        s = s * scale
        if self.talking_heads:
            mix_pre = self.param(
                "mix_heads_pre", nn.initializers.normal(0.02), (self.heads, self.heads)
            )
            s = jnp.einsum("bhqj,hg->bgqj", s, mix_pre)
        p = jax.nn.softmax(s, axis=-1)
        if self.talking_heads:
            mix_post = self.param(
                "mix_heads_post", nn.initializers.normal(0.02), (self.heads, self.heads)
            )
            p = jnp.einsum("bhqj,hg->bgqj", p, mix_post)
        p = nn.Dropout(self.dropout, name="attn_drop")(p, deterministic=deterministic)
        u = jnp.einsum(
            "bhqj,bjd->bhqd", p.astype(c.dtype), c, preferred_element_type=jnp.float32
        ).astype(dtype)
        out = jnp.einsum(
            "bhqd,dhe->bhqe", u, wv, preferred_element_type=jnp.float32
        ).astype(dtype)
        return merge_heads(out)

    def _materializing_attention(self, q, k, v, bias, scale, deterministic):
        """XLA path materializing the score matrix — covers talking-heads,
        re-attention, LSA masking with learned temperature, and training-mode
        attention dropout (SURVEY.md §7.3 item 5)."""
        s = jnp.einsum("bhid,bhjd->bhij", q, k, preferred_element_type=jnp.float32)
        s = s * scale
        if bias is not None:
            s = s + bias.astype(s.dtype)
        if self.mask_self:
            nq, nk = s.shape[-2:]
            s = jnp.where(jnp.eye(nq, nk, dtype=bool), ops.MASK_VALUE, s)
        if self.talking_heads:
            mix_pre = self.param(
                "mix_heads_pre", nn.initializers.normal(0.02), (self.heads, self.heads)
            )
            s = jnp.einsum("bhij,hg->bgij", s, mix_pre)
        p = jax.nn.softmax(s, axis=-1)
        if self.talking_heads:
            mix_post = self.param(
                "mix_heads_post", nn.initializers.normal(0.02), (self.heads, self.heads)
            )
            p = jnp.einsum("bhij,hg->bgij", p, mix_post)
        if self.reattention:
            # DeepViT: learned head re-mixing of the attention map,
            # normalized across the head axis (deepvit.py:68-72). Raw
            # parameters (``reattn_weights``/``reattn_scale``/
            # ``reattn_bias``) are the checkpoint layout.
            reattn, rln_scale, rln_bias = self._reattn_params()
            p = jnp.einsum("bhij,hg->bgij", p, reattn.astype(p.dtype))
            p = _layer_norm_f32(
                p.transpose(0, 2, 3, 1), rln_scale, rln_bias, 1e-6
            ).transpose(0, 3, 1, 2).astype(v.dtype)
        p = nn.Dropout(self.dropout, name="attn_drop")(p, deterministic=deterministic)
        return jnp.einsum("bhij,bhjd->bhid", p.astype(v.dtype), v)

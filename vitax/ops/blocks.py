"""Whole-block primitives in plain JAX: the pre-norm MLP, multi-window
attention, and the two head-mixing attention variants (DeepViT
re-attention, CaiT talking heads).

Numerics follow the rest of the framework: float32 LayerNorm with flax's
op sequence, matrix products on the weights' dtype with float32
accumulation rounded once, float32 softmax and bias adds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def layer_norm_f32(x, scale, bias, eps=1e-6):
    """flax.linen.LayerNorm's exact op sequence (fast variance, scale folded
    into the rsqrt multiplier) on float32 inputs."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(
        0.0, jnp.mean(jnp.square(x), axis=-1, keepdims=True) - jnp.square(mean)
    )
    mul = jax.lax.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


def activate(h, activation: str):
    if activation == "gelu":
        return jax.nn.gelu(h)
    if activation == "gelu_exact":  # erf-based, HF/timm ViTs (interop)
        return jax.nn.gelu(h, approximate=False)
    if activation == "hard_swish":  # LeViT MLP flavor (levit.py:40)
        return h * jax.nn.relu6(h + 3.0) / 6.0
    raise ValueError(activation)


def mlp(
    x,
    w1,
    b1,
    w2,
    b2,
    ln_scale=None,
    ln_bias=None,
    *,
    activation: str = "gelu",
    residual: bool = True,
    ln_eps: float = 1e-6,
):
    """``[LN ->] GEMM -> act -> GEMM [-> +x]`` over tokens ``[..., T, D]``.

    The products run in the weights' dtype (mixed precision follows the
    weights) with float32 accumulation and float32 bias adds."""
    h = x.astype(jnp.float32)
    if ln_scale is not None:
        lb = ln_bias if ln_bias is not None else jnp.zeros_like(ln_scale)
        h = layer_norm_f32(h, ln_scale.astype(jnp.float32), lb.astype(jnp.float32), ln_eps)
    h = h.astype(w1.dtype)
    h = jnp.dot(h, w1, preferred_element_type=jnp.float32)
    if b1 is not None:
        h = h + b1.astype(h.dtype)
    h = activate(h, activation)
    h = jnp.dot(h.astype(w2.dtype), w2, preferred_element_type=jnp.float32)
    if b2 is not None:
        h = h + b2.astype(h.dtype)
    if residual:
        h = h + x.astype(h.dtype)
    return h.astype(x.dtype)


def _norm_qkv_heads(x, ln_scale, ln_bias, wqkv, heads, ln_eps):
    """LN -> fused qkv GEMM -> ``(q, k, v)`` each ``[B, H, N, D]``."""
    b, n, _ = x.shape
    d = wqkv.shape[1] // 3 // heads
    xn = layer_norm_f32(
        x.astype(jnp.float32), ln_scale.astype(jnp.float32),
        ln_bias.astype(jnp.float32), ln_eps,
    ).astype(wqkv.dtype)
    qkv = jnp.einsum("bnd,df->bnf", xn, wqkv, preferred_element_type=jnp.float32)
    q, k, v = jnp.split(qkv.astype(wqkv.dtype), 3, axis=-1)
    split = lambda t: t.reshape(b, n, heads, d).transpose(0, 2, 1, 3)
    return split(q), split(k), split(v)


def _merge_project(o, wout, bout):
    """``[B, H, N, D]`` -> out GEMM + bias, float32 result."""
    b, h, n, d = o.shape
    o = o.transpose(0, 2, 1, 3).reshape(b, n, h * d).astype(wout.dtype)
    out = jnp.einsum("bnf,fd->bnd", o, wout, preferred_element_type=jnp.float32)
    return out + bout.astype(jnp.float32)


def window_attention_block(
    xw, ln_scale, ln_bias, wqkv, wout, bout, heads: int, bias=None, *,
    scale=None, ln_eps: float = 1e-5,
):
    """LN -> qkv GEMM -> attention (+shared bias) -> out GEMM over windowed
    tokens ``[NW, S, C]``. ``bias`` is ``[H|1, S, S]``, shared by every
    window. No residual add."""
    s = xw.shape[1]
    q, k, v = _norm_qkv_heads(xw, ln_scale, ln_bias, wqkv, heads, ln_eps)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sc = jnp.einsum("whid,whjd->whij", q, k, preferred_element_type=jnp.float32)
    sc = sc * scale
    if bias is not None:
        sc = sc + bias.reshape(1, -1, s, s).astype(jnp.float32)
    p = jax.nn.softmax(sc, axis=-1)
    o = jnp.einsum("whij,whjd->whid", p.astype(v.dtype), v)
    return _merge_project(o, wout, bout).astype(xw.dtype)


def reattention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias,
    heads: int, *, scale=None, ln_eps=1e-6, reattn_eps=1e-6,
):
    """DeepViT re-attention block (deepvit.py:60-77 semantics): softmax
    attention whose per-head maps are re-mixed across heads by ``mix`` and
    normalized over the head axis, then PV, out projection and residual."""
    q, k, v = _norm_qkv_heads(x, ln_scale, ln_bias, wqkv, heads, ln_eps)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = jnp.einsum("bhid,bhjd->bhij", q, k, preferred_element_type=jnp.float32) * scale
    p = jax.nn.softmax(s, axis=-1)
    r = jnp.einsum("bhij,hg->bgij", p, mix.astype(p.dtype))
    r = layer_norm_f32(
        r.transpose(0, 2, 3, 1),
        rln_scale.astype(jnp.float32),
        rln_bias.astype(jnp.float32),
        reattn_eps,
    ).transpose(0, 3, 1, 2)
    o = jnp.einsum("bhij,bhjd->bhid", r.astype(v.dtype), v)
    return (_merge_project(o, wout, bout) + x.astype(jnp.float32)).astype(x.dtype)


def talking_heads_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post,
    heads: int, *, scale=None, ln_eps=1e-5, residual=False,
):
    """CaiT talking-heads attention block (cait.py:87-107 semantics): head
    mixes before and after the softmax, then PV and the out projection
    (+x if ``residual``)."""
    q, k, v = _norm_qkv_heads(x, ln_scale, ln_bias, wqkv, heads, ln_eps)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = jnp.einsum("bhid,bhjd->bhij", q, k, preferred_element_type=jnp.float32) * scale
    s = jnp.einsum("bhij,hg->bgij", s, mix_pre.astype(s.dtype))
    p = jax.nn.softmax(s, axis=-1)
    p = jnp.einsum("bhij,hg->bgij", p, mix_post.astype(p.dtype))
    o = jnp.einsum("bhij,bhjd->bhid", p.astype(v.dtype), v)
    out = _merge_project(o, wout, bout)
    if residual:
        out = out + x.astype(jnp.float32)
    return out.astype(x.dtype)

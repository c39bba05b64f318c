"""Softmax attention.

``attention`` serves the whole zoo's attention surface: global fused-qkv
self-attention, cross/context attention, additive logit bias (LeViT,
RegionViT, CrossFormer relative positions), the LSA diagonal self-mask, and
window attention once the windows are folded into the batch axis.

On a GPU, plain bf16/fp16 attention goes to cuDNN's fused flash attention
(``jax.nn.dot_product_attention(implementation="cudnn")``): in the bf16
ViT-L/16 forward at batch 128 it measured 17% faster end to end than the
einsum-softmax-einsum XLA compiles, and 5x faster alone at 3136 tokens
(``scripts/attention_routes.py``, PERF.md). Everything cuDNN does not take
(float32, a bias, the diagonal mask, a value head width that differs from
the key's, head widths above 128 or not a multiple of 8) and every other
backend runs ``reference_attention``, which is also the reference the
tests compare with. Under autodiff the cuDNN route runs the XLA path,
forward and backward (``_cudnn_bnhd``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

# -0.7 * float32 max: large negative that survives exp() without NaN.
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

_CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)


def reference_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    bias: Optional[jax.Array] = None,
    *,
    scale: Optional[float] = None,
    mask_self: bool = False,
) -> jax.Array:
    """Multi-head attention in plain XLA, ``[B, H, N, D]`` in and out.

    Args:
      q: ``[B, H, Nq, D]`` queries.
      k: ``[B, H, Nk, D]`` keys.
      v: ``[B, H, Nk, Dv]`` values (``Dv`` may differ from ``D``).
      bias: optional additive logit bias, broadcastable ``[B|1, H|1, Nq, Nk]``.
      scale: logit scale; defaults to ``D ** -0.5``.
      mask_self: mask the q == k diagonal (LSA).

    Scores and softmax run in float32; the output has the dtype of ``v``.
    """
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    s = jnp.einsum("bhid,bhjd->bhij", q, k, preferred_element_type=jnp.float32)
    s = s * scale
    if bias is not None:
        s = s + bias.astype(s.dtype)
    if mask_self:
        nq, nk = s.shape[-2:]
        s = jnp.where(jnp.eye(nq, nk, dtype=bool), MASK_VALUE, s)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhij,bhjd->bhid", p.astype(v.dtype), v)


def uses_cudnn(q, k, v, bias=None, *, scale=None, mask_self: bool = False) -> bool:
    """Whether ``attention`` sends these operands to cuDNN."""
    d = q.shape[-1]
    return (
        jax.default_backend() == "gpu"
        and bias is None
        and not mask_self
        and (scale is None or isinstance(scale, (int, float)))
        and q.dtype in _CUDNN_DTYPES
        and q.dtype == k.dtype == v.dtype
        and v.shape[-1] == d
        and d % 8 == 0
        and d <= 128
    )


def _reference_bnhd(q, k, v, scale):
    t = lambda a: a.transpose(0, 2, 1, 3)
    return t(reference_attention(t(q), t(k), t(v), scale=scale))


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _cudnn_bnhd(q, k, v, scale):
    """cuDNN flash attention on ``[B, N, H, D]`` operands.

    Differentiated, it runs the XLA path forward and backward instead:
    cuDNN's fused backward refuses odd sequence lengths (197 tokens for
    ViT-L/16 @224), and its partitioner refuses q/k/v with differing
    shardings, which GSPMD tensor parallelism makes of the fused qkv
    projection in the train step."""
    return jax.nn.dot_product_attention(q, k, v, scale=scale, implementation="cudnn")


def _cudnn_fwd(q, k, v, scale):
    return jax.vjp(lambda q, k, v: _reference_bnhd(q, k, v, scale), q, k, v)


def _cudnn_bwd(scale, vjp, g):
    return vjp(g)


_cudnn_bnhd.defvjp(_cudnn_fwd, _cudnn_bwd)


def _static_scale(q, scale) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    bias: Optional[jax.Array] = None,
    *,
    scale: Optional[float] = None,
    mask_self: bool = False,
) -> jax.Array:
    """Multi-head attention, ``[B, H, N, D]`` in and out (arguments as in
    ``reference_attention``)."""
    if uses_cudnn(q, k, v, bias, scale=scale, mask_self=mask_self):
        t = lambda a: a.transpose(0, 2, 1, 3)
        return t(_cudnn_bnhd(t(q), t(k), t(v), _static_scale(q, scale)))
    return reference_attention(q, k, v, bias, scale=scale, mask_self=mask_self)


def qkv_attention(qkv, heads: int, bias=None, *, scale: Optional[float] = None):
    """Self-attention on the fused projection layout ``[B, N, 3*H*D]``
    (``[q | k | v]``, heads minor), returning ``[B, N, H*D]``. The cuDNN
    route reads the layout as ``[B, N, 3, H, D]`` with no transposes."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    q, k, v = (qkv.reshape(b, n, 3, heads, d)[:, :, i] for i in range(3))
    if uses_cudnn(q, k, v, bias, scale=scale):
        return _cudnn_bnhd(q, k, v, _static_scale(q, scale)).reshape(b, n, hd)
    t = lambda a: a.transpose(0, 2, 1, 3)
    out = reference_attention(t(q), t(k), t(v), bias, scale=scale)
    return t(out).reshape(b, n, hd)

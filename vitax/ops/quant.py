"""Int8 quantized GEMM primitives (post-training quantization).

An H100's tensor cores run int8 at twice the bf16 rate (1,979 vs 989 dense
TOPS, NVIDIA's data sheet), and independent of whether XLA reaches that
peak, int8 weights halve the weight memory footprint and traffic — the
dominant term at small serving batches (ViT-L weights ~610MB fp32 / ~305MB
bf16; a batch-1 forward is weight-bound). The model-level transform lives
in ``vitax/utils/quantize.py``.

Scheme (the standard W8A8 dynamic recipe):
  - weights: symmetric per-output-channel int8, scale = amax/127 over the
    contraction dim (zero-point-free keeps the GEMM a plain int8 dot);
  - activations: symmetric per-row (per-token) dynamic int8 — the row max
    is computed in-graph, so no calibration set is needed;
  - accumulation in int32 (``preferred_element_type``), fp32 epilogue
    ``acc * (s_row * s_col) + bias``.

No reference counterpart: the reference (conceptofmind/vit-flax) has no
quantization story at all.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def quantize_symmetric(v: jax.Array, axes) -> Tuple[jax.Array, jax.Array]:
    """THE symmetric int8 recipe — the one definition every quantization
    path in the repo shares (weights, dynamic activations and the QAT
    straight-through forward), so the
    QAT-forward == deployed-forward contract can't drift: scale =
    max(|v|, 1e-12)/127 reduced over ``axes`` (keepdims), value =
    clip(round(v/scale), ±127).

    Returns ``(v_i8, fp32 scale)`` with ``v ~= v_i8 * scale``.
    """
    vf = v.astype(jnp.float32)
    amax = jnp.max(jnp.abs(vf), axis=axes, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    v_i8 = jnp.clip(jnp.round(vf / scale), -127, 127).astype(jnp.int8)
    return v_i8, scale


def quantize_channelwise(w: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Symmetric per-output-channel int8 quantization of a GEMM weight.

    ``w``: (..., K, N) — one scale per output channel (the contraction axis
    is reduced). Leading axes (e.g. the scan depth axis of stacked encoder
    weights) keep independent scales per (leading, N) pair.

    Returns ``(w_i8, scale)`` with ``w ~= w_i8 * scale`` and ``scale``
    shaped like ``w`` with the contraction axis reduced to 1.
    """
    return quantize_symmetric(w, -2)


def dequantize(w_i8: jax.Array, scale: jax.Array, dtype=jnp.float32) -> jax.Array:
    return (w_i8.astype(jnp.float32) * scale).astype(dtype)


def quantize_rows(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Symmetric per-row (per-token) dynamic int8 quantization of an
    activation ``(..., K)``. Returns ``(x_i8, row_scale (...,1) fp32)``."""
    return quantize_symmetric(x, -1)


def int8_matmul(
    x: jax.Array,
    w_i8: jax.Array,
    w_scale: jax.Array,
    bias: Optional[jax.Array] = None,
    out_dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    """``x @ dequant(w)`` executed as an int8 x int8 -> int32 GEMM.

    ``x``: (..., K) float; quantized per-row in-graph (dynamic). ``w_i8``:
    (K, N) int8 with ``w_scale`` (1, N). The int32 accumulator picks up the
    fp32 epilogue ``* (s_row * s_col) [+ bias]``; bias (fp32) is added on
    the fp32 accumulator exactly like the non-quantized blocks do.
    """
    x_i8, s_row = quantize_rows(x)
    acc = jax.lax.dot_general(
        x_i8,
        w_i8,
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    out = acc.astype(jnp.float32) * s_row * w_scale.reshape(-1)
    if bias is not None:
        out = out + bias.astype(jnp.float32)
    return out.astype(out_dtype or x.dtype)

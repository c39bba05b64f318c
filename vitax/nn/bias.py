"""Relative-position attention-bias tables.

These produce the additive ``bias`` consumed by the flash-attention kernel's
bias lane (vitax.ops.flash_attention): LeViT's learned |Δ| embedding table
(levit.py:107-138), RegionViT's windowed rel-pos table padded for the region
token (region_vit_flax.py:122-149), and CrossFormer's resolution-independent
DynamicPositionBias MLP (crossformer.py:44-60).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vitax._vendor.flax import linen as nn


def _grid_coords(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[:h, :w]
    return np.stack([y.flatten(), x.flatten()], axis=-1)  # [h*w, 2]


class LeViTAttentionBias(nn.Module):
    """Learned positional attention bias indexed by (|Δy|, |Δx|)
    (levit.py:107-118). Returns ``[1, heads, Nq, Nk]``."""

    heads: int
    fmap_size: int  # key/value fmap side
    q_fmap_size: Optional[int] = None  # query fmap side (downsampling attn)
    q_stride: int = 1

    @nn.compact
    def __call__(self) -> jax.Array:
        kv_side = self.fmap_size
        q_side = self.q_fmap_size or kv_side
        table = nn.Embed(kv_side * kv_side, self.heads, name="pos_bias")
        q_coords = _grid_coords(q_side, q_side) * self.q_stride
        k_coords = _grid_coords(kv_side, kv_side)
        rel = np.abs(q_coords[:, None, :] - k_coords[None, :, :])  # [Nq, Nk, 2]
        idx = rel[..., 0] * kv_side + rel[..., 1]
        bias = table(jnp.asarray(idx))  # [Nq, Nk, heads]
        return bias.transpose(2, 0, 1)[None]


class WindowRelPosBias(nn.Module):
    """Learned rel-pos bias for a w x w window, with one leading row/col of
    zero-padding for a prepended region/cls token (region_vit_flax.py:137-149).
    Returns ``[1, heads, w*w(+1), w*w(+1)]``."""

    heads: int
    window_size: int
    prepend_tokens: int = 0

    @nn.compact
    def __call__(self) -> jax.Array:
        w = self.window_size
        span = 2 * w - 1
        table = nn.Embed(span * span, self.heads, name="rel_pos_bias")
        coords = _grid_coords(w, w)
        rel = coords[:, None, :] - coords[None, :, :] + (w - 1)  # [N, N, 2]
        idx = rel[..., 0] * span + rel[..., 1]
        bias = table(jnp.asarray(idx)).transpose(2, 0, 1)  # [heads, N, N]
        p = self.prepend_tokens
        if p:
            bias = jnp.pad(bias, ((0, 0), (p, 0), (p, 0)))
        return bias[None]


class ReferenceWindowRelPosBias(nn.Module):
    """RegionViT rel-pos bias exactly as the reference executes under
    clamped gathers (region_vit_flax.py:121-149).

    The reference builds its (2*window_size-1)^2-entry table from the
    DECLARED window size but indexes it with offsets from the ACTUAL
    local/region ratio grid (4x larger at the default config, because the
    regional tokens are space-to-depthed from the already-downsampled local
    fmap, region_vit_flax.py:243-245). The resulting indices run far out of
    table range; a gather that clamps out-of-bounds indices reads edge
    entries for all far offsets (CPU jax fills NaN instead).
    Reproduced here with an explicit clip so the behavior is
    platform-independent. Returns ``[1, heads, N+1, N+1]`` (zero row/col
    padded for the region token).
    """

    heads: int
    declared_window_size: int  # table geometry + the reference's index stride
    window_h: int              # actual ratio grid (lh // rh)
    window_w: int

    @nn.compact
    def __call__(self) -> jax.Array:
        w = self.declared_window_size
        span = 2 * w - 1
        table = nn.Embed(span * span, self.heads, name="rel_pos_bias")
        gx, gy = np.meshgrid(
            np.arange(self.window_h), np.arange(self.window_w), indexing="ij"
        )
        grid = np.stack([gx.flatten(), gy.flatten()])  # [2, N]
        rel = (grid[:, :, None] - grid[:, None, :]) + (w - 1)  # [2, N, N]
        idx = rel[0] * 1 + rel[1] * span  # reference's stride vector [1, 2w-1]
        idx = np.clip(idx, 0, span * span - 1)  # clamped-gather semantics
        bias = table(jnp.asarray(idx)).transpose(2, 0, 1)[None]  # [1, h, N, N]
        return jnp.pad(bias, ((0, 0), (0, 0), (1, 0), (1, 0)))


class DynamicPositionBias(nn.Module):
    """CrossFormer DPB: a small MLP over continuous relative coordinates —
    resolution-independent by construction (crossformer.py:44-60).

    ``__call__(window_size)`` returns ``[1, heads, w*w, w*w]`` (per-head,
    the paper's formulation). ``reference_quirks=True`` reproduces the
    reference exactly instead: the MLP collapses to ONE scalar per offset
    (Dense(1), crossformer.py:58) and the offsets are evaluated on a
    ``(2w+1)``-spaced grid but gathered with ``(2w-1)`` strides
    (crossformer.py:122-127,154-158) — a misindexing that still yields a
    consistent learned bias, just not the geometric one intended. Needed
    for exact-weight parity with reference checkpoints.
    """

    dim: int
    heads: int
    reference_quirks: bool = False

    @nn.compact
    def __call__(self, window_size: int) -> jax.Array:
        w = window_size
        if self.reference_quirks:
            span_eval = 2 * w + 1  # offsets arange(-w, w+1) per axis
            offs = np.stack(
                np.meshgrid(np.arange(span_eval), np.arange(span_eval), indexing="ij"), -1
            )
            offs = offs.reshape(-1, 2) - w
            out_features = 1
            idx_stride = 2 * w - 1  # the reference's mismatched gather stride
        else:
            span_eval = 2 * w - 1
            offs = np.stack(
                np.meshgrid(np.arange(span_eval), np.arange(span_eval), indexing="ij"), -1
            )
            offs = offs.reshape(-1, 2) - (w - 1)
            out_features = self.heads
            idx_stride = span_eval

        h = jnp.asarray(offs, jnp.float32)
        h = nn.Dense(self.dim, name="fc0")(h)
        h = nn.LayerNorm(epsilon=1e-5, use_bias=False, name="ln0")(h)
        h = nn.relu(h)
        h = nn.Dense(self.dim, name="fc1")(h)
        h = nn.LayerNorm(epsilon=1e-5, use_bias=False, name="ln1")(h)
        h = nn.relu(h)
        h = nn.Dense(self.dim, name="fc2")(h)
        h = nn.LayerNorm(epsilon=1e-5, use_bias=False, name="ln2")(h)
        h = nn.relu(h)
        h = nn.Dense(out_features, name="fc3")(h)  # [span_eval^2, out]

        coords = _grid_coords(w, w)
        rel = coords[:, None, :] - coords[None, :, :] + (w - 1)
        idx = rel[..., 0] * idx_stride + rel[..., 1]  # [N, N]
        bias = h[jnp.asarray(idx.reshape(-1))]  # [N*N, out]
        n = w * w
        return bias.reshape(n, n, out_features).transpose(2, 0, 1)[None]

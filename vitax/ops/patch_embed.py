"""Patch-extraction ops — in-graph and jit-compatible.

Replaces the reference's three patchification mechanisms:

1. non-overlapping space-to-depth rearrange (vit.py:146 and eight clones) —
   a pure layout transform that XLA fuses into the following projection GEMM;
2. host-side ``tf.image.extract_patches`` (t2t.py:147, pit.py:212-218) — the
   repo's only host round-trips, replaced by
   ``jax.lax.conv_general_dilated_patches`` so T2T/PiT trace end-to-end;
3. SPT shifted-concat tokenization (vit_small_datasets.py:15-46,134-153).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def patchify(x: jax.Array, patch_h: int, patch_w: int | None = None) -> jax.Array:
    """``[B, H, W, C] -> [B, (H/ph)*(W/pw), ph*pw*C]`` non-overlapping patches.

    Feature order matches einops ``'b (h p1) (w p2) c -> b (h w) (p1 p2 c)'``
    (the reference's convention, vit.py:146), so projection weights are
    interchangeable for parity testing.
    """
    patch_w = patch_w if patch_w is not None else patch_h
    b, h, w, c = x.shape
    gh, gw = h // patch_h, w // patch_w
    x = x.reshape(b, gh, patch_h, gw, patch_w, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_h * patch_w * c)


def unpatchify(x: jax.Array, grid_h: int, grid_w: int, patch_h: int, patch_w: int, c: int) -> jax.Array:
    """Inverse of :func:`patchify`."""
    b = x.shape[0]
    x = x.reshape(b, grid_h, grid_w, patch_h, patch_w, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid_h * patch_h, grid_w * patch_w, c)


def extract_patches(
    x: jax.Array, kernel: int, stride: int, padding: str = "SAME"
) -> jax.Array:
    """Overlapping patches, TF ``extract_patches``-compatible feature order.

    ``[B, H, W, C] -> [B, Ho, Wo, kernel*kernel*C]`` with features ordered
    (row, col, channel) — matching ``tf.image.extract_patches`` so T2T/PiT
    parity holds bit-for-bit (SURVEY.md §7.3 item 4) while staying in-graph.
    """
    c = x.shape[-1]
    # conv_general_dilated_patches returns features as (channel, row, col)
    # in the channel dim for NHWC inputs; transpose to TF's (row, col, chan).
    # (A k^2-strided-slices + channel-concat formulation is the obvious
    # alternative; in the whole model XLA fused its concat into the stage
    # GEMMs and re-gathered strided source per tile, so the conv lowering
    # stays. Not yet measured on a GPU.)
    patches = jax.lax.conv_general_dilated_patches(
        x,
        filter_shape=(kernel, kernel),
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )  # [B, Ho, Wo, C*k*k] ordered (c, kh, kw)
    b, ho, wo, _ = patches.shape
    patches = patches.reshape(b, ho, wo, c, kernel * kernel)
    patches = jnp.swapaxes(patches, -1, -2)
    return patches.reshape(b, ho, wo, kernel * kernel * c)


def spt_shifts(x: jax.Array) -> jax.Array:
    """Shifted Patch Tokenization input expansion (vit_small_datasets.py:15-46).

    Concatenates the image with four zero-filled 1-px shifts along channels:
    ``[B, H, W, C] -> [B, H, W, 5C]`` in the reference's order
    [x, right, left, down, up]. (The SPT paper shifts diagonally; the
    reference shifts axis-aligned — matched here so trained reference
    weights import cleanly.)
    """
    # (height_shift, width_shift): right, left, down, up
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0))
    pieces = [x]
    for dy, dx in shifts:
        padded = jnp.pad(
            x,
            ((0, 0), (max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0)), (0, 0)),
        )
        y0 = max(-dy, 0)
        x0 = max(-dx, 0)
        pieces.append(padded[:, y0 : y0 + x.shape[1], x0 : x0 + x.shape[2], :])
    return jnp.concatenate(pieces, axis=-1)


def posemb_sincos_2d(
    h: int, w: int, dim: int, temperature: float = 10000.0, dtype=jnp.float32
) -> jax.Array:
    """Fixed 2-D sin-cos positional embedding ``[h*w, dim]`` (simple_vit.py:14-25)."""
    y, x = np.mgrid[:h, :w]
    assert dim % 4 == 0, "feature dimension must be multiple of 4 for sincos emb"
    omega = np.arange(dim // 4) / (dim // 4 - 1)
    omega = 1.0 / (temperature**omega)
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1)
    return jnp.asarray(pe, dtype=dtype)

"""Static window-partition index transforms.

Window/dilated-window attention in the reference is a rearrange that folds
windows into the batch axis followed by plain attention (crossformer.py:139-141,
twins_svt.py:120, nest.py:183, scalable_vit.py:195, region_vit_flax.py:158).
Here the partitions are pure layout transforms (XLA fuses them into the
surrounding GEMMs) and the attention itself is ``ops.attention`` with the
windows folded into its batch axis (SURVEY.md §2.4 item 2).
"""

from __future__ import annotations

import jax


def window_partition(x: jax.Array, wsz: int) -> jax.Array:
    """``[B, H, W, C] -> [B*nh*nw, wsz*wsz, C]`` contiguous windows."""
    b, h, w, c = x.shape
    nh, nw = h // wsz, w // wsz
    x = x.reshape(b, nh, wsz, nw, wsz, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, wsz * wsz, c)


def window_unpartition(x: jax.Array, wsz: int, h: int, w: int) -> jax.Array:
    """Inverse of :func:`window_partition`."""
    nh, nw = h // wsz, w // wsz
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, wsz, wsz, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def dilated_partition(x: jax.Array, wsz: int) -> jax.Array:
    """``[B, H, W, C] -> [B*gh*gw, wsz*wsz, C]`` dilated (long-distance)
    windows: each window takes tokens strided by (H/wsz, W/wsz)
    (CrossFormer LDA, crossformer.py:141)."""
    b, h, w, c = x.shape
    gh, gw = h // wsz, w // wsz
    x = x.reshape(b, wsz, gh, wsz, gw, c)
    x = x.transpose(0, 2, 4, 1, 3, 5)
    return x.reshape(b * gh * gw, wsz * wsz, c)


def dilated_unpartition(x: jax.Array, wsz: int, h: int, w: int) -> jax.Array:
    """Inverse of :func:`dilated_partition`."""
    gh, gw = h // wsz, w // wsz
    b = x.shape[0] // (gh * gw)
    c = x.shape[-1]
    x = x.reshape(b, gh, gw, wsz, wsz, c)
    x = x.transpose(0, 3, 1, 4, 2, 5)
    return x.reshape(b, h, w, c)


def block_partition(x: jax.Array, n_blocks: int) -> jax.Array:
    """NesT block split ``[B, H, W, C] -> [B*n*n, H/n, W/n, C]``
    (nest.py:183) — keeps the spatial fmap layout per block."""
    b, h, w, c = x.shape
    bh, bw = h // n_blocks, w // n_blocks
    x = x.reshape(b, n_blocks, bh, n_blocks, bw, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b * n_blocks * n_blocks, bh, bw, c)


def block_unpartition(x: jax.Array, n_blocks: int) -> jax.Array:
    """Inverse of :func:`block_partition`."""
    bn, bh, bw, c = x.shape
    b = bn // (n_blocks * n_blocks)
    x = x.reshape(b, n_blocks, n_blocks, bh, bw, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n_blocks * bh, n_blocks * bw, c)

"""Learned position-embedding resolution transfer.

Every learned-pos-embedding family in the zoo (ViT vit.py:142, DeepViT,
CaiT, ParallelViT, PatchMerger-ViT, SPT/LSA-ViT, CrossViT branches, NesT's
per-hierarchy tables) is locked to its training resolution — the reference
offers no way to run a trained model at another input size. The standard
deployment fix (ViT paper §3.2, "fine-tuning at higher resolution") is 2-D
interpolation of the position table over the patch grid; this implements it
as a pure parameter transform, so a checkpoint trained at 256 runs at 224
or 384 by rewriting one tensor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def interpolate_pos_embedding(
    pos: jax.Array,
    new_grid,
    old_grid=None,
    *,
    num_prefix_tokens: int = 1,
    method: str = "bilinear",
) -> jax.Array:
    """Resize a learned position embedding to a new patch grid.

    Args:
      pos: ``[1, P + N, D]`` table (``P`` prefix tokens — cls/distill —
        kept verbatim; ``N = gh * gw`` grid positions interpolated).
      new_grid: target ``(gh, gw)`` (or int for square).
      old_grid: source grid; inferred as square from ``N`` when omitted.
      num_prefix_tokens: leading non-spatial tokens (0 for SimpleViT-style
        tables, 1 for cls, 2 for cls+distill).
      method: ``jax.image.resize`` method (bilinear matches the ViT paper).

    Returns:
      ``[1, P + gh * gw, D]`` — drop-in replacement for the parameter.
    """
    if isinstance(new_grid, int):
        new_grid = (new_grid, new_grid)
    assert pos.ndim == 3 and pos.shape[0] == 1, f"expected [1, N, D], got {pos.shape}"
    prefix = pos[:, :num_prefix_tokens]
    spatial = pos[:, num_prefix_tokens:]
    n, d = spatial.shape[1], spatial.shape[2]
    if old_grid is None:
        side = int(round(n**0.5))
        assert side * side == n, (
            f"{n} spatial positions is not square; pass old_grid explicitly"
        )
        old_grid = (side, side)
    assert old_grid[0] * old_grid[1] == n, f"{old_grid} != {n} positions"

    grid = spatial.reshape(1, old_grid[0], old_grid[1], d).astype(jnp.float32)
    resized = jax.image.resize(
        grid, (1, new_grid[0], new_grid[1], d), method=method
    )
    resized = resized.reshape(1, new_grid[0] * new_grid[1], d).astype(pos.dtype)
    return jnp.concatenate([prefix, resized], axis=1)


def adapt_vit_resolution(params, image_size: int, patch_size: int,
                         *, num_prefix_tokens: int = 1):
    """Rewrite a ViT-family param tree's ``pos_embedding`` for a new input
    resolution. Returns a new tree; construct the model with the new
    ``image_size`` and apply these params."""
    from vitax._vendor import flax

    def to_plain(d):
        if isinstance(d, (dict, flax.core.FrozenDict)):
            return {k: to_plain(v) for k, v in d.items()}
        return d

    params = to_plain(params)
    assert "pos_embedding" in params, "no top-level pos_embedding in this tree"
    side = image_size // patch_size
    params["pos_embedding"] = interpolate_pos_embedding(
        params["pos_embedding"], (side, side), num_prefix_tokens=num_prefix_tokens
    )
    return params

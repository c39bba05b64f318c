"""RegionViT — regional-to-local attention pyramid (reference:
region_vit_flax.py:178-258).

Each stage: regional tokens self-attend globally, then each local window is
prefixed with its regional token for joint windowed attention with a learned
relative-position bias (region_vit_flax.py:153-171). The regional and joint
attention share one module instance per layer (same-instance semantics,
region_vit_flax.py:152-163), matching the paper's single R2L attention.

Fix-or-match decisions (all fixes, per SURVEY.md §6.3):
  #3  reference discards its mean-pool and returns a 4-D logit map
      (region_vit_flax.py:254-256) — pooled here.
  #14 reference reuses one Downsample instance for local AND regional
      tokens (shared conv weights, region_vit_flax.py:250) — separate here.
  (tokenization) reference space-to-depths the *downsampled local fmap* by
      region_patch_size (region_vit_flax.py:243-245), which makes the
      local/region ratio 4x the window size and sends its rel-pos gather
      out of table range; here regional tokens come from the original image
      so the ratio equals ``window_size`` as the paper defines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax import ops
from vitax.nn.attention import Attention
from vitax.nn.bias import ReferenceWindowRelPosBias, WindowRelPosBias
from vitax.nn.blocks import FeedForward, scan_unroll_for
from vitax.nn.conv import Downsample, PEG


class _R2LBlock(nn.Module):
    """One regional-to-local layer — the scan cell of a stage. The same
    attention module runs the regional and the joint pass (same-instance
    semantics, region_vit_flax.py:152-163)."""

    dim: int
    window_size: int
    heads: int = 4
    dim_head: int = 32
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    norm_eps: float = 1e-5  # every LayerNorm in region_vit_flax.py uses 1e-5
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, carry, bias, deterministic: bool = True):
        local_tokens, region = carry
        b, lh, lw, d = local_tokens.shape
        n_win = region.shape[1]

        attn = Attention(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            dropout=self.attn_dropout,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
            name="attn",
        )
        ff = FeedForward(
            self.dim, self.dim * 4, self.ff_dropout, ln_eps=self.norm_eps,
            dtype=self.dtype, name="ff",
        )

        # regional self-attention (global over the region grid)
        region = region + attn(region, deterministic=deterministic)

        # joint attention: each window prefixed with its region token
        local_win = ops.window_partition(local_tokens, self.window_size)
        region_win = region.reshape(b * n_win, 1, d)
        joint = jnp.concatenate([region_win, local_win], axis=1)
        joint = joint + attn(joint, bias=bias, deterministic=deterministic)
        joint = joint + ff(joint, deterministic=deterministic)

        region = joint[:, :1].reshape(b, n_win, d)
        local_tokens = ops.window_unpartition(joint[:, 1:], self.window_size, lh, lw)
        return (local_tokens, region), ()


class _R2LStage(nn.Module):
    dim: int
    window_size: int
    depth: int = 4
    heads: int = 4
    dim_head: int = 32
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    # Reproduce the reference as executed with clamped gathers: windows sized by the
    # local/region ratio (4x the declared window at the default config) and
    # the clamped out-of-range rel-pos gather (see ReferenceWindowRelPosBias).
    reference_quirks: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, local_tokens, region_tokens, deterministic: bool = True):
        b, lh, lw, d = local_tokens.shape
        rh, rw = region_tokens.shape[1:3]
        wsz_h, wsz_w = lh // rh, lw // rw
        if self.reference_quirks:
            window = wsz_h
            assert wsz_h == wsz_w, f"non-square ratio {wsz_h}x{wsz_w}"
            bias = ReferenceWindowRelPosBias(
                self.heads, self.window_size, wsz_h, wsz_w, name="rel_pos_bias"
            )().astype(jnp.float32)
        else:
            window = self.window_size
            assert wsz_h == wsz_w == self.window_size, (
                f"local/region ratio {wsz_h}x{wsz_w} != window_size {self.window_size}"
            )
            bias = WindowRelPosBias(
                self.heads, self.window_size, prepend_tokens=1, name="rel_pos_bias"
            )().astype(jnp.float32)

        region = region_tokens.reshape(b, rh * rw, d)
        cfg = dict(
            dim=self.dim,
            window_size=window,
            heads=self.heads,
            dim_head=self.dim_head,
            attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout,
            dtype=self.dtype,
        )
        if self.depth > 1:
            stacked = nn.scan(
                _R2LBlock,
                variable_axes={"params": 0},
                split_rngs={"params": True, "dropout": True},
                length=self.depth,
                in_axes=nn.broadcast,
                unroll=scan_unroll_for(self.depth),
            )(**cfg, name="blocks")
            (local_tokens, region), _ = stacked((local_tokens, region), bias, deterministic)
        else:
            (local_tokens, region), _ = _R2LBlock(**cfg, name="blocks")(
                (local_tokens, region), bias, deterministic
            )

        return local_tokens, region.reshape(b, rh, rw, d)


class RegionViT(nn.Module):
    dim: Tuple[int, ...] = (64, 128, 256, 512)
    depth: Tuple[int, ...] = (2, 2, 8, 2)
    window_size: int = 7
    num_classes: int = 1000
    tokenize_local_3_conv: bool = False
    local_patch_size: int = 4
    use_peg: bool = False
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    # Reproduce the reference exactly as it executes with clamped gathers, for
    # imported-checkpoint parity: regional tokens space-to-depthed
    # (channel-major) from the downsampled local fmap so windows are the
    # 4x local/region ratio (region_vit_flax.py:243-247), ONE Downsample
    # instance shared by local and regional tokens (:250, bug register
    # #14), clamped out-of-range rel-pos gathers (:137-149), and the 4-D
    # unpooled logit map (:254-256, bug register #3). Default False = the
    # fixed architecture documented in the module docstring.
    reference_quirks: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, img: jax.Array, train: bool = False) -> jax.Array:
        det = not train
        init_dim = self.dim[0]
        region_patch_size = self.local_patch_size * self.window_size
        _, h, w, _ = img.shape
        assert h % region_patch_size == 0 and w % region_patch_size == 0

        if self.tokenize_local_3_conv:
            x = nn.Conv(init_dim, (3, 3), strides=2, padding="SAME", dtype=self.dtype, name="local_conv0")(img)
            x = nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=self.dtype, name="local_norm0")(x)
            x = nn.gelu(x)
            x = nn.Conv(init_dim, (3, 3), strides=2, padding="SAME", dtype=self.dtype, name="local_conv1")(x)
            x = nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=self.dtype, name="local_norm1")(x)
            x = nn.gelu(x)
            local_tokens = nn.Conv(init_dim, (3, 3), padding="SAME", dtype=self.dtype, name="local_conv2")(x)
        else:
            local_tokens = nn.Conv(
                init_dim, (8, 8), strides=4, padding="SAME", dtype=self.dtype, name="local_conv"
            )(img)

        if self.reference_quirks:
            # regional tokens from the DOWNSAMPLED local fmap, channel-major
            # space-to-depth ('b (h p1) (w p2) c -> b h w (c p1 p2)',
            # region_vit_flax.py:243), projected by a 1x1 conv (:244-247).
            bsz, lh0, lw0, c0 = local_tokens.shape
            p = region_patch_size
            rh0, rw0 = lh0 // p, lw0 // p
            xr = local_tokens.reshape(bsz, rh0, p, rw0, p, c0)
            xr = xr.transpose(0, 1, 3, 5, 2, 4).reshape(bsz, rh0, rw0, c0 * p * p)
            region_tokens = nn.Dense(init_dim, dtype=self.dtype, name="region_proj")(xr)
        else:
            # fixed model: regional tokens from the original image (see
            # fix note above) so the local/region ratio equals window_size
            region = ops.patchify(img, region_patch_size)
            rh = h // region_patch_size
            region = region.reshape(img.shape[0], rh, w // region_patch_size, -1)
            region_tokens = nn.Dense(init_dim, dtype=self.dtype, name="region_proj")(region)

        for s in range(len(self.dim)):
            if s > 0:
                if self.reference_quirks:
                    # ONE Downsample instance for both token sets — shared
                    # conv weights (same-instance flax semantics,
                    # region_vit_flax.py:250)
                    down = Downsample(self.dim[s], dtype=self.dtype, name=f"down_{s}")
                    local_tokens = down(local_tokens)
                    region_tokens = down(region_tokens)
                else:
                    local_tokens = Downsample(self.dim[s], dtype=self.dtype, name=f"local_down_{s}")(local_tokens)
                    region_tokens = Downsample(self.dim[s], dtype=self.dtype, name=f"region_down_{s}")(region_tokens)
                if self.use_peg:
                    local_tokens = PEG(self.dim[s], dtype=self.dtype, name=f"peg_{s}")(local_tokens)
            local_tokens, region_tokens = _R2LStage(
                dim=self.dim[s],
                window_size=self.window_size,
                depth=self.depth[s],
                attn_dropout=self.attn_dropout,
                ff_dropout=self.ff_dropout,
                reference_quirks=self.reference_quirks,
                dtype=self.dtype,
                name=f"stage_{s}",
            )(local_tokens, region_tokens, deterministic=det)

        if self.reference_quirks:
            # the reference discards its mean-pool and maps logits over the
            # unpooled region fmap (region_vit_flax.py:254-256): 4-D output
            x = nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=self.dtype, name="head_norm")(region_tokens)
            return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

        x = jnp.mean(region_tokens, axis=(1, 2))
        x = nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=self.dtype, name="head_norm")(x)
        return nn.Dense(self.num_classes, dtype=self.dtype, name="head")(x)

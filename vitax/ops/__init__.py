"""Op layer: attention, MLP, patch and window primitives in plain JAX.

Everything here is ordinary ``jax.numpy``/``lax`` code that XLA compiles
for the device: the matrix products go to cuBLAS on a GPU, the softmax,
LayerNorm, activation and residual adds fuse around them.
"""

from __future__ import annotations

from vitax.ops.attention_core import (  # noqa: F401
    MASK_VALUE,
    attention,
    qkv_attention,
    reference_attention,
)
from vitax.ops.blocks import (  # noqa: F401
    layer_norm_f32,
    mlp,
    reattention_block,
    talking_heads_block,
    window_attention_block,
)
from vitax.ops.patch_embed import (  # noqa: F401
    extract_patches,
    patchify,
    posemb_sincos_2d,
    spt_shifts,
    unpatchify,
)
from vitax.ops.windows import (  # noqa: F401
    block_partition,
    block_unpartition,
    dilated_partition,
    dilated_unpartition,
    window_partition,
    window_unpartition,
)

__all__ = [
    "attention",
    "qkv_attention",
    "reference_attention",
    "mlp",
    "window_attention_block",
    "reattention_block",
    "talking_heads_block",
    "patchify",
    "unpatchify",
    "extract_patches",
    "spt_shifts",
    "posemb_sincos_2d",
]

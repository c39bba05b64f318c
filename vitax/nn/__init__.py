from vitax.nn.attention import Attention, merge_heads, split_heads  # noqa: F401
from vitax.nn.bias import (  # noqa: F401
    DynamicPositionBias,
    LeViTAttentionBias,
    WindowRelPosBias,
)
from vitax.nn.blocks import FeedForward, Transformer  # noqa: F401
from vitax.nn.conv import (  # noqa: F401
    Aggregate,
    ConvMLP,
    CrossEmbedLayer,
    DepthWiseConv2d,
    Downsample,
    PatchEmbedding,
    PEG,
    Pool,
)
from vitax.nn.embed import SPT, PatchEmbed, PatchMerger, ProjectInOut  # noqa: F401
from vitax.nn.identity import Identity  # noqa: F401

"""Model zoo: the 17 reference families, one framework.

Constructor signatures mirror the reference files (SURVEY.md §2.1) so
reference users can switch by changing the import. ``MODEL_REGISTRY`` maps
reference-style names to (class, tiny smoke config, image size) tuples used
by the test suite and benchmarks.
"""

from vitax.models.cait import CaiT
from vitax.models.cross_vit import CrossViT
from vitax.models.crossformer import CrossFormer
from vitax.models.cvt import CvT
from vitax.models.deepvit import DeepViT
from vitax.models.efficient import EfficientViT
from vitax.models.levit import LeViT
from vitax.models.nest import NesT
from vitax.models.parallel_vit import ParallelViT
from vitax.models.patch_merger import PatchMergerViT
from vitax.models.pit import PiT
from vitax.models.region_vit import RegionViT
from vitax.models.scalable_vit import ScalableViT
from vitax.models.simple_vit import SimpleViT
from vitax.models.t2t import T2TViT
from vitax.models.twins_svt import TwinsSVT
from vitax.models.vit import ViT
from vitax.models.vit_small_datasets import ViTSmallDatasets
from vitax.nn.blocks import Transformer as _Transformer
from vitax.nn.embed import SPT, PatchMerger

__all__ = [
    "CaiT",
    "CrossFormer",
    "CrossViT",
    "CvT",
    "DeepViT",
    "EfficientViT",
    "LeViT",
    "NesT",
    "ParallelViT",
    "PatchMerger",
    "PatchMergerViT",
    "PiT",
    "RegionViT",
    "SPT",
    "ScalableViT",
    "SimpleViT",
    "T2TViT",
    "TwinsSVT",
    "ViT",
    "ViTSmallDatasets",
    "MODEL_REGISTRY",
]

# name -> (class, tiny smoke config, image size)
MODEL_REGISTRY = {
    "vit": (
        ViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "simple_vit": (
        SimpleViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "deepvit": (
        DeepViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "parallel_vit": (
        ParallelViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16, num_parallel_branches=2),
        64,
    ),
    "patch_merger_vit": (
        PatchMergerViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=4, heads=4,
             mlp_dim=128, dim_head=16, patch_merge_layer=2, patch_merge_num_tokens=4),
        64,
    ),
    "cait": (
        CaiT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, cls_depth=1,
             heads=4, mlp_dim=128, dim_head=16),
        64,
    ),
    "vit_small_datasets": (
        ViTSmallDatasets,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "cross_vit": (
        CrossViT,
        dict(image_size=64, num_classes=10, sm_dim=32, lg_dim=64, sm_patch_size=8,
             lg_patch_size=16, sm_enc_depth=1, lg_enc_depth=1, sm_enc_mlp_dim=64,
             lg_enc_mlp_dim=128, cross_attn_depth=1, depth=1, sm_enc_heads=2,
             lg_enc_heads=2, cross_attn_heads=2, sm_enc_dim_head=16, lg_enc_dim_head=16,
             cross_attn_dim_head=16, dropout=0.0, emb_dropout=0.0),
        64,
    ),
    "crossformer": (
        CrossFormer,
        dict(num_classes=10, dim=(32, 64), depth=(1, 1), global_window_size=(4, 2),
             local_window_size=7, cross_embed_kernel_sizes=((4, 8), (2, 4)),
             cross_embed_strides=(4, 2)),
        112,
    ),
    "twins_svt": (
        TwinsSVT,
        dict(num_classes=10, s1_emb_dim=16, s1_depth=1, s1_local_patch_size=4,
             s1_global_k=4, s2_emb_dim=16, s2_depth=1, s2_local_patch_size=4,
             s2_global_k=4, s3_emb_dim=32, s3_depth=1, s3_local_patch_size=4,
             s3_global_k=2, s4_emb_dim=32, s4_depth=1, s4_global_k=2),
        64,
    ),
    "nest": (
        NesT,
        dict(image_size=32, patch_size=4, num_classes=10, dim=32, heads=2,
             num_hierarchies=2, block_repeats=(1, 1)),
        32,
    ),
    "scalable_vit": (
        ScalableViT,
        dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 4),
             reduction_factor=(2, 1), window_size=(4, None),
             ssa_dim_key=16, ssa_dim_value=16, iwsa_dim_key=16, iwsa_dim_value=16),
        64,
    ),
    "region_vit": (
        RegionViT,
        dict(num_classes=10, dim=(32, 64), depth=(1, 1), window_size=7,
             local_patch_size=4, use_peg=True),
        112,
    ),
    "cvt": (
        CvT,
        dict(num_classes=10, s1_emb_dim=16, s1_depth=1, s2_emb_dim=32, s2_depth=1,
             s3_emb_dim=32, s3_depth=1, s3_heads=2),
        32,
    ),
    "levit": (
        LeViT,
        dict(image_size=64, num_classes=10, stages=3, dim=(32, 32, 32), depth=1,
             heads=(1, 2, 4), mlp_mult=2, dim_key=16, dim_value=16),
        64,
    ),
    "pit": (
        PiT,
        dict(image_size=64, patch_size=8, num_classes=10, dim=32, depth=(1, 1),
             heads=2, mlp_dim=64, dim_head=16),
        64,
    ),
    "t2t": (
        T2TViT,
        dict(image_size=64, num_classes=10, dim=64, depth=1, heads=2, mlp_dim=128,
             t2t_layers=((7, 4), (3, 2), (3, 2))),
        64,
    ),
    # The dependency-injected shell (reference efficient.py:15-59, fixed —
    # bug register #1). Any encoder callable plugs in; the smoke config
    # injects a small vanilla Transformer.
    "efficient": (
        EfficientViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64,
             transformer=_Transformer(dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)),
        64,
    ),
}


# Reference-scale presets live in a submodule (imported last: presets pulls
# the constructors from this package, which is fully defined by here).
from vitax.models.presets import REFERENCE_PRESETS, create  # noqa: E402

__all__ += ["REFERENCE_PRESETS", "create"]

"""Reference-scale presets: every family at the hyperparameters the
upstream README documents (reference README.md:11-40 and the per-model
blocks; same numbers as docs/MODELS.md), importable as code.

``MODEL_REGISTRY`` carries tiny smoke shapes for the test suite; these are
the real constructions a migrating `vit-flax` user starts from:

    from vitax.models.presets import create
    model, image_size = create("cait")
    variables = jax.jit(lambda: model.init({"params": key}, img))()

Every preset is validated by tracing init+apply with ``jax.eval_shape``
(tests/test_api_surface.py) so the documented constructors can never rot.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from vitax.models import (
    CaiT,
    CrossFormer,
    CrossViT,
    CvT,
    DeepViT,
    EfficientViT,
    LeViT,
    NesT,
    ParallelViT,
    PatchMergerViT,
    PiT,
    RegionViT,
    ScalableViT,
    SimpleViT,
    T2TViT,
    TwinsSVT,
    ViT,
    ViTSmallDatasets,
)
from vitax.nn.blocks import Transformer

# name -> (constructor, reference-scale kwargs, image size)
# Citations: the reference README block for each family; docs/MODELS.md
# carries the same numbers with per-model commentary.
REFERENCE_PRESETS: Dict[str, Tuple[Callable[..., Any], Dict[str, Any], int]] = {
    # reference README.md:11-26
    "vit": (ViT, dict(
        image_size=256, patch_size=32, num_classes=1000,
        dim=1024, depth=6, heads=16, mlp_dim=2048,
        dropout=0.1, emb_dropout=0.1,
    ), 256),
    "simple_vit": (SimpleViT, dict(
        image_size=256, patch_size=32, num_classes=1000,
        dim=1024, depth=6, heads=16, mlp_dim=2048,
    ), 256),
    "deepvit": (DeepViT, dict(
        image_size=256, patch_size=32, num_classes=1000,
        dim=1024, depth=6, heads=16, mlp_dim=2048,
        dropout=0.1, emb_dropout=0.1,
    ), 256),
    "cait": (CaiT, dict(
        image_size=256, patch_size=32, num_classes=1000,
        dim=1024, depth=12, cls_depth=2, heads=16, mlp_dim=2048,
        dropout=0.1, emb_dropout=0.1, layer_dropout=0.05,
    ), 256),
    "parallel_vit": (ParallelViT, dict(
        image_size=256, patch_size=16, num_classes=1000,
        dim=1024, depth=6, heads=8, mlp_dim=2048,
        num_parallel_branches=2, dropout=0.1, emb_dropout=0.1,
    ), 256),
    "patch_merger_vit": (PatchMergerViT, dict(
        image_size=256, patch_size=16, num_classes=1000,
        dim=1024, depth=12, heads=8, mlp_dim=2048,
        patch_merge_layer=6, patch_merge_num_tokens=8,
        dropout=0.1, emb_dropout=0.1,
    ), 256),
    "vit_small_datasets": (ViTSmallDatasets, dict(
        image_size=256, patch_size=16, num_classes=1000,
        dim=1024, depth=6, heads=16, mlp_dim=2048,
        dropout=0.1, emb_dropout=0.1,
    ), 256),
    "cross_vit": (CrossViT, dict(
        image_size=256, num_classes=1000, depth=4,
        sm_dim=192, sm_patch_size=16, sm_enc_depth=2, sm_enc_heads=8,
        sm_enc_mlp_dim=2048,
        lg_dim=384, lg_patch_size=64, lg_enc_depth=3, lg_enc_heads=8,
        lg_enc_mlp_dim=2048,
        cross_attn_depth=2, cross_attn_heads=8,
        dropout=0.1, emb_dropout=0.1,
    ), 256),
    # reference README.md:226 (CvT block; s3_heads=4 per the README example —
    # the reference file default is 6, cvt.py:161, a documented quirk)
    "cvt": (CvT, dict(
        num_classes=1000, s1_emb_dim=64, s2_emb_dim=192, s3_emb_dim=384,
        s1_depth=1, s2_depth=2, s3_depth=10, s3_heads=4,
    ), 224),
    "levit": (LeViT, dict(
        image_size=224, num_classes=1000, stages=3,
        dim=(256, 384, 512), depth=4, heads=(4, 6, 8),
        mlp_mult=2, dropout=0.1,
    ), 224),
    "nest": (NesT, dict(
        image_size=224, patch_size=4, num_classes=1000,
        dim=96, heads=3, num_hierarchies=3, block_repeats=(2, 2, 8),
    ), 224),
    "pit": (PiT, dict(
        image_size=224, patch_size=14, num_classes=1000,
        dim=256, depth=(3, 3, 3), heads=16, mlp_dim=2048,
        dropout=0.1, emb_dropout=0.1,
    ), 224),
    "t2t": (T2TViT, dict(
        image_size=224, num_classes=1000, dim=512,
        depth=5, heads=8, mlp_dim=512,
        t2t_layers=((7, 4), (3, 2), (3, 2)),
    ), 224),
    "twins_svt": (TwinsSVT, dict(
        num_classes=1000,
        s1_emb_dim=64, s1_patch_size=4, s1_local_patch_size=7,
        s1_global_k=7, s1_depth=1,
        s2_emb_dim=128, s2_patch_size=2, s2_local_patch_size=7,
        s2_global_k=7, s2_depth=1,
        s3_emb_dim=256, s3_patch_size=2, s3_local_patch_size=7,
        s3_global_k=7, s3_depth=5,
        s4_emb_dim=512, s4_patch_size=2, s4_local_patch_size=7,
        s4_global_k=7, s4_depth=4,
        peg_kernel_size=3, dropout=0.0,
    ), 224),
    "scalable_vit": (ScalableViT, dict(
        num_classes=1000, dim=64,
        heads=(2, 4, 8, 16), depth=(2, 2, 20, 2),
        ssa_dim_key=(40, 40, 40, 32), reduction_factor=(8, 4, 2, 1),
        window_size=(64, 32, None, None), dropout=0.1,
    ), 256),
    "region_vit": (RegionViT, dict(
        dim=(64, 128, 256, 512), depth=(2, 2, 8, 2),
        window_size=7, num_classes=1000,
        tokenize_local_3_conv=False, use_peg=False,
    ), 224),
    "crossformer": (CrossFormer, dict(
        num_classes=1000, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2),
        global_window_size=(8, 4, 2, 1), local_window_size=7,
    ), 224),
    # the injected-encoder shell (reference efficient.py:15, fixed here)
    "efficient": (EfficientViT, dict(
        image_size=256, patch_size=32, num_classes=1000, dim=512,
        transformer=Transformer(dim=512, depth=6, heads=8, dim_head=64,
                                mlp_dim=2048),
    ), 256),
}


def create(name: str, **overrides: Any) -> Tuple[Any, int]:
    """Construct a family at its reference-scale preset.

    Returns ``(model, image_size)``. ``overrides`` update the preset kwargs
    (e.g. ``create("vit", dtype=jnp.bfloat16, num_classes=10)``).
    """
    try:
        ctor, kwargs, image_size = REFERENCE_PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: "
            f"{sorted(REFERENCE_PRESETS)}"
        ) from None
    return ctor(**{**kwargs, **overrides}), image_size

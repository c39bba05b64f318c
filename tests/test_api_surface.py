"""API-surface parity: every model constructs with its reference file's
exact ``__main__`` kwargs (the documented public API a reference user
would carry over) and the forward has the right logit shape — checked via
``jax.eval_shape`` (abstract, no FLOPs, full-size configs are fine).

Reference configs: each file's ``if __name__ == '__main__'`` block, e.g.
vit.py:173-190, twins_svt.py:324-363, cait.py / crossformer.py ditto.
"""

import jax
import jax.numpy as jnp
import pytest

from vitax import models as M

CASES = [
    ("vit", M.ViT,
     dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6,
          heads=16, mlp_dim=2048, dropout=0.1, emb_dropout=0.1), 256),
    ("simple_vit", M.SimpleViT,
     dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6,
          heads=16, mlp_dim=2048), 256),
    ("deepvit", M.DeepViT,
     dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6,
          heads=16, mlp_dim=2048, dropout=0.1, emb_dropout=0.1), 256),
    ("cait", M.CaiT,
     dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=12,
          cls_depth=2, heads=16, mlp_dim=2048, dropout=0.1, emb_dropout=0.1,
          layer_dropout=0.05), 256),
    ("parallel_vit", M.ParallelViT,
     dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6,
          heads=8, mlp_dim=2048, num_parallel_branches=2, dropout=0.1,
          emb_dropout=0.1), 256),
    ("patch_merger", M.PatchMergerViT,
     dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=12,
          heads=8, patch_merge_layer=6, patch_merge_num_tokens=8, mlp_dim=2048,
          dropout=0.1, emb_dropout=0.1), 256),
    ("vit_small_datasets", M.ViTSmallDatasets,
     dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6,
          heads=16, mlp_dim=2048, dropout=0.1, emb_dropout=0.1), 256),
    ("cross_vit", M.CrossViT,
     dict(image_size=256, num_classes=1000, depth=4, sm_dim=192,
          sm_patch_size=16, sm_enc_depth=2, sm_enc_heads=8, sm_enc_mlp_dim=2048,
          lg_dim=384, lg_patch_size=64, lg_enc_depth=3, lg_enc_heads=8,
          lg_enc_mlp_dim=2048, cross_attn_depth=2, cross_attn_heads=8,
          dropout=0.1, emb_dropout=0.1), 256),
    ("cvt", M.CvT, dict(num_classes=1000, s1_emb_dim=64, s1_emb_kernel=7,
                        s1_emb_stride=4, s1_proj_kernel=3, s1_kv_proj_stride=2,
                        s1_heads=1, s1_depth=1, s1_mlp_mult=4, s2_emb_dim=192,
                        s2_emb_kernel=3, s2_emb_stride=2, s2_proj_kernel=3,
                        s2_kv_proj_stride=2, s2_heads=3, s2_depth=2,
                        s2_mlp_mult=4, s3_emb_dim=384, s3_emb_kernel=3,
                        s3_emb_stride=2, s3_proj_kernel=3, s3_kv_proj_stride=2,
                        s3_heads=6, s3_depth=10, s3_mlp_mult=4, dropout=0.0), 224),
    ("levit", M.LeViT,
     dict(image_size=224, num_classes=1000, stages=3, dim=(256, 384, 512),
          depth=4, heads=(4, 6, 8), mlp_mult=2, dropout=0.1), 224),
    ("nest", M.NesT,
     dict(image_size=224, patch_size=4, dim=96, heads=3, num_hierarchies=3,
          block_repeats=(2, 2, 8), num_classes=1000), 224),
    ("pit", M.PiT,
     dict(image_size=224, patch_size=14, dim=256, num_classes=1000,
          depth=(3, 3, 3), heads=16, mlp_dim=2048, dropout=0.1,
          emb_dropout=0.1), 224),
    ("t2t", M.T2TViT,
     dict(dim=512, image_size=224, depth=5, heads=8, mlp_dim=512,
          num_classes=1000, t2t_layers=((7, 4), (3, 2), (3, 2))), 224),
    ("twins_svt", M.TwinsSVT,
     dict(num_classes=1000, s1_emb_dim=64, s1_patch_size=4,
          s1_local_patch_size=7, s1_global_k=7, s1_depth=1, s2_emb_dim=128,
          s2_patch_size=2, s2_local_patch_size=7, s2_global_k=7, s2_depth=1,
          s3_emb_dim=256, s3_patch_size=2, s3_local_patch_size=7,
          s3_global_k=7, s3_depth=5, s4_emb_dim=512, s4_patch_size=2,
          s4_local_patch_size=7, s4_global_k=7, s4_depth=4,
          peg_kernel_size=3, dropout=0.0), 224),
    ("scalable_vit", M.ScalableViT,
     dict(num_classes=1000, dim=64, heads=(2, 4, 8, 16), depth=(2, 2, 20, 2),
          ssa_dim_key=(40, 40, 40, 32), reduction_factor=(8, 4, 2, 1),
          window_size=(64, 32, None, None), dropout=0.1), 256),
    ("region_vit", M.RegionViT,
     dict(dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), window_size=7,
          num_classes=1000, tokenize_local_3_conv=False, use_peg=False), 224),
    ("crossformer", M.CrossFormer,
     dict(num_classes=1000, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2),
          global_window_size=(8, 4, 2, 1), local_window_size=7,
          cross_embed_kernel_sizes=((4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
          cross_embed_strides=(4, 2, 2, 2), attn_dropout=0.0, ff_dropout=0.0),
     224),
]


@pytest.mark.parametrize("name,cls,cfg,size", CASES, ids=[c[0] for c in CASES])
def test_reference_main_config_constructs_and_shapes(name, cls, cfg, size):
    model = cls(**cfg)  # the reference's exact public kwargs
    img = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)

    def init_and_apply(img):
        variables = model.init({"params": jax.random.PRNGKey(0)}, img)
        return model.apply(variables, img)

    out = jax.eval_shape(init_and_apply, img)
    if isinstance(out, tuple):  # LeViT optional distill head
        out = out[0]
    assert out.shape == (2, 1000), (name, out.shape)


def test_efficient_shell_injects_any_encoder():
    from vitax.nn.blocks import Transformer

    model = M.EfficientViT(
        image_size=256, patch_size=32, num_classes=1000, dim=512,
        transformer=Transformer(dim=512, depth=2, heads=8, dim_head=64,
                                mlp_dim=1024),
    )
    img = jax.ShapeDtypeStruct((2, 256, 256, 3), jnp.float32)
    out = jax.eval_shape(
        lambda img: model.apply(
            model.init({"params": jax.random.PRNGKey(0)}, img), img
        ),
        img,
    )
    assert out.shape == (2, 1000)


# --- reference-scale presets (models/presets.py = docs/MODELS.md as code) ---

def test_presets_cover_all_registry_families():
    from vitax.models import MODEL_REGISTRY, REFERENCE_PRESETS

    assert set(REFERENCE_PRESETS) == set(MODEL_REGISTRY)


@pytest.mark.parametrize("name", sorted(M.REFERENCE_PRESETS))
def test_preset_constructs_and_traces(name):
    """Every preset builds its documented reference-scale model and the
    abstract forward yields (1, num_classes) — eval_shape only, no FLOPs."""
    model, size = M.create(name)
    img = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)

    def init_and_apply(img):
        variables = model.init({"params": jax.random.PRNGKey(0)}, img)
        return model.apply(variables, img)

    out = jax.eval_shape(init_and_apply, img)
    if isinstance(out, tuple):  # LeViT optional distill head
        out = out[0]
    assert out.shape == (1, 1000), (name, out.shape)


def test_preset_create_overrides():
    model, size = M.create("vit", num_classes=10, depth=2)
    assert model.num_classes == 10 and model.depth == 2 and size == 256
    with pytest.raises(KeyError):
        M.create("nope")

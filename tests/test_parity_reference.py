"""Logit parity of ``vitax.models.ViT`` against the float64 host forward
``vitax.utils.parity.fp64_vit_forward`` on the model's own seeded weights.

float32 runs must match to float32 rounding; bf16, mixed precision and
int8 runs within the limits ``chip_smoke.py`` holds the card to (PERF.md,
"Tolerances"). The perturbation cases move one parameter at a time and
require the model and the reference to move the same way, so every leaf of
the parameter tree is read, and read alike, by both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitax.models import ViT
from vitax.utils.parity import fp64_vit_forward, max_logit_err

BASE = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=3,
            heads=4, mlp_dim=128, dim_head=16)


def _setup(cfg, batch=2, seed=0, **model_kw):
    model = ViT(**cfg, **model_kw)
    s = cfg["image_size"]
    img = jax.random.normal(jax.random.PRNGKey(seed), (batch, s, s, 3))
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(seed + 1)}, img[:1])
    return model, variables, img


def _fp64(cfg, variables, img, **kw):
    return fp64_vit_forward(
        variables, np.asarray(img, np.float64), patch_size=cfg["patch_size"],
        heads=cfg["heads"], dim_head=cfg["dim_head"], **kw,
    )


def _rel_err(got, ref):
    return max_logit_err(got, ref) / float(np.abs(ref).max())


@pytest.mark.parametrize("cfg", [
    BASE,
    dict(BASE, depth=1),
    dict(BASE, depth=6, heads=2, dim_head=32),
    dict(BASE, pool="mean"),
    dict(BASE, activation="gelu_exact", norm_eps=1e-12),
    dict(BASE, image_size=48, patch_size=16, dim=96, heads=3, dim_head=32, num_classes=7),
], ids=["base", "depth1", "depth6_wide_heads", "mean_pool", "gelu_exact", "patch16"])
def test_vit_fp32_matches_fp64(cfg):
    cfg = dict(cfg)
    kw = {k: cfg.pop(k) for k in ("pool", "activation", "norm_eps") if k in cfg}
    model, variables, img = _setup(cfg, **kw)
    got = jax.jit(model.apply)(variables, img)
    ref = _fp64(cfg, variables, img, pool=kw.get("pool", "cls"),
                activation=kw.get("activation", "gelu"), eps=kw.get("norm_eps", 1e-6))
    assert _rel_err(got, ref) < 1e-5


@pytest.mark.parametrize("batch,seed", [(2, 0), (8, 3), (1, 5)])
def test_vit_bf16_within_tolerance_of_fp64(batch, seed):
    model, variables, img = _setup(BASE, batch=batch, seed=seed, dtype=jnp.bfloat16)
    got = np.asarray(jax.jit(model.apply)(variables, img.astype(jnp.bfloat16)), np.float32)
    assert _rel_err(got, _fp64(BASE, variables, img)) < 5e-2


def test_vit_mixed_precision_between_fp32_and_bf16():
    """fp32 residual stream + bf16 products: within the bf16 limit and no
    further from the truth than the all-bf16 run."""
    model, variables, img = _setup(BASE, batch=4, dtype=jnp.bfloat16, residual_dtype=jnp.float32)
    ref = _fp64(BASE, variables, img)
    mixed = np.asarray(jax.jit(model.apply)(variables, img), np.float32)
    bf16 = np.asarray(
        jax.jit(ViT(**BASE, dtype=jnp.bfloat16).apply)(variables, img.astype(jnp.bfloat16)),
        np.float32,
    )
    assert _rel_err(mixed, ref) < 5e-2
    assert _rel_err(mixed, ref) <= _rel_err(bf16, ref)


def test_fp64_forward_takes_variables_or_params():
    _, variables, img = _setup(BASE)
    np.testing.assert_array_equal(
        _fp64(BASE, variables, img), _fp64(BASE, variables["params"], img)
    )


def test_int8_weight_only_within_tolerance_of_fp64():
    from vitax.utils.quantize import quantize_vit, vit_apply_w8a8

    model, variables, img = _setup(BASE, batch=4)
    got = jax.jit(lambda v, x: vit_apply_w8a8(model, v, x, mode="w8"))(
        quantize_vit(variables), img
    )
    assert _rel_err(got, _fp64(BASE, variables, img)) < 5e-2


def test_inference_pipeline_matches_fp64_on_preprocessed_input():
    from vitax.pipeline import InferencePipeline, preprocess

    model, variables, _ = _setup(BASE)
    raw = np.random.default_rng(0).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    pipe = InferencePipeline(model, variables, image_size=32, batch_size=4, dtype=jnp.float32)
    x = preprocess(raw, image_size=32, dtype=jnp.float32)
    assert _rel_err(pipe(raw), _fp64(BASE, variables, x)) < 1e-5


LEAVES = [
    ("patch_embed", "proj", "kernel"), ("patch_embed", "proj", "bias"),
    ("cls",), ("pos_embedding",),
    ("encoder", "blocks", "attn", "norm_scale"), ("encoder", "blocks", "attn", "norm_bias"),
    ("encoder", "blocks", "attn", "qkv_kernel"), ("encoder", "blocks", "attn", "out_kernel"),
    ("encoder", "blocks", "attn", "out_bias"),
    ("encoder", "blocks", "ff", "ln_scale"), ("encoder", "blocks", "ff", "ln_bias"),
    ("encoder", "blocks", "ff", "w1"), ("encoder", "blocks", "ff", "b1"),
    ("encoder", "blocks", "ff", "w2"), ("encoder", "blocks", "ff", "b2"),
    ("head_norm", "scale"), ("head_norm", "bias"),
    ("head", "kernel"), ("head", "bias"),
]


@functools.lru_cache(maxsize=1)
def _perturbation_setup():
    model, variables, img = _setup(BASE, batch=2, seed=11)
    return model, jax.jit(model.apply), variables, img


@pytest.mark.parametrize("path", LEAVES, ids=["/".join(p) for p in LEAVES])
def test_perturbation_parity(path):
    _, apply, variables, img = _perturbation_setup()

    def bumped(tree):
        tree = jax.tree.map(lambda a: a, tree)  # fresh containers
        node = tree["params"]
        for key in path[:-1]:
            node = node[key]
        leaf = node[path[-1]]
        noise = jax.random.normal(jax.random.PRNGKey(len(path)), leaf.shape)
        node[path[-1]] = leaf + 0.2 * noise
        return tree

    moved = bumped(variables)
    d_model = np.asarray(apply(moved, img)) - np.asarray(apply(variables, img))
    d_ref = _fp64(BASE, moved, img) - _fp64(BASE, variables, img)
    assert np.abs(d_ref).max() > 1e-4, "perturbation did not reach the logits"
    np.testing.assert_allclose(d_model, d_ref, atol=1e-5 * float(np.abs(d_ref).max()) + 1e-6, rtol=1e-4)

"""Per-model forward smoke tests on tiny configs (the build's replacement
for the reference's ``__main__`` blocks, SURVEY.md §4): construct, init,
apply, assert logits shape and finiteness, and determinism at inference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitax.models import MODEL_REGISTRY


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_forward_shape_and_determinism(name):
    cls, cfg, image_size = MODEL_REGISTRY[name]
    model = cls(**cfg)
    img = jax.random.normal(jax.random.PRNGKey(0), (2, image_size, image_size, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    apply = jax.jit(lambda v, x: model.apply(v, x))
    out = apply(variables, img)
    num_classes = cfg["num_classes"]
    assert out.shape == (2, num_classes), f"{name}: {out.shape}"
    assert bool(jnp.isfinite(out).all()), f"{name}: non-finite logits"
    # inference is deterministic (no live dropout — reference bug #10 fixed)
    out2 = apply(variables, img)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))


@pytest.mark.parametrize("name", ["vit", "cait"])
def test_train_mode_dropout_is_stochastic(name):
    cls, cfg, image_size = MODEL_REGISTRY[name]
    cfg = dict(cfg, dropout=0.5, emb_dropout=0.5)
    model = cls(**cfg)
    img = jax.random.normal(jax.random.PRNGKey(0), (2, image_size, image_size, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    o1 = model.apply(variables, img, True, rngs={"dropout": jax.random.PRNGKey(2)})
    o2 = model.apply(variables, img, True, rngs={"dropout": jax.random.PRNGKey(3)})
    assert not np.allclose(np.asarray(o1), np.asarray(o2))


def test_efficient_shell_with_injected_encoder():
    from vitax.models import EfficientViT
    from vitax.nn.blocks import Transformer

    encoder = Transformer(dim=64, depth=1, heads=4, dim_head=16, mlp_dim=128)
    model = EfficientViT(
        image_size=64, patch_size=16, num_classes=10, dim=64, transformer=encoder
    )
    img = jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    out = model.apply(variables, img)
    assert out.shape == (1, 10)


def test_standalone_patch_merger():
    from vitax.models import PatchMerger

    merger = PatchMerger(dim=32, num_tokens_out=8)
    feats = jax.random.normal(jax.random.PRNGKey(0), (4, 64, 32))
    params = merger.init({"params": jax.random.PRNGKey(1)}, feats)
    out = merger.apply(params, feats)
    assert out.shape == (4, 8, 32)


def test_simple_vit_channels_first_adapter():
    from vitax.models import SimpleViT

    model = SimpleViT(
        image_size=32, patch_size=8, num_classes=10, dim=64, depth=1, heads=4,
        mlp_dim=128, channels_first=True,
    )
    img = jax.random.normal(jax.random.PRNGKey(0), (1, 3, 32, 32))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    out = model.apply(variables, img)
    assert out.shape == (1, 10)

"""HF/torch ViT checkpoint interop: imported weights must reproduce the
Hugging Face torch implementation's logits (the "switch ecosystems, keep
your checkpoint" path — vitax/utils/interop.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")


def _hf_model(num_labels=10):
    from transformers import ViTConfig, ViTForImageClassification

    cfg = ViTConfig(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=8,
        num_labels=num_labels,
    )
    torch.manual_seed(0)
    m = ViTForImageClassification(cfg)
    m.eval()
    return m


def test_hf_vit_logit_parity():
    from vitax.utils.interop import vit_from_hf

    hf = _hf_model()
    model, variables = vit_from_hf(hf)  # fp32 for strict comparison

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)

    with torch.no_grad():
        ref = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits.numpy()

    got = np.asarray(model.apply(variables, x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_hf_vit_config_mapping():
    from vitax.utils.interop import hf_vit_config

    hf = _hf_model(num_labels=7)
    cfg = hf_vit_config(hf.config)
    assert cfg["dim"] == 64 and cfg["depth"] == 3 and cfg["heads"] == 4
    assert cfg["dim_head"] == 16 and cfg["num_classes"] == 7
    assert cfg["qkv_bias"] is True and cfg["activation"] == "gelu_exact"
    assert cfg["norm_eps"] == hf.config.layer_norm_eps


def test_hf_import_runs_on_kernel_path():
    """The imported tree must also apply under bf16 (the serving config) —
    shapes/layout identical, only dtypes differ."""
    import jax.numpy as jnp

    from vitax.utils.interop import vit_from_hf

    hf = _hf_model()
    model, variables = vit_from_hf(hf, dtype=jnp.bfloat16)
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    out = np.asarray(model.apply(variables, jnp.asarray(x, jnp.bfloat16)))
    assert out.shape == (2, 10)
    assert np.isfinite(out).all()


def test_bare_vitmodel_import_applies():
    """A bare ViTModel (no classifier) imports with a zero-initialized head
    at the config's num_labels width — apply works, logits are zeros."""
    from transformers import ViTConfig, ViTModel

    from vitax.utils.interop import vit_from_hf

    cfg = ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=8,
    )
    torch.manual_seed(0)
    model, variables = vit_from_hf(ViTModel(cfg))
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    out = np.asarray(model.apply(variables, x))
    assert out.shape == (2, cfg.num_labels)
    np.testing.assert_array_equal(out, 0.0)


def test_hf_import_quantizes():
    """The HF-imported (flax-layout, qkv-bias) tree quantizes and the
    quantized forward tracks the float forward."""
    import jax

    from vitax.utils.interop import vit_from_hf
    from vitax.utils.quantize import quantize_vit, vit_apply_w8a8

    hf = _hf_model()
    model, variables = vit_from_hf(hf)
    x = np.random.default_rng(2).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)(variables, x))

    qvars = quantize_vit(variables)
    got = np.asarray(jax.jit(lambda v, i: vit_apply_w8a8(model, v, i))(qvars, x))
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() / scale < 0.05


def test_export_roundtrip_state_dict():
    """import -> export is the identity on an HF checkpoint (every tensor
    bit-equal), so migration works in both directions."""
    from transformers import ViTForImageClassification

    from vitax.utils.interop import export_vit_to_hf, vit_from_hf

    hf_a = _hf_model()
    _, variables = vit_from_hf(hf_a)
    torch.manual_seed(123)
    hf_b = ViTForImageClassification(hf_a.config)  # different random init
    export_vit_to_hf(variables, hf_b)

    sd_a, sd_b = hf_a.state_dict(), hf_b.state_dict()
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        np.testing.assert_array_equal(
            sd_a[k].numpy(), sd_b[k].numpy(), err_msg=k
        )


def test_export_native_vit_serves_from_torch():
    """A natively-initialized (raw-param, biasless-qkv) ViT exports into an
    HF model and the torch forward reproduces our logits."""
    import jax
    import jax.numpy as jnp
    from transformers import ViTConfig, ViTForImageClassification

    from vitax.models import ViT
    from vitax.utils.interop import export_vit_to_hf

    model = ViT(
        image_size=32, patch_size=8, num_classes=10, dim=64, depth=3,
        heads=4, dim_head=16, mlp_dim=128,
        activation="gelu_exact", norm_eps=1e-6,  # HF's erf GELU / eps
    )
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 32, 32, 3))
    )
    cfg = ViTConfig(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=8,
        num_labels=10, layer_norm_eps=1e-6,
    )
    hf = ViTForImageClassification(cfg)
    export_vit_to_hf(variables, hf)
    hf.eval()

    x = np.random.default_rng(4).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ours = np.asarray(jax.jit(model.apply)(variables, x))
    with torch.no_grad():
        theirs = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)

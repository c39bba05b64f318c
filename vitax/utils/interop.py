"""Ecosystem interop: import Hugging Face / torch ViT checkpoints.

The reference framework lives in its own flax island; a production user
switching from the torch ecosystem arrives with HF ``ViTModel`` /
``ViTForImageClassification`` (or timm ViT — same tensor layout)
checkpoints. This maps such a ``state_dict`` onto ``vitax.models.ViT``'s
scanned raw-parameter layout. Logit parity vs the HF torch implementation is asserted in
``tests/test_interop.py``.

Architecture correspondence (HF ViT == Dosovitskiy ViT == our ``ViT`` with
the interop knobs): qkv projections carry biases (``qkv_bias=True`` — this
routes attention onto the flax+flash path; the fused block kernel's qkv
GEMM has no bias input), GELU is the erf form (``activation="gelu_exact"``),
and LayerNorm eps comes from the HF config (1e-12 default). HF applies the
final LayerNorm to the whole sequence then classifies the CLS token; ours
pools CLS then LayerNorms — identical math, LN is per-token.

Layout notes: torch ``Linear.weight`` is ``(out, in)`` (transposed here);
the patch-embed conv ``(dim, c, p, p)`` flattens to our patchify order
``(p1, p2, c)``; q/k/v concatenate into the fused ``to_qkv`` kernel in
head-major order (both sides reshape the inner axis as ``(heads, dim_head)``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def hf_vit_config(hf_config) -> Dict[str, Any]:
    """Our ``ViT`` constructor kwargs for an HF ``ViTConfig``."""
    if hf_config.hidden_size % hf_config.num_attention_heads:
        raise ValueError("hidden_size must be divisible by num_attention_heads")
    return dict(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        num_classes=getattr(hf_config, "num_labels", 0) or 0,
        dim=hf_config.hidden_size,
        depth=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        dim_head=hf_config.hidden_size // hf_config.num_attention_heads,
        mlp_dim=hf_config.intermediate_size,
        pool="cls",
        qkv_bias=getattr(hf_config, "qkv_bias", True),
        activation="gelu_exact" if hf_config.hidden_act == "gelu" else hf_config.hidden_act,
        norm_eps=hf_config.layer_norm_eps,
    )


def import_hf_vit_params(state_dict: Dict[str, Any], depth: int,
                         patch_size: int,
                         num_classes: Optional[int] = None) -> Dict[str, Any]:
    """Map an HF ViT ``state_dict`` onto our ``ViT`` variables.

    Accepts both ``ViTForImageClassification`` (keys under ``vit.`` plus
    ``classifier.*``) and a bare ``ViTModel`` (no prefix, no head): the
    head is then zero-initialized at ``num_classes`` width so the tree
    matches the model built from ``hf_vit_config`` (whose ``num_classes``
    comes from the HF config's ``num_labels``, default 2) — apply works
    and returns all-zero logits until the head is trained.
    """
    sd = {k: _np(v) for k, v in state_dict.items()}
    prefix = "vit." if any(k.startswith("vit.") for k in sd) else ""

    def g(key):
        return sd[prefix + key]

    emb = "embeddings."
    enc = "encoder.layer."

    conv_w = g(emb + "patch_embeddings.projection.weight")  # (dim, c, p, p)
    dim = conv_w.shape[0]
    proj_kernel = conv_w.transpose(2, 3, 1, 0).reshape(patch_size * patch_size * conv_w.shape[1], dim)

    def stack(fn):
        return np.stack([fn(f"{enc}{i}.") for i in range(depth)])

    def sd_t(p):  # torch Linear weight (out, in) -> flax kernel (in, out)
        return g(p).T

    params: Dict[str, Any] = {
        "cls": g(emb + "cls_token"),
        "pos_embedding": g(emb + "position_embeddings"),
        "patch_embed": {"proj": {
            "kernel": proj_kernel,
            "bias": g(emb + "patch_embeddings.projection.bias"),
        }},
        "encoder": {"blocks": {
            "attn": {
                "norm": {
                    "scale": stack(lambda l: g(l + "layernorm_before.weight")),
                    "bias": stack(lambda l: g(l + "layernorm_before.bias")),
                },
                "to_qkv": {
                    "kernel": stack(lambda l: np.concatenate([
                        sd_t(l + "attention.attention.query.weight"),
                        sd_t(l + "attention.attention.key.weight"),
                        sd_t(l + "attention.attention.value.weight"),
                    ], axis=1)),
                    "bias": stack(lambda l: np.concatenate([
                        g(l + "attention.attention.query.bias"),
                        g(l + "attention.attention.key.bias"),
                        g(l + "attention.attention.value.bias"),
                    ])),
                },
                "to_out": {
                    "kernel": stack(lambda l: sd_t(l + "attention.output.dense.weight")),
                    "bias": stack(lambda l: g(l + "attention.output.dense.bias")),
                },
            },
            "ff": {
                "ln_scale": stack(lambda l: g(l + "layernorm_after.weight")),
                "ln_bias": stack(lambda l: g(l + "layernorm_after.bias")),
                "w1": stack(lambda l: sd_t(l + "intermediate.dense.weight")),
                "b1": stack(lambda l: g(l + "intermediate.dense.bias")),
                "w2": stack(lambda l: sd_t(l + "output.dense.weight")),
                "b2": stack(lambda l: g(l + "output.dense.bias")),
            },
        }},
        "head_norm": {
            "scale": g("layernorm.weight"),
            "bias": g("layernorm.bias"),
        },
    }
    if "classifier.weight" in sd:
        params["head"] = {
            "kernel": sd["classifier.weight"].T,
            "bias": sd.get("classifier.bias", np.zeros(sd["classifier.weight"].shape[0], np.float32)),
        }
    else:  # bare ViTModel: no head in the checkpoint — zero-init one
        # default matches hf_vit_config's num_classes for a default HF
        # config (num_labels=2), so the tree fits the model it documents
        width = 2 if num_classes is None else num_classes
        params["head"] = {
            "kernel": np.zeros((dim, width), np.float32),
            "bias": np.zeros((width,), np.float32),
        }
    return {"params": params}


def export_vit_to_hf(variables: Dict[str, Any], hf_model) -> None:
    """Inverse mapping: load this framework's ``ViT`` variables INTO an HF
    ``ViTForImageClassification`` (in place) — migration works in both
    directions, so checkpoints trained here serve from the torch ecosystem
    too. Exact inverse of ``import_hf_vit_params`` (same layout notes);
    round-trip and torch-logit parity asserted in ``tests/test_interop.py``.
    """
    import torch

    p = variables["params"]
    blocks = p["encoder"]["blocks"]
    attn, ff = blocks["attn"], blocks["ff"]
    # both param layouts: raw (qkv_kernel) and flax submodule (to_qkv)
    if "qkv_kernel" in attn:
        norm_s, norm_b = attn["norm_scale"], attn["norm_bias"]
        qkv_k = attn["qkv_kernel"]
        qkv_b = attn.get("qkv_bias")
        out_k, out_b = attn["out_kernel"], attn["out_bias"]
    else:
        norm_s, norm_b = attn["norm"]["scale"], attn["norm"]["bias"]
        qkv_k = attn["to_qkv"]["kernel"]
        qkv_b = attn["to_qkv"].get("bias")
        out_k, out_b = attn["to_out"]["kernel"], attn["to_out"]["bias"]

    cfg = hf_model.config
    dim = cfg.hidden_size
    ps = cfg.patch_size
    sd = {}
    emb = "vit.embeddings."
    enc = "vit.encoder.layer."
    sd[emb + "cls_token"] = np.asarray(p["cls"], np.float32)
    sd[emb + "position_embeddings"] = np.asarray(p["pos_embedding"], np.float32)
    proj = np.asarray(p["patch_embed"]["proj"]["kernel"], np.float32)
    c = proj.shape[0] // (ps * ps)
    sd[emb + "patch_embeddings.projection.weight"] = (
        proj.reshape(ps, ps, c, dim).transpose(3, 2, 0, 1)
    )
    sd[emb + "patch_embeddings.projection.bias"] = np.asarray(
        p["patch_embed"]["proj"]["bias"], np.float32
    )
    depth = np.asarray(qkv_k).shape[0]
    hd = np.asarray(qkv_k).shape[2] // 3
    for i in range(depth):
        l = f"{enc}{i}."
        sd[l + "layernorm_before.weight"] = np.asarray(norm_s[i], np.float32)
        sd[l + "layernorm_before.bias"] = np.asarray(norm_b[i], np.float32)
        qkv = np.asarray(qkv_k[i], np.float32)  # (dim, 3*hd)
        for j, name in enumerate(("query", "key", "value")):
            sd[l + f"attention.attention.{name}.weight"] = (
                qkv[:, j * hd : (j + 1) * hd].T
            )
            bias = (
                np.asarray(qkv_b[i], np.float32)[j * hd : (j + 1) * hd]
                if qkv_b is not None
                else np.zeros(hd, np.float32)
            )
            sd[l + f"attention.attention.{name}.bias"] = bias
        sd[l + "attention.output.dense.weight"] = np.asarray(out_k[i], np.float32).T
        sd[l + "attention.output.dense.bias"] = np.asarray(out_b[i], np.float32)
        sd[l + "layernorm_after.weight"] = np.asarray(ff["ln_scale"][i], np.float32)
        sd[l + "layernorm_after.bias"] = np.asarray(ff["ln_bias"][i], np.float32)
        sd[l + "intermediate.dense.weight"] = np.asarray(ff["w1"][i], np.float32).T
        sd[l + "intermediate.dense.bias"] = np.asarray(ff["b1"][i], np.float32)
        sd[l + "output.dense.weight"] = np.asarray(ff["w2"][i], np.float32).T
        sd[l + "output.dense.bias"] = np.asarray(ff["b2"][i], np.float32)
    sd["vit.layernorm.weight"] = np.asarray(p["head_norm"]["scale"], np.float32)
    sd["vit.layernorm.bias"] = np.asarray(p["head_norm"]["bias"], np.float32)
    sd["classifier.weight"] = np.asarray(p["head"]["kernel"], np.float32).T
    sd["classifier.bias"] = np.asarray(p["head"]["bias"], np.float32)

    hf_model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})


def vit_from_hf(hf_model, dtype=None, residual_dtype=None) -> Tuple[Any, Dict[str, Any]]:
    """One call: HF ``ViTForImageClassification`` -> (our ViT, variables).

    ``dtype=jnp.bfloat16`` runs the imported checkpoint in bf16; default
    keeps fp32 for strict parity checks.
    """
    from vitax.models import ViT

    cfg = hf_vit_config(hf_model.config)
    model = ViT(**cfg, dtype=dtype, residual_dtype=residual_dtype)
    variables = import_hf_vit_params(
        hf_model.state_dict(), depth=cfg["depth"],
        patch_size=cfg["patch_size"], num_classes=cfg["num_classes"],
    )
    return model, variables

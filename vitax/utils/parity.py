"""Ground-truth forward for parity checks.

``fp64_vit_forward`` evaluates ``vitax.models.ViT`` exactly (host NumPy,
float64) from the model's own parameter tree — an implementation of the
same function that shares no code with the framework, against which the
float32, bf16 and int8 forwards are compared. ``max_logit_err`` is the
distance the comparisons report.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def max_logit_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _gelu(x: np.ndarray, approximate: bool) -> np.ndarray:
    if approximate:
        return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))
    from scipy.special import erf

    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def fp64_vit_forward(
    params: Dict[str, Any],
    img: np.ndarray,
    *,
    patch_size: int,
    heads: int,
    dim_head: int = 64,
    pool: str = "cls",
    activation: str = "gelu",
    eps: float = 1e-6,
) -> np.ndarray:
    """Exact fp64 evaluation of ``vitax.models.ViT`` (deterministic mode).

    ``params`` is the model's tree (``variables["params"]`` or the whole
    ``variables``) in the raw-parameter layout of ``models/vit.py`` (no
    qkv bias), scanned or, for a depth-1 stack, unrolled. ``img`` is NHWC. Op for op: patchify
    in einops ``(p1 p2 c)`` order, patch projection, cls token and learned
    positions, ``depth`` pre-norm blocks (LayerNorm, fused qkv, softmax
    attention scaled by ``dim_head ** -0.5``, output projection, residual;
    LayerNorm, MLP with tanh-approximate GELU or erf GELU for
    ``activation="gelu_exact"``, residual), pooling, head LayerNorm and
    classifier.
    """
    p = params["params"] if "params" in params else params

    def a64(x):
        return np.asarray(x, np.float64)

    def ln(x, scale, bias):
        mean = x.mean(-1, keepdims=True)
        var = ((x - mean) ** 2).mean(-1, keepdims=True)
        return (x - mean) / np.sqrt(var + eps) * a64(scale) + a64(bias)

    b, ih, iw, c = img.shape
    ps = patch_size
    gh, gw = ih // ps, iw // ps
    x = np.asarray(img, np.float64).reshape(b, gh, ps, gw, ps, c)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, ps * ps * c)
    proj = p["patch_embed"]["proj"]
    x = x @ a64(proj["kernel"]) + a64(proj["bias"])
    dim = x.shape[-1]
    x = np.concatenate([np.broadcast_to(a64(p["cls"]), (b, 1, dim)), x], axis=1)
    x = x + a64(p["pos_embedding"])
    n = x.shape[1]

    enc = p["encoder"]
    if "blocks" in enc:  # scanned stack: leaves stacked on a depth axis
        attn, ff = enc["blocks"]["attn"], enc["blocks"]["ff"]
        depth = np.shape(attn["qkv_kernel"])[0]
        layers = [({k: v[i] for k, v in attn.items()}, {k: v[i] for k, v in ff.items()})
                  for i in range(depth)]
    else:  # unrolled stack (depth 1): attn_0 / ff_0
        layers = [(enc[f"attn_{i}"], enc[f"ff_{i}"])
                  for i in range(sum(k.startswith("attn_") for k in enc))]
    for layer_attn, layer_ff in layers:
        at = {k: a64(v) for k, v in layer_attn.items()}
        f = {k: a64(v) for k, v in layer_ff.items()}
        xn = ln(x, at["norm_scale"], at["norm_bias"])
        qkv = (xn @ at["qkv_kernel"]).reshape(b, n, 3, heads, dim_head)
        q, k, v = qkv.transpose(2, 0, 3, 1, 4)
        s = np.einsum("bhid,bhjd->bhij", q, k) * dim_head**-0.5
        e = np.exp(s - s.max(-1, keepdims=True))
        o = np.einsum("bhij,bhjd->bhid", e / e.sum(-1, keepdims=True), v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, heads * dim_head)
        x = x + o @ at["out_kernel"] + at["out_bias"]
        h = ln(x, f["ln_scale"], f["ln_bias"]) @ f["w1"] + f["b1"]
        h = _gelu(h, approximate=(activation == "gelu"))
        x = x + h @ f["w2"] + f["b2"]

    x = x[:, 0] if pool == "cls" else x.mean(axis=1)
    x = ln(x, p["head_norm"]["scale"], p["head_norm"]["bias"])
    return x @ a64(p["head"]["kernel"]) + a64(p["head"]["bias"])

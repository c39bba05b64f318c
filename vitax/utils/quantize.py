"""Post-training W8A8 quantization for the ViT encoder.

``quantize_vit(variables)`` converts a trained/imported ViT tree into int8
encoder GEMM weights (symmetric per-output-channel, see ``ops/quant.py``);
``vit_apply_w8a8(model, qvars, img)`` runs the forward with every encoder
GEMM — qkv projection, attention output projection, both MLP matmuls —
executed as int8 x int8 -> int32 ``dot_general``. LayerNorms, softmax,
residual stream, patch embed and the classifier head stay in the model's
float dtypes (patch embed + head carry <2% of weights and FLOPs; keeping
them float removes their quantization error for free).

Why this exists: the reference (conceptofmind/vit-flax) has no quantization
story. int8 x int8 -> int32 products run on the GPU's int8 tensor cores at
twice the bf16 rate, and int8 weights halve weight memory traffic — the
dominant cost at small serving batches.

Accuracy: dynamic per-token activation scales + per-channel weight scales
is the standard W8A8 recipe for ViTs; ``tests/test_quant.py`` bounds the
logit error vs the fp32 forward on random weights, and the divergence is
dominated by the activation rounding (weight rounding alone is ~1e-3).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from vitax._vendor import flax
from vitax import ops
from vitax.core.utils import pair
from vitax.nn.blocks import _activate, _layer_norm
from vitax.ops.quant import int8_matmul, quantize_channelwise, quantize_symmetric


def quantize_vit(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a ViT variables tree (scanned stacked layout) to W8.

    Returns ``{"params": <tree minus encoder GEMM kernels>, "quant":
    {name: {"w": int8 (depth, K, N), "s": fp32 (depth, 1, N)}}}``. Biases
    and norm parameters stay fp32 in ``params``. Accepts plain-dict or
    FrozenDict trees (checkpoints are often frozen) — the input is never
    mutated either way.
    """
    # unfreeze converts FrozenDict nodes to fresh dicts; the tree_map copy
    # covers the already-plain-dict case (unfreeze may return it as-is)
    params = jax.tree_util.tree_map(
        lambda x: x, flax.core.unfreeze(variables["params"])
    )
    blocks = params["encoder"]["blocks"]
    attn = blocks["attn"]
    if "to_qkv" in attn:
        # flax submodule layout — the qkv_bias=True path (HF/timm imports,
        # utils/interop.py). Normalize to the raw-param names so the
        # quantized encoder consumes one layout.
        blocks["attn"] = attn = {
            "norm_scale": attn["norm"]["scale"],
            "norm_bias": attn["norm"]["bias"],
            "qkv_kernel": attn["to_qkv"]["kernel"],
            **(
                {"qkv_bias": attn["to_qkv"]["bias"]}
                if "bias" in attn["to_qkv"]
                else {}
            ),
            "out_kernel": attn["to_out"]["kernel"],
            "out_bias": attn["to_out"]["bias"],
        }
    quant: Dict[str, Any] = {}
    for name, owner, key in [
        ("to_qkv", attn, "qkv_kernel"),
        ("to_out", attn, "out_kernel"),
        ("w1", blocks["ff"], "w1"),
        ("w2", blocks["ff"], "w2"),
    ]:
        w_i8, s = quantize_channelwise(owner[key])
        quant[name] = {"w": w_i8, "s": s}
        del owner[key]
    return {"params": params, "quant": quant}


QUANT_MODES = ("w8a8", "w8")


def resolve_quant_mode(batch: int) -> str:
    """Execution mode that ``mode="auto"`` picks for a serving batch size.

    Weight-only ``w8`` at every batch. At batch 1 the forward is bound by
    reading the weights, and keeping activations float costs nothing. At
    batch 128 on an H100, ``w8`` served more images per second than
    ``w8a8`` in each of three runs (PERF.md): the per-token activation
    quantization costs more than the int8 products save. The batch stays an
    argument because the choice is made per traced shape.
    """
    del batch
    return "w8"


def _check_mode(mode: str, batch: int) -> str:
    if mode == "auto":
        return resolve_quant_mode(batch)
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; use one of {QUANT_MODES} or 'auto'")
    return mode


def _make_qmm(mode: str, dtype):
    if mode == "w8a8":
        return int8_matmul

    def qmm(x, w_i8, w_scale, bias=None, out_dtype=None):
        w = (w_i8.astype(jnp.float32) * w_scale).astype(dtype)
        out = jnp.matmul(x.astype(dtype), w, preferred_element_type=jnp.float32)
        if bias is not None:
            out = out + bias.astype(jnp.float32)
        return out.astype(out_dtype or x.dtype)

    return qmm


def _encoder_w8a8(
    x: jax.Array,
    blocks: Dict[str, Any],
    q: Dict[str, Any],
    *,
    heads: int,
    dim_head: int,
    eps: float,
    dtype,
    activation: str,
    qmm,
) -> jax.Array:
    """The scanned quantized encoder shared by every vanilla-stack model
    (ViT, SimpleViT): pre-norm attention + MLP with all four GEMMs through
    ``qmm``, fp32 residual adds, per-layer weights sliced by ``lax.scan``.
    """
    scale = dim_head**-0.5
    attn_p, ff_p = blocks["attn"], blocks["ff"]

    def layer(x, wq):
        (norm_scale, norm_bias, qkv_b, out_b,
         ln1s, ln1b, b1, b2,
         qkv_w, qkv_s, out_w, out_s, w1_w, w1_s, w2_w, w2_s) = wq

        xn = _layer_norm(x, norm_scale, norm_bias, eps).astype(dtype)
        qkv = qmm(xn, qkv_w, qkv_s, bias=qkv_b, out_dtype=dtype)
        ctx = ops.qkv_attention(qkv, heads, scale=scale)
        out = qmm(ctx, out_w, out_s, bias=out_b, out_dtype=jnp.float32)
        x = (x.astype(jnp.float32) + out).astype(dtype)

        # --- MLP ---
        xn = _layer_norm(x, ln1s, ln1b, eps).astype(dtype)
        h = qmm(xn, w1_w, w1_s, bias=b1, out_dtype=jnp.float32)
        h = _activate(h, activation).astype(dtype)
        out = qmm(h, w2_w, w2_s, bias=b2, out_dtype=jnp.float32)
        x = (x.astype(jnp.float32) + out).astype(dtype)
        return x, ()

    xs = (
        attn_p["norm_scale"], attn_p["norm_bias"],
        attn_p.get("qkv_bias"), attn_p["out_bias"],
        ff_p["ln_scale"], ff_p["ln_bias"], ff_p["b1"], ff_p["b2"],
        q["to_qkv"]["w"], q["to_qkv"]["s"], q["to_out"]["w"], q["to_out"]["s"],
        q["w1"]["w"], q["w1"]["s"], q["w2"]["w"], q["w2"]["s"],
    )
    x, _ = jax.lax.scan(layer, x, xs)
    return x


def _patch_embed_gemm(p: Dict[str, Any], img: jax.Array, patch_size, dtype) -> jax.Array:
    """Patchify + patch-embed GEMM with fp32 epilogue (mirrors PatchEmbed).
    Shared by every quantized/QAT forward in this module — the embed/head
    wrapper exists ONCE so the three modes can't drift apart."""
    x = ops.patchify(img, *pair(patch_size))
    proj = p["patch_embed"]["proj"]
    return (
        jnp.matmul(
            x.astype(dtype), proj["kernel"].astype(dtype),
            preferred_element_type=jnp.float32,
        )
        + proj["bias"]
    ).astype(dtype)


def _vit_embed(model, p: Dict[str, Any], img: jax.Array, dtype) -> jax.Array:
    """ViT token stream: patch embed -> prepend cls -> learned positions."""
    x = _patch_embed_gemm(p, img, model.patch_size, dtype)
    b = x.shape[0]
    cls = jnp.broadcast_to(p["cls"].astype(dtype), (b, 1, model.dim))
    x = jnp.concatenate([cls, x], axis=1)
    return x + p["pos_embedding"].astype(dtype)


def _pool_and_head(p: Dict[str, Any], x: jax.Array, pool: str, eps: float) -> jax.Array:
    """cls-or-mean pool -> fp32 head LayerNorm -> classifier GEMM."""
    x = x[:, 0] if pool == "cls" else jnp.mean(x, axis=1)
    hn = p["head_norm"]
    x = _layer_norm(x.astype(jnp.float32), hn["scale"], hn.get("bias"), eps)
    head = p["head"]
    return jnp.matmul(x, head["kernel"], preferred_element_type=jnp.float32) + head["bias"]


def vit_apply_w8a8(
    model, qvars: Dict[str, Any], img: jax.Array, mode: str = "w8a8"
) -> jax.Array:
    """Quantized inference forward for ``vitax.models.ViT``.

    Mirrors ``ViT.__call__`` (deterministic path) with the four encoder
    GEMMs per layer routed through ``ops.quant.int8_matmul``. Jit it like
    any apply: ``jax.jit(lambda v, x: vit_apply_w8a8(model, v, x))``.

    ``mode="w8"`` keeps activations float and dequantizes the int8 weights
    into the GEMM dtype in-graph (weight-only quantization): the error
    drops to pure weight rounding (~1e-3 logit scale) and the win is the
    halved weight HBM footprint/traffic — the dominant term at serving
    batch sizes.

    ``mode="auto"`` picks the mode for the batch size at trace time
    (``resolve_quant_mode``).
    """
    p, q = qvars["params"], qvars["quant"]
    mode = _check_mode(mode, img.shape[0])
    dtype = model.dtype or jnp.float32
    eps = model.norm_eps
    qmm = _make_qmm(mode, dtype)

    x = _vit_embed(model, p, img, dtype)
    x = _encoder_w8a8(
        x, p["encoder"]["blocks"], q, heads=model.heads,
        dim_head=model.dim_head, eps=eps, dtype=dtype,
        activation=model.activation, qmm=qmm,
    )
    return _pool_and_head(p, x, model.pool, eps)


def _ste_qmm(dtype):
    """Straight-through W8A8 fake-quant GEMM for QAT.

    Forward mirrors ``ops.quant.int8_matmul``'s math — per-token symmetric
    int8 activations × per-channel int8 weights — but on the float master
    values with STE, so the backward is the plain float GEMM gradient.
    Matches the deployed int8 forward up to accumulation order (int32
    exact-sum there vs fp32 here); asserted ≤1e-4 on ViT logits in
    tests/test_quant.py.
    """

    def fq(v, axes):
        vf = v.astype(jnp.float32)
        v_i8, s = quantize_symmetric(vf, axes)  # the deployed recipe, exactly
        q = v_i8.astype(jnp.float32) * s
        return vf + jax.lax.stop_gradient(q - vf)

    def qmm(x, w, _scale_unused, bias=None, out_dtype=None):
        xq = fq(x, (-1,))                              # per token
        wq = fq(w, tuple(range(w.ndim - 1)))           # per output channel
        out = jnp.matmul(
            xq.astype(dtype), wq.astype(dtype),
            preferred_element_type=jnp.float32,
        )
        if bias is not None:
            out = out + bias.astype(jnp.float32)
        return out.astype(out_dtype or x.dtype)

    return qmm


def vit_apply_qat(model, variables: Dict[str, Any], img: jax.Array) -> jax.Array:
    """W8A8 quantization-aware forward for ``vitax.models.ViT`` from the
    LIVE float params: the four encoder GEMMs per layer run through the
    straight-through fake-quant (``_ste_qmm``), so the training forward
    sees (within fp32-vs-int32 accumulation) what ``vit_apply_w8a8`` will
    deploy, while gradients flow to the float master weights. Train with
    any custom step whose loss calls this; afterwards ``quantize_vit`` +
    ``vit_apply_w8a8`` deploys the absorbed rounding. Weight-only QAT for
    every OTHER family is ``fake_quantize_weights`` / ``qat=True``.
    """
    p = variables["params"]
    blocks = p["encoder"]["blocks"]
    attn, ff = blocks["attn"], blocks["ff"]
    assert "qkv_kernel" in attn, (
        "vit_apply_qat expects the raw-param scanned layout "
        "(models/vit.py); HF-submodule trees: normalize via quantize_vit's "
        "layout first"
    )
    dtype = model.dtype or jnp.float32
    depth = attn["qkv_kernel"].shape[0]
    dummy = jnp.zeros((depth, 1, 1), jnp.float32)  # scan slot; _ste_qmm ignores
    q = {
        "to_qkv": {"w": attn["qkv_kernel"], "s": dummy},
        "to_out": {"w": attn["out_kernel"], "s": dummy},
        "w1": {"w": ff["w1"], "s": dummy},
        "w2": {"w": ff["w2"], "s": dummy},
    }
    # share the quantized-encoder scan: blocks minus the float kernels
    blocks_view = {
        "attn": {k: v for k, v in attn.items() if k not in ("qkv_kernel", "out_kernel")},
        "ff": {k: v for k, v in ff.items() if k not in ("w1", "w2")},
    }

    x = _vit_embed(model, p, img, dtype)
    x = _encoder_w8a8(
        x, blocks_view, q, heads=model.heads, dim_head=model.dim_head,
        eps=model.norm_eps, dtype=dtype, activation=model.activation,
        qmm=_ste_qmm(dtype),
    )
    return _pool_and_head(p, x, model.pool, model.norm_eps)


# ---------------------------------------------------------------------------
# Generic weight-only compression (every family)

_W8_KEYS = ("kernel", "w1", "w2", "qkv_kernel", "out_kernel", "q_kernel",
            "k_kernel", "v_kernel")


def _quantize_leaf(w: jax.Array) -> Dict[str, jax.Array]:
    """Symmetric per-output-channel int8: one scale per trailing-axis
    channel, and — for ndim >= 3 — per leading-axis slice too, so a
    scan-stacked ``(depth, K, N)`` kernel gets per-LAYER scales rather
    than one scale shared across every layer's magnitude range (a layer
    with small |w|max would otherwise inherit the global max's scale and
    multiply its rounding error). Dequantize is elementwise in-graph, so
    any broadcastable scale shape is numerically exact; the extra bytes
    are depth x N fp32 — negligible."""
    reduce_axes = tuple(range(1 if w.ndim >= 3 else 0, w.ndim - 1))
    w_i8, scale = quantize_symmetric(w, reduce_axes)
    return {"__w8__": w_i8, "__scale__": scale}


def quantize_weights(
    variables: Dict[str, Any], *, min_size: int = 16384, keys=_W8_KEYS
) -> Dict[str, Any]:
    """Weight-only int8 compression for ANY family's variables tree.

    Unlike ``quantize_vit`` (which rebuilds the vanilla-stack encoder around
    int8 GEMMs), this is a pure tree transform: every float kernel named in
    ``keys`` with ``ndim >= 2`` and ``size >= min_size`` is replaced in
    place by ``{"__w8__": int8, "__scale__": per-channel fp32}``. Norm
    scales/biases, BatchNorm statistics, embeddings, position tables and
    small layers stay float — they carry the numerics and almost none of
    the bytes. Works on all 17 families + the BN models (CvT/LeViT trees
    pass through with ``batch_stats`` untouched).

    The win is ~4x smaller checkpoints/HBM weight residency vs fp32 (~2x
    vs bf16) at pure weight-rounding error; run the forward with
    ``quantized_apply`` (in-graph dequantize — XLA keeps the int8 tables
    resident and converts on the fly).
    """

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {
                k: (
                    _quantize_leaf(v)
                    if (
                        k in keys
                        and hasattr(v, "ndim")
                        and v.ndim >= 2
                        and v.size >= min_size
                        and jnp.issubdtype(v.dtype, jnp.floating)
                    )
                    else walk(v)
                )
                for k, v in node.items()
            }
        return node

    return walk(variables)


def fake_quantize_weights(
    params: Dict[str, Any], *, min_size: int = 16384, keys=_W8_KEYS
) -> Dict[str, Any]:
    """Straight-through-estimator view of the params for weight-only QAT.

    Every kernel ``quantize_weights`` would compress is replaced in-graph by
    ``w + stop_gradient(qdq(w) - w)``: the FORWARD sees exactly the
    int8-rounded weights the deployed ``quantized_apply`` will use (same
    ``_quantize_leaf`` math, so QAT-forward == deployed-forward bitwise —
    asserted in tests/test_quant.py), while the BACKWARD passes gradients
    straight through to the float master weights. Use inside a train step:
    ``model.apply({"params": fake_quantize_weights(params), ...}, x)`` —
    or just pass ``qat=True`` to ``make_train_step``. Training absorbs the
    rounding error, so the post-training ``quantize_weights`` checkpoint
    loses (almost) nothing.
    """

    def qdq(w):
        q = _quantize_leaf(w)
        return (q["__w8__"].astype(jnp.float32) * q["__scale__"]).astype(w.dtype)

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {
                k: (
                    v + jax.lax.stop_gradient(qdq(v) - v)
                    if (
                        k in keys
                        and hasattr(v, "ndim")
                        and v.ndim >= 2
                        and v.size >= min_size
                        and jnp.issubdtype(v.dtype, jnp.floating)
                    )
                    else walk(v)
                )
                for k, v in node.items()
            }
        return node

    return walk(params)


def dequantize_weights(qvars: Dict[str, Any], dtype=jnp.float32) -> Dict[str, Any]:
    """Inverse of ``quantize_weights``: reconstruct a float variables tree
    (in-graph when traced — jit callers keep int8 in HBM)."""

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            if "__w8__" in node:
                return (node["__w8__"].astype(jnp.float32) * node["__scale__"]).astype(dtype)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qvars)


def quantized_apply(model, qvars: Dict[str, Any], *args, dtype=jnp.float32, **kwargs):
    """Run any model's ``apply`` from a ``quantize_weights`` tree.

    Dequantization happens in-graph, so under ``jit`` the int8 tables are
    the resident weights and the float view is a transient the scheduler
    can fuse/stream. Jit it like any apply:
    ``jax.jit(lambda qv, img: quantized_apply(model, qv, img))``.
    """
    return model.apply(dequantize_weights(qvars, dtype=dtype), *args, **kwargs)


def tree_nbytes(tree: Any) -> int:
    """Total bytes of every array leaf (checkpoint-size accounting)."""
    return sum(
        x.size * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(tree)
        if hasattr(x, "dtype")
    )


def simple_vit_apply_w8a8(
    model, qvars: Dict[str, Any], img: jax.Array, mode: str = "w8a8"
) -> jax.Array:
    """Quantized inference forward for ``vitax.models.SimpleViT``
    (no cls token, fixed sin-cos positions, mean pool, eps 1e-5 —
    models/simple_vit.py). All modes of ``vit_apply_w8a8``, ``"auto"``
    included."""
    mode = _check_mode(mode, img.shape[0])
    p, q = qvars["params"], qvars["quant"]
    dtype = model.dtype or jnp.float32
    eps = 1e-5  # simple_vit.py: encoder and head_norm
    qmm = _make_qmm(mode, dtype)

    if model.channels_first:
        img = img.transpose(0, 2, 3, 1)
    ph, pw = pair(model.patch_size)
    gh = img.shape[1] // ph
    gw = img.shape[2] // pw
    x = _patch_embed_gemm(p, img, model.patch_size, dtype)
    x = x + ops.posemb_sincos_2d(gh, gw, model.dim, dtype=x.dtype)[None]

    x = _encoder_w8a8(
        x, p["encoder"]["blocks"], q, heads=model.heads,
        dim_head=model.dim_head, eps=eps, dtype=dtype,
        activation="gelu", qmm=qmm,
    )
    # SimpleViT head norm is bias-free (use_bias=False) — _pool_and_head's
    # hn.get("bias") resolves to None on this tree
    return _pool_and_head(p, x, "mean", eps)

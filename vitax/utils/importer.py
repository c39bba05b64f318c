"""Reference-checkpoint importer (SURVEY.md §5 'checkpoint/resume' row).

The reference names parameters by Flax call order (``Transformer_0/
Attention_3/Dense_0`` — a consequence of its Python-loop stacking,
SURVEY.md §3.1); this maps that layout onto this framework's named modules
so reference-trained parameters run here and logit-parity tests can compare
the two implementations on identical weights.
"""

from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp


def import_reference_deepvit_params(
    ref_params: Dict[str, Any], depth: int, *, scan: bool = True
) -> Dict[str, Any]:
    """Map a reference ``deepvit.py`` tree onto ``vitax.models.DeepViT``.

    DeepViT layout matches vit.py plus per-layer ``reattn_weights`` and a
    re-attention LayerNorm inside each Attention (deepvit.py:68-72). Note
    the reattention path never scans (talking XLA path), so this importer
    always emits per-layer modules.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    tr = p["Transformer_0"]
    out = import_reference_vit_params(ref_params, depth, scan=scan)
    enc = out["params"]["encoder"]

    def reattn(i):
        a = tr[f"Attention_{i}"]
        ln = a["LayerNorm_0"]
        return a["reattn_weights"], ln["scale"], ln["bias"]

    if scan and depth > 1:
        ws, scales, biases = zip(*(reattn(i) for i in range(depth)))
        enc["blocks"]["attn"]["reattn_weights"] = jnp.stack(ws)
        enc["blocks"]["attn"]["reattn_scale"] = jnp.stack(scales)
        enc["blocks"]["attn"]["reattn_bias"] = jnp.stack(biases)
    else:
        for i in range(depth):
            w, s, b_ = reattn(i)
            enc[f"attn_{i}"]["reattn_weights"] = w
            enc[f"attn_{i}"]["reattn_scale"] = s
            enc[f"attn_{i}"]["reattn_bias"] = b_
    return out


def import_reference_lsa_params(
    ref_params: Dict[str, Any], depth: int, dim_head: int = 64, *, scan: bool = True
) -> Dict[str, Any]:
    """Map a reference ``vit_small_datasets.py`` tree onto
    ``vitax.models.ViTSmallDatasets``.

    Layout: SPT_0 tokenizer, Transformer_0/{LSA_i, FeedForward_i,
    PreNorm_i (scale-only LNs)}, top-level LayerNorm_0 (head, scale-only) and
    Dense_0 (head). The reference's constant LSA temperature becomes our
    learned ``log_temperature`` initialized to the same value.
    """
    import jax

    p = ref_params["params"] if "params" in ref_params else ref_params
    tr = p["Transformer_0"]
    log_tau = jnp.log(jnp.asarray(dim_head, jnp.float32) ** -0.5)

    def layer(i):
        attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        attn = tr[f"LSA_{i}"]
        ff = tr[f"FeedForward_{i}"]
        zeros = jnp.zeros_like(attn_norm["scale"])
        return (
            {
                "norm_scale": attn_norm["scale"],
                "norm_bias": zeros,
                "qkv_kernel": attn["Dense_0"]["kernel"],
                "out_kernel": attn["Dense_1"]["kernel"],
                "out_bias": attn["Dense_1"]["bias"],
                "log_temperature": log_tau,
            },
            {
                "ln_scale": ff_norm["scale"],
                "ln_bias": jnp.zeros_like(ff_norm["scale"]),
                "w1": ff["Dense_0"]["kernel"],
                "b1": ff["Dense_0"]["bias"],
                "w2": ff["Dense_1"]["kernel"],
                "b2": ff["Dense_1"]["bias"],
            },
        )

    encoder: Dict[str, Any] = {}
    if scan and depth > 1:
        attns, ffs = zip(*(layer(i) for i in range(depth)))
        encoder["blocks"] = {
            "attn": jax.tree.map(lambda *xs: jnp.stack(xs), *attns),
            "ff": jax.tree.map(lambda *xs: jnp.stack(xs), *ffs),
        }
    else:
        for i in range(depth):
            a, f = layer(i)
            encoder[f"attn_{i}"] = a
            encoder[f"ff_{i}"] = f

    head_scale = p["LayerNorm_0"]["scale"]
    return {
        "params": {
            "cls": p["cls"],
            "pos_embedding": p["pos_embedding"],
            "spt": {
                "norm": {"scale": p["SPT_0"]["LayerNorm_0"]["scale"]},
                "proj": {
                    "kernel": p["SPT_0"]["Dense_0"]["kernel"],
                    "bias": p["SPT_0"]["Dense_0"]["bias"],
                },
            },
            "encoder": encoder,
            "head_norm": {"scale": head_scale, "bias": jnp.zeros_like(head_scale)},
            "head": {
                "kernel": p["Dense_0"]["kernel"],
                "bias": p["Dense_0"]["bias"],
            },
        }
    }


def import_reference_simple_vit_params(
    ref_params: Dict[str, Any], depth: int, *, scan: bool = True
) -> Dict[str, Any]:
    """Map a reference ``simple_vit.py`` tree onto ``vitax.models.SimpleViT``.

    Layout: Dense_1 = patch projection, Dense_0 = head, LayerNorm_0 = head
    norm (scale only); per-layer norms live INSIDE Attention_i/FeedForward_i
    (bias-free), and the out-projection carries no bias — zeros are
    substituted where this framework keeps bias parameters.
    """
    import jax

    p = ref_params["params"] if "params" in ref_params else ref_params
    tr = p["Transformer_0"]

    def layer(i):
        attn = tr[f"Attention_{i}"]
        ff = tr[f"FeedForward_{i}"]
        dim_zeros = jnp.zeros_like(attn["LayerNorm_0"]["scale"])
        return (
            {
                "norm_scale": attn["LayerNorm_0"]["scale"],
                "norm_bias": dim_zeros,
                "qkv_kernel": attn["Dense_0"]["kernel"],
                "out_kernel": attn["Dense_1"]["kernel"],
                "out_bias": dim_zeros,
            },
            {
                "ln_scale": ff["LayerNorm_0"]["scale"],
                "ln_bias": dim_zeros,
                "w1": ff["Dense_0"]["kernel"],
                "b1": ff["Dense_0"]["bias"],
                "w2": ff["Dense_1"]["kernel"],
                "b2": ff["Dense_1"]["bias"],
            },
        )

    encoder: Dict[str, Any] = {}
    if scan and depth > 1:
        attns, ffs = zip(*(layer(i) for i in range(depth)))
        encoder["blocks"] = {
            "attn": jax.tree.map(lambda *xs: jnp.stack(xs), *attns),
            "ff": jax.tree.map(lambda *xs: jnp.stack(xs), *ffs),
        }
    else:
        for i in range(depth):
            a, f = layer(i)
            encoder[f"attn_{i}"] = a
            encoder[f"ff_{i}"] = f

    return {
        "params": {
            "patch_embed": {
                "proj": {
                    "kernel": p["Dense_1"]["kernel"],
                    "bias": p["Dense_1"]["bias"],
                }
            },
            "encoder": encoder,
            "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
            "head": {
                "kernel": p["Dense_0"]["kernel"],
                "bias": p["Dense_0"]["bias"],
            },
        }
    }


def _encoder_layers(tr, depth, *, scan, bias_free_norms=False, out_bias=True):
    """Shared vit-style Transformer mapping: Attention_i/FeedForward_i +
    PreNorm pairs -> our raw-param blocks (optionally scan-stacked)."""
    import jax

    def layer(i):
        attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        attn = tr[f"Attention_{i}"]
        ff = tr[f"FeedForward_{i}"]
        zeros = jnp.zeros_like(attn_norm["scale"])
        a = {
            "norm_scale": attn_norm["scale"],
            "norm_bias": attn_norm.get("bias", zeros),
            "qkv_kernel": attn["Dense_0"]["kernel"],
        }
        if "Dense_1" in attn:  # out projection exists (project_out)
            a["out_kernel"] = attn["Dense_1"]["kernel"]
            a["out_bias"] = attn["Dense_1"].get(
                "bias", jnp.zeros((attn["Dense_1"]["kernel"].shape[1],), jnp.float32)
            )
        f = {
            "ln_scale": ff_norm["scale"],
            "ln_bias": ff_norm.get("bias", jnp.zeros_like(ff_norm["scale"])),
            "w1": ff["Dense_0"]["kernel"],
            "b1": ff["Dense_0"]["bias"],
            "w2": ff["Dense_1"]["kernel"],
            "b2": ff["Dense_1"]["bias"],
        }
        return a, f

    encoder = {}
    if scan and depth > 1:
        attns, ffs = zip(*(layer(i) for i in range(depth)))
        encoder["blocks"] = {
            "attn": jax.tree.map(lambda *xs: jnp.stack(xs), *attns),
            "ff": jax.tree.map(lambda *xs: jnp.stack(xs), *ffs),
        }
    else:
        for i in range(depth):
            a, f = layer(i)
            encoder[f"attn_{i}"] = a
            encoder[f"ff_{i}"] = f
    return encoder


def import_reference_t2t_params(
    ref_params: Dict[str, Any], depth: int, n_t2t_layers: int = 3
) -> Dict[str, Any]:
    """Map a reference ``t2t.py`` tree onto ``vitax.models.T2TViT``.

    Tokenizer stages RearrangeUnfoldTransformer_i each hold a 1-head
    depth-1 Transformer (no out projection — heads==1, dim_head==dim);
    Dense_0 is the final tokenizer projection, Transformer_0 the main
    encoder, LayerNorm_0 + Dense_1 the head.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    out: Dict[str, Any] = {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
        "encoder": _encoder_layers(p["Transformer_0"], depth, scan=True),
        "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
        "head": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
    }
    for i in range(n_t2t_layers - 1):  # last t2t layer has no transformer
        tr = p[f"RearrangeUnfoldTransformer_{i}"]["Transformer_0"]
        out[f"t2t_{i}"] = _encoder_layers(tr, 1, scan=False)
    return {"params": out}


def import_reference_pit_params(ref_params: Dict[str, Any], depth: int) -> Dict[str, Any]:
    """Map a reference ``pit.py`` tree onto ``vitax.models.PiT``.

    Only single-stage configs are importable: the reference's Pool never
    executes (``not_last`` bug, pit.py:199) so its multi-stage models
    degenerate to a flat encoder, while this build actually pools — the
    architectures only coincide when there is one stage.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    # reference call order names the head Dense_0 and the patch projection
    # Dense_1 (pit.py builds mlp_head's Dense before the projection runs)
    return {
        "params": {
            "cls": p["cls"],
            "pos_embedding": p["pos_embedding"],
            "proj": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
            "stage_0": _encoder_layers(p["Transformer_0"], depth, scan=True),
            "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
            "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
        }
    }


def _split_qkv_encoder_layers(tr, depth, *, scan):
    """vit-style encoder whose Attention keeps split q (Dense_0) / kv
    (Dense_1) / out (Dense_2) kernels (cross_vit.py:58-72) — concatenated
    into our fused qkv layout."""
    import jax

    def layer(i):
        attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        attn = tr[f"Attention_{i}"]
        ff = tr[f"FeedForward_{i}"]
        zeros = jnp.zeros_like(attn_norm["scale"])
        a = {
            "norm_scale": attn_norm["scale"],
            "norm_bias": zeros,
            "qkv_kernel": jnp.concatenate(
                [attn["Dense_0"]["kernel"], attn["Dense_1"]["kernel"]], axis=1
            ),
            "out_kernel": attn["Dense_2"]["kernel"],
            "out_bias": attn["Dense_2"]["bias"],
        }
        f = {
            "ln_scale": ff_norm["scale"],
            "ln_bias": jnp.zeros_like(ff_norm["scale"]),
            "w1": ff["Dense_0"]["kernel"],
            "b1": ff["Dense_0"]["bias"],
            "w2": ff["Dense_1"]["kernel"],
            "b2": ff["Dense_1"]["bias"],
        }
        return a, f

    encoder = {}
    if scan and depth > 1:
        attns, ffs = zip(*(layer(i) for i in range(depth)))
        encoder["blocks"] = {
            "attn": jax.tree.map(lambda *xs: jnp.stack(xs), *attns),
            "ff": jax.tree.map(lambda *xs: jnp.stack(xs), *ffs),
        }
    else:
        for i in range(depth):
            a, f = layer(i)
            encoder[f"attn_{i}"] = a
            encoder[f"ff_{i}"] = f
    return encoder


def import_reference_cross_vit_params(
    ref_params: Dict[str, Any],
    *,
    depth: int,
    sm_enc_depth: int,
    lg_enc_depth: int,
    cross_attn_depth: int,
) -> Dict[str, Any]:
    """Map a reference ``cross_vit.py`` tree onto ``vitax.models.CrossViT``.

    Reference layout: ImageEmbedder_{0,1}; MultiScaleEncoder_0 holding
    Transformer_{2d} (sm) / Transformer_{2d+1} (lg) / CrossTransformer_d,
    whose cross Attention_{2j}/{2j+1} params sit beside ProjectInOut_{2j}
    (sm->lg) / ProjectInOut_{2j+1} and scale-only PreNorms; heads are
    LayerNorm_{0,1} + Dense_{0,1}.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    msa = p["MultiScaleEncoder_0"]
    out: Dict[str, Any] = {}

    for branch, emb in (("sm", "ImageEmbedder_0"), ("lg", "ImageEmbedder_1")):
        e = p[emb]
        out[f"{branch}_embedder"] = {
            "cls": e["cls"],
            "pos_embedding": e["pos_embedding"],
            "patch_embed": {
                "proj": {"kernel": e["Dense_0"]["kernel"], "bias": e["Dense_0"]["bias"]}
            },
        }

    def cross_attention(ct, j, prenorm_dim_zeros):
        attn = ct[f"Attention_{j}"]
        norm = ct[f"PreNorm_{j}"]["LayerNorm_0"]
        return {
            "norm": {"scale": norm["scale"], "bias": jnp.zeros_like(norm["scale"])},
            "to_q": {"kernel": attn["Dense_0"]["kernel"]},
            "to_kv": {"kernel": attn["Dense_1"]["kernel"]},
            "to_out": {
                "kernel": attn["Dense_2"]["kernel"],
                "bias": attn["Dense_2"]["bias"],
            },
        }

    for d in range(depth):
        sm_tr = msa[f"Transformer_{2 * d}"]
        lg_tr = msa[f"Transformer_{2 * d + 1}"]
        enc_sm = _split_qkv_encoder_layers(sm_tr, sm_enc_depth, scan=True)
        fn = sm_tr["LayerNorm_0"]
        enc_sm["final_norm"] = {"scale": fn["scale"], "bias": jnp.zeros_like(fn["scale"])}
        out[f"sm_enc_{d}"] = enc_sm
        enc_lg = _split_qkv_encoder_layers(lg_tr, lg_enc_depth, scan=True)
        fn = lg_tr["LayerNorm_0"]
        enc_lg["final_norm"] = {"scale": fn["scale"], "bias": jnp.zeros_like(fn["scale"])}
        out[f"lg_enc_{d}"] = enc_lg

        ct = msa[f"CrossTransformer_{d}"]
        for j in range(cross_attn_depth):
            sm_pio = ct[f"ProjectInOut_{2 * j}"]
            lg_pio = ct[f"ProjectInOut_{2 * j + 1}"]
            out[f"cross_{d}_{j}"] = {
                "sm_attends_lg_proj_in": {
                    "kernel": sm_pio["Dense_0"]["kernel"],
                    "bias": sm_pio["Dense_0"]["bias"],
                },
                "sm_attends_lg_proj_out": {
                    "kernel": sm_pio["Dense_1"]["kernel"],
                    "bias": sm_pio["Dense_1"]["bias"],
                },
                "sm_attends_lg": cross_attention(ct, 2 * j, None),
                "lg_attends_sm_proj_in": {
                    "kernel": lg_pio["Dense_0"]["kernel"],
                    "bias": lg_pio["Dense_0"]["bias"],
                },
                "lg_attends_sm_proj_out": {
                    "kernel": lg_pio["Dense_1"]["kernel"],
                    "bias": lg_pio["Dense_1"]["bias"],
                },
                "lg_attends_sm": cross_attention(ct, 2 * j + 1, None),
            }

    out["sm_head_norm"] = {"scale": p["LayerNorm_0"]["scale"]}
    out["lg_head_norm"] = {"scale": p["LayerNorm_1"]["scale"]}
    out["sm_head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    out["lg_head"] = {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]}
    return {"params": out}


def _conv1x1_to_dense(conv):
    """``(1, 1, cin, cout)`` conv kernel -> ``(cin, cout)`` Dense kernel."""
    k = conv["kernel"]
    out = {"kernel": k.reshape(k.shape[2], k.shape[3])}
    if "bias" in conv:
        out["bias"] = conv["bias"]
    return out


def import_reference_twins_params(
    ref_params: Dict[str, Any], depths=(1, 1, 5, 4)
) -> Dict[str, Any]:
    """Map a reference ``twins_svt.py`` tree onto ``vitax.models.TwinsSVT``.

    Reference layout: PatchEmbedding_{s}, PEG_{s}, and two Transformers per
    stage (Transformer_{2s}, Transformer_{2s+1}); within a transformer the
    per-depth creation order is Local/MLP/Global/MLP with PreNorms numbered
    in that order (stage 4 drops the local pair). 1x1 convs map to Dense
    kernels; the GSA subsampling conv keeps its (k, k, cin, cout) layout.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    out: Dict[str, Any] = {}

    import jax

    def block(tr, depth, has_local):
        def mlp_of(m, norm):
            return {"ff": {
                "ln_scale": norm["scale"],
                "ln_bias": jnp.zeros_like(norm["scale"]),
                "w1": m["Conv_0"]["kernel"].reshape(m["Conv_0"]["kernel"].shape[2], -1),
                "b1": m["Conv_0"]["bias"],
                "w2": m["Conv_1"]["kernel"].reshape(m["Conv_1"]["kernel"].shape[2], -1),
                "b2": m["Conv_1"]["bias"],
            }}

        def layer(i):
            per = 4 if has_local else 2
            out: Dict[str, Any] = {}
            if has_local:
                la = tr[f"LocalAttention_{i}"]
                norm = tr[f"PreNorm_{per * i}"]["LayerNorm_0"]
                # separate to_q / to_kv 1x1 convs concatenate column-wise
                # into the fused-kernel [q|k|v] layout (kv is already [k|v])
                q_k = _conv1x1_to_dense(la["Conv_0"])["kernel"]
                kv_k = _conv1x1_to_dense(la["Conv_1"])["kernel"]
                to_out = _conv1x1_to_dense(la["Conv_2"])
                out["local"] = {
                    "norm_scale": norm["scale"],
                    "norm_bias": jnp.zeros_like(norm["scale"]),
                    "qkv_kernel": jnp.concatenate([q_k, kv_k], axis=1),
                    "out_kernel": to_out["kernel"],
                    "out_bias": to_out.get(
                        "bias", jnp.zeros((to_out["kernel"].shape[1],))
                    ),
                }
                out["ff1"] = mlp_of(tr[f"MLP_{2 * i}"], tr[f"PreNorm_{per * i + 1}"]["LayerNorm_0"])
            ga = tr[f"GlobalAttention_{i}"]
            gnorm = tr[f"PreNorm_{per * i + (2 if has_local else 0)}"]["LayerNorm_0"]
            out["global"] = {
                "norm": {"scale": gnorm["scale"], "bias": jnp.zeros_like(gnorm["scale"])},
                "to_q": _conv1x1_to_dense(ga["Conv_0"]),
                "to_kv": {"kernel": ga["Conv_1"]["kernel"]},  # (k, k, cin, 2*inner)
                "to_out": _conv1x1_to_dense(ga["Conv_2"]),
            }
            fnorm = tr[f"PreNorm_{per * i + (3 if has_local else 1)}"]["LayerNorm_0"]
            out["ff2"] = mlp_of(tr[f"MLP_{2 * i + 1}" if has_local else f"MLP_{i}"], fnorm)
            return out

        layers = [layer(i) for i in range(depth)]
        if depth > 1:  # scanned: stack along the depth axis
            return {"layers": jax.tree.map(lambda *xs: jnp.stack(xs), *layers)}
        return {"layers": layers[0]}

    for s in range(1, 5):
        has_local = s < 4
        out[f"embed_{s}"] = {"proj": _conv1x1_to_dense(p[f"PatchEmbedding_{s - 1}"]["Conv_0"])}
        out[f"peg_{s}"] = {"proj": {
            "kernel": p[f"PEG_{s - 1}"]["Conv_0"]["kernel"],
            "bias": p[f"PEG_{s - 1}"]["Conv_0"]["bias"],
        }}
        out[f"block_a_{s}"] = block(p[f"Transformer_{2 * (s - 1)}"], depths[s - 1], has_local)
        out[f"block_b_{s}"] = block(p[f"Transformer_{2 * (s - 1) + 1}"], depths[s - 1], has_local)

    out["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return {"params": out}


def import_reference_nest_params(
    ref_params: Dict[str, Any],
    num_hierarchies: int,
    block_repeats,
    block_grid_sides,
) -> Dict[str, Any]:
    """Map a reference ``nest.py`` tree onto ``vitax.models.NesT``.

    Reference Transformer_i = hierarchy i (most blocks first); its 1-D
    scalar-per-token pos_emb (nest.py:114) broadcasts across channels into
    our per-(token, channel) embedding. Channel-LN ``g``/``b`` map to
    ``scale``/``bias``; 1x1 convs to Dense kernels (all bias-free here).
    ``block_grid_sides[i]`` is the per-hierarchy block fmap side.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    out: Dict[str, Any] = {
        "proj": _conv1x1_to_dense(p["Conv_0"]),
        "head_norm": {
            "scale": p["LayerNorm_0"]["g"].reshape(-1),
            "bias": p["LayerNorm_0"]["b"].reshape(-1),
        },
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }

    layer_idx = 0
    for li in range(num_hierarchies):
        tr = p[f"Transformer_{li}"]
        side = block_grid_sides[li]
        dim = tr["PreNorm_0"]["LayerNorm_0"]["g"].shape[-1]
        pos = tr["pos_emb"].reshape(1, side, side, 1)
        out[f"pos_emb_{li}"] = jnp.broadcast_to(pos, (1, side, side, dim))
        for d in range(block_repeats[li]):
            attn = tr[f"Attention_{d}"]
            ff = tr[f"FeedForward_{d}"]
            a_norm = tr[f"PreNorm_{2 * d}"]["LayerNorm_0"]
            f_norm = tr[f"PreNorm_{2 * d + 1}"]["LayerNorm_0"]
            out[f"attn_{li}_{d}"] = {
                "norm": {
                    "scale": a_norm["g"].reshape(-1),
                    "bias": a_norm["b"].reshape(-1),
                },
                "to_qkv": _conv1x1_to_dense(attn["Conv_0"]),
                "to_out": _conv1x1_to_dense(attn["Conv_1"]),
            }
            w1 = ff["Conv_0"]["kernel"]
            w2 = ff["Conv_1"]["kernel"]
            out[f"ff_{li}_{d}"] = {"ff": {
                "ln_scale": f_norm["g"].reshape(-1),
                "ln_bias": f_norm["b"].reshape(-1),
                "w1": w1.reshape(w1.shape[2], -1),
                "b1": jnp.zeros((w1.shape[3],), jnp.float32),
                "w2": w2.reshape(w2.shape[2], -1),
                "b2": jnp.zeros((w2.shape[3],), jnp.float32),
            }}
        if li + 1 < num_hierarchies:
            agg = p[f"Aggregate_{li}"]
            out[f"agg_{li}"] = {
                "conv": {"kernel": agg["Conv_0"]["kernel"], "bias": agg["Conv_0"]["bias"]},
                "norm": {
                    "scale": agg["LayerNorm_0"]["g"].reshape(-1),
                    "bias": agg["LayerNorm_0"]["b"].reshape(-1),
                },
            }
    return {"params": out}


def import_reference_scalable_vit_params(
    ref_params: Dict[str, Any], depths
) -> Dict[str, Any]:
    """Map a reference ``scalable_vit.py`` tree onto
    ``vitax.models.ScalableViT`` (use ``reference_block_order=True``:
    the reference's tuple-unpack bug runs both MLPs before IWSA,
    scalable_vit.py:238-251, and imported weights follow that order).

    Per depth d: SSA Conv_0 q / Conv_1 k / Conv_2 v / Conv_3 out;
    IWSA Conv_0 LIM / Conv_1..3 qkv / Conv_4 out; MLP_{2d}, MLP_{2d+1};
    PreNorm_{4d..4d+3} = [ssa, ff1, ff2, iwsa]; PEG on the first block.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    out: Dict[str, Any] = {
        "patchify": {"kernel": p["Conv_0"]["kernel"], "bias": p["Conv_0"]["bias"]},
        "head_norm": {
            "scale": p["LayerNorm_0"]["scale"],
            "bias": jnp.zeros_like(p["LayerNorm_0"]["scale"]),
        },
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }

    def mlp(m, norm):
        return {"ff": {
            "ln_scale": norm["scale"],
            "ln_bias": jnp.zeros_like(norm["scale"]),
            "w1": m["Conv_0"]["kernel"].reshape(m["Conv_0"]["kernel"].shape[2], -1),
            "b1": m["Conv_0"]["bias"],
            "w2": m["Conv_1"]["kernel"].reshape(m["Conv_1"]["kernel"].shape[2], -1),
            "b2": m["Conv_1"]["bias"],
        }}

    import jax

    for s, depth in enumerate(depths):
        tr = p[f"Transformer_{s}"]
        out[f"peg_{s}"] = {"proj": {
            "kernel": tr["PEG_0"]["Conv_0"]["kernel"],
            "bias": tr["PEG_0"]["Conv_0"]["bias"],
        }}
        sn = tr["LayerNorm_0"]
        out[f"stage_norm_{s}"] = {"scale": sn["scale"], "bias": jnp.zeros_like(sn["scale"])}
        if s + 1 < len(depths):
            d = p[f"Downsample_{s}"]["Conv_0"]
            out[f"down_{s}"] = {"conv": {"kernel": d["kernel"], "bias": d["bias"]}}

        def layer(i):
            ssa = tr[f"ScalableSelfAttention_{i}"]
            ssa_norm = tr[f"PreNorm_{4 * i}"]["LayerNorm_0"]
            iwsa = tr[f"InteractiveWindowedSelfAttention_{i}"]
            iwsa_norm = tr[f"PreNorm_{4 * i + 3}"]["LayerNorm_0"]
            return {
                "ssa": {
                    "norm": {"scale": ssa_norm["scale"], "bias": jnp.zeros_like(ssa_norm["scale"])},
                    "to_q": _conv1x1_to_dense(ssa["Conv_0"]),
                    "to_k": {"kernel": ssa["Conv_1"]["kernel"]},
                    "to_v": {"kernel": ssa["Conv_2"]["kernel"]},
                    "to_out": _conv1x1_to_dense(ssa["Conv_3"]),
                },
                "ff1": mlp(tr[f"MLP_{2 * i}"], tr[f"PreNorm_{4 * i + 1}"]["LayerNorm_0"]),
                "ff2": mlp(tr[f"MLP_{2 * i + 1}"], tr[f"PreNorm_{4 * i + 2}"]["LayerNorm_0"]),
                "iwsa": {
                    "norm": {"scale": iwsa_norm["scale"], "bias": jnp.zeros_like(iwsa_norm["scale"])},
                    "lim": {"kernel": iwsa["Conv_0"]["kernel"], "bias": iwsa["Conv_0"]["bias"]},
                    "to_q": _conv1x1_to_dense(iwsa["Conv_1"]),
                    "to_k": _conv1x1_to_dense(iwsa["Conv_2"]),
                    "to_v": _conv1x1_to_dense(iwsa["Conv_3"]),
                    "to_out": _conv1x1_to_dense(iwsa["Conv_4"]),
                },
            }

        first = layer(0)
        for key, val in first.items():
            out[f"{key}_{s}_0"] = val
        rest = [layer(i) for i in range(1, depth)]
        if len(rest) > 1:  # scanned: stack along the depth axis
            out[f"stage_{s}"] = jax.tree.map(lambda *xs: jnp.stack(xs), *rest)
        elif len(rest) == 1:
            out[f"stage_{s}"] = rest[0]
    return {"params": out}


def import_reference_cvt_params(
    ref_params: Dict[str, Any], depths=(1, 2, 10)
) -> Dict[str, Any]:
    """Map a reference ``cvt.py`` tree (params + batch_stats) onto
    ``vitax.models.CvT``. Compare in train-mode BN: the reference hardcodes
    ``use_running_average=False`` (cvt.py:73), so logits depend on batch
    statistics; run ours with ``train=True, mutable=['batch_stats']``.
    """
    p = ref_params["params"]
    bs = ref_params["batch_stats"]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    for s in range(1, len(depths) + 1):
        conv = p[f"Conv_{s - 1}"]
        params[f"embed_{s}"] = {"kernel": conv["kernel"], "bias": conv["bias"]}
        ln = p[f"LayerNorm_{s - 1}"]
        params[f"embed_norm_{s}"] = {
            "scale": ln["g"].reshape(-1),
            "bias": ln["b"].reshape(-1),
        }
        tr = p[f"Transformer_{s - 1}"]
        tr_bs = bs[f"Transformer_{s - 1}"]
        for i in range(depths[s - 1]):
            attn = tr[f"Attention_{i}"]
            attn_bs = tr_bs[f"Attention_{i}"]
            norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
            ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]

            def dw(src, src_bs):
                return (
                    {
                        "depthwise": {"kernel": src["Conv_0"]["kernel"]},
                        "bn": {
                            "scale": src["BatchNorm_0"]["scale"],
                            "bias": src["BatchNorm_0"]["bias"],
                        },
                        "pointwise": {"kernel": src["Conv_1"]["kernel"]},
                    },
                    {"bn": {
                        "mean": src_bs["BatchNorm_0"]["mean"],
                        "var": src_bs["BatchNorm_0"]["var"],
                    }},
                )

            q_p, q_s = dw(attn["DepthWiseConv2d_0"], attn_bs["DepthWiseConv2d_0"])
            kv_p, kv_s = dw(attn["DepthWiseConv2d_1"], attn_bs["DepthWiseConv2d_1"])
            params[f"attn_{s}_{i}"] = {
                "norm": {"scale": norm["scale"], "bias": jnp.zeros_like(norm["scale"])},
                "to_q": q_p,
                "to_kv": kv_p,
                "to_out": _conv1x1_to_dense(attn["Conv_0"]),
            }
            stats[f"attn_{s}_{i}"] = {"to_q": q_s, "to_kv": kv_s}
            ff = tr[f"FeedForward_{i}"]
            w1 = ff["Conv_0"]["kernel"]
            w2 = ff["Conv_1"]["kernel"]
            params[f"ff_{s}_{i}"] = {"ff": {
                "ln_scale": ff_norm["scale"],
                "ln_bias": jnp.zeros_like(ff_norm["scale"]),
                "w1": w1.reshape(w1.shape[2], -1),
                "b1": jnp.zeros((w1.shape[3],), jnp.float32),
                "w2": w2.reshape(w2.shape[2], -1),
                "b2": jnp.zeros((w2.shape[3],), jnp.float32),
            }}

    params["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return {"params": params, "batch_stats": stats}


def import_reference_levit_params(
    ref_params: Dict[str, Any], stages: int, depths, dim_key: int = 32
) -> Dict[str, Any]:
    """Map a reference ``levit.py`` tree (params + batch_stats) onto
    ``vitax.models.LeViT`` (train-mode BN comparison, like CvT).

    Reference Transformer indices alternate stage/downsample blocks. The
    reference adds its positional table as ``bias/scale`` on top of already-
    scaled logits (levit.py:133-138); this build adds the bias directly, so
    the imported table is divided by the scale (x sqrt(dim_key)).
    """
    p = ref_params["params"]
    bs = ref_params["batch_stats"]
    inv_scale = float(dim_key) ** 0.5  # 1 / (dim_key ** -0.5)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    for i in range(4):
        params[f"stem_{i}"] = {
            "kernel": p[f"Conv_{i}"]["kernel"],
            "bias": p[f"Conv_{i}"]["bias"],
        }

    def attention(tr, tr_bs, d):
        attn = tr[f"Attention_{d}"]
        attn_bs = tr_bs[f"Attention_{d}"]
        ap: Dict[str, Any] = {
            "pos_bias": {"pos_bias": {"embedding": attn["Embed_0"]["embedding"] * inv_scale}},
        }
        asb: Dict[str, Any] = {}
        for j, name in enumerate(("to_q", "to_k", "to_v", "to_out")):
            conv = {"kernel": attn[f"Conv_{j}"]["kernel"]}
            if "bias" in attn[f"Conv_{j}"]:
                conv["bias"] = attn[f"Conv_{j}"]["bias"]
            ap[f"{name}_conv"] = conv
            ap[f"{name}_bn"] = {
                "scale": attn[f"BatchNorm_{j}"]["scale"],
                "bias": attn[f"BatchNorm_{j}"]["bias"],
            }
            asb[f"{name}_bn"] = {
                "mean": attn_bs[f"BatchNorm_{j}"]["mean"],
                "var": attn_bs[f"BatchNorm_{j}"]["var"],
            }
        return ap, asb

    def mlp(tr, d):
        m = tr[f"MLP_{d}"]
        return {"ff": {
            "w1": m["Conv_0"]["kernel"].reshape(m["Conv_0"]["kernel"].shape[2], -1),
            "b1": m["Conv_0"]["bias"],
            "w2": m["Conv_1"]["kernel"].reshape(m["Conv_1"]["kernel"].shape[2], -1),
            "b2": m["Conv_1"]["bias"],
        }}

    t = 0
    for s in range(stages):
        tr, tr_bs = p[f"Transformer_{t}"], bs[f"Transformer_{t}"]
        for d in range(depths[s]):
            ap, asb = attention(tr, tr_bs, d)
            params[f"stage_{s}_attn_{d}"] = ap
            stats[f"stage_{s}_attn_{d}"] = asb
            params[f"stage_{s}_mlp_{d}"] = mlp(tr, d)
        t += 1
        if s + 1 < stages:
            tr, tr_bs = p[f"Transformer_{t}"], bs[f"Transformer_{t}"]
            ap, asb = attention(tr, tr_bs, 0)
            params[f"down_{s}_attn_0"] = ap
            stats[f"down_{s}_attn_0"] = asb
            params[f"down_{s}_mlp_0"] = mlp(tr, 0)
            t += 1

    if "Dense_1" in p:  # distill head present: Dense_0 distill, Dense_1 main
        params["head"] = {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]}
        params["distill_head"] = {
            "kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]
        }
    else:
        params["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return {"params": params, "batch_stats": stats}


def import_reference_crossformer_params(
    ref_params: Dict[str, Any], depths=(2, 2, 8, 2)
) -> Dict[str, Any]:
    """Map a reference ``crossformer.py`` tree onto
    ``vitax.models.CrossFormer`` (use ``reference_quirks=True``: the
    reference's DPB is a scalar bias gathered with a mismatched stride —
    see DynamicPositionBias — and imported weights follow that math).
    """
    import jax

    p = ref_params["params"] if "params" in ref_params else ref_params
    out: Dict[str, Any] = {
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }

    def dpb(src):
        d: Dict[str, Any] = {}
        for i in range(4):
            d[f"fc{i}"] = {
                "kernel": src[f"Dense_{i}"]["kernel"],
                "bias": src[f"Dense_{i}"]["bias"],
            }
        for i in range(3):
            d[f"ln{i}"] = {"scale": src[f"LayerNorm_{i}"]["scale"]}
        return d

    def attn(src):
        to_qkv = _conv1x1_to_dense(src["Conv_0"])
        to_out = _conv1x1_to_dense(src["Conv_1"])
        return {
            "norm_scale": src["LayerNorm_0"]["g"].reshape(-1),
            "norm_bias": src["LayerNorm_0"]["b"].reshape(-1),
            "qkv_kernel": to_qkv["kernel"],
            "out_kernel": to_out["kernel"],
            "out_bias": to_out["bias"],
            "dpb": dpb(src["DynamicPositionBias_0"]),
        }

    def conv_mlp(src):
        w1 = src["Conv_0"]["kernel"]
        w2 = src["Conv_1"]["kernel"]
        return {"ff": {
            "ln_scale": src["LayerNorm_0"]["g"].reshape(-1),
            "ln_bias": src["LayerNorm_0"]["b"].reshape(-1),
            "w1": w1.reshape(w1.shape[2], -1),
            "b1": src["Conv_0"]["bias"],
            "w2": w2.reshape(w2.shape[2], -1),
            "b2": src["Conv_1"]["bias"],
        }}

    for s, depth in enumerate(depths):
        cel = p[f"CrossEmbedLayer_{s}"]
        out[f"embed_{s}"] = {
            f"conv_{i}": {"kernel": c["kernel"], "bias": c["bias"]}
            for i, c in ((i, cel[f"Conv_{i}"]) for i in range(len(cel)))
        }
        tr = p[f"Transformer_{s}"]

        def block(i):
            return {
                "sda": attn(tr[f"Attention_{2 * i}"]),
                "mlp1": conv_mlp(tr[f"MLP_{2 * i}"]),
                "lda": attn(tr[f"Attention_{2 * i + 1}"]),
                "mlp2": conv_mlp(tr[f"MLP_{2 * i + 1}"]),
            }

        blocks = [block(i) for i in range(depth)]
        if depth > 1:  # scanned stage
            out[f"stage_{s}"] = jax.tree.map(lambda *xs: jnp.stack(xs), *blocks)
        else:
            out[f"stage_{s}"] = blocks[0]
    return {"params": out}


def import_reference_cait_params(
    ref_params: Dict[str, Any], depth: int, cls_depth: int
) -> Dict[str, Any]:
    """Map a reference ``cait.py`` tree onto ``vitax.models.CaiT``.

    Reference attention uses separate q (Dense_0) / kv (Dense_1) kernels
    even for self-attention — concatenated into our fused qkv_kernel for the
    patch stage; the class stage keeps the split layout. Talking-heads
    mixes map directly; LayerScale is the reference's constant epsilon
    (it never learns it, bug register #6) so imported values equal our
    initializer's. Note reference LayerScale bands epsilon by LAYER index
    (bug register #20) — identical to ours for models up to depth 18.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params

    import jax

    def stage(tr, n_layers, self_attention: bool, eps_vals):
        def layer(i):
            attn = tr[f"Attention_{i}"]
            ff = tr[f"FeedForward_{i}"]
            attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
            ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
            zeros = jnp.zeros_like(attn_norm["scale"])
            if self_attention:
                a = {
                    "norm_scale": attn_norm["scale"],
                    "norm_bias": zeros,
                    "qkv_kernel": jnp.concatenate(
                        [attn["Dense_0"]["kernel"], attn["Dense_1"]["kernel"]], axis=1
                    ),
                    "out_kernel": attn["Dense_2"]["kernel"],
                    "out_bias": attn["Dense_2"]["bias"],
                    "mix_heads_pre": attn["mix_heads_pre_attn"],
                    "mix_heads_post": attn["mix_heads_post_attn"],
                }
            else:
                a = {
                    "norm": {"scale": attn_norm["scale"], "bias": zeros},
                    "to_q": {"kernel": attn["Dense_0"]["kernel"]},
                    "to_kv": {"kernel": attn["Dense_1"]["kernel"]},
                    "to_out": {
                        "kernel": attn["Dense_2"]["kernel"],
                        "bias": attn["Dense_2"]["bias"],
                    },
                    "mix_heads_pre": attn["mix_heads_pre_attn"],
                    "mix_heads_post": attn["mix_heads_post_attn"],
                }
            dim = attn_norm["scale"].shape[0]
            return {
                "attn": a,
                "ff": {
                    "ln_scale": ff_norm["scale"],
                    "ln_bias": zeros,
                    "w1": ff["Dense_0"]["kernel"],
                    "b1": ff["Dense_0"]["bias"],
                    "w2": ff["Dense_1"]["kernel"],
                    "b2": ff["Dense_1"]["bias"],
                },
                "ls_attn": jnp.full((dim,), eps_vals, jnp.float32),
                "ls_ff": jnp.full((dim,), eps_vals, jnp.float32),
            }

        layers = [layer(i) for i in range(n_layers)]
        if n_layers > 1:  # scanned: stack along the depth axis
            return {"blocks": jax.tree.map(lambda *xs: jnp.stack(xs), *layers)}
        return {"blocks": layers[0]}

    eps = 0.1 if depth <= 18 else (1e-5 if depth <= 24 else 1e-6)
    head_scale = p["LayerNorm_0"]["scale"]
    return {
        "params": {
            "cls": p["cls"],
            "pos_embedding": p["pos_embedding"],
            "patch_embed": {
                "proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
            },
            "patch_stage": stage(p["Transformer_0"], depth, True, eps),
            "cls_stage": stage(p["Transformer_1"], cls_depth, False, eps),
            "head_norm": {"scale": head_scale, "bias": jnp.zeros_like(head_scale)},
            "head": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
        }
    }


def import_reference_parallel_vit_params(
    ref_params: Dict[str, Any], depth: int, branches: int = 2
) -> Dict[str, Any]:
    """Map a reference ``parallel_vit.py`` tree onto
    ``vitax.models.ParallelViT`` (never scanned — branch submodules).

    Reference order: per depth d, branch b: Attention_{d*B+b},
    FeedForward_{d*B+b}; PreNorm_{d*2B+b} (attn) and PreNorm_{d*2B+B+b}
    (ff), all scale-only. Out projections carry no bias; zeros substituted.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    tr = p["Transformer_0"]

    encoder: Dict[str, Any] = {}
    for d in range(depth):
        for b in range(branches):
            attn = tr[f"Attention_{d * branches + b}"]
            ff = tr[f"FeedForward_{d * branches + b}"]
            attn_norm = tr[f"PreNorm_{d * 2 * branches + b}"]["LayerNorm_0"]
            ff_norm = tr[f"PreNorm_{d * 2 * branches + branches + b}"]["LayerNorm_0"]
            zeros = jnp.zeros_like(attn_norm["scale"])
            encoder[f"attn_{d}_{b}"] = {
                "norm_scale": attn_norm["scale"],
                "norm_bias": zeros,
                "qkv_kernel": attn["Dense_0"]["kernel"],
                "out_kernel": attn["Dense_1"]["kernel"],
                "out_bias": zeros,
            }
            encoder[f"ff_{d}_{b}"] = {
                "ln_scale": ff_norm["scale"],
                "ln_bias": zeros,
                "w1": ff["Dense_0"]["kernel"],
                "b1": ff["Dense_0"]["bias"],
                "w2": ff["Dense_1"]["kernel"],
                "b2": ff["Dense_1"]["bias"],
            }

    head_scale = p["LayerNorm_0"]["scale"]
    out = {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "patch_embed": {
            "proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
        },
        "encoder": encoder,
        "head_norm": {"scale": head_scale, "bias": jnp.zeros_like(head_scale)},
        "head": {"kernel": p["Dense_1"]["kernel"]},
    }
    if "bias" in p["Dense_1"]:
        out["head"]["bias"] = p["Dense_1"]["bias"]
    else:
        out["head"]["bias"] = jnp.zeros((p["Dense_1"]["kernel"].shape[1],), jnp.float32)
    return {"params": out}


def import_reference_patch_merger_params(
    ref_params: Dict[str, Any], depth: int, merge_at: int, num_tokens_out: int
) -> Dict[str, Any]:
    """Map a reference ``patch_merger.py`` tree onto
    ``vitax.models.PatchMergerViT``.

    The reference's merger queries are a fixed ``PRNGKey(0)`` draw rather
    than a parameter (bug register #4); the same draw seeds our learned
    ``queries`` so logits match at import time.
    """
    import jax

    p = ref_params["params"] if "params" in ref_params else ref_params
    tr = p["Transformer_0"]
    dim = p["Dense_1"]["kernel"].shape[1]

    encoder: Dict[str, Any] = {}
    for i in range(depth):
        attn = tr[f"Attention_{i}"]
        ff = tr[f"FeedForward_{i}"]
        attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        zeros = jnp.zeros_like(attn_norm["scale"])
        encoder[f"attn_{i}"] = {
            "norm_scale": attn_norm["scale"],
            "norm_bias": zeros,
            "qkv_kernel": attn["Dense_0"]["kernel"],
            "out_kernel": attn["Dense_1"]["kernel"],
            "out_bias": zeros,
        }
        encoder[f"ff_{i}"] = {
            "ln_scale": ff_norm["scale"],
            "ln_bias": zeros,
            "w1": ff["Dense_0"]["kernel"],
            "b1": ff["Dense_0"]["bias"],
            "w2": ff["Dense_1"]["kernel"],
            "b2": ff["Dense_1"]["bias"],
        }

    merger_scale = tr["PatchMerger_0"]["LayerNorm_0"]["scale"]
    head_scale = p["LayerNorm_0"]["scale"]
    encoder_and_merger = dict(encoder)
    encoder_and_merger["merger"] = {
        "queries": jax.random.normal(jax.random.PRNGKey(0), (num_tokens_out, dim)),
        "norm": {"scale": merger_scale, "bias": jnp.zeros_like(merger_scale)},
    }
    return {
        "params": {
            # the reference allocates num_patches+1 rows (a cls slot it never
            # uses — mean pool) and slices [:n] at apply; drop the extra row
            "pos_embedding": p["pos_embedding"][:, :-1],
            "patch_embed": {
                "proj": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]}
            },
            **encoder_and_merger,
            "head_norm": {"scale": head_scale, "bias": jnp.zeros_like(head_scale)},
            "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
        }
    }


def import_reference_vit_params(
    ref_params: Dict[str, Any], depth: int, *, scan: bool = True
) -> Dict[str, Any]:
    """Map a reference ``vit.py`` param tree onto ``vitax.models.ViT``.

    Reference layout (vit.py): Dense_0 = patch projection, Dense_1 = head,
    LayerNorm_0 = head norm, Transformer_0/{Attention_i, FeedForward_i,
    PreNorm_{2i} (attn norm), PreNorm_{2i+1} (ff norm)}.

    ``scan=True`` (the encoder's default) stacks the per-layer params along
    a leading depth axis for the nn.scan'd block; ``scan=False`` produces
    the per-layer ``attn_i``/``ff_i`` layout.
    """
    p = ref_params["params"] if "params" in ref_params else ref_params
    tr = p["Transformer_0"]

    def layer(i):
        attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        attn = tr[f"Attention_{i}"]
        ff = tr[f"FeedForward_{i}"]
        return (
            {
                "norm_scale": attn_norm["scale"],
                "norm_bias": attn_norm["bias"],
                "qkv_kernel": attn["Dense_0"]["kernel"],
                "out_kernel": attn["Dense_1"]["kernel"],
                "out_bias": attn["Dense_1"]["bias"],
            },
            {
                "ln_scale": ff_norm["scale"],
                "ln_bias": ff_norm["bias"],
                "w1": ff["Dense_0"]["kernel"],
                "b1": ff["Dense_0"]["bias"],
                "w2": ff["Dense_1"]["kernel"],
                "b2": ff["Dense_1"]["bias"],
            },
        )

    encoder: Dict[str, Any] = {}
    if scan and depth > 1:
        import jax

        attns, ffs = zip(*(layer(i) for i in range(depth)))
        encoder["blocks"] = {
            "attn": jax.tree.map(lambda *xs: jnp.stack(xs), *attns),
            "ff": jax.tree.map(lambda *xs: jnp.stack(xs), *ffs),
        }
    else:
        for i in range(depth):
            a, f = layer(i)
            encoder[f"attn_{i}"] = a
            encoder[f"ff_{i}"] = f

    return {
        "params": {
            "cls": p["cls"],
            "pos_embedding": p["pos_embedding"],
            "patch_embed": {
                "proj": {
                    "kernel": p["Dense_0"]["kernel"],
                    "bias": p["Dense_0"]["bias"],
                }
            },
            "encoder": encoder,
            "head_norm": {
                "scale": p["LayerNorm_0"]["scale"],
                "bias": p["LayerNorm_0"]["bias"],
            },
            "head": {
                "kernel": p["Dense_1"]["kernel"],
                "bias": p["Dense_1"]["bias"],
            },
        }
    }


def import_reference_region_vit_params(
    ref_params: Dict[str, Any], depths=(2, 2, 8, 2)
) -> Dict[str, Any]:
    """Map a reference ``region_vit_flax.py`` tree onto
    ``vitax.models.RegionViT(reference_quirks=True)``.

    Reference layout: Conv_0 = local 8x8/s4 encoder, Conv_1 = region 1x1
    projection (input is the channel-major space-to-depth of the local
    fmap, region_vit_flax.py:243-247), Downsample_{s-1} = the SHARED
    per-stage downsample (:250), R2LTransformer_{s} = {Embed_0 rel-pos
    table, Attention_i {LayerNorm_0 (no bias), Dense_0 qkv, Dense_1 out},
    MLP_i {LayerNorm_0 (no bias), Dense_0, Dense_1}}, LayerNorm_0 +
    Dense_0 = the to_logits head. Our LayerNorms carry a bias parameter;
    the reference's are bias-free, so those import as zeros (identical
    math).
    """
    import jax

    p = ref_params["params"] if "params" in ref_params else ref_params
    rk = p["Conv_1"]["kernel"]  # (1, 1, C*p^2, D)
    out: Dict[str, Any] = {
        "local_conv": {
            "kernel": p["Conv_0"]["kernel"],
            "bias": p["Conv_0"]["bias"],
        },
        "region_proj": {
            "kernel": rk.reshape(rk.shape[2], rk.shape[3]),
            "bias": p["Conv_1"]["bias"],
        },
        "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
        "head": {
            "kernel": p["Dense_0"]["kernel"],
            "bias": p["Dense_0"]["bias"],
        },
    }

    for s, depth in enumerate(depths):
        if s > 0:
            ds = p[f"Downsample_{s - 1}"]["Conv_0"]
            out[f"down_{s}"] = {
                "conv": {"kernel": ds["kernel"], "bias": ds["bias"]}
            }
        tr = p[f"R2LTransformer_{s}"]
        dim = tr["Attention_0"]["Dense_0"]["kernel"].shape[0]
        hidden = tr["MLP_0"]["Dense_0"]["kernel"].shape[1]

        def block(i, tr=tr, dim=dim, hidden=hidden):
            at, ml = tr[f"Attention_{i}"], tr[f"MLP_{i}"]
            return {
                "attn": {
                    "norm_scale": at["LayerNorm_0"]["scale"],
                    "norm_bias": jnp.zeros((dim,), jnp.float32),
                    "qkv_kernel": at["Dense_0"]["kernel"],
                    "out_kernel": at["Dense_1"]["kernel"],
                    "out_bias": at["Dense_1"]["bias"],
                },
                "ff": {
                    "ln_scale": ml["LayerNorm_0"]["scale"],
                    "ln_bias": jnp.zeros((dim,), jnp.float32),
                    "w1": ml["Dense_0"]["kernel"],
                    "b1": ml["Dense_0"]["bias"],
                    "w2": ml["Dense_1"]["kernel"],
                    "b2": ml["Dense_1"]["bias"],
                },
            }

        blocks = [block(i) for i in range(depth)]
        stage: Dict[str, Any] = {
            "rel_pos_bias": {
                "rel_pos_bias": {"embedding": tr["Embed_0"]["embedding"]}
            }
        }
        if depth > 1:  # scanned stage
            stage["blocks"] = jax.tree.map(lambda *xs: jnp.stack(xs), *blocks)
        else:
            stage["blocks"] = blocks[0]
        out[f"stage_{s}"] = stage
    return {"params": out}

"""Behavioral tests beyond forward shape: BN state handling, distillation
head, variable input resolution (CrossFormer's DPB), CaiT stochastic depth,
and PiT's working pooling (the reference's never ran, bug register #2)."""

import jax
import jax.numpy as jnp
import numpy as np

from vitax.models import CaiT, CrossFormer, CvT, LeViT, PiT


def test_levit_batchnorm_state_and_distill():
    model = LeViT(image_size=64, num_classes=10, stages=2, dim=(32, 32), depth=1,
                  heads=(1, 2), mlp_mult=2, dim_key=16, dim_value=16,
                  num_distill_classes=5)
    img = jax.random.normal(jax.random.PRNGKey(0), (2, 64, 64, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    assert "batch_stats" in variables

    # train mode updates the running stats
    (out, distill), new_state = model.apply(
        variables, img, True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(2)},
    )
    assert out.shape == (2, 10) and distill.shape == (2, 5)
    before = jax.tree.leaves(variables["batch_stats"])
    after = jax.tree.leaves(new_state["batch_stats"])
    assert any(not np.allclose(a, b) for a, b in zip(before, after))

    # inference uses stored stats, needs no mutability, is deterministic
    out1, _ = model.apply(variables, img)
    out2, _ = model.apply(variables, img)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))


def _randomize_bn_stats(variables, key):
    """init() leaves BN stats at (mean=0, var=1) — perturb them so the fold
    actually has something nontrivial to fold."""
    from vitax._vendor import flax

    def go(path, leaf):
        k = jax.random.fold_in(key, hash(path) % (2**31))
        if path[-1] == "mean":
            return jax.random.normal(k, leaf.shape) * 0.3
        return jnp.exp(jax.random.normal(k, leaf.shape) * 0.3)  # var > 0

    stats = jax.tree_util.tree_map_with_path(
        lambda p, l: go(tuple(str(x) for x in p), l), variables["batch_stats"]
    )
    return {**variables, "batch_stats": stats}


def test_bn_folding_cvt_matches_unfolded():
    from vitax.utils import fold_batch_norm

    model = CvT(num_classes=10, s1_emb_dim=16, s1_depth=1, s2_emb_dim=32,
                s2_depth=1, s3_emb_dim=32, s3_depth=1, s3_heads=2)
    img = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 32, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    variables = _randomize_bn_stats(variables, jax.random.PRNGKey(7))
    ref = model.apply(variables, img)

    folded_model, folded_vars = fold_batch_norm(model, variables)
    assert "batch_stats" not in folded_vars
    assert not any("bn" in str(p) for p in jax.tree_util.tree_leaves_with_path(
        folded_vars["params"]) for p in [p[0]])
    out = folded_model.apply(folded_vars, img)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_bn_folding_levit_matches_unfolded():
    from vitax.utils import fold_batch_norm

    model = LeViT(image_size=64, num_classes=10, stages=2, dim=(32, 32), depth=1,
                  heads=(1, 2), mlp_mult=2, dim_key=16, dim_value=16)
    img = jax.random.normal(jax.random.PRNGKey(0), (2, 64, 64, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    variables = _randomize_bn_stats(variables, jax.random.PRNGKey(8))
    ref = model.apply(variables, img)

    folded_model, folded_vars = fold_batch_norm(model, variables)
    out = folded_model.apply(folded_vars, img)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_mixed_precision_residual_dtype_tightens_numerics():
    """residual_dtype=float32 (the bench's parity config) must track the
    fp32 model strictly tighter than the all-bf16 stream does."""
    from vitax.models import ViT

    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=6,
               heads=4, mlp_dim=128, dim_head=16)
    img = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 32, 3))
    gold_model = ViT(**cfg)  # fp32 end-to-end
    variables = gold_model.init({"params": jax.random.PRNGKey(1)}, img)
    gold = np.asarray(gold_model.apply(variables, img), np.float64)

    bf16 = np.asarray(
        ViT(**cfg, dtype=jnp.bfloat16).apply(variables, img.astype(jnp.bfloat16)),
        np.float64)
    mixed = np.asarray(
        ViT(**cfg, dtype=jnp.bfloat16, residual_dtype=jnp.float32).apply(variables, img),
        np.float64)
    err_bf16 = np.max(np.abs(bf16 - gold))
    err_mixed = np.max(np.abs(mixed - gold))
    assert err_mixed < err_bf16, (err_mixed, err_bf16)


def test_pos_embedding_resolution_transfer():
    """A ViT trained at one resolution runs at another by interpolating its
    learned position table (utils.pos_embed) — a transform the reference
    cannot express (pos_embedding locked to init shape, vit.py:142)."""
    from vitax.models import ViT
    from vitax.utils import adapt_vit_resolution, interpolate_pos_embedding

    m64 = ViT(image_size=64, patch_size=16, num_classes=10, dim=32, depth=1,
              heads=2, mlp_dim=64, dim_head=16)
    img64 = jax.random.normal(jax.random.PRNGKey(0), (2, 64, 64, 3))
    v64 = m64.init({"params": jax.random.PRNGKey(1)}, img64)

    # identity at the same grid
    same = interpolate_pos_embedding(v64["params"]["pos_embedding"], (4, 4))
    np.testing.assert_allclose(np.asarray(same),
                               np.asarray(v64["params"]["pos_embedding"]), atol=1e-6)

    # transfer 64 -> 96 (grid 4x4 -> 6x6) and run
    p96 = adapt_vit_resolution(v64["params"], image_size=96, patch_size=16)
    assert p96["pos_embedding"].shape == (1, 1 + 36, 32)
    m96 = ViT(image_size=96, patch_size=16, num_classes=10, dim=32, depth=1,
              heads=2, mlp_dim=64, dim_head=16)
    img96 = jax.random.normal(jax.random.PRNGKey(2), (2, 96, 96, 3))
    out = m96.apply({"params": p96}, img96)
    assert out.shape == (2, 10)
    assert bool(jnp.isfinite(out).all())


def test_crossformer_variable_resolution():
    """DPB makes CrossFormer input-size flexible (README.md:94): the same
    params must run at a second resolution (window-compatible)."""
    model = CrossFormer(num_classes=10, dim=(32,), depth=(1,),
                        global_window_size=(4,), local_window_size=7,
                        cross_embed_kernel_sizes=((4, 8),),
                        cross_embed_strides=(4,))
    img1 = jax.random.normal(jax.random.PRNGKey(0), (1, 112, 112, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img1)
    out1 = model.apply(variables, img1)
    img2 = jax.random.normal(jax.random.PRNGKey(0), (1, 224, 224, 3))
    out2 = model.apply(variables, img2)  # same params, bigger fmaps
    assert out1.shape == out2.shape == (1, 10)


def test_cait_stochastic_depth_in_graph():
    model = CaiT(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2,
                 cls_depth=1, heads=2, mlp_dim=64, dim_head=16, layer_dropout=0.5)
    img = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    # different rng -> different subnetwork (in-graph gate; the reference's
    # fixed-PRNGKey(0) host-side dropout produced one mask forever)
    o1 = model.apply(variables, img, True, rngs={"dropout": jax.random.PRNGKey(2)})
    o2 = model.apply(variables, img, True, rngs={"dropout": jax.random.PRNGKey(3)})
    assert not np.allclose(np.asarray(o1), np.asarray(o2))
    # inference: gates off, deterministic
    d1 = model.apply(variables, img)
    d2 = model.apply(variables, img)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_pit_pools_tokens_and_doubles_dim():
    model = PiT(image_size=64, patch_size=8, num_classes=10, dim=32,
                depth=(1, 1), heads=2, mlp_dim=64, dim_head=16)
    img = jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    # the pool layer exists and projects to 2*dim
    pool = variables["params"]["pool_0"]
    assert pool["cls_proj"]["kernel"].shape == (32, 64)
    out = model.apply(variables, img)
    assert out.shape == (1, 10)


def test_scan_unroll_invariant():
    """scan_unroll_for only changes loop emission (nn.scan unroll), never the
    stacked parameter layout or the math — outputs and param trees must be
    identical at unroll=1 (loop) and unroll=depth (straight-line)."""
    import os

    from vitax.nn.blocks import Transformer

    x = jax.random.normal(jax.random.PRNGKey(0), (2, 17, 32))
    outs, shapes = [], []
    prior = os.environ.get("VITAX_SCAN_UNROLL")
    for unroll in ("1", "6"):
        os.environ["VITAX_SCAN_UNROLL"] = unroll
        try:
            m = Transformer(dim=32, depth=6, heads=2, dim_head=16, mlp_dim=64)
            p = m.init({"params": jax.random.PRNGKey(1)}, x)
            outs.append(m.apply(p, x))
            shapes.append(jax.tree.map(jnp.shape, p))
        finally:
            if prior is None:
                os.environ.pop("VITAX_SCAN_UNROLL", None)
            else:
                os.environ["VITAX_SCAN_UNROLL"] = prior
    assert shapes[0] == shapes[1]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=1e-6)


def _attention_layer_vs_block(layer, block_fn, n=33, dim=64):
    """One attention layer of the module against the matching
    ``vitax.ops`` block fed the layer's own parameters."""
    x = jax.random.normal(jax.random.PRNGKey(0), (2, n, dim))
    variables = layer.init({"params": jax.random.PRNGKey(1)}, x)
    p = variables["params"]
    ref = block_fn(x, p)
    np.testing.assert_allclose(
        np.asarray(layer.apply(variables, x)), np.asarray(ref), atol=2e-5, rtol=2e-4
    )


def test_deepvit_fused_reattention_branch_matches_xla():
    """DeepViT's re-attention layer (the module's materializing path)
    matches ``ops.reattention_block`` on the same parameters."""
    from vitax import ops
    from vitax.nn.attention import Attention

    _attention_layer_vs_block(
        Attention(dim=64, heads=4, dim_head=16, reattention=True, fuse_residual=True),
        lambda x, p: ops.reattention_block(
            x, p["norm_scale"], p["norm_bias"], p["qkv_kernel"], p["out_kernel"],
            p["out_bias"], p["reattn_weights"], p["reattn_scale"], p["reattn_bias"],
            4, scale=16**-0.5, ln_eps=1e-6,
        ),
    )


def test_cait_fused_talking_heads_branch_matches_xla():
    """CaiT's talking-heads layer (the module's materializing path) matches
    ``ops.talking_heads_block`` on the same parameters."""
    from vitax import ops
    from vitax.nn.attention import Attention

    _attention_layer_vs_block(
        Attention(dim=64, heads=4, dim_head=16, talking_heads=True, norm_eps=1e-5),
        lambda x, p: ops.talking_heads_block(
            x, p["norm_scale"], p["norm_bias"], p["qkv_kernel"], p["out_kernel"],
            p["out_bias"], p["mix_heads_pre"], p["mix_heads_post"], 4,
            scale=16**-0.5, ln_eps=1e-5,
        ),
    )


class TestLowQueryCrossAttention:
    """The reassociated low-query cross-attention path (round-5 CaiT lever):
    ``q(CW_k)^T = (qW_k^T)C^T`` and ``p(CW_v) = (pC)W_v`` must agree with
    the standard projection order and keep the Dense param tree."""

    def _paths(self, **kwargs):
        import jax
        import jax.numpy as jnp

        from vitax.nn.attention import Attention

        on = Attention(dim=128, heads=4, dim_head=32, lowq_cross=True, **kwargs)
        off = Attention(dim=128, heads=4, dim_head=32, lowq_cross=False, **kwargs)
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 1, 128))
        ctx = jax.random.normal(jax.random.PRNGKey(1), (2, 65, 128))
        v_on = on.init({"params": jax.random.PRNGKey(2)}, x, ctx, True)
        v_off = off.init({"params": jax.random.PRNGKey(2)}, x, ctx, True)
        return on, off, v_on, v_off, x, ctx

    def test_param_tree_identical(self):
        import jax

        _, _, v_on, v_off, _, _ = self._paths()
        t_on = jax.tree_util.tree_structure(v_on)
        t_off = jax.tree_util.tree_structure(v_off)
        assert t_on == t_off
        shapes_on = jax.tree_util.tree_map(lambda a: a.shape, v_on)
        shapes_off = jax.tree_util.tree_map(lambda a: a.shape, v_off)
        assert shapes_on == shapes_off

    def test_matches_standard_order(self):
        import numpy as np

        on, off, v_on, _, x, ctx = self._paths()
        out_on = on.apply(v_on, x, ctx, True)
        out_off = off.apply(v_on, x, ctx, True)
        np.testing.assert_allclose(
            np.asarray(out_on), np.asarray(out_off), atol=2e-5, rtol=2e-5
        )

    def test_matches_standard_order_talking_heads(self):
        import numpy as np

        on, off, v_on, _, x, ctx = self._paths(talking_heads=True)
        out_on = on.apply(v_on, x, ctx, True)
        out_off = off.apply(v_on, x, ctx, True)
        np.testing.assert_allclose(
            np.asarray(out_on), np.asarray(out_off), atol=2e-5, rtol=2e-5
        )

    def test_grads_match_standard_order(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        on, off, v_on, _, x, ctx = self._paths(talking_heads=True)

        def loss(m, v, a, c):
            return jnp.sum(m.apply(v, a, c, True) ** 2)

        g_on = jax.grad(loss, argnums=1)(on, v_on, x, ctx)
        g_off = jax.grad(loss, argnums=1)(off, v_on, x, ctx)
        flat_on = jax.tree_util.tree_leaves(g_on)
        flat_off = jax.tree_util.tree_leaves(g_off)
        for a, b in zip(flat_on, flat_off):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=5e-4, rtol=5e-4
            )

    def test_auto_gate_on_cait_shape(self):
        """dim 1024 / 65-token context / 1 query: the FLOP gate must fire."""
        n_q, n_kv, inner = 1, 65, 1024
        assert 4 * n_q * (inner + n_kv) <= n_kv * inner
        # a 64-query, 64-token context must NOT fire (reassoc would lose)
        assert not (4 * 64 * (inner + 64) <= 64 * inner)

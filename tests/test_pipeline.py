"""Pipeline parallelism on the 8-device virtual CPU mesh: the GPipe
schedule's logits and gradients must match the unpipelined model exactly,
and the per-tick activation transfer must be a collective-permute in the
compiled HLO (not an all-to-all or gather)."""

import jax
import jax.numpy as jnp
import numpy as np

from vitax.models import ViT
from vitax.parallel.pipeline import (
    make_pipeline_mesh,
    pipeline_vit_apply,
    spmd_pipeline,
)

MODEL = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=4,
            heads=4, mlp_dim=128, dim_head=16)


def _init(batch=8):
    img = jax.random.normal(jax.random.PRNGKey(0), (batch, 32, 32, 3))
    variables = MODEL.init({"params": jax.random.PRNGKey(1)}, img)
    return variables, img


def test_pipeline_forward_matches_single_device():
    variables, img = _init(batch=8)
    mesh = make_pipeline_mesh(n_pipe=4, n_data=2)  # dp x pp
    fn = jax.jit(lambda v, im: pipeline_vit_apply(MODEL, v, im, mesh, n_micro=4))
    out_pp = fn(variables, img)
    out_ref = MODEL.apply(variables, img)
    np.testing.assert_allclose(
        np.asarray(out_pp), np.asarray(out_ref), atol=1e-5, rtol=1e-5
    )


def test_pipeline_pure_pipe_and_extra_microbatches():
    # pp only (no data axis), more microbatches than stages (smaller bubble)
    variables, img = _init(batch=8)
    mesh = make_pipeline_mesh(n_pipe=4, n_data=1)
    fn = jax.jit(lambda v, im: pipeline_vit_apply(MODEL, v, im, mesh, n_micro=8))
    out_pp = fn(variables, img)
    out_ref = MODEL.apply(variables, img)
    np.testing.assert_allclose(
        np.asarray(out_pp), np.asarray(out_ref), atol=1e-5, rtol=1e-5
    )


def test_pipeline_transfer_is_collective_permute():
    variables, img = _init(batch=8)
    mesh = make_pipeline_mesh(n_pipe=4, n_data=2)
    fn = jax.jit(lambda v, im: pipeline_vit_apply(MODEL, v, im, mesh, n_micro=4))
    hlo = fn.lower(variables, img).compile().as_text()
    assert "collective-permute" in hlo  # stage-to-stage activation handoff
    assert "all-to-all" not in hlo


def test_pipeline_gradients_match_unpipelined():
    variables, img = _init(batch=8)
    mesh = make_pipeline_mesh(n_pipe=4, n_data=2)

    def loss_pp(params):
        logits = pipeline_vit_apply(MODEL, {"params": params}, img, mesh, n_micro=4)
        return jnp.mean(logits**2)

    def loss_ref(params):
        return jnp.mean(MODEL.apply({"params": params}, img) ** 2)

    g_pp = jax.jit(jax.grad(loss_pp))(variables["params"])
    g_ref = jax.jit(jax.grad(loss_ref))(variables["params"])
    flat_pp = jax.tree_util.tree_leaves_with_path(g_pp)
    flat_ref = dict(
        (jax.tree_util.keystr(p), v)
        for p, v in jax.tree_util.tree_leaves_with_path(g_ref)
    )
    assert flat_pp
    for path, v in flat_pp:
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(flat_ref[jax.tree_util.keystr(path)]),
            atol=1e-5, rtol=1e-4, err_msg=jax.tree_util.keystr(path),
        )


def test_spmd_pipeline_generic_blocks():
    # the generic scheduler on a plain stacked-linear stack: y = x @ W_i + b_i
    depth, dim, batch = 8, 16, 8
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    params = {
        "w": jax.random.normal(k1, (depth, dim, dim)) * 0.1,
        "b": jax.random.normal(k2, (depth, dim)) * 0.1,
    }
    x = jax.random.normal(k3, (batch, dim))

    def block_fn(p, xv):
        return jnp.tanh(xv @ p["w"] + p["b"])

    mesh = make_pipeline_mesh(n_pipe=4, n_data=2)
    out = jax.jit(
        lambda pr, xv: spmd_pipeline(block_fn, pr, xv, mesh, n_micro=4)
    )(params, x)

    ref = x
    for i in range(depth):
        ref = block_fn(jax.tree.map(lambda a: a[i], params), ref)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_pipeline_qkv_bias_model_matches_single_device():
    """The HF/timm-imported config (qkv_bias=True, the flax-submodule
    attention layout) pipelines too and matches the single-device forward."""
    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=4,
                heads=4, mlp_dim=128, dim_head=16, qkv_bias=True)
    img = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    mesh = make_pipeline_mesh(n_pipe=4, n_data=2)
    fn = jax.jit(lambda v, im: pipeline_vit_apply(model, v, im, mesh, n_micro=4))
    np.testing.assert_allclose(
        np.asarray(fn(variables, img)), np.asarray(model.apply(variables, img)),
        atol=1e-5, rtol=1e-5,
    )


def test_pipeline3d_dp_pp_tp_matches_single_device():
    """3D parallelism in one program: batch over data (2), depth over pipe
    (2), every block's GEMMs tensor-sharded over model (2 — Megatron
    column/row split with in-stage psums). Logits must match the
    unpipelined single-device apply, and the compiled HLO must carry BOTH
    collective classes: the pipe ppermute (collective-permute) and the
    tp reduction (all-reduce)."""
    from vitax.parallel.pipeline import (
        make_pipeline3d_mesh,
        pipeline_tp_vit_apply,
    )

    variables, img = _init(batch=8)
    mesh = make_pipeline3d_mesh(n_pipe=2, n_data=2, n_model=2)
    fn = jax.jit(lambda v, im: pipeline_tp_vit_apply(MODEL, v, im, mesh, n_micro=2))
    out = fn(variables, img)
    ref = MODEL.apply(variables, img)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)

    hlo = fn.lower(variables, img).compile().as_text()
    assert "collective-permute" in hlo  # pipe handoff
    # "all-reduce in hlo" alone is vacuous — the GPipe output psum over
    # `pipe` is one all-reduce in EVERY pipelined program (verified: the
    # tp-free pipeline_vit_apply HLO contains it too). The two Megatron
    # psums over `model` inside the tick scan push the 3D program to >= 3.
    tp_free = jax.jit(
        lambda v, im: pipeline_vit_apply(
            MODEL, v, im, make_pipeline_mesh(n_pipe=2, n_data=2), n_micro=2
        )
    )
    base = tp_free.lower(variables, img).compile().as_text().count("all-reduce")
    assert hlo.count("all-reduce") > base >= 1, (
        hlo.count("all-reduce"), base
    )


def test_pipeline3d_head_sharding_is_whole_heads():
    """The tp split must shard WHOLE heads of the [q|k|v] fused kernel:
    with model=4 and 4 heads each shard owns one head, and the result
    still matches the unpipelined apply (a wrong column split would mix
    q/k/v sections and diverge wildly)."""
    from vitax.parallel.pipeline import (
        make_pipeline3d_mesh,
        pipeline_tp_vit_apply,
    )

    variables, img = _init(batch=4)
    mesh = make_pipeline3d_mesh(n_pipe=2, n_data=1, n_model=4)
    out = jax.jit(
        lambda v, im: pipeline_tp_vit_apply(MODEL, v, im, mesh, n_micro=2)
    )(variables, img)
    ref = MODEL.apply(variables, img)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_pipeline3d_gradients_match_unpipelined():
    """jax.grad through the 3D (dp x pp x tp) forward must equal the
    single-device gradients: the GPipe scan, the stage ppermute, and the
    Megatron psums all transpose correctly, so the 3D path is trainable
    as-is (measured 4e-6 max leaf error on first run)."""
    from vitax.parallel.pipeline import (
        make_pipeline3d_mesh,
        pipeline_tp_vit_apply,
    )

    variables, img = _init(batch=8)
    labels = jnp.arange(8) % 10
    mesh = make_pipeline3d_mesh(n_pipe=2, n_data=2, n_model=2)

    def nll(logits, lb):
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(lb.shape[0]), lb])

    g3 = jax.jit(jax.grad(
        lambda p, im, lb: nll(
            pipeline_tp_vit_apply(MODEL, {"params": p}, im, mesh, n_micro=2), lb
        )
    ))(variables["params"], img, labels)
    g1 = jax.jit(jax.grad(
        lambda p, im, lb: nll(MODEL.apply({"params": p}, im), lb)
    ))(variables["params"], img, labels)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5, rtol=2e-5
        ),
        g3, g1,
    )


def test_pipeline3d_train_step_learns():
    """The packaged 3D train step (optimizer included) drives the loss down
    on a fixed batch through the dp x pp x tp forward/backward."""
    from vitax.parallel.pipeline import (
        make_pipeline3d_mesh,
        make_pipeline3d_train_step,
    )
    from vitax.train import create_train_state, make_optimizer

    variables, img = _init(batch=8)
    labels = jnp.arange(8) % 10
    mesh = make_pipeline3d_mesh(n_pipe=2, n_data=2, n_model=2)
    state = create_train_state(
        MODEL, jax.random.PRNGKey(2), img[:1], optimizer=make_optimizer(1e-2)
    )
    step = make_pipeline3d_train_step(
        MODEL, mesh, make_optimizer(1e-2), n_micro=2
    )
    losses = []
    for _ in range(4):
        state, loss = step(state, img, labels)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses

"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4):
data-parallel inference matches single-device, TP specs land on the right
params, the sharded train step runs and reduces loss, and collective
placement is inspectable in the compiled HLO."""

import jax
import jax.numpy as jnp
import numpy as np

from vitax.models import ViT
from vitax.parallel import data_parallel_apply, make_mesh, tp_param_specs
from vitax.train import create_train_state, make_train_step, shard_batch  # noqa

MODEL = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
            heads=4, mlp_dim=128, dim_head=16)


def _init(batch=8):
    img = jax.random.normal(jax.random.PRNGKey(0), (batch, 32, 32, 3))
    variables = MODEL.init({"params": jax.random.PRNGKey(1)}, img)
    return variables, img


def test_data_parallel_matches_single_device():
    variables, img = _init(batch=8)
    mesh = make_mesh()  # 8-way data parallel
    fn = data_parallel_apply(MODEL, mesh)
    out_dp = fn(variables, img)
    out_ref = MODEL.apply(variables, img)
    np.testing.assert_allclose(np.asarray(out_dp), np.asarray(out_ref), atol=1e-5, rtol=1e-5)


def test_dp_head_gather_is_only_collective():
    variables, img = _init(batch=8)
    mesh = make_mesh()
    fn = data_parallel_apply(MODEL, mesh)
    hlo = fn.lower(variables, img).compile().as_text()
    # exactly the classifier-head all-gather; no other cross-device traffic
    assert "all-gather" in hlo
    assert "all-reduce" not in hlo
    assert "collective-permute" not in hlo


def test_tp_specs_match_rules():
    variables, _ = _init()
    specs = tp_param_specs(variables["params"])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    qkv = [s for p, s in flat.items() if p.endswith("qkv_kernel")]
    # scanned encoder: kernels carry a leading (unsharded) depth axis
    assert qkv and all(s[-1] == "model" and all(a is None for a in s[:-1]) for s in qkv)
    w2 = [s for p, s in flat.items() if p.endswith("/w2")]
    assert w2 and all(s[-2] == "model" and s[-1] is None for s in w2)
    heads = [s for p, s in flat.items() if p.startswith("head/")]
    assert all(s == jax.sharding.PartitionSpec() for s in heads)


def test_sharded_train_step_runs_and_learns():
    mesh = make_mesh(n_data=4, n_model=2)
    img = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3))
    labels = jnp.arange(8) % 10
    state = create_train_state(MODEL, jax.random.PRNGKey(1), img[:1], mesh=mesh)
    step = make_train_step(MODEL)
    img_s = shard_batch(img, mesh)
    labels_s = shard_batch(labels, mesh)
    losses = []
    for _ in range(5):
        state, loss = step(state, img_s, labels_s)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 5
    # params kept their TP shardings through the step
    qkv = state.params["encoder"]["blocks"]["attn"]["qkv_kernel"]
    assert "model" in str(qkv.sharding.spec)


def test_train_step_batchnorm_model():
    """CvT trains: BatchNorm state threads through the jitted step."""
    from vitax.models import CvT

    model = CvT(num_classes=10, s1_emb_dim=8, s1_depth=1, s2_emb_dim=16,
                s2_depth=1, s3_emb_dim=16, s3_depth=1, s3_heads=2)
    img = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 32, 3))
    labels = jnp.arange(4) % 10
    state = create_train_state(model, jax.random.PRNGKey(1), img[:1])
    assert "batch_stats" in state.model_state
    step = make_train_step(model)
    before = jax.tree.leaves(state.model_state["batch_stats"])
    losses = []
    for _ in range(4):
        state, loss = step(state, img, labels)
        losses.append(float(loss))
    after = jax.tree.leaves(state.model_state["batch_stats"])
    assert losses[-1] < losses[0], losses
    assert any(not np.allclose(a, b) for a, b in zip(before, after))


def test_shard_map_train_step_kernels_on():
    """The shard_map dp train step (a complete per-device program with
    explicit gradient pmeans) learns on the 8-device CPU mesh and agrees
    with the GSPMD step on the same state/batch."""
    from vitax.train import make_shard_map_train_step

    mesh = make_mesh()  # 8-way data parallel
    img = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3))
    labels = jnp.arange(8) % 10

    state = create_train_state(MODEL, jax.random.PRNGKey(1), img[:1])
    imgs = shard_batch(img, mesh)
    lbls = shard_batch(labels, mesh)

    gspmd_step = make_train_step(MODEL)
    _, loss_gspmd = gspmd_step(state, img, labels)

    step = make_shard_map_train_step(MODEL, mesh)
    new_state, loss0 = step(state, imgs, lbls)
    _, loss1 = step(new_state, imgs, lbls)

    # same math as the GSPMD step (different reduction order)
    np.testing.assert_allclose(float(loss0), float(loss_gspmd), atol=1e-3, rtol=1e-3)
    assert float(loss1) < float(loss0)  # one optimizer step reduces loss
    leaves = jax.tree_util.tree_leaves(new_state.params)
    assert all(bool(jnp.isfinite(l).all()) for l in leaves)
    # params actually moved
    diff = jax.tree.map(lambda a, b: float(jnp.max(jnp.abs(a - b))),
                        new_state.params, state.params)
    assert max(jax.tree_util.tree_leaves(diff)) > 0


def test_ring_attention_matches_single_device():
    """Sequence-parallel ring attention on the 8-device mesh: K/V rotate
    neighbor-to-neighbor (collective-permute in the HLO, no all-gather of
    K/V) and the result matches single-device attention."""
    from vitax.ops import reference_attention
    from vitax.parallel import ring_attention

    b, h, n, d = 2, 4, 8 * 37, 32  # N divides the 8-way ring
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, n, d))
    mesh = make_mesh()  # 8-way on the data axis

    out = ring_attention(q, k, v, mesh)
    ref = reference_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_ring_attention_differentiable():
    """The ring is a lax.scan over ppermute steps, so jax.grad works —
    sequence-parallel attention can sit inside a train step."""
    from vitax.ops import reference_attention
    from vitax.parallel import ring_attention

    b, h, n, d = 1, 2, 8 * 8, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, n, d))
    mesh = make_mesh()

    g_ring = jax.grad(lambda q, k, v: jnp.sum(ring_attention(q, k, v, mesh) ** 2),
                      argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(lambda q, k, v: jnp.sum(reference_attention(q, k, v) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    for a, b_ in zip(g_ring, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_), atol=1e-5, rtol=1e-5)


def test_ring_attention_collective_is_permute_only():
    from vitax.parallel import ring_attention

    mesh = make_mesh()
    b, h, n, d = 1, 2, 8 * 16, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, n, d))

    hlo = jax.jit(
        lambda q, k, v: ring_attention(q, k, v, mesh)
    ).lower(q, k, v).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo


def test_training_ergonomics_schedule_clip_eval():
    """Warmup+cosine schedule, gradient clipping, and the top-1 eval step
    (VERDICT r2 item 7) wire into the standard train step."""
    from vitax.train import (
        make_eval_step, make_optimizer, top1_accuracy, warmup_cosine_schedule,
    )

    sched = warmup_cosine_schedule(1e-3, total_steps=100, warmup_steps=10)
    assert float(sched(0)) == 0.0
    assert abs(float(sched(10)) - 1e-3) < 1e-9  # peak at end of warmup
    assert float(sched(100)) < 1e-5  # cosine-decayed to ~0
    assert abs(float(sched(5)) - 0.5e-3) < 1e-9  # linear warmup

    # clipping caps the global grad norm
    import optax
    tx = make_optimizer(sched, grad_clip_norm=1.0)
    params = {"w": jnp.ones((4,))}
    big_grads = {"w": jnp.full((4,), 100.0)}
    opt_state = tx.init(params)
    updates, _ = tx.update(big_grads, opt_state, params)
    assert bool(jnp.all(jnp.isfinite(updates["w"])))

    # top-1 + eval step
    logits = jnp.array([[0.1, 2.0, -1.0], [3.0, 0.0, 0.0]])
    assert float(top1_accuracy(logits, jnp.array([1, 0]))) == 1.0
    assert float(top1_accuracy(logits, jnp.array([0, 0]))) == 0.5

    img = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 32, 3))
    labels = jnp.arange(4) % 10
    variables = MODEL.init({"params": jax.random.PRNGKey(1)}, img)
    loss, top1 = make_eval_step(MODEL)(variables, img, labels)
    assert bool(jnp.isfinite(loss)) and 0.0 <= float(top1) <= 1.0

    # the full step accepts the scheduled+clipped optimizer and learns
    state = create_train_state(MODEL, jax.random.PRNGKey(1), img[:1], optimizer=tx)
    step = make_train_step(MODEL, optimizer=tx)
    losses = []
    for _ in range(4):
        state, l = step(state, img, labels)
        losses.append(float(l))
    assert losses[-1] < losses[0], losses


def _assert_dp_tp_roundtrip(model, state, img, labels, mesh, *, fwd_tol=1e-4):
    """Shared dp x tp assertions (VERDICT r2 item 6): the train step's HLO
    carries cross-device reduction, and the sharded forward matches the
    same params gathered onto one device."""
    step = make_train_step(model)
    imgs_s, labels_s = shard_batch(img, mesh), shard_batch(labels, mesh)
    hlo = step.lower(state, imgs_s, labels_s).compile().as_text()
    assert "all-reduce" in hlo, "no all-reduce/psum in the dp x tp train step HLO"

    new_state, loss = step(state, imgs_s, labels_s)
    assert bool(jnp.isfinite(loss)), float(loss)

    variables = {"params": state.params, **state.model_state}
    fwd = jax.jit(lambda v, x: model.apply(v, x))
    logits_sharded = jax.device_get(fwd(variables, imgs_s))
    logits_single = jax.device_get(fwd(jax.device_get(variables), jax.device_get(img)))
    err = float(np.max(np.abs(logits_sharded - logits_single)))
    assert err <= fwd_tol, f"sharded-vs-single forward mismatch: {err}"
    return new_state


def test_dp_tp_crossformer():
    """TP beyond ViT: a window family. qkv/w1/w2 shardings land on the
    staged window-attention params and the dp x tp step communicates."""
    from vitax.models import CrossFormer

    model = CrossFormer(num_classes=10, dim=(32, 64), depth=(1, 1),
                        global_window_size=(4, 2), local_window_size=7,
                        cross_embed_kernel_sizes=((4, 8), (2, 4)),
                        cross_embed_strides=(4, 2))
    img = jax.random.normal(jax.random.PRNGKey(0), (8, 112, 112, 3))
    labels = jnp.arange(8) % 10
    mesh = make_mesh(n_data=4, n_model=2)
    state = create_train_state(model, jax.random.PRNGKey(1), img[:1], mesh=mesh)

    sda = state.params["stage_0"]["sda"]
    assert "model" in str(sda["qkv_kernel"].sharding.spec)
    assert "model" in str(sda["out_kernel"].sharding.spec)
    assert "model" in str(state.params["stage_0"]["mlp1"]["ff"]["w2"].sharding.spec)

    _assert_dp_tp_roundtrip(model, state, img, labels, mesh)


def test_dp_tp_cvt_with_batchnorm_state():
    """TP beyond ViT: a BN model. The conv-projection attention's pointwise
    kernels shard over heads, batch_stats thread (replicated) through the
    GSPMD step, and sharded-vs-single logits agree."""
    from vitax.models import CvT

    model = CvT(num_classes=10, s1_emb_dim=16, s1_depth=1, s2_emb_dim=32,
                s2_depth=1, s3_emb_dim=32, s3_depth=1, s3_heads=2)
    img = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3))
    labels = jnp.arange(8) % 10
    mesh = make_mesh(n_data=4, n_model=2)
    state = create_train_state(model, jax.random.PRNGKey(1), img[:1], mesh=mesh)
    assert "batch_stats" in state.model_state

    attn = state.params["attn_3_0"]
    assert "model" in str(attn["to_q"]["pointwise"]["kernel"].sharding.spec)
    assert "model" in str(attn["to_kv"]["pointwise"]["kernel"].sharding.spec)
    assert "model" in str(attn["to_out"]["kernel"].sharding.spec)

    before = jax.tree.leaves(jax.device_get(state.model_state["batch_stats"]))
    new_state = _assert_dp_tp_roundtrip(model, state, img, labels, mesh)
    after = jax.tree.leaves(jax.device_get(new_state.model_state["batch_stats"]))
    assert any(not np.allclose(a, b) for a, b in zip(before, after)), \
        "batch_stats did not update through the sharded step"


def test_gspmd_train_step_with_dropout_and_remat():
    """Regression: nn.remat static_argnums counts `self` as 0 — marking
    index 1 froze the scan carry and left `deterministic` traced, crashing
    every dropout>0 model inside make_train_step (TracerBoolConversionError)."""
    import jax
    import jax.numpy as jnp

    from vitax.models import ViT
    from vitax.train import create_train_state, make_train_step

    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
                heads=4, mlp_dim=128, dim_head=16, dropout=0.1)
    img = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 32, 3))
    labels = jnp.arange(4) % 10
    state = create_train_state(model, jax.random.PRNGKey(1), img[:1])
    step = make_train_step(model)
    state, loss = step(state, img, labels)
    assert jnp.isfinite(loss)
    # and the opt-out path compiles too
    step_noremat = make_train_step(model, remat=False)
    _, loss2 = step_noremat(state, img, labels)
    assert jnp.isfinite(loss2)


def test_ring_attention_masks_padded_columns():
    """true_n masks padded global key columns in-ring, including pad tails
    that span WHOLE shards (n=24 over 8 shards with true_n=17: shard 5 is
    partially masked, shards 6-7 fully — the finite -1e30 mask keeps the
    online-softmax rescale NaN-free). Real rows must equal single-device
    attention over just the real keys."""
    from vitax.ops import reference_attention
    from vitax.parallel import ring_attention
    from vitax.parallel.mesh import make_mesh

    b, h, n, d, true_n = 2, 2, 24, 16, 17
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, n, d))
    mesh = make_mesh(n_data=8, n_model=1)
    out = ring_attention(q, k, v, mesh, true_n=true_n)
    ref = reference_attention(q[:, :, :true_n], k[:, :, :true_n], v[:, :, :true_n])
    np.testing.assert_allclose(
        np.asarray(out)[:, :, :true_n], np.asarray(ref), atol=1e-5, rtol=1e-5
    )


def test_ring_vit_apply_matches_single_device():
    """Sequence parallelism composed into the full model: the token axis
    stays sharded through LN/qkv/MLP (zero comm) and crosses shards only
    via the ring (ppermute in HLO). Logits AND gradients match the
    single-device apply; n=17 pads to 24 so two shards carry only pad."""
    from vitax.models import ViT
    from vitax.parallel import ring_vit_apply
    from vitax.parallel.mesh import make_mesh

    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=64,
                depth=3, heads=4, mlp_dim=128, dim_head=16)
    img = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 32, 3))
    variables = model.init({"params": jax.random.PRNGKey(1)}, img)
    mesh = make_mesh(n_data=8, n_model=1)

    fn = jax.jit(lambda p, im: ring_vit_apply(model, p, im, mesh))
    out = fn(variables, img)
    ref = model.apply(variables, img)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
    hlo = fn.lower(variables, img).compile().as_text()
    assert "collective-permute" in hlo

    # "no all-gather of K/V / row-wise ops zero-comm": any gathers must be
    # head-only constants, so their count must NOT grow with depth — a lost
    # sharding constraint would gather the token axis once per layer
    deep = ViT(image_size=32, patch_size=8, num_classes=10, dim=64,
               depth=6, heads=4, mlp_dim=128, dim_head=16)
    v6 = deep.init({"params": jax.random.PRNGKey(1)}, img)
    hlo6 = jax.jit(
        lambda p, im: ring_vit_apply(deep, p, im, mesh)
    ).lower(v6, img).compile().as_text()
    assert hlo6.count("all-gather") == hlo.count("all-gather"), (
        hlo.count("all-gather"), hlo6.count("all-gather")
    )

    # bf16 stream: the shared raw_block_apply epilogue rounds the attention
    # residual to the stream dtype exactly like the fused kernel, so the
    # bf16 config tracks model.apply within bf16 accumulation noise
    bf16 = ViT(image_size=32, patch_size=8, num_classes=10, dim=64,
               depth=3, heads=4, mlp_dim=128, dim_head=16,
               dtype=jnp.bfloat16)
    vb = bf16.init({"params": jax.random.PRNGKey(1)}, img)
    out_b = jax.jit(lambda p, im: ring_vit_apply(bf16, p, im, mesh))(vb, img)
    ref_b = bf16.apply(vb, img)
    np.testing.assert_allclose(
        np.asarray(out_b, np.float32), np.asarray(ref_b, np.float32),
        atol=5e-2, rtol=5e-2,
    )

    def nll(apply_fn, p, im):
        return -jnp.mean(jax.nn.log_softmax(apply_fn(p, im))[:, 0])

    g_sp = jax.jit(jax.grad(
        lambda p, im: nll(lambda p_, im_: ring_vit_apply(model, p_, im_, mesh), p, im)
    ))(variables, img)
    g_1d = jax.jit(jax.grad(
        lambda p, im: nll(model.apply, p, im)
    ))(variables, img)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5, rtol=2e-5
        ),
        g_sp, g_1d,
    )

"""MoE / expert parallelism: the GShard-style einsum dispatch must equal a
per-token routed reference, capacity overflow must degrade to the residual
passthrough, and the expert tables must shard over the model axis and
train under the stock GSPMD step on a dp×ep mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from vitax.models.vit_moe import ViTMoE
from vitax.nn.blocks import _layer_norm
from vitax.nn.moe import MoEFeedForward
from vitax.parallel import make_mesh, tp_param_specs


def _moe(capacity_factor, e=4, k=2):
    return MoEFeedForward(
        dim=16, hidden_dim=32, num_experts=e, num_selected=k,
        capacity_factor=capacity_factor,
    )


def test_moe_matches_per_token_reference():
    mod = _moe(capacity_factor=100.0)  # capacity = full sequence: no drops
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 10, 16))
    variables = mod.init({"params": jax.random.PRNGKey(1)}, x)
    y = mod.apply(variables, x)

    p = variables["params"]
    xn = _layer_norm(x, p["ln_scale"], p["ln_bias"], 1e-6)
    probs = jax.nn.softmax(
        xn @ p["router"]["kernel"] + p["router"]["bias"], axis=-1
    )
    ref = np.zeros_like(np.asarray(x))
    probs_np = np.asarray(probs)
    xn_np = np.asarray(xn)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            order = np.argsort(-probs_np[b, s])[:2]
            gates = probs_np[b, s][order]
            gates = gates / (gates.sum() + 1e-9)
            for g, eidx in zip(gates, order):
                h = xn_np[b, s] @ np.asarray(p["expert_w1"])[eidx]
                h = h + np.asarray(p["expert_b1"])[eidx]
                h = np.asarray(jax.nn.gelu(jnp.asarray(h)))
                o = h @ np.asarray(p["expert_w2"])[eidx] + np.asarray(p["expert_b2"])[eidx]
                ref[b, s] += g * o
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5, rtol=1e-4)


def test_moe_capacity_overflow_drops_to_passthrough():
    # one expert, one slot: only the first token gets a nonzero delta
    mod = _moe(capacity_factor=1e-9, e=1, k=1)
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 6, 16))
    variables = mod.init({"params": jax.random.PRNGKey(1)}, x)
    y = np.asarray(mod.apply(variables, x))
    assert np.abs(y[0, 0]).max() > 0
    np.testing.assert_array_equal(y[0, 1:], 0.0)


def test_moe_aux_loss_sown():
    mod = _moe(capacity_factor=2.0)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 10, 16))
    variables = mod.init({"params": jax.random.PRNGKey(1)}, x)
    _, inter = mod.apply(variables, x, mutable=["intermediates"])
    (aux,) = inter["intermediates"]["moe_aux_loss"]
    assert np.isfinite(float(aux)) and float(aux) >= 1.0 - 1e-6  # >=1 by Cauchy-Schwarz at k=1 routing


MODEL = ViTMoE(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2,
               heads=4, mlp_dim=64, dim_head=8, num_experts=4, num_selected=2,
               moe_every=2)


def test_vitmoe_ep_shards_and_trains_on_dp_ep_mesh():
    from vitax.train import create_train_state, make_train_step, shard_batch

    img = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3))
    labels = jnp.arange(8) % 10
    variables = MODEL.init({"params": jax.random.PRNGKey(1)}, img[:1])

    # the expert tables' leading E axis lands on the model axis
    specs = tp_param_specs(variables["params"])
    flat = {
        "/".join(str(getattr(kk, "key", kk)) for kk in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]
    }
    ew1 = [s for pth, s in flat.items() if pth.endswith("expert_w1")]
    assert ew1 and all(s[0] == "model" for s in ew1)

    mesh = make_mesh(n_data=4, n_model=2)
    state = create_train_state(MODEL, jax.random.PRNGKey(2), img[:1], mesh=mesh)
    step = make_train_step(MODEL)
    imgs_s, labels_s = shard_batch(img, mesh), shard_batch(labels, mesh)
    losses = []
    for _ in range(3):
        state, loss = step(state, imgs_s, labels_s)
        losses.append(float(loss))
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]  # it learns

    # sharded forward == single-device forward
    fwd = jax.jit(lambda v, x: MODEL.apply(v, x))
    out_s = np.asarray(fwd({"params": state.params}, imgs_s))
    out_1 = np.asarray(
        fwd(jax.device_get({"params": state.params}), jax.device_get(img))
    )
    np.testing.assert_allclose(out_s, out_1, atol=1e-4, rtol=1e-4)


def test_moe_aux_loss_enters_training_loss():
    from vitax.train import create_train_state, make_train_step

    img = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 32, 3))
    labels = jnp.arange(4) % 10
    state = create_train_state(MODEL, jax.random.PRNGKey(2), img[:1])
    _, loss_plain = make_train_step(MODEL)(state, img, labels)
    _, loss_aux = make_train_step(MODEL, moe_aux_weight=0.5)(state, img, labels)
    # same params, same batch: the difference is exactly the weighted aux
    # term, which is >= ~1 for any routing (Switch aux at perfect balance)
    assert float(loss_aux) > float(loss_plain) + 0.3
    assert np.isfinite(float(loss_aux))

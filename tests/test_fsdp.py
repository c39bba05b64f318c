"""FSDP (ZeRO-3-style fully-sharded parameters): the data axis shards the
params and optimizer moments too, GSPMD inserts the gather/scatter
collectives, and training matches the replicated run
(parallel/sharding.py fsdp_param_specs; SURVEY.md §2.3 — the reference has
no distributed code at all).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from vitax.models import ViT
from vitax.parallel import fsdp_param_specs, make_mesh
from vitax.train import create_train_state, make_train_step, shard_batch

CFG = dict(image_size=32, patch_size=8, num_classes=4, dim=128, depth=2,
           heads=4, mlp_dim=256, dim_head=32)


def make_batch(i, n=8):
    key = jax.random.PRNGKey(50 + i)
    return (jax.random.normal(key, (n, 32, 32, 3), jnp.float32),
            jnp.arange(n) % 4)


def _flat_with_paths(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path), leaf


def test_fsdp_specs_compose_with_tp():
    mesh = make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8])
    model = ViT(**CFG)
    params = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 32, 32, 3)))
    )["params"]
    specs = fsdp_param_specs(params, mesh)
    flat = dict(_flat_with_paths(specs))

    qkv = [s for p, s in flat.items() if p.endswith("qkv_kernel")]
    assert qkv, "no qkv kernels found"
    for s in qkv:
        # TP keeps the head dim, FSDP takes the largest free dim
        assert s[-1] == "model" and "data" in s, s
    # small leaves (norm scales, cls, pos tables) stay off the data axis:
    # gathering them costs more latency than their bytes save
    small = [s for p, s in flat.items() if p.endswith("cls")]
    assert small and all("data" not in s for s in small)


def test_fsdp_shards_memory_and_matches_replicated_training():
    """Per-device param/moment bytes divide by the data axis, the compiled
    step all-gathers weights, and two FSDP train steps match the
    replicated run."""
    devices = jax.devices()
    mesh = make_mesh(n_data=4, n_model=2, devices=devices[:8])
    model = ViT(**CFG)
    step_fn = make_train_step(model)

    state_rep = create_train_state(model, jax.random.PRNGKey(0),
                                   make_batch(0)[0][:1], mesh=mesh)
    state_fsdp = create_train_state(model, jax.random.PRNGKey(0),
                                    make_batch(0)[0][:1], mesh=mesh, fsdp=True)

    # memory: the qkv kernel (2, 128, 384) shards 128/4 x 384/2
    qkv = [leaf for p, leaf in _flat_with_paths(state_fsdp.params)
           if p.endswith("qkv_kernel")][0]
    assert qkv.sharding.spec == P(None, "data", "model")
    assert qkv.addressable_shards[0].data.shape == (2, 32, 192)
    # ...and the Adam moments inherit the same shard layout (the ZeRO win)
    moments = [leaf for p, leaf in _flat_with_paths(state_fsdp.opt_state)
               if p.endswith("qkv_kernel")]
    assert moments and all(
        m.addressable_shards[0].data.shape == (2, 32, 192) for m in moments
    )

    imgs, labels = make_batch(0)
    imgs_s, labels_s = shard_batch(imgs, mesh), shard_batch(labels, mesh)
    hlo = step_fn.lower(state_fsdp, imgs_s, labels_s).compile().as_text()
    assert "all-gather" in hlo, "FSDP step never gathers its weight shards"

    for i in range(2):
        imgs, labels = make_batch(i)
        imgs_s, labels_s = shard_batch(imgs, mesh), shard_batch(labels, mesh)
        state_rep, loss_rep = step_fn(state_rep, imgs_s, labels_s)
        state_fsdp, loss_fsdp = step_fn(state_fsdp, imgs_s, labels_s)

    np.testing.assert_allclose(float(loss_rep), float(loss_fsdp), atol=1e-5)
    for (pa, a), (pb, b) in zip(_flat_with_paths(state_rep.params),
                                _flat_with_paths(state_fsdp.params)):
        assert pa == pb
        np.testing.assert_allclose(
            np.asarray(jax.device_get(a)), np.asarray(jax.device_get(b)),
            atol=1e-5, rtol=0, err_msg=pa,
        )


def test_fsdp_checkpoint_cross_topology(tmp_path):
    """An FSDP run checkpoints and restores onto a different mesh with
    fsdp placement re-derived for the new topology."""
    from vitax.utils.checkpoint import abstract_train_state, restore_checkpoint, save_checkpoint

    devices = jax.devices()
    mesh_a = make_mesh(n_data=8, n_model=1, devices=devices[:8])
    model = ViT(**CFG)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               make_batch(0)[0][:1], mesh=mesh_a, fsdp=True)
    save_checkpoint(str(tmp_path / "ckpt"), state)

    mesh_b = make_mesh(n_data=2, n_model=4, devices=devices[:8])
    target = abstract_train_state(model, make_batch(0)[0][:1],
                                  mesh=mesh_b, fsdp=True)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), target=target)
    qkv = [leaf for p, leaf in _flat_with_paths(restored.params)
           if p.endswith("qkv_kernel")][0]
    assert qkv.sharding.spec == P(None, "data", "model")
    assert dict(zip(qkv.sharding.mesh.axis_names,
                    qkv.sharding.mesh.devices.shape)) == {"data": 2, "model": 4}
    for (pa, a), (pb, b) in zip(_flat_with_paths(state.params),
                                _flat_with_paths(restored.params)):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(a)), np.asarray(jax.device_get(b)),
            err_msg=pa,
        )

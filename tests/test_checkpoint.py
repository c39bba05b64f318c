"""Checkpoint subsystem: step management, retention, async save, and
cross-topology restore (save on one mesh, resume on another) — a
production resume path the reference has no counterpart for
(SURVEY.md §5 checkpoint/resume row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

pytest.importorskip("orbax.checkpoint")  # the optional `checkpoint` extra

from vitax.models import ViT
from vitax.parallel import make_mesh
from vitax.train import create_train_state, make_train_step, shard_batch
from vitax.utils.checkpoint import (
    CheckpointManager,
    abstract_train_state,
    restore_checkpoint,
    save_checkpoint,
)


def tiny_vit():
    return ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=2,
               heads=2, mlp_dim=64, dim_head=16)


def make_batch(i, n=8):
    key = jax.random.PRNGKey(100 + i)
    images = jax.random.normal(key, (n, 16, 16, 3), jnp.float32)
    labels = jnp.arange(n) % 4
    return images, labels


def gathered(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def assert_trees_equal(a, b, atol=0.0):
    flat_a = jax.tree_util.tree_leaves(gathered(a))
    flat_b = jax.tree_util.tree_leaves(gathered(b))
    assert len(flat_a) == len(flat_b)
    for la, lb in zip(flat_a, flat_b):
        np.testing.assert_allclose(la, lb, atol=atol, rtol=0)


def test_resume_is_bit_exact(tmp_path):
    """Train 4 straight == train 2, checkpoint, restore, train 2 — bitwise.

    This is the real resume contract: the optimizer moments, step counter,
    and params all round-trip exactly, so the continued run replays the
    identical program on identical state.
    """
    model = tiny_vit()
    step_fn = make_train_step(model)

    state = create_train_state(model, jax.random.PRNGKey(0), make_batch(0)[0][:1])
    for i in range(2):
        state, _ = step_fn(state, *make_batch(i))

    save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), target=state)
    assert int(restored.step) == int(state.step)

    for i in range(2, 4):
        state, _ = step_fn(state, *make_batch(i))
        restored, _ = step_fn(restored, *make_batch(i))

    assert_trees_equal(state.params, restored.params, atol=0.0)
    assert_trees_equal(state.opt_state, restored.opt_state, atol=0.0)


def test_cross_topology_restore(tmp_path):
    """Save from a pure-dp mesh, restore onto a dp x tp mesh: the restored
    params carry the tp shardings, values match, and continued training on
    the new topology matches the old one."""
    devices = jax.devices()
    assert len(devices) >= 8, "conftest pins an 8-device CPU mesh"
    model = tiny_vit()
    step_fn = make_train_step(model)

    mesh_a = make_mesh(n_data=8, n_model=1, devices=devices[:8])
    state = create_train_state(
        model, jax.random.PRNGKey(0), make_batch(0)[0][:1], mesh=mesh_a
    )
    for i in range(2):
        imgs, labels = make_batch(i)
        state, _ = step_fn(state, shard_batch(imgs, mesh_a),
                           shard_batch(labels, mesh_a))
    save_checkpoint(str(tmp_path / "ckpt"), state)

    # Restore onto a DIFFERENT topology: 4-way data x 2-way model.
    mesh_b = make_mesh(n_data=4, n_model=2, devices=devices[:8])
    target = abstract_train_state(model, make_batch(0)[0][:1], mesh=mesh_b)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), target=target)

    # The qkv kernel must land model-sharded on mesh_b, and its optimizer
    # moments with it (the rules match the param name inside the moment
    # paths too).
    def find_qkv_shardings(tree):
        out = []
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            pstr = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            if pstr.endswith("qkv_kernel") or pstr.endswith("to_qkv/kernel"):
                out.append(leaf.sharding)
        return out

    qkv_shardings = find_qkv_shardings(restored.params)
    assert qkv_shardings, "no qkv kernels found in restored params"
    for s in qkv_shardings:
        assert dict(zip(s.mesh.axis_names, s.mesh.devices.shape)) == {
            "data": 4, "model": 2}
        assert s.spec[-1] == "model", f"qkv not model-sharded: {s.spec}"
    moment_shardings = find_qkv_shardings(restored.opt_state)
    assert moment_shardings and all(
        s.spec[-1] == "model" for s in moment_shardings
    ), "optimizer moments did not inherit the qkv sharding"

    # Values round-trip exactly despite the resharding.
    assert_trees_equal(state.params, restored.params, atol=0.0)

    # Continued training on the new topology matches the old one (same
    # math, different collective decomposition — tolerance for float
    # reduction-order differences).
    imgs, labels = make_batch(7)
    state_a, loss_a = step_fn(state, shard_batch(imgs, mesh_a),
                              shard_batch(labels, mesh_a))
    state_b, loss_b = step_fn(restored, shard_batch(imgs, mesh_b),
                              shard_batch(labels, mesh_b))
    assert np.isfinite(float(loss_b))
    np.testing.assert_allclose(float(loss_a), float(loss_b), atol=1e-5)
    assert_trees_equal(state_a.params, state_b.params, atol=1e-5)


def test_single_device_restore_of_sharded_checkpoint(tmp_path):
    """mesh=None target restores a mesh-sharded checkpoint to plain
    single-device arrays (the serve-one-chip-after-pod-training path)."""
    devices = jax.devices()
    model = tiny_vit()
    mesh = make_mesh(n_data=4, n_model=2, devices=devices[:8])
    state = create_train_state(
        model, jax.random.PRNGKey(0), make_batch(0)[0][:1], mesh=mesh
    )
    save_checkpoint(str(tmp_path / "ckpt"), state)

    target = abstract_train_state(model, make_batch(0)[0][:1], mesh=None)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), target=target)
    leaves = jax.tree_util.tree_leaves(restored.params)
    assert all(len(leaf.sharding.device_set) == 1 for leaf in leaves)
    assert_trees_equal(state.params, restored.params, atol=0.0)


def test_manager_retention_latest_and_cadence(tmp_path):
    model = tiny_vit()
    state = create_train_state(model, jax.random.PRNGKey(0), make_batch(0)[0][:1])

    with CheckpointManager(str(tmp_path / "run"), max_to_keep=2,
                           save_interval_steps=2) as mgr:
        saved = [mgr.save(step, state) for step in range(5)]
        mgr.wait()
        # cadence: every 2nd step (0, 2, 4) saves, the rest skip
        assert saved == [True, False, True, False, True]
        # retention: only the newest two survive
        assert mgr.all_steps() == [2, 4]
        assert mgr.latest_step() == 4

        restored = mgr.restore(target=state)
        assert_trees_equal(state.params, restored.params, atol=0.0)
        assert int(restored.step) == int(state.step)

        # a force-save of an already-persisted step is a no-op, not an
        # error (the final-state save usually collides with the cadence)
        assert mgr.save(4, state, force=True) is False
        assert mgr.all_steps() == [2, 4]


def test_manager_best_metric_retention(tmp_path):
    """best_fn retention keeps the best-metric checkpoints, and
    best_step() finds the minimum-loss save."""
    model = tiny_vit()
    state = create_train_state(model, jax.random.PRNGKey(0), make_batch(0)[0][:1])

    with CheckpointManager(str(tmp_path / "run"), max_to_keep=2,
                           best_fn=lambda m: m["loss"],
                           best_mode="min") as mgr:
        for step, loss in enumerate([3.0, 1.0, 2.0, 4.0]):
            mgr.save(step, state, metrics={"loss": loss})
        mgr.wait()
        assert mgr.best_step() == 1
        assert 1 in mgr.all_steps()  # the best save survives retention
        assert len(mgr.all_steps()) == 2


def test_manager_restore_missing_raises(tmp_path):
    with CheckpointManager(str(tmp_path / "empty")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()

"""Checkpoint/resume via orbax (SURVEY.md §5 — the reference has none;
params live only in the Python process there).

Three tiers, lowest to highest:

* ``save_checkpoint`` / ``restore_checkpoint`` — one pytree, one directory.
* ``abstract_train_state`` — the restore target for **cross-topology
  resume**: an abstract ``TrainState`` (shapes/dtypes only, zero device
  memory) whose leaves carry ``NamedSharding``s for a *target* mesh. Save
  a run sharded dp=8, restore it onto dp=4 x tp=2 (or a single chip):
  orbax reshards each array to the requested layout while reading, so the
  full state never has to fit on one device. The mesh you come back on is
  rarely the mesh you left.
* ``CheckpointManager`` — step-numbered training checkpoints with
  retention (``max_to_keep``), cadence (``save_interval_steps``),
  best-metric keeping, and async save (the device-to-host copy happens at
  ``save()``, serialization overlaps the next training steps).

All of it is exercised on the 8-device CPU mesh in
``tests/test_checkpoint.py``, including bit-exact optimizer-state resume
(train 4 steps == train 2, checkpoint, restore, train 2) and a
cross-topology restore whose continued training matches the original mesh.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding


def _abstractify(tree: Any) -> Any:
    """Shape/dtype(/sharding) skeleton for an orbax restore target.

    Leaves that are already ``jax.ShapeDtypeStruct`` pass through unchanged
    so an ``abstract_train_state`` target keeps its mesh shardings.
    """
    return jax.tree.map(
        lambda leaf: leaf if isinstance(leaf, jax.ShapeDtypeStruct)
        else ocp.utils.to_shape_dtype_struct(leaf),
        tree,
    )


def save_checkpoint(path: str, tree: Any, *, force: bool = True) -> None:
    """Save a pytree (params / TrainState) to ``path`` (absolute dir)."""
    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree, force=force)
    ckptr.wait_until_finished()


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a pytree from ``path``.

    ``target`` — a matching pytree of arrays OR of ``jax.ShapeDtypeStruct``
    (e.g. from ``abstract_train_state``) — pins dtypes and *shardings*: each
    array is laid out per the target's sharding as it is read, including
    shardings over a different mesh than the checkpoint was saved from.
    """
    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    if target is not None:
        return ckptr.restore(path, _abstractify(target))
    return ckptr.restore(path)


def abstract_train_state(
    model,
    sample_images,
    optimizer=None,
    *,
    mesh: Optional[Mesh] = None,
    tp_rules=None,
    fsdp: bool = False,
) -> Any:
    """Abstract ``TrainState`` for cross-topology restore — no device memory.

    Builds the state skeleton with ``jax.eval_shape`` (params, optimizer
    moments, step, model_state — shapes and dtypes only), then attaches a
    ``NamedSharding`` over ``mesh`` to every leaf by the same path-regex TP
    rules ``create_train_state`` shards live params with (optimizer moments
    inherit their param's spec because the rules match the param name at
    the end of the moment's path; everything unmatched replicates).

    Pass the SAME ``model``/``optimizer`` the checkpoint was created with —
    the tree structure must match the saved state. ``mesh=None`` restores
    to single-device (unsharded) arrays on the default device — without an
    explicit sharding orbax would fall back to the layout recorded in the
    checkpoint, resurrecting the training topology. ``fsdp=True`` mirrors
    ``create_train_state(fsdp=True)``: every big leaf re-lands sharded
    over the data axis too.
    """
    from vitax.parallel.sharding import (
        DEFAULT_TP_RULES, fsdp_param_specs, tp_param_specs,
    )
    from vitax.train import create_train_state

    if tp_rules is None:
        tp_rules = DEFAULT_TP_RULES
    abstract = jax.eval_shape(
        lambda imgs: create_train_state(
            model, jax.random.PRNGKey(0), imgs, optimizer
        ),
        sample_images,
    )
    if mesh is None:
        single = jax.sharding.SingleDeviceSharding(jax.local_devices()[0])
        return jax.tree.map(
            lambda leaf: jax.ShapeDtypeStruct(
                leaf.shape, leaf.dtype, sharding=single
            ),
            abstract,
        )
    specs = (fsdp_param_specs(abstract, mesh, tp_rules) if fsdp
             else tp_param_specs(abstract, tp_rules))
    return jax.tree.map(
        lambda leaf, spec: jax.ShapeDtypeStruct(
            leaf.shape, leaf.dtype, sharding=NamedSharding(mesh, spec)
        ),
        abstract,
        specs,
    )


class CheckpointManager:
    """Step-numbered training checkpoints: retention, cadence, async save.

    ::

        with CheckpointManager(dir, max_to_keep=3) as mgr:
            for step in range(total):
                state, loss = train_step(state, batch())
                mgr.save(step, state, metrics={"loss": float(loss)})
        # later / elsewhere (any mesh topology):
        target = abstract_train_state(model, imgs, mesh=new_mesh)
        state = CheckpointManager(dir).restore(target=target)

    ``save`` copies device arrays to host and returns; serialization runs
    on a background thread (``async_save=True``) so the next train steps
    overlap the disk write. ``wait()``/``close()``/context-exit block until
    every pending save is durable.
    """

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: Optional[int] = 3,
        save_interval_steps: int = 1,
        async_save: bool = True,
        best_fn=None,
        best_mode: str = "max",
    ):
        options = ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep,
            save_interval_steps=save_interval_steps,
            enable_async_checkpointing=async_save,
            best_fn=best_fn,
            best_mode=best_mode,
            create=True,
        )
        self._mgr = ocp.CheckpointManager(
            os.path.abspath(directory), options=options
        )

    def save(self, step: int, state: Any, *, metrics: Optional[dict] = None,
             force: bool = False) -> bool:
        """Checkpoint ``state`` at ``step``; False when skipped by cadence
        or already saved. ``force`` overrides the cadence (final-state
        saves), never an existing step — a step is written once."""
        if int(step) in self._mgr.all_steps():
            return False
        return self._mgr.save(
            int(step), args=ocp.args.StandardSave(state), metrics=metrics,
            force=force,
        )

    def should_save(self, step: int) -> bool:
        """True when ``save(step)`` would actually write (cadence hit, step
        not already saved). Lets train loops skip materializing loss/metrics
        on skipped steps — ``float(loss)`` is a host sync that defeats async
        dispatch."""
        return (
            int(step) not in self._mgr.all_steps()
            and self._mgr.should_save(int(step))
        )

    def restore(self, step: Optional[int] = None, *, target: Any = None) -> Any:
        """Restore ``step`` (default: latest). ``target`` as in
        ``restore_checkpoint`` — pass ``abstract_train_state(...)`` to
        restore onto a different mesh topology."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self._mgr.directory}"
                )
        args = (
            ocp.args.StandardRestore(_abstractify(target))
            if target is not None else None
        )
        return self._mgr.restore(int(step), args=args)

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def best_step(self) -> Optional[int]:
        return self._mgr.best_step()

    def all_steps(self):
        return sorted(self._mgr.all_steps())

    def wait(self) -> None:
        """Block until every pending async save is durable on disk."""
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

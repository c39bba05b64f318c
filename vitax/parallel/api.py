"""Multi-device execution entry points.

Two complementary paths (SURVEY.md §2.3):

- ``data_parallel_apply``: serving path. ``shard_map`` over the data axis —
  params replicated, batch sharded, the per-device program is the normal
  single-device forward, and the only collective is
  the optional logits ``all_gather`` at the classifier head (the north-star
  placement).
- GSPMD tensor/data parallelism lives in ``vitax.train`` /
  ``vitax.parallel.sharding``: parameters carry NamedShardings and XLA
  inserts the collectives.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vitax.parallel.mesh import DATA_AXIS


def data_parallel_apply(
    model,
    mesh: Mesh,
    *,
    gather_logits: bool = True,
    train: bool = False,
) -> Callable:
    """Build a jitted data-parallel ``fn(variables, images) -> logits``.

    The batch must divide by the data-axis size. Parameters are replicated;
    each device runs the full single-chip forward on its batch shard; with
    ``gather_logits`` every device ends with the full logits (one
    ``all_gather`` at the head, nothing else crosses chips).
    """

    def per_device(variables, imgs):
        out = model.apply(variables, imgs, train)
        if gather_logits:
            out = jax.lax.all_gather(out, DATA_AXIS, axis=0, tiled=True)
        return out

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS)),
        out_specs=P() if gather_logits else P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded)

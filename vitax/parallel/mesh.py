"""Device-mesh construction (SURVEY.md §2.3 — the reference has no
parallelism code; this is the build's sharding layer).

The communication backend is XLA itself: collectives are inserted by the
compiler from sharding annotations and run over the device interconnect
(NVLink between the GPUs of one host). This module
owns mesh construction and the canonical axis names:

  - ``data``: batch-sharded data parallelism (the primary strategy for
    ViT-scale inference and training).
  - ``model``: optional tensor parallelism — attention heads and MLP hidden
    dim sharded; XLA inserts the psum on out/down projections.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, model)`` mesh over the available devices.

    With ``n_data=None`` the data axis absorbs all devices not claimed by
    the model axis. ``n_model=1`` (default) gives pure data parallelism —
    right-sized for every model in the zoo, all of which fit on one chip.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_data is None:
        if n % n_model != 0:
            raise ValueError(
                f"{n} available device(s) not divisible by n_model={n_model}"
            )
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError(
            f"mesh needs n_data*n_model = {n_data}*{n_model} = {n_data * n_model} "
            f"devices but only {n} available ({devices[0].platform}). For a "
            "virtual multi-device mesh, start the process with "
            "JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_device_count=N "
            "(see tests/conftest.py), or use __graft_entry__.dryrun_multichip "
            "which self-provisions one."
        )
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding for image/logit arrays."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

"""Failure detection / recovery helpers (SURVEY.md §5 'failure detection'
row: a device-health probe at startup, an idempotent batch-level retry
around jitted calls) and the persistent compilation cache.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger("vitax.health")


def probe_devices(devices: Optional[Sequence[jax.Device]] = None) -> dict:
    """Tiny per-device compute probe + (multi-device) collective probe.

    Returns a report dict; raises RuntimeError if any device fails to
    produce a correct result.
    """
    devices = list(devices if devices is not None else jax.devices())
    report = {"devices": len(devices), "ok": True, "details": []}
    for d in devices:
        t0 = time.perf_counter()
        x = jax.device_put(jnp.ones((128, 128)), d)
        val = float((x @ x).sum())  # computes on x's device
        ok = abs(val - 128 * 128 * 128) < 1e-3 * 128**3
        report["details"].append({"device": str(d), "ok": ok, "latency_s": time.perf_counter() - t0})
        report["ok"] &= ok
    if len(devices) > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(devices), ("d",))
        x = jax.device_put(jnp.ones((len(devices),)), NamedSharding(mesh, P("d")))
        total = float(jnp.sum(x))
        report["collective_ok"] = abs(total - len(devices)) < 1e-6
        report["ok"] &= report["collective_ok"]
    if not report["ok"]:
        raise RuntimeError(f"device health probe failed: {report}")
    return report


def with_retry(fn: Callable, *, attempts: int = 2, backoff_s: float = 1.0) -> Callable:
    """Idempotent retry wrapper for batch-level inference calls: a transient
    runtime failure (preemption, transport hiccup) re-executes the batch."""

    def wrapper(*args, **kwargs):
        last = None
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # jaxlib runtime errors share no base class
                last = e
                log.warning("batch attempt %d/%d failed: %s", i + 1, attempts, e)
                if i + 1 < attempts:
                    time.sleep(backoff_s * (2**i))
        raise last

    return wrapper


def memory_stats(device: Optional[jax.Device] = None) -> dict:
    """Device memory usage for the bench harness (SURVEY.md §5 metrics row)."""
    d = device or jax.devices()[0]
    stats = d.memory_stats() or {}
    return {
        "bytes_in_use": stats.get("bytes_in_use"),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else ``<repo>/.jax_cache``. The path is part of the
    cache key, so it never depends on the process, the time or a
    temporary directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Persist compiled executables across processes in
    ``compilation_cache_dir()``; returns the directory. A cold compile of
    ViT-L takes tens of seconds, so repeat benchmark, serving and test
    runs reuse the cache."""
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path

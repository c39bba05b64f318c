"""Tracing / profiling / observability hooks (SURVEY.md §5).

The reference's only instrumentation is ``print(output.shape)``; this
provides the JAX-native equivalents: profiler trace capture, compiled-program
cost analysis, and a tiny structured benchmark timer.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Dict, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/vitax_trace"):
    """Capture an xprof/tensorboard trace of the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn: Callable, *args) -> Dict[str, Any]:
    """Compiled-program cost analysis (FLOPs, bytes accessed) for a jitted
    callable — per-kernel cost visibility without running it."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, (list, tuple)):
        costs = costs[0] if costs else {}
    return dict(costs or {})


def benchmark(
    fn: Callable,
    *args,
    iters: int = 20,
    warmup: int = 2,
    items_per_call: Optional[int] = None,
) -> Dict[str, float]:
    """Measure wall-clock latency of ``fn(*args)`` (which must return a JAX
    array or pytree). Returns p50/mean latency and optional throughput."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    stats = {
        "p50_s": samples[len(samples) // 2],
        "mean_s": sum(samples) / len(samples),
        "min_s": samples[0],
    }
    if items_per_call:
        stats["items_per_sec"] = items_per_call / stats["p50_s"]
    return stats


def log_event(name: str, **fields) -> None:
    """Structured one-line JSON logging for compile/run events."""
    print(json.dumps({"event": name, "time": time.time(), **fields}), flush=True)

"""Benchmark: ViT-L/16 @224 bf16 inference throughput on one GPU.

    python bench.py

Prints the device (platform, kind, count, and the card's name and power
limit as ``nvidia-smi`` reports them) and then ONE JSON line:

  {"metric": "...", "value": images/s, "unit": "images/sec/chip", ...}

with the batch-128 throughput, model FLOP/s utilization against the card's
published bf16 peak (``vitax.utils.device.DEVICE_PEAKS``; an unknown card
is an error), p50/p90 batch latency, p50 at batch 1 and 8, the W8A8 int8
throughput, and the bf16 logits' distance to the float64 host forward.
Every timing ends in ``block_until_ready``. It refuses to run without a
GPU.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

CFG = dict(
    image_size=224, patch_size=16, num_classes=1000,
    dim=1024, depth=24, heads=16, mlp_dim=4096, dim_head=64,
)
BATCH = 128
ITERS = 20


def timed_throughput(fn, *args, iters=ITERS, batch=BATCH):
    """(images/s, seconds per batch) over ``iters`` back-to-back calls."""
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return batch / dt, dt


def timed_latency(fn, *args, iters=ITERS):
    """(p50, p90) seconds, each call waited for on its own."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.percentile(ts, 50)), float(np.percentile(ts, 90))


def model_flops_per_image(cfg=CFG) -> float:
    """Forward FLOPs per image from the shapes: 2 per multiply-add, the
    attention scores and PV product counted at their quadratic cost,
    patch embedding and classifier included."""
    n = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    d, m, depth = cfg["dim"], cfg["mlp_dim"], cfg["depth"]
    return (
        2 * n * (cfg["patch_size"] ** 2 * 3) * d
        + depth * (8 * n * d * d + 4 * n * n * d + 4 * n * d * m)
        + 2 * d * cfg["num_classes"]
    )


def main():
    from vitax.models import ViT
    from vitax.utils import enable_compilation_cache, fp64_vit_forward, max_logit_err
    from vitax.utils.device import (
        device_peaks, device_record, nvidia_smi_name_power, require_gpu,
    )
    from vitax.utils.quantize import quantize_vit, vit_apply_w8a8

    device = require_gpu()
    peaks = device_peaks(device.device_kind)
    record = device_record()
    smi = nvidia_smi_name_power()
    print(json.dumps({"device": record, "nvidia_smi": smi}), flush=True)
    enable_compilation_cache()

    model = ViT(**CFG, dtype=jnp.bfloat16)
    img = jax.random.normal(jax.random.PRNGKey(0), (BATCH, 224, 224, 3), jnp.bfloat16)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(1)}, img[:1])
    apply = jax.jit(model.apply)

    ips, per_batch = timed_throughput(apply, params, img)
    p50, p90 = timed_latency(apply, params, img)
    b1_p50, _ = timed_latency(apply, params, img[:1])
    b8_p50, _ = timed_latency(apply, params, img[:8])

    qvars = quantize_vit(params)
    q_apply = jax.jit(lambda v, x: vit_apply_w8a8(model, v, x, mode="w8a8"))
    int8_ips, _ = timed_throughput(q_apply, qvars, img)

    logits = np.asarray(apply(params, img[:2]), np.float32)
    if not np.isfinite(logits).all():
        raise RuntimeError("non-finite bf16 logits")
    truth = fp64_vit_forward(
        jax.device_get(params), np.asarray(img[:2], np.float32),
        patch_size=CFG["patch_size"], heads=CFG["heads"], dim_head=CFG["dim_head"],
    )
    flops = model_flops_per_image()
    print(json.dumps({
        "metric": "ViT-L/16 @224 bf16 inference throughput (batch 128, 1 GPU)",
        "value": ips,
        "unit": "images/sec/chip",
        "device": record,
        "nvidia_smi": smi,
        "batch_latency_s": per_batch,
        "p50_batch_latency_ms": p50 * 1e3,
        "p90_batch_latency_ms": p90 * 1e3,
        "p50_batch1_latency_ms": b1_p50 * 1e3,
        "p50_batch8_latency_ms": b8_p50 * 1e3,
        "int8_w8a8_images_per_sec": int8_ips,
        "model_gflops_per_image": flops / 1e9,
        "achieved_tflops": ips * flops / 1e12,
        "peak_bf16_tflops": peaks["bf16_flops_per_s"] / 1e12,
        "mfu": ips * flops / peaks["bf16_flops_per_s"],
        "max_logit_err_vs_fp64": max_logit_err(logits, truth),
        "max_abs_logit_fp64": float(np.abs(truth).max()),
    }), flush=True)


if __name__ == "__main__":
    main()

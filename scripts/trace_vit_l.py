"""Trace ViT-L/16 @224 on one GPU and print where the device time goes.

    python scripts/trace_vit_l.py            # on the card: trace, then reduce
    python scripts/trace_vit_l.py --reduce   # anywhere: reduce saved traces

Traces a steady window of the bf16 forward at batch 128 and of the train
step (remat, AdamW) at batch 256 with ``jax.profiler``, after warm-up
calls, and reduces each trace to: the device's busy and idle share of the
window, and device time per kernel class (GEMM, attention, convolution,
other fusions, copies). Prints one JSON line per window; the traces stay
under ``chiprun_out/trace_vit_l/``.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join("chiprun_out", "trace_vit_l")
CLASSES = (  # first match wins; matched against the lowercased kernel name
    ("attention", ("sdpa", "flash", "fmha", "attention")),
    ("gemm", ("nvjet", "xmma", "gemm", "matmul", "cutlass", "wgmma")),
    ("convert fusion", ("convert",)),
    ("add fusion", ("loop_add",)),
    ("slice fusion", ("slice",)),
    ("reduce fusion", ("reduce",)),
    ("copy/transpose", ("copy", "transpose", "memcpy", "memset")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other fusion"


def reduce_trace(path: str) -> dict:
    """Busy share of the window (union of kernel intervals over the span
    from the first kernel start to the last kernel end) and device time by
    kernel class and by kernel, from one ``.xplane.pb``. ``nvjet``/``xmma``
    kernels are cuBLAS GEMMs; ``gemm_fusion_dot`` is XLA's own GEMM."""
    data = jax.profiler.ProfileData.from_file(path)
    events, lines = [], set()
    for plane in data.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            lines.add(line.name)
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                events.append((ev.start_ns, ev.start_ns + ev.duration_ns, ev.name))
    if not events:
        return {"device_events": 0, "gpu_lines": sorted(lines)}
    events.sort()
    busy, cur_s, cur_e = 0.0, events[0][0], events[0][1]
    for s, e, _ in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in events) - events[0][0]
    by_class, by_kernel = {}, {}
    for s, e, name in events:
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0.0) + (e - s)
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
    total = sum(by_class.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {
        "device_events": len(events),
        "window_ms": window / 1e6,
        "busy_share": busy / window,
        "idle_share": 1 - busy / window,
        "kernel_ms_by_class": {k: v / 1e6 for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "kernel_share_by_class": {k: v / total for k, v in by_class.items()},
        "top_kernels_ms": [(n[:120], t / 1e6) for n, t in top],
    }


def traced(name: str, fn, args, steps: int) -> dict:
    for _ in range(2):
        jax.block_until_ready(fn(*args))
    logdir = os.path.join(OUT, name)
    with jax.profiler.trace(logdir):
        for _ in range(steps):
            out = fn(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    rec = {"window": name, "steps": steps, **reduce_trace(path)}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    from chip_smoke import VIT_L16
    from vitax.models import ViT
    from vitax.train import create_train_state, make_optimizer, make_train_step
    from vitax.utils import enable_compilation_cache
    from vitax.utils.device import nvidia_smi_name_power, require_gpu

    require_gpu()
    enable_compilation_cache()
    print(json.dumps({"nvidia_smi": nvidia_smi_name_power()}), flush=True)
    model = ViT(**VIT_L16, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.normal(size=(128, 224, 224, 3)), jnp.bfloat16)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, img[:1])
    traced("forward_b128", jax.jit(model.apply), (variables, img), steps=5)

    b = 256
    imgs = jnp.asarray(rng.normal(size=(b, 224, 224, 3)), jnp.bfloat16)
    labels = jnp.asarray(rng.integers(0, 1000, b), jnp.int32)
    opt = make_optimizer(1e-4, grad_clip_norm=1.0)
    state = create_train_state(model, jax.random.PRNGKey(0), imgs[:1], opt)
    step = make_train_step(model, opt, remat=True)
    traced("train_step_b256", lambda s, x, y: step(s, x, y)[1], (state, imgs, labels), steps=3)




def reduce_saved(root: str = OUT) -> None:
    """Print the reduction of every trace already under ``root``."""
    for path in sorted(glob.glob(os.path.join(root, "*", "plugins", "profile", "*", "*.xplane.pb"))):
        name = path.split(os.sep)[-5]
        print(json.dumps({"window": name, **reduce_trace(path)}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--reduce"]:
        reduce_saved()
    else:
        main()

"""Time the attention routes end to end in the ViT-L/16 forward, on the GPU.

Three routes for the attention core, each swapped into the model through
``vitax.ops.qkv_attention`` (the function every raw-parameter attention
layer calls with the fused ``[B, N, 3*H*D]`` projection):

- ``xla``: the plain einsum-softmax-einsum (``ops.reference_attention``);
- ``cudnn``: ``jax.nn.dot_product_attention(implementation="cudnn")``;
- ``triton``: the Pallas-Triton flash kernel that ships with JAX
  (``jax.experimental.pallas.ops.gpu.attention.mha``, a library kernel).
  It needs sequence lengths that divide its block, so the tokens are padded
  to the block and the padding is masked with segment ids.

Each route is timed in the bf16 ViT-L/16 @224 forward at batch 128, and
again alone at the long T2T tokenizer shape (3136 x 3136 tokens, one head
of 64). Prints one JSON line per measurement and writes them to
``chiprun_out/attention_routes.jsonl``.

Run on the card: ``python scripts/attention_routes.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join("chiprun_out", "attention_routes.jsonl")
VIT_L = dict(image_size=224, patch_size=16, num_classes=1000, dim=1024,
             depth=24, heads=16, mlp_dim=4096)


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def time_fn(fn, *args, iters=20, repeats=5):
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, each window closed by ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / iters)
    return float(np.median(samples)), [float(s) for s in samples]


def core_xla(q, k, v, scale):
    """[B, N, H, D] layout in and out."""
    from vitax.ops import reference_attention

    t = lambda a: a.transpose(0, 2, 1, 3)
    return t(reference_attention(t(q), t(k), t(v), scale=scale))


def core_cudnn(q, k, v, scale):
    return jax.nn.dot_product_attention(q, k, v, scale=scale, implementation="cudnn")


def core_triton(q, k, v, scale, block=128):
    from jax.experimental.pallas.ops.gpu.attention import mha

    b, n = q.shape[:2]
    n_pad = -(-n // block) * block
    pad = ((0, 0), (0, n_pad - n), (0, 0), (0, 0))
    seg = (jnp.arange(n_pad) < n).astype(jnp.int32)
    seg = jnp.broadcast_to(seg, (b, n_pad))
    out = mha(jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), seg, sm_scale=scale)
    return out[:, :n]


CORES = {"xla": core_xla, "cudnn": core_cudnn, "triton": core_triton}


def qkv_route(core):
    def qkv_attention(qkv, heads, bias=None, *, scale=None):
        assert bias is None
        b, n, three_hd = qkv.shape
        d = three_hd // 3 // heads
        q, k, v = jnp.split(qkv.reshape(b, n, 3 * heads, d), 3, axis=2)
        out = core(q, k, v, d**-0.5 if scale is None else scale)
        return out.reshape(b, n, heads * d)

    return qkv_attention


def device_header() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def vit_l_forward(batch=128):
    from vitax.models import ViT

    model = ViT(**VIT_L, dtype=jnp.bfloat16)
    img = jax.random.normal(jax.random.PRNGKey(0), (batch, 224, 224, 3), jnp.bfloat16)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(1)}, img[:1])
    return model, variables, img


def measure_vit_routes(routes, batch=128):
    import vitax.ops as ops_mod

    model, variables, img = vit_l_forward(batch)
    original = ops_mod.qkv_attention
    ref = None
    try:
        for name in routes:
            ops_mod.qkv_attention = qkv_route(CORES[name])
            fn = jax.jit(model.apply)
            t, samples = time_fn(fn, variables, img)
            logits = np.asarray(fn(variables, img[:8]), np.float32)
            if ref is None:
                ref = logits
            emit({"what": "vit_l16_forward", "route": name, "batch": batch,
                  "s_per_batch": t, "images_per_s": batch / t, "samples": samples,
                  "max_abs_vs_first_route": float(np.abs(logits - ref).max())})
    finally:
        ops_mod.qkv_attention = original


def measure_long_shape(routes, b=32, n=3136, heads=1, d=64):
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    q, k, v = (jax.random.normal(kk, (b, n, heads, d), jnp.bfloat16) for kk in keys)
    ref = None
    for name in routes:
        fn = jax.jit(lambda q, k, v, c=CORES[name]: c(q, k, v, d**-0.5))
        t, samples = time_fn(fn, q, k, v)
        out = np.asarray(fn(q, k, v)[:2], np.float32)
        if ref is None:
            ref = out
        emit({"what": "attention_core_t2t_stage0", "route": name,
              "shape_bnhd": [b, n, heads, d], "s_per_call": t, "samples": samples,
              "max_abs_vs_first_route": float(np.abs(out - ref).max())})


def main():
    os.makedirs("chiprun_out", exist_ok=True)
    emit({"what": "device", **device_header()})
    routes = sys.argv[1:] or list(CORES)
    measure_vit_routes(routes)
    measure_long_shape(routes)


if __name__ == "__main__":
    main()

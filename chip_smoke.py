"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py             # one card: serve, correctness, int8, train
    python chip_smoke.py --chips 4   # four cards: dp x tp train step and
                                     # data-parallel serving vs one card

Runs ViT-L/16 @224 (``dim=1024, depth=24, heads=16, mlp_dim=4096``, 1000
classes, bf16, random weights from a fixed seed) in one process through
the entry points a user calls:

- serve: ``InferencePipeline(batch_size=128).warm()``, then ``BatchingServer``
  answering single requests;
- correctness: the bf16 forward against a float32 forward of the same weights
  under ``jax.default_matmul_precision("highest")`` and against the host
  float64 NumPy forward (``vitax.utils.parity.fp64_vit_forward``);
- int8: ``vit_apply_w8a8`` in modes ``w8a8``, ``w8`` and ``auto`` at batch 128
  and 1 against the bf16 forward, and the compiled int8 products checked to
  stay s8 x s8 -> s32;
- train: ``create_train_state`` + ``make_train_step(remat=True)``, five steps
  on one fixed batch; the loss must be finite and fall.

Any failed check raises, and the script exits non-zero without a result
line. It refuses to run without a GPU. On success the last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np

VIT_L16 = dict(
    image_size=224, patch_size=16, num_classes=1000,
    dim=1024, depth=24, heads=16, mlp_dim=4096, dim_head=64,
)
# Sizes of the one-card run: serving batch, requests, correctness images,
# train batch (the largest of the powers of two that fits, see PERF.md),
# train steps, and the four-card run's train batch.
FULL_SIZES = dict(
    serve_batch=128, requests=32, decode_size=256, images=8,
    train_batch=1024, train_steps=5, mesh_train_batch=64,
)

# Limits, as a fraction of max|logit| of the reference each is compared
# with (reasons in PERF.md, "Tolerances").
TOL = {
    "fp32_highest_vs_fp64": 1e-4,  # float32 rounding only; TF32 would be ~1e-3
    "bf16_vs_fp64": 5e-2,          # 8-bit mantissa, 24 residual layers
    "w8_vs_bf16": 5e-2,            # per-channel int8 weights
    "w8a8_vs_bf16": 1e-1,          # + per-token int8 activations
    # four-card train step: ||g_mesh - g_one|| / ||g_one||
    "mesh_grad_gap": 1e-1,
}
LR = 1e-4


class SmokeFailure(AssertionError):
    """A smoke check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def timed(fn, *args, iters: int = 10):
    """Mean seconds per call over ``iters`` back-to-back calls, closed by
    ``block_until_ready`` (after two warm calls)."""
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def compare(name: str, got, ref, tol: float) -> dict:
    """Max-abs error over max|ref| within ``tol``; reports top-1 agreement.
    (A top-1 flip between classes the reference ranks more than
    ``2 * tol * max|ref|`` apart needs an error above the limit, so the
    error bound also bounds the flips.)"""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    check(got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite logits")
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale
    agree = int(np.sum(got.argmax(-1) == ref.argmax(-1)))
    out = {
        "max_abs_over_max_logit": err, "limit": tol,
        "top1_agree": f"{agree}/{ref.shape[0]}",
    }
    log("compare", what=name, **out)
    check(err <= tol, f"{name}: error {err:.3g} of max|logit| > limit {tol}")
    return out


_HLO_INST = re.compile(r"\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(.*?)\s([\w\-]+)\((.*)")


def int8_gemms(hlo_text: str) -> int:
    """Count the compiled matrix products whose two operands are s8 and
    whose result is s32: dots, convolutions, library GEMM custom calls and
    GEMM fusions."""
    types, insts = {}, []
    for line in hlo_text.splitlines():
        m = _HLO_INST.match(line)
        if m:
            name, typ, op, rest = m.groups()
            types[name] = typ
            insts.append((typ, op, re.findall(r"%[\w.\-]+", rest.split(")", 1)[0])))
    return sum(
        1 for typ, op, operands in insts
        if op in ("dot", "convolution", "custom-call", "fusion")
        and "s32[" in typ
        and len(operands) >= 2
        and all(types.get(o, "").startswith("s8[") for o in operands[:2])
    )


def build(cfg: dict, dtype, seed: int):
    import jax
    import jax.numpy as jnp

    from vitax.models import ViT

    model = ViT(**cfg, dtype=dtype)
    s = cfg["image_size"]
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, s, s, 3), jnp.float32)
    )
    return model, variables


def phase_serve(model, variables, cfg: dict, sizes: dict, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from vitax.data import JpegDecoder
    from vitax.pipeline import InferencePipeline
    from vitax.serving import BatchingServer

    s, b, r = cfg["image_size"], sizes["serve_batch"], sizes["decode_size"]
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    pipe = InferencePipeline(
        model, variables, image_size=s, batch_size=b, dtype=jnp.bfloat16
    ).warm()
    warm_s = time.perf_counter() - t0
    raw = rng.integers(0, 256, (b, r, r, 3), dtype=np.uint8)
    logits = pipe(raw)
    check(logits.shape == (b, cfg["num_classes"]), f"serve: logits shape {logits.shape}")
    check(bool(np.isfinite(logits).all()), "serve: non-finite logits")
    per_batch = timed(lambda: pipe.dispatch(raw))
    lat = []
    for _ in range(20):
        t = time.perf_counter()
        one = pipe(raw[:1])
        lat.append(time.perf_counter() - t)
    check(one.shape == (1, cfg["num_classes"]), "serve: batch-1 shape")

    decoder = JpegDecoder(size=r)
    images = rng.integers(0, 256, (sizes["requests"], r, r, 3), dtype=np.uint8)
    try:
        from io import BytesIO

        from PIL import Image

        def jpeg(a):
            buf = BytesIO()
            Image.fromarray(a).save(buf, format="JPEG", quality=95)
            return buf.getvalue()

        requests = [jpeg(a) for a in images]
        payload = "jpeg"
    except ImportError:
        requests = list(images)
        payload = "uint8 arrays (no JPEG encoder)"
    t0 = time.perf_counter()
    with BatchingServer(pipe, decoder=decoder, max_wait_ms=5.0, warm=False) as server:
        futures = [server.submit(q) for q in requests]
        answers = np.stack([f.result(timeout=600) for f in futures])
    serve_s = time.perf_counter() - t0
    check(answers.shape == (len(requests), cfg["num_classes"]), "server: answer shape")
    check(bool(np.isfinite(answers).all()), "server: non-finite answers")
    decoded = decoder(requests) if payload == "jpeg" else images
    out = {
        "warm_s": warm_s,
        "images_per_s_batch": b / per_batch,
        "batch": b,
        "p50_batch1_ms": 1e3 * float(np.percentile(lat, 50)),
        "decoder_backend": decoder.backend,
        "requests": len(requests),
        "request_payload": payload,
        "server_wall_s": serve_s,
    }
    log("serve", **out)
    out["server_vs_pipeline"] = compare(
        "server answers vs pipeline on the same decoded images",
        answers, pipe(decoded), TOL["bf16_vs_fp64"],
    )
    return out


def phase_correctness(model, variables, cfg: dict, sizes: dict, seed: int):
    import jax
    import jax.numpy as jnp

    from vitax.models import ViT
    from vitax.utils.parity import fp64_vit_forward

    s = cfg["image_size"]
    imgs = np.random.default_rng(seed + 1).normal(size=(sizes["images"], s, s, 3))
    imgs = imgs.astype(np.float32)
    bf16 = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(imgs, jnp.bfloat16)), np.float32)
    model32 = ViT(**cfg)
    with jax.default_matmul_precision("highest"):
        fp32 = np.asarray(jax.jit(model32.apply)(variables, jnp.asarray(imgs)))
    t0 = time.perf_counter()
    fp64 = fp64_vit_forward(
        jax.device_get(variables), imgs, patch_size=cfg["patch_size"],
        heads=cfg["heads"], dim_head=cfg["dim_head"],
    )
    log("correctness", fp64_host_forward_s=time.perf_counter() - t0,
        max_abs_logit_fp64=float(np.abs(fp64).max()))
    out = {
        "fp32_highest_vs_fp64": compare("fp32 (highest) vs fp64", fp32, fp64, TOL["fp32_highest_vs_fp64"]),
        "bf16_vs_fp64": compare("bf16 vs fp64", bf16, fp64, TOL["bf16_vs_fp64"]),
        "bf16_vs_fp32_highest": compare("bf16 vs fp32 (highest)", bf16, fp32, TOL["bf16_vs_fp64"]),
    }
    return out, imgs, bf16


def phase_int8(model, variables, cfg: dict, sizes: dict, imgs, bf16_logits, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from vitax.utils.quantize import quantize_vit, resolve_quant_mode, vit_apply_w8a8

    s, b, n = cfg["image_size"], sizes["serve_batch"], imgs.shape[0]
    qvars = quantize_vit(variables)
    extra = np.random.default_rng(seed + 2).normal(size=(b - n, s, s, 3)).astype(np.float32)
    batches = {
        b: jnp.asarray(np.concatenate([imgs, extra]), jnp.bfloat16),
        1: jnp.asarray(imgs[:1], jnp.bfloat16),
    }
    out, got = {}, {}
    for batch, x in batches.items():
        for mode in ("w8a8", "w8", "auto"):
            fn = jax.jit(lambda v, x, m=mode: vit_apply_w8a8(model, v, x, mode=m))
            compiled = fn.lower(qvars, x).compile()
            logits = np.asarray(compiled(qvars, x), np.float32)
            got[mode, batch] = logits
            rec = {"batch": batch, "mode": mode}
            resolved = resolve_quant_mode(batch) if mode == "auto" else mode
            if mode == "auto":
                rec["resolves_to"] = resolved
                diff = float(np.abs(logits - got[resolved, batch]).max())
                check(diff <= 1e-3 * float(np.abs(logits).max()),
                      f"int8 auto at batch {batch} differs from {resolved}: {diff}")
            if resolved == "w8a8":
                rec["s8_s32_gemms"] = int8_gemms(compiled.as_text())
                check(rec["s8_s32_gemms"] >= 4,
                      f"int8 w8a8 at batch {batch}: {rec['s8_s32_gemms']} s8 x s8 -> s32 products compiled, expected >= 4")
            if batch == b and mode != "auto":
                rec["images_per_s"] = b / timed(compiled, qvars, x, iters=5)
            log("int8", **rec)
            ref = bf16_logits[:1] if batch == 1 else bf16_logits
            rec["vs_bf16"] = compare(
                f"int8 {mode} batch {batch} vs bf16", logits[: ref.shape[0]], ref,
                TOL[f"{resolved}_vs_bf16"],
            )
            out[f"{mode}_b{batch}"] = rec
    return out


def phase_train(cfg: dict, sizes: dict, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from vitax.models import ViT
    from vitax.train import create_train_state, make_optimizer, make_train_step

    s, b = cfg["image_size"], sizes["train_batch"]
    model = ViT(**cfg, dtype=jnp.bfloat16)
    rng = np.random.default_rng(seed + 3)
    imgs = jnp.asarray(rng.normal(size=(b, s, s, 3)), jnp.bfloat16)
    labels = jnp.asarray(rng.integers(0, cfg["num_classes"], b), jnp.int32)
    opt = make_optimizer(LR, grad_clip_norm=1.0)
    state = create_train_state(model, jax.random.PRNGKey(seed), imgs[:1], opt)
    step = make_train_step(model, opt, remat=True, donate=True)
    t0 = time.perf_counter()
    compiled = step.lower(state, imgs, labels).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    mem_fields = {
        k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        ) if mem is not None and hasattr(mem, k)
    }
    losses, times = [], []
    for _ in range(sizes["train_steps"]):
        t = time.perf_counter()
        state, loss = compiled(state, imgs, labels)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    stats = jax.devices()[0].memory_stats() or {}
    out = {
        "batch": b, "compile_s": compile_s, "losses": losses,
        "step_s_after_first": float(np.mean(times[1:])) if len(times) > 1 else times[0],
        "memory_analysis": mem_fields,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }
    log("train", **out)
    check(bool(np.isfinite(losses).all()), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall {losses}")
    return out


def step_gradients(params, new_params) -> list:
    """The gradient a train step applied, per leaf in float64, read back
    from one ``optax.sgd(1.0)`` step: ``new = params - grad``."""
    import jax

    return [
        np.asarray(p, np.float64) - np.asarray(n, np.float64)
        for p, n in zip(jax.tree.leaves(jax.device_get(params)),
                        jax.tree.leaves(jax.device_get(new_params)))
    ]


def gradient_gap(grads: list, ref: list) -> dict:
    """``||grads - ref|| / ||ref||`` over all leaves together, and the
    largest of the same ratio taken leaf by leaf."""
    num = np.array([np.sum((g - r) ** 2) for g, r in zip(grads, ref)])
    den = np.array([np.sum(r**2) for r in ref])
    leaf = np.sqrt(num[den > 0] / den[den > 0])
    return {"global": float(np.sqrt(num.sum() / den.sum())), "worst_leaf": float(leaf.max())}


def phase_four_cards(cfg: dict, sizes: dict, seed: int) -> dict:
    """dp x tp train step on a (data=2, model=2) mesh and data-parallel
    serving on four cards, each against the same work on one card.

    The train steps use ``optax.sgd(1.0)``, so the parameters each step
    returns are the initial ones minus the gradient it computed, and the
    comparison is one of gradients. A planted fault, the one-card step on
    a batch whose second data shard repeats the first (the gradient of one
    shard only), must land outside the limit the mesh step is held to."""
    import jax
    import jax.numpy as jnp
    import optax

    from vitax.models import ViT
    from vitax.parallel import make_mesh
    from vitax.pipeline import InferencePipeline
    from vitax.train import create_train_state, make_train_step, shard_batch

    devices = jax.devices()
    check(len(devices) >= 4, f"four-card run found {len(devices)} device(s)")
    devices = devices[:4]
    s, b = cfg["image_size"], sizes["mesh_train_batch"]
    model = ViT(**cfg, dtype=jnp.bfloat16)
    rng = np.random.default_rng(seed + 4)
    imgs = jnp.asarray(rng.normal(size=(b, s, s, 3)), jnp.bfloat16)
    labels = jnp.asarray(rng.integers(0, cfg["num_classes"], b), jnp.int32)
    opt = optax.sgd(1.0)
    step = make_train_step(model, opt, remat=True)

    one = create_train_state(model, jax.random.PRNGKey(seed), imgs[:1], opt)
    one_new, one_loss = step(one, imgs, labels)
    half = b // 2
    fault_new, _ = step(
        one,
        jnp.concatenate([imgs[:half], imgs[:half]]),
        jnp.concatenate([labels[:half], labels[:half]]),
    )
    mesh = make_mesh(n_data=2, n_model=2, devices=devices)
    four = create_train_state(model, jax.random.PRNGKey(seed), imgs[:1], opt, mesh=mesh)
    four_new, four_loss = step(four, shard_batch(imgs, mesh), shard_batch(labels, mesh))
    g_one = step_gradients(one.params, one_new.params)
    mesh_gap = gradient_gap(step_gradients(one.params, four_new.params), g_one)
    fault_gap = gradient_gap(step_gradients(one.params, fault_new.params), g_one)
    loss_rel = abs(float(four_loss) - float(one_loss)) / abs(float(one_loss))
    train = {
        "batch": b, "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "loss_one": float(one_loss), "loss_mesh": float(four_loss),
        "loss_rel_diff": loss_rel,
        "grad_gap_mesh": mesh_gap, "grad_gap_planted_fault": fault_gap,
        "grad_gap_limit": TOL["mesh_grad_gap"],
    }
    log("four_cards_train", **train)
    # bf16 reduction order only: well inside the bf16 logit budget
    check(loss_rel <= 1e-2, f"mesh loss {float(four_loss)} vs one card {float(one_loss)}")
    check(mesh_gap["global"] <= TOL["mesh_grad_gap"],
          f"mesh gradient differs from one card's by {mesh_gap['global']:.3g} of its norm")
    check(fault_gap["global"] > TOL["mesh_grad_gap"],
          f"a one-shard gradient is within {TOL['mesh_grad_gap']} of the full one "
          f"({fault_gap['global']:.3g}): the gradient check cannot see a lost exchange")

    variables = {"params": one.params}
    raw = rng.integers(0, 256, (sizes["serve_batch"],) + (sizes["decode_size"],) * 2 + (3,), dtype=np.uint8)
    pipe1 = InferencePipeline(model, variables, image_size=s, batch_size=sizes["serve_batch"],
                              batch_buckets=[sizes["serve_batch"]])
    pipe4 = InferencePipeline(model, variables, image_size=s, batch_size=sizes["serve_batch"],
                              mesh=make_mesh(n_data=4, devices=devices))
    serve = compare("four-card data-parallel pipeline vs one card",
                    pipe4(raw), pipe1(raw), TOL["bf16_vs_fp64"])
    return {"train": train, "serve": serve}


def run(cfg: dict, sizes: dict, *, chips: int = 1, seed: int = 0) -> dict:
    """All phases of one run; raises ``SmokeFailure`` on the first failed
    check. ``chips=4`` runs only the four-card phase."""
    import jax.numpy as jnp

    from vitax.utils import enable_compilation_cache

    enable_compilation_cache()
    if chips == 4:
        return {"four_cards": phase_four_cards(cfg, sizes, seed)}
    model, variables = build(cfg, jnp.bfloat16, seed)
    results = {"serve": phase_serve(model, variables, cfg, sizes, seed)}
    results["correctness"], imgs, bf16 = phase_correctness(model, variables, cfg, sizes, seed)
    results["int8"] = phase_int8(model, variables, cfg, sizes, imgs, bf16, seed)
    del variables
    results["train"] = phase_train(cfg, sizes, seed)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    from vitax.utils.device import device_record, nvidia_smi_name_power, require_gpu

    device = require_gpu()
    smi = nvidia_smi_name_power()
    log("device", kind=device.device_kind, count=device_record()["count"], nvidia_smi=smi)
    run(VIT_L16, FULL_SIZES, chips=args.chips)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ahead-of-time export: serialize a compiled serving program to bytes.

A production-serving capability the reference (a library of model
definitions, no runtime) has no equivalent of: the full device program —
preprocess fused with the model forward — is
lowered and serialized as StableHLO via ``jax.export``, so a serving host
can load and run it **without the model code, flax, or the framework's
Python** (only jax + the weights baked into the artifact). The artifact
pins the program: no retracing, no dependency drift, bit-identical
dispatch across hosts.

Shapes are static by design: XLA compiles per shape, so serving exports one program
per batch bucket (the common production pattern) rather than a symbolic
batch dimension. ``export_serving`` takes a list of bucket sizes and packs
them into one artifact; ``ExportedServing.__call__`` pads to the smallest
covering bucket, mirroring ``InferencePipeline``'s fixed-batch padding.
"""

from __future__ import annotations

import io
import zipfile
from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jax_export

_MAGIC = "vitax_aot_v1"


def export_forward(fn: Callable, *example_args,
                   platforms: Optional[Sequence[str]] = None) -> bytes:
    """Serialize ``jit(fn)`` lowered for ``example_args`` to bytes.

    ``platforms`` allows cross-platform export (e.g. lowering for ``cuda``
    from a CPU build host); default is the current backend.
    """
    exp = jax_export.export(
        jax.jit(fn), platforms=platforms,
    )(*jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), jnp.asarray(a).dtype),
        example_args,
    ))
    return exp.serialize()


def load_forward(blob: bytes) -> Callable:
    """Deserialize an ``export_forward`` artifact into a callable."""
    return jax_export.deserialize(blob).call


def export_serving(
    model,
    variables,
    *,
    image_size: int,
    batch_buckets: Sequence[int] = (1, 8, 64),
    decode_size: int = 256,
    dtype=jnp.bfloat16,
    platforms: Optional[Sequence[str]] = None,
    apply_fn: Optional[Callable] = None,
) -> bytes:
    """Package the serving path (uint8 -> preprocess -> logits) with the
    weights baked in, one program per batch bucket, as a single artifact.

    ``apply_fn(variables, x)`` overrides the forward — e.g. the W8A8
    quantized path: ``export_serving(model, qvars, apply_fn=lambda v, x:
    vit_apply_w8a8(model, v, x))`` bakes the int8 weight tables into the
    artifact (half the float artifact's weight bytes).
    """
    from vitax.pipeline import preprocess

    apply = apply_fn if apply_fn is not None else model.apply

    def run(raw):
        x = preprocess(raw, image_size=image_size, dtype=dtype)
        out = apply(variables, x)
        # serving artifact returns classification logits; LeViT's optional
        # (logits, distill) tuple is a train-time shape
        return out[0] if isinstance(out, tuple) else out

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("MAGIC", _MAGIC)
        z.writestr("buckets", ",".join(str(b) for b in sorted(batch_buckets)))
        for b in batch_buckets:
            raw = jnp.zeros((b, decode_size, decode_size, 3), jnp.uint8)
            z.writestr(f"program_{b}", export_forward(run, raw,
                                                      platforms=platforms))
    return buf.getvalue()


class ExportedServing:
    """Load an ``export_serving`` artifact and serve it.

    Pads a ragged batch up to the smallest covering bucket and slices the
    logits back — the same static-shape policy as ``InferencePipeline``,
    but with zero framework imports at serving time.
    """

    def __init__(self, blob: bytes):
        try:
            z = zipfile.ZipFile(io.BytesIO(blob))
            magic = z.read("MAGIC").decode()
        except (zipfile.BadZipFile, KeyError) as e:
            raise ValueError("not a vitax AOT serving artifact") from e
        if magic != _MAGIC:
            raise ValueError("not a vitax AOT serving artifact")
        self.buckets = [int(s) for s in z.read("buckets").decode().split(",")]
        self._programs: Dict[int, Callable] = {
            b: load_forward(z.read(f"program_{b}")) for b in self.buckets
        }

    def __call__(self, raw_images: np.ndarray) -> np.ndarray:
        n = raw_images.shape[0]
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:  # larger than the biggest bucket: chunk it
            big = self.buckets[-1]
            parts = [self(raw_images[i:i + big])
                     for i in range(0, n, big)]
            return np.concatenate(parts, axis=0)
        if n < bucket:
            pad = np.zeros((bucket - n,) + raw_images.shape[1:],
                           raw_images.dtype)
            raw_images = np.concatenate([raw_images, pad], axis=0)
        return np.asarray(self._programs[bucket](raw_images))[:n]

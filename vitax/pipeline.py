"""Device-side preprocessing + batched inference pipeline (SURVEY.md §7.1
item 6; the reference consumes pre-made random tensors and has no data
path at all).

``preprocess`` fuses resize / crop / normalize into the same XLA program as
the model so raw uint8 images go host->device once and everything else
stays on-chip. ``InferencePipeline`` wraps a model with preprocessing,
optional data-parallel sharding, and fixed-batch padding (static shapes —
one compiled program regardless of ragged final batches).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(img: jax.Array, size: Tuple[int, int]) -> jax.Array:
    """Bilinear resize on device, NHWC."""
    b, _, _, c = img.shape
    return jax.image.resize(img, (b, size[0], size[1], c), method="bilinear")


def center_crop(img: jax.Array, size: Tuple[int, int]) -> jax.Array:
    _, h, w, _ = img.shape
    th, tw = size
    top, left = (h - th) // 2, (w - tw) // 2
    return img[:, top : top + th, left : left + tw, :]


def normalize(
    img: jax.Array,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype=jnp.bfloat16,
) -> jax.Array:
    mean = jnp.asarray(mean, jnp.float32)
    std = jnp.asarray(std, jnp.float32)
    return ((img - mean) / std).astype(dtype)


def preprocess(
    raw: jax.Array,
    *,
    image_size: int,
    resize_to: Optional[int] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype=jnp.bfloat16,
) -> jax.Array:
    """uint8/float NHWC -> normalized model input, entirely in-graph.

    Standard eval transform: scale to [0,1], resize so the SHORT side is
    ``resize_to`` (default: image_size * 256 // 224) — aspect ratio
    preserved, the torchvision-equivalent recipe — center-crop, normalize.
    Shapes are static, so the scaled size is plain Python math at trace
    time; square inputs behave exactly as before.
    """
    img = raw.astype(jnp.float32)
    if raw.dtype == jnp.uint8:
        img = img / 255.0
    resize_to = resize_to or max(image_size, int(image_size * 256 / 224))
    _, h, w, _ = img.shape
    scale = resize_to / min(h, w)
    img = resize_bilinear(img, (max(resize_to, round(h * scale)),
                                max(resize_to, round(w * scale))))
    img = center_crop(img, (image_size, image_size))
    return normalize(img, mean, std, dtype)


class InferencePipeline:
    """Preprocess + forward in one compiled program per batch BUCKET, with
    pad-to-bucket and optional data-parallel sharding.

    A single fixed-batch program would pad every 1-3-image batch the
    ``BatchingServer`` forms to the full batch, so ragged batches pad to
    the smallest compiled bucket instead (default: ``batch_size`` divided
    by 4 repeatedly down to 1 — ×4 spacing keeps the compile count small).
    Call ``warm()`` before serving so no bucket compiles mid-traffic."""

    def __init__(
        self,
        model,
        variables,
        *,
        image_size: int,
        batch_size: int = 64,
        batch_buckets: Optional[Sequence[int]] = None,
        mesh=None,
        dtype=jnp.bfloat16,
        apply_fn=None,
    ):
        self.model = model
        self.variables = variables
        self.batch_size = batch_size
        self.image_size = image_size
        self.dtype = dtype
        if mesh is not None and batch_buckets is None:
            # sharded batches must stay divisible by the data axis, which
            # the DEFAULT bucket derivation (down to 1) can't promise —
            # keep the single fixed-batch program. An explicit
            # batch_buckets list is honored as given (validated below).
            batch_buckets = [batch_size]
        elif batch_buckets is None:
            batch_buckets = []
            b = batch_size
            while b >= 1:
                batch_buckets.append(b)
                b //= 4
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets) | {batch_size})
        if mesh is not None:
            from vitax.parallel.mesh import DATA_AXIS as _DA

            n_data = mesh.shape.get(_DA, 1)
            bad = [b for b in self.batch_buckets if b % n_data]
            if bad:
                # fail at construction, not as a GSPMD sharding error on
                # the first small request mid-traffic
                raise ValueError(
                    f"batch_buckets {bad} not divisible by the '{_DA}' "
                    f"mesh axis ({n_data})"
                )

        # apply_fn(variables, x) overrides the forward — e.g. the int8
        # path: InferencePipeline(model, qvars, apply_fn=lambda v, x:
        # vit_apply_w8a8(model, v, x)) serves quantized end-to-end.
        apply = apply_fn if apply_fn is not None else model.apply

        def run(variables, raw):
            x = preprocess(raw, image_size=image_size, dtype=dtype)
            out = apply(variables, x)
            # serving returns classification logits; a (logits, distill)
            # tuple (LeViT's train-time head, models/levit.py) would
            # otherwise be silently sliced along the tuple axis
            return out[0] if isinstance(out, tuple) else out

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from vitax.parallel.mesh import DATA_AXIS

            self._fn = jax.jit(
                run,
                in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P(DATA_AXIS))),
            )
        else:
            self._fn = jax.jit(run)

    def _bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_size

    def warm(self):
        """Compile every bucket program up front (a first compile takes
        tens of seconds for a large model — never pay it mid-traffic)."""
        shape = (self.image_size, self.image_size, 3)
        for b in self.batch_buckets:
            np.asarray(
                self._fn(
                    self.variables, jnp.zeros((b,) + shape, jnp.uint8)
                )
            )
        return self

    def dispatch(self, raw_images: np.ndarray):
        """Asynchronously dispatch a host batch; returns the list of
        in-flight device arrays (one per compiled-batch chunk) without
        blocking — the streaming serving loop (``data.classify_jpeg_stream``)
        decodes the next batch while these compute."""
        n = raw_images.shape[0]
        bs = self.batch_size
        pending = []
        # n == 0 still runs one zero-padded chunk and slices it empty, so
        # an empty poll returns (0, C) like ExportedServing instead of
        # crashing np.concatenate downstream
        for start in range(0, max(n, 1), bs):
            chunk = raw_images[start : start + bs]
            bucket = self._bucket_for(chunk.shape[0])
            pad = bucket - chunk.shape[0]
            if chunk.shape[0] == 0:
                chunk = np.zeros((bucket,) + raw_images.shape[1:], raw_images.dtype)
            elif pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            logits = self._fn(self.variables, jnp.asarray(chunk))
            pending.append(logits[: bucket - pad if pad else bucket])
        return pending

    def __call__(self, raw_images: np.ndarray) -> np.ndarray:
        """Classify a host batch of any size; pads to the compiled batch."""
        return np.concatenate(
            [np.asarray(p) for p in self.dispatch(raw_images)], axis=0
        )

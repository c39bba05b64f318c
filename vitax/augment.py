"""In-graph data augmentation and training regularizers.

The reference (conceptofmind/vit-flax) ships no training code at all
(SURVEY.md §0) — but the ViT-family papers it implements *depend* on these
regularizers to train (DeiT/CaiT: mixup+cutmix+erasing+EMA; LeViT: hard
distillation, levit.py:225's ``distill_head`` exists exactly for this).
This module provides the standard set, designed for accelerators:

- **Everything runs in-graph** (pure ``jnp``/``lax``, static shapes, explicit
  PRNG keys) so the whole augment→forward→backward step is ONE ``jit`` and
  GSPMD shards it over the data mesh like any other batch op. No host-side
  RNG, no per-sample Python, no dynamic shapes.
- Box-shaped augmentations (cutmix, random erasing) are built from `iota`
  grid comparisons — a mask multiply, not a dynamic-shape slice — so XLA
  fuses them into the surrounding elementwise stream.
- Batch-level mixing uses ``jnp.roll`` partners rather than a gathered
  random permutation: a roll is a cheap static rotation (and under GSPMD a
  collective-permute over the data axis), whereas a random gather would
  all-to-all the full image batch across devices.

Composition: ``one_hot`` (with label smoothing) → ``mixup``/``cutmix``/
``mixup_or_cutmix`` (soft targets in, soft targets out) → model →
``soft_cross_entropy``. Pixel-space ops (``random_hflip``, ``random_crop``,
``color_jitter``, ``random_erasing``) take and return NHWC image batches.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# targets


def one_hot(labels: jax.Array, num_classes: int, smoothing: float = 0.0) -> jax.Array:
    """Integer labels → (optionally smoothed) fp32 target distribution.

    With ``smoothing=s`` the true class gets ``1-s`` and every class gets a
    uniform ``s/num_classes`` floor (the usual ViT-recipe smoothing; rows
    still sum to 1).
    """
    t = jax.nn.one_hot(labels, num_classes, dtype=jnp.float32)
    if smoothing:
        t = t * (1.0 - smoothing) + smoothing / num_classes
    return t


def soft_cross_entropy(logits: jax.Array, target_probs: jax.Array) -> jax.Array:
    """Mean cross-entropy against a soft target distribution (fp32 math)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.sum(target_probs * logp, axis=-1))


# ---------------------------------------------------------------------------
# pixel-space augmentations (NHWC batches)


def random_hflip(key: jax.Array, images: jax.Array, prob: float = 0.5) -> jax.Array:
    """Per-sample horizontal flip: a ``where`` between x and x[..., ::-1, :]."""
    flip = jax.random.bernoulli(key, prob, (images.shape[0],))
    return jnp.where(flip[:, None, None, None], images[:, :, ::-1, :], images)


def random_crop(key: jax.Array, images: jax.Array, padding: int = 4) -> jax.Array:
    """Pad-and-crop (the CIFAR-style shift augmentation).

    Zero-pads ``padding`` px on each spatial side, then takes a per-sample
    random H×W window back out with ``lax.dynamic_slice`` under ``vmap`` —
    traced offsets are fine for ``dynamic_slice`` (static *sizes* are what
    XLA needs), so this stays one compiled program for every offset draw.
    """
    b, h, w, c = images.shape
    padded = jnp.pad(images, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    off = jax.random.randint(key, (b, 2), 0, 2 * padding + 1)

    def crop_one(img, o):
        return jax.lax.dynamic_slice(img, (o[0], o[1], 0), (h, w, c))

    return jax.vmap(crop_one)(padded, off)


def color_jitter(
    key: jax.Array,
    images: jax.Array,
    brightness: float = 0.2,
    contrast: float = 0.2,
) -> jax.Array:
    """Per-sample multiplicative brightness and mean-anchored contrast jitter.

    Factors are drawn uniformly from ``[1-x, 1+x]``; contrast scales the
    deviation from the per-image mean. Output dtype follows the input.
    """
    b = images.shape[0]
    kb, kc = jax.random.split(key)
    x = images.astype(jnp.float32)
    if brightness:
        f = jax.random.uniform(kb, (b, 1, 1, 1), minval=1 - brightness, maxval=1 + brightness)
        x = x * f
    if contrast:
        f = jax.random.uniform(kc, (b, 1, 1, 1), minval=1 - contrast, maxval=1 + contrast)
        mean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
        x = mean + (x - mean) * f
    return x.astype(images.dtype)


def _box_mask(key: jax.Array, h: int, w: int, frac: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(h, w) bool mask, True inside a random box covering ~``frac`` of the
    area (side lengths ``sqrt(frac)``), plus the realized area fraction.

    Built from two iota comparisons per axis — static shapes, one fused
    elementwise op. The box is clipped at the image border, so the realized
    fraction (returned) can be below the requested one; cutmix uses it to
    set the exact label weight.
    """
    kx, ky = jax.random.split(key)
    rh = jnp.round(h * jnp.sqrt(frac)).astype(jnp.int32)
    rw = jnp.round(w * jnp.sqrt(frac)).astype(jnp.int32)
    cy = jax.random.randint(ky, (), 0, h)
    cx = jax.random.randint(kx, (), 0, w)
    y0, y1 = jnp.clip(cy - rh // 2, 0, h), jnp.clip(cy + (rh + 1) // 2, 0, h)
    x0, x1 = jnp.clip(cx - rw // 2, 0, w), jnp.clip(cx + (rw + 1) // 2, 0, w)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    mask = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    realized = ((y1 - y0) * (x1 - x0)).astype(jnp.float32) / float(h * w)
    return mask, realized


# ---------------------------------------------------------------------------
# batch-mixing augmentations (soft targets in, soft targets out)


def mixup(
    key: jax.Array,
    images: jax.Array,
    target_probs: jax.Array,
    alpha: float = 0.2,
) -> tuple[jax.Array, jax.Array]:
    """Mixup (Zhang et al.): convex-combine each sample with its roll-by-one
    batch partner; one Beta(α, α) λ per batch (the timm default).
    """
    lam = jax.random.beta(key, alpha, alpha).astype(jnp.float32)
    partner = jnp.roll(images, 1, axis=0)
    mixed = images.astype(jnp.float32) * lam + partner.astype(jnp.float32) * (1 - lam)
    t = target_probs * lam + jnp.roll(target_probs, 1, axis=0) * (1 - lam)
    return mixed.astype(images.dtype), t


def cutmix(
    key: jax.Array,
    images: jax.Array,
    target_probs: jax.Array,
    alpha: float = 1.0,
) -> tuple[jax.Array, jax.Array]:
    """CutMix (Yun et al.): paste a random box from the roll-by-one partner;
    labels mix by the *realized* pasted-area fraction (border clipping makes
    the drawn λ inexact — the realized one keeps targets calibrated).
    """
    kl, kb = jax.random.split(key)
    lam = jax.random.beta(kl, alpha, alpha).astype(jnp.float32)
    mask, pasted = _box_mask(kb, images.shape[1], images.shape[2], 1.0 - lam)
    partner = jnp.roll(images, 1, axis=0)
    mixed = jnp.where(mask[None, :, :, None], partner, images)
    keep = 1.0 - pasted
    t = target_probs * keep + jnp.roll(target_probs, 1, axis=0) * pasted
    return mixed, t


def mixup_or_cutmix(
    key: jax.Array,
    images: jax.Array,
    target_probs: jax.Array,
    mixup_alpha: float = 0.2,
    cutmix_alpha: float = 1.0,
    cutmix_prob: float = 0.5,
) -> tuple[jax.Array, jax.Array]:
    """Flip a coin between mixup and cutmix each batch (the DeiT recipe).
    ``lax.cond`` executes only the chosen branch under jit."""
    kc, ka = jax.random.split(key)
    return jax.lax.cond(
        jax.random.bernoulli(kc, cutmix_prob),
        lambda: cutmix(ka, images, target_probs, cutmix_alpha),
        lambda: mixup(ka, images, target_probs, mixup_alpha),
    )


def random_erasing(
    key: jax.Array,
    images: jax.Array,
    prob: float = 0.25,
    area_range: tuple[float, float] = (0.02, 0.33),
) -> jax.Array:
    """Random erasing (Zhong et al.): per-sample, with probability ``prob``
    zero out a random box covering an area fraction drawn from
    ``area_range``. Per-sample masks via ``vmap`` over ``_box_mask``.
    """
    b, h, w, _ = images.shape
    kp, kf, kb = jax.random.split(key, 3)
    apply = jax.random.bernoulli(kp, prob, (b,))
    frac = jax.random.uniform(kf, (b,), minval=area_range[0], maxval=area_range[1])
    masks, _ = jax.vmap(lambda k, f: _box_mask(k, h, w, f))(
        jax.random.split(kb, b), frac
    )
    erase = masks & apply[:, None, None]
    return jnp.where(erase[..., None], jnp.zeros((), images.dtype), images)


# ---------------------------------------------------------------------------
# EMA of parameters


class Ema(NamedTuple):
    """Exponential moving average of a param tree (the eval-time weights in
    the DeiT/CaiT recipes). ``decay`` is stored so ``update`` stays a pure
    two-arg function that jits/shards like the train step itself."""

    params: any
    decay: float

    @staticmethod
    def init(params, decay: float = 0.9999) -> "Ema":
        return Ema(jax.tree.map(lambda x: x.astype(jnp.float32), params), decay)

    def update(self, new_params) -> "Ema":
        d = self.decay
        return Ema(
            jax.tree.map(
                lambda e, p: e * d + p.astype(jnp.float32) * (1 - d),
                self.params,
                new_params,
            ),
            d,
        )


# ---------------------------------------------------------------------------
# distillation (LeViT's distill head — models/levit.py returns (out, distill))


def distillation_loss(
    logits: jax.Array,
    distill_logits: jax.Array,
    target_probs: jax.Array,
    teacher_logits: jax.Array,
    alpha: float = 0.5,
    tau: float = 1.0,
    hard: bool = True,
) -> jax.Array:
    """LeViT/DeiT distillation objective for a two-head model.

    Classification head trains on ``target_probs``; the distill head trains
    on the teacher — ``hard=True`` is LeViT's recipe (CE on the teacher's
    argmax), ``hard=False`` the soft KL at temperature ``tau`` (scaled by
    τ² so gradients stay comparable across temperatures). ``alpha`` weighs
    the distill term. Teacher logits are stop-gradiented here, so callers
    can pass a live teacher forward without detaching.
    """
    teacher_logits = jax.lax.stop_gradient(teacher_logits.astype(jnp.float32))
    ce = soft_cross_entropy(logits, target_probs)
    if hard:
        t = jax.nn.one_hot(jnp.argmax(teacher_logits, axis=-1), teacher_logits.shape[-1])
        dl = soft_cross_entropy(distill_logits, t)
    else:
        t = jax.nn.softmax(teacher_logits / tau, axis=-1)
        logp = jax.nn.log_softmax(distill_logits.astype(jnp.float32) / tau, axis=-1)
        dl = -jnp.mean(jnp.sum(t * logp, axis=-1)) * tau**2
    return (1 - alpha) * ce + alpha * dl

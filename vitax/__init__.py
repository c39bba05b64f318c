"""vitax: a Vision-Transformer framework in JAX.

Rebuilds the capability surface of ``conceptofmind/vit-flax`` (17 ViT-family
classifiers) as one JAX/XLA framework:

- ``vitax.ops``      — attention, MLP, patch and window primitives in plain
                       JAX.
- ``vitax.nn``       — shared Flax module layer (the reference copy-pastes
                       these primitives into every file; built once here).
- ``vitax.models``   — the 17 model families with reference-compatible
                       constructor signatures.
- ``vitax.parallel`` — mesh construction, data/tensor-parallel sharding.
- ``vitax.train``    — GSPMD train step (augment/distill/QAT/accum hooks),
                       optimizers, schedules, eval.
- ``vitax.augment``  — in-graph mixup/cutmix/flip/erasing, EMA,
                       distillation loss.
- ``vitax.data``     — native JPEG decode; serving stream + training
                       dataset (decode/step overlap).
- ``vitax.serving``  — dynamic request batching onto the compiled batch.
- ``vitax.pipeline`` — device-fused preprocess + forward.

The Flax modules come from the copy in ``vitax._vendor.flax``
(``vitax/_vendor/README.md``), never from an installed Flax.
"""

from vitax.models import *  # noqa: F401,F403

__version__ = "0.1.0"

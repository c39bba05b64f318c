"""Training layer: loss, optimizer wiring, and a sharded train step.

The reference has no training loop (SURVEY.md §0); this provides the
standard JAX one, GSPMD-sharded: parameters are placed with NamedShardings
from the TP rules (vitax.parallel.sharding), the optimizer state inherits
those shardings at ``init``, the batch is sharded over the data axis, and
XLA inserts every collective (grad all-reduce over ``data``, psum over
``model`` on the row-parallel projections). Shardings follow the data — the
step itself is a plain ``jax.jit``.
"""

from __future__ import annotations

import contextlib

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vitax.nn.blocks import remat_scope
from vitax.parallel.mesh import DATA_AXIS
from vitax.parallel.sharding import DEFAULT_TP_RULES, shard_params


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array
    model_state: Any = {}  # e.g. batch_stats for the BatchNorm models


def cross_entropy_loss(logits: jax.Array, labels: jax.Array) -> jax.Array:
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))


def top1_accuracy(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Fraction of rows whose argmax logit equals the label (eval metric)."""
    return jnp.mean((jnp.argmax(logits, axis=-1) == labels).astype(jnp.float32))


def warmup_cosine_schedule(
    base_lr: float, total_steps: int, warmup_steps: int = 0, end_lr_scale: float = 0.0
):
    """Linear warmup to ``base_lr`` then cosine decay to
    ``base_lr * end_lr_scale`` — the standard ViT training schedule (the
    reference has no training layer at all, SURVEY.md §0)."""
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=base_lr,
        warmup_steps=warmup_steps,
        decay_steps=total_steps,
        end_value=base_lr * end_lr_scale,
    )


def make_optimizer(
    learning_rate=1e-3,
    weight_decay: float = 0.05,
    *,
    name: str = "adamw",
    grad_clip_norm: float = None,
    b1: float = 0.9,
    b2: float = 0.999,
):
    """Named optimizer factory with optional global-norm gradient clipping.

    ``learning_rate`` may be a float or any optax schedule (e.g.
    ``warmup_cosine_schedule``). ``grad_clip_norm`` prepends
    ``optax.clip_by_global_norm`` — standard for ViT training stability.

    ``name``:
      - ``"adamw"`` — the default ViT recipe.
      - ``"lamb"`` — layerwise-adaptive Adam; the standard choice when the
        global batch is scaled across a large data mesh (where AdamW needs
        LR re-tuning per batch size).
      - ``"muon"`` — orthogonalized momentum (Newton–Schulz iterations on
        the 2-D gradient blocks). Its per-step extra work is five matmul
        pairs per weight matrix, with Adam handling the non-2-D leaves.
    """
    if name == "adamw":
        tx = optax.adamw(learning_rate, b1=b1, b2=b2, weight_decay=weight_decay)
    elif name == "lamb":
        tx = optax.lamb(learning_rate, b1=b1, b2=b2, weight_decay=weight_decay)
    elif name == "muon":
        tx = optax.contrib.muon(
            learning_rate, weight_decay=weight_decay,
            adam_b1=b1, adam_b2=b2, adam_weight_decay=weight_decay,
        )
    else:
        raise ValueError(f"unknown optimizer {name!r} (adamw|lamb|muon)")
    if grad_clip_norm is not None:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip_norm), tx)
    return tx


def create_train_state(
    model,
    rng: jax.Array,
    sample_images: jax.Array,
    optimizer=None,
    *,
    mesh: Mesh = None,
    tp_rules=DEFAULT_TP_RULES,
    fsdp: bool = False,
) -> TrainState:
    """Init params (TP-sharded over ``mesh`` when given) + optimizer state.

    ``optimizer.init`` runs on the already-sharded params, so the Adam
    moments inherit the same shardings without explicit annotation.

    ``fsdp=True`` additionally shards every big param over the DATA axis
    (ZeRO-3-style, ``parallel.fsdp_param_specs``): per-device param and
    Adam-moment memory divides by the data-axis size, and the unchanged
    GSPMD step all-gathers weights at their use sites and reduce-scatters
    gradients back to the shards.
    """
    variables = model.init({"params": rng}, sample_images)
    params = variables["params"]
    model_state = {k: v for k, v in variables.items() if k != "params"}
    if mesh is not None:
        if fsdp:
            from vitax.parallel.sharding import shard_params_fsdp

            params = shard_params_fsdp(params, mesh, tp_rules)
        else:
            params = shard_params(params, mesh, tp_rules)
        model_state = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())), model_state
        )
    optimizer = optimizer or make_optimizer()
    opt_state = optimizer.init(params)
    return TrainState(params, opt_state, jnp.zeros((), jnp.int32), model_state)


def make_train_step(
    model,
    optimizer=None,
    *,
    dropout_seed: int = 0,
    remat: bool = True,
    augment_fn: Callable = None,
    teacher_apply: Callable = None,
    distill_alpha: float = 0.5,
    distill_tau: float = 1.0,
    distill_hard: bool = True,
    accum_steps: int = 1,
    qat: bool = False,
    moe_aux_weight: float = 0.0,
    donate: bool = False,
) -> Callable:
    """Jitted ``step(state, images, labels) -> (state, loss)``.

    Works on one chip or any mesh: place ``state``/batch with the desired
    shardings (``create_train_state(mesh=...)`` + a ``P('data')`` batch) and
    GSPMD partitions the step accordingly.

    ``accum_steps=K`` turns the step into gradient accumulation: the batch
    is split into K equal microbatches, gradients are computed per
    microbatch under ``lax.scan`` (so only ONE microbatch's activations are
    live at a time — memory scales with batch/K) and averaged before a
    single optimizer update. With the mean losses used here, K microbatch
    gradients average to exactly the full-batch gradient, so results match
    ``accum_steps=1`` up to float re-association (asserted in
    tests/test_augment.py). Dropout/augment rngs fold in the microbatch
    index, and BatchNorm state threads sequentially through the scan.

    ``qat=True`` trains through the weight-only int8 view
    (``utils.quantize.fake_quantize_weights``): the forward sees exactly
    the rounded weights the deployed ``quantized_apply`` will use, the
    backward passes straight through to the float master weights, so the
    post-training ``quantize_weights`` checkpoint costs (almost) nothing.

    ``moe_aux_weight > 0`` adds the mean of every sown MoE load-balance
    loss (``nn/moe.py``, ``intermediates/moe_aux_loss``) to the training
    loss — the standard Switch/V-MoE router regularizer.

    ``remat=True`` (default) checkpoints each scanned encoder block — the
    backward recomputes activations instead of keeping ``depth`` layers of
    attention intermediates alive. Set ``remat=False`` for small models
    where the recompute FLOPs could outweigh the memory savings.

    ``augment_fn(rng, images, labels) -> (images, target_probs)`` runs
    batch augmentation *inside* the jitted step (so GSPMD shards it with
    the batch) and switches the loss to soft targets — compose it from
    ``vitax.augment`` (mixup/cutmix/flip/erasing + ``one_hot``). The rng
    is folded from ``state.step`` like dropout's, so steps stay
    reproducible and retry-idempotent.

    ``teacher_apply(images) -> teacher_logits`` enables distillation
    against a frozen teacher (``vitax.augment.distillation_loss``). For a
    two-head student (LeViT with ``num_distill_classes``) the distill head
    trains on the teacher; single-head students distill on their one head.
    """
    optimizer = optimizer or make_optimizer()

    def step(state: TrainState, images: jax.Array, labels: jax.Array):
        has_state = bool(jax.tree_util.tree_leaves(state.model_state))
        step_rng = jax.random.fold_in(jax.random.PRNGKey(dropout_seed), state.step)

        def grads_of(model_state, imgs, lbls, rng):
            """(loss, new_model_state), grads for one (micro)batch."""
            if augment_fn is not None:
                aug_images, targets = augment_fn(
                    jax.random.fold_in(rng, 1), imgs, lbls
                )
            else:
                aug_images, targets = imgs, lbls

            def loss_fn(params):
                if qat:
                    from vitax.utils.quantize import fake_quantize_weights

                    params = fake_quantize_weights(params)
                rngs = {"dropout": rng}
                # MoE models sow their load-balance loss under
                # 'intermediates' (nn/moe.py); collect it when weighted.
                mutable = list(model_state.keys()) if has_state else []
                if moe_aux_weight:
                    mutable = mutable + ["intermediates"]
                scope = remat_scope() if remat else contextlib.nullcontext()
                with scope:
                    if mutable:
                        # BatchNorm state and/or sown intermediates
                        logits, mut_out = model.apply(
                            {"params": params, **model_state},
                            aug_images, True,
                            mutable=mutable,
                            rngs=rngs,
                        )
                        mut_out = dict(mut_out)
                    else:
                        logits = model.apply(
                            {"params": params}, aug_images, True, rngs=rngs
                        )
                        mut_out = {}
                inter = mut_out.pop("intermediates", None)
                new_state = mut_out if has_state else model_state
                distill_logits = None
                if isinstance(logits, tuple):  # LeViT distillation head
                    logits, distill_logits = logits
                if teacher_apply is not None:
                    from vitax.augment import distillation_loss, one_hot

                    t = targets if augment_fn is not None else one_hot(
                        lbls, logits.shape[-1]
                    )
                    loss = distillation_loss(
                        logits,
                        logits if distill_logits is None else distill_logits,
                        t,
                        teacher_apply(aug_images),
                        alpha=distill_alpha,
                        tau=distill_tau,
                        hard=distill_hard,
                    )
                elif augment_fn is not None:
                    from vitax.augment import soft_cross_entropy

                    loss = soft_cross_entropy(logits, targets)
                else:
                    loss = cross_entropy_loss(logits, lbls)
                if moe_aux_weight and inter is not None:
                    terms = jax.tree_util.tree_leaves(inter)
                    if terms:
                        loss = loss + moe_aux_weight * (
                            sum(terms) / len(terms)
                        )
                return loss, new_state

            return jax.value_and_grad(loss_fn, has_aux=True)(state.params)

        if accum_steps == 1:
            (loss, new_state), grads = grads_of(
                state.model_state, images, labels, step_rng
            )
        else:
            assert images.shape[0] % accum_steps == 0, (
                f"batch {images.shape[0]} not divisible by accum_steps {accum_steps}"
            )
            micro_imgs = images.reshape(accum_steps, -1, *images.shape[1:])
            micro_lbls = labels.reshape(accum_steps, -1)

            def micro(carry, inp):
                gsum, lsum, mstate = carry
                i, imgs_i, lbls_i = inp
                (loss_i, mstate), g = grads_of(
                    mstate, imgs_i, lbls_i, jax.random.fold_in(step_rng, i + 2)
                )
                gsum = jax.tree.map(
                    lambda a, b: a + b.astype(jnp.float32), gsum, g
                )
                return (gsum, lsum + loss_i, mstate), ()

            zero_g = jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), state.params
            )
            (gsum, lsum, new_state), _ = jax.lax.scan(
                micro,
                (zero_g, jnp.zeros((), jnp.float32), state.model_state),
                (jnp.arange(accum_steps), micro_imgs, micro_lbls),
            )
            grads = jax.tree.map(
                lambda g, p: (g / accum_steps).astype(p.dtype), gsum, state.params
            )
            loss = lsum / accum_steps

        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1, new_state), loss

    # donate=True hands the old state's buffers to XLA (callers overwrite:
    # `state, loss = step(state, ...)`), halving the transient params +
    # optimizer-moment footprint at the update. Off by default because a
    # donated state is unusable afterwards — tests and A/B comparisons
    # legitimately step the SAME initial state through two step functions.
    return jax.jit(step, donate_argnums=(0,) if donate else ())


_EVAL_STEP_CACHE: dict = {}


def make_eval_step(model) -> Callable:
    """Jitted ``eval_step(variables, images, labels) -> (loss, top1)``.

    ``variables`` is the full tree ({'params': ..., 'batch_stats': ...} for
    the BN models); inference mode, deterministic."""

    @jax.jit
    def step(variables, images, labels):
        logits = model.apply(variables, images)
        if isinstance(logits, tuple):  # LeViT distillation head
            logits = logits[0]
        return cross_entropy_loss(logits, labels), top1_accuracy(logits, labels)

    return step


def evaluate(model, variables, batches) -> dict:
    """Stream ``(images, labels)`` batches through the deterministic eval
    step and return sample-weighted ``{"loss", "top1", "samples"}``.

    ``batches`` is any iterable — e.g. ``JpegFolderDataset.epoch(0)``
    (decode of batch k+1 overlaps the device eval of batch k) or a list of
    in-memory pairs. One compiled step serves every equal-shaped batch,
    and the step is cached per model so a per-epoch ``evaluate()`` call in
    a training loop reuses one executable instead of re-jitting each time.
    """
    try:  # linen modules are frozen dataclasses — hashable unless a field isn't
        step = _EVAL_STEP_CACHE.get(model)
        if step is None:
            step = _EVAL_STEP_CACHE[model] = make_eval_step(model)
    except TypeError:  # unhashable config field (e.g. injected module list)
        step = make_eval_step(model)
    n = 0
    loss_sum = 0.0
    acc_sum = 0.0
    for images, labels in batches:
        loss, top1 = step(variables, images, labels)
        b = int(labels.shape[0])
        loss_sum += float(loss) * b
        acc_sum += float(top1) * b
        n += b
    if n == 0:
        raise ValueError("evaluate() got an empty batch iterable")
    return {"loss": loss_sum / n, "top1": acc_sum / n, "samples": n}


def shard_batch(batch: jax.Array, mesh: Mesh) -> jax.Array:
    return jax.device_put(batch, NamedSharding(mesh, P(DATA_AXIS)))


def make_shard_map_train_step(
    model, mesh: Mesh, optimizer=None, *, dropout_seed: int = 0,
    donate: bool = False,
) -> Callable:
    """Data-parallel train step written with ``shard_map``.

    Each device traces a complete per-device program and the only
    collectives are the explicit gradient/loss ``pmean`` over the data axis
    (plus a ``pmean`` of mutable model state, e.g. cross-replica BatchNorm
    statistics). Parameters and optimizer state are replicated; use the
    GSPMD step when tensor parallelism is needed.

    Returns ``step(state, images, labels) -> (state, loss)``; place the
    batch with ``shard_batch``.
    """
    optimizer = optimizer or make_optimizer()

    def per_device(state: TrainState, images: jax.Array, labels: jax.Array):
        has_state = bool(jax.tree_util.tree_leaves(state.model_state))

        def loss_fn(params):
            # independent dropout per data shard
            rng = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(dropout_seed), state.step),
                jax.lax.axis_index(DATA_AXIS),
            )
            rngs = {"dropout": rng}
            if has_state:
                logits, new_state = model.apply(
                    {"params": params, **state.model_state},
                    images, True,
                    mutable=list(state.model_state.keys()),
                    rngs=rngs,
                )
            else:
                logits = model.apply({"params": params}, images, True, rngs=rngs)
                new_state = state.model_state
            if isinstance(logits, tuple):  # LeViT distillation head
                logits = logits[0]
            return cross_entropy_loss(logits, labels), new_state

        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        grads = jax.lax.pmean(grads, DATA_AXIS)
        loss = jax.lax.pmean(loss, DATA_AXIS)
        # cross-replica sync of mutable state (BatchNorm running stats)
        new_state = jax.tree.map(
            lambda x: jax.lax.pmean(x, DATA_AXIS)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            new_state,
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1, new_state), loss

    from jax import shard_map

    rep = P()
    step = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(rep, P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(rep, rep),
        check_vma=False,
    )
    # see make_train_step on donate
    return jax.jit(step, donate_argnums=(0,) if donate else ())

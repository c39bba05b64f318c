"""Augmentation / regularizer tests (vitax/augment.py).

Everything must hold under jit with static shapes — these are in-graph
batch ops meant to live inside the sharded train step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitax import augment
from vitax.models import ViT
from vitax.models.levit import LeViT
from vitax.train import (
    create_train_state,
    cross_entropy_loss,
    make_optimizer,
    make_train_step,
)

KEY = jax.random.PRNGKey(0)
IMG = jax.random.normal(jax.random.PRNGKey(1), (8, 16, 16, 3))
LABELS = jnp.arange(8) % 4


def test_one_hot_smoothing():
    t = augment.one_hot(LABELS, 4, smoothing=0.1)
    np.testing.assert_allclose(np.sum(t, axis=-1), 1.0, rtol=1e-6)
    assert np.allclose(t[0, 0], 0.9 + 0.1 / 4)
    assert np.allclose(t[0, 1], 0.1 / 4)


def test_soft_ce_matches_hard_ce_on_onehot():
    logits = jax.random.normal(KEY, (8, 4))
    hard = cross_entropy_loss(logits, LABELS)
    soft = augment.soft_cross_entropy(logits, augment.one_hot(LABELS, 4))
    np.testing.assert_allclose(float(hard), float(soft), rtol=1e-6)


def test_hflip_prob_edges():
    out0 = augment.random_hflip(KEY, IMG, prob=0.0)
    out1 = augment.random_hflip(KEY, IMG, prob=1.0)
    np.testing.assert_array_equal(np.asarray(out0), np.asarray(IMG))
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(IMG[:, :, ::-1, :]))


def test_random_crop_zero_padding_is_identity_and_shape():
    out = augment.random_crop(KEY, IMG, padding=0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(IMG))
    out = jax.jit(lambda k, x: augment.random_crop(k, x, padding=3))(KEY, IMG)
    assert out.shape == IMG.shape
    # crops of a zero-padded image only move mass around or zero it
    assert float(jnp.sum(jnp.abs(out))) <= float(jnp.sum(jnp.abs(IMG))) + 1e-4


def test_color_jitter_zero_is_identity():
    out = augment.color_jitter(KEY, IMG, brightness=0.0, contrast=0.0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(IMG))


def test_mixup_preserves_batch_mean_and_target_rows():
    t = augment.one_hot(LABELS, 4)
    mixed, tm = jax.jit(lambda k, x, t: augment.mixup(k, x, t, alpha=0.4))(KEY, IMG, t)
    assert mixed.shape == IMG.shape
    # roll partner has the same batch mean, so any lam preserves it
    np.testing.assert_allclose(
        float(jnp.mean(mixed)), float(jnp.mean(IMG)), rtol=1e-5
    )
    np.testing.assert_allclose(np.sum(np.asarray(tm), axis=-1), 1.0, rtol=1e-5)


def test_cutmix_pixels_come_from_one_source_and_weights_match_area():
    t = augment.one_hot(LABELS, 4)
    mixed, tm = jax.jit(lambda k, x, t: augment.cutmix(k, x, t, alpha=1.0))(KEY, IMG, t)
    x = np.asarray(IMG)
    partner = np.roll(x, 1, axis=0)
    m = np.asarray(mixed)
    from_self = np.isclose(m, x)
    from_partner = np.isclose(m, partner)
    assert np.all(from_self | from_partner)
    # label weight on the partner class == pasted-area fraction
    pasted = np.mean(from_partner[0] & ~from_self[0])
    tmn = np.asarray(tm)
    np.testing.assert_allclose(np.sum(tmn, axis=-1), 1.0, rtol=1e-5)
    # row 0's partner label is row 7's label (roll by 1)
    partner_w = tmn[0, int(LABELS[7])]
    np.testing.assert_allclose(partner_w, pasted, atol=0.02)


def test_mixup_or_cutmix_jits():
    t = augment.one_hot(LABELS, 4)
    mixed, tm = jax.jit(augment.mixup_or_cutmix)(KEY, IMG, t)
    assert mixed.shape == IMG.shape and tm.shape == t.shape


def test_random_erasing_edges():
    out0 = augment.random_erasing(KEY, IMG, prob=0.0)
    np.testing.assert_array_equal(np.asarray(out0), np.asarray(IMG))
    out1 = jax.jit(lambda k, x: augment.random_erasing(k, x, prob=1.0))(KEY, IMG)
    zeroed = np.mean(np.asarray(out1) == 0.0, axis=(1, 2, 3))
    assert np.all(zeroed > 0)  # every sample lost a box
    assert np.all(zeroed < 0.6)  # bounded by area_range max + clipping slack


def test_ema_converges_and_decay_zero_tracks():
    params = {"w": jnp.ones((4,)), "b": jnp.zeros((2,))}
    ema = augment.Ema.init(params, decay=0.0)
    new = {"w": jnp.full((4,), 3.0), "b": jnp.ones((2,))}
    ema = ema.update(new)
    np.testing.assert_allclose(np.asarray(ema.params["w"]), 3.0)

    ema = augment.Ema.init({"w": jnp.zeros((4,))}, decay=0.5)
    for _ in range(30):
        ema = ema.update({"w": jnp.ones((4,))})
    np.testing.assert_allclose(np.asarray(ema.params["w"]), 1.0, atol=1e-6)


def test_distillation_loss_alpha_zero_is_plain_ce():
    logits = jax.random.normal(KEY, (8, 4))
    teacher = jax.random.normal(jax.random.PRNGKey(2), (8, 4))
    t = augment.one_hot(LABELS, 4)
    l0 = augment.distillation_loss(logits, logits, t, teacher, alpha=0.0)
    np.testing.assert_allclose(
        float(l0), float(augment.soft_cross_entropy(logits, t)), rtol=1e-6
    )
    # soft mode at tau=1, alpha=1 reduces to CE vs teacher softmax
    l1 = augment.distillation_loss(
        logits, logits, t, teacher, alpha=1.0, hard=False, tau=1.0
    )
    expect = augment.soft_cross_entropy(logits, jax.nn.softmax(teacher, axis=-1))
    np.testing.assert_allclose(float(l1), float(expect), rtol=1e-6)
    # teacher side carries no gradient
    g = jax.grad(
        lambda tl: augment.distillation_loss(logits, logits, t, tl, alpha=1.0)
    )(teacher)
    np.testing.assert_allclose(np.asarray(g), 0.0)


def test_augmented_train_step_learns():
    model = ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=2,
                heads=2, dim_head=16, mlp_dim=64)
    state = create_train_state(model, KEY, IMG[:2])

    def augment_fn(rng, images, labels):
        t = augment.one_hot(labels, 4, smoothing=0.1)
        k1, k2 = jax.random.split(rng)
        images = augment.random_hflip(k1, images)
        return augment.mixup_or_cutmix(k2, images, t)

    step = make_train_step(
        model, make_optimizer(1e-2), augment_fn=augment_fn, remat=False
    )
    losses = []
    for _ in range(6):
        state, loss = step(state, IMG, LABELS)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_distill_train_step_two_heads():
    student = LeViT(
        image_size=64, num_classes=4, stages=2, dim=(32, 32), depth=1,
        heads=(1, 2), mlp_mult=2, dim_key=16, dim_value=16,
        num_distill_classes=4,
    )
    big_img = jax.random.normal(jax.random.PRNGKey(4), (8, 64, 64, 3))
    teacher = ViT(image_size=64, patch_size=16, num_classes=4, dim=32, depth=1,
                  heads=2, dim_head=16, mlp_dim=64)
    tvars = teacher.init({"params": jax.random.PRNGKey(3)}, big_img[:2])
    teacher_apply = lambda x: teacher.apply(tvars, x)

    state = create_train_state(student, KEY, big_img[:2])
    step = make_train_step(
        student, make_optimizer(1e-2), teacher_apply=teacher_apply, remat=False
    )
    state2, loss = step(state, big_img, LABELS)
    assert np.isfinite(float(loss))
    # params actually moved (distill head included)
    moved = jax.tree.map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))), state.params, state2.params
    )
    assert max(jax.tree.leaves(moved)) > 0


def test_grad_accumulation_matches_full_batch():
    model = ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=2,
                heads=2, dim_head=16, mlp_dim=64)
    state = create_train_state(model, KEY, IMG[:2])
    step1 = make_train_step(model, make_optimizer(1e-2), remat=False)
    step4 = make_train_step(model, make_optimizer(1e-2), remat=False,
                            accum_steps=4)
    s1, l1 = step1(state, IMG, LABELS)
    s4, l4 = step4(state, IMG, LABELS)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s4.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_grad_accumulation_bn_model():
    model = LeViT(image_size=64, num_classes=4, stages=2, dim=(32, 32), depth=1,
                  heads=(1, 2), mlp_mult=2, dim_key=16, dim_value=16)
    big_img = jax.random.normal(jax.random.PRNGKey(4), (8, 64, 64, 3))
    state = create_train_state(model, KEY, big_img[:2])
    step = make_train_step(model, make_optimizer(1e-2), remat=False,
                           accum_steps=2)
    state2, loss = step(state, big_img, LABELS)
    assert np.isfinite(float(loss))
    # BatchNorm running stats moved through the scan
    moved = jax.tree.map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))),
        state.model_state, state2.model_state,
    )
    assert max(jax.tree.leaves(moved)) > 0


def test_evaluate_streams_dataset():
    from vitax.train import evaluate, make_eval_step

    model = ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=1,
                heads=2, dim_head=16, mlp_dim=64)
    variables = model.init({"params": KEY}, IMG[:2])
    batches = [(IMG[:4], LABELS[:4]), (IMG[4:], LABELS[4:])]
    out = evaluate(model, variables, batches)
    assert out["samples"] == 8
    # sample-weighted average equals the full-batch eval (equal halves)
    loss, top1 = make_eval_step(model)(variables, IMG, LABELS)
    np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(out["top1"], float(top1), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "lamb", "muon"])
def test_named_optimizers_learn(name):
    model = ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=1,
                heads=2, dim_head=16, mlp_dim=64)
    opt = make_optimizer(1e-2, name=name, grad_clip_norm=1.0)
    state = create_train_state(model, KEY, IMG[:2], optimizer=opt)
    step = make_train_step(model, opt, remat=False)
    losses = []
    for _ in range(8):
        state, loss = step(state, IMG, LABELS)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (name, losses)

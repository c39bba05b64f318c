"""End-to-end training example: any of the 17 model families, synthetic or
folder-of-JPEGs data, single chip or a dp x tp mesh.

  python examples/train.py --model vit --steps 20            # synthetic, 1 chip
  python examples/train.py --model crossformer --dp 4 --tp 2 # 8-device mesh
  python examples/train.py --data /path/to/jpegs --labels labels.txt

The reference repo has no training loop (SURVEY.md §0); this is the
framework's canonical one: create_train_state places params with the TP
sharding rules, make_train_step is GSPMD-partitioned with per-block
rematerialization, and checkpoints round-trip through orbax
(vitax.utils.checkpoint).
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vit", help="MODEL_REGISTRY name")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis")
    ap.add_argument("--data", default=None, help="directory of JPEGs (synthetic if unset)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="CheckpointManager run dir: step-numbered saves, "
                         "keeps the newest 3, async")
    ap.add_argument("--save-every", type=int, default=100,
                    help="checkpoint cadence in steps")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="restore the latest step from a --checkpoint-dir "
                         "run and continue — onto THIS run's --dp/--tp mesh, "
                         "whatever topology the save used")
    ap.add_argument("--augment", action="store_true",
                    help="in-graph flip + mixup/cutmix + label smoothing 0.1")
    ap.add_argument("--ema", type=float, default=None, metavar="DECAY",
                    help="track an EMA of the params (e.g. 0.9999)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "lamb", "muon"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (set before first device use)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from vitax.models import MODEL_REGISTRY
    from vitax.train import (
        create_train_state, make_optimizer, make_train_step, shard_batch,
    )
    from vitax.parallel import make_mesh

    model_cls, default_cfg, default_size = MODEL_REGISTRY[args.model]
    cfg = dict(default_cfg)
    cfg.update(num_classes=args.classes)
    if "image_size" in cfg:
        cfg["image_size"] = args.image_size
    else:
        args.image_size = default_size
    model = model_cls(**cfg, dtype=jnp.bfloat16)

    mesh = None
    if args.dp * args.tp > 1:
        mesh = make_mesh(n_data=args.dp, n_model=args.tp)

    dataset = None
    if args.data:
        import pathlib

        from vitax.data import JpegFolderDataset

        files = sorted(pathlib.Path(args.data).glob("*.jpg"))
        # label = folder-order index mod classes (replace with a real label
        # map); mesh= yields batches pre-sharded P('data') for the step
        dataset = JpegFolderDataset(
            [(str(f), i % args.classes) for i, f in enumerate(files)],
            args.batch, size=args.image_size, mesh=mesh,
        )
        images, labels = next(iter(dataset.epoch(0)))  # shapes for init
    else:
        images = jax.random.normal(
            jax.random.PRNGKey(0),
            (args.batch, args.image_size, args.image_size, 3),
            jnp.bfloat16,
        )
        labels = jnp.arange(args.batch) % args.classes

    optimizer = make_optimizer(args.lr, name=args.optimizer, grad_clip_norm=1.0)

    mgr = None
    if args.checkpoint_dir:
        from vitax.utils.checkpoint import CheckpointManager  # noqa: PLC0415

        mgr = CheckpointManager(args.checkpoint_dir, max_to_keep=3,
                                save_interval_steps=args.save_every)

    if args.resume:
        # cross-topology resume: the abstract target carries THIS run's
        # mesh shardings, so a save from any dp x tp layout re-lands here
        import os

        from vitax.utils.checkpoint import CheckpointManager, abstract_train_state

        target = abstract_train_state(model, images[:1], optimizer, mesh=mesh)
        if mgr is not None and os.path.abspath(args.resume) == os.path.abspath(
            args.checkpoint_dir
        ):
            # resuming into the same run dir: one manager does both — two
            # managers on one directory race retention
            state = mgr.restore(target=target)
        else:
            # the restore manager's background threads must be joined
            with CheckpointManager(args.resume) as restore_mgr:
                state = restore_mgr.restore(target=target)
        print(f"resumed from {args.resume} at step {int(state.step)}")
    else:
        state = create_train_state(model, jax.random.PRNGKey(1), images[:1],
                                   optimizer=optimizer, mesh=mesh)

    augment_fn = None
    if args.augment:
        from vitax import augment as aug

        def augment_fn(rng, imgs, lbls):
            t = aug.one_hot(lbls, args.classes, smoothing=0.1)
            k1, k2 = jax.random.split(rng)
            return aug.mixup_or_cutmix(k2, aug.random_hflip(k1, imgs), t)

    # donate: the loop overwrites state each step, so XLA reuses the old
    # params/opt-moment buffers instead of holding both during the update
    step = make_train_step(model, optimizer, augment_fn=augment_fn,
                           accum_steps=args.accum, donate=True)

    ema = None
    if args.ema is not None:
        from vitax.augment import Ema

        ema = Ema.init(state.params, decay=args.ema)
        ema_update = jax.jit(lambda e, p: e.update(p))

    if mesh is not None:
        images = shard_batch(images, mesh)
        labels = shard_batch(labels, mesh)

    if dataset is not None:
        # shuffled epochs, background decode, device prefetch; batches
        # arrive already sharded when a mesh is set (mesh= above)
        stream = dataset.epochs(-(-args.steps // len(dataset)))
        def next_batch():
            _, imgs, lbls = next(stream)
            return imgs, lbls
    else:
        def next_batch():
            return images, labels

    # track the step counter on the host: int(state.step)/float(loss) every
    # iteration are device syncs that defeat async dispatch —
    # materialize them only when printing or when a save will actually write
    host_step = int(state.step)
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, loss = step(state, *next_batch())
        host_step += 1
        if ema is not None:
            ema = ema_update(ema, state.params)
        if i == 0:
            np.asarray(loss)  # compile barrier
            print(f"compiled in {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
        if (i + 1) % 5 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}")
        if mgr is not None and mgr.should_save(host_step):
            # device->host copy here; serialization overlaps the next steps
            mgr.save(host_step, state, metrics={"loss": float(loss)})
    np.asarray(loss)
    dt = (time.perf_counter() - t0) / max(1, args.steps - 1)
    print(f"{args.batch / dt:.1f} img/s ({dt * 1e3:.1f} ms/step)")

    if mgr is not None:
        mgr.save(host_step, state, metrics={"loss": float(loss)},
                 force=True)  # always persist the final state
        mgr.wait()
        print(f"checkpoints at steps {mgr.all_steps()} in {args.checkpoint_dir}")
        mgr.close()


if __name__ == "__main__":
    main()

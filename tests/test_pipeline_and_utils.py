"""Tests for the preprocessing pipeline, checkpointing, and profiling utils."""

import numpy as np
import jax
import jax.numpy as jnp

from vitax.models import ViT
from vitax.pipeline import InferencePipeline, center_crop, preprocess

MODEL = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=1,
            heads=4, mlp_dim=128, dim_head=16)


def _variables():
    img = jnp.ones((1, 32, 32, 3))
    return MODEL.init({"params": jax.random.PRNGKey(0)}, img)


def test_preprocess_shapes_and_dtype():
    raw = (np.random.rand(2, 48, 48, 3) * 255).astype(np.uint8)
    out = preprocess(jnp.asarray(raw), image_size=32, dtype=jnp.float32)
    assert out.shape == (2, 32, 32, 3)
    assert out.dtype == jnp.float32


def test_center_crop():
    x = jnp.arange(5 * 5, dtype=jnp.float32).reshape(1, 5, 5, 1)
    c = center_crop(x, (3, 3))
    np.testing.assert_array_equal(np.asarray(c[0, :, :, 0]),
                                  np.asarray(x[0, 1:4, 1:4, 0]))


def test_pipeline_ragged_batches():
    variables = _variables()
    pipe = InferencePipeline(MODEL, variables, image_size=32, batch_size=4,
                             dtype=jnp.float32)
    raw = (np.random.rand(6, 40, 40, 3) * 255).astype(np.uint8)
    out = pipe(raw)
    assert out.shape == (6, 10)
    # same images in a different batching give the same logits
    out2 = pipe(raw[:3])
    np.testing.assert_allclose(out[:3], out2, atol=1e-5)


def test_pipeline_batch_buckets():
    """Ragged batches pad to the smallest compiled BUCKET, not the full
    batch (the round-4 serving-latency fix): every bucket program produces
    the same logits, warm() precompiles them all, and n=0 still returns
    (0, C)."""
    variables = _variables()
    pipe = InferencePipeline(MODEL, variables, image_size=32, batch_size=16,
                             dtype=jnp.float32).warm()
    assert pipe.batch_buckets == [1, 4, 16]
    assert [pipe._bucket_for(n) for n in (0, 1, 2, 4, 5, 16, 40)] == \
        [1, 1, 4, 4, 16, 16, 16]
    raw = (np.random.rand(16, 40, 40, 3) * 255).astype(np.uint8)
    full = pipe(raw)
    for n in (1, 2, 5):  # bucket-1, bucket-4 (padded), bucket-16 (padded)
        np.testing.assert_allclose(pipe(raw[:n]), full[:n], atol=1e-5)
    assert pipe(raw[:0]).shape == (0, 10)


def test_aot_export_roundtrip():
    """AOT serving artifact: export the fused preprocess+model program with
    weights baked in, reload it from bytes, and serve — logits must match
    the live InferencePipeline, including ragged batches (bucket padding)
    and batches beyond the largest bucket (chunking)."""
    from vitax.utils.aot import ExportedServing, export_serving

    variables = _variables()
    blob = export_serving(MODEL, variables, image_size=32,
                          batch_buckets=(2, 4), decode_size=40,
                          dtype=jnp.float32)
    served = ExportedServing(blob)
    pipe = InferencePipeline(MODEL, variables, image_size=32, batch_size=4,
                             dtype=jnp.float32)

    raw = (np.random.rand(3, 40, 40, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(served(raw), np.asarray(pipe(raw)),
                               atol=1e-5)  # ragged: pads 3 -> bucket 4
    raw9 = (np.random.rand(9, 40, 40, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(served(raw9), np.asarray(pipe(raw9)),
                               atol=1e-5)  # 9 > max bucket: chunked 4+4+1


def test_checkpoint_roundtrip(tmp_path):
    from vitax.utils.checkpoint import restore_checkpoint, save_checkpoint

    variables = _variables()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, variables)
    restored = restore_checkpoint(path, target=variables)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 variables, restored)


def test_cost_analysis_reports_flops():
    from vitax.utils.profiling import cost_analysis

    variables = _variables()
    img = jnp.ones((4, 32, 32, 3))
    costs = cost_analysis(lambda v, x: MODEL.apply(v, x), variables, img)
    assert costs.get("flops", 0) > 1e6


def test_benchmark_timer():
    from vitax.utils.profiling import benchmark

    variables = _variables()
    img = jnp.ones((4, 32, 32, 3))
    fn = jax.jit(lambda v, x: MODEL.apply(v, x))
    stats = benchmark(fn, variables, img, iters=3, warmup=1, items_per_call=4)
    assert stats["p50_s"] > 0 and stats["items_per_sec"] > 0


def test_health_probe_and_retry():
    from vitax.utils import probe_devices, with_retry

    report = probe_devices()
    assert report["ok"] and report["devices"] == 8
    assert report["collective_ok"]

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("transient")
        return 42

    assert with_retry(flaky, attempts=3, backoff_s=0.0)() == 42


def test_checked_catches_nan():
    from vitax.utils import checked

    def bad(x):
        return jnp.log(x)  # NaN for negative input

    safe = checked(jax.jit(bad))
    safe(jnp.ones((4,)))  # fine
    import pytest as _pytest
    with _pytest.raises(Exception):
        safe(-jnp.ones((4,)))


def test_train_state_checkpoint_roundtrip(tmp_path):
    from vitax.train import create_train_state
    from vitax.utils.checkpoint import restore_checkpoint, save_checkpoint

    img = jnp.ones((1, 32, 32, 3))
    state = create_train_state(MODEL, jax.random.PRNGKey(0), img)
    path = str(tmp_path / "train_ckpt")
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, target=state)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        state.params, restored.params,
    )
    assert int(restored.step) == 0


def test_registry_covers_all_18_families():
    # 17 reference model families + the dependency-injected shell
    # (efficient.py), all constructible from the registry.
    from vitax.models import MODEL_REGISTRY

    assert len(MODEL_REGISTRY) == 18
    assert "efficient" in MODEL_REGISTRY


import pytest


class TestJpegDecode:
    def _jpegs(self, n=4, sizes=((300, 400), (256, 256), (64, 100), (500, 333))):
        from PIL import Image
        import io as _io

        rng = np.random.default_rng(0)
        jpegs, arrays = [], []
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            buf = _io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=95)
            jpegs.append(buf.getvalue())
            arrays.append(arr)
        return jpegs, arrays

    def test_native_decode_matches_pil(self):
        """The native libjpeg decode must match PIL's (same libjpeg) and the
        resize must match the numpy mirror of the kernel's math."""
        from vitax.data import JpegDecoder, _resize_bilinear_u8
        from PIL import Image
        import io as _io

        dec = JpegDecoder(size=224)
        if dec.backend != "native":
            pytest.skip("native decoder not built (no toolchain)")
        jpegs, _ = self._jpegs()
        out = dec(jpegs)
        assert out.shape == (4, 224, 224, 3) and out.dtype == np.uint8
        for i, raw in enumerate(jpegs):
            pil = np.asarray(Image.open(_io.BytesIO(raw)).convert("RGB"))
            ref = _resize_bilinear_u8(pil, 224)
            # decode is the same libjpeg; resize is the same formula in
            # fp32 — allow 1 ulp of uint8 rounding skew
            diff = np.abs(out[i].astype(int) - ref.astype(int))
            assert diff.max() <= 1, diff.max()

    def test_fast_decode_dct_scaling(self):
        """fast=True decodes at a power-of-two IDCT scale (>= the target on
        both axes). Sources under 2x the target must be bit-identical to the
        exact path; larger sources may differ only by the low-pass the DCT
        scaling applies — bounded, and never catastrophic."""
        from PIL import Image
        import io as _io

        from vitax.data import JpegDecoder

        exact = JpegDecoder(size=96)
        fast = JpegDecoder(size=96, fast=True)
        if exact.backend != "native":
            pytest.skip("native decoder not built")

        # < 2x the target on one axis -> no scale admissible -> identical
        small, _ = self._jpegs(n=2, sizes=((150, 260), (100, 100)))
        np.testing.assert_array_equal(exact(small), fast(small))

        # smooth 4x source -> 1/2 or 1/4 IDCT scale fires; output stays close
        rng = np.random.default_rng(1)
        y, x = np.mgrid[0:420, 0:400]
        arr = (127 + 90 * np.sin(x / 37.0) * np.cos(y / 29.0)
               + rng.normal(0, 4, (420, 400))).clip(0, 255).astype(np.uint8)
        arr = np.repeat(arr[..., None], 3, axis=2)
        buf = _io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=95)
        a = exact([buf.getvalue()])[0].astype(np.int32)
        b = fast([buf.getvalue()])[0].astype(np.int32)
        assert not np.array_equal(a, b), "scale never fired — test shape wrong"
        assert np.abs(a - b).mean() < 6.0
        assert np.abs(a - b).max() < 64

    def test_corrupt_jpeg_reported(self):
        from vitax.data import JpegDecoder

        dec = JpegDecoder(size=64)
        if dec.backend != "native":
            pytest.skip("native decoder not built")
        jpegs, _ = self._jpegs(n=2)
        with pytest.raises(ValueError, match="corrupt"):
            dec([jpegs[0], b"not a jpeg at all"])

    def test_jpeg_to_logits_end_to_end(self):
        """The north-star data path: JPEG bytes -> host decode -> device
        resize/crop/normalize fused with the model -> logits."""
        from vitax.data import JpegDecoder, classify_jpegs

        jpegs, _ = self._jpegs(n=3)
        pipe = InferencePipeline(MODEL, _variables(), image_size=32, batch_size=4,
                                 dtype=jnp.float32)
        logits = classify_jpegs(pipe, jpegs, decoder=JpegDecoder(size=48))
        assert logits.shape == (3, 10)
        assert np.isfinite(logits).all()


def test_classify_jpeg_stream_matches_batchwise():
    """Streaming loop (decode k+1 overlapping device batch k) must produce
    the same logits, in order, as per-batch classify_jpegs."""
    import io

    import numpy as np
    from PIL import Image

    import jax.numpy as jnp
    from vitax.data import JpegDecoder, classify_jpeg_stream, classify_jpegs
    from vitax.models import ViT
    from vitax.pipeline import InferencePipeline

    rng = np.random.default_rng(0)
    def jpeg(i):
        buf = io.BytesIO()
        Image.fromarray((rng.random((40, 52, 3)) * 255).astype(np.uint8)).save(
            buf, format="JPEG")
        return buf.getvalue()

    batches = [[jpeg(i) for i in range(3)], [jpeg(i) for i in range(2)]]
    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=32, depth=1,
                heads=2, mlp_dim=64, dim_head=16)
    import jax
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3))))()
    pipe = InferencePipeline(model, variables, image_size=32, batch_size=2,
                             dtype=jnp.float32)
    dec = JpegDecoder(size=36)
    streamed = list(classify_jpeg_stream(pipe, batches, decoder=dec))
    assert len(streamed) == 2
    for got, jpegs in zip(streamed, batches):
        ref = classify_jpegs(pipe, jpegs, decoder=dec)
        np.testing.assert_allclose(got, ref, atol=1e-5)


class TestJpegFolderDataset:
    def _samples(self, n=10, size=(48, 64)):
        from PIL import Image
        import io as _io

        rng = np.random.default_rng(1)
        samples = []
        for i in range(n):
            arr = rng.integers(0, 255, (*size, 3), dtype=np.uint8)
            buf = _io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            samples.append((buf.getvalue(), i))  # label == sample index
        return samples

    def test_epoch_covers_every_sample_once_and_shapes(self):
        from vitax.data import JpegFolderDataset

        ds = JpegFolderDataset(self._samples(12), batch_size=4, size=32, seed=3)
        assert len(ds) == 3
        seen = []
        for images, labels in ds.epoch(0):
            assert images.shape == (4, 32, 32, 3)
            assert str(images.dtype) == "float32"
            assert float(jnp.max(images)) <= 1.0
            seen.extend(np.asarray(labels).tolist())
        assert sorted(seen) == list(range(12))

    def test_shuffle_deterministic_per_epoch_and_varies_across(self):
        from vitax.data import JpegFolderDataset

        ds = JpegFolderDataset(self._samples(12), batch_size=12, size=32, seed=3)
        l0a = np.asarray(next(iter(ds.epoch(0)))[1])
        l0b = np.asarray(next(iter(ds.epoch(0)))[1])
        l1 = np.asarray(next(iter(ds.epoch(1)))[1])
        np.testing.assert_array_equal(l0a, l0b)
        assert not np.array_equal(l0a, l1)

    def test_prefetch_matches_sync_and_paths_work(self, tmp_path):
        from vitax.data import JpegFolderDataset

        samples = self._samples(8)
        # half as files on disk (lazy read on the decode thread)
        path_samples = []
        for i, (raw, lbl) in enumerate(samples):
            if i % 2:
                p = tmp_path / f"{i}.jpg"
                p.write_bytes(raw)
                path_samples.append((str(p), lbl))
            else:
                path_samples.append((raw, lbl))

        a = JpegFolderDataset(samples, batch_size=4, size=32, seed=0, prefetch=True)
        b = JpegFolderDataset(path_samples, batch_size=4, size=32, seed=0, prefetch=False)
        for (ia, la), (ib, lb) in zip(a.epoch(0), b.epoch(0)):
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))

    def test_decode_error_propagates(self):
        from vitax.data import JpegFolderDataset

        bad = [(b"not a jpeg", 0)] * 4
        ds = JpegFolderDataset(bad, batch_size=4, size=32)
        with pytest.raises(Exception):
            list(ds.epoch(0))

    def test_drop_remainder_and_epochs(self):
        from vitax.data import JpegFolderDataset

        ds = JpegFolderDataset(self._samples(10), batch_size=4, size=32)
        assert len(ds) == 2  # 10 // 4, short batch dropped
        rows = list(ds.epochs(2))
        assert len(rows) == 4
        assert [e for e, _, _ in rows] == [0, 0, 1, 1]

    def test_mesh_shards_batches_over_data_axis(self):
        """mesh= yields batches already laid out P('data') — the exact
        sharding make_train_step consumes, so the step never repartitions
        its input. Values must match the unsharded dataset bitwise."""
        from vitax.data import JpegFolderDataset
        from vitax.parallel import make_mesh

        mesh = make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8])
        samples = self._samples(8)
        sharded = JpegFolderDataset(samples, batch_size=8, size=32, seed=0,
                                    mesh=mesh, prefetch=False)
        plain = JpegFolderDataset(samples, batch_size=8, size=32, seed=0,
                                  prefetch=False)
        (si, sl), (pi, pl) = next(iter(sharded.epoch(0))), next(iter(plain.epoch(0)))
        assert si.sharding.spec == jax.sharding.PartitionSpec("data")
        assert len(si.sharding.device_set) == 8  # 4-way split x 2-way replica
        assert si.addressable_shards[0].data.shape[0] == 2  # 8 / n_data
        np.testing.assert_array_equal(np.asarray(si), np.asarray(pi))
        np.testing.assert_array_equal(np.asarray(sl), np.asarray(pl))

        with pytest.raises(ValueError):
            JpegFolderDataset(samples, batch_size=6, size=32, mesh=mesh)

    def test_shards_partition_each_epoch_exactly(self):
        """Workers with the same seed and disjoint shard indices cover
        every sample exactly once per epoch, and a worker's membership
        reshuffles across epochs (shard AFTER shuffle)."""
        from vitax.data import JpegFolderDataset

        samples = self._samples(12)

        def labels_seen(shard, epoch):
            ds = JpegFolderDataset(samples, batch_size=2, size=32, seed=5,
                                   num_shards=3, shard_index=shard,
                                   prefetch=False)
            assert len(ds) == 2  # 12 / 3 shards / batch 2
            return [int(l) for _, ls in ds.epoch(epoch)
                    for l in np.asarray(ls)]

        epoch0 = [labels_seen(s, 0) for s in range(3)]
        assert sorted(sum(epoch0, [])) == list(range(12))
        assert labels_seen(0, 0) == epoch0[0]          # deterministic
        assert set(labels_seen(0, 1)) != set(epoch0[0])  # epoch reshuffle

        with pytest.raises(ValueError):
            JpegFolderDataset(samples, batch_size=2, num_shards=3,
                              shard_index=3)
        with pytest.raises(ValueError):
            JpegFolderDataset(samples, batch_size=2, shard_index=1)
        with pytest.raises(ValueError):  # 12/4 shards < batch 4
            JpegFolderDataset(samples, batch_size=4, num_shards=4,
                              shard_index=0)


def test_jpeg_folder_dataset_abandoned_epoch_stops_producer():
    """Dropping the epoch generator mid-pass (e.g. one next() for init
    shapes) must stop the prefetch thread instead of leaving it blocked
    on q.put with decoded batches pinned (regression)."""
    import threading
    import time

    from vitax.data import JpegFolderDataset

    samples = TestJpegFolderDataset()._samples(12)
    ds = JpegFolderDataset(samples, batch_size=2, size=32, prefetch=True)
    before = threading.active_count()
    it = ds.epoch(0)
    next(it)  # producer is now live and prefetching
    it.close()  # GeneratorExit at the yield -> finally -> stop + join
    deadline = time.time() + 6.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_preprocess_preserves_aspect_ratio():
    """Non-square inputs: the SHORT side scales to resize_to and the long
    side keeps its aspect (the standard eval transform the docstring
    promises) — not a squash to (resize_to, resize_to)."""
    rng = np.random.default_rng(0)
    raw = (rng.random((1, 48, 96, 3)) * 255).astype(np.uint8)  # 2:1 wide
    out = preprocess(jnp.asarray(raw), image_size=32, resize_to=36,
                     dtype=jnp.float32)
    assert out.shape == (1, 32, 32, 3)
    # reference: short side 48 -> 36, long side 96 -> 72, then center crop
    img = jnp.asarray(raw, jnp.float32) / 255.0
    ref = jax.image.resize(img, (1, 36, 72, 3), method="bilinear")
    ref = ref[:, 2:34, 20:52, :]
    from vitax.pipeline import normalize

    np.testing.assert_allclose(
        np.asarray(out), np.asarray(normalize(ref, dtype=jnp.float32)),
        rtol=0, atol=1e-5,
    )


def test_pipeline_tuple_output_model_serves_logits():
    """Models whose apply returns (logits, distill) — LeViT's train-time
    head — must serve classification logits, not a tuple-axis slice."""
    variables = _variables()
    tuple_apply = lambda v, x: (MODEL.apply(v, x), jnp.zeros((x.shape[0], 10)))
    pipe = InferencePipeline(MODEL, variables, image_size=32, batch_size=4,
                             apply_fn=tuple_apply)
    raw = (np.random.rand(6, 48, 48, 3) * 255).astype(np.uint8)
    out = pipe(raw)
    assert out.shape == (6, 10) and np.isfinite(out).all()


def test_pipeline_empty_batch():
    variables = _variables()
    pipe = InferencePipeline(MODEL, variables, image_size=32, batch_size=4)
    out = pipe(np.zeros((0, 48, 48, 3), np.uint8))
    assert out.shape == (0, 10)


def test_exported_serving_rejects_garbage_with_value_error():
    import pytest

    from vitax.utils.aot import ExportedServing

    with pytest.raises(ValueError, match="not a vitax AOT"):
        ExportedServing(b"definitely not a zip")


def test_train_step_donate_runs():
    """donate=True (examples/train.py's setting) must step normally when
    the caller overwrites state."""
    from vitax.train import create_train_state, make_train_step

    model = MODEL
    imgs = jnp.ones((4, 32, 32, 3))
    labels = jnp.zeros((4,), jnp.int32)
    state = create_train_state(model, jax.random.PRNGKey(0), imgs)
    step = make_train_step(model, donate=True)
    state, loss = step(state, imgs, labels)
    state, loss = step(state, imgs, labels)
    assert np.isfinite(float(loss))


def test_evaluate_caches_eval_step():
    from vitax import train as train_mod

    variables = _variables()
    imgs = jnp.ones((2, 32, 32, 3))
    labels = jnp.zeros((2,), jnp.int32)
    train_mod._EVAL_STEP_CACHE.clear()
    train_mod.evaluate(MODEL, variables, [(imgs, labels)])
    assert MODEL in train_mod._EVAL_STEP_CACHE
    first = train_mod._EVAL_STEP_CACHE[MODEL]
    train_mod.evaluate(MODEL, variables, [(imgs, labels)])
    assert train_mod._EVAL_STEP_CACHE[MODEL] is first


def test_pipeline_explicit_buckets_honored_under_mesh():
    """An explicit batch_buckets list survives a mesh (the caller owns
    divisibility); only the DEFAULT derivation collapses to the single
    fixed-batch program under a mesh."""
    from vitax.parallel.mesh import make_mesh

    mesh = make_mesh()
    v = _variables()
    explicit = InferencePipeline(MODEL, v, image_size=32, batch_size=16,
                                 batch_buckets=[8, 16], mesh=mesh,
                                 dtype=jnp.float32)
    assert explicit.batch_buckets == [8, 16]
    default = InferencePipeline(MODEL, v, image_size=32, batch_size=16,
                                mesh=mesh, dtype=jnp.float32)
    assert default.batch_buckets == [16]

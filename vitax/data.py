"""Host data loading: the JPEG decode front-end of the serving pipeline.

The reference has no data path at all (SURVEY.md §5); here raw JPEG bytes
become a fixed-size uint8 RGB batch on the host — via the native
multithreaded libjpeg decoder (native/jpeg_decoder.cpp, ctypes-bound,
GIL-free so decode overlaps device compute) — and everything downstream
(final resize, crop, normalize, patchify) runs inside the model's XLA
program (vitax/pipeline.py). The native library is built on demand
(``make -C native``); a PIL fallback keeps the API available without a
toolchain.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvitjpeg.so")


# Decode flags (must mirror native/jpeg_decoder.cpp).
_FLAG_DCT_SCALE = 1   # IDCT-domain downscale to the smallest M/8 >= out_size
_FLAG_FAST_IDCT = 2   # JDCT_IFAST + plain upsampling
_ABI_VERSION = 2


def _open_lib(path: str = _LIB_PATH) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    try:
        if lib.vt_api_version() != _ABI_VERSION:
            return None
    except AttributeError:  # pre-versioning binary
        return None
    return lib


def _open_rebuilt_lib() -> Optional[ctypes.CDLL]:
    """Load the just-rebuilt library through a UNIQUE temp path: glibc's
    dlopen caches by pathname and ctypes never dlcloses, so re-CDLL'ing
    ``_LIB_PATH`` after a rebuild would return the stale pre-rebuild
    mapping whenever the old binary was already opened this process."""
    import shutil
    import tempfile

    try:
        fd, tmp = tempfile.mkstemp(prefix="libvitjpeg-", suffix=".so")
        os.close(fd)
        shutil.copy2(_LIB_PATH, tmp)
    except OSError:
        return _open_lib()
    lib = _open_lib(tmp)
    try:  # the mapping survives the unlink; keeps /tmp clean
        os.unlink(tmp)
    except OSError:
        pass
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    lib = _open_lib() if os.path.exists(_LIB_PATH) else None
    if lib is None:
        try:  # (re)build on demand; quiet failure -> PIL fallback
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "clean", "all"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:  # noqa: BLE001 — no toolchain / no libjpeg
            return None
        lib = _open_rebuilt_lib()
        if lib is None:
            return None
    lib.vt_decode_jpeg_batch.restype = ctypes.c_int
    lib.vt_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data
        ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
        ctypes.c_int,                     # n
        ctypes.c_int,                     # out_size
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.POINTER(ctypes.c_int64),   # status [n]
        ctypes.c_int,                     # n_threads
        ctypes.c_int,                     # flags
    ]
    return lib


_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _load_native()
        _LIB_TRIED = True
    return _LIB


class JpegDecoder:
    """Batch JPEG -> uint8 RGB ``[N, size, size, 3]`` with host bilinear
    resize (half-pixel centers). Native multithreaded decode when the
    library is available; PIL otherwise (``.backend`` says which).

    ``fast=True`` trades bit-exactness for host throughput on the decode —
    the serving bottleneck on small hosts: the IDCT
    downscales in the DCT domain to the smallest power-of-two size still
    covering ``size`` (a proper low-pass, so the final bilinear reads a
    1-2x source instead of full resolution). Power-of-two scales are the
    ones libjpeg-turbo executes with SIMD — odd M/8 scales and JDCT_IFAST
    were both measured slower than the full-scale SIMD decode and are not
    used. Scale selection never decodes below ``size``; images under 2x
    the target decode identically to the exact path. The PIL fallback uses
    ``Image.draft`` (the same power-of-two DCT scaling)."""

    def __init__(self, size: int = 256, threads: Optional[int] = None,
                 fast: bool = False):
        self.size = size
        self.threads = threads or min(32, os.cpu_count() or 8)
        self.fast = fast
        self._lib = _native_lib()
        self.backend = "native" if self._lib is not None else "pil"

    def __call__(self, jpegs: Sequence[bytes]) -> np.ndarray:
        if self._lib is not None:
            return self._decode_native(jpegs)
        return self._decode_pil(jpegs)

    def _decode_native(self, jpegs: Sequence[bytes]) -> np.ndarray:
        n = len(jpegs)
        data = np.frombuffer(b"".join(jpegs), np.uint8)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(j) for j in jpegs], out=offsets[1:])
        out = np.empty((n, self.size, self.size, 3), np.uint8)
        status = np.zeros(n, np.int64)
        flags = _FLAG_DCT_SCALE if self.fast else 0
        failures = self._lib.vt_decode_jpeg_batch(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, self.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.threads, flags,
        )
        if failures:
            bad = np.nonzero(status)[0].tolist()
            raise ValueError(f"{failures} corrupt JPEG(s) at indices {bad[:8]}")
        return out

    def _decode_pil(self, jpegs: Sequence[bytes]) -> np.ndarray:
        from PIL import Image

        out = np.empty((len(jpegs), self.size, self.size, 3), np.uint8)
        for i, raw in enumerate(jpegs):
            img = Image.open(io.BytesIO(raw))
            if self.fast:
                img.draft("RGB", (self.size, self.size))
            img = img.convert("RGB")
            arr = np.asarray(img)
            out[i] = _resize_bilinear_u8(arr, self.size)
        return out


def _resize_bilinear_u8(arr: np.ndarray, size: int) -> np.ndarray:
    """Numpy mirror of the native resize (half-pixel centers) — keeps the
    PIL fallback numerically aligned with the native path."""
    h, w, _ = arr.shape
    if h == size and w == size:
        return arr
    fy = np.clip((np.arange(size) + 0.5) * (h / size) - 0.5, 0, h - 1)
    fx = np.clip((np.arange(size) + 0.5) * (w / size) - 0.5, 0, w - 1)
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    a = arr.astype(np.float32)
    top = a[y0][:, x0] + (a[y0][:, x1] - a[y0][:, x0]) * wx
    bot = a[y1][:, x0] + (a[y1][:, x1] - a[y1][:, x0]) * wx
    return (top + (bot - top) * wy + 0.5).astype(np.uint8)


class JpegFolderDataset:
    """Shuffled, batched, multi-epoch training iterator over JPEG bytes.

    The training-side counterpart of ``classify_jpeg_stream``: per-epoch
    deterministic shuffle (``seed`` + epoch index → reproducible runs and
    exact resume at an epoch boundary), native multithreaded decode of
    batch k+1 on a background thread while the accelerator trains on
    batch k, and an async ``jax.device_put`` so the host→device copy of
    the next batch overlaps the current step too. Yields
    ``(images fp32 [B,S,S,3] on device, labels int32 [B] on device)``.

    ``samples`` is a sequence of ``(jpeg_bytes_or_path, label)``; paths are
    read lazily on the decode thread, so a million-file folder costs no
    RAM up front. The last short batch of an epoch is dropped when
    ``drop_remainder`` (static shapes — one compiled train step).

    ``mesh`` shards every yielded batch over the mesh's data axis as it is
    placed (``NamedSharding(mesh, P('data'))`` — the layout
    ``make_train_step`` consumes), so the host→device copy already scatters
    each shard to its device and the train step never repartitions its
    input. ``batch_size`` must divide by the data-axis size. (Addressable
    single-process meshes; a multi-host global batch additionally needs
    ``jax.make_array_from_process_local_data`` on the per-host shard.)

    ``num_shards``/``shard_index`` give each worker a disjoint slice of
    every epoch: the epoch's shuffled order is computed identically on all
    workers (same ``seed``), then strided — the union covers each sample
    exactly once per epoch and a worker's membership reshuffles across
    epochs. This is the per-host input partition for multi-process
    training (pass ``jax.process_count()`` / ``jax.process_index()``).
    """

    def __init__(
        self,
        samples: Sequence,
        batch_size: int,
        *,
        size: int = 224,
        seed: int = 0,
        decoder: Optional[JpegDecoder] = None,
        drop_remainder: bool = True,
        normalize: bool = True,
        prefetch: bool = True,
        mesh=None,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
    ):
        if (num_shards is None) != (shard_index is None):
            raise ValueError("pass num_shards and shard_index together")
        if num_shards is not None and not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self._shard = (shard_index or 0, num_shards or 1)
        if len(samples) // self._shard[1] < batch_size:
            raise ValueError(
                f"{len(samples)} samples / {self._shard[1]} shards "
                f"< batch_size {batch_size}"
            )
        self.samples = list(samples)
        self.batch_size = batch_size
        self.seed = seed
        self.decoder = decoder or JpegDecoder(size=size)
        self.drop_remainder = drop_remainder
        self.normalize = normalize
        self.prefetch = prefetch
        self._sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            from vitax.parallel.mesh import DATA_AXIS

            n_data = mesh.shape[DATA_AXIS]
            if batch_size % n_data:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the mesh's "
                    f"{n_data}-way data axis"
                )
            self._sharding = NamedSharding(mesh, PartitionSpec(DATA_AXIS))

    def __len__(self) -> int:
        num = self._shard[1]
        n = len(self.samples) // num
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.samples))
        idx, num = self._shard
        # every shard truncated to len//num samples: unequal shard sizes
        # would give workers different batch counts per epoch, which
        # desynchronizes (hangs) SPMD collective train steps
        return order[idx::num][: len(self.samples) // num]

    def _load(self, idx: np.ndarray):
        jpegs = []
        labels = np.empty(len(idx), np.int32)
        for j, i in enumerate(idx):
            raw, labels[j] = self.samples[i]
            if not isinstance(raw, (bytes, bytearray)):
                with open(raw, "rb") as f:
                    raw = f.read()
            jpegs.append(raw)
        images = self.decoder(jpegs).astype(np.float32)
        if self.normalize:
            images /= 255.0
        return images, labels

    def epoch(self, epoch: int = 0) -> Iterator:
        """One pass over the data in the epoch's shuffled order."""
        import jax

        order = self._order(epoch)
        nb = len(self)
        batches = (order[k * self.batch_size:(k + 1) * self.batch_size] for k in range(nb))

        put = (lambda a: jax.device_put(a, self._sharding)) if self._sharding \
            else jax.device_put

        if not self.prefetch:
            for idx in batches:
                images, labels = self._load(idx)
                yield put(images), put(labels)
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)  # bounded lookahead
        # consumer-abandonment guard: a generator dropped mid-epoch (e.g.
        # one next() for init shapes) raises GeneratorExit at the yield —
        # without it the producer would block on q.put forever, pinning a
        # thread plus up to maxsize decoded+device-put batches
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for idx in batches:
                    if stop.is_set():
                        return
                    images, labels = self._load(idx)
                    # async copy: overlaps the in-flight train step
                    if not _put((put(images), put(labels))):
                        return
                _put(None)
            except Exception as e:  # surface decode errors on the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def epochs(self, n: int) -> Iterator:
        """``n`` epochs back to back, yielding ``(epoch, images, labels)``."""
        for e in range(n):
            for images, labels in self.epoch(e):
                yield e, images, labels


def classify_jpegs(pipeline, jpegs: List[bytes], *, decoder: Optional[JpegDecoder] = None):
    """End-to-end: JPEG bytes -> logits through an ``InferencePipeline``.

    Host: native multithreaded decode to a fixed ``[N, S, S, 3]`` uint8
    batch. Device: resize/crop/normalize fused into the model program.
    """
    decoder = decoder or JpegDecoder()
    return pipeline(decoder(jpegs))


def classify_jpeg_stream(
    pipeline,
    batches: Iterable[List[bytes]],
    *,
    decoder: Optional[JpegDecoder] = None,
) -> Iterator[np.ndarray]:
    """Streaming serving loop: decode batch k+1 on the host while the device
    runs batch k.

    JAX dispatch is asynchronous, so submitting the device work and then
    decoding the next batch overlaps the two naturally; the one-batch
    lookahead keeps exactly one undelivered device result in flight
    (bounded memory). With the GIL-free native decoder the host side truly
    runs while the device computes. Yields one logits array per input
    batch, in order.
    """
    decoder = decoder or JpegDecoder()
    pending = None  # in-flight device chunks of the previous batch
    for jpegs in batches:
        raw = decoder(jpegs)             # host decode (overlaps device work)
        if pending is not None:
            # wait for + deliver batch k-1
            yield np.concatenate([np.asarray(p) for p in pending], axis=0)
        pending = pipeline.dispatch(raw)  # async dispatch of batch k
    if pending is not None:
        yield np.concatenate([np.asarray(p) for p in pending], axis=0)

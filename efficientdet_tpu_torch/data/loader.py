"""Batched loading with background prefetch, and host batches to the device.

``DataLoader``, ``eval_batches`` and ``prefetch_iter`` are the port's own
copies of ``efficientdet_tpu/data/loader.py``: the same batches, in the same
order, for the same seed, made either in Python (``dataset[i]`` through the
dataset's transform, with an optional RAM cache of decoded images) or by
the C++ batch pipeline of ``efficientdet_tpu_torch.native`` (threaded JPEG
decode with the resize, flip, normalize and pad fused). ``native='auto'``
takes the pipeline where it can serve the dataset, as the JAX package
does; ``'on'`` raises where it cannot, with the compiler's error where the
library did not build; ``'off'`` stays in Python. Both report the path they
took (``native_active``) and count the images that a native batch had to
make through ``dataset[i]`` (``native_fallbacks``: a file that is not a
JPEG, or is rotated by its EXIF orientation). ``to_device`` is the
counterpart of ``shard_batch``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .transforms import IMAGENET_MEAN, IMAGENET_STD, collate, pad_annotations

NATIVE_MODES = ("off", "auto", "on")


def native_blocker(dataset, image_size) -> Optional[str]:
    """Why the C++ pipeline cannot make this dataset's batches, or None.
    It needs a square resize target (an int) and a dataset of files:
    ``image_path`` and ``load_annotations``."""
    if not isinstance(image_size, int):
        return (f"it makes square canvases only, not {image_size} (H, W): "
                "a rectangular canvas is resized in Python")
    if image_size <= 0:
        return "it needs image_size > 0"
    missing = [a for a in ("image_path", "load_annotations")
               if not hasattr(dataset, a)]
    if missing:
        return (f"{type(dataset).__name__} has no "
                f"{' or '.join(missing)}: it reads no image files")
    return None


def native_active(dataset, image_size: int, native: str) -> bool:
    """Whether batches of ``dataset`` go through the C++ pipeline under
    ``native``: 'auto' where ``native_blocker`` finds nothing and the
    library builds here; 'on' the same, and raises where either fails (with
    the compiler's stderr for the library); 'off' never."""
    if native not in NATIVE_MODES:
        raise ValueError(f"native must be one of {NATIVE_MODES}, got "
                         f"{native!r}")
    if native == "off":
        return False
    from .. import native as native_mod
    blocker = native_blocker(dataset, image_size)
    if native == "on":
        if blocker:
            raise ValueError(f"native='on': the C++ pipeline cannot serve "
                             f"this dataset: {blocker}")
        native_mod.load()
        return True
    return blocker is None and native_mod.available()


def data_path(active: bool, batch_size: int) -> str:
    """One line naming the path that makes the batches, and for the C++
    pipeline the libjpeg it was built against and by which route."""
    if active:
        from .. import native as native_mod
        return (f"data path: native C++ pipeline (JPEG decode, resize, flip, "
                f"normalize, pad), up to "
                f"{native_mod.default_threads(batch_size)} threads, libjpeg: "
                f"{native_mod.libjpeg()}")
    return "data path: Python (dataset[i] through its transform), one thread"


def native_images(dataset, idx: Sequence[int], image_size: int,
                  flips: Optional[np.ndarray]):
    """(paths, images, scales, ok) of ``dataset``'s images ``idx`` from the
    C++ pipeline, normalized as the ``Normalizer``."""
    from .. import native as native_mod
    paths = [dataset.image_path(int(i)) for i in idx]
    images, scales, ok = native_mod.decode_resize_batch(
        paths, image_size, flips, IMAGENET_MEAN, IMAGENET_STD)
    return paths, images, scales, ok


class DataLoader:
    """Minimal epoch-based loader: shuffle, batch, collate, prefetch.

    ``batch_size`` is the per-process batch; with ``shard_index`` and
    ``num_shards`` every process gets a disjoint slice of one same-seed
    permutation per epoch, ``seed + epoch``. ``uint8_images`` collates
    uint8 [0, 255] images for the on-device normalize.

    ``native`` ('off', 'auto' or 'on'; ``native_active`` above) selects the
    C++ batch pipeline, which replaces the dataset's Normalizer ->
    Augmenter(``flip_prob``) -> Resizer(``image_size``) transform with the
    same arithmetic; its flips are drawn per epoch from
    ``RandomState(seed * 9973 + epoch)``. ``uint8_images`` and
    ``cache='ram'`` switch it off, as in the JAX package (it emits
    normalized float32; the cache replaces the same decode). Without it the
    in-Python path reads neither ``image_size`` nor ``flip_prob``: the
    dataset's transform resizes and flips. ``cache='ram'`` keeps each
    sample's decoded image (uint8, exact for an 8-bit decode) and
    annotations in host memory after first use and applies the dataset's
    random transform anew every epoch; the dataset must have
    ``load_image``, ``load_annotations`` and ``transform``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 max_boxes: int = 100, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1,
                 native: str = "off", image_size: int = 0,
                 flip_prob: float = 0.0, cache: str = "off",
                 uint8_images: bool = False):
        if cache not in ("off", "ram"):
            raise ValueError(f"cache must be 'off' or 'ram', got {cache!r}")
        if cache == "ram" and not (hasattr(dataset, "load_image")
                                   and hasattr(dataset, "load_annotations")):
            raise ValueError("cache='ram' needs dataset.load_image and "
                             "dataset.load_annotations")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_boxes = max_boxes
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.image_size = image_size
        self.flip_prob = flip_prob
        self.uint8_images = uint8_images
        self._cache = {} if cache == "ram" else None
        self._epoch = 0
        if uint8_images or cache == "ram":
            native = "off"
        self.native_active = native_active(dataset, image_size, native)
        self.native_fallbacks = 0

    def set_epoch(self, epoch: int) -> None:
        """Continue as if ``epoch`` epochs had been run (a resumed run): the
        next epoch shuffles with ``seed + epoch + 1``."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def data_path(self) -> str:
        return data_path(self.native_active, self.batch_size)

    def _batch_indices(self) -> Iterator[Sequence[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # same seed on every process -> one global permutation
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        order = order[self.shard_index::self.num_shards]
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield idx

    def _native_batch(self, idx: Sequence[int],
                      rng: np.random.RandomState) -> dict:
        """One collated batch from the C++ pipeline. The boxes follow the
        Python transform's order: the flip mirrors x against the original
        width (``Augmenter``), then the resize scales them (``Resizer``).
        An image the pipeline could not make comes from ``dataset[i]``."""
        from .. import native as native_mod
        flips = (rng.rand(len(idx)) < self.flip_prob
                 if self.flip_prob > 0 else np.zeros(len(idx), bool))
        paths, images, scales, ok = native_images(
            self.dataset, idx, self.image_size, flips)
        annots = []
        for j, i in enumerate(idx):
            if not ok[j]:
                sample = self.dataset[int(i)]
                self.native_fallbacks += 1
                images[j] = sample["img"]
                scales[j] = sample.get("scale", 1.0)
                annots.append(np.asarray(sample["annot"], np.float32))
                continue
            a = np.asarray(self.dataset.load_annotations(int(i)),
                           np.float32).reshape(-1, 5).copy()
            if flips[j] and len(a):
                w = native_mod.image_dims(paths[j])[0]
                x1, x2 = a[:, 0].copy(), a[:, 2].copy()
                a[:, 0] = w - x2
                a[:, 2] = w - x1
            a[:, :4] *= scales[j]
            annots.append(a)
        return {"images": images,
                "annotations": pad_annotations(annots, self.max_boxes),
                "scales": scales}

    def _cached_sample(self, i: int) -> dict:
        """``dataset[i]`` with the decode served from the RAM cache: the
        datasets' {'img' float32 [0, 1], 'annot', 'scale' 1.0} through the
        dataset's transform; uint8 batches skip the float round trip."""
        ent = self._cache.get(i)
        if ent is None:
            img = self.dataset.load_image(i)
            ann = np.asarray(self.dataset.load_annotations(i),
                             np.float32).reshape(-1, 5)
            ent = (np.round(img * 255.0).astype(np.uint8), ann)
            self._cache[i] = ent
        img8, ann = ent
        img = img8 if self.uint8_images else img8.astype(np.float32) / 255.0
        sample = {"img": img, "annot": ann.copy(), "scale": 1.0}
        transform = getattr(self.dataset, "transform", None)
        return transform(sample) if transform is not None else sample

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        # The C++ pipeline's flips, one stream per epoch.
        self._flip_rng = np.random.RandomState(self.seed * 9973 + self._epoch)
        sample = (self.dataset.__getitem__ if self._cache is None
                  else self._cached_sample)

        def batches():
            for idx in self._batch_indices():
                if self.native_active:
                    yield self._native_batch(idx, self._flip_rng)
                else:
                    yield collate([sample(int(i)) for i in idx],
                                  self.max_boxes,
                                  uint8_images=self.uint8_images)

        return prefetch_iter(batches(), depth=self.prefetch)


class EvalBatches:
    """The iterator ``eval_batches`` returns: (indices, images (B, S, S, 3)
    f32, scales (B,) f32) per batch, with ``native_active`` and the count
    of ``native_fallbacks`` so far."""

    def __init__(self, dataset, batch_size: int, image_size: int,
                 native: str):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.native_active = native_active(dataset, image_size, native)
        self.native_fallbacks = 0
        self._batches = self._make()

    def __iter__(self) -> "EvalBatches":
        return self

    def __next__(self) -> tuple:
        return next(self._batches)

    def data_path(self) -> str:
        return data_path(self.native_active, self.batch_size)

    def _make(self) -> Iterator[tuple]:
        dataset, batch_size = self.dataset, self.batch_size
        n = len(dataset)
        for start in range(0, n, batch_size):
            idx = list(range(start, min(start + batch_size, n)))
            if self.native_active:
                _, images, scales, ok = native_images(
                    dataset, idx, self.image_size, None)
                for j, i in enumerate(idx):
                    if not ok[j]:
                        s = dataset[i]
                        self.native_fallbacks += 1
                        images[j] = s["img"]
                        scales[j] = s.get("scale", 1.0)
            else:
                samples = [dataset[i] for i in idx]
                images = np.stack([s["img"] for s in samples]
                                  ).astype(np.float32)
                scales = np.array([s.get("scale", 1.0) for s in samples],
                                  np.float32)
            if len(idx) < batch_size:
                pad = batch_size - len(idx)
                images = np.concatenate(
                    [images, np.zeros((pad,) + images.shape[1:], np.float32)])
                scales = np.concatenate([scales, np.ones((pad,), np.float32)])
            yield idx, images, scales


def eval_batches(dataset, batch_size: int, image_size: int = 0,
                 native: str = "auto") -> EvalBatches:
    """Sequential eval batches: (indices, images (B, S, S, 3) f32, scales
    (B,) f32). The last batch is zero-padded to the batch size, with scales
    1, so the step sees one shape; callers drop the padded rows by index.
    The C++ pipeline makes them under ``native`` by the ``DataLoader``'s
    rules (an image it cannot make comes from ``dataset[i]``); otherwise
    ``dataset[i]``'s transform does. ``native='on'`` raises here, before
    the first batch, where the pipeline cannot serve the dataset."""
    return EvalBatches(dataset, batch_size, image_size, native)


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread with a bounded queue, overlapping
    host work with device compute. An exception of the worker is raised
    again in the consumer, never turned into a clean stop."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            q.put((stop, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
            raise item[1]
        yield item


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Copy a collated batch of numpy arrays or tensors to ``device``. To a
    CUDA device the copy goes through pinned host memory with
    ``non_blocking=True``, so it overlaps the work already queued on the
    current stream; the host buffers stay alive until it is done, as the
    caching host allocator records the stream."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(value)) \
            if isinstance(value, np.ndarray) else value
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out

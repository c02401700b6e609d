"""Batched loading with background prefetch, and host batches to the device.

``DataLoader`` and ``prefetch_iter`` are the port's own copies of the
in-Python path of ``efficientdet_tpu/data/loader.py``, with its RAM cache
of decoded images: the same batches, in the same order, for the same seed;
``eval_batches`` is the copy of its sequential evaluation batches. The JAX
package's C++ batch pipeline (``native=``) is not ported yet: any value
other than ``"off"`` raises. ``to_device`` is the counterpart of
``shard_batch``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from .transforms import collate


def refuse_native(native: str) -> None:
    """Raise for any C++ batch pipeline setting but 'off'."""
    if native != "off":
        raise NotImplementedError(
            f"native={native!r}: the C++ batch pipeline is not ported yet "
            "(ROADMAP queue A, item A13); use native='off'")


class DataLoader:
    """Minimal epoch-based loader: shuffle, batch, collate, prefetch.

    ``batch_size`` is the per-process batch; with ``shard_index`` and
    ``num_shards`` every process gets a disjoint slice of one same-seed
    permutation per epoch, ``seed + epoch``. ``uint8_images`` collates
    uint8 [0, 255] images for the on-device normalize.

    ``image_size`` and ``flip_prob`` are the C++ pipeline's resize and flip
    (the JAX package's ``native=``); they are kept for it, and the
    in-Python path reads neither: the dataset's transform resizes and
    flips. ``cache='ram'`` keeps each sample's decoded image (uint8, exact
    for an 8-bit decode) and annotations in host memory after first use
    and applies the dataset's random transform anew every epoch; the
    dataset must have ``load_image``, ``load_annotations`` and
    ``transform``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 max_boxes: int = 100, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1,
                 native: str = "off", image_size: int = 0,
                 flip_prob: float = 0.0, cache: str = "off",
                 uint8_images: bool = False):
        refuse_native(native)
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

    def set_epoch(self, epoch: int) -> None:
        """Continue as if ``epoch`` epochs had been run (a resumed run): the
        next epoch shuffles with ``seed + epoch + 1``."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

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
        # The C++ pipeline's per-epoch flip stream (JAX package); kept so a
        # port of it draws the same flips.
        self._flip_rng = np.random.RandomState(self.seed * 9973 + self._epoch)
        sample = (self.dataset.__getitem__ if self._cache is None
                  else self._cached_sample)

        def batches():
            for idx in self._batch_indices():
                yield collate([sample(int(i)) for i in idx],
                              self.max_boxes, uint8_images=self.uint8_images)

        return prefetch_iter(batches(), depth=self.prefetch)


def eval_batches(dataset, batch_size: int,
                 native: str = "off") -> Iterator[tuple]:
    """Sequential eval batches: yields (indices, images (B, S, S, 3) f32,
    scales (B,) f32) from ``dataset[i]``'s transform. The last batch is
    zero-padded to the batch size, with scales 1, so the step sees one
    shape; callers drop the padded rows by index. ``native`` other than
    'off' raises before the first batch is made."""
    refuse_native(native)
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        samples = [dataset[i] for i in idx]
        images = np.stack([s["img"] for s in samples]).astype(np.float32)
        scales = np.array([s.get("scale", 1.0) for s in samples], np.float32)
        if len(idx) < batch_size:
            pad = batch_size - len(idx)
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], np.float32)])
            scales = np.concatenate([scales, np.ones((pad,), np.float32)])
        yield idx, images, scales


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

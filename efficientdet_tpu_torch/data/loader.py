"""Batched loading with background prefetch, and host batches to the device.

``DataLoader`` and ``prefetch_iter`` are the port's own copies of the
in-Python path of ``efficientdet_tpu/data/loader.py``: the same batches, in
the same order, for the same seed. The JAX package's C++ batch pipeline
(``native=``) is not ported yet: any value other than ``"off"`` raises; nor
is its RAM cache of decoded images (``cache=``), which only the datasets
that decode files use.
``to_device`` is the counterpart of ``shard_batch``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from .transforms import collate


class DataLoader:
    """Minimal epoch-based loader: shuffle, batch, collate, prefetch.

    ``batch_size`` is the per-process batch; with ``shard_index`` and
    ``num_shards`` every process gets a disjoint slice of one same-seed
    permutation per epoch. ``uint8_images`` collates uint8 [0, 255] images
    for the on-device normalize."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 max_boxes: int = 100, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1,
                 native: str = "off", uint8_images: bool = False):
        if native != "off":
            raise NotImplementedError(
                f"native={native!r}: the C++ batch pipeline is not ported "
                "yet (ROADMAP queue A, item 14); use native='off'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_boxes = max_boxes
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.uint8_images = uint8_images
        self._epoch = 0

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

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1

        def batches():
            for idx in self._batch_indices():
                yield collate([self.dataset[int(i)] for i in idx],
                              self.max_boxes, uint8_images=self.uint8_images)

        return prefetch_iter(batches(), depth=self.prefetch)


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

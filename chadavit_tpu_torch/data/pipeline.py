"""Host data pipeline: dense collation, threaded prefetching, upload to the card.

Counterpart of ``chadavit_tpu/data/pipeline.py`` (``_to_dense`` :26,
``dense_collate`` :43, ``HostLoader`` :97, ``device_prefetch`` :286). Every
batch is dense ``(B, C, H, W)`` float32 with a ``(B,)`` channel-count vector;
padded channel planes are zero. Multi-crop samples collate crop-major,
``(num_crops, B, C, H, W)``.

``HostLoader`` keeps the JAX loader's deterministic batch order (a seeded
shuffle per epoch, optional channel-count bucketing, ``iter_from(skip)`` for
an exact mid-epoch resume without decoding the skipped prefix) and its
threads (``num_workers`` workers, batches emitted strictly in order). One
thing differs: each sample is augmented with a generator of its own,
``sample_rng(seed, epoch, index)``, where the JAX loader draws every sample
from the one generator of its augmentation pipeline. Under several worker
threads that shared generator is consumed in whatever order the threads
reach it, and a resumed run starts it afresh, so the JAX loader's crops
change from run to run and after a resume; the port's depend on (seed, epoch,
index) alone. The raw path of the on-device augmentation has no random host
op, so its batches equal the JAX loader's bit for bit: ``channels_last``
and ``dtype`` collate the decoder's HWC integer planes as they are, and
``native_batch_fn`` decodes a whole batch in the C++ thread pool
(:func:`chadavit_tpu_torch.data.native.make_dense_batch_fn`). The JAX
loader's ``collate_fn``, ``emit_index`` and multi-host ``shard`` (for the
evaluation and parallel paths) are not ported yet.

:func:`device_prefetch` replaces the JAX upload thread: it pins each host
batch and copies it to the device with ``non_blocking=True`` from a
background thread, a few batches ahead of the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def _to_dense(images: Sequence[np.ndarray], max_channels: int,
              channels_last: bool = False, dtype=np.float32) -> tuple:
    """CHW images (HWC when ``channels_last``) with ragged channel counts ->
    (B, C_max, H, W) + counts."""
    b = len(images)
    if channels_last:
        images = [np.ascontiguousarray(img.transpose(2, 0, 1)) for img in images]
    h, w = images[0].shape[-2:]
    out = np.zeros((b, max_channels, h, w), dtype)
    counts = np.empty((b,), np.int32)
    for i, img in enumerate(images):
        c = min(img.shape[0], max_channels)
        out[i, :c] = img[:c]
        counts[i] = c
    return out, counts


def dense_collate(batch: List, max_channels: int,
                  channels_last: bool = False, dtype=np.float32) -> Dict[str, np.ndarray]:
    """Collate ``[(img_or_crops, label), ...]`` (optionally ``(idx, img, label)``)
    into dense arrays. Multi-crop samples produce ``crops`` stacked crop-major
    ``(num_crops, B, C_max, H, W)`` grouped by crop size; single images produce
    ``images`` ``(B, C_max, H, W)``.

    Layout contract: augmented samples are CHW (AugmentationPipeline output);
    raw dataset samples are HWC — pass ``channels_last=True`` for those."""
    first = batch[0]
    *_, images, labels_probe = first[-2:]
    labels = np.asarray([b[-1] for b in batch])
    if isinstance(labels_probe, (int, float, np.integer, np.floating)):
        labels = labels.astype(np.float32 if isinstance(labels_probe, float) else np.int32)

    samples = [b[-2] for b in batch]
    if isinstance(samples[0], list):  # multi-crop
        num_crops = len(samples[0])
        sizes = [c.shape[-1] for c in samples[0]]
        big = sizes[0]
        large_idx = [i for i, s in enumerate(sizes) if s == big]
        small_idx = [i for i, s in enumerate(sizes) if s != big]
        out: Dict[str, np.ndarray] = {"labels": labels}

        def stack(idxs):
            crops, counts = [], None
            for ci in idxs:
                dense, counts = _to_dense([s[ci] for s in samples], max_channels,
                                          channels_last, dtype)
                crops.append(dense)
            return np.stack(crops, 0), counts

        out["crops"], out["channel_counts"] = stack(large_idx)
        if small_idx:
            out["small_crops"], _ = stack(small_idx)
        assert len(large_idx) + len(small_idx) == num_crops
        return out

    dense, counts = _to_dense(samples, max_channels, channels_last, dtype)
    return {"images": dense, "channel_counts": counts, "labels": labels}


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The augmentation generator of sample ``index`` in ``epoch``."""
    return np.random.default_rng([seed, epoch, index])


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class HostLoader:
    """Threaded prefetching batch loader with deterministic per-epoch order
    and per-sample augmentation generators.

    ``channels_last`` and ``dtype`` say how samples collate (HWC raw planes
    of the decoder's dtype on the on-device augmentation path);
    ``native_batch_fn(idxs, width) -> batch`` replaces the per-sample path
    with one call per batch (JAX ``pipeline.py:105-117``)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        max_channels: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        channels_last: bool = False,
        bucket_by_channels: bool = False,
        bucket_round: int = 2,
        dtype=np.float32,
        native_batch_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_channels = max_channels
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        # channel-count bucketing: batch images of similar channel counts and
        # pad only to the batch's (rounded) max. Requires dataset.channel_count(i).
        self.bucket_by_channels = bucket_by_channels and hasattr(dataset, "channel_count")
        self.bucket_round = bucket_round
        self.channels_last = channels_last
        self.dtype = dtype
        self.native_batch_fn = native_batch_fn

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        if self.bucket_by_channels:
            counts = np.asarray([self.dataset.channel_count(int(i)) for i in order])
            order = order[np.argsort(counts, kind="stable")]
        nb = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        batches = [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]
        if self.bucket_by_channels and self.shuffle:
            rng.shuffle(batches)
        return batches

    def _bucket_width(self, idxs) -> int:
        cmax = max(self.dataset.channel_count(int(i)) for i in idxs)
        r = self.bucket_round
        return min(((cmax + r - 1) // r) * r, self.max_channels)

    def _sample(self, index: int, epoch: int):
        get = getattr(self.dataset, "get", None)
        if get is None:
            return self.dataset[index]
        return get(index, sample_rng(self.seed, epoch, index))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate the epoch starting at batch index ``skip`` WITHOUT decoding
        the skipped prefix (mid-epoch preemption resume). Batch order and
        content from ``skip`` on are identical to a full epoch."""
        epoch = self.epoch
        batches = self._batches()[skip:]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        it_lock = threading.Lock()
        idx_iter = iter(enumerate(batches, start=skip))
        results: Dict[int, Dict] = {}
        res_lock = threading.Lock()
        next_emit = [skip]

        def worker():
            try:
                while not stop.is_set():
                    with it_lock:
                        try:
                            bi, idxs = next(idx_iter)
                        except StopIteration:
                            return
                    width = (self._bucket_width(idxs) if self.bucket_by_channels
                             else self.max_channels)
                    if self.native_batch_fn is not None:
                        batch = self.native_batch_fn(idxs, width)
                    else:
                        samples = [self._sample(int(i), epoch) for i in idxs]
                        batch = dense_collate(samples, width, self.channels_last, self.dtype)
                    # emit strictly in batch order; the put polls `stop` so that a
                    # consumer that abandons the epoch early (max_steps,
                    # preemption) leaves no worker parked on a full queue
                    with res_lock:
                        results[bi] = batch
                        while next_emit[0] in results:
                            item = results[next_emit[0]]
                            while True:
                                if stop.is_set():
                                    return
                                try:
                                    out_q.put(item, timeout=0.2)
                                    break
                                except queue.Full:
                                    continue
                            results.pop(next_emit[0])
                            next_emit[0] += 1
            except BaseException as e:  # propagate to the consumer
                out_q.put(_WorkerError(e))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(len(batches)):
                item = out_q.get()
                if isinstance(item, _WorkerError):
                    stop.set()
                    raise item.exc
                yield item
        finally:
            stop.set()
        self.epoch += 1


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              casts: Optional[Dict[str, torch.dtype]] = None) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: each array pinned (on a CUDA device) and
    copied with ``non_blocking=True``, then cast on the device where
    ``casts`` names a dtype for its key."""
    casts = casts or {}
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t.to(casts[k]) if k in casts else t
    return out


def device_prefetch(iterable, upload: Optional[Callable] = None, depth: int = 2):
    """Run ``upload`` (e.g. :func:`to_device`) on the items of ``iterable``
    in ONE background thread, ``depth`` items ahead of the consumer, and
    yield the results in order.

    The copies are issued on the device's current stream from that thread,
    so they are ordered before every kernel the consumer enqueues after
    receiving the batch. Exceptions in the producer propagate to the
    consumer; abandoning the generator early (``break``, preemption) stops
    the producer.
    """
    _end = object()
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not _put(item if upload is None else upload(item)):
                    return
            _put(_end)
        except BaseException as e:  # propagate to the consumer
            _put(_WorkerError(e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _end:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        stop.set()

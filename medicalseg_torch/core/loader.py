# Copyright 2026. Apache License 2.0.
"""The host data pipeline that feeds the card.

Counterpart of ``medicalseg_tpu/core/loader.py``: an iteration-oriented
loader with a producer thread a batch or two ahead, in one of three modes.

  * ``device_cache`` (``auto`` picks it when every transform has a device
    implementation, every volume has one shape and the deduplicated
    dataset takes at most ``device_cache_bytes``, 1 GiB, in the wire
    dtypes: the JAX loader's rule): the whole dataset is staged on the
    card once (:meth:`TrainLoader.build_device_cache`), and the loader
    yields only int32 index vectors [N] into :attr:`TrainLoader.
    unique_pairs`; the train step gathers its batch on the card
    (``core.state.make_cached_train_step``).
  * ``device`` (``auto``'s choice for larger or mixed-shape datasets with
    device transforms): the producer reads each batch of raw phase0
    ``.npy`` volumes in one call of the native reader; augmentation runs
    on the card at the head of the train step
    (:class:`~medicalseg_torch.transforms.DeviceAugmentor`).
  * ``host``: Compose runs per sample across ``num_workers`` threads
    (the reference's DataLoader). Each sample's transforms draw from a
    generator seeded from (seed, batch number, row of the global batch),
    so the draws depend neither on thread order nor on the process. The
    batch number is the loader's count of batches made, so a resumed run
    restarts it from 0, as it restarts the shuffle.

The shuffle is the JAX loader's: ``np.random.RandomState(seed)`` permutes
the train list (repeated ``repeat_train`` times) epoch by epoch, so the
same seed gives the same index sequence in every mode. Batches are CPU
tensors in a wire format: ``wire_dtype='bfloat16'`` ships images as bf16
and labels as uint8 (int16 where the classes or the ignore index need it),
2-4x fewer bytes than float32 / int32; the train step widens them on the
card. The device cache holds the volumes in the same wire dtypes.

In ``device`` and ``device_cache`` modes the volumes are read by the
native C++ reader (:class:`~medicalseg_torch.data_native.
NativeVolumeLoader`: a thread pool with its own LRU byte cache and
prefetch), one for the images and one for the labels over
:attr:`TrainLoader.unique_pairs`, as the JAX loader reads them: images as
float32, labels as uint8 when the wire label dtype is uint8 and as int32
otherwise, each cast to the wire dtype. With ``pin_memory`` (batches bound
for a card) a ``device`` batch is read into a fresh buffer of torch's
pinned allocator, so the prefetcher copies it without pinning it again.
Where the native reader cannot be built, these modes raise with the
compiler's output. ``host`` mode runs the dataset's Compose in Python.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..transforms import device_supports
from ..utils import logger

MODES = ("auto", "device", "device_cache", "host")
DEVICE_CACHE_BYTES = 1 << 30  # auto: the largest dataset held on the card
PREFETCH = 2  # batches the producer makes ahead of the consumer


def _wire_label_dtype(dataset, wire_dtype):
    if wire_dtype not in ("bfloat16", "bf16"):
        return torch.int32
    top = max(getattr(dataset, "num_classes", None) or 1 << 15,
              getattr(dataset, "ignore_index", None) or 0)
    if top <= 255:
        return torch.uint8
    return torch.int16 if top < 1 << 15 else torch.int32


def _on_device(dataset):
    return device_supports(getattr(dataset, "raw_transforms", None) or [])


class TrainLoader:
    """Infinite shuffled batch iterator over a MedicalDataset.

    Yields, in the wire dtypes (module docstring):
      * device mode: (images [N, D, H, W] raw, labels [N, D, H, W]) CPU
        tensors, pinned with ``pin_memory``;
      * device_cache mode: int32 index vectors [N] (numpy) into
        :attr:`unique_pairs`, the rows of :meth:`build_device_cache`;
      * host mode: (images [N, D, H, W, 1] float transformed, labels int)
        CPU tensors.
    ``cache_bytes`` is the budget of each native reader's cache of
    decoded volumes (device modes). Call :meth:`stop` when done: it also
    frees the native readers.

    ``rows`` = (start, stop) keeps those rows of every batch of
    ``batch_size`` (the global batch of a process mesh: a rank's rows,
    ``parallel.Mesh.rows``) and makes nothing else: the batches follow the
    global order and host mode seeds each row's draws from its global
    row, so the ranks' rows together are, bit for bit, the batches of one
    loader at the global batch. The device cache still holds the whole
    dataset.
    """

    def __init__(self, dataset, batch_size, num_workers=2, seed=0,
                 mode="auto", wire_dtype="float32", cache_bytes=2 << 30,
                 device_cache_bytes=DEVICE_CACHE_BYTES, pin_memory=False,
                 rows=None):
        if mode not in MODES:
            raise ValueError("mode must be one of {}, got {!r}".format(
                MODES, mode))
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = (0, batch_size) if rows is None else tuple(rows)
        self.num_workers = max(1, num_workers)
        self.seed = int(seed)
        self.rng = np.random.RandomState(seed)
        self._made = 0  # batches made: the host draws' step
        self.wire_dtype = wire_dtype
        self._img_dtype = (torch.bfloat16 if wire_dtype in ("bfloat16", "bf16")
                           else torch.float32)
        self._lab_dtype = _wire_label_dtype(dataset, wire_dtype)
        # each volume once (the train list repeats it ``repeat_train``
        # times): the rows of the device cache
        self.unique_pairs = sorted({tuple(p) for p in dataset.file_list})
        self._pair_index = {pair: i
                            for i, pair in enumerate(self.unique_pairs)}
        on_device = _on_device(dataset)
        if mode == "auto":
            mode = "host"
            if on_device:
                mode = ("device_cache" if self._cache_bytes() <=
                        device_cache_bytes else "device")
        if mode == "device_cache" and not on_device:
            raise ValueError("device_cache requires device-supported "
                             "transforms")
        self.mode = mode
        self.pin_memory = bool(pin_memory)
        self._native = None
        reader = "python"
        if mode in ("device", "device_cache"):
            from .. import data_native
            self._native = tuple(
                data_native.NativeVolumeLoader(
                    [pair[k] for pair in self.unique_pairs],
                    threads=self.num_workers, cache_bytes=cache_bytes)
                for k in (0, 1))
            reader = "native ({})".format(data_native.backend())
        logger.info("TrainLoader mode: {} (batch_size={}, wire={}, reader="
                    "{})".format(self.mode, batch_size, wire_dtype, reader))

        self._pool = (ThreadPoolExecutor(self.num_workers)
                      if mode == "host" and self.num_workers > 1 else None)
        self._indices = None
        self._pos = 0
        self._queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _cache_bytes(self):
        """Bytes of the deduplicated dataset in the wire dtypes when every
        image has one shape (read from the ``.npy`` headers); 2^62 when
        the shapes differ or a file cannot be read."""
        if not self.unique_pairs:
            return 1 << 62
        try:
            shapes = {np.load(img, mmap_mode="r").shape
                      for img, _ in self.unique_pairs}
        except (OSError, ValueError):  # missing, or not an .npy array
            return 1 << 62
        if len(shapes) != 1:
            return 1 << 62
        per = int(np.prod(shapes.pop())) * (self._img_dtype.itemsize +
                                             self._lab_dtype.itemsize)
        return per * len(self.unique_pairs)

    def _read_labels_as(self):
        """The dtype the native reader reads labels in: uint8 for a uint8
        wire (clamped to [0, 255]), else int32 (cast to the wire dtype)."""
        return torch.uint8 if self._lab_dtype == torch.uint8 else torch.int32

    def _read(self, reader, indices, wire, read, out):
        """Volumes ``indices`` of ``reader`` into ``out`` ([N, ...] of the
        ``wire`` dtype): read as ``read`` straight into it when the dtypes
        agree, else into a staging array and cast."""
        if wire == read:
            return reader.load_batch(indices, read, out=out)
        return out.copy_(torch.from_numpy(reader.load_batch(indices, read)))

    def read_batch(self, uidx):
        """The device-mode batch of volumes ``unique_pairs[uidx]``:
        (images, labels) [N, D, H, W] CPU tensors in the wire dtypes, read
        by the native readers into a fresh buffer (pinned with
        ``pin_memory``: the copy of the last batch to the card may still
        read its buffer). ValueError when the volumes' shapes differ."""
        images_in, labels_in = self._native
        shape = (len(uidx),) + images_in.shape(uidx[0])
        images = torch.empty(shape, dtype=self._img_dtype,
                             pin_memory=self.pin_memory)
        labels = torch.empty(shape, dtype=self._lab_dtype,
                             pin_memory=self.pin_memory)
        return (self._read(images_in, uidx, self._img_dtype, torch.float32,
                           images),
                self._read(labels_in, uidx, self._lab_dtype,
                           self._read_labels_as(), labels))

    def build_device_cache(self, device="cuda"):
        """Stage every unique volume on ``device`` (device_cache mode):
        (images [V, D, H, W], labels [V, D, H, W]) in the wire dtypes, row
        i holding ``unique_pairs[i]``, read by the native readers volume by
        volume. Raises ValueError when the shapes differ."""
        if self._native is None:
            raise ValueError("build_device_cache reads through the native "
                             "readers of the device modes; mode is "
                             + self.mode)
        images_in, labels_in = self._native
        n = len(self.unique_pairs)
        shape = images_in.shape(0)
        images = torch.empty((n,) + shape, dtype=self._img_dtype)
        labels = torch.empty((n,) + shape, dtype=self._lab_dtype)
        for i in range(n):
            got = images_in.shape(i)
            if got != shape:
                raise ValueError(
                    "device_cache requires uniform volume shapes; got {} "
                    "vs {}".format(got, shape))
            self._read(images_in, [i], self._img_dtype, torch.float32,
                       images[i:i + 1])
            self._read(labels_in, [i], self._lab_dtype,
                       self._read_labels_as(), labels[i:i + 1])
        logger.info(
            "device cache: {} volumes, images {} {} + labels {} {} = "
            "{:.0f} MB on {}".format(
                n, tuple(images.shape), images.dtype, tuple(labels.shape),
                labels.dtype, (images.nbytes + labels.nbytes) / 1e6, device))
        return images.to(device), labels.to(device)

    def _next_indices(self):
        n = len(self.dataset)
        out = []
        while len(out) < self.batch_size:
            if self._indices is None or self._pos >= len(self._indices):
                self._indices = np.arange(n)
                self.rng.shuffle(self._indices)
                self._pos = 0
            take = min(self.batch_size - len(out),
                       len(self._indices) - self._pos)
            out.extend(self._indices[self._pos:self._pos + take])
            self._pos += take
        return np.asarray(out)

    def _make_batch(self):
        idxs = self._next_indices()[self.rows[0]:self.rows[1]]
        uidx = [self._pair_index[tuple(self.dataset.file_list[i])]
                for i in idxs]
        if self.mode == "device_cache":
            return np.asarray(uidx, np.int32)
        if self.mode == "device":
            return self.read_batch(uidx)

        step, self._made = self._made, self._made + 1

        def one(row, i):
            # the draws of global row ``row`` of batch ``step``
            rng = np.random.default_rng([self.seed, step, row])
            im, lab, _ = self.dataset.item(int(i), rng)
            # Compose gives [1, D, H, W]; NDHWC wants [D, H, W, 1]
            return (np.moveaxis(np.asarray(im, np.float32), 0, -1),
                    np.asarray(lab))
        rows = range(self.rows[0], self.rows[0] + len(idxs))
        items = (list(self._pool.map(one, rows, idxs)) if self._pool
                 else [one(r, i) for r, i in zip(rows, idxs)])
        images = np.stack([it[0] for it in items])
        labels = np.stack([it[1] for it in items])
        return (torch.from_numpy(images).to(self._img_dtype),
                torch.from_numpy(labels).to(self._lab_dtype))

    def _producer(self):
        while not self._stop.is_set():
            try:
                item = self._make_batch()
            except Exception as e:  # surfaced to the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._queue.get(timeout=0.5)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        """End the producer and free the native readers. A producer still
        inside a native read holds its reader until the read returns;
        :meth:`NativeVolumeLoader.close` waits for it."""
        self._stop.set()
        self._thread.join(timeout=10)
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        for reader in self._native or ():
            reader.close()

    @property
    def iters_per_epoch(self):
        return max(1, len(self.dataset) // self.batch_size)


class EvalLoader:
    """Sequential batch-size-1 loader over the val set. Yields (image NDHWC
    [1, D, H, W, 1] float32, label [1, D, H, W] int32, index) numpy arrays;
    ``start``/``stop`` select a shard of the index range."""

    def __init__(self, dataset, start=0, stop=None):
        self.dataset = dataset
        self.start = int(start)
        self.stop = len(dataset) if stop is None else int(stop)

    def __len__(self):
        return max(self.stop - self.start, 0)

    def __iter__(self):
        for idx in range(self.start, self.stop):
            im, label, _ = self.dataset[idx]
            im = np.moveaxis(np.asarray(im, np.float32), 0, -1)[None]
            label = np.asarray(label, np.int32)[None]
            yield im, label, idx

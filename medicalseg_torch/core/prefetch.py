# Copyright 2026. Apache License 2.0.
"""Host-to-device prefetch.

Counterpart of ``medicalseg_tpu/core/prefetch.py``. A thread takes each
host batch from the producer (the loader), pins it (a no-op for a batch
the loader read into pinned memory) and starts its copy to the card on a
side CUDA stream, recording an event behind the copy; the
consumer's stream waits on that event (the host does not), so the copy of
batch k + 1 overlaps the step of batch k. Each tensor is marked with
``record_stream`` for the consumer's stream, so the caching allocator does
not hand its memory to another tensor while work of the consumer may still
read it. On the CPU the items pass through unchanged.
"""

import queue
import threading

import torch

_DONE = object()
DEPTH = 2  # batches copied ahead of the consumer: double buffering


class DevicePrefetcher:
    """Iterate device-resident items ahead of the consumer.

    Args:
        producer: iterable of host items, each a tuple (or list) of CPU
            tensors. It is consumed in its own thread.
        device: where the items go.

    Raises in the consumer any exception the producer hit. Call
    :meth:`close` (or exhaust it) to end the thread.
    """

    def __init__(self, producer, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._queue = queue.Queue(maxsize=DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(producer,),
                                        daemon=True)
        self._thread.start()

    def _copy(self, item):
        if not self._cuda:
            return tuple(item), None
        with torch.cuda.stream(self._stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self, producer):
        try:
            for item in producer:
                if self._stop.is_set():
                    return
                self._put(self._copy(item))
        except Exception as e:  # surfaced on the consumer side
            self._put(e)
            return
        self._put(_DONE)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)

"""Background batch prefetching.

The port's copy of `mvgformer_tpu/data/prefetch.py`: host-side image load
and warp, and the host-to-device copy, run on a producer thread with a
bounded queue (double-buffered by default), overlapping the step. The
consumer tracks how long it blocked waiting (`last_wait_s`,
`total_wait_s`), so a loop can log whether the loader holds the step back.

On the card, `DevicePlacer` issues each batch's copy from pinned memory
with `non_blocking=True` on a stream of its own and records an event; the
consumer makes its current stream wait on that event and marks every
placed tensor as used there (`record_stream`) before it reads the batch,
so a batch is never read before its copy lands.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

import torch

from mvgformer_tpu_torch.data.meta import map_tensors


class Prefetcher:
    """Wrap an (idx, host_batch) iterator; yields (idx, placed_batch).

    place_fn runs ON THE PRODUCER THREAD; ready_fn, where given, runs on
    the consumer's thread on each placed item before it is yielded.

    The consumer may stop early (e.g. --max_steps breaking mid-epoch);
    `close()` (called when the consuming generator is closed or
    garbage-collected, or by the context manager) unblocks and joins the
    producer, so queued device batches are freed.
    """

    _SENTINEL = object()

    def __init__(self, iterator: Iterable, place_fn: Callable,
                 depth: int = 2, ready_fn: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err = []
        self._stop = threading.Event()
        self._ready = ready_fn
        self.last_wait_s = 0.0
        self.total_wait_s = 0.0

        def worker():
            try:
                for idx, batch in iterator:
                    if self._stop.is_set():
                        break
                    placed = (idx, place_fn(batch))
                    # a bounded put that re-checks the stop flag, so that
                    # close() cannot deadlock against a full queue
                    while not self._stop.is_set():
                        try:
                            self._q.put(placed, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001
                self._err.append(e)
            finally:
                # blocking but interruptible: put_nowait could drop the
                # sentinel on a full queue and deadlock the consumer
                while not self._stop.is_set():
                    try:
                        self._q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the producer and drop queued batches.

        Join before draining: a put() blocked in its retry window could
        otherwise land one more placed batch after the drain."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[Tuple]:
        try:
            while True:
                t0 = time.perf_counter()
                item = self._q.get()
                self.last_wait_s = time.perf_counter() - t0
                self.total_wait_s += self.last_wait_s
                if item is self._SENTINEL:
                    if self._err:
                        raise self._err[0]
                    return
                idx, placed = item
                yield idx, (placed if self._ready is None
                            else self._ready(placed))
        finally:
            self.close()


class DevicePlacer:
    """Places Batches (dataclasses of CPU tensors) on `device` for a
    Prefetcher: `place` on the producer thread, `ready` on the consumer's.

    On a CUDA device, `place` pins the batch and copies it with
    non_blocking=True on this placer's own stream, then records an event;
    `ready` makes the consumer's current stream wait on the event and
    records the placed tensors as used on that stream. The pinned batch is
    kept with the placed one until `ready`. On the CPU both are plain."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def place(self, batch):
        if self.stream is None:
            return batch.to(self.device)
        pinned = map_tensors(batch, lambda t: t.pin_memory())
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            placed = map_tensors(
                pinned, lambda t: t.to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self.stream)
        return placed, done, pinned

    def ready(self, item):
        if self.stream is None:
            return item
        placed, done, _pinned = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        map_tensors(placed, lambda t: t.record_stream(current))
        return placed

    def prefetch(self, iterator: Iterable, depth: int = 2) -> Prefetcher:
        """A Prefetcher over (idx, host_batch) that yields placed
        batches."""
        return Prefetcher(iterator, self.place, depth=depth,
                          ready_fn=self.ready)

"""Background-thread batch prefetching for the host input pipeline (port of
``pdfnet_tpu/data/prefetch.py``).

The device step and the (CPU-bound) sample building overlap: a worker
thread keeps a small queue of ready host batches, optionally already
transformed (for example copied to the card).  Replaces torch's
DataLoader(num_workers=N) role; numpy/cv2 release the GIL in the hot paths
so threads suffice.

One repair against the JAX module: the end-of-source marker is queued like
an item, waiting for room, where the JAX module drops it when the queue is
full, which leaves a consumer slower than the source blocked for ever.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class PrefetchIterator:
    """Iterator wrapper with a one-deep worker thread.

    Supports early exit: ``close()`` (also via context manager / GC) stops
    the worker, drains the queue, and closes the source generator so its
    resources (thread pools, file handles) are released promptly.
    """

    def __init__(self, source: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(source),), daemon=True)
        self._thread.start()

    def _worker(self, it: Iterator):
        try:
            for item in it:
                if self._stop.is_set():
                    break
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    break
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException:
                    pass
            # the end marker waits for room like any item: dropped on a full
            # queue, it would leave a slower consumer blocked for ever once
            # it has drained the queue
            while not self._stop.is_set():
                try:
                    self._q.put(self._done, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Stop the worker and release the source iterator."""
        self._stop.set()
        # drain so a blocked put() observes the stop flag quickly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(source: Iterable, depth: int = 2,
             transform: Optional[Callable] = None) -> PrefetchIterator:
    return PrefetchIterator(source, depth, transform)

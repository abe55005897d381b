"""Threaded input prefetching — the async input pipeline.

Role of the reference's `DataLoader(num_workers=8, collate_fn=
merge_second_batch)` (`train.py:259-273`): example prep (augmentation +
target assignment, numpy) runs in background threads while the device
executes the previous step, keeping host prep off the critical path.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchIterator:
    """Wrap a batch-producing iterator with N worker threads + a queue.
    Batches come out in the order they were made, whichever worker made
    each: a data-parallel step's ranks each take their slice of the same
    k-th global batch."""

    def __init__(self, make_batch: Callable[[], dict], num_workers: int = 2,
                 prefetch_size: int = 4):
        self._make_batch = make_batch
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch_size)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._made = 0                # batches made (under the lock)
        self._next = 0                # the next batch __next__ hands out
        self._ready: dict = {}        # batches taken off the queue early
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                with self._lock:      # batch order/rng stays deterministic
                    seq = self._made
                    self._made += 1
                    batch = self._make_batch()
            except Exception as e:    # surface errors on the consumer side
                self._queue.put((seq, e))
                return
            while not self._stop.is_set():
                try:
                    self._queue.put((seq, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        # workers enqueue in any order once out of the lock: hold the
        # batches that come early until their turn
        while self._next not in self._ready:
            seq, item = self._queue.get()
            if isinstance(item, Exception):
                raise item
            self._ready[seq] = item
        item = self._ready.pop(self._next)
        self._next += 1
        return item

    def close(self):
        self._stop.set()


def bounded_ordered_map(fn, items, num_workers: int = 4,
                        prefetch: int = 8):
    """Like ThreadPoolExecutor.map but with a bounded in-flight window, so
    results stream in order without materializing the whole input (used by
    the eval loop: per-batch example prep runs in threads while the device
    executes the previous batch)."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    items = iter(items)
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        window: collections.deque = collections.deque()
        try:
            for _ in range(prefetch):
                window.append(ex.submit(fn, next(items)))
        except StopIteration:
            pass
        while window:
            result = window.popleft().result()
            try:
                window.append(ex.submit(fn, next(items)))
            except StopIteration:
                pass
            yield result

"""Host-side input pipeline of the training epoch: batches prepared on a
producer thread ahead of the step; the port of
supnerf_tpu/training/prefetch.py's PrefetchBatcher (the reference hides its
ray prep in torch DataLoader worker processes, train_nuscenes.py
--num_workers).

The producer prepares each batch (one batch_prepare_fn call, or
prepare_fn per row on a pool of num_workers threads; numpy releases the
interpreter lock only in its large operations, so the producer and the
consumer's own work contend for it: training/trainer.py), collates it and
puts it on a queue of `prefetch` batches. Three rules hold, as in the JAX
package:
  - the consumer sees exactly the batches of the serial loop, in its order;
  - an exception in the producer is raised on the consumer's thread;
  - a consumer that stops early leaves no live producer: the producer's
    puts wait a bounded time and re-check a stop flag.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

THREAD_NAME = "train-prefetch"
# seconds a blocked put waits before it re-checks whether the consumer left
_PUT_POLL_S = 0.2


class PrefetchBatcher:
    """Iterates collated batches of `indices` (full batches only, as the
    training loop takes them) prepared ahead of consumption.

    prepare_fn(idx) -> row; collate_fn(rows or the batch_prepare_fn result,
    the seconds their preparation took) -> batch; batch_prepare_fn(idxs),
    when given, prepares a whole batch in one call instead of prepare_fn on
    the pool."""

    def __init__(self, prepare_fn, collate_fn, indices, batch_size: int,
                 num_workers: int = 4, prefetch: int = 2, batch_prepare_fn=None):
        if num_workers < 1:
            raise ValueError("num_workers >= 1 (the serial loop takes 0)")
        self.prepare_fn, self.collate_fn = prepare_fn, collate_fn
        self.indices = list(indices)
        self.batch_size, self.num_workers, self.prefetch = batch_size, num_workers, prefetch
        self.batch_prepare_fn = batch_prepare_fn

    def __len__(self):
        return len(self.indices) // self.batch_size

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=_PUT_POLL_S)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(len(self)):
                        if stop.is_set():
                            return
                        idxs = self.indices[b * self.batch_size:(b + 1) * self.batch_size]
                        t0 = time.perf_counter()
                        if self.batch_prepare_fn is not None:
                            rows = self.batch_prepare_fn(idxs)
                        else:
                            rows = list(pool.map(self.prepare_fn, idxs))
                        put(self.collate_fn(rows, time.perf_counter() - t0))
            except Exception as e:  # raised again on the consumer's thread
                put(e)
            finally:
                put(None)

        threading.Thread(target=producer, name=THREAD_NAME, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

"""Threaded prefetching loader: overlap host-side sample preparation (JPEG
decode, anyres tiling — GIL-releasing native/numpy work) with device steps.

The port's copy of `vis_zephyr_tpu/data/prefetch.py` (no JAX in it). The
reference delegates this to torch DataLoader worker processes
(`train/train.py:849`, SURVEY §3.1 "PROCESS BOUNDARY: CPU"). Threads
suffice here because the heavy work runs in C (libjpeg / the native
pipeline / numpy), and threads avoid pickling + copy costs for the large
pixel arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence


class PrefetchLoader:
    """Iterates batches of dataset samples, prepared by a worker pool,
    collated in submission order."""

    def __init__(
        self,
        dataset,
        collate: Callable,
        batch_indices: Sequence[Sequence[int]],
        num_workers: int = 4,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.collate = collate
        self.batches = [list(b) for b in batch_indices]
        self.num_workers = max(1, num_workers)
        self.depth = max(1, prefetch_batches)

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        job_q: "queue.Queue" = queue.Queue()
        for i, batch in enumerate(self.batches):
            job_q.put((i, batch))
        results = {}
        results_lock = threading.Lock()
        next_emit = [0]
        emit_cv = threading.Condition()

        def worker():
            while True:
                try:
                    i, batch = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    samples = [self.dataset[j] for j in batch]
                    payload = ("ok", self.collate(samples))
                except Exception as e:  # noqa: BLE001 — surfaced to consumer
                    payload = ("err", e)
                with emit_cv:
                    results[i] = payload
                    emit_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        for i in range(len(self.batches)):
            with emit_cv:
                while i not in results:
                    emit_cv.wait()
                status, payload = results.pop(i)
            if status == "err":
                raise payload
            yield payload

"""Prefetching input pipeline.

The port of ``repro.data.pipeline``. The prefetch-buffer depth is sized
by the paper's FIFO-depth logic (``core.dataflow.prefetch_depth``):
enough slots to cover consumer stalls of a few producer periods. A
background thread calls ``batch_fn(step)`` for consecutive steps and
queues the host batches; the train step copies each to the card
(``train.steps.batch_to_device``). Batches are functions of the step, so
a resumed run starts the pipeline at its step and needs no pipeline
state in the checkpoint.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

from repro_torch.core.dataflow import prefetch_depth


class DataPipeline:
    """Wraps a ``batch_fn(step) -> dict of numpy arrays`` with prefetch;
    iterating yields ``(step, batch)`` in step order from ``start_step``."""

    def __init__(
        self,
        batch_fn: Callable[[int], Any],
        start_step: int = 0,
        producer_period_s: float = 0.001,
        consumer_period_s: float = 0.01,
    ):
        self.batch_fn = batch_fn
        self.depth = prefetch_depth(producer_period_s, consumer_period_s)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

"""Host-side data pipeline: deterministic, resumable, prefetching (PyTorch
port of ``repro.data.pipeline``).

Batches are derived from (seed, step) only, so a restart resumes the stream
exactly by moving the cursor to the checkpoint's step: there is no host
state to persist.  A background thread keeps ``prefetch`` batches ready so
host generation overlaps device compute; an exception in ``make_batch`` is
raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

CLOSE_TIMEOUT_S = 10.0  # how long close() waits for a worker inside make_batch


class DataPipeline:
    """Wraps ``make_batch(step) -> batch`` with prefetch and resume."""

    def __init__(self, make_batch: Callable[[int], object], *, start_step: int = 0,
                 prefetch: int = 2):
        self.make_batch = make_batch
        self.step = start_step
        self.prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                batch = self.make_batch(s)
            except Exception as e:  # surfaced in the consumer
                self._q.put(e)
                return
            self._q.put((s, batch))
            s += 1

    def __iter__(self) -> Iterator:
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        s, batch = item
        self.step = s + 1
        return s, batch

    def close(self):
        """Stop the worker: drain the queue so a blocked ``put`` returns, then join."""
        self._stop.set()
        timeout = CLOSE_TIMEOUT_S
        while self._thread is not None and self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            timeout -= 0.05
            if timeout <= 0:
                raise RuntimeError("the data pipeline's worker did not stop")

"""A producer thread that builds host batches ahead of the training step.

Both trainers' ``fit`` overlap host work (batch draws, the pair lookup of
``_prep_host_arrays``, host plans) with the device step this way, as the
JAX package's do (``stargcn_tpu/train/loop.py:813-840``,
``stargcn_tpu/train/sampled_loop.py:615-676``).  The thread runs numpy
only: it touches no device, so copies to the card stay on the main thread.
It is the only consumer of the samplers it is given, so it draws in the
order a serial loop does, and it stops after the batches ``fit`` will take,
so a ``fit`` that runs to its end leaves the samplers' shared stream where
a serial one does (one that stops early has drawn up to ``depth`` + 1
results more).
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Calls ``make()`` ``count`` times in a daemon thread and queues up to
    ``depth`` results ahead of ``get()``; ``setup()``, where given, runs
    first in that thread (a per-thread setting such as the OpenMP team
    cap).  An exception in ``setup`` or ``make`` is raised by the ``get``
    that would have returned the result.  Use it as a context manager:
    leaving the block stops the thread and joins it (after the ``make`` call
    in flight returns), also when the block raises."""

    def __init__(self, make, count: int, depth: int = 2, setup=None):
        self._queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(make, count, setup),
                                        name="prefetch", daemon=True)
        self._thread.start()

    def _run(self, make, count, setup):
        for i in range(count):
            if self._stop.is_set():
                return
            try:
                if i == 0 and setup is not None:
                    setup()
                item = (True, make())
            except BaseException as e:  # raised again by get()
                item = (False, e)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if not item[0]:
                return

    def get(self):
        ok, item = self._queue.get()
        if not ok:
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

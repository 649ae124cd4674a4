"""Host-side timing utilities.

Counterpart of ``optimization_tpu/core/host.py``.  The reference drives
wall-clock facilities from inside its solver loops (``Util/Stopwatch.h:
15-29``, ``Base/Concepts.h:47-49,76-80``): per-iteration ``result.time[]``,
the ``max_computation_time`` stop and the ``verbose`` lines.  The port's
host driver (:mod:`.driver`) reads the clock between chunks of iterations;
this module holds its stopwatch.
"""

from __future__ import annotations

import time

__all__ = ["Stopwatch"]


class Stopwatch:
    """Wall-clock stopwatch in seconds (reference ``Util/Stopwatch.h:15-29``)."""

    def __init__(self) -> None:
        self._start = time.monotonic()

    def tick(self) -> None:
        self._start = time.monotonic()

    def tock(self) -> float:
        return time.monotonic() - self._start

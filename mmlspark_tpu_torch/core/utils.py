"""Small host-side utilities — the port's copy of ``mmlspark_tpu/core/utils.py``.

Equivalents of the reference's ``core/utils`` + ``core/env`` helpers:
``StopWatch`` (``core/utils/StopWatch.scala``), ``AsyncUtils.bufferedAwait``
(``core/utils/AsyncUtils.scala``), ``FaultToleranceUtils.retryWithTimeout``
(``downloader/ModelDownloader.scala:37-52``), ``StreamUtilities.using``
(``core/env/StreamUtilities.scala``).
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class StopWatch:
    """Accumulating nanosecond stopwatch with a measure() context manager."""

    def __init__(self) -> None:
        self.elapsed_ns = 0
        self._start: Optional[int] = None

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        if self._start is not None:
            self.elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9


def retry(
    fn: Callable[[], T],
    attempts: int = 5,
    initial_delay_s: float = 0.1,
    backoff: float = 2.0,
    retryable: Callable[[Exception], bool] = lambda e: True,
) -> T:
    """Exponential-backoff retry (cf. ``TrainUtils.scala:496-512`` network-init
    retries and ``ModelDownloader.scala:37-52``)."""
    delay = initial_delay_s
    last: Optional[Exception] = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            if not retryable(e):
                raise
            last = e
            if i < attempts - 1:
                time.sleep(delay)
                delay *= backoff
    assert last is not None
    raise last


def buffered_parallel_map(
    fn: Callable[[T], R], items: Sequence[T], max_concurrency: int = 8
) -> List[R]:
    """Bounded-concurrency map on a thread pool — ``AsyncUtils.bufferedAwait``.
    Order-preserving. Used for HTTP fan-out and AutoML sweeps, never for
    device compute (which batches instead)."""
    if not items:
        return []
    with ThreadPoolExecutor(max_workers=min(max_concurrency, len(items))) as pool:
        return list(pool.map(fn, items))


@contextlib.contextmanager
def using(*resources: Any) -> Iterator[Sequence[Any]]:
    """RAII for close()-able resources (``StreamUtilities.using``)."""
    try:
        yield resources
    finally:
        for r in reversed(resources):
            with contextlib.suppress(Exception):
                r.close()

"""Tracing and profiling utilities — the port's copy of
``mmlspark_tpu/core/profiling.py``, over ``torch.profiler`` where the
reference has ``jax.profiler``: :func:`profile_trace` captures any region as
a Chrome trace, and :func:`annotate` names a region inside it (and, on a
card, an NVTX range).

    from mmlspark_tpu_torch.core.profiling import profile_trace, annotate, StopWatch

    with profile_trace("traces/"):             # host + CUDA activity
        with annotate("gbdt-fit"):             # named region in the trace
            model = clf.fit(table)

    sw = StopWatch()
    with sw.measure("binning"):
        ...
    sw.summary()  # {"binning": seconds}
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch


def get_logger(name: str = "mmlspark_tpu_torch") -> logging.Logger:
    """Framework logger: a namespaced logger with one stderr handler
    installed on first use; level via MMLSPARK_TPU_LOGLEVEL."""
    logger = logging.getLogger(name)
    root = logging.getLogger("mmlspark_tpu_torch")
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        root.addHandler(handler)
        root.setLevel(os.environ.get("MMLSPARK_TPU_LOGLEVEL", "WARNING").upper())
        # propagate stays True: log-capture tooling (pytest caplog) hooks the
        # python root logger
    return logger


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the body (host activity, and
    CUDA kernels when a card is present) and write it to ``log_dir`` as a
    Chrome trace (``trace_<pid>_<ns>.json``). Yields the profiler, whose
    ``key_averages()`` summarize the region."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active profiler trace (and an NVTX range on a
    card, for Nsight); little overhead when no trace is running."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class StopWatch:
    """Accumulating named phase timer — the reference's ``StopWatch``
    (``core/utils/StopWatch.scala``) / VW per-phase diagnostics pattern."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, phase: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(phase, time.perf_counter() - t0)

    def add(self, phase: str, seconds: float) -> None:
        """Fold an externally-timed duration into ``phase``."""
        self._totals[phase] = self._totals.get(phase, 0.0) + seconds

    def summary(self) -> Dict[str, float]:
        return dict(self._totals)

    def log(self, logger: Optional[logging.Logger] = None, prefix: str = "") -> None:
        logger = logger or get_logger()
        total = sum(self._totals.values()) or 1.0
        for phase, secs in sorted(self._totals.items(), key=lambda kv: -kv[1]):
            logger.info("%s%s: %.3fs (%.0f%%)", prefix, phase, secs, 100 * secs / total)

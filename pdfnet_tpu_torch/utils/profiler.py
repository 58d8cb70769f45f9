"""Profiling / tracing hooks (port of ``pdfnet_tpu/utils/profiler.py`` on
``torch.profiler``).

The reference has no profiling subsystem beyond wall-clock AverageMeters
(lib/trains/base_trainer.py:116-121, batch_time/data_time).  The port keeps
both meters (data wait against step time) and, over a window of steps, a
``torch.profiler`` trace of the host and the card, written as a Chrome trace
(``{trace_dir}/trace_{first step}.json``, viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from pdfnet_tpu_torch.utils.vis import AverageMeter


class StepProfiler:
    """Per-step timing meters + an optional ``torch.profiler`` window.

    Usage::

        prof = StepProfiler(trace_dir="outputs/profile", start_step=10,
                            num_steps=5, sync=True)
        for batch in data:
            prof.data_tick()           # after the batch is ready
            with prof.step():          # wraps the device step
                stats = train_step(...)
        prof.close()                   # stops a still-open trace

    Attribution: a CUDA call returns before the card finishes, so step()
    measures the host's enqueue unless ``sync`` is set, in which case it
    synchronizes the card before it stops the clock (``Config.profile_sync``,
    and always inside a trace window, where exact step boundaries matter).
    Without it the card's time surfaces at the next host sync and lands in
    data_time; the meters then measure pipeline gaps.
    """

    def __init__(self, trace_dir: str = "", start_step: int = 10,
                 num_steps: int = 5, sync: bool = False):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.sync = sync
        self.step_num = 0
        self._prof = None
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._last = time.perf_counter()

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def reset_epoch(self) -> None:
        """Reset the wall-clock meters at an epoch boundary so that set-up
        before the first step is not charged to data_time and the summary
        reflects only the current epoch."""
        self.batch_time.reset()
        self.data_time.reset()
        self._last = time.perf_counter()

    def data_tick(self) -> None:
        """Call when the host batch is ready: accumulates data-wait time."""
        now = time.perf_counter()
        self.data_time.update(now - self._last)
        self._last = now

    def _synchronize(self) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def step(self):
        """Wrap one train step: a named range, the trace window's edges and
        (with ``sync`` or inside the window) a card synchronize."""
        if self.trace_dir and self._prof is None \
                and self.step_num == self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._first = self.step_num
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"train_step_{self.step_num}"):
            yield
            if self.sync or self._prof is not None:
                self._synchronize()
        now = time.perf_counter()
        self.batch_time.update(now - t0)
        self._last = now
        self.step_num += 1
        if self._prof is not None and self.step_num >= self.stop_step:
            self.close()

    def close(self) -> None:
        """Stop a still-open trace window and write its Chrome trace."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.trace_dir, f"trace_{self._first}.json"))

    def summary(self) -> Dict[str, float]:
        return {
            "data_time_avg_s": self.data_time.avg,
            "step_time_avg_s": self.batch_time.avg,
        }

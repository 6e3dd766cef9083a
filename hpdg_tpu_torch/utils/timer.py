"""Timers and profiling helpers.

Port of ``hpdg_tpu.utils.timer``: wall-clock timers that wait for the
device to finish the work they time, and named trace regions that show
up in ``torch.profiler`` traces.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

# the trace started by :func:`start_trace`, until :func:`stop_trace`
_ACTIVE: list = []


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)


def synchronize(result) -> None:
    """Wait until the device work that produces ``result`` (a tensor, or
    a dict/list/tuple of them) has finished: one synchronize per CUDA
    device among its tensors."""
    for d in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(d)


class Timer:
    """Wall-clock timer that waits for device work (Dune::Timer analog)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self, result=None) -> float:
        if result is not None:
            synchronize(result)
        return time.perf_counter() - self._t0


@contextmanager
def profile_region(name: str):
    """Named trace region: shows up in torch.profiler traces."""
    with torch.profiler.record_function(name):
        yield


def start_trace(logdir: str):
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the card; :func:`stop_trace` writes it to ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _ACTIVE.append((prof, logdir))
    return prof


def stop_trace() -> str:
    """Stop the trace :func:`start_trace` began and write it as a Chrome
    trace into its ``logdir``; returns the file's path."""
    prof, logdir = _ACTIVE.pop()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path

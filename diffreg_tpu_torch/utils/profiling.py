"""Profiling helpers: timers that include the device's work, and traces.

Counterpart of the JAX package's utils/profiling.py (the reference's
CudaRuntimeProfiler/CpuRuntimeProfiler, vision3d/utils/profiling.py:6-70).
On a CUDA device a block is timed by CUDA events recorded around it, read
after the end event has completed; on the CPU by the host clock, since the
CPU's work is done when the block returns. ``trace`` records a
``torch.profiler`` trace for TensorBoard.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


def _device_of(value, device):
    if device is not None:
        return torch.device(device)
    leaves = value if isinstance(value, (list, tuple)) else [value]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class _Clock:
    """Start/stop on one device: CUDA events there, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            with torch.cuda.device(device):
                self._start = torch.cuda.Event(enable_timing=True)
                self._end = torch.cuda.Event(enable_timing=True)
            self._device = device

    def start(self):
        if self.cuda:
            self._start.record(torch.cuda.current_stream(self._device))
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds since ``start``, once the device has finished the block."""
        if self.cuda:
            self._end.record(torch.cuda.current_stream(self._device))
            self._end.synchronize()
            return self._start.elapsed_time(self._end) / 1e3
        return time.perf_counter() - self._t0


class DeviceTimer:
    """Context manager timing a block, the device's completion included. The
    device is ``device``, or that of ``sync_value`` (a tensor or a sequence
    holding one), or the CPU."""

    def __init__(self, name: str = "", sync_value=None, device=None):
        self.name = name
        self.elapsed = 0.0
        self._clock = _Clock(_device_of(sync_value, device))

    def __enter__(self):
        self._clock.start()
        return self

    def __exit__(self, *exc):
        self.elapsed = self._clock.stop()
        return False


@contextlib.contextmanager
def runtime_profiler(name: str, timers=None, device=None):
    """Keyed timing block on ``device`` (default the CPU) feeding a
    ``utils/logging.py:Timers``."""
    clock = _Clock(_device_of(None, device))
    clock.start()
    try:
        yield
    finally:
        dt = clock.stop()
        if timers is not None:
            timers.meters[name].update(dt)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A torch.profiler trace of the block (the CPU, and CUDA where there is
    one), written for TensorBoard under ``log_dir`` (default: a directory in
    the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "diffreg_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof

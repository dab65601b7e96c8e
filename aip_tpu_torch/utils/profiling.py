"""Tracing and step timing. Port of ``aip_tpu.utils.profiling`` (the
rebuild's analog of the reference's CUDA-event iteration timing,
``train.py:117-118,158,225``).

``trace(dir)`` wraps a block in ``torch.profiler`` and writes a Chrome
trace (``trace.json``, viewable in Perfetto); ``StepTimer`` measures each
step's wall time, synchronising with the card first when asked to.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (the CPU, and the card where there is one)
    and write ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def device_sync(x) -> None:
    """Block until the card has computed ``x`` (a tensor, or a list or tuple
    whose first entry is one): ``torch.cuda.synchronize`` on its device. A
    CPU tensor is computed already."""
    t = x[0] if isinstance(x, (list, tuple)) else x
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Rolling per-step timing with EMA (the reference's iter_time scalar)."""

    def __init__(self, ema: float = 0.6):
        self.ema = ema
        self.value = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            device_sync(sync_on)
        dt = time.perf_counter() - self._t0
        self.value = dt if self.value is None else (
            self.ema * self.value + (1 - self.ema) * dt)
        return dt

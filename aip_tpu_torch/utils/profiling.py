"""The port's spans and counters, and its trace export. Port of
``aip_tpu.utils.profiling`` (the rebuild's analog of the reference's
CUDA-event iteration timing, ``train.py:117-118,158,225``).

``span(name)`` names a stage of the work and ``count(name, n)`` counts
something where that work happens. Both record only while a
``torch.profiler`` runs in the process: outside one, each costs a check of
the profiler's flag and nothing more (no ``record_function``, no clock
read, no allocation), so a counter outside a profiler counts nothing.
Under a profiler a span

* opens ``record_function(name)``: the span is an event of the profiler's
  trace, on its clock, and the device work launched under it is the span's;
* stamps ``time.perf_counter_ns()`` at entry and exit and adds, per name,
  the openings (``count``), the host seconds (``host_s``) and the self host
  seconds (``self_host_s``: the duration less the part covered by the
  spans opened inside it on the same thread);
* given ``device=`` a CUDA tensor or device (``True``: the current CUDA
  device), records a CUDA timing event at each bound; the pairs become
  ``device_s`` only when the totals are read, which waits for the card.

``span_stats()`` returns the totals, ``reset_spans()`` clears them.
``span(..., timed=True)`` also stamps (and records its events) outside a
profiler, without totals, for a caller that reads its own span: the
``as`` target's ``ms()``. ``trace(dir)`` profiles a block and writes a
Chrome trace (Perfetto); ``device_sync`` waits for a tensor's card.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from pathlib import Path

import torch
from torch._C._autograd import _profiler_enabled


class _Recorder:
    """Totals of the spans and counters recorded under a profiler."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans = {}      # name -> [count, host ns, self host ns]
            self.device = {}     # name -> [device s folded, [(start, end) events]]
            self.counters = {}

    def stack(self) -> list:
        """This thread's open recorded spans, innermost last."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, name: str, host_ns: int, self_ns: int, events) -> None:
        with self.lock:
            rec = self.spans.setdefault(name, [0, 0, 0])
            rec[0] += 1
            rec[1] += host_ns
            rec[2] += self_ns
            if events is not None:
                self.device.setdefault(name, [0.0, []])[1].append(events)

    def count(self, name: str, n) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def stats(self) -> dict:
        with self.lock:
            out = {}
            for name, (n, host_ns, self_ns) in self.spans.items():
                device_s = None
                if name in self.device:
                    dev = self.device[name]
                    for start, end in dev[1]:
                        end.synchronize()
                        dev[0] += start.elapsed_time(end) / 1e3
                    dev[1] = []
                    device_s = dev[0]
                out[name] = {"count": n, "host_s": host_ns / 1e9, "self_host_s": self_ns / 1e9,
                             "device_s": device_s}
            out.update(self.counters)
            return out


_RECORDER = _Recorder()


def _cuda_device(device):
    """The CUDA device a span's events go to, or None."""
    if device is False or device is None:
        return None
    if device is True:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_initialized() \
            else None
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    return device if device.type == "cuda" else None


class _Span:
    """One opening of a span (see the module docstring)."""

    __slots__ = ("name", "device", "recording", "rf", "events", "t0", "t1", "child_ns")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.recording = _profiler_enabled()
        self.child_ns = 0
        self.events = None
        dev = _cuda_device(self.device)
        if dev is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            self.events = (start, dev)
        if self.recording:
            _RECORDER.stack().append(self)
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.recording:
            self.rf.__exit__(*exc)
        if self.events is not None:
            start, dev = self.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            self.events = (start, end)
        if self.recording:
            stack = _RECORDER.stack()
            stack.pop()
            host_ns = self.t1 - self.t0
            if stack:
                stack[-1].child_ns += host_ns
            _RECORDER.add(self.name, host_ns, host_ns - self.child_ns, self.events)
        return False

    def ms(self) -> float:
        """This opening's milliseconds: between its CUDA events (waiting for
        the card) where it recorded them, else on the host clock."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            return start.elapsed_time(end)
        return (self.t1 - self.t0) / 1e6

    def __call__(self, fn):
        return _Closed(self.name, self.device is True)(fn)


class _Closed:
    """What ``span`` gives outside a profiler: nothing on entry and exit; as
    a decorator, a span opened afresh at each call."""

    __slots__ = ("name", "device")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, device=device):
                return fn(*args, **kwargs)

        return spanned


_CLOSED: dict = {}


def span(name: str, device=False, timed: bool = False):
    """A context manager (or decorator) naming a stage ``name``; records
    only under a profiler, or with ``timed`` (see the module docstring).
    ``device``: a tensor or device whose CUDA stream the span's events time,
    or True for the current CUDA device; ignored off a card."""
    if timed or _profiler_enabled():
        return _Span(name, device)
    closed = _CLOSED.get(name)
    if closed is None or closed.device is not (device is True):
        closed = _CLOSED[name] = _Closed(name, device is True)
    return closed


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``, under a profiler only."""
    if _profiler_enabled():
        _RECORDER.count(name, n)


def span_stats() -> dict:
    """``{span: {"count", "host_s", "self_host_s", "device_s"}}`` (device_s
    None for a span without device events) and ``{counter: value}``, as
    recorded since the last ``reset_spans``. Waits for the card where a
    span recorded device events."""
    return _RECORDER.stats()


def reset_spans() -> None:
    """Clear every span total and counter."""
    _RECORDER.reset()


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

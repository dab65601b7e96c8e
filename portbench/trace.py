"""The traced segment: ``torch.profiler`` over a few units, reduced in
memory to what the readers need (no trace file is written).

* device time and launches by kernel name (kernels, copies and fills);
* device time under each ``record_function`` span, by the kernels that the
  span's CPU events (and their children) launched;
* the device's busy time (the union of its operations' intervals) and the
  traced window's length on the host clock;
* the idle gaps between device operations, each named by what the host was
  doing in its middle.
"""

from __future__ import annotations

import bisect
import re
import sys
import time
import traceback
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "aip_tpu_torch" / "csrc"
UNIT_SPAN = "portbench.unit"
SHORT_GAP_US = 20


def port_kernel_names() -> tuple[str, ...]:
    """The names of the port's own CUDA kernels, read from its sources."""
    names = set()
    bounds = re.compile(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)")
    for src in sorted(CSRC.glob("*.cu")):
        text = bounds.sub(" ", src.read_text())
        names.update(re.findall(r"__global__[^;{(]*?\b(\w+)\s*\(", text, flags=re.S))
    return tuple(sorted(names))


def is_port_kernel(name: str, own: tuple[str, ...]) -> bool:
    """Whether a device operation's name is one of the port's kernels."""
    return any(re.search(rf"\b{k}\b", name) for k in own)


class TraceSummary:
    def __init__(self):
        self.units = 0
        self.failed = 0
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: dict[str, list] = {}     # name -> [seconds, launches]
        self.spans: dict[str, float] = {}      # span -> device seconds
        self.gaps: dict[str, list] = {}        # host op -> [seconds, count]

    def kernel_s(self, pattern: str) -> float | None:
        """Device seconds of the kernels whose name holds ``pattern``."""
        hits = [s for name, (s, _) in self.kernels.items() if pattern in name]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
                "idle_gaps": [[name[:160], s] for name, (s, _) in gaps]}


def traced(drv, n_units: int, sync, on_card: bool) -> TraceSummary:
    """Profile ``n_units`` units of ``drv`` after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    summary = TraceSummary()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_units):
            try:
                with record_function(UNIT_SPAN):
                    drv.unit()
                sync()
                summary.units += 1
            except Exception:
                traceback.print_exc(file=sys.stderr)
                summary.failed += 1
        summary.window_s = time.perf_counter() - t0
    if on_card:
        _reduce(prof.events(), summary)
    return summary


def _reduce(events, summary: TraceSummary) -> None:
    from torch.autograd import DeviceType

    device_ops, cpu_roots, host_ops = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name == UNIT_SPAN:
                continue
            if e.name.startswith(("gs.", "portbench.")):
                continue
            device_ops.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU:
            if e.cpu_parent is None:
                cpu_roots.append(e)
            host_ops.append(e)
    for start, end, name in device_ops:
        rec = summary.kernels.setdefault(name, [0.0, 0])
        rec[0] += (end - start) / 1e6
        rec[1] += 1

    # Busy time: the union of the device operations' intervals.
    device_ops.sort()
    merged = []
    for start, end, _ in device_ops:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    summary.busy_s = sum(end - start for start, end in merged) / 1e6

    # Device time by span: each CPU event under a span credits the kernels it
    # launched, once per event.
    credited = set()

    def walk(e, span):
        if e.name.startswith("gs.") or (e.name.startswith("portbench.") and e.name != UNIT_SPAN):
            span = e.name
        if span is not None and e.kernels and e.id not in credited:
            credited.add(e.id)
            for k in e.kernels:
                summary.spans[span] = summary.spans.get(span, 0.0) + k.duration / 1e6
        for c in e.cpu_children:
            walk(c, span)

    for e in cpu_roots:
        walk(e, None)

    # Idle gaps inside the unit spans, named by the innermost host op in
    # their middle (and the innermost span around it).
    units = sorted((e.time_range.start, e.time_range.end) for e in host_ops
                   if e.name == UNIT_SPAN)
    if not units or not merged:
        return
    host_ops.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host_ops]
    ends = [m[1] for m in merged]
    gaps = []
    for u0, u1 in units:
        i = bisect.bisect_left(ends, u0)
        cursor = u0
        while i < len(merged) and merged[i][0] < u1:
            if merged[i][0] > cursor:
                gaps.append((cursor, merged[i][0]))
            cursor = max(cursor, merged[i][1])
            i += 1
        if cursor < u1:
            gaps.append((cursor, u1))
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_US:
            rec = summary.gaps.setdefault(f"gaps under {SHORT_GAP_US} us", [0.0, 0])
            rec[0] += (g1 - g0) / 1e6
            rec[1] += 1
            continue
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, mid)
        inner, span = None, None
        for e in reversed(host_ops[max(0, j - 400):j]):
            if e.time_range.end >= mid and e.name != UNIT_SPAN:
                if e.name.startswith(("gs.", "portbench.")):
                    span = span or e.name
                elif inner is None:
                    inner = e.name
                if inner is not None and span is not None:
                    break
        name = "/".join(n for n in (span, inner) if n) or "host: no op"
        rec = summary.gaps.setdefault(name, [0.0, 0])
        rec[0] += (g1 - g0) / 1e6
        rec[1] += 1

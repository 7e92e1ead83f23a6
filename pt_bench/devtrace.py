"""The traced window's reduction: ``torch.profiler`` over the card (CUPTI)
→ the device's busy seconds, each kernel's launches and device seconds,
the launch count, and the breakdown the result line carries: the device
operations that took most time and the device's idle gaps by what the
host was doing meanwhile."""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch

TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced window's wall
    busy_s: float  # union of the device's operation intervals
    kernels: dict  # profiler kernel name → (launches, device seconds)
    launches: int  # device kernels run (copies and fills not counted)
    device_ops: list  # [[name, seconds]], most time first
    idle_gaps: list  # [[host op, idle seconds]], most idle first

    def kernel(self, parts) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose profiler name
        holds every string of ``parts``."""
        parts = (parts,) if isinstance(parts, str) else parts
        hits = [v for k, v in self.kernels.items() if all(p in k for p in parts)]
        return sum(n for n, _ in hits), sum(s for _, s in hits)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "[memory]"))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(cpu, starts, t: float) -> str:
    """The host's top-level op running at time ``t`` (the latest started
    one that has not ended), or Python between ops."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host outside any op (Python)"


def traced(fn, device) -> Trace:
    """Run ``fn`` once under the profiler, the card synchronised at both
    ends → its Trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    busy_iv = _merge((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(e - s for s, e in busy_iv) / 1e6
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CPU and e.cpu_parent is None)
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy_iv, busy_iv[1:]):
        idle[_label(cpu, starts, 0.5 * (e0 + s1))] += (s1 - e0) / 1e6
    ops = sorted(((k[:NAME_CHARS], v[1]) for k, v in kernels.items()), key=lambda x: -x[1])
    gaps = sorted(idle.items(), key=lambda x: -x[1])
    return Trace(window, busy, {k: tuple(v) for k, v in kernels.items()},
                 sum(v[0] for k, v in kernels.items() if not _is_copy(k)),
                 [[k, s] for k, s in ops[:TOP]], [[k[:NAME_CHARS], s] for k, s in gaps[:TOP]])

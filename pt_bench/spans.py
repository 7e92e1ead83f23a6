"""Where the card's idle seconds go, by the port's own spans.

The port opens a ``torch.profiler.record_function`` range at each stage of
its host loop while ``cuda_optix_pathtracing_tpu_torch.utils.trace``
records (``pt.batch``, ``pt.pass``, ``pt.camera``, ``pt.bounce``, ...;
``:replay`` when autograd's backward pass recomputes them), and counts the
rays it hands to the intersection queries. The span window is a run of
its own: the cell's ``trace_units`` units under the profiler with the
port recording, apart from the traced window whose top-level host ops
label the ``breakdown``, which spans would relabel. It runs in a child
process (``python3 -m pt_bench.spans --workload NAME --seed N``) started
by the first of the span readers in ``metrics/`` during a ``--trace 1``
run of ``run.py``, so the parent's device memory, its peak and every
number it read before are left as they were; the child's result is kept
for the other readers. Against a port without ``utils/trace.py``, or with
no CUDA device, the readers find nothing and start nothing; a child that
fails, or prints no result, fails the run.

``attribute`` reduces the window's profiler events. Each idle gap of the
card (between the union of its operations, and from the window's edges to
them) goes to one label: the innermost ``pt.*`` span open at the gap's
midpoint on the thread that launched the kernel ending the gap; else, if
that thread is inside an autograd engine node, the span of the node's
forward op (same sequence number, on the forward thread) with ``[bwd]``,
or ``backward`` where none matches; else ``outside`` (the caller's own
code: the benchmark's loop and syncs, Adam). Every kernel is counted
under the label of its launch in the same way. The gap after the last
device operation is ``outside``.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import time
from collections import Counter, defaultdict

import torch

NODE = "autograd::engine::evaluate_function: "
WINDOW = "pt_bench.spans.window"
SPAN = "pt."
REPLAY = ":replay"
BWD = "[bwd]"
OUTSIDE = "outside"
BACKWARD = "backward"
UNRESOLVED = "unresolved"  # a device operation whose launching thread was not found
SEP = ">"
CHILD_TIMEOUT_S = 900


@dataclasses.dataclass(frozen=True)
class Event:
    """One record of the window. Times in ns on the profiler's clock."""

    kind: str  # "span", "node" (autograd engine), "op" (forward, sequence-numbered),
    # "kernel", "copy" (device copy or fill) or "window"
    name: str
    thread: int | None  # host thread; a device operation's: the launching thread
    start: int
    end: int
    seq: int = -1  # op, node: autograd sequence number
    fwd_thread: int = 0  # node: the thread its forward op ran on
    launch: int = 0  # device operation: when the host launched it


class _Nesting:
    """Intervals of one thread, nested as a call stack: at any time, the
    names (or events) open, outermost first."""

    def __init__(self, events, key=lambda e: e.name):
        self.times, self.paths = [], []
        stack = []  # (end, path)

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                self.times.append(end)
                self.paths.append(stack[-1][1] if stack else ())

        for e in sorted(events, key=lambda e: (e.start, -e.end)):
            close_until(e.start)
            path = (stack[-1][1] if stack else ()) + (key(e),)
            stack.append((e.end, path))
            self.times.append(e.start)
            self.paths.append(path)
        close_until(float("inf"))

    def at(self, t) -> tuple:
        i = bisect.bisect_right(self.times, t) - 1
        return self.paths[i] if i >= 0 else ()


def is_backward(path: tuple) -> bool:
    return path == (BACKWARD,) or path[-1].endswith(BWD) or any(
        p.endswith(REPLAY) for p in path)


def under(name: str):
    """Labels inside the forward span ``name``, its children included."""
    return lambda path: name in path and not is_backward(path)


def leaf(name: str):
    return lambda path: path[-1] == name


@dataclasses.dataclass
class Attribution:
    window_s: float  # the window on the profiler's clock
    busy_s: float  # union of the device's operations inside it
    idle: dict  # label path (tuple of names) → idle seconds
    kernels: dict  # label path → kernels launched (copies and fills not counted)
    spans: set  # span names opened in the window

    def idle_s(self) -> float:
        return sum(self.idle.values())

    def share(self, pred) -> float:
        """% of the window's idle seconds under the labels ``pred`` takes."""
        total = self.idle_s()
        return 100.0 * sum(v for p, v in self.idle.items() if pred(p)) / total if total else 0.0

    def launches(self, pred) -> int:
        return sum(n for p, n in self.kernels.items() if pred(p))

    def to_json(self) -> dict:
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "idle": {SEP.join(p): v for p, v in self.idle.items()},
                "kernels": {SEP.join(p): n for p, n in self.kernels.items()},
                "spans": sorted(self.spans)}

    @classmethod
    def from_json(cls, d: dict) -> Attribution:
        split = lambda k: tuple(k.split(SEP))  # noqa: E731
        return cls(d["window_s"], d["busy_s"], {split(k): v for k, v in d["idle"].items()},
                   {split(k): v for k, v in d["kernels"].items()}, set(d["spans"]))

    def table(self) -> str:
        """Idle seconds and kernels by label (the innermost name), most
        idle first."""
        idle, kern = defaultdict(float), defaultdict(int)
        for p, v in self.idle.items():
            idle[p[-1]] += v
        for p, n in self.kernels.items():
            kern[p[-1]] += n
        total = self.idle_s()
        rows = [f"{'label':<24} {'idle s':>10} {'idle %':>8} {'kernels':>8}"]
        for name in sorted(set(idle) | set(kern), key=lambda k: (-idle[k], k)):
            share = 100.0 * idle[name] / total if total else 0.0
            rows.append(f"{name:<24} {idle[name]:>10.6f} {share:>8.3f} {kern[name]:>8d}")
        rows.append(f"{'(sum)':<24} {total:>10.6f} {100.0 if total else 0.0:>8.3f} "
                    f"{sum(kern.values()):>8d}")
        return "\n".join(rows)


def attribute(events) -> Attribution:
    """Idle gaps and kernels of the window's events by label (module
    docstring)."""
    by_thread = defaultdict(list)
    nodes_by_thread = defaultdict(list)
    ops, device, window = {}, [], None
    for e in events:
        if e.kind == "span":
            by_thread[e.thread].append(e)
        elif e.kind == "node":
            nodes_by_thread[e.thread].append(e)
        elif e.kind == "op":
            ops[(e.thread, e.seq)] = e.start
        elif e.kind in ("kernel", "copy"):
            device.append(e)
        elif e.kind == "window":
            window = e
    spans = {t: _Nesting(evs) for t, evs in by_thread.items()}
    nodes = {t: _Nesting(evs, key=lambda e: e) for t, evs in nodes_by_thread.items()}
    none = _Nesting(())

    def label(thread, t) -> tuple:
        if thread is None:
            return (UNRESOLVED,)
        path = spans.get(thread, none).at(t)
        if path:
            return path
        open_nodes = nodes.get(thread, none).at(t)
        if not open_nodes:
            return (OUTSIDE,)
        node = open_nodes[-1]
        t_op = ops.get((node.fwd_thread, node.seq))
        fwd = () if t_op is None else spans.get(node.fwd_thread, none).at(t_op)
        return fwd[:-1] + (fwd[-1] + BWD,) if fwd else (BACKWARD,)

    device.sort(key=lambda e: (e.start, e.end))
    w0 = window.start if window else (device[0].start if device else 0)
    w1 = window.end if window else (max(e.end for e in device) if device else 0)
    idle, kernels = defaultdict(float), defaultdict(int)
    busy, reach = 0, w0  # reach: the latest end of the union so far
    for e in device:
        if e.end <= w0 or e.start >= w1:
            continue
        s, t = max(e.start, w0), min(e.end, w1)
        if s > reach:  # the card idled from reach until e started: e ends the gap
            idle[label(e.thread, 0.5 * (reach + s))] += (s - reach) / 1e9
        busy += max(0, t - max(s, reach))
        reach = max(reach, t)
        if e.kind == "kernel":
            kernels[label(e.thread, e.launch)] += 1
    if w1 > reach:
        idle[(OUTSIDE,)] += (w1 - reach) / 1e9
    names = {e.name for evs in by_thread.values() for e in evs}
    return Attribution((w1 - w0) / 1e9, busy / 1e9, dict(idle), dict(kernels), names)


RUNTIME = re.compile(r"cu(da)?[A-Z]")  # CUDA runtime and driver calls


def from_kineto(raw) -> list:
    """The window's Events from ``prof.profiler.kineto_results.events()``
    (read raw: the profiler's own event list is never built). A device
    operation's thread is that of the host op or span its launch is linked
    to (kineto's ``linked_correlation_id``), in the profiler's own thread
    ids, which spans, ops and autograd nodes share; its launch time is the
    runtime call's with the same correlation id. The device timeline's
    copies of ``record_function`` ranges are not operations."""
    from torch.autograd import DeviceType

    raw = list(raw)
    ranges = {e.name() for e in raw if e.device_type() == DeviceType.CPU and e.is_user_annotation()}
    front, runtime, device, out = {}, {}, [], []
    for e in raw:
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if not (e.is_user_annotation() or name in ranges):
                device.append(e)
            continue
        if e.linked_correlation_id() > 0 or (not e.is_user_annotation() and RUNTIME.match(name)):
            runtime[e.correlation_id()] = (e.start_ns(), e.linked_correlation_id(),
                                           e.start_thread_id())
            continue
        thread = e.start_thread_id()
        front[e.correlation_id()] = thread
        ev = dict(name=name, thread=thread, start=e.start_ns(), end=e.end_ns())
        if name == WINDOW:
            out.append(Event("window", **ev))
        elif name.startswith(SPAN) and e.is_user_annotation():
            out.append(Event("span", **ev))
        elif name.startswith(NODE):
            out.append(Event("node", seq=e.sequence_nr(), fwd_thread=e.fwd_thread_id(), **ev))
        elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0 and not e.is_user_annotation():
            out.append(Event("op", seq=e.sequence_nr(), **ev))
    system = {tid: front[linked] for _, linked, tid in runtime.values() if linked in front}
    for e in device:
        start, linked, tid = runtime.get(e.correlation_id(), (e.start_ns(), 0, None))
        thread = front.get(e.linked_correlation_id() or linked, system.get(tid))
        copy = e.name().startswith(("Memcpy", "Memset"))
        out.append(Event("copy" if copy else "kernel", e.name(), thread, e.start_ns(),
                         e.end_ns(), launch=start))
    return out


def profiled(fn, device) -> list:
    """Run ``fn`` once under the profiler inside the window's range, the
    card synchronised at both ends → its Events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    return from_kineto(prof.profiler.kineto_results.events())


def measure(name: str, seed: int, device="cuda", root=None) -> dict:
    """Set-up as a run of the cell does it, one unit to start the
    recording path, then the span window of ``trace_units`` units →
    {units, spp, attribution, counters}. ``root``: the checkout whose
    ``BENCHMARK.json`` holds the cell (default: this one)."""
    from cuda_optix_pathtracing_tpu_torch.utils import trace

    from . import harness

    t_start = time.perf_counter()
    cell = harness.load_cell(name, root or harness.ROOT)
    port = harness.Port()
    if torch.device(device).type == "cuda":
        port.load_kernels()
    spec, builder = harness.scene_spec(cell)
    scene = port.scene_from_host(builder.to_host_scene(spec, port.HostScene), device=device)
    traffic = harness.TRAFFIC[cell.mix["kind"]](port, scene, cell, seed, device)
    traffic.warm()
    n = cell.mix["trace_units"]
    keep_none = lambda k, t: False  # noqa: E731
    t0 = time.perf_counter()
    with trace.recording():
        traffic.run(lambda k, now: k >= 1, keep_none)
        trace.reset()
        events = profiled(lambda: traffic.run(lambda k, now: k >= n, keep_none), device)
        counts = trace.snapshot()
    t1 = time.perf_counter()
    att = attribute(events)
    kinds = Counter(e.kind for e in events)
    print(f"pt_bench spans: {name} seed {seed}: set-up {t0 - t_start:.3f} s, window and "
          f"events {t1 - t0:.3f} s, reduction {time.perf_counter() - t1:.3f} s; "
          f"{dict(kinds)}; window {att.window_s:.6f} s, busy {att.busy_s:.6f} s, idle "
          f"{att.window_s - att.busy_s:.6f} s, attributed {att.idle_s():.6f} s\n{att.table()}",
          file=sys.stderr)
    return {"units": n, "spp": traffic.unit_spp, "attribution": att.to_json(),
            "counters": {k: v for k, v in counts.items() if not k.startswith("launches.")}}


@dataclasses.dataclass
class Window:
    units: int
    spp: int
    attribution: Attribution
    counters: dict


_RESULTS: dict = {}


def _run_args():
    """(workload, seed) of the ``run.py --trace 1`` this process runs, or
    None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None or args.trace != 1:
        return None
    return args.workload, args.seed


def window() -> Window | None:
    """The span window of this run's cell and seed, measured once in a
    child process; None where there is nothing to read (not a traced run,
    no card, no port spans). Raises where the child fails or prints no
    result, so a broken window fails the traced run."""
    from . import harness

    key = _run_args()
    if key is None or not torch.cuda.is_available():
        return None
    if importlib.util.find_spec("cuda_optix_pathtracing_tpu_torch.utils.trace") is None:
        return None
    if key not in _RESULTS:
        cmd = [sys.executable, "-m", "pt_bench.spans", "--workload", key[0], "--seed",
               str(key[1])]
        proc = subprocess.run(cmd, cwd=harness.ROOT, stdout=subprocess.PIPE, text=True,
                              timeout=CHILD_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"the span window failed: {' '.join(cmd)} exited "
                               f"{proc.returncode} with {len(lines)} lines on stdout")
        d = json.loads(lines[-1])
        _RESULTS[key] = Window(d["units"], d["spp"], Attribution.from_json(d["attribution"]),
                               d["counters"])
    return _RESULTS[key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The span window of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        result = measure(args.workload, args.seed)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Spans and counters inside the port, behind one switch.

``recording()`` turns recording on for the whole process (not per thread:
autograd runs the backward pass on a worker thread of its own). Nothing
reads an environment variable or a flag of the CLI.

- **Spans**: ``span(name)`` opens a ``torch.profiler.record_function``
  range while recording, so a profiler session keeps it in memory on the
  same clock and timeline as the device kernels' records. While recording
  is off it returns one shared no-op context: no ``record_function``
  call, no ATen op, no device work, no allocation. A span opened while
  autograd runs a backward pass (the path replay's recomputed bounces)
  gets the suffix ``:replay``.
- **Counters**: one registry of named counts. ``count`` adds a Python
  int and is always on (the kernel wrappers' ``launches.<wrapper>``, the
  rays handed to the intersection queries, ``rays.query``, the rows
  handed to the texture fetches, ``tex.query``, the rows handed to a
  light-tree descent or pmf replay, ``lighttree.query``, and the RNG keys the
  fused kernels could not read in place, ``fused.key_copies``). ``count_device`` adds
  the elements of a device tensor that are nonzero into one device
  accumulator per name, only while recording (``rays.live``, ``tex.live``,
  ``lighttree.live``);
  nothing is read back until ``snapshot()``, so no count synchronises the
  device on the hot path. ``is_recording()`` guards the work of building
  such a tensor.

The port's spans: ``pt.batch`` > ``pt.pass`` > ``pt.camera``, ``pt.fused``
or ``pt.trace`` > ``pt.bounce`` > ``pt.closest``, ``pt.shade`` (>
``pt.texture`` in textured scenes; ``pt.lighttree``, the pmf replay of an
emitter hit, in light-tree scenes), ``pt.nee`` > ``pt.shadow`` (and
``pt.lighttree``, each descent, in light-tree scenes), ``pt.bsdf``;
``pt.raysort`` under the queries; ``pt.film``; ``pt.loss`` > ``pt.inject``
in a gradient step.

A recipe that records a render's spans and kernels into one chrome trace
is in the README.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

_recording = False
_NULL = contextlib.nullcontext()
_host: Counter = Counter()
_device: dict = {}


@contextlib.contextmanager
def recording():
    """Record spans and device counters inside the block."""
    global _recording
    was, _recording = _recording, True
    try:
        yield
    finally:
        _recording = was


def span(name: str, **args):
    """A named range of the profiler's timeline while recording (keyword
    arguments are shown with it), the shared no-op context otherwise."""
    if not _recording:
        return _NULL
    if torch._C._current_graph_task_id() != -1:
        name += ":replay"
    detail = ",".join(f"{k}={v}" for k, v in args.items()) or None
    return torch.profiler.record_function(name, detail)


def is_recording() -> bool:
    """Is recording on?"""
    return _recording


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _host[name] += n


def count_device(name: str, x: torch.Tensor) -> None:
    """While recording, add the number of nonzero elements of ``x`` to the
    device counter ``name`` (on ``x``'s device, read by ``snapshot``)."""
    if not _recording:
        return
    n = torch.count_nonzero(x)
    acc = _device.get(name)
    if acc is None:
        _device[name] = n
    else:
        acc.add_(n)


def snapshot() -> Counter:
    """Every counter's value; a name never counted reads 0. Reads the
    device counters (one synchronising read each)."""
    out = Counter(_host)
    out.update({k: int(v) for k, v in _device.items()})
    return out


def reset() -> None:
    """Set every counter to 0."""
    _host.clear()
    _device.clear()

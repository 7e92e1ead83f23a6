"""Faults planted under the timed path, for the readings on the chip
(``control.py --fault``) and the CPU tests: the comparison has to read
each of them as not correct.

- ``unchanged_state``: a render batch returns the film it was given; a
  gradient step leaves the parameters as they were;
- ``half_batch``: half of each batch's samples left out, the other half
  standing in for them, so the batch's mean is the mean over the rest;
- ``altered_answer``: the radiance altered by 1 % where the renderer
  produces it.

No exchange between chips exists in a one-chip cell, so none is planted.
"""

from __future__ import annotations

import torch

ALTERED_BY = 1.01
NAMES = ("unchanged_state", "half_batch", "altered_answer")


def _renderers():
    from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    return MK, D


def _half(orig):
    def half(scene, cfg, width, height, sample, nspp=1):
        if nspp > 1:
            r = orig(scene, cfg, width, height, sample, nspp)
            return torch.cat([r[: nspp // 2]] * 2)
        return orig(scene, cfg, width, height, sample - sample % 2, 1)

    return half


def _altered(orig):
    def altered(*args, **kw):
        return orig(*args, **kw) * ALTERED_BY

    return altered


def _unchanged(traffic) -> None:
    if traffic.kind == "render":
        traffic.batch = lambda film: film
    else:
        traffic.opt.step = lambda: None


def plant(name: str):
    """Plant fault ``name`` → (a traffic hook for ``harness.run`` or None,
    the function that takes the fault out again)."""
    if name == "unchanged_state":
        return _unchanged, lambda: None
    MK, D = _renderers()
    orig = MK.render_sample_batch
    broken = {"half_batch": _half, "altered_answer": _altered}[name](orig)
    MK.render_sample_batch = D.render_sample_batch = broken

    def undo():
        MK.render_sample_batch = D.render_sample_batch = orig

    return None, undo

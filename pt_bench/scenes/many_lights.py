"""The many-lights Cornell box, kept by the benchmark: a frozen copy of the
port's ``scene/procedural.cornell_box_many_lights`` over the benchmark's
own Cornell box (``cornell.py``, loaded from its file beside this one), so
that a change to the program cannot change the scene it is measured on.

The box of ``cornell.py`` (its spheres at ``sphere_lat`` x ``sphere_lon``)
under an 8 x 8 array of emissive ceiling quads:

- each quad 0.2 on a side, facing -z at z 1.99, the array 0.5 apart
  across the box (x from -1.75) and 0.25 deep (y from 0.15): over the
  front half of the box, out of the camera's view;
- each quad a material of its own: black Lambert (``mtype`` 3, albedo 0)
  emitting 4 x 10^u x (1, 0.93, 0.8), u uniform in [-1.5, 0.5) drawn from
  ``numpy.random.default_rng(0)`` quad by quad, x-major;
- with the spot, 129 finite light records (the spot and 128 emissive
  triangles), so the port builds a light tree over them.

``build(cfg)`` gives ``cornell.SceneSpec``; ``to_host_scene`` is
``cornell.py``'s. It imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np

LAMBERT = 3
GRID = 8  # quads along each side of the array
QUAD = 0.2  # side of a quad
CEILING_Z = 1.99
RNG_SEED = 0


def _cornell():
    name = "pt_bench_scene_cornell_for_many_lights"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name("cornell.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def build(cfg: dict):
    """The Cornell box of ``cornell.build(cfg)`` with the quad array and
    its materials appended after the box's own triangles and materials."""
    C = _cornell()
    box = C.build(cfg)
    rng = np.random.default_rng(RNG_SEED)
    tris, mats, materials = [box.tris], [box.tri_mat], list(box.materials)
    for i in range(GRID):
        for j in range(GRID):
            r = 4.0 * 10.0 ** rng.uniform(-1.5, 0.5)
            materials.append(dict(mtype=LAMBERT, albedo=np.zeros(3, np.float32),
                                  emission=np.asarray((r, 0.93 * r, 0.8 * r), np.float32)))
            quad = C.plane((-1.75 + 0.5 * i, 0.15 + 0.25 * j, CEILING_Z), (0, 0, -1), QUAD, QUAD)
            tris.append(np.stack(quad).astype(np.float32))
            mats.append(np.full(len(quad), len(materials) - 1, np.int32))
    return dataclasses.replace(box, tris=np.concatenate(tris), tri_mat=np.concatenate(mats),
                               materials=tuple(materials))


def to_host_scene(spec, HostScene):
    """The spec as the port's ``HostScene`` (``cornell.to_host_scene``)."""
    return _cornell().to_host_scene(spec, HostScene)

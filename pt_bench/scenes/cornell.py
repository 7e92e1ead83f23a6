"""The Cornell box of the upstream DumbTracer (``host_utils.cu:402-457``),
kept by the benchmark: a frozen copy of the port's
``scene/procedural.cornell_host``, so that a change to the program cannot
change the scene it is measured on.

``build(cfg)`` gives a ``SceneSpec``: plain numpy triangles, material and
light rows in the port's ``HostScene`` dict format, the environment colour
and the camera. The same spec goes to the port (``to_host_scene``) and to
the plain reference (``pt_bench/reference``).

- left ball: Oren-Nayar (1, .7, .3), sigma .7
- right ball: GGX dielectric, tints (.02, .07, .01) / (.95, .95, .87),
  phi0 1, eta 1.44, alpha (.5, .7)
- walls: Oren-Nayar; white back and ceiling, orange floor, red left,
  green right
- spot light 2 (1, 1, 1) at (0, 1.8, 1.7) aimed at -z, cone cos(pi/6) to
  cos(pi/3), radius 0.01; constant environment 0.1
- camera at the origin looking along +y, 20 mm lens on a 36 mm sensor
"""

from __future__ import annotations

import dataclasses

import numpy as np

OREN_NAYAR = 0
GGX_DIELECTRIC = 1
SPOT = 1


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    tris: np.ndarray  # (T, 3, 3) float32 corners
    tri_mat: np.ndarray  # (T,) int32 material ids
    materials: tuple  # HostScene material dicts
    lights: tuple  # HostScene light dicts
    env_color: tuple
    camera: dict  # position, direction, width, height, focal_length_mm, sensor_height_mm


def _stable_tangent(normal):
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    an = np.abs(n)
    if an[0] <= an[1] and an[0] <= an[2]:
        major = np.array([1.0, 0.0, 0.0])
    elif an[1] <= an[0] and an[1] <= an[2]:
        major = np.array([0.0, 1.0, 0.0])
    else:
        major = np.array([0.0, 0.0, 1.0])
    t = np.cross(major, n)
    t = t / np.linalg.norm(t)
    return n, t, np.cross(n, t)


def sphere(center, radius, lat: int, lon: int):
    """UV sphere: top and bottom caps and quad bands."""
    c = np.asarray(center, np.float64)
    tris = []
    top = c + [0, radius, 0]
    bottom = c + [0, -radius, 0]
    for i in range(lat):
        th0 = np.pi * i / lat
        th1 = np.pi * (i + 1) / lat
        y0, y1 = radius * np.cos(th0), radius * np.cos(th1)
        r0, r1 = radius * np.sin(th0), radius * np.sin(th1)
        for j in range(lon):
            ph0 = 2 * np.pi * j / lon
            ph1 = 2 * np.pi * ((j + 1) % lon) / lon
            p00 = c + [r0 * np.cos(ph0), y0, r0 * np.sin(ph0)]
            p01 = c + [r0 * np.cos(ph1), y0, r0 * np.sin(ph1)]
            p10 = c + [r1 * np.cos(ph0), y1, r1 * np.sin(ph0)]
            p11 = c + [r1 * np.cos(ph1), y1, r1 * np.sin(ph1)]
            if i == 0:
                tris.append([top, p10, p11])
            elif i == lat - 1:
                tris.append([p00, bottom, p01])
            else:
                tris.append([p00, p10, p01])
                tris.append([p01, p10, p11])
    return [np.asarray(t, np.float32) for t in tris]


def plane(center, normal, width, height):
    """Oriented quad as two counter-clockwise triangles."""
    c = np.asarray(center, np.float64)
    _, t, b = _stable_tangent(normal)
    t = t * width * 0.5
    b = b * height * 0.5
    p0, p1, p2, p3 = c - t - b, c + t - b, c + t + b, c - t + b
    return [np.asarray([p0, p2, p1], np.float32), np.asarray([p0, p3, p2], np.float32)]


def oren_nayar(color, sigma):
    return dict(mtype=OREN_NAYAR, albedo=np.asarray(color, np.float32), on_sigma=float(sigma))


def build(cfg: dict) -> SceneSpec:
    """The Cornell box at ``cfg``'s image size, its spheres at
    ``sphere_lat`` x ``sphere_lon`` subdivisions."""
    lat, lon = cfg["sphere_lat"], cfg["sphere_lon"]
    white = (0.9, 170.0 / 204.0, 160.0 / 204.0)
    models = [
        (sphere((-1.2, 2.0, -0.25), 0.5, lat, lon), oren_nayar((1.0, 0.7, 0.3), 0.7)),
        (sphere((1.2, 2.4, -0.25), 0.5, lat, lon),
         dict(mtype=GGX_DIELECTRIC, refl_tint=np.asarray((0.02, 0.07, 0.01), np.float32),
              trans_tint=np.asarray((0.95, 0.95, 0.87), np.float32),
              phi0=1.0, eta=1.44, alphax=0.5, alphay=0.7)),
        (plane((0, 4, 0), (0, -1, 0), 4, 4), oren_nayar(white, 0.5)),
        (plane((0, 2, -0.5), (0, 0, 1), 4, 4), oren_nayar((1.0, 0.7, 0.3), 0.7)),
        (plane((0, 2, 2), (0, 0, -1), 4, 4), oren_nayar(white, 0.5)),
        (plane((-2, 2, 0), (1, 0, 0), 4, 4), oren_nayar((1.0, 0.01, 0.01), 0.6)),
        (plane((2, 2, 0), (-1, 0, 0), 4, 4), oren_nayar((0.01, 1.0, 0.01), 0.6)),
    ]
    tris = np.stack([t for tri_list, _ in models for t in tri_list]).astype(np.float32)
    tri_mat = np.concatenate([np.full(len(tl), i, np.int32) for i, (tl, _) in enumerate(models)])
    d = np.asarray((0.0, 0.0, -1.0), np.float64)
    spot = dict(ltype=SPOT, color=(2.0, 2.0, 2.0), pos=(0.0, 1.8, 1.7),
                direction=(d / np.linalg.norm(d)).astype(np.float32),
                cos_theta0=float(np.cos(np.pi / 6)), cos_theta_e=float(np.cos(np.pi / 3)),
                radius=0.01)
    camera = dict(position=(0.0, 0.0, 0.0), direction=(0.0, 1.0, 0.0),
                  width=cfg["width"], height=cfg["height"],
                  focal_length_mm=20.0, sensor_height_mm=36.0)
    return SceneSpec(tris, tri_mat, tuple(m for _, m in models), (spot,), (0.1, 0.1, 0.1),
                     camera)


def to_host_scene(spec: SceneSpec, HostScene):
    """The spec as the port's ``HostScene`` (the class is passed in, so
    this module imports nothing of the port)."""
    hs = HostScene()
    for mat in spec.materials:
        hs.add_material(dict(mat))
    hs.add_model(list(spec.tris), 0)
    hs.tri_mat = [int(m) for m in spec.tri_mat]
    for light in spec.lights:
        hs.add_light(dict(light))
    hs.env_color = spec.env_color
    hs.camera = dataclasses.replace(hs.camera, **spec.camera)
    return hs

"""Procedural geometry and the Cornell-box scene (counterpart of the
reference ``scene/procedural.py``): the same geometry, materials, spot
light, constant 0.1 environment and camera, built with numpy."""

from __future__ import annotations

import numpy as np

from ..ops import bsdf as B
from ..ops import lights as L
from ..ops.camera import CameraConfig
from .types import HostScene, Scene, scene_from_host


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
    b = np.cross(n, t)
    return n, t, b


def generate_sphere(center, radius, lat_subdiv: int, lon_subdiv: int):
    """UV sphere: top/bottom caps + quad bands."""
    c = np.asarray(center, np.float64)
    tris = []
    top = c + [0, radius, 0]
    bottom = c + [0, -radius, 0]
    for i in range(lat_subdiv):
        th0 = np.pi * i / lat_subdiv
        th1 = np.pi * (i + 1) / lat_subdiv
        y0, y1 = radius * np.cos(th0), radius * np.cos(th1)
        r0, r1 = radius * np.sin(th0), radius * np.sin(th1)
        for j in range(lon_subdiv):
            ph0 = 2 * np.pi * j / lon_subdiv
            ph1 = 2 * np.pi * ((j + 1) % lon_subdiv) / lon_subdiv
            p00 = c + [r0 * np.cos(ph0), y0, r0 * np.sin(ph0)]
            p01 = c + [r0 * np.cos(ph1), y0, r0 * np.sin(ph1)]
            p10 = c + [r1 * np.cos(ph0), y1, r1 * np.sin(ph0)]
            p11 = c + [r1 * np.cos(ph1), y1, r1 * np.sin(ph1)]
            if i == 0:
                tris.append([top, p10, p11])
            elif i == lat_subdiv - 1:
                tris.append([p00, bottom, p01])
            else:
                tris.append([p00, p10, p01])
                tris.append([p01, p10, p11])
    return [np.asarray(t, np.float32) for t in tris]


def generate_cube(center, scale):
    """Axis-aligned cube, 12 triangles."""
    c = np.asarray(center, np.float64)
    s = np.asarray(scale, np.float64)
    corners = []
    for i in range(8):
        off = np.array(
            [
                (0.5 if i & 1 else -0.5) * s[0],
                (0.5 if i & 2 else -0.5) * s[1],
                (0.5 if i & 4 else -0.5) * s[2],
            ]
        )
        corners.append(c + off)
    faces = [
        (0, 1, 3, 2),
        (4, 5, 7, 6),
        (0, 1, 5, 4),
        (2, 3, 7, 6),
        (0, 2, 6, 4),
        (1, 3, 7, 5),
    ]
    tris = []
    for f in faces:
        a, b, cc, d = (corners[k] for k in f)
        tris.append(np.asarray([a, b, cc], np.float32))
        tris.append(np.asarray([a, cc, d], np.float32))
    return tris


def generate_plane(center, normal, width, height):
    """Oriented quad split into 2 CCW triangles."""
    c = np.asarray(center, np.float64)
    _, t, b = _stable_tangent(normal)
    t = t * width * 0.5
    b = b * height * 0.5
    p0, p1, p2, p3 = c - t - b, c + t - b, c + t + b, c - t + b
    return [
        np.asarray([p0, p2, p1], np.float32),
        np.asarray([p0, p3, p2], np.float32),
    ]


def cornell_host(width: int, height: int, lat: int, lon: int) -> HostScene:
    """The Cornell box's HostScene, with spheres of ``lat`` × ``lon``
    subdivisions."""
    white = (0.9, 170.0 / 204.0, 160.0 / 204.0)
    hs = HostScene()
    hs.add_model(generate_sphere((-1.2, 2.0, -0.25), 0.5, lat, lon), 0)
    hs.add_material(B.oren_nayar((1.0, 0.7, 0.3), 0.7))
    hs.add_model(generate_sphere((1.2, 2.4, -0.25), 0.5, lat, lon), 1)
    hs.add_material(
        B.ggx_dielectric((0.02, 0.07, 0.01), (0.95, 0.95, 0.87), 1.0, 1.44, 0.5, 0.7)
    )
    hs.add_model(generate_plane((0, 4, 0), (0, -1, 0), 4, 4), 2)
    hs.add_material(B.oren_nayar(white, 0.5))
    hs.add_model(generate_plane((0, 2, -0.5), (0, 0, 1), 4, 4), 3)
    hs.add_material(B.oren_nayar((1.0, 0.7, 0.3), 0.7))
    hs.add_model(generate_plane((0, 2, 2), (0, 0, -1), 4, 4), 4)
    hs.add_material(B.oren_nayar(white, 0.5))
    hs.add_model(generate_plane((-2, 2, 0), (1, 0, 0), 4, 4), 5)
    hs.add_material(B.oren_nayar((1.0, 0.01, 0.01), 0.6))
    hs.add_model(generate_plane((2, 2, 0), (-1, 0, 0), 4, 4), 6)
    hs.add_material(B.oren_nayar((0.01, 1.0, 0.01), 0.6))

    hs.add_light(
        L.spot_light(
            (2.0, 2.0, 2.0),
            (0.0, 1.8, 1.7),
            (0.0, 0.0, -1.0),
            float(np.cos(np.pi / 6)),
            float(np.cos(np.pi / 3)),
            0.01,
        )
    )
    hs.env_color = (0.1, 0.1, 0.1)
    hs.camera = CameraConfig(
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 1.0, 0.0),
        width=width,
        height=height,
    )
    return hs


def cornell_box(width: int = 256, height: int = 256, device="cuda") -> Scene:
    """The reference renderer's measured scene: 26 triangles.

    - left ball: Oren-Nayar (1, .7, .3) σ=.7
    - right ball: GGX dielectric, tints (.02,.07,.01)/(.95,.95,.87),
      φ0=1, η=1.44, α=(.5,.7)
    - walls: Oren-Nayar — white back/ceiling, orange floor, red left,
      green right
    - spot light 2·(1,1,1) at (0,1.8,1.7) aimed -z, cone cos(π/6)…cos(π/3),
      radius 0.01; constant environment 0.1
    - camera at origin looking +y, 20mm/36mm
    """
    return scene_from_host(cornell_host(width, height, 2, 4), device=device)


def cornell_box_mesh(
    width: int = 256, height: int = 256, subdiv: int = 48, use_bvh=None, device="cuda"
) -> Scene:
    """Cornell box with finely tessellated spheres (about 2·subdiv² + 60
    triangles; 16,138 at subdiv 64): the BVH scene. Same materials,
    light and camera as ``cornell_box``."""
    return scene_from_host(
        cornell_host(width, height, subdiv, subdiv), use_bvh=use_bvh, device=device
    )


def cornell_box_mesh_instanced(
    width: int = 256, height: int = 256, subdiv: int = 48, use_bvh=None, device="cuda"
) -> Scene:
    """``cornell_box_mesh`` with each sphere an instance of its own
    origin-centred base mesh, placed by a translation; the walls bake (one
    identity instance). The same geometry and estimator as the baked
    scene, through per-mesh tables, world-box culling and sorted queries."""
    white = (0.9, 170.0 / 204.0, 160.0 / 204.0)
    hs = HostScene()
    hs.add_material(B.oren_nayar((1.0, 0.7, 0.3), 0.7))
    hs.add_material(
        B.ggx_dielectric((0.02, 0.07, 0.01), (0.95, 0.95, 0.87), 1.0, 1.44, 0.5, 0.7)
    )
    hs.add_model(generate_plane((0, 4, 0), (0, -1, 0), 4, 4), 2)
    hs.add_material(B.oren_nayar(white, 0.5))
    hs.add_model(generate_plane((0, 2, -0.5), (0, 0, 1), 4, 4), 3)
    hs.add_material(B.oren_nayar((1.0, 0.7, 0.3), 0.7))
    hs.add_model(generate_plane((0, 2, 2), (0, 0, -1), 4, 4), 4)
    hs.add_material(B.oren_nayar(white, 0.5))
    hs.add_model(generate_plane((-2, 2, 0), (1, 0, 0), 4, 4), 5)
    hs.add_material(B.oren_nayar((1.0, 0.01, 0.01), 0.6))
    hs.add_model(generate_plane((2, 2, 0), (-1, 0, 0), 4, 4), 6)
    hs.add_material(B.oren_nayar((0.01, 1.0, 0.01), 0.6))
    base = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.5, subdiv, subdiv))

    def at(p):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = p
        return m[None]

    hs.add_instance_group(base, 0, at((-1.2, 2.0, -0.25)))
    hs.add_instance_group(base, 1, at((1.2, 2.4, -0.25)))
    hs.add_light(
        L.spot_light(
            (2.0, 2.0, 2.0),
            (0.0, 1.8, 1.7),
            (0.0, 0.0, -1.0),
            float(np.cos(np.pi / 6)),
            float(np.cos(np.pi / 3)),
            0.01,
        )
    )
    hs.env_color = (0.1, 0.1, 0.1)
    hs.camera = CameraConfig(
        position=(0.0, 0.0, 0.0), direction=(0.0, 1.0, 0.0), width=width, height=height
    )
    return scene_from_host(hs, use_bvh=use_bvh, device=device)


def cornell_box_many_lights(
    width: int = 256, height: int = 256, subdiv: int = 64, use_bvh=None, device="cuda"
) -> Scene:
    """``cornell_box_mesh`` under an 8 × 8 array of emissive ceiling quads
    (0.2 on a side, 0.5 apart across the box and 0.25 deep), each of its
    own material with radiance 4 × 10^u, u uniform in [−1.5, 0.5) from a
    numpy seed (lights of unequal power): with the spot, 129 finite light
    records, so the scene gets a light tree. The array hangs over the
    front half of the box, outside the camera's view: seen directly, its
    edges would add anti-aliasing noise that no light selection changes."""
    hs = cornell_host(width, height, subdiv, subdiv)
    rng = np.random.default_rng(0)
    for i in range(8):
        for j in range(8):
            r = 4.0 * 10.0 ** rng.uniform(-1.5, 0.5)
            mat = hs.add_material(B.diffuse_light((r, 0.93 * r, 0.8 * r)))
            center = (-1.75 + 0.5 * i, 0.15 + 0.25 * j, 1.99)
            hs.add_model(generate_plane(center, (0, 0, -1), 0.2, 0.2), mat)
    return scene_from_host(hs, use_bvh=use_bvh, device=device)

"""Camera rays and brute-force ray-triangle intersection of the plain
reference: Moeller-Trumbore over every triangle, with the tolerances of
the path tracer (determinant 1e-7, t > 1e-4, barycentric slack 1e-7), the
first index winning a tie. Triangles are ``v0, e0 = p1 - p0, e1 = p2 -
p0``; the geometric normal is ``cross(e1, e0)`` normalised.

The sweeps can also count the work an any-hit query needs: the tests up
to each ray's first occluder in the triangles' order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .shading import cross, dot, normalize

MT_TOLERANCE = 1e-7
T_MIN = 1e-4
BIG_T = 3.0e38
CHUNK = 512  # triangles per step of a sweep (the result does not depend on it)


def camera_from_raster(focal_mm, sensor_h_mm, x_res, y_res) -> np.ndarray:
    """4x4 float32: raster (px, py, 0) → camera-space sensor point."""
    sensor_w_mm = sensor_h_mm * float(x_res) / float(y_res)
    mm = 1e-3
    f, sh, sw = focal_mm * mm, sensor_h_mm * mm, sensor_w_mm * mm
    px_x, px_y = sw / float(x_res), sh / float(y_res)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = px_x
    m[1, 1] = -px_y
    m[0, 3] = -0.5 * sw + 0.5 * px_x
    m[1, 3] = 0.5 * sh - 0.5 * px_y
    m[2, 3] = f
    return m


def world_from_camera(direction, position) -> np.ndarray:
    """4x4 float32 camera → world; world up is +z."""
    d = np.asarray(direction, dtype=np.float64)
    forward = d / np.linalg.norm(d)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = np.cross(right, forward)
    m[:3, 2] = forward
    m[:3, 3] = np.asarray(position, dtype=np.float64)
    return m


def _transform(m, p, point: bool):
    return torch.stack([m[i, 0] * p[..., 0] + m[i, 1] * p[..., 1] + m[i, 2] * p[..., 2]
                        + (m[i, 3] if point else 0.0) for i in range(3)], dim=-1)


def generate_rays(p_film, cam_from_raster, world_from_cam):
    """Rays through film points (N, 2) → (origins, unit directions)."""
    p_raster = torch.cat([p_film, torch.zeros_like(p_film[..., :1])], dim=-1)
    p_camera = _transform(cam_from_raster, p_raster, True)
    o = _transform(world_from_cam, torch.zeros_like(p_camera), True)
    return o, normalize(_transform(world_from_cam, p_camera, False))


def _candidates(o, d, v0, e0, e1):
    """(N, Tc) t of every (ray, triangle) pair, BIG_T where invalid."""
    ox, oy, oz = (o[:, None, i] for i in range(3))
    dx, dy, dz = (d[:, None, i] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e0x, e0y, e0z = (e0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    px = dy * e1z - dz * e1y
    py = dz * e1x - dx * e1z
    pz = dx * e1y - dy * e1x
    det = px * e0x + py * e0y + pz * e0z
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    qx = ty * e0z - tz * e0y
    qy = tz * e0x - tx * e0z
    qz = tx * e0y - ty * e0x
    parallel = torch.abs(det) < MT_TOLERANCE
    inv_det = 1.0 / torch.where(parallel, 1.0, det)
    u = inv_det * (px * tx + py * ty + pz * tz)
    v = inv_det * (qx * dx + qy * dy + qz * dz)
    t = inv_det * (qx * e1x + qy * e1y + qz * e1z)
    valid = ((~parallel) & (u >= -MT_TOLERANCE) & (v >= -MT_TOLERANCE)
             & (u + v <= 1.0 + MT_TOLERANCE) & (t > T_MIN))
    return torch.where(valid, t, BIG_T)


def closest_raw(o, d, v0, e0, e1):
    """(best t, best index): BIG_T and 0 on a miss."""
    best_t = torch.full((o.shape[0],), BIG_T, dtype=o.dtype, device=o.device)
    best_i = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    for base in range(0, v0.shape[0], CHUNK):
        t = _candidates(o, d, v0[base:base + CHUNK], e0[base:base + CHUNK], e1[base:base + CHUNK])
        i_l = torch.argmin(t, dim=1)
        t_b = torch.gather(t, 1, i_l[:, None])[:, 0]
        better = t_b < best_t
        best_t = torch.where(better, t_b, best_t)
        best_i = torch.where(better, base + i_l, best_i)
    return best_t, best_i


def occluded(o, d, v0, e0, e1, t_max, count=None):
    """True where a triangle lies at T_MIN < t < t_max. With ``count`` (a
    bool mask of the rays whose work is wanted) → also the number of tests
    those rays make up to their first occluder (all T where none)."""
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype, device=o.device),
                               (o.shape[0],))[:, None]
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    tests = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    for base in range(0, v0.shape[0], CHUNK):
        hit = _candidates(o, d, v0[base:base + CHUNK], e0[base:base + CHUNK],
                          e1[base:base + CHUNK]) < t_max
        if count is not None:
            first = torch.argmax(hit.to(torch.int32), dim=1) + 1
            tests += torch.where(occ, 0, torch.where(hit.any(1), first, hit.shape[1]))
        occ = occ | hit.any(1)
    if count is None:
        return occ
    return occ, int(tests[count].sum())


class Hit(NamedTuple):
    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor
    tri: torch.Tensor  # (N,) int64
    pos: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) geometric, against the ray
    error: torch.Tensor  # (N, 3) position error bound


_EPS32 = np.float32(5.960464477539063e-08)
_GAMMA7 = float(np.float32(7) * _EPS32 / (np.float32(1.0) - np.float32(7) * _EPS32))


def closest_hit(o, d, v0, e0, e1) -> Hit:
    """The closest hit with its barycentrics recomputed for the winning
    triangle, position, incident-facing normal and error bound."""
    best_t, best_i = closest_raw(o, d, v0, e0, e1)
    hv0, he0, he1 = v0[best_i], e0[best_i], e1[best_i]
    px = d[:, 1] * he1[:, 2] - d[:, 2] * he1[:, 1]
    py = d[:, 2] * he1[:, 0] - d[:, 0] * he1[:, 2]
    pz = d[:, 0] * he1[:, 1] - d[:, 1] * he1[:, 0]
    det = px * he0[:, 0] + py * he0[:, 1] + pz * he0[:, 2]
    inv_det = 1.0 / torch.where(torch.abs(det) < MT_TOLERANCE, 1.0, det)
    tx, ty, tz = o[:, 0] - hv0[:, 0], o[:, 1] - hv0[:, 1], o[:, 2] - hv0[:, 2]
    qx = ty * he0[:, 2] - tz * he0[:, 1]
    qy = tz * he0[:, 0] - tx * he0[:, 2]
    qz = tx * he0[:, 1] - ty * he0[:, 0]
    u = inv_det * (px * tx + py * ty + pz * tz)
    v = inv_det * (qx * d[:, 0] + qy * d[:, 1] + qz * d[:, 2])
    pos = hv0 + u[:, None] * he0 + v[:, None] * he1
    ng = normalize(cross(he1, he0))
    ng = torch.where((dot(d, ng) > 0.0)[:, None], -ng, ng)
    w = (1.0 - u - v)[..., None]
    p1, p2 = hv0 + he0, hv0 + he1
    err = _GAMMA7 * (torch.abs(u[..., None] * hv0) + torch.abs(v[..., None] * p1)
                     + torch.abs(w * p2))
    return Hit(best_t < BIG_T, best_t, best_i, pos, ng, err)

"""Ray-triangle intersection, plain PyTorch (counterpart of the reference
``ops/intersect.py``).

Möller–Trumbore with the reference's tolerances: determinant cutoff
1e-7, t > 1e-4, barycentric slack ±1e-7. ``intersect_closest_raw`` and
``intersect_any`` are the plain versions of the CUDA kernels in
``csrc/intersect.cu`` (``ops/intersect_cuda.py``): the closest hit keeps
the first index on a tie, returns ``BIG_T``/0 on a miss, and rays with
d = 0 never hit (det = 0 is "parallel").

Triangles are SoA ``v0, e0, e1`` (T, 3) with ``e0 = p1 - p0``,
``e1 = p2 - p0``; the geometric normal is ``cross(e1, e0)`` normalized.

``mt_cull`` is the plain version of the cull that the brute-force fused
kernel's sweeps and the any-hit kernel make before the division
(``csrc/common.cuh`` ``sweep_test``), and ``closest_split_ref`` the plain
model of the closest-hit kernel's split of a ray over several lanes; only
the tests use them, to hold them to the sweeps here: the cull never
rejects a pair they accept, and the split finds the same winner.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import cross, dot, error_from_triangle_intersection, normalize

MT_TOLERANCE = 1e-7
T_MIN = 1e-4
BIG_T = 3.0e38

# the brute-force sweeps' cull bounds (csrc/common.cuh CULL_*), float32
CULL_LO, CULL_HI, CULL_TMIN, CULL_TCAP = 2e-7, 1.000004, 0.99e-4, 1.000004


class ClosestHit(NamedTuple):
    """SoA hit record."""

    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) f32
    tri: torch.Tensor  # (N,) int64 index of the best triangle (0 if none)
    u: torch.Tensor  # (N,) barycentric
    v: torch.Tensor  # (N,) barycentric
    pos: torch.Tensor  # (N,3)
    normal: torch.Tensor  # (N,3) geometric normal, flipped against the ray
    error: torch.Tensor  # (N,3) intersection error bound
    front: torch.Tensor  # (N,) bool: hit the side cross(e0,e1) points to


def _mt_numerators(o, d, v0, e0, e1):
    """(N, Tc) Möller–Trumbore det and the numerators of u, v and t for
    every (ray, triangle) pair, each operation rounded to float32."""
    ox, oy, oz = (o[:, None, i] for i in range(3))
    dx, dy, dz = (d[:, None, i] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e0x, e0y, e0z = (e0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    px = dy * e1z - dz * e1y
    py = dz * e1x - dx * e1z
    pz = dx * e1y - dy * e1x
    det = px * e0x + py * e0y + pz * e0z
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    qx = ty * e0z - tz * e0y
    qy = tz * e0x - tx * e0z
    qz = tx * e0y - ty * e0x
    un = px * tx + py * ty + pz * tz
    vn = qx * dx + qy * dy + qz * dz
    tn = qx * e1x + qy * e1y + qz * e1z
    return det, un, vn, tn


def _mt_candidates(o, d, v0, e0, e1):
    """(N, Tc) Möller–Trumbore t for every (ray, triangle) pair; invalid
    pairs get BIG_T."""
    det, un, vn, tn = _mt_numerators(o, d, v0, e0, e1)
    parallel = torch.abs(det) < MT_TOLERANCE
    inv_det = 1.0 / torch.where(parallel, 1.0, det)
    u = inv_det * un
    v = inv_det * vn
    t = inv_det * tn
    valid = (
        (~parallel)
        & (u >= -MT_TOLERANCE)
        & (v >= -MT_TOLERANCE)
        & (u + v <= 1.0 + MT_TOLERANCE)
        & (t > T_MIN)
    )
    return torch.where(valid, t, BIG_T)


def mt_cull(o, d, v0, e0, e1, t_cap):
    """(N, T) bool: the pairs that the brute-force fused kernel's sweeps
    and the any-hit kernel reject before the division, where ``t_cap`` (N,) is the sweep's limit
    (the best t so far, or the shadow ray's t_max), computed as the kernel
    computes it. With a = |det| and the numerators signed by det, a pair is
    rejected when parallel, when u's or v's numerator is below −a·CULL_LO,
    their sum above a·CULL_HI, t's numerator at most a·CULL_TMIN, or at
    least a·(t_cap·CULL_TCAP): each implies that ``_mt_candidates``'s t is
    invalid or not below t_cap (``csrc/common.cuh`` says why)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    det, un, vn, tn = _mt_numerators(o, d, v0, e0, e1)
    a = torch.abs(det)
    neg = det < 0.0
    us, vs, ts = (torch.where(neg, -x, x) for x in (un, vn, tn))
    lo = -(a * f32(CULL_LO))
    cap = torch.as_tensor(t_cap, dtype=torch.float32, device=o.device) * f32(CULL_TCAP)
    return (
        (a < MT_TOLERANCE) | (us < lo) | (vs < lo) | (us + vs > a * f32(CULL_HI))
        | (ts <= a * f32(CULL_TMIN)) | (ts >= a * cap[:, None])
    )


def intersect_closest_raw(o, d, v0, e0, e1, chunk: int = 32):
    """Sweep only: (best_t (N,) f32, best_i (N,) int64), BIG_T/0 on a miss;
    the first index wins a tie."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG_T, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for base in range(0, v0.shape[0], chunk):
        t = _mt_candidates(
            o, d, v0[base:base + chunk], e0[base:base + chunk], e1[base:base + chunk]
        )
        i_l = torch.argmin(t, dim=1)
        t_b = torch.gather(t, 1, i_l[:, None])[:, 0]
        better = t_b < best_t
        best_t = torch.where(better, t_b, best_t)
        best_i = torch.where(better, base + i_l, best_i)
    return best_t, best_i


def closest_split_ref(o, d, v0, e0, e1, k: int):
    """Plain model of the closest-hit kernel's split of a ray over ``k``
    lanes (``csrc/intersect.cu``): lane l sweeps triangles l, l + k, ...
    and keeps the first index of its least t (BIG_T/0 on a miss), then the
    lanes reduce to the lexicographic least (t, index), as the kernel's
    shuffles do. Equal to ``intersect_closest_raw`` bit for bit; only the
    tests call it."""
    best_t = torch.full((o.shape[0],), BIG_T, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    for lane in range(k):
        t, i = intersect_closest_raw(o, d, v0[lane::k], e0[lane::k], e1[lane::k])
        i = torch.where(t < BIG_T, lane + k * i, 0)
        better = (t < best_t) | ((t == best_t) & (i < best_i))
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i, best_i)
    return best_t, best_i


def intersect_any(o, d, v0, e0, e1, t_max, chunk: int = 32):
    """Occlusion test: True where a triangle is hit at T_MIN < t < t_max."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = torch.broadcast_to(t_max, (o.shape[0],))[:, None]
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for base in range(0, v0.shape[0], chunk):
        t = _mt_candidates(
            o, d, v0[base:base + chunk], e0[base:base + chunk], e1[base:base + chunk]
        )
        occ = occ | torch.any(t < t_max, dim=1)
    return occ


def _uv_for_tri(o, d, v0g, e0g, e1g):
    """Barycentrics of rays against their own gathered triangle (N,)."""
    px = d[:, 1] * e1g[:, 2] - d[:, 2] * e1g[:, 1]
    py = d[:, 2] * e1g[:, 0] - d[:, 0] * e1g[:, 2]
    pz = d[:, 0] * e1g[:, 1] - d[:, 1] * e1g[:, 0]
    det = px * e0g[:, 0] + py * e0g[:, 1] + pz * e0g[:, 2]
    inv_det = 1.0 / torch.where(torch.abs(det) < MT_TOLERANCE, 1.0, det)
    tx = o[:, 0] - v0g[:, 0]
    ty = o[:, 1] - v0g[:, 1]
    tz = o[:, 2] - v0g[:, 2]
    qx = ty * e0g[:, 2] - tz * e0g[:, 1]
    qy = tz * e0g[:, 0] - tx * e0g[:, 2]
    qz = tx * e0g[:, 1] - ty * e0g[:, 0]
    u = inv_det * (px * tx + py * ty + pz * tz)
    v = inv_det * (qx * d[:, 0] + qy * d[:, 1] + qz * d[:, 2])
    return u, v


def closest_epilogue(o, d, v0, e0, e1, best_t, best_i, t_max=None) -> ClosestHit:
    """Full hit record from (best_t, best_i): barycentrics recomputed for
    the winning triangle, position, incident-facing normal, error bound."""
    hit = best_t < BIG_T
    if t_max is not None:
        hit = hit & (best_t < t_max)
    best_i = best_i.to(torch.int64)
    hv0, he0, he1 = v0[best_i], e0[best_i], e1[best_i]
    best_u, best_v = _uv_for_tri(o, d, hv0, he0, he1)
    pos = hv0 + best_u[:, None] * he0 + best_v[:, None] * he1
    ng = normalize(cross(he1, he0))
    facing = dot(d, ng) > 0.0
    ng = torch.where(facing[:, None], -ng, ng)
    err = error_from_triangle_intersection(best_u, best_v, hv0, hv0 + he0, hv0 + he1)
    return ClosestHit(hit, best_t, best_i, best_u, best_v, pos, ng, err, facing)


def intersect_closest(o, d, v0, e0, e1, t_max=None, chunk: int = 32) -> ClosestHit:
    """Closest hit of rays (N,3)×2 against all T triangles."""
    best_t, best_i = intersect_closest_raw(o, d, v0, e0, e1, chunk)
    return closest_epilogue(o, d, v0, e0, e1, best_t, best_i, t_max)

"""Vector math on ``(..., 3)`` float32 tensors (counterpart of the
reference ``ops/vecmath.py``).

Dot products and transforms are explicit per-component multiply-adds,
never ``@``/``einsum``: those may run as TF32 on the card (the GPU form of
the bf16 ray-quantisation fault, ``docs/quality.md``), and the explicit
form is also the order the CUDA kernels use.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
INV_PI = 1.0 / math.pi


def dot(a, b, keepdim: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdim else r


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v):
    return torch.sqrt(dot(v, v))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def sqr(x):
    return x * x


def normalize(v):
    l2 = dot(v, v, keepdim=True)
    return v * torch.where(l2 > 0.0, torch.rsqrt(torch.clamp(l2, min=1e-38)), 0.0)


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def average3(v):
    return (v[..., 0] + v[..., 1] + v[..., 2]) / 3.0


def max_component(v):
    return torch.maximum(torch.maximum(v[..., 0], v[..., 1]), v[..., 2])


def smoothstep(a, b, x):
    """Correct smoothstep between edges ``a`` and ``b`` (the reference
    CUDA renderer's has min/max swapped; see the JAX package's note)."""
    t = torch.clamp((x - a) / (b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sin_sqr_to_one_minus_cos(s_sq):
    """1 - sqrt(1 - s^2), Taylor-stabilized for small angles."""
    return torch.where(s_sq > 0.0004, 1.0 - safe_sqrt(1.0 - s_sq), 0.5 * s_sq)


def sin_from_cos(c):
    return safe_sqrt(1.0 - sqr(c))


def gram_schmidt(n):
    """Branch-free tangent frame around unit normal ``n`` → (T, B):
    cross with (1,1,1), or (-1,1,1) near the diagonal."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    near_diag = (torch.abs(nx - ny) <= 1e-3) & (torch.abs(nx - nz) <= 1e-3)
    a = torch.stack(
        [
            nz - ny,
            torch.where(near_diag, nx + nz, nx - nz),
            torch.where(near_diag, -ny - nx, ny - nx),
        ],
        dim=-1,
    )
    t = normalize(a)
    return t, cross(n, t)


def face_forward(n, v):
    """Flip ``n`` into the hemisphere of ``v``."""
    return torch.where(dot(n, v, keepdim=True) < 0.0, -n, n)


def refract_angle(incident, normal, cos_theta_t, inv_eta):
    """Refracted direction from the transmitted cosine (Snell);
    ``incident`` points away from the surface, ``inv_eta = η_i/η_t``."""
    c = inv_eta * dot(incident, normal, keepdim=True) - cos_theta_t[..., None]
    return c * normal - inv_eta * incident


# fp32 rounding-error bounds (PBRT gamma), as the reference computes them
_MACHINE_EPS = np.float32(5.960464477539063e-08)  # 2^-24


def float_gamma(n: int):
    ne = n * _MACHINE_EPS
    return ne / (1.0 - ne)


def error_from_triangle_intersection(u, v, p0, p1, p2):
    """Intersection-point error bound (same pairing of weights and
    corners as the reference)."""
    g = float(float_gamma(7))
    w = (1.0 - u - v)[..., None]
    return g * (
        torch.abs(u[..., None] * p0)
        + torch.abs(v[..., None] * p1)
        + torch.abs(w * p2)
    )


def offset_ray_origin(p, error, ng, w):
    """Shift ``p`` off the surface along ±ng by the error bound, then
    round each component one ulp away from the surface."""
    d = dot(torch.abs(ng), error, keepdim=True)
    offset = ng * d
    offset = torch.where(dot(w, ng, keepdim=True) < 0.0, -offset, offset)
    po = p + offset
    toward = torch.where(offset > 0.0, math.inf, -math.inf).to(po.dtype)
    return torch.nextafter(po, toward)


def transform_point(m, p):
    """4×4 ``m`` applied to points ``p`` (..., 3), explicit f32 mul-adds."""
    return torch.stack(
        [
            m[i, 0] * p[..., 0] + m[i, 1] * p[..., 1] + m[i, 2] * p[..., 2]
            + m[i, 3]
            for i in range(3)
        ],
        dim=-1,
    )


def transform_vector(m, v):
    return torch.stack(
        [
            m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1] + m[i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )

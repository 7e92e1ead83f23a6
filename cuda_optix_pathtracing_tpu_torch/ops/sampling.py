"""Sampling primitives (counterpart of the reference ``ops/sampling.py``):
the disk, cosine-hemisphere, cone and sphere samplers, the ray-sphere
hit the spot light needs and the environment map's direction → (u, v)
map. Batched over leading dims; directions built on a
normal use the ``gram_schmidt`` frame."""

from __future__ import annotations

import torch

from .vecmath import INV_PI, PI, dot, gram_schmidt, safe_acos, safe_sqrt


def sample_uniform_disk(u1, u2):
    """Concentric (Shirley–Chiu) disk mapping.

    φ = (π/4)(b/a) in the |a|-dominant wedges and π/2 − (π/4)(a/b)
    otherwise. An early version of the reference used (3π/4)·(a/b) in the
    second branch, which folds the azimuth density 2:1 by quadrant; keep
    this form (the JAX package documents the fix in ``ops/bsdf.py``).
    """
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    a_dom = torch.abs(a) > torch.abs(b)
    rho = torch.where(a_dom, a, b)
    ratio = torch.where(
        a_dom,
        b / torch.where(a == 0.0, 1.0, a),
        a / torch.where(b == 0.0, 1.0, b),
    )
    phi = torch.where(a_dom, (PI / 4.0) * ratio, PI / 2.0 - (PI / 4.0) * ratio)
    zero = (a == 0.0) & (b == 0.0)
    x = torch.where(zero, 0.0, rho * torch.cos(phi))
    y = torch.where(zero, 0.0, rho * torch.sin(phi))
    return x, y


def sample_uniform_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_cos_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere around ``n`` → (dir, pdf)."""
    x, y = sample_uniform_disk(u1, u2)
    cos_theta = safe_sqrt(1.0 - (x * x + y * y))
    t, b = gram_schmidt(n)
    d = x[..., None] * t + y[..., None] * b + cos_theta[..., None] * n
    return d, cos_theta * INV_PI


def sample_uniform_cone(n, one_minus_cos, u1, u2):
    """Uniform direction in the cone around ``n`` → (dir, cos, pdf,
    delta); a degenerate cone returns ``n`` with pdf 1 and delta set."""
    x, y = sample_uniform_disk(u1, u2)
    r2 = x * x + y * y
    cone = one_minus_cos > 0.0
    cos_theta = torch.where(cone, 1.0 - r2 * one_minus_cos, 1.0)
    scale = safe_sqrt(r2 * one_minus_cos * (2.0 - r2 * one_minus_cos))
    denom = torch.clamp(one_minus_cos, min=1e-8)
    pdf = torch.where(cone, 0.5 / (PI * denom), 1.0)
    t, b = gram_schmidt(n)
    d_cone = (
        (x * scale)[..., None] * t
        + (y * scale)[..., None] * b
        + cos_theta[..., None] * n
    )
    d = torch.where(cone[..., None], d_cone, n)
    return d, cos_theta, pdf, ~cone


def ray_sphere_intersect(ray_o, ray_d, t_min, t_max, center, radius):
    """Ray-sphere hit (after Cycles) → (hit_mask, t, p)."""
    d_vec = center - ray_o
    r_sq = radius * radius
    d_sq = dot(d_vec, d_vec)
    d_cos = dot(d_vec, ray_d)
    away = (d_sq > r_sq) & (d_cos < 0.0)
    perp = d_vec - d_cos[..., None] * ray_d
    sin_sq = dot(perp, perp)
    outside_ray = sin_sq > r_sq
    t = d_cos - torch.copysign(safe_sqrt(r_sq - sin_sq), d_sq - r_sq)
    hit = (~away) & (~outside_ray) & (t > t_min) & (t < t_max)
    p = ray_o + ray_d * t[..., None]
    return hit, t, p


def map_to_sphere(co):
    """Direction → (u, v) spherical map: u = ½ − atan2(x, y)/2π,
    v = 1 − acos(z/|co|)/π; u = 0 on the z axis, (0, 0) for a zero vector."""
    l2 = dot(co, co)
    x, y, z = co[..., 0], co[..., 1], co[..., 2]
    u = torch.where(
        (x == 0.0) & (y == 0.0), 0.0, 0.5 - torch.atan2(x, y) * (0.5 * INV_PI)
    )
    v = 1.0 - safe_acos(z / torch.clamp(torch.sqrt(l2), min=1e-20)) * INV_PI
    zero = l2 <= 0.0
    return torch.where(zero, 0.0, u), torch.where(zero, 0.0, v)

"""Light library: point (sphere nucleus), spot, constant environment,
directional and area lights (counterpart of the reference
``ops/lights.py``).

Each ray carries its gathered light row and the light types are
evaluated as masked dense code; a caller that knows which types its table
holds passes them (``types``), and the branches of absent types are not
run. Spot attenuation uses a correct smoothstep; a constant-environment
row's pdf is the uniform sphere's 1/(4π). Scenes with many finite lights
select them through the light tree (``ops/light_tree.py``): its records
are the POINT/SPOT rows of the table (``REC_ROW``) and the triangles of
the ``EmissiveTable`` (``REC_TRI``), each sampled on its own; ENV and
DIRECTIONAL rows stay outside it and are sampled every bounce.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .sampling import (
    ray_sphere_intersect,
    sample_cos_hemisphere,
    sample_uniform_cone,
    sample_uniform_sphere,
)
from .vecmath import (
    INV_PI,
    cross,
    dot,
    length,
    normalize,
    safe_sqrt,
    sin_sqr_to_one_minus_cos,
    smoothstep,
    sqr,
)

POINT = 0
SPOT = 1
ENV = 2
DIRECTIONAL = 3
AREA = 4  # one row standing for the whole emissive-triangle set

ALL_LIGHT_TYPES = (POINT, SPOT, ENV, DIRECTIONAL, AREA)

BIG_DIST = 3.0e38


class LightTable(NamedTuple):
    """SoA light parameters; rows indexed by light id."""

    ltype: torch.Tensor  # (L,) int32
    color: torch.Tensor  # (L,3) intensity
    pos: torch.Tensor  # (L,3)
    direction: torch.Tensor  # (L,3) unit (spot/directional)
    cos_theta0: torch.Tensor  # (L,) spot max-intensity cosine
    cos_theta_e: torch.Tensor  # (L,) spot penumbra cosine
    radius: torch.Tensor  # (L,) nucleus radius
    one_minus_cos: torch.Tensor  # (L,) directional spread

    def gather(self, idx) -> "LightTable":
        return LightTable(*(f[idx] for f in self))


def point_light(color, position, radius: float = 1e-3) -> dict:
    return dict(ltype=POINT, color=color, pos=position, radius=radius)


def spot_light(color, position, direction, cos_theta0, cos_theta_e, radius) -> dict:
    d = np.asarray(direction, np.float64)
    return dict(
        ltype=SPOT,
        color=color,
        pos=position,
        direction=(d / np.linalg.norm(d)).astype(np.float32),
        cos_theta0=float(cos_theta0),
        cos_theta_e=float(cos_theta_e),
        radius=float(radius),
    )


def directional_light(color, direction, one_minus_cos: float = 0.0) -> dict:
    d = np.asarray(direction, np.float64)
    return dict(
        ltype=DIRECTIONAL,
        color=color,
        direction=(d / np.linalg.norm(d)).astype(np.float32),
        one_minus_cos=float(one_minus_cos),
    )


def environment_light(color) -> dict:
    return dict(ltype=ENV, color=color)


def area_light() -> dict:
    """The one row standing for the emissive-triangle set."""
    return dict(ltype=AREA, color=(0.0, 0.0, 0.0))


class EmissiveTable(NamedTuple):
    """Flattened emissive-triangle set for area-light NEE."""

    v0: torch.Tensor  # (K,3)
    e0: torch.Tensor  # (K,3)
    e1: torch.Tensor  # (K,3)
    rad: torch.Tensor  # (K,3) radiance
    cdf: torch.Tensor  # (K+1,) area-weighted selection CDF
    area: torch.Tensor  # () total area


def make_emissive_table(v0, e0, e1, rad, device=None) -> EmissiveTable:
    v0 = np.asarray(v0, np.float32)
    e0 = np.asarray(e0, np.float32)
    e1 = np.asarray(e1, np.float32)
    rad = np.asarray(rad, np.float32)
    areas = 0.5 * np.linalg.norm(np.cross(e0, e1), axis=1)
    total = max(float(areas.sum()), 1e-12)
    cdf = np.concatenate([[0.0], np.cumsum(areas / total)]).astype(np.float32)
    cdf[-1] = 1.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return EmissiveTable(
        t(v0), t(e0), t(e1), t(rad), t(cdf),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def sample_area_light(em: EmissiveTable, position, u1, u2):
    """Uniform-by-area sample of the emissive set from ``position`` →
    (p, dir, dist, pdf_solid, le). Emission is two-sided."""
    k = em.v0.shape[0]
    tri = torch.clamp(
        torch.searchsorted(em.cdf, u1.contiguous(), right=True) - 1, 0, k - 1
    )
    c0 = em.cdf[tri]
    c1 = em.cdf[tri + 1]
    du = (u1 - c0) / torch.clamp(c1 - c0, min=1e-12)
    tv0, te0, te1, trad = em.v0[tri], em.e0[tri], em.e1[tri], em.rad[tri]
    su = safe_sqrt(du)
    b1 = 1.0 - su
    b2 = u2 * su
    p = tv0 + b1[..., None] * te0 + b2[..., None] * te1
    n_e = cross(te0, te1)
    n_len = torch.clamp(length(n_e), min=1e-12)
    n_e = n_e / n_len[..., None]
    to_p = p - position
    dist_sqr = torch.clamp(dot(to_p, to_p), min=1e-12)
    dist = torch.sqrt(dist_sqr)
    d = to_p / dist[..., None]
    cos_l = torch.abs(dot(d, n_e))
    pdf_solid = dist_sqr / torch.clamp(cos_l * em.area, min=1e-12)
    lit = cos_l > 1e-6
    le = torch.where(lit[..., None], trad, 0.0)
    pdf_solid = torch.where(lit, pdf_solid, 0.0)
    return p, d, dist, pdf_solid, le


_DEFAULTS = dict(
    ltype=POINT,
    color=(1.0, 1.0, 1.0),
    pos=(0.0, 0.0, 0.0),
    direction=(0.0, 0.0, -1.0),
    cos_theta0=1.0,
    cos_theta_e=0.0,
    radius=1e-3,
    one_minus_cos=0.0,
)


def make_light_table(lights: Sequence[dict], device=None) -> LightTable:
    rows = []
    for li in lights:
        d = dict(_DEFAULTS)
        d.update(li)
        rows.append(d)

    def col(name, width):
        if width == 1:
            a = np.asarray([r[name] for r in rows], np.float32)
        else:
            a = np.asarray(
                [np.broadcast_to(r[name], (3,)) for r in rows], np.float32
            )
        return torch.as_tensor(a, device=device)

    return LightTable(
        ltype=torch.as_tensor(
            np.asarray([r["ltype"] for r in rows], np.int32), device=device
        ),
        color=col("color", 3),
        pos=col("pos", 3),
        direction=col("direction", 3),
        cos_theta0=col("cos_theta0", 1),
        cos_theta_e=col("cos_theta_e", 1),
        radius=col("radius", 1),
        one_minus_cos=col("one_minus_cos", 1),
    )


class LightSample(NamedTuple):
    p_light: torch.Tensor  # (N,3) sampled point
    direction: torch.Tensor  # (N,3) shading point → light
    pdf: torch.Tensor  # (N,) solid-angle pdf (0 = invalid)
    delta: torch.Tensor  # (N,) bool
    distance: torch.Tensor  # (N,)
    factor: torch.Tensor  # (N,) angular attenuation (spot)


def sample_light(lt: LightTable, position, u1, u2, normal, types=ALL_LIGHT_TYPES) -> LightSample:
    """Sample the gathered rows ``lt`` from ``position`` (N,3).

    Point/spot nucleus sampling: a cone toward the sphere from outside, a
    cosine hemisphere around ``normal`` from inside (no transmission
    history is carried into NEE, as in the reference integrator). Spots
    sample their spread cone instead when it is tighter, attenuate by a
    smoothstep and re-project the sample onto the sphere. A constant
    environment row samples the uniform sphere; a directional row the cone
    of its spread around −direction (delta). ``types``: the light types
    the rows may hold; the others' branches are skipped.
    """
    n = position.shape[0]
    lpos, radius = lt.pos, lt.radius
    radius_sqr = sqr(radius)
    to_p = position - lpos
    dist_sqr = torch.clamp(dot(to_p, to_p), min=1e-20)
    dist = torch.sqrt(dist_sqr)
    light_n = to_p / dist[..., None]
    outside = dist_sqr > radius_sqr
    effectively_delta = (radius / dist) < 1e-3
    omc_sphere = sin_sqr_to_one_minus_cos(radius_sqr / dist_sqr)
    d_out, cos_out, pdf_out, delta_out = sample_uniform_cone(
        -light_n, omc_sphere, u1, u2
    )
    d_in, pdf_in = sample_cos_hemisphere(normal, u1, u2)
    cos_in = -dot(d_in, light_n)
    d = torch.where(outside[..., None], d_out, d_in)
    cos_theta = torch.where(outside, cos_out, cos_in)
    pdf = torch.where(outside, pdf_out, pdf_in)
    delta = outside & (delta_out | effectively_delta)
    pdf = torch.where(delta, 1.0, pdf)
    # law of cosines: distance to the sphere surface along the sample
    distance = dist * cos_theta - torch.copysign(
        safe_sqrt(radius_sqr - dist_sqr + dist_sqr * sqr(cos_theta)),
        dist_sqr - radius_sqr,
    )
    p_light = position + d * distance[..., None]
    factor = torch.ones((n,), dtype=torch.float32, device=position.device)

    # ---- spot extras ----
    is_spot = lt.ltype == SPOT
    spot_dir = lt.direction
    omc_spread = 1.0 - lt.cos_theta_e
    toward_apex = omc_sphere < omc_spread
    d_cone, _, pdf_cone, delta_cone = sample_uniform_cone(
        -spot_dir, omc_spread, u1, u2
    )
    hit_s, t_s, p_s = ray_sphere_intersect(
        position, d_cone, 0.0, BIG_DIST, lpos, radius
    )
    use_cone = is_spot & outside & ~toward_apex
    d = torch.where(use_cone[..., None], d_cone, d)
    pdf = torch.where(use_cone, torch.where(hit_s, pdf_cone, 0.0), pdf)
    delta = torch.where(use_cone, delta_cone & hit_s, delta)
    distance = torch.where(use_cone, t_s, distance)
    p_light = torch.where(use_cone[..., None], p_s, p_light)

    cos_spot = dot(-d, spot_dir)
    att = smoothstep(lt.cos_theta_e, lt.cos_theta0, cos_spot)
    factor = torch.where(is_spot, att, factor)
    pdf = torch.where(is_spot & (att <= 0.0), 0.0, pdf)
    eff_delta = is_spot & ((radius / dist) < 1e-3) & (pdf > 0.0)
    delta = delta | eff_delta
    pdf = torch.where(eff_delta, 1.0, pdf)
    # re-project onto the sphere and fix the direction
    spot_like = is_spot & (pdf > 0.0)
    ng = normalize(p_light - lpos)
    p_proj = ng * radius[..., None] + lpos
    new_dir = p_proj - position
    new_dist = length(new_dir)
    proj_ok = spot_like & (new_dist > 1e-8)
    d = torch.where(
        proj_ok[..., None],
        new_dir / torch.clamp(new_dist, min=1e-8)[..., None],
        d,
    )
    distance = torch.where(proj_ok, new_dist, distance)
    p_light = torch.where(proj_ok[..., None], p_proj, p_light)

    if ENV in types:  # uniform sphere
        is_env = lt.ltype == ENV
        d_env = sample_uniform_sphere(u1, u2)
        d = torch.where(is_env[..., None], d_env, d)
        pdf = torch.where(is_env, 0.25 * INV_PI, pdf)
        delta = torch.where(is_env, False, delta)
        distance = torch.where(is_env, BIG_DIST, distance)
        p_light = torch.where(is_env[..., None], d_env, p_light)
        factor = torch.where(is_env, 1.0, factor)

    if DIRECTIONAL in types:  # cone of spread around −direction
        is_dir = lt.ltype == DIRECTIONAL
        d_dir, _, pdf_dir, _ = sample_uniform_cone(lt.direction, lt.one_minus_cos, u1, u2)
        d = torch.where(is_dir[..., None], -d_dir, d)
        pdf = torch.where(is_dir, pdf_dir, pdf)
        delta = torch.where(is_dir, True, delta)
        distance = torch.where(is_dir, BIG_DIST, distance)
        p_light = torch.where(is_dir[..., None], d_dir, p_light)
        factor = torch.where(is_dir, 1.0, factor)
    return LightSample(p_light, d, pdf, delta, distance, factor)


def eval_light(lt: LightTable, ls: LightSample):
    """Radiance arriving along the sample: intensity × angular factor,
    with inverse-square falloff for point/spot rows."""
    le = lt.color * ls.factor[..., None]
    finite = (lt.ltype == POINT) | (lt.ltype == SPOT)
    atten = 1.0 / torch.clamp(sqr(ls.distance), min=1e-12)
    return torch.where(finite[..., None], le * atten[..., None], le)


def eval_infinite_light(color, direction):
    """Constant environment emission and its uniform-sphere pdf."""
    n = direction.shape[0]
    pdf = torch.full((n,), 0.25 * INV_PI, dtype=torch.float32, device=direction.device)
    return color.expand(n, 3), pdf

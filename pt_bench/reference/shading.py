"""Vector math, sampling, materials and lights of the plain reference, in
plain PyTorch: Oren-Nayar (Fujii, energy-compensated), the GGX dielectric
with VNDF sampling and Kulla-Conty multiple scattering, and point and spot
lights with nucleus-sphere sampling. Every function works in the dtype of
its inputs (float32, or bfloat16 for the control).

Dot products are explicit multiply-adds, never ``@``: a product on the card
may run in TF32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

PI = math.pi
INV_PI = 1.0 / math.pi
OREN_NAYAR, GGX_DIELECTRIC = 0, 1
POINT, SPOT = 0, 1
DELTA_ALPHA = 1e-3  # below this roughness GGX is specular
THROUGHPUT_EPS = 1e-6
BIG_DIST = 3.0e38


# ---------------------------------------------------------------- vectors

def dot(a, b, keepdim: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdim else r


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


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
    t = torch.clamp((x - a) / (b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sin_from_cos(c):
    return safe_sqrt(1.0 - sqr(c))


def gram_schmidt(n):
    """Branch-free tangent frame around unit ``n``: cross with (1, 1, 1),
    or (-1, 1, 1) near the diagonal."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    near = (torch.abs(nx - ny) <= 1e-3) & (torch.abs(nx - nz) <= 1e-3)
    a = torch.stack([nz - ny, torch.where(near, nx + nz, nx - nz),
                     torch.where(near, -ny - nx, ny - nx)], dim=-1)
    t = normalize(a)
    return t, cross(n, t)


def face_forward(n, v):
    return torch.where(dot(n, v, keepdim=True) < 0.0, -n, n)


def refract_angle(incident, normal, cos_theta_t, inv_eta):
    c = inv_eta * dot(incident, normal, keepdim=True) - cos_theta_t[..., None]
    return c * normal - inv_eta * incident


def offset_ray_origin(p, error, ng, w):
    """Shift ``p`` off the surface by its error bound along +-ng, then one
    ulp further away."""
    d = dot(torch.abs(ng), error, keepdim=True)
    offset = ng * d
    offset = torch.where(dot(w, ng, keepdim=True) < 0.0, -offset, offset)
    po = p + offset
    toward = torch.where(offset > 0.0, math.inf, -math.inf).to(po.dtype)
    return torch.nextafter(po, toward)


# --------------------------------------------------------------- sampling

def sample_uniform_disk(u1, u2):
    """Concentric (Shirley-Chiu) disk mapping."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    a_dom = torch.abs(a) > torch.abs(b)
    rho = torch.where(a_dom, a, b)
    ratio = torch.where(a_dom, b / torch.where(a == 0.0, 1.0, a),
                        a / torch.where(b == 0.0, 1.0, b))
    phi = torch.where(a_dom, (PI / 4.0) * ratio, PI / 2.0 - (PI / 4.0) * ratio)
    zero = (a == 0.0) & (b == 0.0)
    return (torch.where(zero, 0.0, rho * torch.cos(phi)),
            torch.where(zero, 0.0, rho * torch.sin(phi)))


def sample_cos_hemisphere(n, u1, u2):
    x, y = sample_uniform_disk(u1, u2)
    cos_theta = safe_sqrt(1.0 - (x * x + y * y))
    t, b = gram_schmidt(n)
    return x[..., None] * t + y[..., None] * b + cos_theta[..., None] * n, cos_theta * INV_PI


def sample_uniform_cone(n, one_minus_cos, u1, u2):
    x, y = sample_uniform_disk(u1, u2)
    r2 = x * x + y * y
    cone = one_minus_cos > 0.0
    cos_theta = torch.where(cone, 1.0 - r2 * one_minus_cos, 1.0)
    scale = safe_sqrt(r2 * one_minus_cos * (2.0 - r2 * one_minus_cos))
    pdf = torch.where(cone, 0.5 / (PI * torch.clamp(one_minus_cos, min=1e-8)), 1.0)
    t, b = gram_schmidt(n)
    d = (x * scale)[..., None] * t + (y * scale)[..., None] * b + cos_theta[..., None] * n
    return torch.where(cone[..., None], d, n), cos_theta, pdf, ~cone


def ray_sphere_intersect(ray_o, ray_d, t_min, t_max, center, radius):
    d_vec = center - ray_o
    r_sq = radius * radius
    d_sq = dot(d_vec, d_vec)
    d_cos = dot(d_vec, ray_d)
    away = (d_sq > r_sq) & (d_cos < 0.0)
    perp = d_vec - d_cos[..., None] * ray_d
    sin_sq = dot(perp, perp)
    t = d_cos - torch.copysign(safe_sqrt(r_sq - sin_sq), d_sq - r_sq)
    hit = (~away) & ~(sin_sq > r_sq) & (t > t_min) & (t < t_max)
    return hit, t, ray_o + ray_d * t[..., None]


# -------------------------------------------------------------- materials

class Materials(NamedTuple):
    mtype: torch.Tensor  # (M,) int32
    albedo: torch.Tensor  # (M, 3)
    on_sigma: torch.Tensor
    alphax: torch.Tensor
    alphay: torch.Tensor
    phi0: torch.Tensor
    eta: torch.Tensor
    refl_tint: torch.Tensor  # (M, 3)
    trans_tint: torch.Tensor  # (M, 3)

    def gather(self, idx) -> "Materials":
        return Materials(*(f[idx] for f in self))


MAT_DEFAULTS = dict(mtype=0, albedo=(1.0, 1.0, 1.0), on_sigma=0.0, alphax=0.5, alphay=0.5,
                    phi0=0.0, eta=1.5, refl_tint=(1.0, 1.0, 1.0), trans_tint=(0.0, 0.0, 0.0))


def make_materials(rows, device, dtype) -> Materials:
    rows = [{**MAT_DEFAULTS, **r} for r in rows]
    bad = {r["mtype"] for r in rows} - {OREN_NAYAR, GGX_DIELECTRIC}
    if bad:
        raise ValueError(f"the reference knows Oren-Nayar and GGX dielectric rows, not {bad}")

    def col(name, width):
        a = np.asarray([np.broadcast_to(np.asarray(r[name], np.float32), (3,)) if width == 3
                        else r[name] for r in rows], np.float32)
        return torch.as_tensor(a, device=device).to(dtype)

    return Materials(torch.as_tensor(np.asarray([r["mtype"] for r in rows], np.int32),
                                     device=device),
                     col("albedo", 3), col("on_sigma", 1), col("alphax", 1), col("alphay", 1),
                     col("phi0", 1), col("eta", 1), col("refl_tint", 3), col("trans_tint", 3))


def ggx_d(alpha2, cos_nh):
    cos2 = torch.clamp(sqr(cos_nh), max=1.0)
    return alpha2 / (PI * sqr((1.0 - cos2) + alpha2 * cos2))


def _lambda_from_sqr_alpha_tan(s):
    return 0.5 * (torch.sqrt(1.0 + s) - 1.0)


def ggx_lambda(alpha2, cos_n):
    s = alpha2 * torch.clamp(1.0 / torch.clamp(sqr(cos_n), min=1e-12) - 1.0, min=0.0)
    return _lambda_from_sqr_alpha_tan(s)


def ggx_aniso_d(ax, ay, h):
    hx, hy, hz = h[..., 0] / ax, h[..., 1] / ay, h[..., 2]
    len2 = hx * hx + hy * hy + hz * hz
    return INV_PI / torch.clamp(ax * ay * sqr(len2), min=1e-20)


def ggx_aniso_lambda(ax, ay, v):
    s = (sqr(ax * v[..., 0]) + sqr(ay * v[..., 1])) / torch.clamp(sqr(v[..., 2]), min=1e-12)
    return _lambda_from_sqr_alpha_tan(s)


def sample_ggx_vndf(local_o, u1, u2, ax, ay):
    """Heitz 2018 visible-normal sampling → local half vector."""
    v = normalize(torch.stack([ax * local_o[..., 0], ay * local_o[..., 1], local_o[..., 2]], -1))
    lensq = sqr(v[..., 0]) + sqr(v[..., 1])
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-14))
    frame = (lensq > 1e-7)[..., None]
    zero = torch.zeros_like(inv_len)
    t1 = torch.where(frame, torch.stack([-v[..., 1] * inv_len, v[..., 0] * inv_len, zero], -1),
                     torch.stack([zero + 1.0, zero, zero], -1))
    t2 = torch.where(frame, cross(v, t1), torch.stack([zero, zero + 1.0, zero], -1))
    dx, dy = sample_uniform_disk(u1, u2)
    dy = lerp(safe_sqrt(1.0 - sqr(dx)), dy, 0.5 * (1.0 + v[..., 2]))
    nh = dx[..., None] * t1 + dy[..., None] * t2 + safe_sqrt(1.0 - sqr(dx) - sqr(dy))[..., None] * v
    return normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=0.0)], -1))


def fresnel_dielectric(cos_i, eta):
    """(F, cos theta_t); ``eta`` is outside over inside for this side."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t = safe_sqrt(1.0 - sqr(cos_i)) / eta
    tir = sin_t >= 1.0
    cos_t = safe_sqrt(1.0 - sqr(sin_t))
    r_parl = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    return torch.where(tir, 1.0, 0.5 * (sqr(r_parl) + sqr(r_perp))), cos_t


# GGX energy tables: the directional albedo E(cos, alpha^2) by stratified
# VNDF integration, fitted by polynomials (Kulla-Conty); numpy, float64

E_TABLE_RES = 32
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _np_disk(u1, u2):
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    a_dom = np.abs(a) > np.abs(b)
    rho = np.where(a_dom, a, b)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.nan_to_num(np.where(a_dom, b / a, a / b))
    phi = np.where(a_dom, (np.pi / 4) * ratio, np.pi / 2 - (np.pi / 4) * ratio)
    zero = (a == 0) & (b == 0)
    return np.where(zero, 0.0, rho * np.cos(phi)), np.where(zero, 0.0, rho * np.sin(phi))


def _np_lambda(alpha2, cos_n):
    s = alpha2 * np.maximum(0.0, 1.0 / np.maximum(cos_n**2, 1e-12) - 1.0)
    return 0.5 * (np.sqrt(1.0 + s) - 1.0)


@functools.lru_cache(maxsize=1)
def _energy_tables():
    res, ns = E_TABLE_RES, 64
    u1, u2 = np.meshgrid((np.arange(ns) + 0.5) / ns, (np.arange(ns) + 0.5) / ns, indexing="ij")
    u1, u2 = u1.reshape(1, -1), u2.reshape(1, -1)
    cos_o = np.clip(np.linspace(0.0, 1.0, res).reshape(-1, 1), 1e-3, 1.0)
    sin_o = np.sqrt(1.0 - cos_o**2)
    rows = []
    for alpha2 in np.clip(np.linspace(0.0, 1.0, res), 1e-6, 1.0):
        alpha = np.sqrt(alpha2)
        vx, vz = alpha * sin_o, cos_o
        norm = np.sqrt(vx**2 + vz**2)
        vx, vz = vx / norm, vz / norm
        dx, dy = _np_disk(u1, u2)
        dy = ((1.0 - 0.5 * (1.0 + vz)) * np.sqrt(np.maximum(1.0 - dx**2, 0.0))
              + 0.5 * (1.0 + vz) * dy)
        dz = np.sqrt(np.maximum(1.0 - dx**2 - dy**2, 0.0))
        nhx = (dx * (-vz) + dz * vx) * alpha
        nhy = dy * alpha
        nhz = np.maximum(dx * vx + dz * vz, 0.0)
        nlen = np.sqrt(nhx**2 + nhy**2 + nhz**2) + 1e-20
        nhx, nhz = nhx / nlen, nhz / nlen
        won = sin_o * nhx + cos_o * nhz
        wiz = 2.0 * won * nhz - cos_o
        lam_o = _np_lambda(alpha2, cos_o)
        lam_i = _np_lambda(alpha2, np.maximum(wiz, 1e-6))
        rows.append(np.where(wiz > 0.0, (1.0 + lam_o) / (1.0 + lam_o + lam_i), 0.0).mean(axis=1))
    e = np.clip(np.stack(rows, axis=1), 1e-3, 1.0)
    grid = np.linspace(0.0, 1.0, res)
    eavg = np.clip(2.0 * _trapezoid(e * grid[:, None], grid, axis=0), 1e-3, 1.0)
    return e.astype(np.float32), eavg.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _poly_coeffs(deg: int = 6):
    e, eavg = _energy_tables()
    g = np.linspace(0.0, 1.0, E_TABLE_RES)
    cc, aa = np.meshgrid(g, g, indexing="ij")
    basis = np.stack([cc.ravel() ** i * aa.ravel() ** j
                      for i in range(deg + 1) for j in range(deg + 1)], axis=1)
    c2, *_ = np.linalg.lstsq(basis, e.ravel(), rcond=None)
    c1, *_ = np.linalg.lstsq(np.stack([g**i for i in range(deg + 1)], axis=1), eavg, rcond=None)
    return c2.reshape(deg + 1, deg + 1).astype(np.float32), c1.astype(np.float32), deg


def _lookup_e(alpha2, cos_no):
    c2, _, deg = _poly_coeffs()
    x = torch.clamp(cos_no, 0.0, 1.0)
    y = torch.clamp(alpha2, 0.0, 1.0)
    acc = torch.zeros_like(x)
    for i in range(deg, -1, -1):
        row = torch.zeros_like(x)
        for j in range(deg, -1, -1):
            row = row * y + float(c2[i, j])
        acc = acc * x + row
    return torch.clamp(acc, 1e-3, 1.0)


def _lookup_eavg(alpha2):
    _, c1, deg = _poly_coeffs()
    y = torch.clamp(alpha2, 0.0, 1.0)
    acc = torch.zeros_like(y)
    for i in range(deg, -1, -1):
        acc = acc * y + float(c1[i])
    return torch.clamp(acc, 1e-3, 1.0)


def _multiscatter(mat: Materials, cos_no):
    alpha2 = mat.alphax * mat.alphay
    e = _lookup_e(alpha2, cos_no)
    eavg = _lookup_eavg(alpha2)[..., None]
    fms = mat.trans_tint * eavg / torch.clamp(1.0 - mat.trans_tint * (1.0 - eavg), min=1e-4)
    return 1.0 + fms * ((1.0 - e) / e)[..., None]


def _oren_nayar_fcos(mat: Materials, n, wo, wi):
    pm = PI / 2.0 - 2.0 / 3.0
    a = 1.0 / (PI + pm * mat.on_sigma)
    b = a * mat.on_sigma

    def g(c0):
        small = c0 < 1e-6
        c = torch.where(small, 0.5, c0)
        s = sin_from_cos(c)
        main = s * (safe_acos(c) - 2.0 / 3.0 - s * c) + (2.0 / 3.0) * (s / c) * (1.0 - sqr(s) * s)
        return torch.where(small, pm - c0, main)

    nl = torch.clamp(dot(n, wi), min=0.0)
    nv = torch.clamp(dot(n, wo), min=0.0)
    t = dot(wi, wo) - nl * nv
    t = torch.where(t > 0.0, t / (torch.maximum(nl, nv) + 1e-38), t)
    single = a + b * t
    e_l = a * PI + b * g(nl)
    e_v = a * PI + b * g(nv)
    ms = torch.clamp(mat.albedo * (1.0 - e_v)[..., None], min=0.0) * (1.0 - e_l)[..., None]
    return mat.albedo * nl[..., None] * (single[..., None] + ms)


def _ggx_frame(ns, phi0):
    t, b = gram_schmidt(ns)
    x = torch.cos(phi0)[..., None] * t + torch.sin(phi0)[..., None] * b
    return x, cross(ns, x)


def _stack3(x, y, z):
    return torch.stack([x, y, z], dim=-1)


class BsdfSample(NamedTuple):
    wi: torch.Tensor
    f_cos: torch.Tensor
    pdf: torch.Tensor
    eta: torch.Tensor
    delta: torch.Tensor
    refract: torch.Tensor


def sample_bsdf(mat: Materials, wo, ns, ng, u1, u2, uc, inside) -> BsdfSample:
    """A direction from the gathered rows' lobes → f cos, pdf and flags."""
    valid_side = dot(wo, ng) > 0.0
    ns = face_forward(ns, ng)
    cos_no = dot(ns, wo)

    wi_d, pdf_d = sample_cos_hemisphere(ns, u1, u2)
    above = dot(ng, wi_d) > 0.0
    f_diff = torch.where(above[..., None], _oren_nayar_fcos(mat, ns, wo, wi_d), 0.0)
    pdf_diff = torch.where(above, pdf_d, 0.0)

    ax, ay = mat.alphax, mat.alphay
    is_delta = torch.maximum(ax, ay) < DELTA_ALPHA
    x_axis, y_axis = _ggx_frame(ns, mat.phi0)
    local_o = _stack3(dot(x_axis, wo), dot(y_axis, wo), cos_no)
    local_h = sample_ggx_vndf(local_o, u1, u2, ax, ay)
    h_rough = local_h[..., 0:1] * x_axis + local_h[..., 1:2] * y_axis + local_h[..., 2:3] * ns
    h = torch.where(is_delta[..., None], ns, h_rough)
    z = torch.zeros_like(cos_no)
    local_h = torch.where(is_delta[..., None], _stack3(z, z, z + 1.0), local_h)
    cos_ho = dot(h, wo)

    eta_eff = torch.where(inside, 1.0 / mat.eta, mat.eta)
    f_diel, cos_hi = fresnel_dielectric(cos_ho, eta_eff)
    reflectance = f_diel[..., None] * mat.refl_tint
    transmittance = (1.0 - f_diel)[..., None] * mat.trans_tint
    inv_eta = 1.0 / eta_eff
    wi_refl = 2.0 * cos_ho[..., None] * h - wo
    denom = torch.clamp(average3(reflectance + transmittance), min=1e-12)
    pdf_reflect = torch.clamp(average3(reflectance) / denom, 0.0, 1.0)
    do_refract = uc > pdf_reflect
    wi_g = torch.where(do_refract[..., None], refract_angle(wo, h, cos_hi, inv_eta[..., None]),
                       wi_refl)

    bad_hemi = (dot(ng, wi_g) <= 0.0) & ~do_refract
    lobe_pdf = torch.where(do_refract, 1.0 - pdf_reflect, pdf_reflect)
    f_g = torch.where(do_refract[..., None], transmittance, reflectance)

    alpha2 = ax * ay
    cos_ni = dot(ns, wi_g)
    use_iso = (ax == ay) | do_refract
    local_i = 2.0 * cos_ho[..., None] * local_h - local_o
    d_val = torch.where(use_iso, ggx_d(alpha2, local_h[..., 2]), ggx_aniso_d(ax, ay, local_h))
    lam_i = torch.where(use_iso, ggx_lambda(alpha2, cos_ni), ggx_aniso_lambda(ax, ay, local_i))
    lam_o = torch.where(use_iso, ggx_lambda(alpha2, cos_no), ggx_aniso_lambda(ax, ay, local_o))
    jac = torch.where(do_refract, torch.abs(cos_ho * cos_hi)
                      / torch.clamp(sqr(cos_hi + cos_ho * inv_eta), min=1e-8), 0.25)
    common = d_val / torch.clamp(cos_no, min=1e-6) * jac
    pdf_rough = lobe_pdf * common / (1.0 + lam_o)
    f_rough = f_g * (common / (1.0 + lam_o + lam_i))[..., None]
    f_rough = torch.where(do_refract[..., None], f_rough, f_rough * _multiscatter(mat, cos_no))
    pdf_ggx = torch.where(is_delta, lobe_pdf, pdf_rough)
    f_ggx = torch.where(is_delta[..., None], f_g * lobe_pdf[..., None], f_rough)
    zero_fres = ((average3(reflectance) < THROUGHPUT_EPS)
                 & (average3(transmittance) < THROUGHPUT_EPS))
    ggx_invalid = bad_hemi | zero_fres
    pdf_ggx = torch.where(ggx_invalid, 0.0, pdf_ggx)
    f_ggx = torch.where(ggx_invalid[..., None], 0.0, f_ggx)

    is_ggx = mat.mtype == GGX_DIELECTRIC
    wi = torch.where(is_ggx[..., None], wi_g, wi_d)
    f_cos = torch.where(is_ggx[..., None], f_ggx, f_diff)
    pdf = torch.where(is_ggx, pdf_ggx, pdf_diff)
    refract = is_ggx & do_refract & ~ggx_invalid
    eta_out = torch.where(refract, eta_eff, 1.0)
    delta = is_ggx & is_delta
    pdf = torch.where(valid_side, pdf, 0.0)
    f_cos = torch.where(valid_side[..., None], f_cos, 0.0)
    return BsdfSample(wi, f_cos, pdf, eta_out, delta, refract)


def eval_bsdf(mat: Materials, wo, wi, ns, ng, inside):
    """f cos and pdf toward given directions; delta lobes give zero."""
    valid_side = dot(wo, ng) > 0.0
    ns = face_forward(ns, ng)
    cos_no = dot(ns, wo)
    cos_ni = dot(ns, wi)
    cos_ngi = dot(ng, wi)

    diff_ok = cos_ni > 0.0
    f_diff = torch.where(diff_ok[..., None], _oren_nayar_fcos(mat, ns, wo, wi), 0.0)
    pdf_diff = torch.where(diff_ok, torch.clamp(cos_ni, min=0.0) * INV_PI, 0.0)

    ax, ay = mat.alphax, mat.alphay
    alpha2 = ax * ay
    is_delta = torch.maximum(ax, ay) < DELTA_ALPHA
    is_trans = cos_ni < 0.0
    eta_eff = torch.where(inside, 1.0 / mat.eta, mat.eta)
    ior = torch.where(is_trans, eta_eff, 1.0)
    h_raw = ior[..., None] * wi + wo
    inv_len_h = 1.0 / torch.clamp(torch.sqrt(dot(h_raw, h_raw)), min=1e-12)
    h = face_forward(h_raw * inv_len_h[..., None], ns)
    cos_ho = dot(h, wo)
    f_diel, _ = fresnel_dielectric(cos_ho, eta_eff)
    refl = f_diel[..., None] * mat.refl_tint
    trans = (1.0 - f_diel)[..., None] * mat.trans_tint

    cos_nh = dot(ns, h)
    use_iso = (ax == ay) | is_trans
    x_axis, y_axis = _ggx_frame(ns, mat.phi0)
    local_h = _stack3(dot(x_axis, h), dot(y_axis, h), cos_nh)
    local_o = _stack3(dot(x_axis, wo), dot(y_axis, wo), cos_no)
    local_i = _stack3(dot(x_axis, wi), dot(y_axis, wi), cos_ni)
    d_val = torch.where(use_iso, ggx_d(alpha2, cos_nh), ggx_aniso_d(ax, ay, local_h))
    lam_i = torch.where(use_iso, ggx_lambda(alpha2, torch.abs(cos_ni)),
                        ggx_aniso_lambda(ax, ay, local_i))
    lam_o = torch.where(use_iso, ggx_lambda(alpha2, cos_no), ggx_aniso_lambda(ax, ay, local_o))
    jac = torch.where(is_trans, sqr(ior * inv_len_h) * torch.abs(cos_ho * dot(h, wi)), 0.25)
    common = d_val / torch.clamp(cos_no, min=1e-6) * jac
    denom = torch.clamp(average3(refl + trans), min=1e-12)
    pdf_reflect = torch.clamp(average3(refl) / denom, 0.0, 1.0)
    lobe_pdf = torch.where(is_trans, 1.0 - pdf_reflect, pdf_reflect)
    pdf_ggx = lobe_pdf * common / (1.0 + lam_o)
    f_sel = torch.where(is_trans[..., None], trans, refl * _multiscatter(mat, cos_no))
    f_ggx = f_sel * (common / (1.0 + lam_o + lam_i))[..., None]
    has_refl = average3(mat.refl_tint) > THROUGHPUT_EPS
    has_trans = average3(mat.trans_tint) > THROUGHPUT_EPS
    ggx_bad = ((cos_no <= 0.0) | ((cos_ngi < 0.0) != is_trans) | is_delta
               | (~has_refl & (cos_ngi > 0.0)) | (~has_trans & (cos_ngi < 0.0)))
    pdf_ggx = torch.where(ggx_bad, 0.0, pdf_ggx)
    f_ggx = torch.where(ggx_bad[..., None], 0.0, f_ggx)

    is_ggx = mat.mtype == GGX_DIELECTRIC
    f = torch.where(is_ggx[..., None], f_ggx, f_diff)
    pdf = torch.where(is_ggx, pdf_ggx, pdf_diff)
    return torch.where(valid_side[..., None], f, 0.0), torch.where(valid_side, pdf, 0.0)


# ----------------------------------------------------------------- lights

class Lights(NamedTuple):
    ltype: torch.Tensor  # (L,) int32
    color: torch.Tensor  # (L, 3)
    pos: torch.Tensor  # (L, 3)
    direction: torch.Tensor  # (L, 3)
    cos_theta0: torch.Tensor
    cos_theta_e: torch.Tensor
    radius: torch.Tensor

    def gather(self, idx) -> "Lights":
        return Lights(*(f[idx] for f in self))


LIGHT_DEFAULTS = dict(ltype=POINT, color=(1.0, 1.0, 1.0), pos=(0.0, 0.0, 0.0),
                      direction=(0.0, 0.0, -1.0), cos_theta0=1.0, cos_theta_e=0.0, radius=1e-3)


def make_lights(rows, device, dtype) -> Lights:
    rows = [{**LIGHT_DEFAULTS, **r} for r in rows]
    bad = {r["ltype"] for r in rows} - {POINT, SPOT}
    if bad:
        raise ValueError(f"the reference knows point and spot lights, not {bad}")

    def col(name, width):
        a = np.asarray([np.broadcast_to(np.asarray(r[name], np.float32), (3,)) if width == 3
                        else r[name] for r in rows], np.float32)
        return torch.as_tensor(a, device=device).to(dtype)

    return Lights(torch.as_tensor(np.asarray([r["ltype"] for r in rows], np.int32), device=device),
                  col("color", 3), col("pos", 3), col("direction", 3), col("cos_theta0", 1),
                  col("cos_theta_e", 1), col("radius", 1))


def sample_light(lt: Lights, position, u1, u2, normal):
    """Point and spot rows: a cone toward the nucleus sphere from outside,
    a cosine hemisphere from inside; a spot samples its spread cone when
    that is tighter, attenuates by a smoothstep and re-projects the sample
    onto the sphere → (direction, pdf, distance, factor)."""
    lpos, radius = lt.pos, lt.radius
    radius_sqr = sqr(radius)
    to_p = position - lpos
    dist_sqr = torch.clamp(dot(to_p, to_p), min=1e-20)
    dist = torch.sqrt(dist_sqr)
    light_n = to_p / dist[..., None]
    outside = dist_sqr > radius_sqr
    s_sq = radius_sqr / dist_sqr
    omc_sphere = torch.where(s_sq > 0.0004, 1.0 - safe_sqrt(1.0 - s_sq), 0.5 * s_sq)
    d_out, cos_out, pdf_out, delta_out = sample_uniform_cone(-light_n, omc_sphere, u1, u2)
    d_in, pdf_in = sample_cos_hemisphere(normal, u1, u2)
    cos_in = -dot(d_in, light_n)
    d = torch.where(outside[..., None], d_out, d_in)
    cos_theta = torch.where(outside, cos_out, cos_in)
    pdf = torch.where(outside, pdf_out, pdf_in)
    delta = outside & (delta_out | ((radius / dist) < 1e-3))
    pdf = torch.where(delta, 1.0, pdf)
    distance = dist * cos_theta - torch.copysign(
        safe_sqrt(radius_sqr - dist_sqr + dist_sqr * sqr(cos_theta)), dist_sqr - radius_sqr)
    p_light = position + d * distance[..., None]
    factor = torch.ones_like(dist)

    is_spot = lt.ltype == SPOT
    spot_dir = lt.direction
    omc_spread = 1.0 - lt.cos_theta_e
    toward_apex = omc_sphere < omc_spread
    d_cone, _, pdf_cone, delta_cone = sample_uniform_cone(-spot_dir, omc_spread, u1, u2)
    hit_s, t_s, p_s = ray_sphere_intersect(position, d_cone, 0.0, BIG_DIST, lpos, radius)
    use_cone = is_spot & outside & ~toward_apex
    d = torch.where(use_cone[..., None], d_cone, d)
    pdf = torch.where(use_cone, torch.where(hit_s, pdf_cone, 0.0), pdf)
    distance = torch.where(use_cone, t_s, distance)
    p_light = torch.where(use_cone[..., None], p_s, p_light)

    att = smoothstep(lt.cos_theta_e, lt.cos_theta0, dot(-d, spot_dir))
    factor = torch.where(is_spot, att, factor)
    pdf = torch.where(is_spot & (att <= 0.0), 0.0, pdf)
    eff_delta = is_spot & ((radius / dist) < 1e-3) & (pdf > 0.0)
    pdf = torch.where(eff_delta, 1.0, pdf)
    spot_like = is_spot & (pdf > 0.0)
    p_proj = normalize(p_light - lpos) * radius[..., None] + lpos
    new_dir = p_proj - position
    new_dist = length(new_dir)
    proj_ok = spot_like & (new_dist > 1e-8)
    d = torch.where(proj_ok[..., None], new_dir / torch.clamp(new_dist, min=1e-8)[..., None], d)
    distance = torch.where(proj_ok, new_dist, distance)
    return d, pdf, distance, factor


def eval_light(lt: Lights, distance, factor):
    """Intensity x angular factor, with inverse-square falloff."""
    le = lt.color * factor[..., None]
    return le * (1.0 / torch.clamp(sqr(distance), min=1e-12))[..., None]

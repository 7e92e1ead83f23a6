"""BSDF library: Lambert, Oren-Nayar (energy-compensated), GGX dielectric
and GGX conductor (counterpart of the reference ``ops/bsdf.py``).

Materials live in an SoA table; per-hit rows are gathered by index and
all four models are evaluated as masked dense tensor code. ``sample`` and
``eval`` return f·cosθᵢ including albedo/Fresnel exactly once; the
integrator applies ``beta *= f/pdf``. GGX multiple scattering follows
Kulla–Conty with E/Eavg tables computed by numerical integration and
compressed into polynomials; ``ggx_energy_tables`` and ``_e_poly_coeffs``
are the reference's deterministic numpy, copied verbatim, so the
coefficients are equal. Type codes match the reference enum.

Texture ids (albedo, roughness, normal map; −1 for none) index the
scene's texture pool; the integrator replaces the gathered constants by
texture fetches at the hit (``models/megakernel._textured_mat``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .sampling import sample_cos_hemisphere, sample_uniform_disk
from .vecmath import (
    INV_PI,
    PI,
    average3,
    cross,
    dot,
    face_forward,
    gram_schmidt,
    lerp,
    normalize,
    refract_angle,
    safe_acos,
    safe_sqrt,
    sin_from_cos,
    sqr,
)

OREN_NAYAR = 0
GGX_DIELECTRIC = 1
GGX_CONDUCTOR = 2
LAMBERT = 3

DELTA_ALPHA = 1e-3  # below this roughness GGX is treated as specular
THROUGHPUT_EPS = 1e-6


@dataclass(frozen=True)
class MatFeatures:
    """Which material lobes a scene uses; the plain evaluators drop the
    code for absent lobes. The CUDA kernel branches per thread instead."""

    oren_nayar: bool = True
    lambert: bool = True
    ggx: bool = True
    conductor: bool = True
    transmission: bool = True
    aniso: bool = True

    @property
    def diffuse(self) -> bool:
        return self.oren_nayar or self.lambert


ALL_FEATURES = MatFeatures()


class MaterialTable(NamedTuple):
    """SoA material parameters; rows indexed by material id."""

    mtype: torch.Tensor  # (M,) int32
    albedo: torch.Tensor  # (M,3) ON/Lambert albedo
    on_sigma: torch.Tensor  # (M,)
    alphax: torch.Tensor  # (M,)
    alphay: torch.Tensor  # (M,)
    phi0: torch.Tensor  # (M,) anisotropy azimuth
    eta: torch.Tensor  # (M,) dielectric IOR
    refl_tint: torch.Tensor  # (M,3)
    trans_tint: torch.Tensor  # (M,3)
    cond_eta: torch.Tensor  # (M,3)
    cond_k: torch.Tensor  # (M,3)
    emission: torch.Tensor  # (M,3) emitted radiance (area lights)
    albedo_tex: torch.Tensor  # (M,) int32 texture id of the albedo, -1 none
    rough_tex: torch.Tensor  # (M,) int32 roughness texture id, -1 none
    normal_tex: torch.Tensor  # (M,) int32 normal-map texture id, -1 none

    def gather(self, idx, textured: bool = True) -> "MaterialTable":
        """Rows ``idx`` of every column; without ``textured`` the texture
        ids are left out (None): a scene without textures reads none."""
        if textured:
            return MaterialTable(*(f[idx] for f in self))
        return MaterialTable(*(f[idx] for f in self[:-3]), None, None, None)


def mat_features_from_table(t: MaterialTable) -> MatFeatures:
    """Feature set of a concrete material table (read through
    ``.detach()``, so a table of optimised parameters works too)."""
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    mtype = host(t.mtype)
    types = set(mtype.tolist())
    ggx_rows = np.isin(mtype, (GGX_DIELECTRIC, GGX_CONDUCTOR))
    ax = host(t.alphax)[ggx_rows]
    ay = host(t.alphay)[ggx_rows]
    diel_rows = mtype == GGX_DIELECTRIC
    has_trans = bool(
        np.any(
            np.max(host(t.trans_tint)[diel_rows], axis=-1, initial=0.0)
            > THROUGHPUT_EPS
        )
    )
    return MatFeatures(
        oren_nayar=OREN_NAYAR in types,
        lambert=LAMBERT in types,
        ggx=bool(ggx_rows.any()),
        conductor=GGX_CONDUCTOR in types,
        transmission=has_trans,
        aniso=bool(np.any(np.abs(ax - ay) > 1e-6)),
    )


def oren_nayar(color, roughness: float) -> dict:
    """Oren-Nayar: sigma in radians [0, π/2]."""
    return dict(
        mtype=OREN_NAYAR,
        albedo=np.clip(np.asarray(color, np.float32), 0.0, 1.0),
        on_sigma=float(np.clip(roughness, 0.0, np.pi / 2)),
    )


def lambert(color=(1.0, 1.0, 1.0)) -> dict:
    return dict(mtype=LAMBERT, albedo=np.asarray(color, np.float32))


def diffuse_light(radiance, color=(0.0, 0.0, 0.0)) -> dict:
    """Emissive (area-light) material; ``color`` is the surface albedo."""
    return dict(
        mtype=LAMBERT,
        albedo=np.asarray(color, np.float32),
        emission=np.asarray(radiance, np.float32),
    )


def ggx_dielectric(refl_tint, trans_tint, phi0, eta, alphax, alphay) -> dict:
    return dict(
        mtype=GGX_DIELECTRIC,
        refl_tint=np.asarray(refl_tint, np.float32),
        trans_tint=np.asarray(trans_tint, np.float32),
        phi0=float(phi0),
        eta=float(eta),
        alphax=float(alphax),
        alphay=float(alphay),
    )


def ggx_conductor(eta, k, phi0, alphax, alphay) -> dict:
    return dict(
        mtype=GGX_CONDUCTOR,
        cond_eta=np.asarray(eta, np.float32),
        cond_k=np.asarray(k, np.float32),
        phi0=float(phi0),
        alphax=float(alphax),
        alphay=float(alphay),
    )


_DEFAULTS = dict(
    mtype=LAMBERT,
    albedo=(1.0, 1.0, 1.0),
    on_sigma=0.0,
    alphax=0.5,
    alphay=0.5,
    phi0=0.0,
    eta=1.5,
    refl_tint=(1.0, 1.0, 1.0),
    trans_tint=(0.0, 0.0, 0.0),
    cond_eta=(0.2, 0.4, 1.3),
    cond_k=(3.4, 2.3, 1.7),
    emission=(0.0, 0.0, 0.0),
    albedo_tex=-1,
    rough_tex=-1,
    normal_tex=-1,
)


def make_material_table(materials: Sequence[dict], device=None) -> MaterialTable:
    """Build the SoA table from factory dicts."""
    rows = []
    for m in materials:
        d = dict(_DEFAULTS)
        d.update(m)
        rows.append(d)

    def col(name, width):
        if width == 1:
            a = np.asarray([r[name] for r in rows], np.float32)
        else:
            a = np.asarray(
                [np.broadcast_to(r[name], (3,)) for r in rows], np.float32
            )
        return torch.as_tensor(a, device=device)

    return MaterialTable(
        mtype=torch.as_tensor(
            np.asarray([r["mtype"] for r in rows], np.int32), device=device
        ),
        albedo=col("albedo", 3),
        on_sigma=col("on_sigma", 1),
        alphax=col("alphax", 1),
        alphay=col("alphay", 1),
        phi0=col("phi0", 1),
        eta=col("eta", 1),
        refl_tint=col("refl_tint", 3),
        trans_tint=col("trans_tint", 3),
        cond_eta=col("cond_eta", 3),
        cond_k=col("cond_k", 3),
        emission=col("emission", 3),
        **{
            name: torch.as_tensor(np.asarray([r[name] for r in rows], np.int32), device=device)
            for name in ("albedo_tex", "rough_tex", "normal_tex")
        },
    )


# ---------------------------------------------------------------------------
# GGX microfacet pieces (jcgt.org/published/0003/02/03, VNDF 0007/04/01)
# ---------------------------------------------------------------------------


def ggx_lambda_from_sqr_alpha_tan(s):
    return 0.5 * (torch.sqrt(1.0 + s) - 1.0)


def ggx_d(alpha2, cos_nh):
    cos2 = torch.clamp(sqr(cos_nh), max=1.0)
    return alpha2 / (PI * sqr((1.0 - cos2) + alpha2 * cos2))


def ggx_lambda(alpha2, cos_n):
    s = alpha2 * torch.clamp(
        1.0 / torch.clamp(sqr(cos_n), min=1e-12) - 1.0, min=0.0
    )
    return ggx_lambda_from_sqr_alpha_tan(s)


def ggx_aniso_d(alphax, alphay, local_h):
    hx = local_h[..., 0] / alphax
    hy = local_h[..., 1] / alphay
    hz = local_h[..., 2]
    alpha2 = alphax * alphay
    len2 = hx * hx + hy * hy + hz * hz
    return INV_PI / torch.clamp(alpha2 * sqr(len2), min=1e-20)


def ggx_aniso_lambda(alphax, alphay, v):
    s = (sqr(alphax * v[..., 0]) + sqr(alphay * v[..., 1])) / torch.clamp(
        sqr(v[..., 2]), min=1e-12
    )
    return ggx_lambda_from_sqr_alpha_tan(s)


def sample_ggx_vndf(local_o, u1, u2, ax, ay):
    """Heitz 2018 VNDF sampling in tangent space → local half vector."""
    v = normalize(
        torch.stack([ax * local_o[..., 0], ay * local_o[..., 1], local_o[..., 2]], dim=-1)
    )
    lensq = sqr(v[..., 0]) + sqr(v[..., 1])
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-14))
    use_frame = (lensq > 1e-7)[..., None]
    zero = torch.zeros_like(inv_len)
    t1 = torch.where(
        use_frame,
        torch.stack([-v[..., 1] * inv_len, v[..., 0] * inv_len, zero], dim=-1),
        torch.stack([zero + 1.0, zero, zero], dim=-1),
    )
    t2 = torch.where(
        use_frame, cross(v, t1), torch.stack([zero, zero + 1.0, zero], dim=-1)
    )
    dx, dy = sample_uniform_disk(u1, u2)
    dy = lerp(safe_sqrt(1.0 - sqr(dx)), dy, 0.5 * (1.0 + v[..., 2]))
    nh = (
        dx[..., None] * t1
        + dy[..., None] * t2
        + safe_sqrt(1.0 - sqr(dx) - sqr(dy))[..., None] * v
    )
    return normalize(
        torch.stack(
            [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)],
            dim=-1,
        )
    )


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance and transmitted cosine; ``eta`` is
    outside/inside for the current side. Returns (F, cos_theta_t)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_i = safe_sqrt(1.0 - sqr(cos_i))
    sin_t = sin_i / eta
    tir = sin_t >= 1.0
    cos_t = safe_sqrt(1.0 - sqr(sin_t))
    r_parl = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    f = 0.5 * (sqr(r_parl) + sqr(r_perp))
    return torch.where(tir, 1.0, f), cos_t


def fresnel_conductor(cos_i, eta, k):
    """RGB conductor Fresnel; eta, k are (..., 3)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)[..., None]
    cos2 = sqr(cos_i)
    sin2 = 1.0 - cos2
    eta2, k2 = sqr(eta), sqr(k)
    t0 = eta2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp(sqr(t0) + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * cos_i * a
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = cos2 * a2b2 + sqr(sin2)
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


# ---------------------------------------------------------------------------
# GGX energy-preservation tables (computed, not copied) — verbatim numpy
# ---------------------------------------------------------------------------

E_TABLE_RES = 32

# numpy >= 2 renamed trapz; the result is identical
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@functools.lru_cache(maxsize=1)
def ggx_energy_tables():
    """Directional albedo E(cosθo, α²) of single-scatter GGX (Fresnel = 1)
    and its cosine-weighted average Eavg(α²), by stratified 64×64
    VNDF-estimator integration per cell."""
    res = E_TABLE_RES
    ns = 64
    u1, u2 = np.meshgrid(
        (np.arange(ns) + 0.5) / ns, (np.arange(ns) + 0.5) / ns, indexing="ij"
    )
    u1 = u1.reshape(1, -1)
    u2 = u2.reshape(1, -1)

    cos_o = np.linspace(0.0, 1.0, res).reshape(-1, 1)
    cos_o = np.clip(cos_o, 1e-3, 1.0)
    sin_o = np.sqrt(1.0 - cos_o**2)

    e_rows = []
    alpha2_grid = np.clip(np.linspace(0.0, 1.0, res), 1e-6, 1.0)
    for alpha2 in alpha2_grid:
        alpha = np.sqrt(alpha2)
        vx = alpha * sin_o
        vz = cos_o
        norm = np.sqrt(vx**2 + vz**2)
        vx, vz = vx / norm, vz / norm  # stretched view
        dx, dy = _np_concentric_disk(u1, u2)
        dy = (1.0 - 0.5 * (1.0 + vz)) * np.sqrt(np.maximum(1.0 - dx**2, 0.0)) + 0.5 * (
            1.0 + vz
        ) * dy
        dz = np.sqrt(np.maximum(1.0 - dx**2 - dy**2, 0.0))
        # nh = dx*t2 + dy*t1 + dz*v  (t2 = (-vz, 0, vx))
        nhx = dx * (-vz) + dz * vx
        nhy = dy
        nhz = dx * vx + dz * vz
        nhx *= alpha
        nhy *= alpha
        nhz = np.maximum(nhz, 0.0)
        nlen = np.sqrt(nhx**2 + nhy**2 + nhz**2) + 1e-20
        nhx, nhy, nhz = nhx / nlen, nhy / nlen, nhz / nlen
        won = sin_o * nhx + cos_o * nhz
        wiz = 2.0 * won * nhz - cos_o
        lam_o = _np_ggx_lambda(alpha2, cos_o)
        lam_i = _np_ggx_lambda(alpha2, np.maximum(wiz, 1e-6))
        contrib = np.where(wiz > 0.0, (1.0 + lam_o) / (1.0 + lam_o + lam_i), 0.0)
        e_rows.append(contrib.mean(axis=1))
    e = np.stack(e_rows, axis=1)  # (cos_idx, alpha_idx)
    e = np.clip(e, 1e-3, 1.0)
    cgrid = np.linspace(0.0, 1.0, res)
    eavg = 2.0 * _trapezoid(e * cgrid[:, None], cgrid, axis=0)
    eavg = np.clip(eavg, 1e-3, 1.0)
    return e.astype(np.float32), eavg.astype(np.float32)


def _np_concentric_disk(u1, u2):
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    a_dom = np.abs(a) > np.abs(b)
    rho = np.where(a_dom, a, b)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(a_dom, b / a, a / b)
    ratio = np.nan_to_num(ratio)
    phi = np.where(a_dom, (np.pi / 4) * ratio, np.pi / 2 - (np.pi / 4) * ratio)
    zero = (a == 0) & (b == 0)
    return np.where(zero, 0.0, rho * np.cos(phi)), np.where(zero, 0.0, rho * np.sin(phi))


def _np_ggx_lambda(alpha2, cos_n):
    s = alpha2 * np.maximum(0.0, 1.0 / np.maximum(cos_n**2, 1e-12) - 1.0)
    return 0.5 * (np.sqrt(1.0 + s) - 1.0)


@functools.lru_cache(maxsize=1)
def _e_poly_coeffs(deg: int = 6):
    """Least-squares tensor-product polynomial fit of E(cosθo, α²) and a
    1D fit of Eavg(α²): (coef2d (deg+1, deg+1), coef1d (deg+1,), deg)."""
    e, eavg = ggx_energy_tables()
    res = E_TABLE_RES
    c = np.linspace(0.0, 1.0, res)
    a = np.linspace(0.0, 1.0, res)
    cc, aa = np.meshgrid(c, a, indexing="ij")
    basis = np.stack(
        [cc.ravel() ** i * aa.ravel() ** j for i in range(deg + 1) for j in range(deg + 1)],
        axis=1,
    )
    coef2d, *_ = np.linalg.lstsq(basis, e.ravel(), rcond=None)
    basis1 = np.stack([a**i for i in range(deg + 1)], axis=1)
    coef1d, *_ = np.linalg.lstsq(basis1, eavg, rcond=None)
    return (
        coef2d.reshape(deg + 1, deg + 1).astype(np.float32),
        coef1d.astype(np.float32),
        deg,
    )


def lookup_e(alpha2, cos_no):
    """E(cosθo, α²) via the polynomial fit (Horner in y inside x)."""
    coef2d, _, deg = _e_poly_coeffs()
    x = torch.clamp(cos_no, 0.0, 1.0)
    y = torch.clamp(alpha2, 0.0, 1.0)
    acc = torch.zeros_like(x)
    for i in range(deg, -1, -1):
        row = torch.zeros_like(x)
        for j in range(deg, -1, -1):
            row = row * y + float(coef2d[i, j])
        acc = acc * x + row
    return torch.clamp(acc, 1e-3, 1.0)


def lookup_eavg(alpha2):
    _, coef1d, deg = _e_poly_coeffs()
    y = torch.clamp(alpha2, 0.0, 1.0)
    acc = torch.zeros_like(y)
    for i in range(deg, -1, -1):
        acc = acc * y + float(coef1d[i])
    return torch.clamp(acc, 1e-3, 1.0)


def ggx_multiscatter_factor(mat: MaterialTable, cos_no, ft: MatFeatures = ALL_FEATURES):
    """(N,3) multiple-scattering multiplier 1 + Fms·(1-E)/E (Kulla–Conty);
    Fss is the transmittance tint (dielectric) or the F82-tint fit
    (conductor)."""
    alpha2 = mat.alphax * mat.alphay
    e = lookup_e(alpha2, cos_no)
    eavg = lookup_eavg(alpha2)
    if ft.conductor:
        f0 = fresnel_conductor(torch.ones_like(cos_no), mat.cond_eta, mat.cond_k)
        f82 = fresnel_conductor(
            torch.full_like(cos_no, 1.0 / 7.0), mat.cond_eta, mat.cond_k
        )
        one = torch.ones_like(f0)
        b = (lerp(f0, one, 0.46266436) - f82) * 17.651384
        fss_cond = lerp(f0, one, 1.0 / 21.0) - b * (1.0 / 126.0)
        fss = torch.where(
            (mat.mtype == GGX_CONDUCTOR)[..., None], fss_cond, mat.trans_tint
        )
    else:
        fss = mat.trans_tint
    missing = (1.0 - e) / e
    fms = fss * eavg[..., None] / torch.clamp(
        1.0 - fss * (1.0 - eavg[..., None]), min=1e-4
    )
    return 1.0 + fms * missing[..., None]


# ---------------------------------------------------------------------------
# Oren-Nayar (Fujii improved model + OpenPBR-style multiscatter)
# ---------------------------------------------------------------------------


def oren_nayar_ab(sigma):
    a = 1.0 / (PI + (PI / 2.0 - 2.0 / 3.0) * sigma)
    return a, a * sigma


def oren_nayar_g(cos_theta):
    pm = PI / 2.0 - 2.0 / 3.0
    small = cos_theta < 1e-6
    c = torch.where(small, 0.5, cos_theta)
    sin_t = sin_from_cos(c)
    theta = safe_acos(c)
    main = sin_t * (theta - 2.0 / 3.0 - sin_t * c) + (2.0 / 3.0) * (sin_t / c) * (
        1.0 - sqr(sin_t) * sin_t
    )
    return torch.where(small, pm - cos_theta, main)


def _oren_nayar_fcos(mat: MaterialTable, n, wo, wi):
    """f·cosθᵢ for Oren-Nayar including albedo (N,3)."""
    a, b = oren_nayar_ab(mat.on_sigma)
    nl = torch.clamp(dot(n, wi), min=0.0)
    nv = torch.clamp(dot(n, wo), min=0.0)
    t = dot(wi, wo) - nl * nv
    t = torch.where(t > 0.0, t / (torch.maximum(nl, nv) + 1e-38), t)
    single = a + b * t
    e_l = a * PI + b * oren_nayar_g(nl)
    e_v = a * PI + b * oren_nayar_g(nv)
    ms = torch.clamp(mat.albedo * (1.0 - e_v)[..., None], min=0.0) * (1.0 - e_l)[..., None]
    return mat.albedo * nl[..., None] * (single[..., None] + ms)


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # (N,3)
    f_cos: torch.Tensor  # (N,3) f·|cosθi| (0 where invalid)
    pdf: torch.Tensor  # (N,) solid-angle pdf (0 where invalid)
    eta: torch.Tensor  # (N,) relative IOR crossed (1 for reflection)
    delta: torch.Tensor  # (N,) bool
    refract: torch.Tensor  # (N,) bool


def _ggx_frame(ns, phi0):
    """Tangent frame rotated by phi0 around ns."""
    t, b = gram_schmidt(ns)
    c = torch.cos(phi0)[..., None]
    s = torch.sin(phi0)[..., None]
    x = c * t + s * b
    return x, cross(ns, x)


def _eta_for_side(mat_eta, inside):
    return torch.where(inside, 1.0 / mat_eta, mat_eta)


def _stack3(x, y, z):
    return torch.stack([x, y, z], dim=-1)


def sample_bsdf(
    mat: MaterialTable, wo, ns, ng, u1, u2, uc, inside=None,
    ft: MatFeatures = ALL_FEATURES,
) -> BsdfSample:
    """Sample the gathered material rows. ``inside`` marks rays inside a
    dielectric (flips eta); ``ft`` drops lobes the scene does not use."""
    n = wo.shape[0]
    dev = wo.device
    if inside is None:
        inside = torch.zeros((n,), dtype=torch.bool, device=dev)

    valid_side = dot(wo, ng) > 0.0
    ns = face_forward(ns, ng)
    cos_no = dot(ns, wo)

    if ft.diffuse:
        wi_d, pdf_d = sample_cos_hemisphere(ns, u1, u2)
        above = dot(ng, wi_d) > 0.0
        if ft.oren_nayar and ft.lambert:
            f_on = _oren_nayar_fcos(mat, ns, wo, wi_d)
            f_lam = mat.albedo * pdf_d[..., None]
            f_diff = torch.where((mat.mtype == OREN_NAYAR)[..., None], f_on, f_lam)
        elif ft.oren_nayar:
            f_diff = _oren_nayar_fcos(mat, ns, wo, wi_d)
        else:
            f_diff = mat.albedo * pdf_d[..., None]
        f_diff = torch.where(above[..., None], f_diff, 0.0)
        pdf_diff = torch.where(above, pdf_d, 0.0)
    else:
        wi_d = wo
        f_diff = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        pdf_diff = torch.zeros((n,), dtype=torch.float32, device=dev)

    if ft.ggx:
        ax, ay = mat.alphax, mat.alphay
        is_delta = torch.maximum(ax, ay) < DELTA_ALPHA
        x_axis, y_axis = _ggx_frame(ns, mat.phi0)
        local_o = _stack3(dot(x_axis, wo), dot(y_axis, wo), cos_no)
        local_h = sample_ggx_vndf(local_o, u1, u2, ax, ay)
        h_rough = (
            local_h[..., 0:1] * x_axis
            + local_h[..., 1:2] * y_axis
            + local_h[..., 2:3] * ns
        )
        h = torch.where(is_delta[..., None], ns, h_rough)
        z = torch.zeros_like(cos_no)
        local_h = torch.where(is_delta[..., None], _stack3(z, z, z + 1.0), local_h)
        cos_ho = dot(h, wo)

        eta_eff = _eta_for_side(mat.eta, inside)
        f_diel, cos_hi = fresnel_dielectric(cos_ho, eta_eff)
        refl_diel = f_diel[..., None] * mat.refl_tint
        trans_diel = (1.0 - f_diel)[..., None] * mat.trans_tint
        if ft.conductor:
            refl_cond = fresnel_conductor(cos_ho, mat.cond_eta, mat.cond_k)
            conductor = (mat.mtype == GGX_CONDUCTOR)[..., None]
            reflectance = torch.where(conductor, refl_cond, refl_diel)
            transmittance = torch.where(conductor, 0.0, trans_diel)
        else:
            reflectance = refl_diel
            transmittance = trans_diel

        inv_eta = 1.0 / eta_eff
        wi_refl = 2.0 * cos_ho[..., None] * h - wo
        if ft.transmission:
            denom = torch.clamp(average3(reflectance + transmittance), min=1e-12)
            pdf_reflect = torch.clamp(average3(reflectance) / denom, 0.0, 1.0)
            do_refract = uc > pdf_reflect
            wi_refr = refract_angle(wo, h, cos_hi, inv_eta[..., None])
            wi_g = torch.where(do_refract[..., None], wi_refr, wi_refl)
        else:
            pdf_reflect = torch.ones((n,), dtype=torch.float32, device=dev)
            do_refract = torch.zeros((n,), dtype=torch.bool, device=dev)
            wi_g = wi_refl

        bad_hemi = (dot(ng, wi_g) <= 0.0) & ~do_refract
        lobe_pdf = torch.where(do_refract, 1.0 - pdf_reflect, pdf_reflect)
        f_g = torch.where(do_refract[..., None], transmittance, reflectance)

        alpha2 = ax * ay
        cos_ni = dot(ns, wi_g)
        d_iso = ggx_d(alpha2, local_h[..., 2])
        lam_i_iso = ggx_lambda(alpha2, cos_ni)
        lam_o_iso = ggx_lambda(alpha2, cos_no)
        if ft.aniso:
            use_iso = (ax == ay) | do_refract
            local_i = 2.0 * cos_ho[..., None] * local_h - local_o
            d_val = torch.where(use_iso, d_iso, ggx_aniso_d(ax, ay, local_h))
            lam_i = torch.where(use_iso, lam_i_iso, ggx_aniso_lambda(ax, ay, local_i))
            lam_o = torch.where(use_iso, lam_o_iso, ggx_aniso_lambda(ax, ay, local_o))
        else:
            d_val, lam_i, lam_o = d_iso, lam_i_iso, lam_o_iso

        if ft.transmission:
            jac = torch.where(
                do_refract,
                torch.abs(cos_ho * cos_hi)
                / torch.clamp(sqr(cos_hi + cos_ho * inv_eta), min=1e-8),
                0.25,
            )
        else:
            jac = 0.25
        common = d_val / torch.clamp(cos_no, min=1e-6) * jac
        pdf_rough = lobe_pdf * common / (1.0 + lam_o)
        f_rough = f_g * (common / (1.0 + lam_o + lam_i))[..., None]
        ms = ggx_multiscatter_factor(mat, cos_no, ft)
        f_rough = torch.where(do_refract[..., None], f_rough, f_rough * ms)

        # delta lobe: f/pdf must equal the Fresnel-weighted tint; pdf = 1
        pdf_ggx = torch.where(is_delta, lobe_pdf, pdf_rough)
        f_ggx = torch.where(is_delta[..., None], f_g * lobe_pdf[..., None], f_rough)

        zero_fres = (average3(reflectance) < THROUGHPUT_EPS) & (
            average3(transmittance) < THROUGHPUT_EPS
        )
        ggx_invalid = bad_hemi | zero_fres
        pdf_ggx = torch.where(ggx_invalid, 0.0, pdf_ggx)
        f_ggx = torch.where(ggx_invalid[..., None], 0.0, f_ggx)

        if ft.diffuse:
            is_ggx = (mat.mtype == GGX_DIELECTRIC) | (mat.mtype == GGX_CONDUCTOR)
            wi = torch.where(is_ggx[..., None], wi_g, wi_d)
            f_cos = torch.where(is_ggx[..., None], f_ggx, f_diff)
            pdf = torch.where(is_ggx, pdf_ggx, pdf_diff)
        else:
            is_ggx = torch.ones((n,), dtype=torch.bool, device=dev)
            wi, f_cos, pdf = wi_g, f_ggx, pdf_ggx
        refract = is_ggx & do_refract & ~ggx_invalid
        eta_out = torch.where(refract, eta_eff, 1.0)
        delta = is_ggx & is_delta
    else:
        wi, f_cos, pdf = wi_d, f_diff, pdf_diff
        refract = torch.zeros((n,), dtype=torch.bool, device=dev)
        eta_out = torch.ones((n,), dtype=torch.float32, device=dev)
        delta = torch.zeros((n,), dtype=torch.bool, device=dev)

    pdf = torch.where(valid_side, pdf, 0.0)
    f_cos = torch.where(valid_side[..., None], f_cos, 0.0)
    return BsdfSample(wi, f_cos, pdf, eta_out, delta, refract)


def eval_bsdf(mat: MaterialTable, wo, wi, ns, ng, inside=None,
              ft: MatFeatures = ALL_FEATURES):
    """f·cosθᵢ (N,3) and pdf (N,) toward given directions (NEE/MIS);
    delta lobes evaluate to zero."""
    n = wo.shape[0]
    dev = wo.device
    if inside is None:
        inside = torch.zeros((n,), dtype=torch.bool, device=dev)
    valid_side = dot(wo, ng) > 0.0
    ns = face_forward(ns, ng)
    cos_no = dot(ns, wo)
    cos_ni = dot(ns, wi)
    cos_ngi = dot(ng, wi)

    if ft.diffuse:
        f_lam = mat.albedo * torch.clamp(cos_ni, min=0.0)[..., None] * INV_PI
        if ft.oren_nayar and ft.lambert:
            f_on = _oren_nayar_fcos(mat, ns, wo, wi)
            f_diff = torch.where((mat.mtype == OREN_NAYAR)[..., None], f_on, f_lam)
        elif ft.oren_nayar:
            f_diff = _oren_nayar_fcos(mat, ns, wo, wi)
        else:
            f_diff = f_lam
        pdf_diff = torch.clamp(cos_ni, min=0.0) * INV_PI
        diff_ok = cos_ni > 0.0
        f_diff = torch.where(diff_ok[..., None], f_diff, 0.0)
        pdf_diff = torch.where(diff_ok, pdf_diff, 0.0)
    else:
        f_diff = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        pdf_diff = torch.zeros((n,), dtype=torch.float32, device=dev)

    if not ft.ggx:
        pdf = torch.where(valid_side, pdf_diff, 0.0)
        f = torch.where(valid_side[..., None], f_diff, 0.0)
        return f, pdf

    ax, ay = mat.alphax, mat.alphay
    alpha2 = ax * ay
    is_delta = torch.maximum(ax, ay) < DELTA_ALPHA
    conductor = mat.mtype == GGX_CONDUCTOR
    if ft.transmission:
        is_trans = cos_ni < 0.0
    else:
        is_trans = torch.zeros((n,), dtype=torch.bool, device=dev)
    eta_eff = _eta_for_side(mat.eta, inside)
    if ft.transmission:
        ior = torch.where(is_trans, eta_eff, 1.0)
        h_raw = ior[..., None] * wi + wo
    else:
        ior = torch.ones((n,), dtype=torch.float32, device=dev)
        h_raw = wi + wo
    inv_len_h = 1.0 / torch.clamp(torch.sqrt(dot(h_raw, h_raw)), min=1e-12)
    h = h_raw * inv_len_h[..., None]
    h = face_forward(h, ns)
    cos_ho = dot(h, wo)
    f_diel, _ = fresnel_dielectric(cos_ho, eta_eff)
    if ft.conductor:
        refl = torch.where(
            conductor[..., None],
            fresnel_conductor(cos_ho, mat.cond_eta, mat.cond_k),
            f_diel[..., None] * mat.refl_tint,
        )
        trans = torch.where(
            conductor[..., None], 0.0, (1.0 - f_diel)[..., None] * mat.trans_tint
        )
    else:
        refl = f_diel[..., None] * mat.refl_tint
        trans = (1.0 - f_diel)[..., None] * mat.trans_tint

    cos_nh = dot(ns, h)
    d_iso = ggx_d(alpha2, cos_nh)
    lam_i_iso = ggx_lambda(alpha2, torch.abs(cos_ni))
    lam_o_iso = ggx_lambda(alpha2, cos_no)
    if ft.aniso:
        use_iso = (ax == ay) | is_trans
        x_axis, y_axis = _ggx_frame(ns, mat.phi0)
        local_h = _stack3(dot(x_axis, h), dot(y_axis, h), cos_nh)
        local_o = _stack3(dot(x_axis, wo), dot(y_axis, wo), cos_no)
        local_i = _stack3(dot(x_axis, wi), dot(y_axis, wi), cos_ni)
        d_val = torch.where(use_iso, d_iso, ggx_aniso_d(ax, ay, local_h))
        lam_i = torch.where(use_iso, lam_i_iso, ggx_aniso_lambda(ax, ay, local_i))
        lam_o = torch.where(use_iso, lam_o_iso, ggx_aniso_lambda(ax, ay, local_o))
    else:
        d_val, lam_i, lam_o = d_iso, lam_i_iso, lam_o_iso

    if ft.transmission:
        jac = torch.where(
            is_trans,
            sqr(ior * inv_len_h) * torch.abs(cos_ho * dot(h, wi)),
            0.25,
        )
    else:
        jac = 0.25
    common = d_val / torch.clamp(cos_no, min=1e-6) * jac
    if ft.transmission:
        denom = torch.clamp(average3(refl + trans), min=1e-12)
        pdf_reflect = torch.clamp(average3(refl) / denom, 0.0, 1.0)
        lobe_pdf = torch.where(is_trans, 1.0 - pdf_reflect, pdf_reflect)
    else:
        lobe_pdf = torch.ones((n,), dtype=torch.float32, device=dev)
    pdf_ggx = lobe_pdf * common / (1.0 + lam_o)
    ms = ggx_multiscatter_factor(mat, cos_no, ft)
    f_sel = torch.where(is_trans[..., None], trans, refl * ms)
    f_ggx = f_sel * (common / (1.0 + lam_o + lam_i))[..., None]

    has_refl_tint = average3(mat.refl_tint) > THROUGHPUT_EPS
    has_trans_tint = average3(mat.trans_tint) > THROUGHPUT_EPS
    if ft.conductor:
        has_refl = conductor | has_refl_tint
        has_trans = ~conductor & has_trans_tint
    else:
        has_refl, has_trans = has_refl_tint, has_trans_tint
    ggx_bad = (
        (cos_no <= 0.0)
        | ((cos_ngi < 0.0) != is_trans)
        | is_delta
        | (~has_refl & (cos_ngi > 0.0))
        | (~has_trans & (cos_ngi < 0.0))
    )
    pdf_ggx = torch.where(ggx_bad, 0.0, pdf_ggx)
    f_ggx = torch.where(ggx_bad[..., None], 0.0, f_ggx)

    if ft.diffuse:
        is_ggx = (mat.mtype == GGX_DIELECTRIC) | (mat.mtype == GGX_CONDUCTOR)
        f = torch.where(is_ggx[..., None], f_ggx, f_diff)
        pdf = torch.where(is_ggx, pdf_ggx, pdf_diff)
    else:
        f, pdf = f_ggx, pdf_ggx
    pdf = torch.where(valid_side, pdf, 0.0)
    f = torch.where(valid_side[..., None], f, 0.0)
    return f, pdf

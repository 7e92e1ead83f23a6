"""Image textures: one flat mip pool, trilinear and bounded-tap EWA
filtering, ray-cone LOD (counterpart of the reference ``ops/texture.py``).

Every texture and every mip level lives in one ``(P, 3)`` float32 tensor
of linear-light RGB; a small per-(texture, level) table holds each level's
first row, width and height. Chains are built in numpy on the host, as
the reference builds them (2× box filter, edge clamp for odd sizes), so
the pools are equal texel for texel.

Texel fetches are plain indexing, differentiable with respect to the pool;
the LOD is detached (the footprint choice carries no gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .vecmath import cross, dot


class TexturePool(NamedTuple):
    """All textures' full mip chains in one flat tensor. ``L`` is the
    pool-wide level count; a texture with fewer levels repeats its last
    (1×1) level in the metadata rows, so any clamped lod is valid."""

    texels: torch.Tensor  # (P, 3) f32 linear-light RGB
    level_off: torch.Tensor  # (T, L) int32 first row of (tex, level)
    level_w: torch.Tensor  # (T, L) int32
    level_h: torch.Tensor  # (T, L) int32
    n_levels: torch.Tensor  # (T,) int32

    @property
    def num_textures(self) -> int:
        return self.level_off.shape[0]

    @property
    def max_levels(self) -> int:
        return self.level_off.shape[1]


def downsample2x(img: np.ndarray) -> np.ndarray:
    """2× box-filter downsample, the last row/column repeated for odd
    sizes."""
    h, w = img.shape[:2]
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
        w += 1
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h > 1 and w > 1:
        return img.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
    if h > 1:
        return img.reshape(nh, 2, 1, -1).mean(axis=1)
    if w > 1:
        return img.reshape(1, nw, 2, -1).mean(axis=2)
    return img


def build_mip_chain(img: np.ndarray) -> list[np.ndarray]:
    """Full chain down to 1×1; level 0 is the input as (H, W, 3) float32."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    img = img[:, :, :3]
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        levels.append(downsample2x(levels[-1]).astype(np.float32))
    return levels


def build_texture_pool(images: Sequence[np.ndarray], device=None) -> TexturePool:
    """Mip every image, concatenate the levels, and tabulate them."""
    if not images:
        raise ValueError("build_texture_pool needs at least one image")
    chains = [build_mip_chain(im) for im in images]
    max_l = max(len(c) for c in chains)
    texels = []
    off = 0
    level_off = np.zeros((len(chains), max_l), np.int32)
    level_w = np.zeros_like(level_off)
    level_h = np.zeros_like(level_off)
    n_levels = np.zeros((len(chains),), np.int32)
    for t, chain in enumerate(chains):
        n_levels[t] = len(chain)
        for lv_i in range(max_l):
            lv = chain[min(lv_i, len(chain) - 1)]
            if lv_i < len(chain):
                level_off[t, lv_i] = off
                texels.append(lv.reshape(-1, 3))
                off += lv.shape[0] * lv.shape[1]
            else:  # the last level's row again, no extra texels
                level_off[t, lv_i] = level_off[t, len(chain) - 1]
            level_w[t, lv_i] = lv.shape[1]
            level_h[t, lv_i] = lv.shape[0]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return TexturePool(
        t(np.concatenate(texels, axis=0)), t(level_off), t(level_w), t(level_h), t(n_levels)
    )


def _meta(pool: TexturePool, tex_id, level):
    """Per-ray (first row, width, height) of (texture, level), int64."""
    flat = tex_id.to(torch.int64) * pool.max_levels + level.to(torch.int64)
    return (
        pool.level_off.reshape(-1)[flat].to(torch.int64),
        pool.level_w.reshape(-1)[flat].to(torch.int64),
        pool.level_h.reshape(-1)[flat].to(torch.int64),
    )


def sample_bilinear(pool: TexturePool, tex_id, uv, level):
    """Bilinear fetch at integer mip ``level`` with repeat wrapping:
    ``tex_id`` (N,), ``uv`` (N,2), ``level`` (N,) → (N,3). Texel i covers
    [i/w, (i+1)/w)."""
    off, w, h = _meta(pool, tex_id, level)
    x = uv[..., 0] * w.to(torch.float32) - 0.5
    y = uv[..., 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)

    def tex(xa, ya):
        return pool.texels[off + torch.remainder(ya, h) * w + torch.remainder(xa, w)]

    c00 = tex(xi, yi)
    c10 = tex(xi + 1, yi)
    c01 = tex(xi, yi + 1)
    c11 = tex(xi + 1, yi + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_trilinear(pool: TexturePool, tex_id, uv, lod):
    """Bilinear at two levels, lerped by frac(lod); ``lod`` is clamped to
    the texture's own chain and detached."""
    lod = lod.detach()
    max_l = (pool.n_levels[tex_id.to(torch.int64)] - 1).to(torch.float32)
    lod = torch.minimum(torch.clamp(lod, min=0.0), max_l)
    l0 = torch.floor(lod)
    f = (lod - l0)[..., None]
    l0i = l0.to(torch.int64)
    l1i = torch.minimum(l0i + 1, max_l.to(torch.int64))
    c0 = sample_bilinear(pool, tex_id, uv, l0i)
    c1 = sample_bilinear(pool, tex_id, uv, l1i)
    return c0 * (1 - f) + c1 * f


MAX_ANISO = 8.0  # anisotropy clamp of the EWA footprint
EWA_TAPS = 5


def cone_ellipse_uv(cone_w, density, wo, ng, dpdu, dpdv):
    """UV-space footprint of a ray cone at grazing incidence → (major
    half-axis (N,2), minor half-length (N,)). The surface footprint's minor
    half-width is ``cone_w/2``, its major half-width ``cone_w/(2·cosθ)``
    along the view's tangent projection (anisotropy clamped to
    MAX_ANISO); the major axis maps to UV through the Gram inverse of
    [dpdu dpdv]."""
    cos_t = torch.abs(dot(wo, ng))
    t_view = wo - ng * dot(wo, ng, keepdim=True)
    t_len = torch.sqrt(torch.clamp(dot(t_view, t_view), min=1e-20))
    t_view = t_view / t_len[..., None]
    ratio = torch.clamp(1.0 / torch.clamp(cos_t, min=1.0 / MAX_ANISO), 1.0, MAX_ANISO)
    guu = dot(dpdu, dpdu)
    guv = dot(dpdu, dpdv)
    gvv = dot(dpdv, dpdv)
    det = torch.clamp(guu * gvv - guv * guv, min=1e-20)
    bu = dot(t_view, dpdu)
    bv = dot(t_view, dpdv)
    du = (gvv * bu - guv * bv) / det
    dv = (guu * bv - guv * bu) / det
    dir_uv = torch.stack([du, dv], dim=-1)  # UV image of the unit t_view
    minor_len = 0.5 * cone_w * density
    duv_major = dir_uv * (0.5 * cone_w * ratio)[..., None]
    return duv_major, minor_len


def sample_ewa(pool: TexturePool, tex_id, uv, duv_major, lod_minor):
    """Bounded-tap anisotropic filter: EWA_TAPS trilinear probes spaced
    along the major UV axis, Gaussian-weighted (alpha = 2), each at the
    minor-axis LOD."""
    lod_minor = lod_minor.detach()
    acc = None
    wsum = 0.0
    for i in range(EWA_TAPS):
        s = (i / (EWA_TAPS - 1.0)) * 2.0 - 1.0  # [-1, 1]
        wgt = float(np.exp(-2.0 * s * s))
        c = sample_trilinear(pool, tex_id, uv + duv_major * s, lod_minor)
        acc = c * wgt if acc is None else acc + c * wgt
        wsum += wgt
    return acc / wsum


def uv_density(tri_uv, e0, e1):
    """Per-triangle ‖duv/dp‖ scale, sqrt(uv area / world area)."""
    uve0 = tri_uv[:, 1] - tri_uv[:, 0]
    uve1 = tri_uv[:, 2] - tri_uv[:, 0]
    uv_area = torch.abs(uve0[:, 0] * uve1[:, 1] - uve0[:, 1] * uve1[:, 0])
    wcross = cross(e0, e1)
    w_area = torch.sqrt(dot(wcross, wcross))
    return torch.sqrt(uv_area / torch.clamp(w_area, min=1e-20))


def raycone_lod(pool: TexturePool, tex_id, cone_width, density):
    """Mip lambda of a ray-cone footprint:
    log2(cone_width · density · level-0 size)."""
    _, w0, h0 = _meta(pool, tex_id, torch.zeros_like(tex_id))
    size0 = torch.maximum(w0, h0).to(torch.float32)
    return torch.log2(torch.clamp(cone_width * density * size0, min=1e-12))


def pixel_cone_spread(cam_from_raster) -> torch.Tensor:
    """Angle of one pixel at the image centre, the camera cone's spread:
    the pixel pitch (the raster map's x column) over the focal length
    (|m[2,3]|)."""
    dd = cam_from_raster[:3, 0]
    f = torch.abs(cam_from_raster[2, 3])
    return torch.sqrt(torch.sum(dd * dd)) / torch.clamp(f, min=1e-12)

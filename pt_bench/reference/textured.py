"""The plain reference path tracer of textured scene files: the estimator
the port computes for a scene with image textures, per-corner UVs and
shading normals, in plain PyTorch, from the benchmark's own scene spec
(``pt_bench/scenes/scene_file.py``), with brute-force intersection over
the spec's triangles. It imports nothing of the port; what it shares with
``integrator.py`` it imports from this folder, and where it needs a
variant (hits with barycentrics, NEE about a shading normal) it has its
own copy.

Per path: a box-filtered camera ray whose cone starts at zero width and
the pixel's spread (the pixel pitch over the focal length), then up to
``max_depth`` bounces of

- closest hit; a miss adds the constant environment and ends the path;
- the hit's UV (per-corner UVs interpolated by the barycentrics), its UV
  tangents dpdu, dpdv and the triangle's UV density sqrt(UV area / world
  area);
- the cone's width at the hit (width + spread · t), stretched by 1/cos of
  the view angle, clamped at ``MAX_ANISO``; each texture's LOD is
  log2(width · density · its larger side), clamped to its chain;
- trilinear fetches (bilinear with repeat wrapping on the two nearest mip
  levels of the benchmark's own 2x box-filter chains): the albedo map
  replaces the albedo, the roughness map r sets alpha = r^2 (Oren-Nayar
  sigma = r · pi / 2);
- the shading normal: per-corner normals interpolated, then the normal
  map, at the unstretched cone's LOD, in the frame of dpdu Gram-Schmidt'ed
  against it, the bitangent's handedness from dpdv, flipped to the
  incident side of the geometric normal;
- next-event estimation toward one uniformly chosen point or spot light
  with a shadow ray, and a BSDF sample, both about the shading normal;
- Russian roulette on beta times the product of eta^2 from
  ``rr_start_depth`` on;
- the cone carried on: its width set to the width at the hit, its spread
  widened to at least ``DIFFUSE_CONE_SPREAD`` at the first non-specular
  bounce.

Random numbers come from the hash sampler keyed by (pixel, sample ^ seed,
dimension), so a path is the same path here and in the port.

Departures from the upstream DumbTracer's description of its own renderer
(both the port's, so the reference follows them): the hash sampler and the
box filter, where the upstream draws Halton-Owen samples through a Mitchell
filter; a ray cone's width, where the upstream takes its texture LOD from
ray differentials; trilinear filtering of row-major mip levels, where the
upstream filters EWA over Morton-ordered levels; one light picked
uniformly, where the upstream splits between its environment map and a
light tree; and the constant environment 0.05 in place of the file's
environment image, which the repository does not hold. Environment-map
importance sampling and its NEE shadow ray are not here: a cell of a file
with an environment image needs them first.

``dtype`` is float32, or bfloat16 for the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import film as F
from . import geometry as G
from . import rng as R
from . import shading as S
from .integrator import Work, camera_rays

SAMPLERS = {"hash": R.HashSampler}
MAX_ANISO = 8.0  # clamp of the cone footprint's 1/cos stretch
DIFFUSE_CONE_SPREAD = 0.3  # the spread of a path after its first non-specular bounce
TEX_FIELDS = ("albedo_tex", "rough_tex", "normal_tex")


class Pool(NamedTuple):
    """Every texture's mip levels in one (P, 3) tensor; per (texture,
    level) the first row, width and height. A texture with fewer levels
    than the pool repeats its last one."""

    texels: torch.Tensor
    level_off: torch.Tensor  # (T, L) int64
    level_w: torch.Tensor
    level_h: torch.Tensor
    n_levels: torch.Tensor  # (T,) int64


class RefScene(NamedTuple):
    v0: torch.Tensor
    e0: torch.Tensor
    e1: torch.Tensor
    tri_mat: torch.Tensor  # (T,) int64
    tri_uv: torch.Tensor  # (T, 3, 2)
    tri_uvdens: torch.Tensor  # (T,)
    tri_ns: torch.Tensor  # (T, 3, 3)
    materials: S.Materials
    mat_tex: torch.Tensor  # (M, 3) int64 texture ids (albedo, roughness, normal), -1 none
    pool: Pool
    lights: S.Lights
    env: torch.Tensor  # (3,)
    cam_from_raster: torch.Tensor
    world_from_cam: torch.Tensor
    cone_spread: torch.Tensor  # () the pixel's spread angle


def downsample2x(img: np.ndarray) -> np.ndarray:
    """2x box-filter downsample, the last row or column repeated for odd
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


def mip_chain(img) -> list:
    """Levels down to 1x1, level 0 the image as (H, W, 3) float32."""
    levels = [np.asarray(img, np.float32)[:, :, :3]]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        levels.append(downsample2x(levels[-1]).astype(np.float32))
    return levels


def make_pool(images, device, dtype) -> Pool:
    chains = [mip_chain(im) for im in images]
    n_max = max(len(c) for c in chains)
    off = np.zeros((len(chains), n_max), np.int64)
    lw, lh = np.zeros_like(off), np.zeros_like(off)
    rows, start = [], 0
    for t, chain in enumerate(chains):
        for k in range(n_max):
            lv = chain[min(k, len(chain) - 1)]
            if k < len(chain):
                off[t, k] = start
                rows.append(lv.reshape(-1, 3))
                start += lv.shape[0] * lv.shape[1]
            else:
                off[t, k] = off[t, len(chain) - 1]
            lw[t, k], lh[t, k] = lv.shape[1], lv.shape[0]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Pool(t(np.concatenate(rows)).to(dtype), t(off), t(lw), t(lh),
                t(np.asarray([len(c) for c in chains], np.int64)))


def uv_density(tri_uv, e0, e1):
    """Per-triangle sqrt(UV area / world area)."""
    a = tri_uv[:, 1] - tri_uv[:, 0]
    b = tri_uv[:, 2] - tri_uv[:, 0]
    uv_area = torch.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    w_area = S.length(S.cross(e0, e1))
    return torch.sqrt(uv_area / torch.clamp(w_area, min=1e-20))


def make_scene(spec, device, dtype=torch.float32) -> RefScene:
    """The spec (``pt_bench/scenes/scene_file.py``) as the reference's
    tensors."""
    tris = spec.tris.astype("float32")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)  # noqa: E731
    v0, e0, e1 = t(tris[:, 0]), t(tris[:, 1] - tris[:, 0]), t(tris[:, 2] - tris[:, 0])
    tri_uv = t(spec.tri_uv)
    cam = spec.camera
    cam_from_raster = t(G.camera_from_raster(cam["focal_length_mm"], cam["sensor_height_mm"],
                                             cam["width"], cam["height"]))
    pitch = cam_from_raster[:3, 0]
    spread = torch.sqrt(torch.sum(pitch * pitch)) / torch.clamp(torch.abs(cam_from_raster[2, 3]),
                                                                min=1e-12)
    mat_tex = torch.as_tensor([[int(m.get(k, -1)) for k in TEX_FIELDS] for m in spec.materials],
                              dtype=torch.int64, device=device)
    return RefScene(
        v0, e0, e1, torch.as_tensor(spec.tri_mat, device=device).to(torch.int64), tri_uv,
        uv_density(tri_uv, e0, e1), t(spec.tri_ns),
        S.make_materials(spec.materials, device, dtype), mat_tex,
        make_pool(spec.textures, device, dtype), S.make_lights(spec.lights, device, dtype),
        t(spec.env_color), cam_from_raster,
        t(G.world_from_camera(cam["direction"], cam["position"])), spread)


# ---------------------------------------------------------------- textures

def _meta(pool: Pool, tex, level):
    flat = tex * pool.level_off.shape[1] + level
    return (pool.level_off.reshape(-1)[flat], pool.level_w.reshape(-1)[flat],
            pool.level_h.reshape(-1)[flat])


def bilinear(pool: Pool, tex, uv, level):
    """Bilinear fetch at integer mip ``level`` with repeat wrapping; texel
    i covers [i/w, (i+1)/w)."""
    off, w, h = _meta(pool, tex, level)
    x = uv[:, 0] * w.to(uv.dtype) - 0.5
    y = uv[:, 1] * h.to(uv.dtype) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)

    def at(xa, ya):
        return pool.texels[off + torch.remainder(ya, h) * w + torch.remainder(xa, w)]

    top = at(xi, yi) * (1 - fx) + at(xi + 1, yi) * fx
    bot = at(xi, yi + 1) * (1 - fx) + at(xi + 1, yi + 1) * fx
    return top * (1 - fy) + bot * fy


def trilinear(pool: Pool, tex, uv, lod):
    """Bilinear at the two levels around ``lod`` (clamped to the texture's
    chain), lerped by its fraction."""
    max_l = (pool.n_levels[tex] - 1).to(lod.dtype)
    lod = torch.minimum(torch.clamp(lod.detach(), min=0.0), max_l)
    l0 = torch.floor(lod)
    f = (lod - l0)[:, None]
    l0i = l0.to(torch.int64)
    l1i = torch.minimum(l0i + 1, max_l.to(torch.int64))
    return bilinear(pool, tex, uv, l0i) * (1 - f) + bilinear(pool, tex, uv, l1i) * f


def cone_lod(pool: Pool, tex, width, density):
    """log2(width · density · the texture's larger side at level 0)."""
    _, w0, h0 = _meta(pool, tex, torch.zeros_like(tex))
    size0 = torch.maximum(w0, h0).to(width.dtype)
    return torch.log2(torch.clamp(width * density * size0, min=1e-12))


# ------------------------------------------------------------------- hits

class Hit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    normal: torch.Tensor  # geometric, against the ray
    error: torch.Tensor


def closest_hit(o, d, v0, e0, e1) -> Hit:
    """``geometry.closest_hit`` with the winning triangle's barycentrics."""
    best_t, best_i = G.closest_raw(o, d, v0, e0, e1)
    hv0, he0, he1 = v0[best_i], e0[best_i], e1[best_i]
    px = d[:, 1] * he1[:, 2] - d[:, 2] * he1[:, 1]
    py = d[:, 2] * he1[:, 0] - d[:, 0] * he1[:, 2]
    pz = d[:, 0] * he1[:, 1] - d[:, 1] * he1[:, 0]
    det = px * he0[:, 0] + py * he0[:, 1] + pz * he0[:, 2]
    inv_det = 1.0 / torch.where(torch.abs(det) < G.MT_TOLERANCE, 1.0, det)
    tx, ty, tz = o[:, 0] - hv0[:, 0], o[:, 1] - hv0[:, 1], o[:, 2] - hv0[:, 2]
    qx = ty * he0[:, 2] - tz * he0[:, 1]
    qy = tz * he0[:, 0] - tx * he0[:, 2]
    qz = tx * he0[:, 1] - ty * he0[:, 0]
    u = inv_det * (px * tx + py * ty + pz * tz)
    v = inv_det * (qx * d[:, 0] + qy * d[:, 1] + qz * d[:, 2])
    pos = hv0 + u[:, None] * he0 + v[:, None] * he1
    ng = S.normalize(S.cross(he1, he0))
    ng = torch.where((S.dot(d, ng) > 0.0)[:, None], -ng, ng)
    w = (1.0 - u - v)[:, None]
    err = G._GAMMA7 * (torch.abs(u[:, None] * hv0) + torch.abs(v[:, None] * (hv0 + he0))
                       + torch.abs(w * (hv0 + he1)))
    return Hit(best_t < G.BIG_T, best_t, best_i, u, v, pos, ng, err)


class SurfaceUV(NamedTuple):
    uv: torch.Tensor
    dpdu: torch.Tensor
    dpdv: torch.Tensor
    ok: torch.Tensor  # a UV triangle that is not degenerate
    dens: torch.Tensor


def uv_at_hit(scene: RefScene, hit: Hit) -> SurfaceUV:
    """With p = v0 + u·e0 + v·e1 and uv = uv0 + u·duv1 + v·duv2:
    dpdu = (dv2·e0 - dv1·e1)/det, dpdv = (du1·e1 - du2·e0)/det."""
    uv3 = scene.tri_uv[hit.tri]
    w = (1.0 - hit.u - hit.v)[:, None]
    uv = w * uv3[:, 0] + hit.u[:, None] * uv3[:, 1] + hit.v[:, None] * uv3[:, 2]
    duv1, duv2 = uv3[:, 1] - uv3[:, 0], uv3[:, 2] - uv3[:, 0]
    e0, e1 = scene.e0[hit.tri], scene.e1[hit.tri]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    dpdu = (duv2[:, 1:2] * e0 - duv1[:, 1:2] * e1) * inv_det[:, None]
    dpdv = (duv1[:, 0:1] * e1 - duv2[:, 0:1] * e0) * inv_det[:, None]
    return SurfaceUV(uv, dpdu, dpdv, ok, scene.tri_uvdens[hit.tri])


def shading_normal(scene: RefScene, hit: Hit):
    """Per-corner normals interpolated, on the geometric normal's side;
    the geometric normal where the interpolation degenerates."""
    n3 = scene.tri_ns[hit.tri]
    w = (1.0 - hit.u - hit.v)[:, None]
    ns = w * n3[:, 0] + hit.u[:, None] * n3[:, 1] + hit.v[:, None] * n3[:, 2]
    bad = S.dot(ns, ns, keepdim=True) < 1e-12
    ns = S.normalize(torch.where(bad, hit.normal, ns))
    return torch.where(S.dot(ns, hit.normal, keepdim=True) < 0.0, -ns, ns)


def textured_material(scene: RefScene, mat: S.Materials, tex, hit: Hit, suv: SurfaceUV, cone_w,
                      wo) -> S.Materials:
    """Albedo and roughness from the maps at the cone's stretched LOD."""
    cos_t = torch.abs(S.dot(wo, hit.normal))
    stretched = cone_w / torch.clamp(cos_t, min=1.0 / MAX_ANISO)

    def fetch(ids):
        ids = torch.clamp(ids, min=0)
        return trilinear(scene.pool, ids, suv.uv, cone_lod(scene.pool, ids, stretched, suv.dens))

    has_alb, has_r = tex[:, 0] >= 0, tex[:, 1] >= 0
    albedo = torch.where(has_alb[:, None], fetch(tex[:, 0]), mat.albedo)
    rough = fetch(tex[:, 1])[:, 0]
    alpha = S.sqr(rough)
    return mat._replace(albedo=albedo, alphax=torch.where(has_r, alpha, mat.alphax),
                        alphay=torch.where(has_r, alpha, mat.alphay),
                        on_sigma=torch.where(has_r, rough * (math.pi / 2.0), mat.on_sigma))


def normal_mapped(scene: RefScene, tex, hit: Hit, suv: SurfaceUV, ns, cone_w):
    """``ns`` turned by the tangent-space normal map."""
    ids = torch.clamp(tex[:, 2], min=0)
    texel = trilinear(scene.pool, ids, suv.uv, cone_lod(scene.pool, ids, cone_w, suv.dens))
    n_t = 2.0 * texel - 1.0
    tang = suv.dpdu - ns * S.dot(ns, suv.dpdu, keepdim=True)
    tlen = torch.sqrt(torch.clamp(S.dot(tang, tang), min=1e-20))
    tang = tang / tlen[:, None]
    bita = S.cross(ns, tang)
    bita = torch.where((S.dot(bita, suv.dpdv) < 0.0)[:, None], -bita, bita)
    n_new = n_t[:, 0:1] * tang + n_t[:, 1:2] * bita + n_t[:, 2:3] * ns
    bad = S.dot(n_new, n_new) < 1e-12
    n_new = S.normalize(torch.where(bad[:, None], ns, n_new))
    n_new = torch.where(S.dot(n_new, hit.normal, keepdim=True) < 0.0, -n_new, n_new)
    use = (tex[:, 2] >= 0) & suv.ok & (tlen > 1e-10)
    return torch.where(use[:, None], n_new, ns)


# ------------------------------------------------------------------- paths

class _Path(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    beta: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    inside: torch.Tensor
    eta_scale: torch.Tensor
    cone_w: torch.Tensor
    cone_s: torch.Tensor


def _nee(scene, sampler, px, py, sample, depth_dim, hit, mat, wo, ns, inside, alive, work):
    n_lights = scene.lights.ltype.shape[0]
    ul = sampler.sample_1d(px, py, sample, depth_dim + R.LIGHT_SELECT)
    lt = scene.lights.gather(torch.clamp((ul * n_lights).to(torch.int64), max=n_lights - 1))
    pmf = 1.0 / n_lights
    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.LIGHT_U)
    direction, pdf, distance, factor = S.sample_light(lt, hit.pos, u1, u2, hit.normal)
    le = S.eval_light(lt, distance, factor)
    f_cos, _ = S.eval_bsdf(mat, wo, direction, ns, hit.normal, inside)
    shadow_o = S.offset_ray_origin(hit.pos, hit.error, hit.normal, direction)
    if work is None:
        occ = G.occluded(shadow_o, direction, scene.v0, scene.e0, scene.e1, distance)
    else:
        live = (pdf > 0.0) & (S.max_component(f_cos) > 0.0) & alive
        occ, tests = G.occluded(shadow_o, direction, scene.v0, scene.e0, scene.e1, distance,
                                count=live)
        work.shadow_rays += int(live.sum())
        work.shadow_tests += tests
        if work.keep_rays:
            work.shadow.append((shadow_o[live], direction[live], distance[live]))
    return torch.where(((pdf > 0.0) & ~occ)[:, None], le * f_cos / pmf, 0.0)


def _bounce(scene, sampler, px, py, sample, depth, st: _Path, rr_start_depth, work) -> _Path:
    depth_dim = depth * R.DIMS_PER_BOUNCE
    if work is not None:
        work.closest_rays += int(st.alive.sum())
        if work.keep_rays:
            work.closest.append((st.o[st.alive], st.d[st.alive]))
    hit = closest_hit(st.o, st.d, scene.v0, scene.e0, scene.e1)
    miss = st.alive & ~hit.hit
    radiance = st.radiance + torch.where(miss[:, None], st.beta * scene.env, 0.0)
    alive = st.alive & hit.hit
    if work is not None:
        work.hits += int(alive.sum())
    wo = -st.d
    row = scene.tri_mat[hit.tri]
    mat, tex = scene.materials.gather(row), scene.mat_tex[row]
    ns = shading_normal(scene, hit)
    cone_at_hit = st.cone_w + st.cone_s * torch.abs(hit.t)
    suv = uv_at_hit(scene, hit)
    mat = textured_material(scene, mat, tex, hit, suv, cone_at_hit, wo)
    ns = normal_mapped(scene, tex, hit, suv, ns, cone_at_hit)
    nee = _nee(scene, sampler, px, py, sample, depth_dim, hit, mat, wo, ns, st.inside, alive,
               work)
    radiance = radiance + torch.where(alive[:, None], st.beta * nee, 0.0)

    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.BSDF_U)
    uc = sampler.sample_1d(px, py, sample, depth_dim + R.BSDF_UC)
    bs = S.sample_bsdf(mat, wo, ns, hit.normal, u1, u2, uc, st.inside)
    valid = bs.pdf > 0.0
    beta = st.beta * torch.where(valid[:, None],
                                 bs.f_cos / torch.clamp(bs.pdf, min=1e-12)[:, None], 1.0)
    alive = alive & valid
    o_new = S.offset_ray_origin(hit.pos, hit.error, hit.normal, bs.wi)
    inside = st.inside ^ (bs.refract & alive)
    eta_scale = torch.where(bs.refract & alive, st.eta_scale * S.sqr(bs.eta), st.eta_scale)

    rr_beta = S.max_component(beta) * eta_scale
    u_rr = sampler.sample_1d(px, py, sample, depth_dim + R.RR)
    q = torch.clamp(1.0 - rr_beta, min=0.0)
    do_rr = (rr_beta < 1.0) & (depth >= rr_start_depth)
    killed = do_rr & (u_rr < q)
    beta = beta * torch.where(do_rr & ~killed, 1.0 / torch.clamp(1.0 - q, min=1e-6), 1.0)[:, None]
    alive = alive & ~killed
    cone_w = torch.where(alive, cone_at_hit, st.cone_w)
    cone_s = torch.where(alive & ~bs.delta, torch.clamp(st.cone_s, min=DIFFUSE_CONE_SPREAD),
                         st.cone_s)
    a3 = alive[:, None]
    return _Path(torch.where(a3, o_new, st.o), torch.where(a3, bs.wi, st.d),
                 torch.where(a3, beta, st.beta), radiance, alive, inside, eta_scale, cone_w,
                 cone_s)


def trace(scene: RefScene, sampler, px, py, sample, max_depth: int, rr_start_depth: int = 2,
          work: Work | None = None):
    """Radiance (N, 3) of one path per (px, py, sample), int64 keys."""
    o, d = camera_rays(scene, sampler, px, py, sample)
    n = o.shape[0]
    like = dict(dtype=o.dtype, device=o.device)
    flags = dict(dtype=torch.bool, device=o.device)
    st = _Path(o, d, torch.ones((n, 3), **like), torch.zeros((n, 3), **like),
               torch.ones((n,), **flags), torch.zeros((n,), **flags), torch.ones((n,), **like),
               torch.zeros((n,), **like), scene.cone_spread.expand(n).clone())
    if work is not None:
        work.paths += n
    for depth in range(max_depth):
        st = _bounce(scene, sampler, px, py, sample, depth, st, rr_start_depth, work)
    return st.radiance


def pixel_samples(scene, sampler, px, py, sample0: int, nspp: int, max_depth: int,
                  rr_start_depth: int = 2, block: int = 1 << 16, work: Work | None = None):
    """Radiance (nspp, P, 3) of samples sample0 .. sample0 + nspp - 1 of
    pixels (px, py), traced in blocks of at most ``block`` paths."""
    keys_px, keys_py = px.repeat(nspp), py.repeat(nspp)
    keys_s = sample0 + torch.repeat_interleave(torch.arange(nspp, device=px.device),
                                               px.shape[0])
    out = [trace(scene, sampler, keys_px[i:i + block], keys_py[i:i + block], keys_s[i:i + block],
                 max_depth, rr_start_depth, work)
           for i in range(0, keys_px.shape[0], block)]
    return torch.cat(out).reshape(nspp, px.shape[0], 3)


def film_batch(scene, sampler, px, py, sample0, kspp, spp_per_pass, max_depth, before=None):
    """One progressive batch of pixels (px, py) into the film ``before``
    (mean, m2, n), or an empty one → ((mean, m2, n), the batch's own
    mean per pixel)."""
    rad = pixel_samples(scene, sampler, px, py, sample0, kspp, max_depth).to(torch.float32)
    if before is None:
        z = torch.zeros_like(rad[0])
        before = (z, z.clone(), torch.zeros((), dtype=torch.float32, device=rad.device))
    return F.accumulate(*before, rad, spp_per_pass), rad.mean(dim=0)


def image_loss(scene, sampler, albedo, sample0: int, spp: int, width, height, max_depth,
               target: float = 0.0, rows_per_block: int = 64):
    """The L2 image loss of a ``spp``-sample render with the materials'
    albedo replaced by ``albedo`` (a textured albedo still wins): its
    value, with ``albedo.grad`` holding the gradient."""
    sc = scene._replace(materials=scene.materials._replace(albedo=albedo))
    total, dev = 0.0, albedo.device
    for y0 in range(0, height, rows_per_block):
        ys, xs = torch.meshgrid(torch.arange(y0, min(y0 + rows_per_block, height), device=dev),
                                torch.arange(width, device=dev), indexing="ij")
        rad = pixel_samples(sc, sampler, xs.reshape(-1), ys.reshape(-1), sample0, spp, max_depth)
        part = torch.sum((torch.sum(rad, dim=0) / spp - target) ** 2) / (height * width * 3)
        part.backward()
        total += float(part.detach())
    return total

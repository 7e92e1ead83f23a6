"""The plain reference path tracer: the estimator the port computes, in
plain PyTorch, from the benchmark's own scene spec, with brute-force
intersection over the spec's triangles. It imports nothing of the port.

Per path: camera ray with box-filter jitter, then up to ``max_depth``
bounces of closest hit, constant environment on a miss, next-event
estimation toward one uniformly chosen point or spot light with a shadow
ray, a BSDF sample, and Russian roulette on beta times the product of
eta^2 from ``rr_start_depth`` on. Random numbers come from the hash
sampler keyed by (pixel, sample ^ seed, dimension), so a path is the same
path here and in the port.

``dtype`` is float32, or bfloat16 for the control.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import film as F
from . import geometry as G
from . import rng as R
from . import shading as S

# the configuration's ``sampler`` → the sampler of this estimator
SAMPLERS = {"hash": R.HashSampler}


class RefScene(NamedTuple):
    v0: torch.Tensor
    e0: torch.Tensor
    e1: torch.Tensor
    tri_mat: torch.Tensor  # (T,) int64
    materials: S.Materials
    lights: S.Lights
    env: torch.Tensor  # (3,)
    cam_from_raster: torch.Tensor
    world_from_cam: torch.Tensor


def make_scene(spec, device, dtype=torch.float32) -> RefScene:
    """The spec (``pt_bench/scenes``) as the reference's tensors."""
    tris = spec.tris.astype("float32")
    v0, e0, e1 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
    cam = spec.camera
    return RefScene(
        t(v0), t(e0), t(e1), torch.as_tensor(spec.tri_mat, device=device).to(torch.int64),
        S.make_materials(spec.materials, device, dtype), S.make_lights(spec.lights, device, dtype),
        t(torch.tensor(spec.env_color, dtype=torch.float32)),
        t(G.camera_from_raster(cam["focal_length_mm"], cam["sensor_height_mm"],
                               cam["width"], cam["height"])),
        t(G.world_from_camera(cam["direction"], cam["position"])))


@dataclasses.dataclass
class Work:
    """What the paths needed, counted as they were traced: closest-hit
    queries of live paths, hits shaded, shadow rays cast (their light
    sample contributes), and the shadow rays' brute-force tests up to the
    first occluder. With ``keep_rays`` the queries' rays too, for walking
    another acceleration structure over them."""

    paths: int = 0
    closest_rays: int = 0
    hits: int = 0
    shadow_rays: int = 0
    shadow_tests: int = 0
    keep_rays: bool = False
    closest: list = dataclasses.field(default_factory=list)  # (o, d)
    shadow: list = dataclasses.field(default_factory=list)  # (o, d, t_max)


class _Path(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    beta: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    inside: torch.Tensor
    eta_scale: torch.Tensor


def camera_rays(scene: RefScene, sampler: R.HashSampler, px, py, sample):
    """Box-filtered camera rays of pixels (px, py) at ``sample``."""
    u1, u2 = sampler.sample_2d(px, py, sample, R.CAMERA_U)
    pix = torch.stack([px, py], dim=-1).to(torch.float32).to(u1.dtype)
    return G.generate_rays(pix + torch.stack([u1, u2], dim=-1),
                           scene.cam_from_raster, scene.world_from_cam)


def _nee(scene, sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive, work):
    n_lights = scene.lights.ltype.shape[0]
    ul = sampler.sample_1d(px, py, sample, depth_dim + R.LIGHT_SELECT)
    lt = scene.lights.gather(torch.clamp((ul * n_lights).to(torch.int64), max=n_lights - 1))
    pmf = 1.0 / n_lights
    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.LIGHT_U)
    direction, pdf, distance, factor = S.sample_light(lt, hit.pos, u1, u2, hit.normal)
    le = S.eval_light(lt, distance, factor)
    f_cos, _ = S.eval_bsdf(mat, wo, direction, hit.normal, hit.normal, inside)
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
    return torch.where(((pdf > 0.0) & ~occ)[..., None], le * f_cos / pmf, 0.0)


def _bounce(scene, sampler, px, py, sample, depth, st: _Path, rr_start_depth, work) -> _Path:
    depth_dim = depth * R.DIMS_PER_BOUNCE
    if work is not None:
        work.closest_rays += int(st.alive.sum())
        if work.keep_rays:
            work.closest.append((st.o[st.alive], st.d[st.alive]))
    hit = G.closest_hit(st.o, st.d, scene.v0, scene.e0, scene.e1)
    miss = st.alive & ~hit.hit
    radiance = st.radiance + torch.where(miss[..., None], st.beta * scene.env, 0.0)
    alive = st.alive & hit.hit
    if work is not None:
        work.hits += int(alive.sum())
    wo = -st.d
    mat = scene.materials.gather(scene.tri_mat[hit.tri])
    nee = _nee(scene, sampler, px, py, sample, depth_dim, hit, mat, wo, st.inside, alive, work)
    radiance = radiance + torch.where(alive[..., None], st.beta * nee, 0.0)

    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.BSDF_U)
    uc = sampler.sample_1d(px, py, sample, depth_dim + R.BSDF_UC)
    bs = S.sample_bsdf(mat, wo, hit.normal, hit.normal, u1, u2, uc, st.inside)
    valid = bs.pdf > 0.0
    beta = st.beta * torch.where(valid[..., None],
                                 bs.f_cos / torch.clamp(bs.pdf, min=1e-12)[..., None], 1.0)
    alive = alive & valid
    o_new = S.offset_ray_origin(hit.pos, hit.error, hit.normal, bs.wi)
    inside = st.inside ^ (bs.refract & alive)
    eta_scale = torch.where(bs.refract & alive, st.eta_scale * S.sqr(bs.eta), st.eta_scale)

    rr_beta = S.max_component(beta) * eta_scale
    u_rr = sampler.sample_1d(px, py, sample, depth_dim + R.RR)
    q = torch.clamp(1.0 - rr_beta, min=0.0)
    do_rr = (rr_beta < 1.0) & (depth >= rr_start_depth)
    killed = do_rr & (u_rr < q)
    beta = beta * torch.where(do_rr & ~killed, 1.0 / torch.clamp(1.0 - q, min=1e-6), 1.0)[..., None]
    alive = alive & ~killed
    a3 = alive[..., None]
    return _Path(torch.where(a3, o_new, st.o), torch.where(a3, bs.wi, st.d),
                 torch.where(a3, beta, st.beta), radiance, alive, inside, eta_scale)


def trace(scene: RefScene, sampler, px, py, sample, max_depth: int, rr_start_depth: int = 2,
          work: Work | None = None):
    """Radiance (N, 3) of one path per (px, py, sample), int64 keys."""
    o, d = camera_rays(scene, sampler, px, py, sample)
    n = o.shape[0]
    like = dict(dtype=o.dtype, device=o.device)
    st = _Path(o, d, torch.ones((n, 3), **like), torch.zeros((n, 3), **like),
               torch.ones((n,), dtype=torch.bool, device=o.device),
               torch.zeros((n,), dtype=torch.bool, device=o.device), torch.ones((n,), **like))
    if work is not None:
        work.paths += n
    for depth in range(max_depth):
        st = _bounce(scene, sampler, px, py, sample, depth, st, rr_start_depth, work)
    return st.radiance


def pixel_samples(scene, sampler, px, py, sample0: int, nspp: int, max_depth: int,
                  rr_start_depth: int = 2, block: int = 1 << 16, work: Work | None = None):
    """Radiance (nspp, P, 3) of samples sample0 .. sample0 + nspp - 1 of
    pixels (px, py), traced in blocks of at most ``block`` paths."""
    dev = px.device
    keys_px = px.repeat(nspp)
    keys_py = py.repeat(nspp)
    keys_s = sample0 + torch.repeat_interleave(torch.arange(nspp, device=dev), px.shape[0])
    out = [trace(scene, sampler, keys_px[i:i + block], keys_py[i:i + block], keys_s[i:i + block],
                 max_depth, rr_start_depth, work)
           for i in range(0, keys_px.shape[0], block)]
    return torch.cat(out).reshape(nspp, px.shape[0], 3)


def film_batch(scene, sampler, px, py, sample0, kspp, spp_per_pass, max_depth, before=None):
    """One progressive batch of pixels (px, py) into a film: the film
    ``before`` (mean, m2, n), or an empty one → ((mean, m2, n), the batch's
    own mean per pixel)."""
    rad = pixel_samples(scene, sampler, px, py, sample0, kspp, max_depth).to(torch.float32)
    if before is None:
        z = torch.zeros_like(rad[0])
        before = (z, z.clone(), torch.zeros((), dtype=torch.float32, device=rad.device))
    return F.accumulate(*before, rad, spp_per_pass), rad.mean(dim=0)


def image_loss(scene, sampler, albedo, sample0: int, spp: int, width, height, max_depth,
               target: float = 0.0, rows_per_block: int = 64):
    """The L2 image loss of a ``spp``-sample render with the materials'
    albedo replaced by ``albedo``: its value, with ``albedo.grad`` holding
    the gradient (backward block by block of image rows)."""
    sc = scene._replace(materials=scene.materials._replace(albedo=albedo))
    total = 0.0
    dev = albedo.device
    for y0 in range(0, height, rows_per_block):
        ys, xs = torch.meshgrid(torch.arange(y0, min(y0 + rows_per_block, height), device=dev),
                                torch.arange(width, device=dev), indexing="ij")
        rad = pixel_samples(sc, sampler, xs.reshape(-1), ys.reshape(-1), sample0, spp, max_depth)
        img = torch.sum(rad, dim=0) / spp
        part = torch.sum((img - target) ** 2) / (height * width * 3)
        part.backward()
        total += float(part.detach())
    return total

"""Megakernel integrator in PyTorch (counterpart of the reference
``models/megakernel.py``).

Estimator (NEE + one-sample power-heuristic MIS for area lights and the
environment + Russian roulette, transmission tracking):

    L += β · Le · f·cosθ · w / (pmf · pdf_light)   (area lights, env NEE)
    L += β · Le · f·cosθ / pmf                      (point/spot/directional)
    β *= f·cosθ / pdf_bsdf                          (bounce)

Scenes from files add textures (albedo, roughness and tangent-space
normal maps, filtered trilinearly or by bounded-tap EWA at a ray-cone
LOD: the path carries the cone's width and spread), per-corner shading
normals and an HDR environment, importance-sampled each bounce with
``env_nee`` and MIS-weighted against the miss shader. Only the plain
PyTorch integrator shades them; the fused kernels refuse such scenes
(``megakernel_cuda_supported``), so their intersection queries still go
to kernels 2, 3 and 4.

Many lights: a scene with a light tree (``ops/light_tree.py``) selects
its NEE light by a stochastic importance descent of the tree below 1, 2
or 4 deterministic subtree roots (``nee_splits``), one shadow ray each,
and MIS-weights a directly hit emitter by the tree's pmf from the last
shading point (``PathState.prev_n``, carried only then). Instanced
scenes (``Scene.instances``) place base meshes by affine transforms. Both
take ``fused="off"``: the fused gate refuses them.

Two routes down the same path:

- ``fused="on"``: ``models/megakernel_cuda.trace_paths_fused``, the whole
  path loop in one CUDA kernel (one thread per path);
- ``fused="off"``: ``trace_paths`` below, a Python depth loop of dense
  masked bounce steps over the ray batch. Its closest-hit and shadow
  queries go through ``ops/query.py``, which picks their kernel (or the
  plain sweep), parks dead rays, sorts the rays and loops over instances;
  its BSDF stage is one launch of ``pt_bsdf_step`` a bounce
  (``models/bsdf_step.py``) for CUDA rows that no gradient needs.

BVH scenes render their camera rays in Morton pixel order when the image
is a power-of-two square (``pixel_order``), so neighbouring rays start in
neighbouring pixels.

Camera samples: a box filter (uniform jitter in the pixel) or the
Mitchell filter, importance-sampled through its tabulated CDF
(``ops/filters.py``), each sample weighted by the filter's sign. Random
numbers: the hash sampler or Owen-scrambled Halton (``ops/rng.py``).
``camera_batch`` writes a CUDA scene's box-filtered camera rays and keys
with one launch of the camera kernel (``camera_rays_fused``), any other
camera batch with ``camera_plain``, the kernel's plain version.

``trace_paths`` with ``backend="torch"`` is the plain version of the fused
kernel, of the intersection kernels and of the BSDF-stage kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import query
from ..ops import rng as R
from ..ops.bsdf import ALL_FEATURES, MatFeatures, eval_bsdf
from ..ops.camera import generate_rays, pixel_centers
from ..ops.envmap import env_radiance, eval_envmap, sample_envmap
from ..ops.film import Film, film_add_batch, film_add_sample, film_new
from ..ops.filters import filter_sampler, sample_filter
from ..ops.light_tree import REC_ROW, REC_TRI, light_tree_pmf, sample_light_tree, split_frontier
from ..ops.lights import AREA, ENV, eval_light, sample_area_light, sample_light
from ..ops.morton import is_pot_square, morton_pixel_order, unmorton_image
from ..ops.texture import (
    MAX_ANISO,
    cone_ellipse_uv,
    pixel_cone_spread,
    raycone_lod,
    sample_ewa,
    sample_trilinear,
)
from ..ops.vecmath import (
    cross,
    dot,
    length,
    max_component,
    normalize,
    offset_ray_origin,
    safe_sqrt,
    sqr,
)
from ..scene.types import Scene, scene_to
from ..utils import trace
from .bsdf_step import bsdf_step, bsdf_step_plain


@dataclass(frozen=True)
class MegakernelConfig:
    max_depth: int = 5  # bounce budget
    rr_start_depth: int = 2  # roulette active from this depth on
    sampler: str = "hash"  # "hash" | "halton" (Owen-scrambled, dims < 12)
    seed: int = 0
    remat: bool = True  # recompute bounces in backward (path replay)
    remat_every: int = 1  # bounces per checkpoint group: 1 = classic
    # per-bounce path replay (minimum memory); k>1 stores activations
    # within each k-bounce group and replays only group boundaries —
    # fewer recomputed traversals in the backward at k× the activation
    # memory
    tri_chunk: int = 32  # triangles per step of the plain sweep
    env_nee: bool = False  # importance-sample the environment each bounce,
    # MIS-weighted against the miss shader; outside the fused set
    backend: str = "auto"  # "auto" | "torch" | "cuda": intersection
    # kernels. auto = the CUDA kernels for CUDA tensors, the plain sweep
    # for CPU tensors; torch = the plain sweep everywhere (the kernels'
    # plain version); cuda = the kernels, raising for CPU tensors
    features: MatFeatures = ALL_FEATURES  # material lobes the plain
    # evaluators keep (bsdf.mat_features_from_table)
    pixel_filter: str = "box"  # "box" | "mitchell": camera-sample filter.
    # mitchell = filter importance sampling through the tabulated
    # Mitchell-Netravali filter (radius 2), each sample weighted by sign(f)
    light_strategy: str = "auto"  # "auto" | "uniform" | "tree": NEE light
    # selection. tree = stochastic light-tree descent with tree-pmf MIS;
    # uniform = 1/N pick; auto = tree whenever the scene built one
    nee_splits: int = 1  # 1 | 2 | 4 deterministic root subtrees, one
    # shadow ray each (tree strategy only)
    texture_filter: str = "trilinear"  # "trilinear" | "ewa": ewa adds
    # bounded-tap anisotropic filtering along the ray-cone footprint's
    # major axis (ops/texture.sample_ewa)
    fused: str = "auto"  # "auto" | "on" | "off": the fused CUDA path-loop
    # kernel; auto = on for CUDA scenes inside its feature set
    pixel_order: str = "auto"  # "auto" | "linear" | "morton": Morton pixel
    # order keeps neighbouring rays in neighbouring pixels; auto = morton
    # when the scene has a BVH and the image is a power-of-two square
    sort_rays: str = "auto"  # "auto" | "on" | "off": sort rays by
    # direction octant | origin Morton before the intersection kernels
    # (kernel route, BVH and instanced scenes); auto = on whenever a
    # queried mesh has a BVH
    debug: bool = False  # NaN guard: render() checks the film for
    # non-finite values after every progressive batch and raises
    # FloatingPointError naming the batch and the count (one host read a
    # batch, only when on)


def _validate(cfg: MegakernelConfig) -> None:
    if cfg.sampler not in ("hash", "halton"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if cfg.pixel_filter not in ("box", "mitchell"):
        raise ValueError(f"unknown pixel_filter {cfg.pixel_filter!r}")
    if cfg.light_strategy not in ("auto", "uniform", "tree"):
        raise ValueError(f"unknown light_strategy {cfg.light_strategy!r}")
    if cfg.nee_splits not in (1, 2, 4):
        raise ValueError(f"nee_splits must be 1, 2 or 4, got {cfg.nee_splits}")
    if cfg.texture_filter not in ("trilinear", "ewa"):
        raise ValueError(f"unknown texture_filter {cfg.texture_filter!r}")
    if cfg.backend not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.fused not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused mode {cfg.fused!r}")
    if cfg.pixel_order not in ("auto", "linear", "morton"):
        raise ValueError(f"unknown pixel_order {cfg.pixel_order!r}")
    if cfg.sort_rays not in ("auto", "on", "off"):
        raise ValueError(f"unknown sort_rays {cfg.sort_rays!r}")
    if cfg.remat_every < 1:
        raise ValueError(f"remat_every must be >= 1, got {cfg.remat_every}")


def resolve_fused(scene: Scene, cfg: MegakernelConfig) -> MegakernelConfig:
    """Pin ``cfg.fused`` to "on"/"off" for a concrete scene; "on" is
    validated against the fused kernel's feature set. "auto" fuses CUDA
    scenes inside that set unless ``backend="torch"`` asks for the plain
    path, BVH scenes included: on the H100 the fused kernel renders the
    mesh Cornell box at 256², depth 5, about 13 times as fast as the sorted
    wavefront (chip_smoke.py; PERF.md). The reference never fuses BVH
    scenes, from a TPU measurement that does not carry over."""
    from .megakernel_cuda import megakernel_cuda_supported

    _validate(cfg)
    if cfg.fused == "on":
        if not megakernel_cuda_supported(scene, cfg):
            raise ValueError(
                "fused='on' but the scene/config is outside the fused "
                "kernel's feature set (see models/megakernel_cuda.py)"
            )
        return cfg
    if cfg.fused == "off":
        return cfg
    on = (
        scene.device.type == "cuda"
        and cfg.backend != "torch"
        and megakernel_cuda_supported(scene, cfg)
    )
    return dataclasses.replace(cfg, fused="on" if on else "off")


class PathState(NamedTuple):
    o: torch.Tensor  # (N,3)
    d: torch.Tensor  # (N,3)
    beta: torch.Tensor  # (N,3)
    radiance: torch.Tensor  # (N,3)
    alive: torch.Tensor  # (N,) bool
    inside: torch.Tensor  # (N,) odd transmission count
    eta_scale: torch.Tensor  # (N,) ∏ η² for roulette
    prev_pdf: torch.Tensor  # (N,) bsdf pdf of the last bounce (MIS)
    prev_delta: torch.Tensor  # (N,) last bounce was specular
    cone_w: torch.Tensor | None = None  # (N,) ray-cone width at the origin
    cone_s: torch.Tensor | None = None  # (N,) ray-cone spread angle (rad);
    # both None in scenes without textures, whose shading needs no LOD
    prev_n: torch.Tensor | None = None  # (N,3) shading normal at the last
    # bounce: the light tree's pmf of a directly hit emitter (tree only)


def init_path_state(n: int, o, d, cone_spread=None, tree: bool = False) -> PathState:
    """Fresh path state; ``cone_spread`` (the camera's pixel cone, for
    textured scenes) starts the ray cones; ``tree`` adds ``prev_n``."""
    dev = o.device
    f = dict(dtype=torch.float32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return PathState(
        o=o,
        d=d,
        beta=torch.ones((n, 3), **f),
        radiance=torch.zeros((n, 3), **f),
        alive=torch.ones((n,), **b),
        inside=torch.zeros((n,), **b),
        eta_scale=torch.ones((n,), **f),
        prev_pdf=torch.zeros((n,), **f),
        prev_delta=torch.ones((n,), **b),  # the camera counts as delta
        cone_w=None if cone_spread is None else torch.zeros((n,), **f),
        cone_s=None if cone_spread is None else cone_spread.expand(n).clone(),
        prev_n=-d if tree else None,  # unused while prev_delta (weight 1)
    )


def camera_path_state(scene: Scene, cfg, o, d) -> PathState:
    """Fresh paths on camera rays (o, d): the pixel's ray cone in textured
    scenes, ``prev_n`` with a light tree."""
    spread = None if scene.textures is None else pixel_cone_spread(scene.cam_from_raster)
    return init_path_state(o.shape[0], o, d, spread, tree=_tree_on(cfg, scene))


def _tree_on(cfg, scene) -> bool:
    """NEE light selection: the tree or uniform."""
    if cfg.light_strategy == "tree":
        if scene.light_tree is None:
            raise ValueError(
                "light_strategy='tree' but the scene has no light tree "
                "(build with scene_from_host(use_light_tree=True))"
            )
        return True
    if cfg.light_strategy == "uniform":
        return False
    return scene.light_tree is not None


class SurfaceUV(NamedTuple):
    """UV parameterisation at the hits, shared by the texture fetches and
    the normal map."""

    uv: torch.Tensor  # (N,2)
    dpdu: torch.Tensor  # (N,3) world-space UV tangents
    dpdv: torch.Tensor  # (N,3)
    ok: torch.Tensor  # (N,) non-degenerate UV triangle
    dens: torch.Tensor  # (N,) the triangle's ‖duv/dp‖ (cone LOD)


def _uv_at_hit(scene: Scene, hit) -> SurfaceUV:
    """Interpolated UV and world-space UV tangents at the hits: with
    p = v0 + u·e0 + v·e1 and uv = uv0 + u·duv1 + v·duv2,
    dpdu = (dv2·e0 − dv1·e1)/det and dpdv = (du1·e1 − du2·e0)/det."""
    uv3 = scene.tri_uv[hit.tri]
    w = (1.0 - hit.u - hit.v)[..., None]
    uv = w * uv3[:, 0] + hit.u[..., None] * uv3[:, 1] + hit.v[..., None] * uv3[:, 2]
    duv1 = uv3[:, 1] - uv3[:, 0]
    duv2 = uv3[:, 2] - uv3[:, 0]
    e0 = scene.tri_e0[hit.tri]
    e1 = scene.tri_e1[hit.tri]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    dpdu = (duv2[:, 1:2] * e0 - duv1[:, 1:2] * e1) * inv_det[:, None]
    dpdv = (duv1[:, 0:1] * e1 - duv2[:, 0:1] * e0) * inv_det[:, None]
    return SurfaceUV(uv, dpdu, dpdv, ok, scene.tri_uvdens[hit.tri])


def _textured_mat(scene: Scene, cfg, mat, hit, suv: SurfaceUV, cone_w, wo):
    """The gathered material with its albedo and roughness replaced by
    texture fetches at the hits. Trilinear filtering covers the
    footprint's major axis (the cone's surface ellipse stretches by 1/cosθ
    at grazing incidence); ``cfg.texture_filter == "ewa"`` instead filters
    each tap at the minor axis' LOD and spreads taps along the major."""
    uv, dens = suv.uv, suv.dens
    use_ewa = cfg.texture_filter == "ewa"
    if use_ewa:
        duv_major, _ = cone_ellipse_uv(cone_w, dens, wo, hit.normal, suv.dpdu, suv.dpdv)
        cone_iso = cone_w
    else:
        cos_t = torch.abs(dot(wo, hit.normal))
        cone_iso = cone_w / torch.clamp(cos_t, min=1.0 / MAX_ANISO)

    def fetch(tid):
        if use_ewa:
            lod = raycone_lod(scene.textures, tid, cone_w, dens)
            return sample_ewa(scene.textures, tid, uv, duv_major, lod)
        return sample_trilinear(
            scene.textures, tid, uv, raycone_lod(scene.textures, tid, cone_iso, dens)
        )

    has_alb = mat.albedo_tex >= 0
    albedo = torch.where(
        has_alb[..., None], fetch(torch.clamp(mat.albedo_tex, min=0)), mat.albedo
    )
    has_r = mat.rough_tex >= 0
    rough = fetch(torch.clamp(mat.rough_tex, min=0))[:, 0]
    alpha = sqr(rough)
    return mat._replace(
        albedo=albedo,
        alphax=torch.where(has_r, alpha, mat.alphax),
        alphay=torch.where(has_r, alpha, mat.alphay),
        on_sigma=torch.where(has_r, rough * (torch.pi / 2.0), mat.on_sigma),
    )


def _normal_mapped(scene: Scene, mat, hit, suv: SurfaceUV, ns, cone_w):
    """``ns`` perturbed by the material's tangent-space normal map, in the
    frame of dpdu Gram-Schmidt'ed against ``ns`` with the bitangent's
    handedness from dpdv, flipped into the incident hemisphere. Unchanged
    where the material has no normal map or the UVs are degenerate."""
    tid = torch.clamp(mat.normal_tex, min=0)
    texel = sample_trilinear(
        scene.textures, tid, suv.uv, raycone_lod(scene.textures, tid, cone_w, suv.dens)
    )
    n_t = 2.0 * texel - 1.0  # tangent space, z out of the surface
    dpdu = suv.dpdu
    tang = dpdu - ns * dot(ns, dpdu, keepdim=True)
    tlen = torch.sqrt(torch.clamp(dot(tang, tang), min=1e-20))
    tang = tang / tlen[:, None]
    bita = cross(ns, tang)
    handed = torch.where(dot(bita, suv.dpdv) < 0.0, -1.0, 1.0)
    bita = bita * handed[:, None]
    n_new = n_t[:, 0:1] * tang + n_t[:, 1:2] * bita + n_t[:, 2:3] * ns
    bad = dot(n_new, n_new) < 1e-12
    n_new = normalize(torch.where(bad[:, None], ns, n_new))
    flip = dot(n_new, hit.normal, keepdim=True) < 0.0
    n_new = torch.where(flip, -n_new, n_new)
    use = (mat.normal_tex >= 0) & suv.ok & (tlen > 1e-10)
    return torch.where(use[:, None], n_new, ns)


def _count_texture_rows(mat, alive) -> None:
    """The rows handed to the texture fetches, every row once per map
    (``tex.query``), and, while recording, those of a live path whose
    material has that map (``tex.live``)."""
    ids = (mat.albedo_tex, mat.rough_tex, mat.normal_tex)
    trace.count("tex.query", len(ids) * alive.shape[0])
    if trace.is_recording():
        trace.count_device("tex.live", (torch.stack(ids) >= 0) & alive)


def _count_tree_rows(alive, rec_of_tri=None) -> None:
    """The rows handed to a light-tree descent or pmf replay
    (``lighttree.query``), and, while recording, those whose answer is
    used (``lighttree.live``): a descent's live paths, a replay's live
    paths that hit an emissive triangle with a record (``rec_of_tri``
    ≥ 0)."""
    trace.count("lighttree.query", alive.shape[0])
    if trace.is_recording():
        used = alive if rec_of_tri is None else alive & (rec_of_tri >= 0)
        trace.count_device("lighttree.live", used)


def _shading_normal(scene: Scene, hit):
    """Barycentric interpolation of the per-corner shading normals,
    aligned with the incident-side geometric normal; the geometric normal
    where the scene has none or the interpolation degenerates."""
    if scene.tri_ns is None:
        return hit.normal
    n3 = scene.tri_ns[hit.tri]
    w = (1.0 - hit.u - hit.v)[..., None]
    ns = w * n3[:, 0] + hit.u[..., None] * n3[:, 1] + hit.v[..., None] * n3[:, 2]
    bad = dot(ns, ns, keepdim=True) < 1e-12
    ns = normalize(torch.where(bad, hit.normal, ns))
    flip = dot(ns, hit.normal, keepdim=True) < 0.0
    return torch.where(flip, -ns, ns)


def _shadow_connection(scene: Scene, cfg, hit, mat, wo, inside, ns, alive, direction, distance, live):
    """One light sample's BSDF about ``ns`` and shadow ray up to ``distance``
    → (f·cosθ, BSDF pdf, occluded). The ray is live (not parked) where
    ``live``, f·cosθ > 0 and ``alive`` hold; with ``live`` None, where
    ``alive`` does."""
    f_cos, bsdf_pdf = eval_bsdf(mat, wo, direction, ns, hit.normal, inside, ft=cfg.features)
    shadow_live = alive
    if live is not None:
        shadow_live = live & (max_component(f_cos) > 0.0) & alive
    shadow_o = offset_ray_origin(hit.pos, hit.error, hit.normal, direction)
    occluded = query.occluded(scene, cfg, shadow_o, direction, distance, alive=shadow_live)
    return f_cos, bsdf_pdf, occluded


def _nee(scene: Scene, cfg, sampler: R.Sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive, ns):
    """Next-event estimation at the hit points → (N,3) contribution, the
    BSDF evaluated about the shading normal ``ns``."""
    n_lights = scene.num_lights
    ul = sampler.sample_1d(px, py, sample, depth_dim + R.Dim.LIGHT_SELECT)
    light_idx = torch.clamp((ul * n_lights).to(torch.int64), max=n_lights - 1)
    lt = scene.lights.gather(light_idx)
    pmf = 1.0 / n_lights

    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.LIGHT_U)
    ls = sample_light(lt, hit.pos, u1, u2, hit.normal, types=scene.light_types)
    direction, distance, pdf = ls.direction, ls.distance, ls.pdf
    le = eval_light(lt, ls)
    is_area = None
    if scene.emissive is not None:
        # area rows sample the emissive set by area; the shadow ray stops
        # just short of the sampled point
        is_area = lt.ltype == AREA
        _, d_a, dist_a, pdf_a, le_a = sample_area_light(
            scene.emissive, hit.pos, u1, u2
        )
        direction = torch.where(is_area[..., None], d_a, direction)
        distance = torch.where(is_area, dist_a * 0.999, distance)
        pdf = torch.where(is_area, pdf_a, pdf)
        le = torch.where(is_area[..., None], le_a, le)

    f_cos, bsdf_pdf, occluded = _shadow_connection(
        scene, cfg, hit, mat, wo, inside, ns, alive, direction, distance, pdf > 0.0
    )

    # point/spot/directional lights are not scene geometry: NEE is their
    # only estimator, so no MIS weight and no division by the cone pdf (the
    # 1/d² falloff is already in le)
    contrib = le * f_cos / pmf
    if ENV in scene.light_types:
        # constant-environment rows are extended lights sampled by uniform
        # sphere: divide by that pdf
        contrib = torch.where(
            (lt.ltype == ENV)[..., None],
            le * f_cos / (pmf * torch.clamp(pdf, min=1e-12))[..., None],
            contrib,
        )
    if is_area is not None:
        # area lights are geometry: power-heuristic MIS against the BSDF
        # estimator on the full density pmf·pdf
        pdf_total = pdf * pmf
        w = sqr(pdf_total) / torch.clamp(sqr(pdf_total) + sqr(bsdf_pdf), min=1e-24)
        contrib_area = le * f_cos * (w / torch.clamp(pdf_total, min=1e-12))[..., None]
        contrib = torch.where(is_area[..., None], contrib_area, contrib)
    ok = (pdf > 0.0) & ~occluded
    return torch.where(ok[..., None], contrib, 0.0)


def _tree_record_nee(scene: Scene, cfg, rec, pmf, hit, mat, wo, inside, u1, u2, alive, ns):
    """Contribution of one light-tree record (a point/spot row or an
    emissive triangle) selected with pmf ``pmf``; one shadow ray."""
    tree = scene.light_tree
    kind = tree.rec_kind[rec]
    idx = tree.rec_idx[rec].to(torch.int64)

    # light-table rows (point/spot): not geometry, NEE only
    lt = scene.lights.gather(torch.where(kind == REC_ROW, idx, 0))
    ls = sample_light(lt, hit.pos, u1, u2, hit.normal, types=scene.light_types)
    direction, distance, pdf = ls.direction, ls.distance, ls.pdf
    le = eval_light(lt, ls)
    is_tri = kind == REC_TRI

    # emissive-triangle records: a uniform point on that triangle
    if scene.emissive is not None:
        em = scene.emissive
        k = torch.where(is_tri, idx, 0)
        tv0, te0, te1, trad = em.v0[k], em.e0[k], em.e1[k], em.rad[k]
        su = safe_sqrt(u1)
        b1 = 1.0 - su
        b2 = u2 * su
        p = tv0 + b1[..., None] * te0 + b2[..., None] * te1
        n_e = cross(te0, te1)
        area2 = torch.clamp(length(n_e), min=1e-12)
        n_e = n_e / area2[..., None]
        to_p = p - hit.pos
        d2 = torch.clamp(dot(to_p, to_p), min=1e-12)
        dist = torch.sqrt(d2)
        d_tri = to_p / dist[..., None]
        cos_l = torch.abs(dot(d_tri, n_e))
        pdf_tri = torch.where(
            cos_l > 1e-6, d2 / torch.clamp(cos_l * 0.5 * area2, min=1e-12), 0.0
        )
        direction = torch.where(is_tri[..., None], d_tri, direction)
        distance = torch.where(is_tri, dist * 0.999, distance)
        pdf = torch.where(is_tri, pdf_tri, pdf)
        le = torch.where(is_tri[..., None], trad, le)

    f_cos, bsdf_pdf, occluded = _shadow_connection(
        scene, cfg, hit, mat, wo, inside, ns, alive, direction, distance, (pdf > 0.0) & (pmf > 0.0)
    )

    # rows: NEE only, divided by the selection pmf; triangles: power-
    # heuristic MIS on the full density pmf·pdf
    contrib = le * f_cos / torch.clamp(pmf, min=1e-12)[..., None]
    if scene.emissive is not None:
        pdf_total = pdf * pmf
        w = sqr(pdf_total) / torch.clamp(sqr(pdf_total) + sqr(bsdf_pdf), min=1e-24)
        contrib_tri = le * f_cos * (w / torch.clamp(pdf_total, min=1e-12))[..., None]
        contrib = torch.where(is_tri[..., None], contrib_tri, contrib)
    ok = (pdf > 0.0) & (pmf > 0.0) & ~occluded
    return torch.where(ok[..., None], contrib, 0.0)


def _nee_tree(scene: Scene, cfg, sampler: R.Sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive, ns):
    """Light-tree NEE: below each live root of the deterministic split
    (``cfg.nee_splits`` subtrees) one importance descent and one shadow
    ray (dims ``TREE_U + 3·slot``); the infinite rows (environment,
    directional) outside the tree each sampled every bounce (pmf 1)."""
    tree = scene.light_tree
    _, roots = split_frontier(tree, cfg.nee_splits)
    total = torch.zeros_like(hit.pos)
    for slot, root in enumerate(roots):
        if root < 0:
            continue
        base = depth_dim + R.Dim.TREE_U + 3 * slot
        u_sel = sampler.sample_1d(px, py, sample, base)
        u1, u2 = sampler.sample_2d(px, py, sample, base + 1)
        with trace.span("pt.lighttree"):
            rec, pmf = sample_light_tree(tree, hit.pos, hit.normal, u_sel, root=root)
        _count_tree_rows(alive)
        total = total + _tree_record_nee(
            scene, cfg, rec, pmf, hit, mat, wo, inside, u1, u2, alive=alive, ns=ns,
        )
    n = hit.pos.shape[0]
    for k in range(tree.n_infinite):
        lt = scene.lights.gather(tree.infinite_rows[k].to(torch.int64).expand(n))
        u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.LIGHT_U)
        ls = sample_light(lt, hit.pos, u1, u2, hit.normal, types=scene.light_types)
        le = eval_light(lt, ls)
        f_cos, _, occluded = _shadow_connection(
            scene, cfg, hit, mat, wo, inside, ns, alive, ls.direction, ls.distance, None
        )
        # environment rows are extended (uniform-sphere) lights: divide by the pdf
        c_inf = torch.where(
            (lt.ltype == ENV)[..., None],
            le * f_cos / torch.clamp(ls.pdf, min=1e-12)[..., None],
            le * f_cos,
        )
        ok = (ls.pdf > 0.0) & ~occluded
        total = total + torch.where(ok[..., None], c_inf, 0.0)
    return total


def _nee_env(scene: Scene, cfg, sampler: R.Sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive, ns):
    """Environment-map NEE at the hit points, power-heuristic MIS against
    BSDF sampling → (N,3) contribution."""
    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.ENV_U)
    d_env, le, pdf_env = sample_envmap(scene.env, u1, u2)
    f_cos, bsdf_pdf, occluded = _shadow_connection(
        scene, cfg, hit, mat, wo, inside, ns, alive, d_env, 3.0e38, pdf_env > 0.0
    )
    w = sqr(pdf_env) / torch.clamp(sqr(pdf_env) + sqr(bsdf_pdf), min=1e-24)
    contrib = le * f_cos * (w / torch.clamp(pdf_env, min=1e-12))[..., None]
    ok = (pdf_env > 0.0) & ~occluded
    return torch.where(ok[..., None], contrib, 0.0)


def bounce_step(scene: Scene, cfg, sampler, px, py, sample, depth: int, state: PathState) -> PathState:
    """One path-tracing bounce over the full ray batch."""
    with trace.span("pt.bounce", depth=depth):
        depth_dim = depth * R.DIMS_PER_BOUNCE
        hit = query.closest(scene, cfg, state.o, state.d, alive=state.alive)
        with trace.span("pt.shade"):
            # miss → environment, path dies; when the environment is also
            # NEE-sampled, MIS-weighted against the last bounce's bsdf pdf (delta
            # prefixes keep full weight)
            miss = state.alive & ~hit.hit
            if cfg.env_nee:
                le_env, pdf_env_of_d = eval_envmap(scene.env, state.d)
                w_env = torch.where(
                    state.prev_delta,
                    1.0,
                    sqr(state.prev_pdf)
                    / torch.clamp(sqr(state.prev_pdf) + sqr(pdf_env_of_d), min=1e-24),
                )
                env_term = state.beta * le_env * w_env[..., None]
            else:
                env_term = state.beta * env_radiance(scene.env, state.d)
            radiance = state.radiance + torch.where(miss[..., None], env_term, 0.0)
            alive = state.alive & hit.hit

            wo = -state.d
            textured = scene.textures is not None
            mat = scene.materials.gather(scene.tri_mat[hit.tri].to(torch.int64), textured=textured)
            ns = _shading_normal(scene, hit)
            cone_at_hit = None
            if textured:
                with trace.span("pt.texture"):
                    # the ray cone's width at the hit drives the mip selection
                    cone_at_hit = state.cone_w + state.cone_s * torch.abs(hit.t)
                    suv = _uv_at_hit(scene, hit)
                    mat = _textured_mat(scene, cfg, mat, hit, suv, cone_at_hit, wo)
                    ns = _normal_mapped(scene, mat, hit, suv, ns, cone_at_hit)
                # outside pt.texture, so the span holds the fetches alone
                _count_texture_rows(mat, alive)
            use_tree = _tree_on(cfg, scene)
            if scene.emissive is not None:
                # directly-hit emitter, MIS-weighted against the NEE estimator
                # (weight 1 after delta bounces and the camera)
                cos_l = torch.abs(dot(state.d, hit.normal))
                if use_tree and scene.tri_emrec is not None:
                    # NEE's density for this triangle: the tree's pmf from the last
                    # shading point times the triangle's own area pdf
                    levels, _ = split_frontier(scene.light_tree, cfg.nee_splits)
                    rec_of_tri = scene.tri_emrec[hit.tri]
                    rec_hit = torch.clamp(rec_of_tri, min=0)
                    with trace.span("pt.lighttree"):
                        pmf_sel = light_tree_pmf(
                            scene.light_tree, rec_hit, state.o, state.prev_n, split_levels=levels
                        )
                    _count_tree_rows(alive, rec_of_tri)
                    area_tri = 0.5 * length(cross(scene.tri_e0[hit.tri], scene.tri_e1[hit.tri]))
                    pdf_hit = sqr(hit.t) / torch.clamp(cos_l * area_tri, min=1e-12) * pmf_sel
                else:
                    pdf_hit = (
                        sqr(hit.t)
                        / torch.clamp(cos_l * scene.emissive.area, min=1e-12)
                        * (1.0 / scene.num_lights)
                    )
                w_em = torch.where(
                    state.prev_delta,
                    1.0,
                    sqr(state.prev_pdf)
                    / torch.clamp(sqr(state.prev_pdf) + sqr(pdf_hit), min=1e-24),
                )
                radiance = radiance + torch.where(
                    alive[..., None], state.beta * mat.emission * w_em[..., None], 0.0
                )
        with trace.span("pt.nee"):
            nee = (_nee_tree if use_tree else _nee)(
                scene, cfg, sampler, px, py, sample, depth_dim, hit, mat, wo, state.inside,
                alive=alive, ns=ns,
            )
            if cfg.env_nee:
                nee = nee + _nee_env(
                    scene, cfg, sampler, px, py, sample, depth_dim, hit, mat, wo, state.inside,
                    alive=alive, ns=ns,
                )
            radiance = radiance + torch.where(alive[..., None], state.beta * nee, 0.0)
        with trace.span("pt.bsdf"):
            stage = bsdf_step if _bsdf_kernel_route(cfg, scene, state) else bsdf_step_plain
            return stage(
                cfg, sampler, px, py, sample, depth, state, hit, mat, wo, ns, alive, radiance,
                cone_at_hit,
            )


def _bsdf_kernel_route(cfg, scene: Scene, state: PathState) -> bool:
    """Does ``pt_bsdf_step`` run this bounce's BSDF stage: the kernel
    route (``backend`` not "torch"), rows on the card, and no autograd
    graph recorded (the kernel has no backward, so a gradient's forward
    and replay keep the plain stage)?"""
    return cfg.backend != "torch" and state.o.is_cuda and not _needs_grad(scene, state)


def trace_paths(scene: Scene, cfg: MegakernelConfig, px, py, sample, o, d, device="cuda",
                qmc_dims: int = R.QMC_DIMS):
    """Trace one sample per ray for rays (o, d) → radiance (N,3).

    ``px, py`` are int64 pixel coordinates (RNG keys in [0, 2^32)),
    ``sample`` the global sample index (int or (N,) int64 tensor). Every
    input moves to ``device``. ``qmc_dims``: the Halton sampler's leading
    dimensions.
    """
    _validate(cfg)
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    with trace.span("pt.trace"):
        px, py, o, d = (x.to(dev) for x in (px, py, o, d))
        if torch.is_tensor(sample):
            sample = sample.to(dev)
        sampler = R.Sampler(cfg.sampler, cfg.seed, qmc_dims)
        state = camera_path_state(scene, cfg, o, d)

        def bounces(depths, state):
            for depth in depths:
                state = bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
            return state

        if cfg.remat and _needs_grad(scene, state):
            # path replay: the backward pass recomputes each group of
            # remat_every bounces from its input state and the counter-based
            # RNG (no stateful generator is drawn from, so the RNG state is not
            # stashed). Non-reentrant checkpointing keeps the gradients to the
            # scene's tables, which the bounces close over. Spans opened by
            # the recomputation end in ":replay" (utils/trace.py).
            k = cfg.remat_every
            for start in range(0, cfg.max_depth, k):
                depths = range(start, min(start + k, cfg.max_depth))
                state = checkpoint(
                    bounces, depths, state, use_reentrant=False, preserve_rng_state=False
                )
            return state.radiance
        return bounces(range(cfg.max_depth), state).radiance


def _needs_grad(scene: Scene, state: PathState) -> bool:
    """Will autograd record this trace: grad on, and a tensor of the scene
    or of the path state requiring it? A forward-only render keeps the
    plain loop."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(x) -> bool:
        if torch.is_tensor(x):
            return x.requires_grad
        if isinstance(x, tuple):
            return any(any_grad(f) for f in x)
        return False

    return any_grad(scene) or any_grad(state)


def _use_morton(cfg, scene, width, height) -> bool:
    if cfg.pixel_order == "morton":
        return is_pot_square(width, height)
    if cfg.pixel_order == "auto":
        return scene.bvh is not None and is_pot_square(width, height)
    return False


def _camera_kernel_route(dev, cfg: MegakernelConfig, sample, mats) -> bool:
    """Does the camera kernel serve this pass: a CUDA scene, the box
    filter, a Python int sample, and camera matrices ``mats`` that need no
    gradient?"""
    return (
        dev.type == "cuda"
        and cfg.pixel_filter == "box"
        and isinstance(sample, int)
        and not any(m.requires_grad for m in mats)
    )


def camera_plain(scene: Scene, cfg: MegakernelConfig, width, height, sample, nspp: int = 1):
    """``camera_batch``'s plain route, and the camera kernel's plain
    version: pixel centres (gathered into Morton order on the host's
    permutation), the sampler's keys and ``generate_rays``, op by op."""
    dev = scene.device
    pix = pixel_centers(width, height, dev)
    morton = _use_morton(cfg, scene, width, height)
    if morton:
        pix = pix[torch.as_tensor(morton_pixel_order(width, height), device=dev)]
    if nspp > 1:
        pix = pix.repeat(nspp, 1)
        sample = sample + torch.repeat_interleave(
            torch.arange(nspp, dtype=torch.int64, device=dev), width * height
        )
    px = pix[:, 0].to(torch.int64)
    py = pix[:, 1].to(torch.int64)
    sampler = R.Sampler(cfg.sampler, cfg.seed)
    u1, u2 = sampler.sample_2d(px, py, sample, R.Dim.CAMERA_U)
    fw = None
    if cfg.pixel_filter == "mitchell":
        dx, dy, fw = sample_filter(filter_sampler(str(dev)), u1, u2)
        p_film = pix + 0.5 + torch.stack([dx, dy], dim=-1)
    else:
        p_film = pix + torch.stack([u1, u2], dim=-1)
    o, d = generate_rays(p_film, scene.cam_from_raster, scene.world_from_cam)
    return px, py, sample, o, d, fw, morton


def camera_batch(scene: Scene, cfg: MegakernelConfig, width, height, sample, nspp: int = 1):
    """Camera rays of ``nspp`` samples of every pixel, in the render's
    pixel order → (px, py, sample, o, d, filter weight or None, morton),
    inside the span ``pt.camera``.

    Two routes with the same values: one launch of the camera kernel
    (``megakernel_cuda.camera_rays_fused``, counted as
    ``launches.camera_rays``) for a CUDA scene with the box filter, a
    Python int ``sample`` and camera matrices that need no gradient;
    ``camera_plain`` otherwise (CPU scenes, the Mitchell filter, a tensor
    ``sample``, matrices being optimised)."""
    with trace.span("pt.camera"):
        mats = (scene.cam_from_raster, scene.world_from_cam)
        if not _camera_kernel_route(scene.device, cfg, sample, mats):
            return camera_plain(scene, cfg, width, height, sample, nspp)
        from .megakernel_cuda import camera_rays_fused

        morton = _use_morton(cfg, scene, width, height)
        px, py, sample, o, d = camera_rays_fused(
            scene, width, height, sample, nspp, morton, cfg.seed, cfg.sampler
        )
        return px, py, sample, o, d, None, morton


def batch_image(radiance, fw, morton: bool, width, height, nspp: int = 1):
    """Radiance of a ``camera_batch`` → (nspp, H, W, 3) image, or (H, W,
    3) when nspp == 1: weighted by the filter, back in raster order."""
    with trace.span("pt.film"):
        if fw is not None:
            radiance = radiance * fw[:, None]
        if morton:
            img = unmorton_image(radiance.reshape(nspp, height * width, 3), height, width)
            return img if nspp > 1 else img[0]
        if nspp > 1:
            return radiance.reshape(nspp, height, width, 3)
        return radiance.reshape(height, width, 3)


def render_sample_batch(scene: Scene, cfg: MegakernelConfig, width, height, sample, nspp: int = 1):
    """Render ``nspp`` samples for every pixel → (nspp, H, W, 3) radiance,
    or (H, W, 3) when nspp == 1. The scene's device is the render's."""
    with trace.span("pt.pass"):
        px, py, sample, o, d, fw, morton = camera_batch(scene, cfg, width, height, sample, nspp)
        if cfg.fused == "auto":
            cfg = resolve_fused(scene, cfg)
        if cfg.fused == "on":
            from .megakernel_cuda import trace_paths_fused

            radiance = trace_paths_fused(
                scene, px, py, sample, o, d,
                max_depth=cfg.max_depth, rr_start_depth=cfg.rr_start_depth,
                seed=cfg.seed, sampler=cfg.sampler,
            )
        else:
            radiance = trace_paths(scene, cfg, px, py, sample, o, d, device=scene.device)
        return batch_image(radiance, fw, morton, width, height, nspp)


def render_progressive(scene: Scene, film: Film, cfg: MegakernelConfig, width, height, sample_offset, kspp, spp_per_pass: int = 1, device="cuda"):
    """Accumulate ``kspp`` samples into the film starting at
    ``sample_offset``; ``spp_per_pass`` samples are traced as one
    flattened ray batch per pass and must divide ``kspp``."""
    if kspp % spp_per_pass:
        raise ValueError(f"kspp={kspp} not divisible by spp_per_pass={spp_per_pass}")
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    film = Film(*(x.to(dev) for x in film))
    with trace.span("pt.batch", sample_offset=sample_offset, kspp=kspp):
        for k in range(0, kspp, spp_per_pass):
            radiance = render_sample_batch(
                scene, cfg, width, height, int(sample_offset) + k, nspp=spp_per_pass
            )
            with trace.span("pt.film"):
                if spp_per_pass > 1:
                    film = film_add_batch(film, radiance)
                else:
                    film = film_add_sample(film, radiance)
    return film


def render(scene: Scene, width: int, height: int, spp: int, cfg: MegakernelConfig | None = None, kspp: int = 4, film: Film | None = None, progress_cb=None, spp_per_pass: int = 1, device="cuda"):
    """Host-side progressive render loop (checkpointable between
    batches of ``kspp`` samples)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    cfg = resolve_fused(scene, cfg or MegakernelConfig())
    film = film if film is not None else film_new(height, width, dev)
    done = int(film.n)
    while done < spp:
        batch = min(kspp, spp - done)
        per_pass = spp_per_pass if batch % spp_per_pass == 0 else 1
        film = render_progressive(
            scene, film, cfg, width, height, done, batch, per_pass, device=dev
        )
        done += batch
        if cfg.debug:
            bad = int(torch.count_nonzero(~torch.isfinite(film.mean)))
            if bad:
                raise FloatingPointError(
                    f"NaN guard: film holds {bad} non-finite values after "
                    f"sample batch ending at spp={done}"
                )
        if progress_cb is not None:
            progress_cb(film, done)
    return film

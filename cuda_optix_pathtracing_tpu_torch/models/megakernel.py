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
shading point (``PathState.prev_n``, carried only then). Instanced scenes
(``Scene.instances``) run each query once per instance: rays that miss
the instance's world box are parked, the rest transformed into object
space (explicit float32 mul-adds, the direction left unnormalized so t is
shared) and sent to the kernel of that mesh's own tables, the closest
hit min-reduced over the instances. Both take ``fused="off"``: the fused
gate refuses them.

Two routes down the same path:

- ``fused="on"``: ``models/megakernel_cuda.trace_paths_fused``, the whole
  path loop in one CUDA kernel (one thread per path);
- ``fused="off"``: ``trace_paths`` below, a Python depth loop of dense
  masked bounce steps over the ray batch, whose closest-hit and shadow
  queries go to the CUDA kernels for CUDA tensors (brute force,
  ``ops/intersect_cuda.py``; BVH scenes, ``ops/bvh_cuda.py``, on rays
  stably sorted by octant and origin with dead rays parked) and to the
  plain sweep, unsorted, for CPU tensors.

BVH scenes render their camera rays in Morton pixel order when the image
is a power-of-two square (``pixel_order``), so neighbouring rays start in
neighbouring pixels.

Camera samples: a box filter (uniform jitter in the pixel) or the
Mitchell filter, importance-sampled through its tabulated CDF
(``ops/filters.py``), each sample weighted by the filter's sign. Random
numbers: the hash sampler or Owen-scrambled Halton (``ops/rng.py``).

``trace_paths`` with ``backend="torch"`` is the plain version of the fused
kernel and of the intersection kernels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import bvh_cuda, intersect_cuda
from ..ops import rng as R
from ..ops.bsdf import ALL_FEATURES, MatFeatures, eval_bsdf, sample_bsdf
from ..ops.camera import generate_rays, pixel_centers
from ..ops.envmap import env_radiance, eval_envmap, sample_envmap
from ..ops.film import Film, film_add_batch, film_add_sample, film_new
from ..ops.filters import filter_sampler, sample_filter
from ..ops.intersect import BIG_T, closest_epilogue, intersect_any, intersect_closest_raw
from ..ops.light_tree import REC_ROW, REC_TRI, light_tree_pmf, sample_light_tree, split_frontier
from ..ops.lights import AREA, ENV, eval_light, sample_area_light, sample_light
from ..ops.morton import is_pot_square, morton_pixel_order, unmorton_image
from ..ops.raysort import ray_sort_key, sorted_apply, sorted_apply_tmax
from ..ops.shade_tables import BRUTE_ROW_WORDS
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
    # direction octant | origin Morton before the BVH kernels (kernel
    # route only); auto = on whenever the scene has a BVH
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


def _use_kernels(cfg: MegakernelConfig, t: torch.Tensor) -> bool:
    if cfg.backend == "torch":
        return False
    if cfg.backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return t.is_cuda


def _sort_on(cfg, scene) -> bool:
    if cfg.sort_rays == "auto":
        return scene.bvh is not None
    return cfg.sort_rays == "on"


_DEAD_ORIGIN = 1.0e9  # parked origin of a dead ray: outside every box
_DEAD_DIR = (0.57735027, 0.57735027, 0.57735027)  # +octant, pointing away


def _park_dead(o, d, alive):
    """Move dead rays far away, pointing away from the scene: their
    traversal ends at the root, and their results are masked anyway."""
    if alive is None:
        return o, d
    m = alive[:, None]
    return (
        torch.where(m, o, _DEAD_ORIGIN),
        torch.where(m, d, torch.tensor(_DEAD_DIR, dtype=d.dtype, device=d.device)),
    )


def _sort_key(scene: Scene, o, d, alive):
    return ray_sort_key(o, d, scene.bounds[0], scene.bounds[1], alive)


def _brute_rows(scene: Scene):
    """The brute-force kernels' 48 B triangle rows: the head of the
    scene's ``brute_tables`` (a view, built once per scene)."""
    return scene.brute_tables[: BRUTE_ROW_WORDS * scene.tri_v0.shape[0]]


def _affine_pts(a, p):
    """A (3,4) affine [R|t] applied to (N,3) points with explicit float32
    multiply-adds: a matrix product may round through TF32 or bf16 and
    shift origins far enough to self-shadow."""
    return torch.stack(
        [p[:, 0] * a[i, 0] + p[:, 1] * a[i, 1] + p[:, 2] * a[i, 2] + a[i, 3] for i in range(3)],
        dim=-1,
    )


def _affine_vecs(a, v):
    """The linear part only (directions)."""
    return torch.stack(
        [v[:, 0] * a[i, 0] + v[:, 1] * a[i, 1] + v[:, 2] * a[i, 2] for i in range(3)], dim=-1
    )


def _rows_pts(rows, p):
    """Per-ray (N,3,4) affines applied to (N,3) points (float32 mul-adds)."""
    return torch.sum(rows[:, :, :3] * p[:, None, :], dim=-1) + rows[:, :, 3]


def _rows_vecs(rows, v):
    return torch.sum(rows[:, :, :3] * v[:, None, :], dim=-1)


def _rows_vecs_t(rows, v):
    """The transposed linear part (normals: M⁻ᵀ)."""
    return torch.sum(rows[:, :, :3] * v[:, :, None], dim=-2)


def _ray_box_hit(o, d, lo, hi):
    """(N,) bool: does the forward ray meet the box (lo, hi)? Parked rays
    (far origin, pointing away) never do."""
    tiny = 1e-12
    inv = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return tf >= torch.clamp(tn, min=0.0)


def _closest_raw_mesh(cfg, o, d, mesh):
    """(t, local row) of the rays on one instance's mesh tables: kernel 4
    for a BVH mesh, kernel 2 otherwise, the plain sweep for CPU tensors."""
    if not _use_kernels(cfg, o):
        return intersect_closest_raw(o, d, mesh.tri_v0, mesh.tri_e0, mesh.tri_e1, cfg.tri_chunk)
    if mesh.bvh is not None:
        return bvh_cuda.bvh_closest_raw(o, d, mesh)
    return intersect_cuda.closest_bruteforce(
        o, d, mesh.tri_v0, mesh.tri_e0, mesh.tri_e1, rows=mesh.tri_rows
    )


def _any_raw_mesh(cfg, o, d, t_max, mesh):
    """(N,) bool occlusion of the rays on one instance's mesh tables."""
    if not _use_kernels(cfg, o):
        return intersect_any(o, d, mesh.tri_v0, mesh.tri_e0, mesh.tri_e1, t_max, cfg.tri_chunk)
    if mesh.bvh is not None:
        return bvh_cuda.bvh_any_raw(o, d, mesh, t_max) > 0
    return intersect_cuda.anyhit_bruteforce(
        o, d, mesh.tri_v0, mesh.tri_e0, mesh.tri_e1, t_max, rows=mesh.tri_rows
    )


def _inst_sort_on(cfg, inst, o) -> bool:
    """Sort instanced queries (kernel route only): on, or auto with a BVH
    mesh among the instances."""
    if not _use_kernels(cfg, o):
        return False
    if cfg.sort_rays == "auto":
        return any(m.bvh is not None for m in inst.meshes)
    return cfg.sort_rays == "on"


def _inst_park(o, d, keep):
    m = keep[:, None]
    return (
        torch.where(m, o, _DEAD_ORIGIN),
        torch.where(m, d, torch.tensor(_DEAD_DIR, dtype=d.dtype, device=d.device)),
    )


def _instance_rays(inst, k, o, d):
    """Instance ``k``'s object-space rays and the mask of the rays that
    meet its world box; the others parked."""
    a = inst.obj_from_world[k]
    o_k = _affine_pts(a, o)
    d_k = _affine_vecs(a, d)
    if inst.bounds_lo is None:
        return o_k, d_k, None
    hit_box = _ray_box_hit(o, d, inst.bounds_lo[k], inst.bounds_hi[k])
    o_k, d_k = _inst_park(o_k, d_k, hit_box)
    return o_k, d_k, hit_box


def _closest_instanced(scene: Scene, cfg, o, d, alive=None):
    """Closest hit over the placed meshes: per instance, the rays that meet
    its world box, in object space (t is shared between the spaces, the
    object direction left unnormalized), on that mesh's tables; the
    nearest hit kept with its global row (local row + ``tstart``). One
    epilogue in the winner's object space over the scene's concatenated
    arrays, then position, normal (inverse transpose) and error bound
    back to world space."""
    inst = scene.instances
    o, d = _park_dead(o, d, alive)
    n = o.shape[0]

    def run(o_s, d_s):
        best_t = torch.full((n,), BIG_T, dtype=torch.float32, device=o.device)
        best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
        best_k = torch.zeros((n,), dtype=torch.int64, device=o.device)
        for k, mesh in enumerate(inst.meshes):
            o_k, d_k, hit_box = _instance_rays(inst, k, o_s, d_s)
            t, i = _closest_raw_mesh(cfg, o_k, d_k, mesh)
            better = t < best_t
            if hit_box is not None:
                better = better & hit_box
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, i + inst.tstart[k], best_i)
            best_k = torch.where(better, k, best_k)
        return best_t, best_i, best_k

    if _inst_sort_on(cfg, inst, o):
        best_t, best_i, best_k = sorted_apply(o, d, _sort_key(scene, o, d, alive), run)
    else:
        best_t, best_i, best_k = run(o, d)

    a_win = inst.obj_from_world[best_k]  # (N,3,4) each ray's instance
    m_win = inst.world_from_obj[best_k]
    hit = closest_epilogue(
        _rows_pts(a_win, o), _rows_vecs(a_win, d), scene.tri_v0, scene.tri_e0, scene.tri_e1,
        best_t, best_i,
    )
    return hit._replace(
        pos=_rows_pts(m_win, hit.pos),
        normal=normalize(_rows_vecs_t(a_win, hit.normal)),  # M⁻ᵀ = (obj_from_world)ᵀ
        error=_rows_vecs(torch.abs(m_win), hit.error),  # conservative |M|·err
    )


def _any_instanced(scene: Scene, cfg, o, d, t_max, alive=None):
    """Occlusion over the placed meshes: any instance's mesh hit below
    ``t_max`` (the box test is not clamped to ``t_max``)."""
    inst = scene.instances
    o, d = _park_dead(o, d, alive)
    n = o.shape[0]
    t_arr = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (n,)
    )

    def run(o_s, d_s, t_s):
        occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
        for k, mesh in enumerate(inst.meshes):
            o_k, d_k, hit_box = _instance_rays(inst, k, o_s, d_s)
            occ_k = _any_raw_mesh(cfg, o_k, d_k, t_s, mesh)
            occ = occ | (occ_k if hit_box is None else occ_k & hit_box)
        return occ

    if _inst_sort_on(cfg, inst, o):
        return sorted_apply_tmax(o, d, t_arr, _sort_key(scene, o, d, alive), run)
    return run(o, d, t_arr)


def _closest(scene: Scene, cfg, o, d, alive=None):
    if scene.instances is not None:
        return _closest_instanced(scene, cfg, o, d, alive)
    if not _use_kernels(cfg, o):
        t, i = intersect_closest_raw(
            o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, cfg.tri_chunk
        )
    elif scene.bvh is not None:
        o, d = _park_dead(o, d, alive)
        if _sort_on(cfg, scene):
            t, i = sorted_apply(
                o, d, _sort_key(scene, o, d, alive),
                lambda so, sd: bvh_cuda.bvh_closest_raw(so, sd, scene),
            )
        else:
            t, i = bvh_cuda.bvh_closest_raw(o, d, scene)
    else:
        t, i = intersect_cuda.closest_bruteforce(
            o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, rows=_brute_rows(scene)
        )
    return closest_epilogue(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t, i)


def _any(scene: Scene, cfg, o, d, t_max, alive=None):
    if scene.instances is not None:
        return _any_instanced(scene, cfg, o, d, t_max, alive)
    if not _use_kernels(cfg, o):
        return intersect_any(
            o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max, cfg.tri_chunk
        )
    if scene.bvh is not None:
        o, d = _park_dead(o, d, alive)
        if _sort_on(cfg, scene):
            occ = sorted_apply_tmax(
                o, d, t_max, _sort_key(scene, o, d, alive),
                lambda so, sd, st: bvh_cuda.bvh_any_raw(so, sd, scene, st),
            )
        else:
            occ = bvh_cuda.bvh_any_raw(o, d, scene, t_max)
        return occ > 0
    return intersect_cuda.anyhit_bruteforce(
        o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max, rows=_brute_rows(scene)
    )


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


# spread of a path after its first non-specular bounce: a diffuse
# reflection's footprint grows like a wide cone, pulling deeper bounces
# toward the coarsest (and cheapest) mips
DIFFUSE_CONE_SPREAD = 0.3


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


def _nee(scene: Scene, cfg, sampler: R.Sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive=None, ns=None):
    """Next-event estimation at the hit points → (N,3) contribution, the
    BSDF evaluated about the shading normal ``ns`` (default: geometric).
    Shadow rays of dead paths, and of samples whose contribution is zero
    anyway, are marked dead for the BVH kernels (parked, sorted last)."""
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

    f_cos, bsdf_pdf = eval_bsdf(
        mat, wo, direction, hit.normal if ns is None else ns, hit.normal, inside,
        ft=cfg.features,
    )
    shadow_live = (pdf > 0.0) & (max_component(f_cos) > 0.0)
    if alive is not None:
        shadow_live = shadow_live & alive
    shadow_o = offset_ray_origin(hit.pos, hit.error, hit.normal, direction)
    occluded = _any(scene, cfg, shadow_o, direction, distance, alive=shadow_live)

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


def _tree_record_nee(scene: Scene, cfg, rec, pmf, hit, mat, wo, inside, u1, u2, alive=None, ns=None):
    """Contribution of one light-tree record (a point/spot row or an
    emissive triangle) selected with pmf ``pmf``; one shadow ray, marked
    dead where the contribution is zero anyway."""
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

    f_cos, bsdf_pdf = eval_bsdf(
        mat, wo, direction, hit.normal if ns is None else ns, hit.normal, inside,
        ft=cfg.features,
    )
    shadow_live = (pdf > 0.0) & (pmf > 0.0) & (max_component(f_cos) > 0.0)
    if alive is not None:
        shadow_live = shadow_live & alive
    shadow_o = offset_ray_origin(hit.pos, hit.error, hit.normal, direction)
    occluded = _any(scene, cfg, shadow_o, direction, distance, alive=shadow_live)

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


def _nee_tree(scene: Scene, cfg, sampler: R.Sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive=None, ns=None):
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
        rec, pmf = sample_light_tree(tree, hit.pos, hit.normal, u_sel, root=root)
        total = total + _tree_record_nee(
            scene, cfg, rec, pmf, hit, mat, wo, inside, u1, u2, alive=alive, ns=ns,
        )
    n = hit.pos.shape[0]
    for k in range(tree.n_infinite):
        lt = scene.lights.gather(tree.infinite_rows[k].to(torch.int64).expand(n))
        u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.LIGHT_U)
        ls = sample_light(lt, hit.pos, u1, u2, hit.normal, types=scene.light_types)
        le = eval_light(lt, ls)
        shadow_o = offset_ray_origin(hit.pos, hit.error, hit.normal, ls.direction)
        occluded = _any(scene, cfg, shadow_o, ls.direction, ls.distance, alive=alive)
        f_cos, _ = eval_bsdf(
            mat, wo, ls.direction, hit.normal if ns is None else ns, hit.normal, inside,
            ft=cfg.features,
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


def _nee_env(scene: Scene, cfg, sampler: R.Sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive=None, ns=None):
    """Environment-map NEE at the hit points, power-heuristic MIS against
    BSDF sampling → (N,3) contribution."""
    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.ENV_U)
    d_env, le, pdf_env = sample_envmap(scene.env, u1, u2)
    f_cos, bsdf_pdf = eval_bsdf(
        mat, wo, d_env, hit.normal if ns is None else ns, hit.normal, inside,
        ft=cfg.features,
    )
    shadow_live = (pdf_env > 0.0) & (max_component(f_cos) > 0.0)
    if alive is not None:
        shadow_live = shadow_live & alive
    shadow_o = offset_ray_origin(hit.pos, hit.error, hit.normal, d_env)
    occluded = _any(scene, cfg, shadow_o, d_env, 3.0e38, alive=shadow_live)
    w = sqr(pdf_env) / torch.clamp(sqr(pdf_env) + sqr(bsdf_pdf), min=1e-24)
    contrib = le * f_cos * (w / torch.clamp(pdf_env, min=1e-12))[..., None]
    ok = (pdf_env > 0.0) & ~occluded
    return torch.where(ok[..., None], contrib, 0.0)


def bounce_step(scene: Scene, cfg, sampler, px, py, sample, depth: int, state: PathState) -> PathState:
    """One path-tracing bounce over the full ray batch."""
    n = state.o.shape[0]
    depth_dim = depth * R.DIMS_PER_BOUNCE
    hit = _closest(scene, cfg, state.o, state.d, alive=state.alive)

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
    if textured:
        # the ray cone's width at the hit drives the mip selection
        cone_at_hit = state.cone_w + state.cone_s * torch.abs(hit.t)
        suv = _uv_at_hit(scene, hit)
        mat = _textured_mat(scene, cfg, mat, hit, suv, cone_at_hit, wo)
        ns = _normal_mapped(scene, mat, hit, suv, ns, cone_at_hit)
    use_tree = _tree_on(cfg, scene)
    if scene.emissive is not None:
        # directly-hit emitter, MIS-weighted against the NEE estimator
        # (weight 1 after delta bounces and the camera)
        cos_l = torch.abs(dot(state.d, hit.normal))
        if use_tree and scene.tri_emrec is not None:
            # NEE's density for this triangle: the tree's pmf from the last
            # shading point times the triangle's own area pdf
            levels, _ = split_frontier(scene.light_tree, cfg.nee_splits)
            rec_hit = torch.clamp(scene.tri_emrec[hit.tri], min=0)
            pmf_sel = light_tree_pmf(
                scene.light_tree, rec_hit, state.o, state.prev_n, split_levels=levels
            )
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

    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.BSDF_U)
    uc = sampler.sample_1d(px, py, sample, depth_dim + R.Dim.BSDF_UC)
    bs = sample_bsdf(mat, wo, ns, hit.normal, u1, u2, uc, state.inside, ft=cfg.features)

    valid = bs.pdf > 0.0
    beta = state.beta * torch.where(
        valid[..., None], bs.f_cos / torch.clamp(bs.pdf, min=1e-12)[..., None], 1.0
    )
    alive = alive & valid
    o_new = offset_ray_origin(hit.pos, hit.error, hit.normal, bs.wi)
    inside = state.inside ^ (bs.refract & alive)
    eta_scale = torch.where(
        bs.refract & alive, state.eta_scale * sqr(bs.eta), state.eta_scale
    )

    # russian roulette on β·∏η² from rr_start_depth on
    rr_beta = max_component(beta) * eta_scale
    u_rr = sampler.sample_1d(px, py, sample, depth_dim + R.Dim.RR)
    q = torch.clamp(1.0 - rr_beta, min=0.0)
    do_rr = (rr_beta < 1.0) & (depth >= cfg.rr_start_depth)
    killed = do_rr & (u_rr < q)
    survived = torch.where(
        do_rr & ~killed, 1.0 / torch.clamp(1.0 - q, min=1e-6), 1.0
    )
    beta = beta * survived[..., None]
    alive = alive & ~killed

    cone_w = cone_s = None
    if textured:
        # ray cones: the width grows by spread·distance; the first
        # non-specular bounce widens the spread to the diffuse cone
        cone_w = torch.where(alive, cone_at_hit, state.cone_w)
        cone_s = torch.where(
            alive & ~bs.delta,
            torch.clamp(state.cone_s, min=DIFFUSE_CONE_SPREAD),
            state.cone_s,
        )

    a3 = alive[..., None]
    return PathState(
        o=torch.where(a3, o_new, state.o),
        d=torch.where(a3, bs.wi, state.d),
        beta=torch.where(a3, beta, state.beta),
        radiance=radiance,
        alive=alive,
        inside=inside,
        eta_scale=eta_scale,
        prev_pdf=torch.where(alive, bs.pdf, state.prev_pdf),
        prev_delta=torch.where(alive, bs.delta, state.prev_delta),
        cone_w=cone_w,
        cone_s=cone_s,
        prev_n=None if state.prev_n is None else torch.where(a3, ns, state.prev_n),
    )


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
        # scene's tables, which the bounces close over.
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


def camera_batch(scene: Scene, cfg: MegakernelConfig, width, height, sample, nspp: int = 1):
    """Camera rays of ``nspp`` samples of every pixel, in the render's
    pixel order → (px, py, sample, o, d, filter weight or None, morton)."""
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


def batch_image(radiance, fw, morton: bool, width, height, nspp: int = 1):
    """Radiance of a ``camera_batch`` → (nspp, H, W, 3) image, or (H, W,
    3) when nspp == 1: weighted by the filter, back in raster order."""
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
    for k in range(0, kspp, spp_per_pass):
        radiance = render_sample_batch(
            scene, cfg, width, height, int(sample_offset) + k, nspp=spp_per_pass
        )
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

"""The intersection queries of the unfused integrator (``trace_paths`` and
``bounce_step`` in ``models/megakernel.py``): ``closest`` → ``ClosestHit``
in the span ``pt.closest``, ``occluded`` → (N,) bool in ``pt.shadow``.
Each counts the rays handed to it (``rays.query``) and, while recording,
those alive (``rays.live``).

The route on one set of mesh tables (a Scene's own, or an instance's
``MeshTables``): the plain sweep (``ops/intersect.py``) for CPU tensors
or ``backend="torch"``; else kernel 4 (``ops/bvh_cuda.py``) on tables
with a BVH, kernels 2 and 3 (``ops/intersect_cuda.py``) without. Dead
rays are parked before the kernels of a BVH scene and before every
instanced query. On the kernel route, with ``cfg.sort_rays`` "on", or
"auto" and a BVH among the query's meshes, the rays are stably sorted by
``ray_sort_key`` on the grid of ``Scene.bounds`` (dead rays last; BVH
and instanced scenes have one) and put back in their own order after;
the key, the sort and the unsort are ``pt.raysort`` spans.

An instanced scene runs the query once per instance, in its object space
(the direction left unnormalized so t is shared) on its mesh's tables,
the rays that miss its world box parked; the nearest hit is kept, the
flags OR-ed.
"""

from __future__ import annotations

from functools import partial

import torch

from ..scene.types import MeshTables, Scene
from ..utils import trace
from . import bvh_cuda, intersect_cuda
from .intersect import BIG_T, ClosestHit, closest_epilogue, intersect_any, intersect_closest_raw
from .raysort import ray_sort_key, sorted_apply
from .shade_tables import BRUTE_ROW_WORDS
from .vecmath import normalize

_DEAD_ORIGIN = 1.0e9  # parked origin of a dead ray: outside every box
_DEAD_DIR = (0.57735027, 0.57735027, 0.57735027)  # +octant, pointing away


def _use_kernels(cfg, t: torch.Tensor) -> bool:
    if cfg.backend == "torch":
        return False
    if cfg.backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return t.is_cuda


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


def _on_tables(cfg, kernels: bool, tables, o, d, t_max=None):
    """(t, row local to the tables) of the closest hit, or with ``t_max``
    the occlusion flags. Kernels 2 and 3 read 48 B rows: an instance
    mesh's ``tri_rows``, the head of a Scene's ``brute_tables``."""
    tris = (tables.tri_v0, tables.tri_e0, tables.tri_e1)
    if not kernels:
        if t_max is None:
            return intersect_closest_raw(o, d, *tris, cfg.tri_chunk)
        return intersect_any(o, d, *tris, t_max, cfg.tri_chunk)
    if tables.bvh is not None:
        if t_max is None:
            return bvh_cuda.bvh_closest_raw(o, d, tables)
        return bvh_cuda.bvh_any_raw(o, d, tables, t_max) > 0
    if isinstance(tables, MeshTables):
        rows = tables.tri_rows
    else:
        rows = tables.brute_tables[: BRUTE_ROW_WORDS * tables.tri_v0.shape[0]]
    if t_max is None:
        return intersect_cuda.closest_bruteforce(o, d, *tris, rows=rows)
    return intersect_cuda.anyhit_bruteforce(o, d, *tris, t_max, rows=rows)


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


def _rows_vecs(rows, v):
    """Per-ray (N,3,4) affines' linear part applied to (N,3) vectors."""
    return torch.sum(rows[:, :, :3] * v[:, None, :], dim=-1)


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


def _per_instance(cfg, kernels: bool, inst, o, d, t_max=None):
    """Per instance k: (k, the query in its object space on its mesh's
    tables, the mask of the rays that meet its world box or None)."""
    for k, mesh in enumerate(inst.meshes):
        a = inst.obj_from_world[k]
        o_k = _affine_pts(a, o)
        d_k = _affine_vecs(a, d)
        hit_box = None
        if inst.bounds_lo is not None:
            hit_box = _ray_box_hit(o, d, inst.bounds_lo[k], inst.bounds_hi[k])
            o_k, d_k = _park_dead(o_k, d_k, hit_box)
        yield k, _on_tables(cfg, kernels, mesh, o_k, d_k, t_max), hit_box


def _nearest(cfg, kernels: bool, scene: Scene, o, d):
    """(t, global row: local row + ``tstart``, instance) of each ray's
    nearest hit over the instances."""
    inst = scene.instances
    best_t = torch.full((o.shape[0],), BIG_T, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    best_k = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    for k, (t, i), hit_box in _per_instance(cfg, kernels, inst, o, d):
        better = t < best_t if hit_box is None else (t < best_t) & hit_box
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i + inst.tstart[k], best_i)
        best_k = torch.where(better, k, best_k)
    return best_t, best_i, best_k


def _any_instance(cfg, kernels: bool, scene: Scene, o, d, t_max):
    """Occlusion by any instance (the box test is not clamped to ``t_max``)."""
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (o.shape[0],)
    )
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for _, occ_k, hit_box in _per_instance(cfg, kernels, scene.instances, o, d, t_max):
        occ = occ | (occ_k if hit_box is None else occ_k & hit_box)
    return occ


def _query(scene: Scene, cfg, o, d, alive, fn, *extras):
    """Count, route, park, sort and run ``fn(cfg, kernel route?, scene, o,
    d, *extras)`` → (its results in the rays' order, the rays as queried)."""
    trace.count("rays.query", o.shape[0])
    if alive is not None:
        trace.count_device("rays.live", alive)
    kernels = _use_kernels(cfg, o)
    if scene.instances is not None or (kernels and scene.bvh is not None):
        o, d = _park_dead(o, d, alive)
    fn = partial(fn, cfg, kernels, scene)
    meshes = (scene,) if scene.instances is None else scene.instances.meshes
    auto = cfg.sort_rays == "auto" and any(m.bvh is not None for m in meshes)
    if not (kernels and scene.bounds is not None and (auto or cfg.sort_rays == "on")):
        return fn(o, d, *extras), o, d
    with trace.span("pt.raysort"):
        key = _sort_key(scene, o, d, alive)
    return sorted_apply(o, d, key, fn, *extras), o, d


def closest(scene: Scene, cfg, o, d, alive=None) -> ClosestHit:
    """Closest hit of the rays (o, d). An instanced scene takes one
    epilogue in each ray's winning object space over the scene's
    concatenated arrays, then brings position, normal (inverse transpose)
    and error bound back to world space."""
    with trace.span("pt.closest"):
        if scene.instances is None:
            (t, i), o, d = _query(scene, cfg, o, d, alive, _on_tables)
            return closest_epilogue(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t, i)
        (t, i, k), o, d = _query(scene, cfg, o, d, alive, _nearest)
        a_win = scene.instances.obj_from_world[k]  # (N,3,4) each ray's instance
        m_win = scene.instances.world_from_obj[k]
        hit = closest_epilogue(
            _rows_vecs(a_win, o) + a_win[:, :, 3], _rows_vecs(a_win, d),
            scene.tri_v0, scene.tri_e0, scene.tri_e1, t, i,
        )
        return hit._replace(
            pos=_rows_vecs(m_win, hit.pos) + m_win[:, :, 3],
            # M⁻ᵀ = (obj_from_world)ᵀ
            normal=normalize(torch.sum(a_win[:, :, :3] * hit.normal[:, :, None], dim=-2)),
            error=_rows_vecs(torch.abs(m_win), hit.error),  # conservative |M|·err
        )


def occluded(scene: Scene, cfg, o, d, t_max, alive=None):
    """(N,) bool: a triangle hit at T_MIN < t < ``t_max`` (per ray, or one
    value for all)."""
    with trace.span("pt.shadow"):
        fn = _on_tables if scene.instances is None else _any_instance
        return _query(scene, cfg, o, d, alive, fn, t_max)[0]

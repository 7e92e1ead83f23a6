"""The plain reference path tracer of many-lights scenes: the estimator the
port computes when a scene holds enough light records for a light tree, in
plain PyTorch and NumPy, from the benchmark's own scene spec
(``pt_bench/scenes/many_lights.py``), with brute-force intersection over
the spec's triangles. It imports nothing of the port; what it shares with
``integrator.py`` it imports from this folder.

The light tree (Conty Estevez & Kulla, "Importance Sampling of Many
Lights with Adaptive Tree Splitting", HPG 2018, sections 4-5), built here
on the host from the spec's own lights and emissive triangles:

- records: each point or spot light, then each triangle whose material
  emits, in triangle order. A record is a box, an orientation cone (axis,
  theta_o), a falloff theta_e and an energy: a point light a box of its
  radius (at least 1e-3), the whole sphere (theta_o pi, theta_e pi/2),
  4 pi times its mean colour; a spot the cone of its inner angle, theta_e
  the outer less the inner angle (at least 1e-3), its mean colour times
  the solid angle 2 pi (1 - (cos theta0 + cos theta_e) / 2); a triangle
  its box, its normal with theta_o = theta_e = pi/2 (two-sided), its mean
  radiance times its area times 2 pi;
- a binary tree split top-down by the summed-area orientation heuristic
  (SAOH): energy x the cone's measure M_Omega (eq. 1) x the box's surface
  area, over 12 bins of the centroids' extent on each of the three axes,
  a tie going to the first cut tried, x first; a median split
  where every centroid coincides or the branch would pass 60 levels;
- nodes in depth-first order, each ``[lo, hi, axis, theta_o, theta_e,
  energy, left, right, rec]`` (``LightTree``: the features as ``nodes``,
  the last three as ``links``; a leaf's children are itself and ``rec`` its
  record, -1 at an inner node), and each record's bit trail (bit k set
  where the branch turns right at level k).

Per path: a box-filtered camera ray, then up to ``max_depth`` bounces of

- closest hit; a miss adds the constant environment and ends the path;
- a hit on an emitting triangle adds beta x its radiance, weighted by the
  power heuristic of the last BSDF sample's pdf against the density with
  which next-event estimation would have picked that point: the tree's pmf
  of the triangle's record from the last vertex (the ray's origin and the
  last shading normal), replayed along its bit trail, times the
  triangle's solid-angle pdf t^2 / (|cos| x area). The weight is 1 after
  a specular bounce and for the camera ray;
- next-event estimation by one importance descent of the tree (dimension
  ``TREE_U``; u rescaled at each level, so one number serves every level)
  to one record, then one shadow ray to it: a spot or point light by its
  own sampling, divided by the record's pmf; a triangle at a uniform point
  of it by its solid-angle pdf, power-heuristic MIS on pmf x pdf against
  the BSDF's pdf, the shadow ray stopping at 0.999 of the distance;
- a BSDF sample and Russian roulette on beta times the product of eta^2
  from ``rr_start_depth`` on, as ``integrator.py`` does. Lambert rows (the
  emitters' black surfaces) are Oren-Nayar rows of sigma 0, whose f is
  Lambert's.

The importance of a cluster seen from a point p with normal n (section
4.2): energy x cos theta' x cos theta_i' / max(d^2, r^2), where d is the
distance to the box's centre, r its half diagonal, theta_u the angle the
box's sphere subtends, theta' = max(theta - theta_o - theta_u, 0) the
angle to the cone (zero from theta_e on), and theta_i' = max(theta_i -
theta_u, 0) the incident angle, |cos| for two-sided surfaces. A level
goes left with probability I_left / (I_left + I_right), one half where
both are zero.

Random numbers come from the hash sampler keyed by (pixel, sample ^ seed,
dimension), so a path is the same path here and in the port.

Departures from the upstream DumbTracer's description of its own renderer
(both the port's, so the reference follows them): the hash sampler and the
box filter, where the upstream draws Halton-Owen samples through a Mitchell
filter; one shadow ray a bounce below the root (the port's default
``nee_splits`` 1), where the upstream splits adaptively into up to four
subtrees; no strategy split between the environment and the tree, since
the scenes this module serves have a constant environment, which only the
miss shader adds; the importance's distance floored at the box's half
diagonal and a leaf's cone taken as its triangle's hemisphere pair.

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

# the configuration's ``sampler`` → the sampler of this estimator
SAMPLERS = {"hash": R.HashSampler}
TREE_U = 12  # per-bounce dimension of the descent; its light sample takes the next two
LAMBERT = 3  # a material row's mtype: Lambert
BINS = 12  # SAOH bins an axis
MAX_LEVELS = 60  # a branch longer than this splits at the median
TREE_RECORDS = 16  # the least records the port builds a tree for; below it NEE is uniform
ROW, TRI = 0, 1  # a record's kind: a light row, an emissive triangle


# ------------------------------------------------------------ host build

class _Record(NamedTuple):
    kind: int
    idx: int
    lo: np.ndarray  # float64 box
    hi: np.ndarray
    axis: np.ndarray
    theta_o: float
    theta_e: float
    energy: float


class LightTree(NamedTuple):
    """The tree on the host: node by node in depth-first order."""

    nodes: np.ndarray  # (M, 12) float64 [lo(3), hi(3), axis(3), theta_o, theta_e, energy]
    links: np.ndarray  # (M, 3) int64 [left, right, rec]
    rec_kind: np.ndarray  # (R,) ROW | TRI
    rec_idx: np.ndarray  # (R,) light row, or the triangle's index among the emitters
    rec_energy: np.ndarray  # (R,) float64
    trail: np.ndarray  # (R,) uint64 bits, bit k = right at level k
    trail_len: np.ndarray  # (R,) int64: the record's leaf depth

    @property
    def depth(self) -> int:
        return int(self.trail_len.max())


def light_records(light_rows, tri_v0, tri_e0, tri_e1, tri_rad) -> list:
    """The records of the lights' rows (float32 columns as the spec's
    tables hold them) and of the emitting triangles (float32 first
    corners, edges and radiance)."""
    recs = []
    for i, lt in enumerate(light_rows):
        color = np.asarray(lt["color"], np.float32)
        lum = float(np.mean(np.broadcast_to(color, (3,))))
        pos = np.asarray(lt["pos"], np.float32).astype(np.float64)
        r = max(float(np.float32(lt["radius"])), 1e-3)
        if lt["ltype"] == S.POINT:
            recs.append(_Record(ROW, i, pos - r, pos + r, np.array([0.0, 0.0, 1.0]), math.pi,
                                math.pi / 2, lum * 4.0 * math.pi))
        elif lt["ltype"] == S.SPOT:
            c0, ce = np.float32(lt["cos_theta0"]), np.float32(lt["cos_theta_e"])
            inner = math.acos(float(np.clip(c0, -1, 1)))
            outer = math.acos(float(np.clip(ce, -1, 1)))
            recs.append(_Record(ROW, i, pos - r, pos + r,
                                np.asarray(lt["direction"], np.float32).astype(np.float64),
                                inner, max(outer - inner, 1e-3),
                                lum * 2.0 * math.pi * (1.0 - 0.5 * (c0 + ce))))
        else:
            raise ValueError(f"the reference knows point and spot lights, not {lt['ltype']}")
    for k in range(len(tri_v0)):
        p0 = tri_v0[k].astype(np.float64)
        p1, p2 = p0 + tri_e0[k].astype(np.float64), p0 + tri_e1[k].astype(np.float64)
        n = np.cross(p1 - p0, p2 - p0)
        nl = np.linalg.norm(n)
        recs.append(_Record(TRI, k, np.minimum(np.minimum(p0, p1), p2),
                            np.maximum(np.maximum(p0, p1), p2), n / max(nl, 1e-12),
                            math.pi / 2, math.pi / 2,
                            float(np.mean(tri_rad[k])) * (0.5 * nl) * 2.0 * math.pi))
    return recs


def _merge_cones(axis_a, theta_a, axis_b, theta_b):
    """The narrowest cone (axis, half-angle) about both: the wider cone
    turned toward the other by half of what sticks out (section 4.1)."""
    if theta_b > theta_a:
        axis_a, theta_a, axis_b, theta_b = axis_b, theta_b, axis_a, theta_a
    between = math.acos(float(np.clip(np.dot(axis_a, axis_b), -1.0, 1.0)))
    if min(between + theta_b, math.pi) <= theta_a:
        return axis_a, theta_a
    theta = (between + theta_a + theta_b) * 0.5
    if theta >= math.pi:
        return axis_a, math.pi
    pivot = np.cross(axis_a, axis_b)
    pl = np.linalg.norm(pivot)
    if pl < 1e-9:  # opposite or equal axes: no plane to turn in
        return axis_a, math.pi if between > 1e-6 else theta
    pivot = pivot / pl
    turn = theta - theta_a
    c, s = math.cos(turn), math.sin(turn)  # Rodrigues: axis_a turned by ``turn`` about pivot
    out = axis_a * c + np.cross(pivot, axis_a) * s + pivot * np.dot(pivot, axis_a) * (1.0 - c)
    norm = np.linalg.norm(out)
    return (out / norm if norm > 0 else axis_a), theta


def _cone_measure(theta_o: float, theta_e: float) -> float:
    """M_Omega of a cone of half-angle theta_o with falloff theta_e (eq. 1)."""
    theta_w = min(theta_o + theta_e, math.pi)
    so, co = math.sin(theta_o), math.cos(theta_o)
    return 2.0 * math.pi * (1.0 - co) + 0.5 * math.pi * (
        2.0 * theta_w * so - math.cos(theta_o - 2.0 * theta_w) + 2.0 * theta_o * so + co)


def _cluster(recs):
    """Box, cone, falloff and energy of a set of records."""
    lo = np.min([r.lo for r in recs], axis=0)
    hi = np.max([r.hi for r in recs], axis=0)
    axis, theta_o = recs[0].axis, recs[0].theta_o
    for r in recs[1:]:
        axis, theta_o = _merge_cones(axis, theta_o, r.axis, r.theta_o)
    return lo, hi, axis, theta_o, max(r.theta_e for r in recs), float(sum(r.energy for r in recs))


def _saoh_cost(recs) -> float:
    lo, hi, _, theta_o, theta_e, energy = _cluster(recs)
    ext = np.maximum(hi - lo, 0.0)
    area = float(2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0]) + 1e-8)
    return energy * _cone_measure(theta_o, theta_e) * area


def _split(recs, ids: list, level: int):
    """The SAOH's cheapest binned cut of ``ids`` → (left ids, right ids)."""
    best = None
    if level + max(1, math.ceil(math.log2(len(ids)))) < MAX_LEVELS:
        centre = np.stack([(recs[i].lo + recs[i].hi) * 0.5 for i in ids])
        for ax in range(3):
            c = centre[:, ax]
            lo, hi = c.min(), c.max()
            if hi - lo < 1e-12:
                continue
            bins = np.minimum(((c - lo) / (hi - lo) * BINS).astype(int), BINS - 1)
            for cut in range(1, BINS):
                left = [i for i, b in zip(ids, bins) if b < cut]
                right = [i for i, b in zip(ids, bins) if b >= cut]
                if left and right:
                    cost = (_saoh_cost([recs[i] for i in left])
                            + _saoh_cost([recs[i] for i in right]))
                    if best is None or cost < best[0]:
                        best = (cost, left, right)
    if best is None:
        half = len(ids) // 2
        return list(ids[:half]), list(ids[half:])
    return best[1], best[2]


def build_light_tree(recs) -> LightTree:
    """The tree over ``recs`` (``light_records``)."""
    nodes, links = [], []
    trail = np.zeros(len(recs), np.uint64)
    trail_len = np.zeros(len(recs), np.int64)
    # depth-first: a node takes its id before its children; the right
    # child is built after the whole left subtree
    stack = [(list(range(len(recs))), 0, 0, None)]  # ids, level, trail bits, (parent, side)
    while stack:
        ids, level, bits, parent = stack.pop()
        lo, hi, axis, theta_o, theta_e, energy = _cluster([recs[i] for i in ids])
        me = len(nodes)
        nodes.append(np.concatenate([lo, hi, axis, [theta_o, theta_e, energy]]))
        links.append([me, me, -1])
        if parent is not None:
            links[parent[0]][parent[1]] = me
        if len(ids) == 1:
            links[me][2] = ids[0]
            trail[ids[0]], trail_len[ids[0]] = np.uint64(bits), level
            continue
        left, right = _split(recs, ids, level)
        stack.append((right, level + 1, bits | (1 << level), (me, 1)))
        stack.append((left, level + 1, bits, (me, 0)))
    return LightTree(np.asarray(nodes, np.float64), np.asarray(links, np.int64),
                     np.asarray([r.kind for r in recs], np.int64),
                     np.asarray([r.idx for r in recs], np.int64),
                     np.asarray([r.energy for r in recs], np.float64), trail, trail_len)


# ----------------------------------------------------------- the scene

class Tree(NamedTuple):
    """The tree as tensors of the device and dtype of the render."""

    lo: torch.Tensor  # (M, 3)
    hi: torch.Tensor
    axis: torch.Tensor
    theta_o: torch.Tensor  # (M,)
    theta_e: torch.Tensor
    energy: torch.Tensor
    left: torch.Tensor  # (M,) int64
    right: torch.Tensor
    rec: torch.Tensor  # (M,) int64, -1 at an inner node
    rec_kind: torch.Tensor  # (R,) int64
    rec_idx: torch.Tensor
    bits: torch.Tensor  # (R, depth) int64: 1 where the branch turns right
    trail_len: torch.Tensor  # (R,) int64
    depth: int


class RefScene(NamedTuple):
    v0: torch.Tensor
    e0: torch.Tensor
    e1: torch.Tensor
    tri_mat: torch.Tensor  # (T,) int64
    materials: S.Materials
    emission: torch.Tensor  # (M, 3) each material's radiance
    lights: S.Lights
    env: torch.Tensor  # (3,)
    cam_from_raster: torch.Tensor
    world_from_cam: torch.Tensor
    tree: Tree
    tri_rec: torch.Tensor  # (T,) int64: the record of an emitting triangle, -1 elsewhere
    em_v0: torch.Tensor  # (K, 3) the emitting triangles, by their index among the emitters
    em_e0: torch.Tensor
    em_e1: torch.Tensor
    em_rad: torch.Tensor


def _emission(spec) -> np.ndarray:
    """(M, 3) float32: each material's emitted radiance, 0 where it emits none."""
    return np.stack([np.broadcast_to(np.asarray(m.get("emission", 0.0), np.float32), (3,))
                     for m in spec.materials])


def spec_light_tree(spec) -> tuple[LightTree, np.ndarray]:
    """The spec's tree and each triangle's record (-1 where it emits
    nothing)."""
    tris = spec.tris.astype(np.float32)
    v0, e0, e1 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    rad = _emission(spec)[np.asarray(spec.tri_mat)]
    emits = np.flatnonzero(rad.max(axis=1) > 0)
    rows = [{**S.LIGHT_DEFAULTS, **lt} for lt in spec.lights]
    recs = light_records(rows, v0[emits], e0[emits], e1[emits], rad[emits])
    if len(recs) < TREE_RECORDS:
        raise ValueError(f"{len(recs)} light records: the port builds a light tree for "
                         f"{TREE_RECORDS} or more and picks lights uniformly below that")
    tree = build_light_tree(recs)
    tri_rec = np.full(len(tris), -1, np.int64)
    tri_rec[emits] = np.arange(len(rows), len(recs))
    return tree, tri_rec


def make_scene(spec, device, dtype=torch.float32) -> RefScene:
    """The spec (``pt_bench/scenes``) as the reference's tensors."""
    tris = spec.tris.astype("float32")
    v0, e0, e1 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    rows = [dict(m, mtype=S.OREN_NAYAR, on_sigma=0.0) if m["mtype"] == LAMBERT else m
            for m in spec.materials]
    emission = _emission(spec)
    host, tri_rec = spec_light_tree(spec)
    bits = (host.trail[:, None] >> np.arange(host.depth, dtype=np.uint64)) & np.uint64(1)
    nd = host.nodes.astype(np.float32)
    tree = Tree(t(nd[:, 0:3]), t(nd[:, 3:6]), t(nd[:, 6:9]), t(nd[:, 9]), t(nd[:, 10]),
                t(nd[:, 11]), i64(host.links[:, 0]), i64(host.links[:, 1]),
                i64(host.links[:, 2]), i64(host.rec_kind), i64(host.rec_idx),
                i64(bits.astype(np.int64)), i64(host.trail_len), host.depth)
    emits = np.flatnonzero(tri_rec >= 0)
    cam = spec.camera
    return RefScene(
        t(v0), t(e0), t(e1), i64(spec.tri_mat), S.make_materials(rows, device, dtype),
        t(emission), S.make_lights(spec.lights, device, dtype), t(spec.env_color),
        t(G.camera_from_raster(cam["focal_length_mm"], cam["sensor_height_mm"],
                               cam["width"], cam["height"])),
        t(G.world_from_camera(cam["direction"], cam["position"])),
        tree, i64(tri_rec), t(v0[emits]), t(e0[emits]), t(e1[emits]),
        t(emission[np.asarray(spec.tri_mat)[emits]]))


# ------------------------------------------------- descent and replay

def importance(tree: Tree, node, p, n):
    """Importance of clusters ``node`` (N,) seen from points ``p`` with
    normals ``n``."""
    def dot(a, b):  # a reduction, as the port sums these products (the same bits on a card)
        return torch.sum(a * b, dim=-1)

    lo, hi = tree.lo[node], tree.hi[node]
    centre, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    r2 = dot(half, half)
    d = p - centre
    d2 = dot(d, d)
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    w = d / dist[..., None]  # cluster → point
    theta = torch.arccos(torch.clamp(dot(tree.axis[node], w), -1.0, 1.0))
    theta_u = torch.arcsin(torch.clamp(torch.sqrt(r2) / dist, 0.0, 1.0))
    theta_p = torch.clamp(theta - tree.theta_o[node] - theta_u, min=0.0)
    emitted = torch.where(theta_p < tree.theta_e[node], torch.cos(theta_p), 0.0)
    theta_i = torch.arccos(torch.clamp(torch.abs(dot(n, -w)), 0.0, 1.0))
    incident = torch.cos(torch.clamp(theta_i - theta_u, min=0.0))
    near = torch.clamp(torch.maximum(d2, r2), min=1e-8)
    return torch.clamp(tree.energy[node] * emitted * incident / near, min=0.0)


def _go_left(tree: Tree, node, p, n):
    """Each node's children and the probability of the left one."""
    left, right = tree.left[node], tree.right[node]
    il, ir = importance(tree, left, p, n), importance(tree, right, p, n)
    total = il + ir
    return left, right, torch.where(total > 0, il / torch.clamp(total, min=1e-30), 0.5)


def sample_tree(tree: Tree, p, n, u):
    """One importance descent from the root → (record (N,) int64, pmf)."""
    node = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    pmf = torch.ones_like(u)
    for _ in range(tree.depth):
        leaf = tree.rec[node] >= 0
        left, right, pl = _go_left(tree, node, p, n)
        go_left = u < pl
        u = torch.clamp(torch.where(go_left, u / torch.clamp(pl, min=1e-12),
                                    (u - pl) / torch.clamp(1.0 - pl, min=1e-12)),
                        0.0, 1.0 - 1e-7)
        node = torch.where(leaf, node, torch.where(go_left, left, right))
        pmf = torch.where(leaf, pmf, pmf * torch.where(go_left, pl, 1.0 - pl))
    return torch.clamp(tree.rec[node], min=0), pmf


def tree_pmf(tree: Tree, rec, p, n):
    """The pmf with which ``sample_tree`` picks record ``rec`` from ``p``,
    ``n``: the descent replayed along the record's bit trail."""
    bits, tlen = tree.bits[rec], tree.trail_len[rec]
    node = torch.zeros_like(rec)
    pmf = torch.ones(p.shape[:1], dtype=p.dtype, device=p.device)
    for level in range(tree.depth):
        on = (level < tlen) & (tree.rec[node] < 0)
        left, right, pl = _go_left(tree, node, p, n)
        right_turn = bits[:, level] == 1
        pmf = torch.where(on, pmf * torch.where(right_turn, 1.0 - pl, pl), pmf)
        node = torch.where(on, torch.where(right_turn, right, left), node)
    return pmf


# ------------------------------------------------------------- the paths

class _Path(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    beta: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    inside: torch.Tensor
    eta_scale: torch.Tensor
    prev_pdf: torch.Tensor  # the last BSDF sample's pdf
    prev_delta: torch.Tensor  # the last bounce was specular (the camera counts as one)
    prev_n: torch.Tensor  # the last shading normal


def _power(a, b):
    return S.sqr(a) / torch.clamp(S.sqr(a) + S.sqr(b), min=1e-24)


def _nee(scene: RefScene, sampler, px, py, sample, depth_dim, hit, mat, wo, inside, alive, work):
    """One tree-picked record's contribution, one shadow ray."""
    tree = scene.tree
    u_sel = sampler.sample_1d(px, py, sample, depth_dim + TREE_U)
    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + TREE_U + 1)
    rec, pmf = sample_tree(tree, hit.pos, hit.normal, u_sel)
    kind, idx = tree.rec_kind[rec], tree.rec_idx[rec]
    is_tri = kind == TRI

    # a light row: its own sampling, not geometry
    lt = scene.lights.gather(torch.where(is_tri, 0, idx))
    direction, pdf, distance, factor = S.sample_light(lt, hit.pos, u1, u2, hit.normal)
    le = S.eval_light(lt, distance, factor)

    # an emitting triangle: a uniform point on it
    k = torch.where(is_tri, idx, 0)
    tv0, te0, te1 = scene.em_v0[k], scene.em_e0[k], scene.em_e1[k]
    su = S.safe_sqrt(u1)
    point = tv0 + (1.0 - su)[..., None] * te0 + (u2 * su)[..., None] * te1
    normal = S.cross(te0, te1)
    area2 = torch.clamp(S.length(normal), min=1e-12)
    to_p = point - hit.pos
    d2 = torch.clamp(S.dot(to_p, to_p), min=1e-12)
    dist = torch.sqrt(d2)
    d_tri = to_p / dist[..., None]
    cos_l = torch.abs(S.dot(d_tri, normal / area2[..., None]))
    pdf_tri = torch.where(cos_l > 1e-6, d2 / torch.clamp(cos_l * 0.5 * area2, min=1e-12), 0.0)
    direction = torch.where(is_tri[..., None], d_tri, direction)
    distance = torch.where(is_tri, dist * 0.999, distance)
    pdf = torch.where(is_tri, pdf_tri, pdf)
    le = torch.where(is_tri[..., None], scene.em_rad[k], le)

    f_cos, bsdf_pdf = S.eval_bsdf(mat, wo, direction, hit.normal, hit.normal, inside)
    shadow_o = S.offset_ray_origin(hit.pos, hit.error, hit.normal, direction)
    if work is None:
        occ = G.occluded(shadow_o, direction, scene.v0, scene.e0, scene.e1, distance)
    else:
        live = (pdf > 0.0) & (pmf > 0.0) & (S.max_component(f_cos) > 0.0) & alive
        occ, tests = G.occluded(shadow_o, direction, scene.v0, scene.e0, scene.e1, distance,
                                count=live)
        work.shadow_rays += int(live.sum())
        work.shadow_tests += tests
        if work.keep_rays:
            work.shadow.append((shadow_o[live], direction[live], distance[live]))

    row = le * f_cos / torch.clamp(pmf, min=1e-12)[..., None]
    pdf_total = pdf * pmf
    tri = le * f_cos * (_power(pdf_total, bsdf_pdf) / torch.clamp(pdf_total, min=1e-12))[..., None]
    contrib = torch.where(is_tri[..., None], tri, row)
    return torch.where(((pdf > 0.0) & (pmf > 0.0) & ~occ)[..., None], contrib, 0.0)


def _bounce(scene: RefScene, sampler, px, py, sample, depth, st: _Path, rr_start_depth,
            work) -> _Path:
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
    mat_id = scene.tri_mat[hit.tri]
    mat = scene.materials.gather(mat_id)

    # an emitter hit by the BSDF's ray, weighted against NEE's density
    cos_l = torch.abs(S.dot(st.d, hit.normal))
    pmf_hit = tree_pmf(scene.tree, torch.clamp(scene.tri_rec[hit.tri], min=0), st.o, st.prev_n)
    area = 0.5 * S.length(S.cross(scene.e0[hit.tri], scene.e1[hit.tri]))
    t_hit = torch.where(alive, hit.t, 1.0)  # a miss's t would overflow t^2
    pdf_hit = S.sqr(t_hit) / torch.clamp(cos_l * area, min=1e-12) * pmf_hit
    w_em = torch.where(st.prev_delta, 1.0, _power(st.prev_pdf, pdf_hit))
    radiance = radiance + torch.where(alive[..., None],
                                      st.beta * scene.emission[mat_id] * w_em[..., None], 0.0)

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
                 torch.where(a3, beta, st.beta), radiance, alive, inside, eta_scale,
                 torch.where(alive, bs.pdf, st.prev_pdf), torch.where(alive, bs.delta, st.prev_delta),
                 torch.where(a3, hit.normal, st.prev_n))


def trace(scene: RefScene, sampler, px, py, sample, max_depth: int, rr_start_depth: int = 2,
          work: Work | None = None):
    """Radiance (N, 3) of one path per (px, py, sample), int64 keys."""
    o, d = camera_rays(scene, sampler, px, py, sample)
    n = o.shape[0]
    like = dict(dtype=o.dtype, device=o.device)
    flag = lambda v: torch.full((n,), v, dtype=torch.bool, device=o.device)  # noqa: E731
    st = _Path(o, d, torch.ones((n, 3), **like), torch.zeros((n, 3), **like), flag(True),
               flag(False), torch.ones((n,), **like), torch.zeros((n,), **like), flag(True), -d)
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

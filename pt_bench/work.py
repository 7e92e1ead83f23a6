"""The benchmark's reckoning of the work a render needs, and the H100's
peaks: what a kernel's roofline share is measured against.

The work is counted on the reference's own paths (``reference.Work``)
over a sample of the traced window's paths, so the same work is counted
whatever implements it: brute force tests every triangle for a closest
hit and stops at the first occluder for a shadow ray; a BVH query is
counted on a binary BVH that the benchmark builds itself from the
triangles by a fixed plain method (``build_bvh``: median split on the
longest centroid axis, leaves of at most ``LEAF`` triangles), walked
nearest child first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# operations: a ray-triangle test (Moeller-Trumbore), a box slab test of
# one child, the shading of one hit (BSDF sample and evaluation, light
# sample, roulette)
MT_FLOPS = 45
SLAB_FLOPS = 25
SHADE_FLOPS = 800
# bytes: a fused path reads o, d (24) and px, py, sample^seed (12) and
# writes its radiance (12); a query ray reads o, d (24) and writes t and
# the row (8), or reads t_max and writes the flag (8); a triangle row is
# v0, e0, e1 (36) and a material id (4); a BVH node two boxes and two
# links (56)
PATH_BYTES = 48
RAY_BYTES = 32
TRI_BYTES = 36
MAT_BYTES = 4
NODE_BYTES = 56
LEAF = 4


@dataclasses.dataclass
class Reckoning:
    """Work per path of a traced window, from sampled paths."""

    triangles: int
    closest_rays: float = 0.0  # closest-hit queries (live paths) per path
    hits: float = 0.0  # hits shaded per path
    shadow_rays: float = 0.0  # shadow rays cast per path
    shadow_tests: float = 0.0  # brute-force tests up to the first occluder per path
    bvh_nodes: int = 0
    closest_slabs: float = 0.0  # BVH box tests of the closest queries per path
    closest_tri_tests: float = 0.0
    shadow_slabs: float = 0.0
    shadow_tri_tests: float = 0.0


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take → (seconds, "operations" or
    "bytes", whichever bounds it)."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(bound: float, measured_s: float) -> float:
    return 100.0 * bound / measured_s


def fused_brute(r: Reckoning, paths: float):
    """Kernel 1: every live path tests all T triangles per bounce, each
    shadow ray up to its first occluder, every hit is shaded."""
    flops = paths * ((r.closest_rays * r.triangles + r.shadow_tests) * MT_FLOPS
                     + r.hits * SHADE_FLOPS)
    return bound_s(flops, paths * PATH_BYTES + r.triangles * (TRI_BYTES + MAT_BYTES))


def fused_bvh(r: Reckoning, paths: float):
    """Kernel 5: the BVH walks of every closest and shadow query, every
    hit shaded."""
    flops = paths * ((r.closest_slabs + r.shadow_slabs) * SLAB_FLOPS
                     + (r.closest_tri_tests + r.shadow_tri_tests) * MT_FLOPS
                     + r.hits * SHADE_FLOPS)
    tables = r.bvh_nodes * NODE_BYTES + r.triangles * (TRI_BYTES + MAT_BYTES)
    return bound_s(flops, paths * PATH_BYTES + tables)


def brute_closest(r: Reckoning, paths: float, launches: int):
    rays = paths * r.closest_rays
    return bound_s(rays * r.triangles * MT_FLOPS,
                   rays * RAY_BYTES + launches * r.triangles * TRI_BYTES)


def brute_any(r: Reckoning, paths: float, launches: int):
    return bound_s(paths * r.shadow_tests * MT_FLOPS,
                   paths * r.shadow_rays * RAY_BYTES + launches * r.triangles * TRI_BYTES)


def bvh_closest(r: Reckoning, paths: float, launches: int):
    flops = paths * (r.closest_slabs * SLAB_FLOPS + r.closest_tri_tests * MT_FLOPS)
    tables = r.bvh_nodes * NODE_BYTES + r.triangles * TRI_BYTES
    return bound_s(flops, paths * r.closest_rays * RAY_BYTES + launches * tables)


def bvh_any(r: Reckoning, paths: float, launches: int):
    flops = paths * (r.shadow_slabs * SLAB_FLOPS + r.shadow_tri_tests * MT_FLOPS)
    tables = r.bvh_nodes * NODE_BYTES + r.triangles * TRI_BYTES
    return bound_s(flops, paths * r.shadow_rays * RAY_BYTES + launches * tables)


# ------------------------------------------------------------- plain BVH

@dataclasses.dataclass
class PlainBVH:
    lo: np.ndarray  # (M, 3) node boxes
    hi: np.ndarray
    left: np.ndarray  # (M,) child node, -1 at a leaf
    right: np.ndarray
    first: np.ndarray  # (M,) leaf's first triangle in ``order``
    count: np.ndarray  # (M,) leaf's triangles, 0 at an inner node
    order: np.ndarray  # triangle ids, leaf by leaf


def build_bvh(v0, e0, e1, leaf: int = LEAF) -> PlainBVH:
    """Binary BVH by median split of the centroids along the longest axis
    of their box, leaves of at most ``leaf`` triangles."""
    v0, e0, e1 = (np.asarray(a, np.float64) for a in (v0, e0, e1))
    p = np.stack([v0, v0 + e0, v0 + e1], axis=1)
    tmin, tmax, cen = p.min(1), p.max(1), p.mean(1)
    lo, hi, left, right, first, count, order = [], [], [], [], [], [], []

    def node(ids) -> int:
        k = len(lo)
        lo.append(tmin[ids].min(0))
        hi.append(tmax[ids].max(0))
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        if len(ids) <= leaf:
            first[k], count[k] = len(order), len(ids)
            order.extend(ids.tolist())
            return k
        c = cen[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        ids = ids[np.argsort(c[:, axis], kind="stable")]
        half = len(ids) // 2
        left[k] = node(ids[:half])
        right[k] = node(ids[half:])
        return k

    node(np.arange(len(v0)))
    a = lambda x, dt=np.int64: np.asarray(x, dt)  # noqa: E731
    return PlainBVH(a(lo, np.float64), a(hi, np.float64), a(left), a(right), a(first),
                    a(count), a(order))


def _slab(o, inv_d, lo, hi, t_max):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    return (tn <= tf) & (tf >= 0.0) & (tn < t_max), tn


def _tri_t(o, d, v0, e0, e1):
    """Moeller-Trumbore t of broadcast (ray, triangle) pairs, inf on a miss."""
    p = np.cross(d, e1)
    det = (p * e0).sum(-1)
    ok = np.abs(det) >= 1e-7
    inv = 1.0 / np.where(ok, det, 1.0)
    t = o - v0
    u = (p * t).sum(-1) * inv
    q = np.cross(t, e0)
    v = (q * d).sum(-1) * inv
    tt = (q * e1).sum(-1) * inv
    hit = ok & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7) & (tt > 1e-4)
    return np.where(hit, tt, np.inf)


def walk(bvh: PlainBVH, v0, e0, e1, o, d, t_max=None):
    """Walk every ray, all rays a step at a time: each pops its nearest
    node and skips it once its entry lies beyond the best hit; an inner
    node tests both child boxes and pushes the hit ones far first; a leaf
    tests its triangles, a shadow query (``t_max`` given) up to its first
    occluder, where it stops → (box tests, triangle tests), summed over
    the rays."""
    v0, e0, e1 = (np.asarray(a, np.float64) for a in (v0, e0, e1))
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    n = o.shape[0]
    any_hit = t_max is not None
    best = np.full(n, np.inf) if not any_hit else np.asarray(t_max, np.float64).copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / d
    depth = 2 * int(np.ceil(np.log2(max(len(bvh.lo), 2)))) + 8
    stack_n = np.zeros((n, depth), np.int64)
    stack_t = np.zeros((n, depth))
    sp = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    slabs, tris = n, 0

    def push(i, k, t):
        stack_n[i, sp[i]] = k
        stack_t[i, sp[i]] = t
        sp[i] += 1

    with np.errstate(invalid="ignore"):
        ok, tn = _slab(o, inv_d, bvh.lo[0], bvh.hi[0], best)
        push(np.flatnonzero(ok), 0, tn[ok])
        lanes = np.arange(LEAF)
        while True:
            i = np.flatnonzero((sp > 0) & ~done)
            if not len(i):
                break
            sp[i] -= 1
            k, tk = stack_n[i, sp[i]], stack_t[i, sp[i]]
            keep = tk < best[i]
            i, k = i[keep], k[keep]
            leaf = bvh.count[k] > 0
            li, lk = i[leaf], k[leaf]
            if len(li):
                cnt = bvh.count[lk]
                valid = lanes[None] < cnt[:, None]
                ids = bvh.order[np.where(valid, bvh.first[lk][:, None] + lanes[None], 0)]
                t = _tri_t(o[li][:, None], d[li][:, None], v0[ids], e0[ids], e1[ids])
                t = np.where(valid, t, np.inf)
                if any_hit:
                    hit = t < best[li][:, None]
                    has = hit.any(1)
                    tris += int(np.where(has, np.argmax(hit, 1) + 1, cnt).sum())
                    done[li[has]] = True
                else:
                    tris += int(cnt.sum())
                    best[li] = np.minimum(best[li], t.min(1))
            ii, kk = i[~leaf], k[~leaf]
            if len(ii):
                c0, c1 = bvh.left[kk], bvh.right[kk]
                slabs += 2 * len(ii)
                ok0, t0 = _slab(o[ii], inv_d[ii], bvh.lo[c0], bvh.hi[c0], best[ii])
                ok1, t1 = _slab(o[ii], inv_d[ii], bvh.lo[c1], bvh.hi[c1], best[ii])
                near0 = t0 <= t1
                for c, okc, tc in ((np.where(near0, c1, c0), np.where(near0, ok1, ok0),
                                    np.where(near0, t1, t0)),
                                   (np.where(near0, c0, c1), np.where(near0, ok0, ok1),
                                    np.where(near0, t0, t1))):
                    push(ii[okc], c[okc], tc[okc])
    return slabs, tris

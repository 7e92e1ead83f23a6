"""8-wide BVH: host build, packed node tables, and the numpy oracle of the
traversal kernel (counterpart of the reference ``ops/bvh.py``).

The build is the reference's binned-SAH binary build collapsed to
branching factor 8 with at most ``LEAF_SIZE`` triangles per leaf, run by
the port's copy of the reference's C++ builder (``native/``), so both
packages build the same tree. ``pack_bvh`` re-bases every leaf onto its
own block of ``LEAF_SIZE`` rows of the packed triangle arrays (pad rows
have zero edges: det 0, never hit) and packs the node tables in the
reference's exact layout:

- ``box`` (M, 128) f32: per node, the 8 child slabs comp-major
  ``[lox×8|loy×8|loz×8|hix×8|hiy×8|hiz×8]`` (48 lanes used, empty
  children zeroed);
- ``meta`` (M·16,) i32: per node, 8 slotwords ``(payload << 6) | code``
  (code 0 empty / 1 internal / 2 leaf; payload = child node row or
  8-triangle block row), then 8 per-octant permcodes, the far-to-near
  child visit order along each direction octant, 3 bits per slot;
- ``perm`` (Tp,) i32, host: packed row → original triangle (-1 = pad).

``traverse_packed_ref`` is a per-ray stack traversal of those tables in
numpy: the CPU oracle of the CUDA kernel (``csrc/bvh.cuh``), step for
step, with the counts of node pops and triangle tests that the bound of
the kernel's work needs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .intersect import BIG_T, MT_TOLERANCE, T_MIN

LEAF_SIZE = 16  # triangles per leaf, two 8-row blocks
N_BINS = 16
BRANCHING = 8
STACK_SIZE = 64  # entries of the kernel's per-ray stack (csrc/bvh.cuh)

CODE_EMPTY = 0
CODE_INTERNAL = 1
CODE_LEAF = 2


class BVHArrays(NamedTuple):
    child_lo: np.ndarray  # (M, 8, 3) f32
    child_hi: np.ndarray  # (M, 8, 3) f32
    child_node: np.ndarray  # (M, 8) i32
    child_leaf_start: np.ndarray  # (M, 8) i32
    child_leaf_count: np.ndarray  # (M, 8) i32: 0 internal, >0 leaf, -1 empty
    tri_order: np.ndarray  # (T,) i32 reordered → original triangle

    @property
    def num_nodes(self):
        return self.child_lo.shape[0]


def build_bvh(v0, e0, e1) -> BVHArrays:
    """Host build of (T, 3) float32 triangles (numpy or CPU tensors) with
    the port's C++ builder."""
    from ..native import bvh_build_native

    return BVHArrays(*bvh_build_native(
        np.asarray(v0, np.float32), np.asarray(e0, np.float32),
        np.asarray(e1, np.float32), LEAF_SIZE, N_BINS,
    ))


class PackedBVH(NamedTuple):
    """Node tables on the scene's device, in the reference's layout (see
    the module docstring), plus the host permutation and the tree's depth."""

    box: torch.Tensor  # (M, 128) f32
    meta: torch.Tensor  # (M*16,) i32
    perm: np.ndarray  # (Tp,) i32 host: packed row → original tri, -1 = pad
    depth: int  # levels of internal nodes from the root; a traversal
    # stack holds at most 7·depth + 1 entries

    @property
    def num_nodes(self):
        return self.box.shape[0]


def _permcodes(lo, hi, valid):
    """(M, 8) i32 per-octant permcodes: child visit order far-to-near
    along each octant direction, packed 3 bits per slot."""
    cent = np.where(valid[..., None], (lo + hi) * 0.5, 0.0)  # (M, 8, 3)
    m = lo.shape[0]
    codes = np.zeros((m, 8), np.int64)
    for oct_ in range(8):
        sign = np.asarray(
            [
                -1.0 if (oct_ >> 0) & 1 else 1.0,
                -1.0 if (oct_ >> 1) & 1 else 1.0,
                -1.0 if (oct_ >> 2) & 1 else 1.0,
            ],
            np.float32,
        )
        key = cent @ sign  # (M, 8) centroid distance along the octant dir
        order = np.argsort(-key, axis=1, kind="stable")  # far-to-near
        code = np.zeros(m, np.int64)
        for k in range(8):
            code |= order[:, k] << (3 * k)
        codes[:, oct_] = code
    return codes.astype(np.int32)


def tree_depth(meta) -> int:
    """Levels of internal nodes below and including the root."""
    slots = np.asarray(meta, np.int32).reshape(-1, 16)[:, :8]
    level, depth = np.zeros(1, np.int64), 0
    while level.size:
        depth += 1
        w = slots[level]
        level = (w[(w & 63) == CODE_INTERNAL] >> 6).astype(np.int64)
    return depth


def pack_bvh(bvh: BVHArrays, device="cpu") -> PackedBVH:
    """Re-base leaves onto LEAF_SIZE-padded blocks and pack the node
    tables (box rows + slotword/permcode meta) onto ``device``."""
    ls = np.asarray(bvh.child_leaf_start)
    lc = np.asarray(bvh.child_leaf_count)
    cn = np.asarray(bvh.child_node)
    order = np.asarray(bvh.tri_order)
    lo = np.nan_to_num(np.asarray(bvh.child_lo), nan=0.0, posinf=0.0, neginf=0.0)
    hi = np.nan_to_num(np.asarray(bvh.child_hi), nan=0.0, posinf=0.0, neginf=0.0)

    leaf_pos = np.argwhere(lc > 0)  # (L, 2) rows of (node, child)
    perm = np.full(len(leaf_pos) * LEAF_SIZE, -1, np.int32)
    new_start = np.zeros_like(ls)
    ni, ci = leaf_pos[:, 0], leaf_pos[:, 1]
    cnt = lc[ni, ci].astype(np.int64)
    base = np.arange(len(leaf_pos), dtype=np.int64) * LEAF_SIZE
    new_start[ni, ci] = base.astype(np.int32)
    # ragged scatter: element j of leaf li goes to base[li] + j
    within = np.arange(cnt.sum(), dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    perm[np.repeat(base, cnt) + within] = order[np.repeat(ls[ni, ci].astype(np.int64), cnt) + within]

    m = lo.shape[0]
    valid = lc >= 0
    box = np.zeros((m, 128), np.float32)
    for k in range(3):
        box[:, 8 * k: 8 * (k + 1)] = np.where(valid, lo[:, :, k], 0.0)
        box[:, 24 + 8 * k: 24 + 8 * (k + 1)] = np.where(valid, hi[:, :, k], 0.0)

    is_leaf = lc > 0
    block_base = new_start // 8  # 8-triangle block row (LEAF_SIZE is a multiple of 8)
    payload = np.where(is_leaf, block_base, cn).astype(np.int64)
    code = np.where(~valid, CODE_EMPTY, np.where(is_leaf, CODE_LEAF, CODE_INTERNAL)).astype(np.int64)
    meta = np.zeros((m, 16), np.int32)
    meta[:, 0:8] = ((payload << 6) | code).astype(np.int32)
    meta[:, 8:16] = _permcodes(lo, hi, valid)
    meta = meta.reshape(-1)
    return PackedBVH(
        torch.as_tensor(box, device=device), torch.as_tensor(meta, device=device),
        perm, tree_depth(meta),
    )


def permute_tri_array(arr, perm, pad_value=0) -> np.ndarray:
    """Reorder a per-triangle host array (T, ...) into packed-BVH order
    (Tp, ...), pad rows set to ``pad_value``."""
    arr = np.asarray(arr)
    perm = np.asarray(perm)
    out = np.full((perm.shape[0],) + arr.shape[1:], pad_value, arr.dtype)
    valid = perm >= 0
    out[valid] = arr[perm[valid]]
    return out


def bvh_stats(bvh: BVHArrays) -> dict:
    lc = np.asarray(bvh.child_leaf_count)
    return dict(
        nodes=int(bvh.num_nodes),
        leaves=int((lc > 0).sum()),
        max_leaf=int(lc.max(initial=0)),
        tris=int(bvh.tri_order.shape[0]),
    )


# ---------------------------------------------------------------------------
# numpy oracle of the traversal kernel
# ---------------------------------------------------------------------------

_F = np.float32


def _mt(o, d, v0, e0, e1):
    """Möller–Trumbore t of rays (n, 3) against rows (n, k, 3), BIG_T
    where invalid: the plain sweep's arithmetic, one rounding per op."""
    dx, dy, dz = (d[:, None, i] for i in range(3))
    e0x, e0y, e0z = (e0[..., i] for i in range(3))
    e1x, e1y, e1z = (e1[..., i] for i in range(3))
    px = dy * e1z - dz * e1y
    py = dz * e1x - dx * e1z
    pz = dx * e1y - dy * e1x
    det = px * e0x + py * e0y + pz * e0z
    parallel = np.abs(det) < _F(MT_TOLERANCE)
    inv_det = _F(1.0) / np.where(parallel, _F(1.0), det)
    tx, ty, tz = (o[:, None, i] - v0[..., i] for i in range(3))
    qx = ty * e0z - tz * e0y
    qy = tz * e0x - tx * e0z
    qz = tx * e0y - ty * e0x
    u = inv_det * (px * tx + py * ty + pz * tz)
    v = inv_det * (qx * dx + qy * dy + qz * dz)
    t = inv_det * (qx * e1x + qy * e1y + qz * e1z)
    valid = (
        ~parallel & (u >= _F(-MT_TOLERANCE)) & (v >= _F(-MT_TOLERANCE))
        & (u + v <= _F(1.0 + MT_TOLERANCE)) & (t > _F(T_MIN))
    )
    return np.where(valid, t, _F(BIG_T))


def traverse_packed_ref(box, meta, tri_v0, tri_e0, tri_e1, o, d, mode="closest", t_max=None):
    """Per-ray stack traversal of the packed tables, as the CUDA kernel
    does it (all rays step together, each with its own stack):

    - ``inv = 1/where(|d| < 1e-12, 1e-12, d)``; octant from the signs of d;
    - pop an entry (slotword, tn); skip it when tn > limit (limit = t_best
      for "closest", ``t_max`` for "any");
    - a leaf tests its LEAF_SIZE rows from ``payload·8`` in order
      (closest: strict t < t_best; any: stop at the first t < t_max);
    - an internal node slab-tests its children,
      ``tn = max(…, T_MIN) <= tf = min(…, limit)``, and pushes the
      non-empty ones that pass in its far-to-near permcode order for the
      ray's octant, so pops are near-first.

    Returns ``(t, i, counts)`` for "closest" (BIG_T and row 0 on a miss)
    or ``(occluded, counts)`` for "any"; ``counts`` holds per-ray int64
    arrays: ``pops`` (internal nodes expanded), ``slabs`` (child slab
    tests) and ``tests`` (ray-triangle tests)."""
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    anyhit = mode == "any"
    npf = lambda x: np.asarray(x.cpu() if torch.is_tensor(x) else x)  # noqa: E731
    box = npf(box).astype(_F).reshape(-1, 128)
    lo = box[:, 0:24].reshape(-1, 3, 8)
    hi = box[:, 24:48].reshape(-1, 3, 8)
    meta = npf(meta).astype(np.int32).reshape(-1, 16)
    v0, e0, e1 = (npf(a).astype(_F) for a in (tri_v0, tri_e0, tri_e1))
    o = npf(o).astype(_F)
    d = npf(d).astype(_F)
    n = o.shape[0]
    if anyhit:
        limit0 = np.broadcast_to(np.asarray(npf(t_max), _F), (n,)).copy()
    tiny = _F(1e-12)
    inv = _F(1.0) / np.where(np.abs(d) < tiny, tiny, d)
    octant = (d[:, 0] < 0) | ((d[:, 1] < 0) << 1) | ((d[:, 2] < 0) << 2)

    # BRANCHING spare columns: an overflow is caught after the push
    st_w = np.zeros((n, STACK_SIZE + BRANCHING), np.int32)
    st_t = np.zeros((n, STACK_SIZE + BRANCHING), _F)
    st_w[:, 0] = (0 << 6) | CODE_INTERNAL  # root, tn = 0
    sp = np.ones(n, np.int64)
    t_best = np.full(n, BIG_T, _F)
    i_best = np.zeros(n, np.int64)
    occ = np.zeros(n, bool)
    counts = {k: np.zeros(n, np.int64) for k in ("pops", "slabs", "tests")}
    rows16 = np.arange(LEAF_SIZE)
    while True:
        r = np.nonzero((sp > 0) & ~occ)[0]
        if r.size == 0:
            break
        sp[r] -= 1
        w = st_w[r, sp[r]]
        limit = limit0[r] if anyhit else t_best[r]
        keep = st_t[r, sp[r]] <= limit
        r, w, limit = r[keep], w[keep], limit[keep]
        code, payload = w & 63, w >> 6

        lf = code == CODE_LEAF
        rl = r[lf]
        if rl.size:
            rows = payload[lf][:, None] * 8 + rows16  # (nl, 16)
            t = _mt(o[rl], d[rl], v0[rows], e0[rows], e1[rows])
            if anyhit:
                hit = t < limit[lf][:, None]
                found = hit.any(axis=1)
                counts["tests"][rl] += np.where(found, np.argmax(hit, axis=1) + 1, LEAF_SIZE)
                occ[rl] |= found
            else:
                k = np.argmin(t, axis=1)
                tk = t[np.arange(rl.size), k]
                better = tk < t_best[rl]
                t_best[rl] = np.where(better, tk, t_best[rl])
                i_best[rl] = np.where(better, rows[np.arange(rl.size), k], i_best[rl])
                counts["tests"][rl] += LEAF_SIZE

        ri = r[~lf]
        if ri.size:
            node = payload[~lf]
            lim = limit[~lf][:, None]
            oo, ii = o[ri][:, :, None], inv[ri][:, :, None]
            t0 = (lo[node] - oo) * ii  # (ni, 3, 8)
            t1 = (hi[node] - oo) * ii
            tmin, tmax = np.minimum(t0, t1), np.maximum(t0, t1)
            tn = np.maximum(np.maximum(tmin[:, 0], tmin[:, 1]), np.maximum(tmin[:, 2], _F(T_MIN)))
            tf = np.minimum(np.minimum(tmax[:, 0], tmax[:, 1]), np.minimum(tmax[:, 2], lim))
            slots = meta[node, :8]
            nonempty = (slots & 63) != CODE_EMPTY
            want = (tn <= tf) & nonempty
            counts["pops"][ri] += 1
            counts["slabs"][ri] += nonempty.sum(axis=1)
            pc = meta[node, 8 + octant[ri]]
            idx = np.arange(ri.size)
            for k in range(BRANCHING):
                ch = (pc >> (3 * k)) & 7
                push = want[idx, ch]
                rp = ri[push]
                st_w[rp, sp[rp]] = slots[idx, ch][push]
                st_t[rp, sp[rp]] = tn[idx, ch][push]
                sp[rp] += 1
            if sp.max() > STACK_SIZE:
                raise RuntimeError(f"traversal stack overflow ({STACK_SIZE} entries)")
    if anyhit:
        return occ, counts
    return t_best, i_best, counts

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
numpy, as the reference's CUDA renderer walks them: the CPU oracle of the
kernels' traversal, with the counts of node pops and triangle tests that
the bound of the kernels' work needs.

The CUDA kernels that walk the tree (the traversal kernels of
``csrc/bvh.cu`` and the fused path-tracing kernels of
``csrc/megakernel.cu``) read a compact copy of it, built once per scene
(``scene/types.py``):

- ``pack_nodes`` → (M, 64) 32-bit words per node, 256 B: the 48 slab
  floats of ``box`` (the TPU's 80 lanes of padding dropped), the 8 slot
  words, with a leaf's row count less one in the spare bits 2-5, and the 8
  permcodes; a node reads as 16 float4 loads;
- ``pack_tri_rows`` → (Tp, 12) f32 rows ``[v0,0|e0,0|e1,0]``, three float4
  loads per triangle.

``traverse_compact_ref`` walks those tables one ray at a time as the
kernels' traversal (``csrc/bvh_compact.cuh``) does (a stack of (node,
children left) entries, one per level), and gives ``traverse_packed_ref``'s
t and rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .intersect import BIG_T, MT_TOLERANCE, T_MIN

LEAF_SIZE = 16  # triangles per leaf, two 8-row blocks
N_BINS = 16
BRANCHING = 8
STACK_SIZE = 64  # entries of traverse_packed_ref's stack of children
COMPACT_STACK = 8  # entries of the kernels' stack (csrc/bvh_compact.cuh)
NODE_WORDS = 64  # 32-bit words of a compact node: 48 slabs | 8 slots | 8 permcodes
ROW_WORDS = 12  # floats of a compact triangle row

CODE_EMPTY = 0
CODE_INTERNAL = 1
CODE_LEAF = 2


def stack_fits(depth: int) -> bool:
    """Can the kernels walk a tree of ``depth`` levels of internal nodes?
    Their compact walk keeps one (node, children left) entry per level
    above the deepest (depth - 1 entries): depth 9 at most, the depth that
    ``traverse_packed_ref``'s stack of children (7·depth + 1 entries) allows
    too."""
    return depth - 1 <= COMPACT_STACK


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
    the module docstring), plus the host permutation, the tree's depth and
    the kernels' compact node table. ``packed_bvh`` makes one."""

    box: torch.Tensor  # (M, 128) f32
    meta: torch.Tensor  # (M*16,) i32
    perm: np.ndarray  # (Tp,) i32 host: packed row → original tri, -1 = pad
    depth: int  # levels of internal nodes from the root (stack_fits)
    nodes: torch.Tensor  # (M, 64) compact nodes (pack_nodes)

    @property
    def num_nodes(self):
        return self.box.shape[0]


def packed_bvh(box: torch.Tensor, meta: torch.Tensor, perm) -> PackedBVH:
    """PackedBVH of the reference-layout tables ``box`` and ``meta`` (on
    the scene's device) and the host ``perm``: their depth and compact
    nodes built here, once per scene."""
    perm = np.asarray(perm, np.int32)
    return PackedBVH(box, meta, perm, tree_depth(meta.cpu()), pack_nodes(box, meta, perm))


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
    tables (box rows + slotword/permcode meta, and their compact copy)
    onto ``device``."""
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
    return packed_bvh(torch.as_tensor(box, device=device),
                      torch.as_tensor(meta.reshape(-1), device=device), perm)


def pack_nodes(box, meta, perm) -> torch.Tensor:
    """The compact node table (M, 64) f32 on ``box``'s device: per node
    ``box``'s 48 slab floats, the 8 slot words and the 8 permcodes of
    ``meta`` (int32 bit patterns). A leaf's slot word also holds its row
    count less one in bits 2-5: one past its last real row (``perm`` ≥ 0),
    so a leaf test stops before the pad rows at its end."""
    m = box.shape[0]
    meta = np.asarray(meta.cpu(), np.int32).reshape(m, 16)
    slots = meta[:, :8].astype(np.int64)
    real = np.asarray(perm) >= 0
    rows = ((slots >> 6) * 8)[..., None] + np.arange(LEAF_SIZE)  # (M, 8, 16)
    in_leaf = np.where(rows < real.size, real[np.minimum(rows, real.size - 1)], False)
    count = np.where(in_leaf.any(-1), LEAF_SIZE - np.argmax(in_leaf[..., ::-1], axis=-1), 1)
    leaf = (slots & 63) == CODE_LEAF
    words = np.where(leaf, slots | ((count - 1) << 2), slots).astype(np.int32)
    nodes = np.zeros((m, NODE_WORDS), np.int32)
    nodes[:, :48] = np.asarray(box.cpu(), np.float32)[:, :48].view(np.int32)
    nodes[:, 48:56] = words
    nodes[:, 56:64] = meta[:, 8:16]
    return torch.from_numpy(nodes.view(np.float32)).to(box.device)


def pack_tri_rows(v0, e0, e1) -> torch.Tensor:
    """(Tp, 12) f32 triangle rows ``[v0,0|e0,0|e1,0]`` of the packed
    arrays, on their device."""
    z = torch.zeros_like(v0[:, :1])
    return torch.cat([v0, z, e0, z, e1, z], dim=1).contiguous()


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


def traverse_packed_ref(box, meta, tri_v0, tri_e0, tri_e1, o, d, mode="closest", t_max=None,
                        perm=None):
    """Per-ray stack traversal of the packed tables, one stack of
    children per ray (all rays step together), the walk that the kernels'
    compact traversal reproduces bit for bit:

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
    tests) and ``tests`` (ray-triangle tests). Given the host ``perm``,
    ``tests`` counts real rows only (``perm`` ≥ 0): a leaf's pad rows follow
    its real ones and never hit, so these are the tests a traversal needs,
    where a walk of these tables alone makes all LEAF_SIZE."""
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
    real = np.ones(v0.shape[0], bool) if perm is None else np.asarray(perm) >= 0
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
            n_real = real[rows].sum(axis=1)
            if anyhit:
                hit = t < limit[lf][:, None]
                found = hit.any(axis=1)
                counts["tests"][rl] += np.where(found, np.argmax(hit, axis=1) + 1, n_real)
                occ[rl] |= found
            else:
                k = np.argmin(t, axis=1)
                tk = t[np.arange(rl.size), k]
                better = tk < t_best[rl]
                t_best[rl] = np.where(better, tk, t_best[rl])
                i_best[rl] = np.where(better, rows[np.arange(rl.size), k], i_best[rl])
                counts["tests"][rl] += n_real

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


def traverse_compact_ref(nodes, rows, o, d, mode="closest", t_max=None):
    """Per-ray walk of the compact tables (``pack_nodes``,
    ``pack_tri_rows``), one ray at a time, as the kernels' traversal
    (``csrc/bvh_compact.cuh``) does it:

    - a node's expansion slab-tests its 8 children at once (the test of
      ``traverse_packed_ref``) and keeps the non-empty ones that pass, in
      near-first order of the ray's octant permcode;
    - the walk takes the children left one by one: a leaf tests its rows
      up to its last real one; an internal child is descended into, its
      parent pushed as (node, children left) when any are left; an empty
      list pops the stack;
    - a child taken after the limit may have shrunk (not the first one of
      an expansion) is slab-tested again against the limit (t_best for
      "closest"; "any" never shrinks its limit), the cull the packed walk
      makes with its stored tn.

    The visits, culls and leaf tests are ``traverse_packed_ref``'s, in the
    same order, so it returns the same ``(t, i, counts)`` for "closest"
    (BIG_T and row 0 on a miss) or ``(occluded, counts)`` for "any";
    ``counts`` holds per-ray ``pops`` (internal nodes expanded) and
    ``tests`` (the rows tested, which stop at each leaf's last real row:
    ``traverse_packed_ref``'s counts given ``perm``)."""
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    anyhit = mode == "any"
    npf = lambda x: np.asarray(x.cpu() if torch.is_tensor(x) else x)  # noqa: E731
    nd = npf(nodes).astype(_F).reshape(-1, NODE_WORDS)
    slab = nd[:, :48].reshape(-1, 6, 8)  # lo x, y, z | hi x, y, z
    words = nd[:, 48:].view(np.int32)  # slot words | permcodes
    rw = npf(rows).astype(_F).reshape(-1, ROW_WORDS)
    v0, e0, e1 = rw[:, 0:3], rw[:, 4:7], rw[:, 8:11]
    o = npf(o).astype(_F)
    d = npf(d).astype(_F)
    n = o.shape[0]
    if anyhit:
        limit0 = np.broadcast_to(np.asarray(npf(t_max), _F), (n,))
    tiny = _F(1e-12)
    inv = _F(1.0) / np.where(np.abs(d) < tiny, tiny, d)
    t_best = np.full(n, BIG_T, _F)
    i_best = np.zeros(n, np.int64)
    occ = np.zeros(n, bool)
    counts = {k: np.zeros(n, np.int64) for k in ("pops", "tests")}
    for r in range(n):
        oct_ = int(d[r, 0] < 0) | int(d[r, 1] < 0) << 1 | int(d[r, 2] < 0) << 2
        tb = limit0[r] if anyhit else _F(BIG_T)
        oo, ii = o[r][:, None], inv[r][:, None]

        def passes(node):
            t0 = (slab[node, 0:3] - oo) * ii
            t1 = (slab[node, 3:6] - oo) * ii
            tmin, tmax = np.minimum(t0, t1), np.maximum(t0, t1)
            tn = np.maximum(np.maximum(tmin[0], tmin[1]), np.maximum(tmin[2], _F(T_MIN)))
            tf = np.minimum(np.minimum(tmax[0], tmax[1]), np.minimum(tmax[2], tb))
            return (tn <= tf) & ((words[node, :8] & 3) != CODE_EMPTY)

        def expand(node):
            counts["pops"][r] += 1
            pc, ok = int(words[node, 8 + oct_]), passes(node)
            return [c for c in ((pc >> (21 - 3 * j)) & 7 for j in range(BRANCHING)) if ok[c]]

        node, left, fresh, stack = 0, expand(0), True, []
        while left or stack:
            if not left:
                node, left = stack.pop()
                fresh = False
                continue
            ch = left.pop(0)
            if not (anyhit or fresh or passes(node)[ch]):
                continue
            fresh = False
            w = int(words[node, ch])
            if w & 3 == CODE_LEAF:
                k = np.arange((w >> 6) * 8, (w >> 6) * 8 + ((w >> 2) & 15) + 1)
                t = _mt(o[r:r + 1], d[r:r + 1], v0[k][None], e0[k][None], e1[k][None])[0]
                if anyhit and (t < tb).any():
                    counts["tests"][r] += int(np.argmax(t < tb)) + 1
                    occ[r] = True
                    break
                counts["tests"][r] += k.size
                j = int(np.argmin(t))
                if not anyhit and t[j] < tb:
                    tb, i_best[r] = t[j], k[j]
                continue
            if left:
                stack.append((node, left))
                if len(stack) > COMPACT_STACK:
                    raise RuntimeError(f"traversal stack overflow ({COMPACT_STACK} entries)")
            node, left, fresh = w >> 6, expand(w >> 6), True
        t_best[r] = tb
    if anyhit:
        return occ, counts
    return t_best, i_best, counts

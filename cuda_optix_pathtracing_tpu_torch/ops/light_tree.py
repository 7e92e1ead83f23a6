"""Many-lights light tree (Conty Estevez & Kulla, HPG 2018), counterpart
of the reference ``ops/light_tree.py``.

A binary tree over *light records* (point/spot rows of the light table
and single emissive triangles), built on the host with the summed-area
orientation heuristic (SAOH); at shading time each ray descends it
stochastically by cluster importance, and a record's selection pmf is
recovered from its branch bits for MIS against BSDF sampling.

- The host build is numpy, record for record the reference's: the nodes
  flattened into one ``(M, 15)`` float32 feature matrix
  ``[lo(3), hi(3), axis(3), theta_o, theta_e, energy, left, right, rec]``
  (a leaf's children point at itself and ``rec`` holds its record; −1 on
  internal nodes).
- The descent runs ``depth`` levels for every ray; a ray that reaches a
  leaf early stays there. Each level gathers both children of every
  ray's node as one ``(2N, 15)`` row gather and scores them in one
  ``_importance`` call.
- ``light_tree_pmf`` replays the descent along a record's branch bits,
  multiplying the branch probabilities. The bits are ``(R, 2)`` int64
  words (levels 0-31, then 32-63), each holding an unsigned 32-bit value.
- Root splitting: the host precomputes the breadth-first frontiers of 1,
  2 and 4 subtree roots (−1 = dead slot); NEE draws one record below each
  live root.

Importance of a cluster seen from a shading point: energy × cos θ' ×
cos θ_i' / d², θ' discounting the cluster's orientation cone θ_o and the
angle θ_u it subtends, zero beyond the falloff θ_e (Conty & Kulla 2018,
§4).
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

REC_ROW = 0  # the record is a LightTable row (point/spot)
REC_TRI = 1  # the record is an emissive triangle

_BINS = 12

_F_LO, _F_HI, _F_AXIS = slice(0, 3), slice(3, 6), slice(6, 9)
_F_TO, _F_TE, _F_EN, _F_LEFT, _F_RIGHT, _F_REC = 9, 10, 11, 12, 13, 14


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------


class _Rec(NamedTuple):
    kind: int
    idx: int
    lo: np.ndarray
    hi: np.ndarray
    axis: np.ndarray
    theta_o: float
    theta_e: float
    energy: float


def _cone_union(a_axis, a_o, b_axis, b_o):
    """Merge two orientation cones → (axis, theta_o): the half-angle of the
    result spans both (Conty & Kulla 2018 §4.1)."""
    if b_o > a_o:
        a_axis, a_o, b_axis, b_o = b_axis, b_o, a_axis, a_o
    d = float(np.clip(np.dot(a_axis, b_axis), -1.0, 1.0))
    theta_d = math.acos(d)
    if min(theta_d + b_o, math.pi) <= a_o:
        return a_axis, a_o  # a covers b
    theta_o = (theta_d + a_o + b_o) * 0.5
    if theta_o >= math.pi:
        return a_axis, math.pi
    rot = theta_o - a_o  # turn a's axis toward b's by this much
    w = np.cross(a_axis, b_axis)
    wl = np.linalg.norm(w)
    if wl < 1e-9:
        return a_axis, math.pi if theta_d > 1e-6 else theta_o
    w = w / wl
    ca, sa = math.cos(rot), math.sin(rot)  # Rodrigues' rotation about w
    axis = a_axis * ca + np.cross(w, a_axis) * sa + w * np.dot(w, a_axis) * (1.0 - ca)
    n = np.linalg.norm(axis)
    return (axis / n if n > 0 else a_axis), theta_o


def _orientation_measure(theta_o: float, theta_e: float) -> float:
    """Solid-angle measure M_Ω of an orientation cone with falloff
    (Conty & Kulla 2018, eq. 1)."""
    theta_w = min(theta_o + theta_e, math.pi)
    so = math.sin(theta_o)
    return 2.0 * math.pi * (1.0 - math.cos(theta_o)) + 0.5 * math.pi * (
        2.0 * theta_w * so
        - math.cos(theta_o - 2.0 * theta_w)
        + 2.0 * theta_o * so
        + math.cos(theta_o)
    )


def _surface_area(lo, hi) -> float:
    d = np.maximum(hi - lo, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]) + 1e-8)


def _cluster_of(recs: Sequence[_Rec]):
    lo = np.min([r.lo for r in recs], axis=0)
    hi = np.max([r.hi for r in recs], axis=0)
    axis, theta_o = recs[0].axis, recs[0].theta_o
    for r in recs[1:]:
        axis, theta_o = _cone_union(axis, theta_o, r.axis, r.theta_o)
    theta_e = max(r.theta_e for r in recs)
    energy = float(sum(r.energy for r in recs))
    return lo, hi, axis, theta_o, theta_e, energy


def _saoh(recs) -> float:
    lo, hi, _, theta_o, theta_e, energy = _cluster_of(recs)
    return energy * _orientation_measure(theta_o, theta_e) * _surface_area(lo, hi)


class LightTree(NamedTuple):
    """The flattened tree on one device, and the host ints that shape the
    descent (``depth`` levels) and the root split (``frontiers``: the
    roots for 1, 2 and 4 splits)."""

    feat: torch.Tensor  # (M, 15) f32 node features
    rec_kind: torch.Tensor  # (R,) int32 REC_ROW | REC_TRI
    rec_idx: torch.Tensor  # (R,) int32 light row or emissive-table triangle
    trail: torch.Tensor  # (R, 2) int64 branch bits, word 0 = levels 0-31
    trail_len: torch.Tensor  # (R,) int32
    rec_energy: torch.Tensor  # (R,) f32
    infinite_rows: torch.Tensor  # (I,) int32 ENV/DIRECTIONAL rows ([0] if none)
    depth: int = 0
    n_records: int = 0
    n_infinite: int = 0
    frontiers: tuple = ((0,), (0, -1), (0, -1, -1, -1))


def _np(x, dtype=None):
    """Host numpy copy of a tensor or array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def _records_from_lights(ltype, color, pos, direction, cos_theta0, cos_theta_e, radius) -> list:
    """Light-table rows → records. ENV/DIRECTIONAL rows are infinite and
    stay outside the tree."""
    from .lights import POINT, SPOT

    recs = []
    for i in range(len(ltype)):
        t = int(ltype[i])
        lum = float(np.mean(color[i]))
        if t == POINT:
            r = max(float(radius[i]), 1e-3)
            recs.append(_Rec(
                REC_ROW, i, pos[i] - r, pos[i] + r, np.array([0.0, 0.0, 1.0]),
                math.pi, math.pi / 2, lum * 4.0 * math.pi,
            ))
        elif t == SPOT:
            r = max(float(radius[i]), 1e-3)
            to = math.acos(float(np.clip(cos_theta0[i], -1, 1)))
            te_abs = math.acos(float(np.clip(cos_theta_e[i], -1, 1)))
            recs.append(_Rec(
                REC_ROW, i, pos[i] - r, pos[i] + r, np.asarray(direction[i], np.float64), to,
                max(te_abs - to, 1e-3),
                lum * 2.0 * math.pi * (1.0 - 0.5 * (cos_theta0[i] + cos_theta_e[i])),
            ))
    return recs


def _records_from_emissive(v0, e0, e1, rad) -> list:
    recs = []
    for i in range(len(v0)):
        p0 = np.asarray(v0[i], np.float64)
        p1 = p0 + np.asarray(e0[i], np.float64)
        p2 = p0 + np.asarray(e1[i], np.float64)
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        n = np.cross(p1 - p0, p2 - p0)
        area = 0.5 * np.linalg.norm(n)
        axis = n / max(np.linalg.norm(n), 1e-12)
        lum = float(np.mean(rad[i]))
        # two-sided emitters: the cone covers both hemispheres
        recs.append(_Rec(
            REC_TRI, i, lo, hi, axis, math.pi / 2, math.pi / 2, lum * area * 2.0 * math.pi,
        ))
    return recs


def build_light_tree(lights=None, emissive=None, device=None) -> tuple[Optional[LightTree], np.ndarray]:
    """The tree over the finite rows of ``lights`` (a LightTable) and the
    triangles of ``emissive`` (an EmissiveTable), on ``device`` (default:
    the tables' own) → (tree or None, emissive_rec): ``emissive_rec[k]``
    is the record of emissive-table triangle ``k``."""
    from .lights import DIRECTIONAL, ENV

    if device is None:
        src = lights if lights is not None else emissive
        device = src[0].device if src is not None and torch.is_tensor(src[0]) else "cpu"
    recs: list = []
    inf_rows: list = []
    if lights is not None:
        lt_np = _np(lights.ltype)
        inf_rows = [int(i) for i in np.where((lt_np == ENV) | (lt_np == DIRECTIONAL))[0]]
        recs += _records_from_lights(
            lt_np, _np(lights.color), _np(lights.pos, np.float64),
            _np(lights.direction, np.float64), _np(lights.cos_theta0),
            _np(lights.cos_theta_e), _np(lights.radius),
        )
    if emissive is not None:
        recs += _records_from_emissive(
            _np(emissive.v0), _np(emissive.e0), _np(emissive.e1), _np(emissive.rad)
        )
    if not recs:
        return None, np.zeros((0,), np.int32)

    nodes = []  # dicts, children patched in
    rec_trail = np.zeros((len(recs), 2), np.uint32)  # 64-bit trail in two words
    rec_tlen = np.zeros((len(recs),), np.int32)

    def make_node(rec_ids, depth, trail):
        lo, hi, axis, theta_o, theta_e, energy = _cluster_of([recs[i] for i in rec_ids])
        node_id = len(nodes)
        nodes.append(dict(lo=lo, hi=hi, axis=axis, theta_o=theta_o, theta_e=theta_e,
                          energy=energy, left=-1, right=-1, depth=depth))
        if len(rec_ids) == 1:
            r = rec_ids[0]
            nodes[node_id]["right"] = r  # a leaf's right holds its record
            rec_trail[r, 0] = np.uint32(trail & 0xFFFFFFFF)
            rec_trail[r, 1] = np.uint32(trail >> 32)
            rec_tlen[r] = depth
            return node_id
        # a skewed SAOH chain could overflow the 64-bit trail: once the
        # balanced depth left would pass the budget, split at the median
        force_median = depth + max(1, math.ceil(math.log2(len(rec_ids)))) >= 60
        best = None
        if not force_median:
            # binned SAOH over the 3 axes of the centroids' box
            cents = np.stack([(recs[i].lo + recs[i].hi) * 0.5 for i in rec_ids])
            for ax in range(3):
                cmin, cmax = cents[:, ax].min(), cents[:, ax].max()
                if cmax - cmin < 1e-12:
                    continue
                which = np.minimum(
                    ((cents[:, ax] - cmin) / (cmax - cmin) * _BINS).astype(int), _BINS - 1
                )
                for cut in range(1, _BINS):
                    l_ids = [rid for rid, w in zip(rec_ids, which) if w < cut]
                    r_ids = [rid for rid, w in zip(rec_ids, which) if w >= cut]
                    if not l_ids or not r_ids:
                        continue
                    cost = _saoh([recs[i] for i in l_ids]) + _saoh([recs[i] for i in r_ids])
                    if best is None or cost < best[0]:
                        best = (cost, l_ids, r_ids)
        if best is None:  # coincident centroids or forced balance: median
            half = len(rec_ids) // 2
            best = (0.0, list(rec_ids[:half]), list(rec_ids[half:]))
        _, l_ids, r_ids = best
        nodes[node_id]["left"] = make_node(l_ids, depth + 1, trail)
        nodes[node_id]["right"] = make_node(r_ids, depth + 1, trail | (1 << depth))
        return node_id

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * len(recs) + 64))
    try:
        make_node(list(range(len(recs))), 0, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    depth = int(max(n["depth"] for n in nodes))
    assert depth < 64, f"light tree depth {depth} exceeds the 64-bit trail"
    feat = np.zeros((len(nodes), 15), np.float32)
    for i, n in enumerate(nodes):
        leaf = n["left"] < 0
        feat[i, _F_LO] = n["lo"]
        feat[i, _F_HI] = n["hi"]
        feat[i, _F_AXIS] = n["axis"]
        feat[i, _F_TO] = n["theta_o"]
        feat[i, _F_TE] = n["theta_e"]
        feat[i, _F_EN] = n["energy"]
        # a leaf's children are itself: the fixed-depth descent idles there
        feat[i, _F_LEFT] = i if leaf else n["left"]
        feat[i, _F_RIGHT] = i if leaf else n["right"]
        feat[i, _F_REC] = n["right"] if leaf else -1

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    tree = LightTree(
        feat=t(feat, np.float32),
        rec_kind=t([r.kind for r in recs], np.int32),
        rec_idx=t([r.idx for r in recs], np.int32),
        trail=t(rec_trail, np.int64),
        trail_len=t(rec_tlen, np.int32),
        rec_energy=t([r.energy for r in recs], np.float32),
        infinite_rows=t(inf_rows or [0], np.int32),
        depth=depth,
        n_records=len(recs),
        n_infinite=len(inf_rows),
        frontiers=tuple(tuple(_frontier_from_feat(feat, s)) for s in (1, 2, 4)),
    )
    emissive_rec = np.array([i for i, r in enumerate(recs) if r.kind == REC_TRI], np.int32)
    return tree, emissive_rec


def light_tree_from_arrays(feat, rec_kind, rec_idx, trail, trail_len, rec_energy,
                           infinite_rows, n_infinite: int, device) -> LightTree:
    """A LightTree from its arrays (a reference tree flattened to numpy):
    ``depth`` is the longest branch trail, the frontiers come from
    ``feat``; the trail words are taken as unsigned 32-bit values."""
    feat = np.asarray(feat, np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    trail_len = np.asarray(trail_len, np.int32)
    return LightTree(
        feat=t(feat, np.float32),
        rec_kind=t(rec_kind, np.int32),
        rec_idx=t(rec_idx, np.int32),
        trail=t(np.asarray(trail).astype(np.uint32), np.int64),
        trail_len=t(trail_len, np.int32),
        rec_energy=t(rec_energy, np.float32),
        infinite_rows=t(infinite_rows, np.int32),
        depth=int(trail_len.max()),
        n_records=int(trail_len.shape[0]),
        n_infinite=int(n_infinite),
        frontiers=tuple(tuple(_frontier_from_feat(feat, s)) for s in (1, 2, 4)),
    )


def _frontier_from_feat(feat: np.ndarray, n_split: int) -> list:
    """Breadth-first expansion of the root into ≤ ``n_split`` node ids
    over the host feature matrix (−1 = dead slot)."""
    frontier = [0]
    for _ in range(int(math.log2(n_split))):
        nxt = []
        for nd in frontier:
            if nd < 0:
                nxt += [-1, -1]
            elif int(round(feat[nd, _F_REC])) >= 0:  # a leaf: keep, and a dead slot
                nxt += [nd, -1]
            else:
                nxt += [int(round(feat[nd, _F_LEFT])), int(round(feat[nd, _F_RIGHT]))]
        frontier = nxt
    return frontier


def split_frontier(tree: LightTree, n_split: int):
    """The root split into ≤ ``n_split`` (1, 2 or 4) subtree roots →
    (levels, roots), roots a list of node ids (−1 = dead slot), read from
    the host's precomputed frontiers."""
    assert n_split in (1, 2, 4), "split budget must be 1, 2, or 4"
    levels = int(math.log2(n_split))
    return levels, list(tree.frontiers[levels])


# ---------------------------------------------------------------------------
# device side: importance and descent
# ---------------------------------------------------------------------------


def _importance(f, p, n):
    """Importance of the clusters ``f`` ((N, 15) node features) from
    shading points ``p`` with normals ``n``."""
    lo, hi = f[:, _F_LO], f[:, _F_HI]
    axis = f[:, _F_AXIS]
    theta_o, theta_e, energy = f[:, _F_TO], f[:, _F_TE], f[:, _F_EN]
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    r2 = torch.sum(half * half, dim=-1)
    d = p - center
    d2 = torch.sum(d * d, dim=-1)
    d2c = torch.maximum(d2, r2)  # no blow-up inside or next to the cluster
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    wi = d / dist[..., None]  # cluster → shading point
    cos_t = torch.clamp(torch.sum(axis * wi, dim=-1), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_u = torch.clamp(torch.sqrt(r2) / dist, 0.0, 1.0)
    theta_u = torch.arcsin(sin_u)
    theta_p = torch.clamp(theta - theta_o - theta_u, min=0.0)
    emitted = torch.where(theta_p < theta_e, torch.cos(theta_p), 0.0)
    # incident-angle bound (|cos|: two-sided BSDFs)
    cos_i = torch.clamp(torch.abs(torch.sum(n * (-wi), dim=-1)), 0.0, 1.0)
    theta_i = torch.arccos(cos_i)
    cos_ip = torch.cos(torch.clamp(theta_i - theta_u, min=0.0))
    return torch.clamp(energy * emitted * cos_ip / torch.clamp(d2c, min=1e-8), min=0.0)


def _level(tree: LightTree, node, p2, n2):
    """One descent level for the nodes ``node`` (N,) → (left, right,
    is_leaf, pl): both children gathered as one (2N, 15) row gather and
    scored in one call; ``pl`` the probability of going left."""
    npts = node.shape[0]
    links = torch.round(tree.feat[node, _F_LEFT:]).to(torch.int64)  # left, right, rec
    left, right = links[:, 0], links[:, 1]
    is_leaf = links[:, 2] >= 0
    imp = _importance(tree.feat[torch.cat([left, right])], p2, n2)
    il, ir = imp[:npts], imp[npts:]
    tot = il + ir
    pl = torch.where(tot > 0, il / torch.clamp(tot, min=1e-30), 0.5)
    return left, right, is_leaf, pl


def sample_light_tree(tree: LightTree, p, n, u, root=None):
    """Stochastic importance descent from ``root`` (default: node 0) →
    (record (N,) int64, pmf (N,) f32); ``u`` is rescaled at every level
    (CDF inversion reused)."""
    npts = p.shape[0]
    node = torch.full((npts,), 0 if root is None else int(root), dtype=torch.int64, device=p.device)
    pmf = torch.ones((npts,), dtype=torch.float32, device=p.device)
    p2, n2 = torch.cat([p, p]), torch.cat([n, n])
    for _ in range(tree.depth):
        left, right, is_leaf, pl = _level(tree, node, p2, n2)
        go_left = u < pl
        u = torch.clamp(
            torch.where(
                go_left,
                u / torch.clamp(pl, min=1e-12),
                (u - pl) / torch.clamp(1.0 - pl, min=1e-12),
            ),
            0.0,
            1.0 - 1e-7,
        )
        step_p = torch.where(go_left, pl, 1.0 - pl)
        node = torch.where(is_leaf, node, torch.where(go_left, left, right))
        pmf = torch.where(is_leaf, pmf, pmf * step_p)
    rec = torch.round(tree.feat[node, _F_REC]).to(torch.int64)
    return torch.clamp(rec, min=0), pmf


def light_tree_pmf(tree: LightTree, rec, p, n, split_levels: int = 0):
    """The pmf with which ``sample_light_tree`` (below a root split of
    ``split_levels`` deterministic levels) selects record ``rec`` from
    ``p``/``n``: the descent replayed along the record's branch bits."""
    rec = rec.to(torch.int64)
    trail = tree.trail[rec]  # (N, 2) int64, unsigned 32-bit words
    tlen = tree.trail_len[rec]
    npts = p.shape[0]
    node = torch.zeros((npts,), dtype=torch.int64, device=p.device)
    pmf = torch.ones((npts,), dtype=torch.float32, device=p.device)
    p2, n2 = torch.cat([p, p]), torch.cat([n, n])
    for level in range(tree.depth):
        left, right, is_leaf, pl = _level(tree, node, p2, n2)
        bit = (trail[:, level // 32] >> (level % 32)) & 1
        active = (level < tlen) & ~is_leaf
        step_p = torch.where(bit == 0, pl, 1.0 - pl)
        if level >= split_levels:
            pmf = torch.where(active, pmf * step_p, pmf)
        node = torch.where(active, torch.where(bit == 0, left, right), node)
    return pmf

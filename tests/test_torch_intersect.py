"""The plain closest-hit and any-hit sweeps (the CUDA kernels' plain
versions) against the JAX reference ``ops/intersect.py`` on the Cornell
triangles, with camera-like and random rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import intersect as JI
from cuda_optix_pathtracing_tpu.scene import cornell_box as j_cornell_box
from cuda_optix_pathtracing_tpu_torch.ops import intersect as TI
from cuda_optix_pathtracing_tpu_torch.ops import intersect_cuda as TC
from cuda_optix_pathtracing_tpu_torch.ops.bvh import pack_tri_rows
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box as t_cornell_box

torch.set_num_threads(2)

N = 4096


@pytest.fixture(scope="module")
def tris():
    s = j_cornell_box(16, 16)
    return [np.asarray(a) for a in (s.tri_v0, s.tri_e0, s.tri_e1)]


@pytest.fixture(scope="module", params=["random", "camera"])
def rays(request):
    rs = np.random.default_rng(11)
    if request.param == "random":
        o = rs.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (N, 3))
        d = rs.normal(size=(N, 3))
    else:  # from the camera at the origin into the box's +y half-space
        o = np.zeros((N, 3))
        d = np.stack([rs.uniform(-1, 1, N), np.ones(N), rs.uniform(-1, 1, N)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = 0.0  # zero directions never hit
    t_max = rs.uniform(0.05, 6.0, N)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_closest_matches_reference(tris, rays):
    o, d, _ = rays
    tj, ij = JI.intersect_closest_raw(*(jnp.asarray(a) for a in (o, d, *tris)))
    tj, ij = np.asarray(tj), np.asarray(ij)
    tt, it = TC.closest_bruteforce(_t(o), _t(d), *(_t(a) for a in tris))
    tt, it = tt.numpy(), it.numpy()
    rel = np.abs(tt - tj) / np.maximum(np.abs(tj), 1e-30)
    assert rel.max() <= 1e-5
    tie = rel <= 1e-6
    assert ((it == ij) | tie).all()
    assert (tt[:4] == TI.BIG_T).all() and (it[:4] == 0).all()
    assert (tt < TI.BIG_T).mean() > 0.3


def test_any_matches_reference(tris, rays):
    o, d, t_max = rays
    occ_j = np.asarray(JI.intersect_any(*(jnp.asarray(a) for a in (o, d, *tris, t_max))))
    occ_t = TC.anyhit_bruteforce(_t(o), _t(d), *(_t(a) for a in tris), _t(t_max)).numpy()
    assert (occ_j == occ_t).mean() >= 0.999
    assert not occ_t[:4].any()
    assert 0.05 < occ_t.mean() < 0.95


def test_closest_epilogue_matches_reference(tris, rays):
    o, d, _ = rays
    tj, ij = JI.intersect_closest_raw(*(jnp.asarray(a) for a in (o, d, *tris)))
    ref = JI.closest_epilogue(*(jnp.asarray(a) for a in (o, d, *tris)), tj, ij)
    out = TI.closest_epilogue(
        *(_t(a) for a in (o, d, *tris)), _t(np.asarray(tj)), _t(np.asarray(ij).astype(np.int64))
    )
    for name in ("hit", "front"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(out, name).numpy())
    for name in ("u", "v", "pos", "normal", "error"):
        a = np.asarray(getattr(ref, name))
        b = getattr(out, name).numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max()), name


def test_kernel_wrappers_refuse_oversized_tables():
    assert TC.MAX_TRIS == 227 * 1024 // 48 == 4842
    ok = torch.zeros((TC.MAX_TRIS, 3))
    rows, n = TC._rows(ok, ok, ok, pack_tri_rows(ok, ok, ok))
    assert n == TC.MAX_TRIS and rows.numel() == 12 * n
    big = torch.zeros((TC.MAX_TRIS + 1, 3))
    with pytest.raises(ValueError, match="BVH"):
        TC._rows(big, big, big, pack_tri_rows(big, big, big))


def _tie_case(name, n=4096):
    """(o, d, v0, e0, e1) of a seeded case full of ties in t: the Cornell
    box's 26 triangles followed by a shuffled copy of them (duplicates,
    whose ties the first index wins), or a 6 x 6 grid of quads split into
    72 triangles (shared edges and vertices), hit by rays aimed at points
    on the triangles' shared edges or at the grid's vertices."""
    rs = np.random.default_rng({"duplicated": 31, "shared_edges": 32, "vertex": 33}[name])
    if name == "duplicated":
        s = j_cornell_box(16, 16)
        v0, e0, e1 = (np.asarray(a) for a in (s.tri_v0, s.tri_e0, s.tri_e1))
        perm = rs.permutation(v0.shape[0])
        v0, e0, e1 = (np.concatenate([a, a[perm]]) for a in (v0, e0, e1))
        o = rs.uniform([-0.8, 0.0, 0.2], [0.8, 2.0, 1.6], (n, 3))
        d = rs.normal(size=(n, 3))
    else:
        g = 6
        ij = np.stack(np.meshgrid(np.arange(g), np.arange(g), indexing="ij"), -1).reshape(-1, 2)
        p00 = np.concatenate([0.5 * ij, np.zeros((g * g, 1))], 1)
        ex, ey = np.array([0.5, 0.0, 0.0]), np.array([0.0, 0.5, 0.0])
        # two triangles a quad, sharing its diagonal p10-p01
        v0 = np.concatenate([p00, p00 + ex + ey])
        e0 = np.concatenate([np.tile(ex, (g * g, 1)), np.tile(-ex, (g * g, 1))])
        e1 = np.concatenate([np.tile(ey, (g * g, 1)), np.tile(-ey, (g * g, 1))])
        k = rs.integers(0, g * g, n)
        if name == "vertex":
            target = p00[k] + rs.integers(0, 2, (n, 1)) * ex + rs.integers(0, 2, (n, 1)) * ey
        else:  # on a diagonal, or on the edge two neighbouring quads share
            u = rs.random((n, 1))
            side = rs.integers(0, 3, (n, 1))
            target = p00[k] + np.where(side == 0, u * ex + (1 - u) * ey,
                                       np.where(side == 1, ex + u * ey, ey + u * ex))
        o = target + rs.uniform([-1.0, -1.0, 0.5], [1.0, 1.0, 3.0], (n, 3))
        d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return tuple(f(a) for a in (o, d, v0, e0, e1))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["duplicated", "shared_edges", "vertex"])
def test_closest_split_matches_sweep(name, k):
    """The closest-hit kernel's split of a ray over k lanes, each sweeping
    every k-th triangle, then the lexicographic least (t, index) of the
    lanes, finds the sequential sweep's winner bit for bit, on cases where
    many rays tie in t between two or more triangles."""
    o, d, v0, e0, e1 = _tie_case(name)
    t = TI._mt_candidates(o, d, v0, e0, e1)
    least = t.min(1).values
    ties = ((t == least[:, None]).sum(1) >= 2) & (least < TI.BIG_T)
    assert int(ties.sum()) > 200
    ts, is_ = TI.intersect_closest_raw(o, d, v0, e0, e1)
    tk, ik = TI.closest_split_ref(o, d, v0, e0, e1, k)
    assert torch.equal(tk, ts) and torch.equal(ik, is_)
    assert int((ts < TI.BIG_T).sum()) > o.shape[0] // 2


def test_kernel_rows_from_the_scene_or_packed():
    """A brute-force scene's brute_tables[:12T] and pack_tri_rows hold the
    same geometry words (the first differs in word 3, the material id), and
    the wrappers give the same results with either as ``rows``."""
    scene = t_cornell_box(16, 16, device="cpu")
    v0, e0, e1 = scene.tri_v0, scene.tri_e0, scene.tri_e1
    n = v0.shape[0]
    packed = pack_tri_rows(v0, e0, e1)
    blob, n_b = TC._rows(v0, e0, e1, scene.brute_tables[: 12 * n])
    assert n_b == n and blob.data_ptr() == scene.brute_tables.data_ptr()
    geo = [0, 1, 2, 4, 5, 6, 8, 9, 10, 11, 7]
    assert torch.equal(blob.view(n, 12)[:, geo], packed[:, geo])
    o, d, t_max = (torch.from_numpy(a) for a in _seeded_rays(1024))
    for rows in (packed, scene.brute_tables[: 12 * n], None):
        tc, ic = TC.closest_bruteforce(o, d, v0, e0, e1, rows=rows)
        occ = TC.anyhit_bruteforce(o, d, v0, e0, e1, t_max, rows=rows)
        tr, ir = TI.intersect_closest_raw(o, d, v0, e0, e1)
        assert torch.equal(tc, tr) and torch.equal(ic, ir)
        assert torch.equal(occ, TI.intersect_any(o, d, v0, e0, e1, t_max))
    with pytest.raises(ValueError, match="rows"):
        TC._rows(v0, e0, e1, packed[:-1])


def test_t_max_is_read_in_place():
    """The any-hit kernel takes t_max as a pointer and a stride (0 for one
    value) or a Python number by value: no copy, no broadcast."""
    n = 8
    per_ray = torch.arange(2 * n, dtype=torch.float32)
    assert TC._t_max_arg(2.5, n, per_ray.device) == (None, 0, 2.5)
    one = torch.tensor(3.0)
    assert TC._t_max_arg(one, n, one.device) == (one.data_ptr(), 0, 0.0)
    view = per_ray[::2]
    assert TC._t_max_arg(view, n, view.device) == (view.data_ptr(), 2, 0.0)
    for bad in (per_ray, per_ray[:n].double()):
        with pytest.raises(ValueError, match="t_max"):
            TC._t_max_arg(bad, n, bad.device)


def _seeded_rays(n):
    rs = np.random.default_rng(5)
    o = rs.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            rs.uniform(0.05, 6.0, n).astype(np.float32))


def _cull_case(name, n=4096):
    """(o, d, v0, e0, e1, t_cap) of a seeded case for the fused kernel's
    cull: a soup of 48 triangles of sizes 0.01-10 and rays aimed at them,
    at random, at points on their edges and corners (edge-grazing), nearly
    in their planes (near-parallel: det near the 1e-7 cutoff) or starting
    a hair in front of them (near-origin: t near T_MIN); t_cap random, at
    the sweep's bound BIG_T, or a few ulp above or below each ray's t."""
    rs = np.random.default_rng({"random": 21, "grazing": 22, "parallel": 23,
                                "near_origin": 24}[name])
    t = 48
    scale = 10.0 ** rs.uniform(-2, 1, (t, 1))
    v0 = rs.uniform(-3, 3, (t, 3))
    e0 = rs.normal(size=(t, 3)) * scale
    e1 = rs.normal(size=(t, 3)) * scale
    k = rs.integers(0, t, n)
    normal = np.cross(e0[k], e1[k])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    if name == "random":
        o = rs.uniform(-6, 6, (n, 3))
        d = rs.normal(size=(n, 3))
    else:
        u, v = rs.random(n), rs.random(n)
        side = rs.integers(0, 4, n)  # on v = 0, u = 0, u + v = 1, or a corner
        u = np.where(side == 1, 0.0, u)
        v = np.where(side == 0, 0.0, v)
        edge = side == 2
        v = np.where(edge, 1.0 - u, v)
        u = np.where(side == 3, rs.integers(0, 2, n), u)
        v = np.where(side == 3, 0.0, v)
        jitter = rs.choice([-1.0, 0.0, 1.0], (n, 2)) * 10.0 ** rs.uniform(-9, -6, (n, 2))
        u, v = u + jitter[:, 0], v + jitter[:, 1]
        target = v0[k] + u[:, None] * e0[k] + v[:, None] * e1[k]
        if name == "parallel":
            along = np.cross(normal, rs.normal(size=(n, 3)))
            along /= np.linalg.norm(along, axis=1, keepdims=True)
            tilt = rs.choice([-1.0, 1.0], (n, 1)) * 10.0 ** rs.uniform(-9, -3, (n, 1))
            d = along + tilt * normal
            o = target - rs.uniform(0.1, 5.0, (n, 1)) * d / np.linalg.norm(d, axis=1,
                                                                        keepdims=True)
        else:
            d = rs.normal(size=(n, 3))
            dist = (rs.uniform(0.1, 5.0, (n, 1)) if name == "grazing"
                    else 1e-4 * (1.0 + rs.uniform(-1e-3, 1e-3, (n, 1))))
            o = target - dist * d / np.linalg.norm(d, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    o, d, v0, e0, e1 = (f(a) for a in (o, d, v0, e0, e1))
    t_hit, _ = TI.intersect_closest_raw(o, d, v0, e0, e1)
    which = rs.integers(0, 4, n)
    ulp = torch.from_numpy(rs.integers(-3, 4, n).astype(np.float32))
    near = t_hit * (1.0 + ulp * 2.0**-23)
    rand = f(rs.uniform(0.05, 8.0, n))
    t_cap = torch.where(torch.from_numpy(which == 0), torch.full_like(rand, TI.BIG_T), rand)
    t_cap = torch.where(torch.from_numpy(which >= 2) & (t_hit < TI.BIG_T), near, t_cap)
    return o, d, v0, e0, e1, t_cap


@pytest.mark.parametrize("name", ["random", "grazing", "parallel", "near_origin"])
def test_sweep_cull_never_rejects_a_hit(name):
    """The fused kernel's cull before the division (``mt_cull``) never
    rejects a pair that the plain sweep accepts below the sweep's limit
    (exactly: not one pair), nor the winner of ``intersect_closest_raw``
    at the least limit above its t, and it rejects most of the rest."""
    o, d, v0, e0, e1, t_cap = _cull_case(name)
    cull = TI.mt_cull(o, d, v0, e0, e1, t_cap)
    t = TI._mt_candidates(o, d, v0, e0, e1)
    accept = t < t_cap[:, None]
    assert accept.sum() > 100
    assert not bool((cull & accept).any())
    assert float(cull[~accept].float().mean()) > 0.5
    # the winner of the closest-hit sweep, tested against the least limit
    # above its t, and every occluder of the any-hit sweep
    t_best, i_best = TI.intersect_closest_raw(o, d, v0, e0, e1)
    hit = t_best < TI.BIG_T
    above = torch.nextafter(t_best, torch.tensor(float("inf")))
    cull_w = TI.mt_cull(o, d, v0, e0, e1, above)
    assert not bool(cull_w[torch.arange(o.shape[0]), i_best][hit].any())
    occ = TI.intersect_any(o, d, v0, e0, e1, t_cap)
    assert bool(((~cull & accept).any(1) == occ).all())

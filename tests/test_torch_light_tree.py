"""The port's light tree (``ops/light_tree.py``) and many-lights NEE
against the JAX reference, on inputs from a numpy seed: the host build
field for field, the descent's records and pmfs, the bit-trail pmf, a tree
scene's render at the parity bar; then the reference's own light-tree
tests (``tests/test_light_tree.py``) on the port's API."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.megakernel import MegakernelConfig as JCfg
from cuda_optix_pathtracing_tpu.models.megakernel import render_sample_batch as j_render_batch
from cuda_optix_pathtracing_tpu.ops import bsdf as JB
from cuda_optix_pathtracing_tpu.ops import light_tree as JT
from cuda_optix_pathtracing_tpu.ops import lights as JL
from cuda_optix_pathtracing_tpu.ops.camera import CameraConfig as JCam
from cuda_optix_pathtracing_tpu.scene.types import HostScene as JHost
from cuda_optix_pathtracing_tpu.scene.types import scene_from_host as j_from_host
from cuda_optix_pathtracing_tpu_torch.models.megakernel import (
    MegakernelConfig,
    render_sample_batch,
    resolve_fused,
)
from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import megakernel_cuda_supported
from cuda_optix_pathtracing_tpu_torch.ops import bsdf as TB
from cuda_optix_pathtracing_tpu_torch.ops import light_tree as TT
from cuda_optix_pathtracing_tpu_torch.ops import lights as TL
from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
from cuda_optix_pathtracing_tpu_torch.ops.camera import CameraConfig as TCam
from cuda_optix_pathtracing_tpu_torch.scene.procedural import generate_plane
from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene as THost
from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host as t_from_host

torch.set_num_threads(2)

FIELDS = ("feat", "rec_kind", "rec_idx", "trail", "trail_len", "rec_energy", "infinite_rows")
SIZE = 16
DEPTH = 2
SPP = 2


def _point_rows(n, rng, spread=4.0):
    rows = []
    for _ in range(n):
        p = rng.uniform(-spread, spread, 3)
        p[2] = rng.uniform(1.0, 3.0)
        rows.append(dict(ltype=TL.POINT, color=tuple(rng.uniform(0.05, 3.0, 3)), pos=tuple(p),
                         radius=1e-3))
    return rows


def _many_lights_host(host_cls, bsdf, lights, cam_cls, seed=5):
    """A Lambert floor and a wall under 14 point lights, two spots, a
    constant environment row, a directional row and an emissive strip of
    8 triangles (uneven areas): every record kind and both infinite kinds."""
    rng = np.random.default_rng(seed)
    hs = host_cls()
    hs.camera = cam_cls(position=(0.0, -6.0, 3.0), direction=(0.0, 1.0, -0.45),
                        width=SIZE, height=SIZE)
    hs.materials = [
        bsdf.lambert((0.7, 0.7, 0.7)),
        bsdf.oren_nayar((0.5, 0.6, 0.7), 0.4),
        bsdf.diffuse_light((3.0, 2.5, 2.0)),
    ]
    hs.add_model(generate_plane((0, 0, 0), (0, 0, 1), 12, 12), 0)
    hs.add_model(generate_plane((0, 3, 1.5), (0, -1, 0), 8, 3), 1)
    strip = []
    for k in range(4):
        x0 = -3.0 + 1.5 * k
        w = 0.4 + 0.3 * k
        quad = [[x0, 1.0, 2.5], [x0 + w, 1.0, 2.5], [x0 + w, 1.6, 2.5], [x0, 1.6, 2.5]]
        q = np.asarray(quad, np.float32)
        strip += [q[[0, 2, 1]], q[[0, 3, 2]]]
    hs.add_model(strip, 2)
    for row in _point_rows(14, rng):
        hs.add_light(dict(row, ltype=lights.POINT))
    hs.add_light(lights.spot_light((4.0, 3.0, 2.0), (1.0, -1.0, 2.5), (0.0, 0.3, -1.0),
                                   float(np.cos(0.4)), float(np.cos(0.7)), 0.02))
    hs.add_light(lights.spot_light((2.0, 3.0, 4.0), (-2.0, 1.0, 2.0), (0.2, 0.0, -1.0),
                                   float(np.cos(0.3)), float(np.cos(0.9)), 0.01))
    hs.add_light(lights.environment_light((0.05, 0.06, 0.08)))
    hs.add_light(lights.directional_light((0.4, 0.35, 0.3), (0.3, 0.5, -1.0), 0.01))
    return hs


@pytest.fixture(scope="module")
def tree100():
    rows = _point_rows(100, np.random.default_rng(7))
    jt, _ = JT.build_light_tree(JL.make_light_table([dict(r) for r in rows]), None)
    tt, _ = TT.build_light_tree(TL.make_light_table([dict(r) for r in rows]), None)
    return jt, tt


@pytest.fixture(scope="module")
def scenes():
    """(reference, port) scenes of ``_many_lights_host``, trees built."""
    j_scene = j_from_host(_many_lights_host(JHost, JB, JL, JCam))
    t_scene = t_from_host(_many_lights_host(THost, TB, TL, TCam), device="cpu")
    return j_scene, t_scene


def _assert_tree_equal(jt, tt):
    for name in FIELDS:
        ref = np.asarray(getattr(jt, name))
        ours = getattr(tt, name).numpy()
        np.testing.assert_array_equal(ours, ref.astype(ours.dtype), err_msg=name)
        assert np.array_equal(ours.astype(ref.dtype), ref), name
    assert (tt.depth, tt.n_records, tt.n_infinite) == (jt.depth, jt.n_records, jt.n_infinite)
    assert tt.frontiers == jt.frontiers


@pytest.mark.parametrize("which", ["points100", "scene"])
def test_tree_build_equals_reference(tree100, scenes, which):
    """The host build, field for field (the trail words as int64 holding
    the reference's u32 values), and a scene's ``tri_emrec``."""
    if which == "points100":
        jt, tt = tree100
    else:
        j_scene, t_scene = scenes
        jt, tt = j_scene.light_tree, t_scene.light_tree
        assert tt.n_records == 14 + 2 + 8 and tt.n_infinite == 2
        np.testing.assert_array_equal(t_scene.tri_emrec.numpy(), np.asarray(j_scene.tri_emrec))
        assert int((t_scene.tri_emrec >= 0).sum()) == 8
    _assert_tree_equal(jt, tt)


def _descent_gap(tree, p, n, u, root):
    """Per ray, the smallest |u − pl| over the port's descent levels:
    where it is below 1e-6, an ulp of pl between XLA and torch can send
    the ray the other way."""
    npts = p.shape[0]
    node = torch.full((npts,), root, dtype=torch.int64)
    gap = torch.full((npts,), float("inf"))
    p2, n2 = torch.cat([p, p]), torch.cat([n, n])
    for _ in range(tree.depth):
        left, right, is_leaf, pl = TT._level(tree, node, p2, n2)
        gap = torch.where(is_leaf, gap, torch.minimum(gap, (u - pl).abs()))
        go_left = u < pl
        u = torch.clamp(torch.where(go_left, u / torch.clamp(pl, min=1e-12),
                                    (u - pl) / torch.clamp(1.0 - pl, min=1e-12)), 0.0, 1.0 - 1e-7)
        node = torch.where(is_leaf, node, torch.where(go_left, left, right))
    return gap


@pytest.mark.parametrize("tree_of", ["points100", "scene"])
def test_sample_light_tree_matches_reference(tree100, scenes, tree_of):
    """Records equal but where u lies within 1e-6 of a branch probability
    (counted; at most 0.1 % of the rays), pmfs to rtol 1e-5, from every
    root of the 4-way split."""
    jt, tt = tree100 if tree_of == "points100" else (scenes[0].light_tree, scenes[1].light_tree)
    rng = np.random.default_rng(11)
    m = 8192
    p = rng.uniform([-4, -4, 0], [4, 4, 3], (m, 3)).astype(np.float32)
    n = rng.normal(size=(m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u = rng.uniform(0.0, 1.0, m).astype(np.float32)
    pt, nt, ut = (torch.from_numpy(a) for a in (p, n, u))
    for root in [r for r in tt.frontiers[2] if r >= 0] + [0]:
        rec_j, pmf_j = JT.sample_light_tree(jt, jnp.asarray(p), jnp.asarray(n), jnp.asarray(u),
                                            root=root)
        rec_t, pmf_t = TT.sample_light_tree(tt, pt, nt, ut, root=root)
        rec_j, pmf_j = np.asarray(rec_j), np.asarray(pmf_j)
        same = rec_t.numpy() == rec_j
        flips = ~same
        near = (_descent_gap(tt, pt, nt, ut, root) < 1e-6).numpy()
        assert not (flips & ~near).any(), f"root {root}: records differ away from a boundary"
        assert flips.sum() <= 1e-3 * m, f"root {root}: {flips.sum()} flips"
        np.testing.assert_allclose(pmf_t.numpy()[same], pmf_j[same], rtol=1e-5)


@pytest.mark.parametrize("split_levels", [0, 1, 2])
def test_light_tree_pmf_matches_reference(scenes, split_levels):
    """The bit-trail pmf of every record from 64 points (rtol 1e-5), and
    below a split the pmfs sum to the live subtrees (rtol 1e-4)."""
    jt, tt = scenes[0].light_tree, scenes[1].light_tree
    rng = np.random.default_rng(3)
    k = 64
    p = rng.uniform([-4, -4, 0], [4, 4, 2], (k, 3)).astype(np.float32)
    n = np.tile(np.float32([0.0, 0.0, 1.0]), (k, 1))
    rec = np.repeat(np.arange(tt.n_records), k)
    pp, nn = np.tile(p, (tt.n_records, 1)), np.tile(n, (tt.n_records, 1))
    ref = np.asarray(JT.light_tree_pmf(jt, jnp.asarray(rec, jnp.int32), jnp.asarray(pp),
                                       jnp.asarray(nn), split_levels=split_levels))
    ours = TT.light_tree_pmf(tt, torch.from_numpy(rec), torch.from_numpy(pp), torch.from_numpy(nn),
                             split_levels=split_levels).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    live = sum(r >= 0 for r in TT.split_frontier(tt, 1 << split_levels)[1])
    np.testing.assert_allclose(ours.reshape(tt.n_records, k).sum(0), live, rtol=1e-4)


@pytest.mark.parametrize("splits", [1, 4])
def test_tree_render_matches_reference(scenes, splits):
    """The tree scene (point, spot, emissive and infinite rows; tree-pmf
    MIS on emitter hits) at 16², depth 2, 2 spp, against JAX's XLA
    integrator at the parity bar."""
    j_scene, t_scene = scenes
    jcfg = JCfg(max_depth=DEPTH, remat=False, backend="xla", fused="off", nee_splits=splits)
    cfg = MegakernelConfig(max_depth=DEPTH, fused="off", nee_splits=splits)
    ref = np.asarray(j_render_batch(j_scene, jcfg, SIZE, SIZE, jnp.uint32(0), nspp=SPP)).sum(0)
    ours = render_sample_batch(t_scene, cfg, SIZE, SIZE, 0, nspp=SPP).numpy().sum(0)
    diff = np.abs(ref - ours) / SPP
    assert np.isfinite(ours).all() and ours.mean() > 0
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


def test_tree_config_and_gate(scenes):
    """``light_strategy="tree"`` is accepted (and refused on a scene
    without a tree); the fused gate refuses a tree scene, so ``auto``
    resolves to the plain integrator."""
    t_scene = scenes[1]
    assert not megakernel_cuda_supported(t_scene, MegakernelConfig())
    assert resolve_fused(t_scene, MegakernelConfig(light_strategy="tree")).fused == "off"
    no_tree = t_scene._replace(light_tree=None, tri_emrec=None)
    with pytest.raises(ValueError, match="no light tree"):
        render_sample_batch(no_tree, MegakernelConfig(light_strategy="tree", fused="off"), 4, 4, 0)
    with pytest.raises(ValueError, match="nee_splits"):
        resolve_fused(t_scene, MegakernelConfig(nee_splits=3))


# --- the reference's light-tree tests on the port's API --------------------


def test_pmf_sums_to_one(tree100):
    tree = tree100[1]
    p = torch.tensor([[0.0, 0.0, 0.1], [3.0, -2.0, 0.5], [-4.0, 4.0, 0.0]])
    n = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    total = torch.zeros(3)
    for r in range(tree.n_records):
        total = total + TT.light_tree_pmf(tree, torch.full((3,), r), p, n)
    np.testing.assert_allclose(total.numpy(), 1.0, rtol=1e-4)


def test_descent_matches_trail_pmf(tree100):
    """The descent's selection frequencies over a stratified u grid equal
    the bit-trail pmf; the sampled pmfs equal the walk's."""
    tree = tree100[1]
    m = 4096
    u = (torch.arange(m, dtype=torch.float32) + 0.5) / m
    p = torch.tensor([1.0, 1.0, 0.2]).expand(m, 3)
    nrm = torch.tensor([0.0, 0.0, 1.0]).expand(m, 3)
    rec, pmf = TT.sample_light_tree(tree, p, nrm, u)
    counts = np.bincount(rec.numpy(), minlength=tree.n_records) / m
    for r in np.unique(rec.numpy()):
        analytic = float(TT.light_tree_pmf(tree, torch.tensor([int(r)]), p[:1], nrm[:1])[0])
        assert counts[r] == pytest.approx(analytic, abs=2.5 / m + 0.02 * analytic)
    np.testing.assert_allclose(pmf.numpy(), TT.light_tree_pmf(tree, rec, p, nrm).numpy(),
                               rtol=1e-4)


def test_split_frontier_shapes(tree100):
    tree = tree100[1]
    levels, roots = TT.split_frontier(tree, 4)
    assert levels == 2 and len(roots) == 4
    live = [r for r in roots if r >= 0]
    assert len(live) >= 1
    p = torch.tensor([[0.5, -0.5, 0.3]])
    n = torch.tensor([[0.0, 0.0, 1.0]])
    total = sum(TT.light_tree_pmf(tree, torch.tensor([r]), p, n, split_levels=levels)
                for r in range(tree.n_records))
    np.testing.assert_allclose(total.numpy(), len(live), rtol=1e-4)


def _many_light_scene(n_lights, seed=3, use_tree=None):
    rng = np.random.default_rng(seed)
    hs = THost()
    mat = hs.add_material(dict(kind="lambert", albedo=(0.7, 0.7, 0.7)))
    hs.add_model(generate_plane((0, 0, 0), (0, 0, 1), 12, 12), mat)
    for row in _point_rows(n_lights, rng):
        hs.add_light(TL.point_light(row["color"], row["pos"]))
    hs.camera = TCam(position=(0.0, -6.0, 3.0), direction=(0.0, 1.0, -0.45), width=16, height=16)
    return t_from_host(hs, use_light_tree=use_tree, device="cpu")


def _render_mean(scene, strategy, spp, seed=0, splits=1):
    """Mean of ``spp`` samples (0 … spp−1, the reference's loop), traced as
    one batch."""
    cfg = MegakernelConfig(max_depth=2, remat=False, light_strategy=strategy, seed=seed,
                           nee_splits=splits, features=mat_features_from_table(scene.materials))
    return render_sample_batch(scene, cfg, 16, 16, 0, nspp=spp).numpy().mean(0)


@pytest.fixture(scope="module")
def scene24():
    return _many_light_scene(24, use_tree=True)


def test_tree_unbiased_vs_uniform(scene24):
    assert scene24.light_tree is not None
    a = _render_mean(scene24, "tree", 96)
    b = _render_mean(scene24, "uniform", 96)
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)
    np.testing.assert_allclose(a, b, atol=5.0 * a.mean())


def test_tree_splits_unbiased(scene24):
    a = _render_mean(scene24, "tree", 48, splits=4)
    b = _render_mean(scene24, "tree", 48, splits=1)
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)


def test_tree_lower_variance_than_uniform():
    """At equal spp the tree's error against a converged image is well
    below uniform selection's."""
    scene = _many_light_scene(100, use_tree=True)
    ref = _render_mean(scene, "tree", 256, seed=1, splits=2)
    a = _render_mean(scene, "tree", 8, seed=0)
    b = _render_mean(scene, "uniform", 8, seed=0)
    mse_tree = float(((a - ref) ** 2).mean())
    mse_uni = float(((b - ref) ** 2).mean())
    assert mse_tree < 0.6 * mse_uni, (mse_tree, mse_uni)


def test_scene_autobuild_threshold():
    assert _many_light_scene(4).light_tree is None
    assert _many_light_scene(20).light_tree is not None

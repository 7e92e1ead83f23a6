"""The port's BVH (``ops/bvh.py``, ``native/``) against the JAX reference:
the build and the packed tables bit for bit, the build invariants, and the
numpy traversal oracle and the plain packed sweep against the reference's
traversal kernel run in interpret mode (``bvh_closest_raw`` /
``bvh_any_raw``, as ``tests/test_bvh.py`` runs them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import bvh as JB
from cuda_optix_pathtracing_tpu.ops import bvh_pallas as JP
from cuda_optix_pathtracing_tpu.ops.camera import generate_rays, pixel_centers
from cuda_optix_pathtracing_tpu.scene.procedural import cornell_box_mesh as j_cornell_box_mesh
from cuda_optix_pathtracing_tpu_torch.ops import bvh as TB
from cuda_optix_pathtracing_tpu_torch.ops.bvh_cuda import check_bvh_scene
from cuda_optix_pathtracing_tpu_torch.ops.intersect import intersect_any, intersect_closest_raw
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh

torch.set_num_threads(2)

BIG_T = 3.0e38


def random_soup(t, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    v0 = centers + rng.normal(0, 0.3, (t, 3)).astype(np.float32)
    e0 = rng.normal(0, 0.5, (t, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (t, 3)).astype(np.float32)
    return v0, e0, e1


def random_rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.05, 8.0, n).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("t", [5, 40, 300])
def test_build_and_pack_equal_reference(t):
    v0, e0, e1 = random_soup(t)
    ref = JB.build_bvh(v0, e0, e1)
    ours = TB.build_bvh(v0, e0, e1)
    for name, a, b in zip(TB.BVHArrays._fields, ref, ours):
        assert np.asarray(a).dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    pr, po = JB.pack_bvh(ref), TB.pack_bvh(ours)
    np.testing.assert_array_equal(np.asarray(pr.box), po.box.numpy())
    np.testing.assert_array_equal(np.asarray(pr.meta), po.meta.numpy())
    np.testing.assert_array_equal(pr.perm, po.perm)
    assert po.box.dtype == torch.float32 and po.meta.dtype == torch.int32
    assert po.depth == TB.tree_depth(np.asarray(pr.meta)) >= 1


@pytest.mark.parametrize("t", [5, 40, 300])
def test_build_invariants(t):
    v0, e0, e1 = random_soup(t)
    bvh = TB.build_bvh(v0, e0, e1)
    assert TB.bvh_stats(bvh)["max_leaf"] <= TB.LEAF_SIZE
    assert (np.sort(bvh.tri_order) == np.arange(t)).all(), "every triangle in one leaf"
    p1, p2 = v0 + e0, v0 + e1
    lc, ls = bvh.child_leaf_count, bvh.child_leaf_start
    for ni in range(bvh.num_nodes):
        for ci in range(TB.BRANCHING):
            if lc[ni, ci] <= 0:
                continue
            ids = bvh.tri_order[ls[ni, ci]: ls[ni, ci] + lc[ni, ci]]
            pts = np.concatenate([v0[ids], p1[ids], p2[ids]])
            assert (pts >= bvh.child_lo[ni, ci] - 1e-4).all()
            assert (pts <= bvh.child_hi[ni, ci] + 1e-4).all()


def _soup_case(t, n):
    v0, e0, e1 = random_soup(t)
    packed = TB.pack_bvh(TB.build_bvh(v0, e0, e1))
    tris = tuple(TB.permute_tri_array(a, packed.perm) for a in (v0, e0, e1))
    o, d, t_max = random_rays(n)
    return packed.box.numpy(), packed.meta.numpy(), tris, o, d, t_max


def _mesh_case():
    """Camera rays of the mesh Cornell box (subdivision 16, 24²) and
    random rays from inside the box, on the reference's own scene."""
    s = j_cornell_box_mesh(24, 24, subdiv=16, use_bvh=True)
    pix = pixel_centers(24, 24) + 0.5
    o, d = generate_rays(pix, s.cam_from_raster, s.world_from_cam)
    tris = tuple(np.asarray(a) for a in (s.tri_v0, s.tri_e0, s.tri_e1))
    rng = np.random.default_rng(2)
    ro = rng.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (512, 3)).astype(np.float32)
    rd = rng.normal(size=(512, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o), ro])
    d = np.concatenate([np.asarray(d), rd])
    t_max = rng.uniform(0.5, 6.0, o.shape[0]).astype(np.float32)
    return np.asarray(s.bvh.box), np.asarray(s.bvh.meta), tris, o, d, t_max


@pytest.fixture(scope="module", params=["soup40", "soup500", "mesh16"])
def traversal_case(request):
    """(tables, rays, JAX interpret-mode (t, row) and occlusion flags)."""
    if request.param == "mesh16":
        box, meta, tris, o, d, t_max = _mesh_case()
    else:
        t, n = {"soup40": (40, 1024), "soup500": (500, 2048)}[request.param]
        box, meta, tris, o, d, t_max = _soup_case(t, n)
    rows = JP.tri_rows_pack(*(jnp.asarray(a) for a in tris))
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(box), jnp.asarray(meta), rows)
    t_j, i_j = JP.bvh_closest_raw(*args, interpret=True)
    occ_j = JP.bvh_any_raw(*args, jnp.asarray(t_max), interpret=True)
    ref = (np.asarray(t_j), np.asarray(i_j), np.asarray(occ_j) > 0)
    return box, meta, tris, o, d, t_max, ref


def _closest_agrees(t, i, t_ref, i_ref):
    hit = t_ref < BIG_T
    np.testing.assert_array_equal(t < BIG_T, hit)
    rel = np.abs(t - t_ref) / np.abs(t_ref)
    assert (rel[hit] <= 1e-5).all(), rel[hit].max()
    # rows agree except on ties: two t within 1e-6 relative
    assert ((i == i_ref) | (rel <= 1e-6)).all()


def test_oracle_matches_reference_kernel(traversal_case):
    box, meta, tris, o, d, t_max, (t_j, i_j, occ_j) = traversal_case
    t, i, counts = TB.traverse_packed_ref(box, meta, *tris, o, d)
    _closest_agrees(t, i, t_j, i_j)
    assert (counts["pops"] >= 1).all() and (counts["slabs"] >= counts["pops"]).all()
    assert (counts["tests"] % TB.LEAF_SIZE == 0).all()
    occ, _ = TB.traverse_packed_ref(box, meta, *tris, o, d, "any", t_max)
    np.testing.assert_array_equal(occ, occ_j)


def test_plain_sweep_matches_reference_kernel(traversal_case):
    box, meta, tris, o, d, t_max, (t_j, i_j, occ_j) = traversal_case
    tt = [torch.from_numpy(np.array(a)) for a in (o, d, *tris)]
    t, i = intersect_closest_raw(*tt)
    _closest_agrees(t.numpy(), i.numpy(), t_j, i_j)
    occ = intersect_any(*tt, torch.from_numpy(t_max))
    np.testing.assert_array_equal(occ.numpy(), occ_j)


def test_kernel_refuses_trees_deeper_than_its_stack():
    scene = cornell_box_mesh(8, 8, subdiv=8, use_bvh=True, device="cpu")
    o = torch.zeros((4, 3))
    check_bvh_scene(scene, o, o)
    deep = scene._replace(bvh=scene.bvh._replace(depth=TB.COMPACT_STACK + 2))
    with pytest.raises(ValueError, match="entries of the kernels' compact stack"):
        check_bvh_scene(deep, o, o)


def test_both_stacks_allow_depth_nine():
    """The kernels' compact stack (one entry a level) refuses the trees
    that the oracle's stack of children (7 entries a level) refuses:
    deeper than 9."""
    assert TB.stack_fits(9) and not TB.stack_fits(10)
    assert 7 * 10 + 1 > TB.STACK_SIZE and 10 - 1 > TB.COMPACT_STACK


@pytest.mark.parametrize("table", ["nodes", "tri_rows", "tri_mat"])
def test_kernel_refuses_non_contiguous_compact_tables(table):
    """One check guards both kernel families, which walk the same compact
    tables: the traversal kernels and the fused BVH kernels."""
    scene = cornell_box_mesh(8, 8, subdiv=8, use_bvh=True, device="cpu")
    o = torch.zeros((4, 3))
    if table == "nodes":
        nodes = scene.bvh.nodes.t().contiguous().t()
        bad = scene._replace(bvh=scene.bvh._replace(nodes=nodes))
    elif table == "tri_rows":
        bad = scene._replace(tri_rows=scene.tri_rows.t().contiguous().t())
    else:
        bad = scene._replace(tri_mat=torch.stack([scene.tri_mat] * 2, 1)[:, 0])
    assert not getattr(bad.bvh if table == "nodes" else bad, table).is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        check_bvh_scene(bad, o, o)


def test_kernel_refuses_trees_of_2_24_nodes():
    """A stack entry holds a node index in 24 bits: 2^24 nodes are
    refused (a stride-0 view stands in for the 4 GiB table)."""
    scene = cornell_box_mesh(8, 8, subdiv=8, use_bvh=True, device="cpu")
    o = torch.zeros((4, 3))
    for m, ok in (((1 << 24) - 1, True), (1 << 24, False)):
        nodes = scene.bvh.nodes[:1].expand(m, TB.NODE_WORDS)
        big = scene._replace(bvh=scene.bvh._replace(nodes=nodes))
        with pytest.raises(ValueError, match="contiguous" if ok else "2\\^24"):
            check_bvh_scene(big, o, o)


@pytest.fixture(scope="module")
def mesh8():
    return cornell_box_mesh(8, 8, subdiv=8, use_bvh=True, device="cpu")


def test_parked_dead_rays_miss_in_oracle_and_sweep(mesh8):
    """The wavefront parks dead rays before a BVH query: they sort last
    and both the traversal (its oracle) and the plain sweep miss them, so
    kernel and sweep agree on every row of a main-path launch."""
    from cuda_optix_pathtracing_tpu_torch.ops.query import _park_dead, _sort_key

    o, d, t_max = (torch.from_numpy(a) for a in random_rays(256, seed=5, spread=1.5))
    alive = torch.from_numpy(np.random.default_rng(6).random(256) < 0.5)
    po, pd = _park_dead(o, d, alive)
    tris = (mesh8.tri_v0, mesh8.tri_e0, mesh8.tri_e1)
    dead = ~alive
    assert bool((_sort_key(mesh8, po, pd, alive)[dead] == 0xFFFFFFFF).all())
    t, i = intersect_closest_raw(po, pd, *tris)
    tr, ir, counts = TB.traverse_packed_ref(mesh8.bvh.box, mesh8.bvh.meta, *tris, po, pd)
    assert bool((t[dead] >= BIG_T).all()) and (tr[dead.numpy()] >= BIG_T).all()
    assert bool((i[dead] == 0).all()) and (ir[dead.numpy()] == 0).all()
    assert (counts["tests"][dead.numpy()] == 0).all()
    assert not bool(intersect_any(po, pd, *tris, t_max)[dead].any())


def test_scene_bounds_built_once_per_scene(mesh8):
    from cuda_optix_pathtracing_tpu_torch.ops.raysort import scene_bounds
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    lo, hi = scene_bounds(mesh8.tri_v0, mesh8.tri_e0, mesh8.tri_e1)
    np.testing.assert_array_equal(mesh8.bounds.numpy(), torch.stack([lo, hi]).numpy())
    assert cornell_box(8, 8, device="cpu").bounds is None


def test_native_library_is_keyed_by_host_cpu(monkeypatch):
    from cuda_optix_pathtracing_tpu_torch import native

    here = native.lib_path()
    monkeypatch.setattr(native, "cpu_fingerprint", lambda: "another CPU")
    assert native.lib_path() != here
    assert native.lib_path().parent == here.parent


# ---- the fused kernels' compact tables -------------------------------------


def _compact_case(name):
    """(PackedBVH, triangle arrays, compact nodes and rows, rays) of a
    random soup or the port's mesh Cornell box (subdivision 16)."""
    if name == "mesh16":
        scene = cornell_box_mesh(24, 24, subdiv=16, use_bvh=True, device="cpu")
        packed, tris = scene.bvh, (scene.tri_v0, scene.tri_e0, scene.tri_e1)
        rng = np.random.default_rng(2)
        o = rng.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (600, 3)).astype(np.float32)
        d = rng.normal(size=(600, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_max = rng.uniform(0.5, 6.0, 600).astype(np.float32)
        return packed, tris, scene.bvh.nodes, scene.tri_rows, (o, d, t_max)
    t, n = {"soup5": (5, 200), "soup40": (40, 500), "soup300": (300, 600)}[name]
    v0, e0, e1 = random_soup(t)
    packed = TB.pack_bvh(TB.build_bvh(v0, e0, e1))
    tris = tuple(torch.from_numpy(TB.permute_tri_array(a, packed.perm)) for a in (v0, e0, e1))
    return packed, tris, packed.nodes, TB.pack_tri_rows(*tris), random_rays(n)


@pytest.mark.parametrize("name", ["soup5", "soup40", "soup300", "mesh16"])
def test_compact_nodes_round_trip(name):
    """Every child's slabs, slot word and permcode of PackedBVH come back
    from the compact table; a leaf's row count ends at its last real row."""
    packed, _, nodes, _, _ = _compact_case(name)
    assert nodes.shape == (packed.num_nodes, TB.NODE_WORDS) and nodes.dtype == torch.float32
    box, meta = packed.box.numpy(), packed.meta.numpy().reshape(-1, 16)
    words = nodes.view(torch.int32).numpy()
    np.testing.assert_array_equal(nodes.numpy()[:, :48], box[:, :48])
    assert not box[:, 48:].any()  # what the compact node drops is padding
    np.testing.assert_array_equal(words[:, 56:], meta[:, 8:])
    slots = words[:, 48:56]
    np.testing.assert_array_equal(slots & ~0x3C, meta[:, :8])
    leaf = (meta[:, :8] & 63) == TB.CODE_LEAF
    assert not (slots[~leaf] & 0x3C).any()
    real = packed.perm >= 0
    for w in slots[leaf]:
        block = real[(w >> 6) * 8:(w >> 6) * 8 + TB.LEAF_SIZE]
        assert ((w >> 2) & 15) + 1 == np.nonzero(block)[0].max() + 1
    assert real.sum() < real.size  # the leaves have pad rows to skip


@pytest.mark.parametrize("name", ["soup40", "soup300", "mesh16"])
def test_compact_walk_matches_packed_oracle(name):
    """The numpy walk over the compact layout (the fused kernels'
    traversal) gives traverse_packed_ref's t and rows bit for bit, and its
    occlusion flags."""
    packed, tris, nodes, rows, (o, d, t_max) = _compact_case(name)
    t, i, _ = TB.traverse_compact_ref(nodes, rows, o, d)
    tr, ir, _ = TB.traverse_packed_ref(packed.box, packed.meta, *tris, o, d)
    assert (tr < BIG_T).sum() > 0
    np.testing.assert_array_equal(t, tr)
    np.testing.assert_array_equal(i, ir)
    occ, _ = TB.traverse_compact_ref(nodes, rows, o, d, "any", t_max)
    occ_r, _ = TB.traverse_packed_ref(packed.box, packed.meta, *tris, o, d, "any", t_max)
    assert 0 < occ_r.sum() < occ_r.size
    np.testing.assert_array_equal(occ, occ_r)


@pytest.mark.parametrize("name", ["soup40", "soup300", "mesh16"])
def test_compact_walk_counts_the_tests_a_traversal_needs(name):
    """The compact walk's counts (internal nodes expanded, rows tested up
    to each leaf's last real row) equal traverse_packed_ref's given perm,
    which counts no pad row: the same nodes as the packed walk, fewer
    tests than its LEAF_SIZE a leaf."""
    packed, tris, nodes, rows, (o, d, t_max) = _compact_case(name)
    for mode, tm in (("closest", None), ("any", t_max)):
        *_, c = TB.traverse_compact_ref(nodes, rows, o, d, mode, tm)
        *_, c_real = TB.traverse_packed_ref(packed.box, packed.meta, *tris, o, d, mode, tm,
                                            perm=packed.perm)
        *_, c_all = TB.traverse_packed_ref(packed.box, packed.meta, *tris, o, d, mode, tm)
        np.testing.assert_array_equal(c["pops"], c_real["pops"])
        np.testing.assert_array_equal(c["tests"], c_real["tests"])
        np.testing.assert_array_equal(c_real["pops"], c_all["pops"])
        assert (c_real["tests"] <= c_all["tests"]).all()
        assert c_real["tests"].sum() < c_all["tests"].sum(), mode


def test_compact_tables_built_once_per_scene(mesh8):
    """A BVH scene carries its compact nodes and (Tp, 12) rows, which equal
    pack_nodes's and tri_v0 / e0 / e1 with zero padding."""
    nodes = TB.pack_nodes(mesh8.bvh.box, mesh8.bvh.meta, mesh8.bvh.perm)
    np.testing.assert_array_equal(mesh8.bvh.nodes.numpy(), nodes.numpy())
    rows = mesh8.tri_rows
    assert rows.shape == (mesh8.num_triangles, TB.ROW_WORDS) and rows.is_contiguous()
    for c, a in ((0, mesh8.tri_v0), (4, mesh8.tri_e0), (8, mesh8.tri_e1)):
        np.testing.assert_array_equal(rows[:, c:c + 3].numpy(), a.numpy())
    assert not rows[:, 3::4].any()

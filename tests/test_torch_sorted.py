"""The port's depth-sorted fused wavefront (``trace_paths_fused_sorted``)
on the CPU, where every bounce is the plain ``bounce_step``: bit for bit
the port's ``trace_paths`` on the same rays (each step is per ray and the
sort only permutes), and against the JAX reference's
``trace_paths_fused_sorted`` in interpret mode to the parity bar, with
the hash and the Halton samplers, on the mesh Cornell box at 16²,
subdivision 8, depth 3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.megakernel_pallas import (
    trace_paths_fused_sorted as j_sorted,
)
from cuda_optix_pathtracing_tpu.ops import rng as JR
from cuda_optix_pathtracing_tpu.ops.camera import generate_rays
from cuda_optix_pathtracing_tpu.ops.morton import morton_pixel_order
from cuda_optix_pathtracing_tpu.scene.procedural import cornell_box_mesh as j_cornell_box_mesh
from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, trace_paths
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, scene_from_arrays
from test_torch_bridge import flatten_scene

torch.set_num_threads(2)

W = H = 16
DEPTH = 3


@pytest.fixture(scope="module")
def scenes():
    j_scene = j_cornell_box_mesh(W, H, subdiv=8, use_bvh=True)
    t_scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    assert t_scene.bvh is not None
    return j_scene, t_scene


def _camera(j_scene, sampler, spp=1):
    """Camera rays of samples 0..spp-1 in Morton pixel order, made by the
    reference, as numpy arrays."""
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.float32)
    pix = np.tile(pix[morton_pixel_order(W, H)], (spp, 1))
    sample = np.repeat(np.arange(spp, dtype=np.uint32), W * H)
    px, py = (jnp.asarray(pix[:, i].astype(np.uint32)) for i in range(2))
    u1, u2 = JR.Sampler(sampler, 0).sample_2d(px, py, jnp.asarray(sample), JR.Dim.CAMERA_U)
    o, d = generate_rays(
        jnp.asarray(pix) + jnp.stack([u1, u2], -1), j_scene.cam_from_raster, j_scene.world_from_cam
    )
    return np.array(px), np.array(py), sample, np.array(o), np.array(d)


def _t(px, py, sample, o, d):
    i64 = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return i64(px), i64(py), i64(sample), torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("sampler", ["hash", "halton"])
def test_sorted_equals_trace_paths_bit_for_bit(scenes, sampler):
    _, t_scene = scenes
    px, py, sample, o, d = _t(*_camera(scenes[0], sampler, spp=2))
    before = MKC.bounce_fused.launches
    ours = MKC.trace_paths_fused_sorted(t_scene, px, py, sample, o, d, max_depth=DEPTH,
                                        seed=5, sampler=sampler)
    plain = trace_paths(t_scene, MegakernelConfig(max_depth=DEPTH, seed=5, sampler=sampler),
                        px, py, sample, o, d, device="cpu")
    assert MKC.bounce_fused.launches == before  # CPU: the plain bounce, no kernel
    assert ours.shape == (2 * W * H, 3) and float(ours.mean()) > 0.0
    np.testing.assert_array_equal(ours.numpy(), plain.numpy())


@pytest.mark.parametrize("sampler", ["hash", "halton"])
def test_sorted_matches_reference(scenes, sampler):
    j_scene, t_scene = scenes
    px, py, sample, o, d = _camera(j_scene, sampler)
    ref = np.asarray(j_sorted(j_scene, jnp.asarray(px), jnp.asarray(py), jnp.uint32(0),
                              jnp.asarray(o), jnp.asarray(d), max_depth=DEPTH,
                              interpret=True, sampler=sampler))
    ours = MKC.trace_paths_fused_sorted(t_scene, *_t(px, py, sample, o, d), max_depth=DEPTH,
                                        sampler=sampler).numpy()
    diff = np.abs(ref - ours)
    assert np.isfinite(ours).all()
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


def test_bounce_keeps_dead_paths_and_sorts_them_last(scenes):
    """One plain bounce leaves a dead path's row as it was and gives it the
    dead key; every key is ``path_keys``'s; the sort of the keys runs the
    dead paths last; the rows stay in slot order."""
    _, t_scene = scenes
    st = MKC.pack_path_state(*_t(*_camera(scenes[0], "hash")))
    for depth in range(3):  # roulette from depth 2 ends paths
        keys = MKC.bounce_fused(t_scene, st, depth)
    dead = st.view(torch.int32)[:, MKC.ALIVE] == 0
    assert 0 < int(dead.sum()) < st.shape[0]
    before = st.clone()
    keys = MKC.bounce_fused(t_scene, st, 3, perm=MKC.sort_paths(keys))
    np.testing.assert_array_equal(st[dead].numpy(), before[dead].numpy())
    np.testing.assert_array_equal(keys.numpy(), MKC.path_keys(t_scene, st).numpy())
    alive = st.view(torch.int32)[:, MKC.ALIVE] != 0
    assert keys.dtype == torch.int32
    assert bool((keys[~alive] == 0x7FFFFFFF).all()) and bool((keys[alive] < 0x7FFFFFFF).all())
    perm = MKC.sort_paths(keys)
    assert perm.dtype == torch.int64
    assert not bool(alive[perm][int(alive.sum()):].any())
    np.testing.assert_array_equal(st.view(torch.int32)[:, MKC.SLOT].numpy(), np.arange(st.shape[0]))


def test_path_state_round_trips():
    """pack_path_state → unpack_path_state gives back the rays, the keys
    (full u32 range) and init_path_state's values, in (N, 24) rows of 96 B
    with zero padding; a state written into the rows unpacks unchanged."""
    rs = np.random.default_rng(4)
    n = 37
    o = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    d = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    px, py, sample = (torch.from_numpy(rs.integers(0, 2**32, n, dtype=np.int64)) for _ in range(3))
    st = MKC.pack_path_state(px, py, sample, o, d)
    assert st.shape == (n, MKC.STATE_WORDS) and st.dtype == torch.float32 and st.is_contiguous()
    assert 4 * MKC.STATE_WORDS == 96 and MKC.FIELDS <= MKC.STATE_WORDS
    assert not st[:, MKC.FIELDS:].any()
    state, kpx, kpy, ks = MKC.unpack_path_state(st)
    for a, b in ((state.o, o), (state.d, d), (kpx, px), (kpy, py), (ks, sample)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert bool((state.beta == 1).all()) and not bool(state.radiance.any())
    assert bool(state.alive.all()) and not bool(state.inside.any()) and bool(state.prev_delta.all())
    assert bool((state.eta_scale == 1).all()) and not bool(state.prev_pdf.any())
    np.testing.assert_array_equal(st.view(torch.int32)[:, MKC.SLOT].numpy(), np.arange(n))
    si = st.view(torch.int32)
    vals = torch.from_numpy(rs.normal(size=(n, 12)).astype(np.float32))
    st[:, :12] = vals
    st[:, MKC.ETA_SCALE] = vals[:, 0]
    st[:, MKC.PREV_PDF] = vals[:, 1]
    flags = torch.from_numpy(rs.integers(0, 2, (n, 3)).astype(np.int32))
    si[:, MKC.ALIVE], si[:, MKC.INSIDE], si[:, MKC.PREV_DELTA] = flags.T
    state, *_ = MKC.unpack_path_state(st)
    for a, c in ((state.o, 0), (state.d, 3), (state.beta, 6), (state.radiance, 9)):
        np.testing.assert_array_equal(a.numpy(), vals[:, c:c + 3].numpy())
    np.testing.assert_array_equal(state.eta_scale.numpy(), vals[:, 0].numpy())
    np.testing.assert_array_equal(state.prev_pdf.numpy(), vals[:, 1].numpy())
    for a, f in ((state.alive, 0), (state.inside, 1), (state.prev_delta, 2)):
        np.testing.assert_array_equal(a.numpy(), flags[:, f].numpy() != 0)


def test_sorted_refuses_a_scene_without_bvh():
    scene = cornell_box(W, H, device="cpu")
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="BVH"):
        MKC.trace_paths_fused_sorted(scene, k, k, 0, o, d)
    with pytest.raises(ValueError, match="BVH"):
        MKC.bounce_fused(scene, MKC.pack_path_state(k, k, 0, o, d), 0)

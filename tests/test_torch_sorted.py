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
from cuda_optix_pathtracing_tpu_torch.utils import trace
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
    before = trace.snapshot()["launches.bounce_fused"]
    ours = MKC.trace_paths_fused_sorted(t_scene, px, py, sample, o, d, max_depth=DEPTH,
                                        seed=5, sampler=sampler)
    plain = trace_paths(t_scene, MegakernelConfig(max_depth=DEPTH, seed=5, sampler=sampler),
                        px, py, sample, o, d, device="cpu")
    assert trace.snapshot()["launches.bounce_fused"] == before  # CPU: the plain bounce, no kernel
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


# keys over the whole int64 range: the kernels read the low 32 bits
KEYS = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -1, -2**31, -2**63, 2**63 - 1]


def _words(values):
    """The u32 values (low 32 bits) of int keys, as int32 bit patterns."""
    return [((v & 0xFFFFFFFF) ^ 2**31) - 2**31 for v in values]


def _key_inputs(kind):
    """(px, py, sample, keys handed over in place, copies) of one input kind;
    sample's values are the reverse of px's, py's are px's."""
    k64 = torch.tensor(KEYS, dtype=torch.int64)
    rev = k64.flip(0).contiguous()
    if kind == "int64":
        return k64, k64.clone(), rev, (True, True, True), 0
    if kind == "int":  # a Python int sample (one sample a pixel): sample0
        return k64, k64.clone(), 2**40 - 1, (True, True, None), 0
    if kind == "negative int":
        return k64, k64.clone(), -2**31 - 1, (True, True, None), 0
    if kind == "int32":
        w = lambda x: torch.tensor(_words(x.tolist()), dtype=torch.int32)  # noqa: E731
        return w(k64), w(k64), w(rev), (False, False, False), 3
    if kind == "0-d":
        return k64, k64.clone(), torch.tensor(2**32 - 1), (True, True, False), 1
    if kind == "broadcast":
        return k64, k64.clone(), torch.tensor(-5).expand(len(KEYS)), (True, True, False), 1
    if kind == "strided":
        both = torch.stack([k64, rev], 1).reshape(-1)
        return both[0::2], both[0::2].clone(), both[1::2], (False, True, False), 2
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind", ["int64", "int", "negative int", "int32", "0-d", "broadcast", "strided"]
)
def test_fused_keys_route_and_values(kind):
    """fused_keys hands a contiguous (n,) int64 key on the device over in
    place and a Python int sample as sample0, and copies any other key,
    counted in fused.key_copies; either way the kernels' low 32 bits of each
    key, and pack_path_state's key columns, hold the u32 values."""
    px, py, sample, in_place, copies = _key_inputs(kind)
    n, dev = len(KEYS), torch.device("cpu")
    before = trace.snapshot()["fused.key_copies"]
    got = MKC.fused_keys(px, py, sample, n, dev)
    assert trace.snapshot()["fused.key_copies"] == before + copies
    if isinstance(sample, int):
        want_s = _words([sample]) * n
        assert got[2] is None and got[3] == sample & 0xFFFFFFFF
    else:
        want_s = _words(torch.as_tensor(sample).expand(n).tolist())
        assert got[3] == 0
    wants = (_words(KEYS), _words(KEYS), want_s)
    for x, k, same in zip((px, py, sample), got[:3], in_place):
        assert (k is x) == bool(same)
        if k is not None:
            assert k.dtype == torch.int64 and k.shape == (n,) and k.is_contiguous()
    words = [MKC._low_words(k).tolist() for k in got[:2]]
    words.append(_words([got[3]]) * n if got[2] is None else MKC._low_words(got[2]).tolist())
    assert words == list(wants)
    st = MKC.pack_path_state(px, py, sample, torch.zeros((n, 3)), torch.ones((n, 3)))
    si = st.view(torch.int32)
    assert [si[:, c].tolist() for c in (MKC.PX, MKC.PY, MKC.SAMPLE)] == list(wants)


def test_fused_keys_copy_keys_on_another_device():
    """Keys on another device than the rays' are copied to it, each counted."""
    k = torch.arange(4, dtype=torch.int64)
    before = trace.snapshot()["fused.key_copies"]
    got = MKC.fused_keys(k, k, k, 4, torch.device("meta"))
    assert trace.snapshot()["fused.key_copies"] == before + 3
    assert all(x.device.type == "meta" and x.shape == (4,) for x in got[:3])


def test_sorted_refuses_a_scene_without_bvh():
    scene = cornell_box(W, H, device="cpu")
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="BVH"):
        MKC.trace_paths_fused_sorted(scene, k, k, 0, o, d)
    with pytest.raises(ValueError, match="BVH"):
        MKC.bounce_fused(scene, MKC.pack_path_state(k, k, 0, o, d), 0)

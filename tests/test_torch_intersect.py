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
    big = torch.zeros((TC.MAX_TRIS + 1, 3))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="BVH"):
        TC._check_rays(o, o, TC.tri_table(big, big, big))

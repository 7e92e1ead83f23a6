"""The port's wavefront integrators (``models/wavefront.py``) on the CPU:
the reference's three wavefront tests (``tests/test_wavefront.py``) on the
port; the port's dense and pool films against JAX's
``render_sample_batch_wavefront`` and ``render_pool_wavefront`` (XLA
integrator) at the parity bar, on the Cornell box and, dense, on the BVH
mesh box; and ``bounce_step`` with a per-lane depth tensor equal, lane by
lane, to its scalar-depth calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.wavefront import WavefrontConfig as JWCfg
from cuda_optix_pathtracing_tpu.models.wavefront import render_pool_wavefront as j_pool
from cuda_optix_pathtracing_tpu.models.wavefront import render_sample_batch_wavefront as j_dense
from cuda_optix_pathtracing_tpu.ops.bsdf import mat_features_from_table as j_features
from cuda_optix_pathtracing_tpu.scene import cornell_box as j_cornell_box
from cuda_optix_pathtracing_tpu.scene.procedural import cornell_box_mesh as j_cornell_box_mesh
from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.models.megakernel import (
    MegakernelConfig,
    render,
    render_sample_batch,
)
from cuda_optix_pathtracing_tpu_torch.models.wavefront import (
    WavefrontConfig,
    render_pool_wavefront,
    render_sample_batch_wavefront,
    render_wavefront,
)
from cuda_optix_pathtracing_tpu_torch.ops import rng as R
from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, scene_from_arrays
from test_torch_bridge import flatten_scene

torch.set_num_threads(2)

W = 32
DEPTH = 4
POOL = 512


def _parity(a, b):
    diff = np.abs(a - b)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


# ---- the reference's wavefront tests, on the port ---------------------------


def test_wavefront_matches_megakernel():
    """Same estimator, same RNG keys → the same image: bit for bit here
    (the reference holds it to rtol 1e-5, atol 1e-6), one batch and a
    progressive render."""
    scene = cornell_box(W, W, device="cpu")
    kw = dict(max_depth=DEPTH, remat=False, pixel_order="linear")
    a = render_sample_batch(scene, MegakernelConfig(fused="off", **kw), W, W, 0)
    b = render_sample_batch_wavefront(scene, WavefrontConfig(**kw), W, W, 0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(a, b)
    fa = render(scene, W, W, 3, cfg=MegakernelConfig(fused="off", **kw), kspp=2, device="cpu")
    fb = render_wavefront(scene, W, W, 3, cfg=WavefrontConfig(**kw), kspp=2, device="cpu")
    assert torch.equal(fa.mean, fb.mean) and torch.equal(fa.m2, fb.m2)
    assert float(fb.n) == 3


def test_wavefront_rejects_halton():
    scene = cornell_box(8, 8, device="cpu")
    cfg = WavefrontConfig(max_depth=2, sampler="halton", remat=False)
    with pytest.raises(ValueError, match="hash sampler"):
        render_sample_batch_wavefront(scene, cfg, 8, 8, 0)
    with pytest.raises(ValueError, match="hash sampler"):
        render_pool_wavefront(scene, 8, 8, 1, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="box pixel filter"):
        render_pool_wavefront(scene, 8, 8, 1, cfg=WavefrontConfig(pixel_filter="mitchell"),
                              device="cpu")


def test_pool_wavefront_matches_megakernel():
    """The regenerating pool (512 lanes: many refill generations) against
    the dense render: the same keys per (pixel, sample), only the order of
    floating-point sums differs."""
    spp = 4
    scene = cornell_box(W, W, device="cpu")
    ft = mat_features_from_table(scene.materials)
    f1 = render(scene, W, W, spp, cfg=MegakernelConfig(max_depth=DEPTH, remat=False, features=ft),
                kspp=spp, device="cpu")
    f2 = render_pool_wavefront(scene, W, W, spp,
                               cfg=WavefrontConfig(max_depth=DEPTH, remat=False, features=ft),
                               pool=POOL, device="cpu")
    np.testing.assert_allclose(f1.mean.numpy(), f2.mean.numpy(), atol=3e-5)
    np.testing.assert_allclose(f1.m2.numpy(), f2.m2.numpy(), atol=3e-4)
    assert float(f2.n) == spp


# ---- against the reference -----------------------------------------------


@pytest.fixture(scope="module")
def j_scene():
    return j_cornell_box(W, W)


def test_dense_matches_reference(j_scene):
    t_scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    jcfg = JWCfg(max_depth=DEPTH, remat=False, backend="xla")
    ref = jax.jit(lambda: j_dense(j_scene, jcfg, W, W, jnp.uint32(1)))()
    got = render_sample_batch_wavefront(t_scene, WavefrontConfig(max_depth=DEPTH), W, W, 1)
    _parity(got.numpy(), np.asarray(ref))


def test_pool_matches_reference(j_scene):
    spp = 2
    t_scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    jcfg = JWCfg(max_depth=DEPTH, remat=False, backend="xla",
                 features=j_features(j_scene.materials))
    ref = j_pool(j_scene, W, W, spp, cfg=jcfg, pool=POOL)
    got = render_pool_wavefront(t_scene, W, W, spp, cfg=WavefrontConfig(max_depth=DEPTH),
                                pool=POOL, device="cpu")
    _parity(got.mean.numpy(), np.asarray(ref.mean))
    _parity(got.m2.numpy(), np.asarray(ref.m2))
    assert float(got.n) == float(ref.n) == spp


def test_dense_mesh_matches_reference():
    """The BVH mesh box (subdivision 8): the dense wavefront against JAX's
    and, bit for bit, against the port's ``trace_paths`` route in the same
    (Morton) pixel order."""
    w = 16
    j_mesh = j_cornell_box_mesh(w, w, subdiv=8, use_bvh=True)
    t_mesh = scene_from_arrays(flatten_scene(j_mesh), "cpu")
    assert t_mesh.bvh is not None
    jcfg = JWCfg(max_depth=3, remat=False, backend="xla")
    ref = jax.jit(lambda: j_dense(j_mesh, jcfg, w, w, jnp.uint32(0)))()
    got = render_sample_batch_wavefront(t_mesh, WavefrontConfig(max_depth=3), w, w, 0)
    _parity(got.numpy(), np.asarray(ref))
    plain = render_sample_batch(t_mesh, MegakernelConfig(max_depth=3, fused="off"), w, w, 0)
    assert torch.equal(got, plain)


# ---- per-lane depth --------------------------------------------------------


def test_bounce_step_depth_tensor_matches_scalar():
    """``bounce_step`` with an (N,) int64 depth (the pool's lanes) equals,
    lane by lane, its call with each lane's depth as an int: every field
    of the path state, on paths already two bounces deep."""
    w = 16
    scene = cornell_box(w, w, device="cpu")
    cfg = MegakernelConfig(max_depth=5, rr_start_depth=1, fused="off")
    px, py, sample, o, d, _, _ = MK.camera_batch(scene, cfg, w, w, 3)
    sampler = R.Sampler("hash", cfg.seed)
    state = MK.camera_path_state(scene, cfg, o, d)
    for depth in range(2):
        state = MK.bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
    lanes = torch.as_tensor(np.random.default_rng(0).integers(0, 5, o.shape[0]))
    mixed = MK.bounce_step(scene, cfg, sampler, px, py, sample, lanes, state)
    for depth in range(5):
        ref = MK.bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
        sel = lanes == depth
        assert sel.any()
        for name, a, b in zip(MK.PathState._fields, mixed, ref):
            if a is None:
                assert b is None, name
                continue
            assert torch.equal(a[sel], b[sel]), (depth, name)

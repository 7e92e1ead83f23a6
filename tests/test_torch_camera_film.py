"""Ray generation and film accumulation of the port against the JAX
reference on the CPU (≤ 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import camera as jcam
from cuda_optix_pathtracing_tpu.ops import film as jfilm
from cuda_optix_pathtracing_tpu_torch.ops import camera as tcam
from cuda_optix_pathtracing_tpu_torch.ops import film as tfilm

torch.set_num_threads(2)

TOL = 1e-6


@pytest.mark.parametrize("res", [(32, 32), (24, 16)])
def test_generate_rays_runtime_scene(res):
    """Matrices passed as runtime arguments (not folded constants): the
    form in which the reference once quantized rays to bf16."""
    w, h = res
    rs = np.random.default_rng(5)
    cam_from_raster = jcam.camera_from_raster(20.0, 36.0, w, h)
    world_from_cam = jcam.world_from_camera((0.2, 1.0, 0.1), (0.3, -0.5, 0.2))
    pix = np.asarray(jcam.pixel_centers(w, h))
    p_film = (pix + rs.uniform(0, 1, pix.shape)).astype(np.float32)
    o_j, d_j = jax.jit(jcam.generate_rays)(
        jnp.asarray(p_film), jnp.asarray(cam_from_raster), jnp.asarray(world_from_cam)
    )
    o_t, d_t = tcam.generate_rays(
        torch.from_numpy(p_film),
        torch.from_numpy(np.array(cam_from_raster)),
        torch.from_numpy(np.array(world_from_cam)),
    )
    assert np.abs(np.asarray(o_j) - o_t.numpy()).max() <= TOL
    assert np.abs(np.asarray(d_j) - d_t.numpy()).max() <= TOL
    np.testing.assert_array_equal(tcam.pixel_centers(w, h).numpy(), pix)


@pytest.fixture(scope="module")
def batches():
    rs = np.random.default_rng(9)
    return [rs.gamma(0.5, 1.0, size=(3, 8, 6, 3)).astype(np.float32) for _ in range(3)]


def _close(jf, tf):
    for a, b in zip(jf, tf):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL * max(1.0, np.abs(np.asarray(a)).max())


def test_welford_samples(batches):
    jf, tf = jfilm.film_new(8, 6), tfilm.film_new(8, 6)
    for b in batches:
        for s in b:
            jf = jfilm.film_add_sample(jf, jnp.asarray(s))
            tf = tfilm.film_add_sample(tf, torch.from_numpy(s))
    _close(jf, tf)
    assert float(tf.n) == 9.0
    assert np.abs(np.asarray(jfilm.film_sqrt_mse(jf)) - tfilm.film_sqrt_mse(tf).numpy()).max() <= TOL


def test_chan_batches_and_merge(batches):
    jf, tf = jfilm.film_new(8, 6), tfilm.film_new(8, 6)
    for b in batches:
        jf = jfilm.film_add_batch(jf, jnp.asarray(b))
        tf = tfilm.film_add_batch(tf, torch.from_numpy(b))
    _close(jf, tf)
    jm = jfilm.film_merge(jf, jf)
    tm = tfilm.film_merge(tf, tf)
    _close(jm, tm)


def test_srgb_encode_and_uint8():
    x = np.linspace(-0.1, 1.2, 4001, dtype=np.float32)
    a = np.asarray(jfilm.srgb_encode(jnp.asarray(x)))
    b = tfilm.srgb_encode(torch.from_numpy(x)).numpy()
    assert np.abs(a - b).max() <= TOL
    np.testing.assert_array_equal(
        np.asarray(jfilm.to_uint8(jnp.asarray(a))), tfilm.to_uint8(torch.from_numpy(a)).numpy()
    )

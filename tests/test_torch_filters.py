"""The port's Mitchell filter (``ops/filters.py``) and piecewise-constant
distributions (``ops/distrib.py``) against the JAX reference on the same
seeded inputs: filter values, the filter sampler's tables, and the
sampled offsets, pdfs and weights (values within 1e-6, weights equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import distrib as JD
from cuda_optix_pathtracing_tpu.ops import filters as JF
from cuda_optix_pathtracing_tpu_torch.ops import distrib as TD
from cuda_optix_pathtracing_tpu_torch.ops import filters as TF

torch.set_num_threads(2)

TOL = dict(rtol=0, atol=1e-6)


def _u(n, seed):
    u = np.random.default_rng(seed).random((2, n)).astype(np.float32)
    u[:, :4] = [0.0, 0.5, np.float32(1.0 - 2**-24), 0.25]  # edges of [0, 1)
    return u


def test_mitchell_values():
    x = np.linspace(-1.2, 1.2, 4001).astype(np.float32)
    np.testing.assert_allclose(TF.mitchell_1d(x).numpy(), np.asarray(JF.mitchell_1d(jnp.asarray(x))), **TOL)
    gx, gy = np.meshgrid(x[::40] * 2, x[::40][::-1] * 2)
    np.testing.assert_allclose(
        TF.mitchell_2d(gx, gy).numpy(),
        np.asarray(JF.mitchell_2d(jnp.asarray(gx, jnp.float32), jnp.asarray(gy, jnp.float32))),
        **TOL,
    )


@pytest.fixture(scope="module")
def samplers():
    return JF.make_filter_sampler(), TF.make_filter_sampler()


def test_filter_sampler_tables(samplers):
    jfs, tfs = samplers
    assert tfs.radius == jfs.radius and tfs.table.shape == (32, 32)
    np.testing.assert_allclose(tfs.table.numpy(), np.asarray(jfs.table), **TOL)
    np.testing.assert_array_equal(np.sign(tfs.table.numpy()), np.sign(np.asarray(jfs.table)))
    for a, b in zip(tfs.dist, jfs.dist):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_sample_filter(samplers):
    jfs, tfs = samplers
    u1, u2 = _u(50_000, 1)
    jdx, jdy, jw = JF.sample_filter(jfs, jnp.asarray(u1), jnp.asarray(u2))
    tdx, tdy, tw = TF.sample_filter(tfs, torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), **TOL)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert set(np.unique(tw.numpy())) == {-1.0, 1.0}
    # the cached per-device sampler is the same tables
    c = TF.filter_sampler("cpu")
    assert TF.filter_sampler("cpu") is c
    np.testing.assert_array_equal(c.table.numpy(), tfs.table.numpy())


@pytest.mark.parametrize("shape", [(7, 13), (70, 90)])
def test_piecewise_2d(shape):
    rng = np.random.default_rng(2)
    func = rng.random(shape).astype(np.float32) * (rng.random(shape) < 0.7)
    func[1] = 0.0  # an empty row: uniform conditional
    jd, td = JD.make_piecewise_2d(func), TD.make_piecewise_2d(func)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    u1, u2 = _u(20_000, 3)
    jx, jy, jp = JD.sample_piecewise_2d(jd, jnp.asarray(u1), jnp.asarray(u2))
    tx, ty, tp = TD.sample_piecewise_2d(td, torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TD.pdf_piecewise_2d(td, tx, ty).numpy(),
        np.asarray(JD.pdf_piecewise_2d(jd, jnp.asarray(tx.numpy()), jnp.asarray(ty.numpy()))),
        rtol=1e-6, atol=1e-6,
    )
    zero = TD.make_piecewise_2d(np.zeros(shape, np.float32))
    _, _, pz = TD.sample_piecewise_2d(zero, torch.from_numpy(u1), torch.from_numpy(u2))
    assert (pz == 1.0).all()


def test_piecewise_1d():
    rng = np.random.default_rng(4)
    func = rng.random(17).astype(np.float32) + 0.05
    func[3] = 0.0
    jd, td = JD.make_piecewise_1d(func), TD.make_piecewise_1d(func)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    u = _u(20_000, 5)[0]
    jx, jp, ji = JD.sample_piecewise_1d(jd, jnp.asarray(u))
    tx, tp, ti = TD.sample_piecewise_1d(td, torch.from_numpy(u))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        TD.pdf_piecewise_1d(td, tx).numpy(), np.asarray(JD.pdf_piecewise_1d(jd, jnp.asarray(tx.numpy()))),
        rtol=1e-6, atol=1e-6,
    )
    zero = TD.make_piecewise_1d(np.zeros(9, np.float32))
    np.testing.assert_allclose(zero.cdf.numpy(), np.linspace(0, 1, 10, dtype=np.float32), atol=1e-7)

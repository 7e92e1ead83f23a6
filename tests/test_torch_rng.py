"""The port's hash sampler is bit-exact against the JAX reference on random
u32 keys, including keys ≥ 2^31 (int64-masked u32 arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import rng as JR
from cuda_optix_pathtracing_tpu_torch.ops import rng as TR

torch.set_num_threads(2)

N = 100_000


@pytest.fixture(scope="module")
def keys():
    k = np.random.default_rng(1234).integers(0, 2**32, size=(4, N), dtype=np.uint64)
    k[:, :8] = [[0], [2**31], [2**32 - 1], [2**31 - 1]]  # edge keys
    k = k.astype(np.uint32)
    assert (k >= 2**31).any()
    return k


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_pcg4d_bit_exact(keys):
    ref = JR.pcg4d(*(jnp.asarray(k) for k in keys))
    out = TR.pcg4d(*(_t(k) for k in keys))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), o.numpy())


def test_pcg_hash_bit_exact(keys):
    for k in keys:
        np.testing.assert_array_equal(
            np.asarray(JR.pcg_hash(jnp.asarray(k))).astype(np.int64),
            TR.pcg_hash(_t(k)).numpy(),
        )


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 5])
def test_hash_samples_bit_exact(keys, seed):
    px, py, s, dim = keys
    u = JR.hash_sample_1d(*(jnp.asarray(k) for k in keys), seed=seed)
    v = TR.hash_sample_1d(_t(px), _t(py), _t(s), _t(dim), seed=seed)
    np.testing.assert_array_equal(np.asarray(u), v.numpy())
    assert v.dtype == torch.float32
    u1, u2 = JR.hash_sample_2d(*(jnp.asarray(k) for k in keys), seed=seed)
    v1, v2 = TR.hash_sample_2d(_t(px), _t(py), _t(s), _t(dim), seed=seed)
    np.testing.assert_array_equal(np.asarray(u1), v1.numpy())
    np.testing.assert_array_equal(np.asarray(u2), v2.numpy())


def test_sampler_scalar_sample_and_dims(keys):
    px, py = keys[0][:4096], keys[1][:4096]
    js = JR.Sampler("hash", 3)
    ts = TR.Sampler("hash", 3)
    for dim in (0, TR.Dim.LIGHT_U, 4 * TR.DIMS_PER_BOUNCE + TR.Dim.RR):
        a = js.sample_1d(jnp.asarray(px), jnp.asarray(py), 17, dim)
        b = ts.sample_1d(_t(px), _t(py), 17, dim)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(NotImplementedError, match="slice 4"):
        TR.Sampler("halton")

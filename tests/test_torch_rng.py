"""The port's samplers against the JAX reference on random u32 keys,
including keys ≥ 2^31 (int64-masked u32 arithmetic): the hash sampler and
the integer parts of the Owen-scrambled Halton sampler bit for bit.

The odd-base radical inverse is held to within 1 ulp of the JAX function,
not bit for bit: XLA's CPU backend contracts the reference's digit
accumulate ``value + sdigit * inv_mult`` into a fused multiply-add (its
results equal that FMA rounded once), while ``ops/rng.py`` as written
rounds the product and the sum apart, and so do the port and its CUDA
kernels (``__fmul_rn``/``__fadd_rn``). Bases 2 and 3 never differ (their
products are exact). The port is also held bit for bit to a numpy float32
statement of the reference's loop, rounded after every operation."""

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
    with pytest.raises(ValueError, match="unknown sampler"):
        TR.Sampler("sobol")


BIG_SEED = 4_000_000_000  # a seed >= 2^31


def _j_seed(seed):
    return np.uint32(seed)  # JAX reads a Python int > 2^31 as int32


def _within_ulp(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    assert (gap <= np.spacing(np.maximum(np.abs(a), np.abs(b)))).all(), gap.max()


def _np_radical_inverse(index, base, seed, n_digits):
    """The reference's loop in numpy: u32 in uint64 with masks, float32
    rounded after every operation."""
    m = 0xFFFFFFFF

    def pcg_hash(s):
        st = (s * 747796405 + 2891336453) & m
        w = (((st >> ((st >> 28) + 4)) ^ st) * 277803737) & m
        return (w >> 22) ^ w

    idx, seed = (np.broadcast_to(np.asarray(x, np.uint64), np.shape(seed)) for x in (index, seed))
    value = np.zeros(idx.shape, np.float32)
    prefix = np.zeros(idx.shape, np.uint64)
    inv = np.float32(1.0 / base)
    inv_mult = inv
    for _ in range(n_digits):
        digit = idx % base
        sdigit = ((digit + pcg_hash((prefix * 0x9E3779B9) & m ^ seed)) & m) % base
        value = (value + (sdigit.astype(np.float32) * inv_mult).astype(np.float32)).astype(np.float32)
        prefix = (prefix * base + digit + 1) & m
        idx = idx // base
        inv_mult = np.float32(inv_mult * inv)
    return np.minimum(value, np.float32(1.0 - 1e-7))


def test_halton_bit_ops_exact(keys):
    x, s = keys[0], keys[1]
    np.testing.assert_array_equal(
        np.asarray(JR.reverse_bits32(jnp.asarray(x))).astype(np.int64),
        TR.reverse_bits32(_t(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(JR.laine_karras_permutation(jnp.asarray(x), jnp.asarray(s))).astype(np.int64),
        TR.laine_karras_permutation(_t(x), _t(s)).numpy())
    np.testing.assert_array_equal(
        np.asarray(JR.sobol_owen_base2(jnp.asarray(x), jnp.asarray(s))),
        TR.sobol_owen_base2(_t(x), _t(s)).numpy())


@pytest.mark.parametrize("base", [3, 5, 13, 131])
def test_radical_inverse_owen(keys, base):
    idx, seed = keys[2][:8192], keys[3][:8192]
    nd = TR.n_digits(base)
    ours = TR.radical_inverse_owen(_t(idx), base, _t(seed), nd).numpy()
    np.testing.assert_array_equal(ours, _np_radical_inverse(idx, base, seed, nd))
    ref = JR.radical_inverse_owen(jnp.asarray(idx), base, jnp.asarray(seed), nd)
    _within_ulp(ref, ours)
    if base == 3:
        np.testing.assert_array_equal(np.asarray(ref), ours)


def test_halton_owen_sample_all_bases(keys):
    """Dims 0-40 (all 32 prime bases, and dims past 32 wrapping to them),
    seeds 0 and one >= 2^31, array and scalar sample indices."""
    px, py, s = (k[:2048] for k in keys[:3])
    for dim in range(41):
        seed = (0, BIG_SEED)[dim % 2]
        samples = [s] + ([123_456_789] if dim % 8 == 0 or dim == 33 else [])
        for smp in samples:
            j_smp = jnp.asarray(smp) if isinstance(smp, np.ndarray) else jnp.uint32(smp)
            ref = JR.halton_owen_sample(jnp.asarray(px), jnp.asarray(py), j_smp, dim, _j_seed(seed))
            ours = TR.halton_owen_sample(_t(px), _t(py), _t(smp) if isinstance(smp, np.ndarray) else smp,
                                         dim, seed)
            assert ours.shape == (2048,) and ours.dtype == torch.float32
            if TR.PRIMES[dim % 32] <= 3:
                np.testing.assert_array_equal(np.asarray(ref), ours.numpy())
            else:
                _within_ulp(ref, ours.numpy())


@pytest.mark.parametrize("qmc_dims", [12, 3])
def test_halton_sampler_cut_over(keys, qmc_dims):
    """Halton below qmc_dims, the hash from there on (a 2-D request needs
    both of its dims below it)."""
    px, py, s = (k[:1024] for k in keys[:3])
    js = JR.Sampler("halton", _j_seed(BIG_SEED), qmc_dims=qmc_dims)
    ts = TR.Sampler("halton", BIG_SEED, qmc_dims=qmc_dims)
    jk = [jnp.asarray(k) for k in (px, py, s)]
    tk = [_t(k) for k in (px, py, s)]
    for dim in (qmc_dims - 2, qmc_dims - 1, qmc_dims, 24 + 5):
        _within_ulp(js.sample_1d(*jk, dim), ts.sample_1d(*tk, dim).numpy())
        for r, o in zip(js.sample_2d(*jk, dim), ts.sample_2d(*tk, dim)):
            _within_ulp(r, o.numpy())
    hashed = TR.hash_sample_1d(*tk, qmc_dims, seed=BIG_SEED)
    np.testing.assert_array_equal(ts.sample_1d(*tk, qmc_dims).numpy(), hashed.numpy())
    h2 = TR.hash_sample_2d(*tk, qmc_dims - 1, seed=BIG_SEED)
    for a, b in zip(ts.sample_2d(*tk, qmc_dims - 1), h2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

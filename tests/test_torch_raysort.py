"""The port's ray sorting (``ops/raysort.py``) and Morton pixel order
(``ops/morton.py``) against the JAX reference: sort keys and pixel orders
bit for bit, and the sorted round trip exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import morton as JM
from cuda_optix_pathtracing_tpu.ops import raysort as JR
from cuda_optix_pathtracing_tpu_torch.ops import morton as TM
from cuda_optix_pathtracing_tpu_torch.ops import raysort as TR

torch.set_num_threads(2)


def _rays(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = [[0.0, -0.0, 1.0]] * 8  # signed zeros: -0 is not negative
    alive = rng.random(n) < 0.7
    return o, d, alive


def test_ray_sort_key_equals_reference():
    o, d, alive = _rays()
    lo, hi = np.array([-2.0, 0.0, -1.0], np.float32), np.array([2.0, 4.0, 2.5], np.float32)
    ref = JR.ray_sort_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi),
                          jnp.asarray(alive))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ours = TR.ray_sort_key(t(o), t(d), t(lo), t(hi), t(alive))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref).astype(np.int64))
    assert (ours[~t(alive)] == TR.DEAD_KEY).all()
    blo, bhi = TR.scene_bounds(t(o), t(d), t(-d))
    jlo, jhi = JR.scene_bounds(jnp.asarray(o), jnp.asarray(d), jnp.asarray(-d))
    np.testing.assert_array_equal(blo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(bhi.numpy(), np.asarray(jhi))


def test_int32_key_sorts_as_ray_sort_key():
    """The depth-sorted wavefront's int32 key: live keys equal ray_sort_key's
    u32 values, dead rays 0x7FFFFFFF, and its stable argsort is
    ray_sort_key's, dead rays included."""
    o, d, alive = (torch.from_numpy(a) for a in _rays(20_000, seed=3))
    alive[:2000] = False  # runs of dead rays among live ones with equal keys
    o[2000:6000] = o[2000]
    lo, hi = torch.tensor([-2.0, 0.0, -1.0]), torch.tensor([2.0, 4.0, 2.5])
    k64 = TR.ray_sort_key(o, d, lo, hi, alive)
    k32 = TR.ray_sort_key32(o, d, lo, hi, alive)
    assert k32.dtype == torch.int32
    np.testing.assert_array_equal(k32[alive].numpy(), k64[alive].numpy())
    assert bool((k32[~alive] == TR.DEAD_KEY32).all()) and int(k64[alive].max()) < TR.DEAD_KEY32
    np.testing.assert_array_equal(torch.sort(k32, stable=True).indices.numpy(),
                                  torch.sort(k64, stable=True).indices.numpy())


def test_sorted_apply_round_trip_is_exact():
    o, d, alive = (torch.from_numpy(a) for a in _rays(4096, seed=1))
    key = TR.ray_sort_key(o, d, o.amin(0), o.amax(0), alive)
    idx = torch.sort(key, stable=True).indices
    assert (key[idx][1:] >= key[idx][:-1]).all()

    def per_ray(so, sd):
        return (so * 2.0 + sd).sum(-1), torch.arange(so.shape[0])

    a, pos = TR.sorted_apply(o, d, key, per_ray)
    np.testing.assert_array_equal(a.numpy(), (o * 2.0 + d).sum(-1).numpy())
    # each ray went to the position its key gives it
    np.testing.assert_array_equal(pos.numpy(), torch.argsort(idx).numpy())
    t_max = torch.from_numpy(np.random.default_rng(2).random(4096).astype(np.float32))
    out = TR.sorted_apply(o, d, key, lambda so, sd, st: st * (so + sd).sum(-1), t_max)
    np.testing.assert_array_equal(out.numpy(), (t_max * (o + d).sum(-1)).numpy())


@pytest.mark.parametrize("size", [32, 64])
def test_morton_order_equals_reference(size):
    order = TM.morton_pixel_order(size, size)
    np.testing.assert_array_equal(order, JM.morton_pixel_order(size, size))
    flat = np.random.default_rng(size).random((size * size, 3)).astype(np.float32)
    ref = np.asarray(JM.unmorton_image(jnp.asarray(flat), size, size))
    np.testing.assert_array_equal(TM.unmorton_image(torch.from_numpy(flat), size, size).numpy(), ref)
    # unmorton inverts the Morton gather of row-major pixels, batched too
    img = torch.from_numpy(flat).reshape(size, size, 3)
    both = torch.stack([img, 2 * img]).reshape(2, -1, 3)[:, torch.from_numpy(order)]
    np.testing.assert_array_equal(TM.unmorton_image(both, size, size).numpy(),
                                  torch.stack([img, 2 * img]).numpy())
    assert TM.is_pot_square(size, size) and not TM.is_pot_square(size, size // 2)

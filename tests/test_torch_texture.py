"""The port's textures, environment map and infinite lights against the
JAX reference on seeded inputs: mip chains and pools equal, texture
lookups within atol 1e-6; the environment's tables, samples and pdfs
within 1e-6 relative on ``veranda_polyhaven_1k.png`` and a seeded 16×32
map; directional and environment light rows as the reference's
``tests/test_lights.py`` checks them."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import envmap as JE
from cuda_optix_pathtracing_tpu.ops import lights as JL
from cuda_optix_pathtracing_tpu.ops import texture as JT
from cuda_optix_pathtracing_tpu.ops.sampling import map_to_sphere as j_map_to_sphere
from cuda_optix_pathtracing_tpu.utils import imageio as jimageio
from cuda_optix_pathtracing_tpu_torch.ops import envmap as TE
from cuda_optix_pathtracing_tpu_torch.ops import lights as TL
from cuda_optix_pathtracing_tpu_torch.ops import texture as TT
from cuda_optix_pathtracing_tpu_torch.ops.sampling import map_to_sphere
from cuda_optix_pathtracing_tpu_torch.utils import imageio as timageio

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
N = 4096


def _images():
    rs = np.random.default_rng(5)
    return [
        rs.uniform(0.0, 1.0, (37, 20, 3)).astype(np.float32),
        rs.uniform(0.0, 1.0, (16, 16, 1)).astype(np.float32),
        rs.uniform(0.0, 1.0, (1, 5, 3)).astype(np.float32),
    ]


@pytest.fixture(scope="module")
def pools():
    return JT.build_texture_pool(_images()), TT.build_texture_pool(_images())


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(ours, ref, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol, rtol=0)


def test_srgb_to_linear_equals_reference():
    img = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)
    np.testing.assert_array_equal(timageio.srgb_to_linear(img), jimageio.srgb_to_linear(img))
    img16 = (np.arange(1024, dtype=np.uint16) * 64).reshape(32, 32)
    np.testing.assert_array_equal(timageio.srgb_to_linear(img16), jimageio.srgb_to_linear(img16))


def test_mip_chains_and_pool_equal(pools):
    for im in _images():
        ours, ref = TT.build_mip_chain(im), JT.build_mip_chain(im)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    jp, tp = pools
    for name in JT.TexturePool._fields:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tp.max_levels == 7 and tp.num_textures == 3


def _lookups():
    rs = np.random.default_rng(9)
    tex = rs.integers(0, 3, N).astype(np.int32)
    uv = rs.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    level = rs.integers(0, 7, N).astype(np.int32)
    lod = rs.uniform(-1.0, 8.0, N).astype(np.float32)
    return tex, uv, level, lod


def test_bilinear_and_trilinear_match_reference(pools):
    jp, tp = pools
    tex, uv, level, lod = _lookups()
    level = np.minimum(level, np.asarray(jp.n_levels)[tex] - 1).astype(np.int32)
    _close(TT.sample_bilinear(tp, _t(tex), _t(uv), _t(level)),
           JT.sample_bilinear(jp, jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(level)))
    _close(TT.sample_trilinear(tp, _t(tex), _t(uv), _t(lod)),
           JT.sample_trilinear(jp, jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(lod)))


def _surface():
    """Seeded footprint inputs: cone widths, UV densities, view directions,
    normals and UV tangents."""
    rs = np.random.default_rng(13)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    ng = unit(rs.normal(size=(N, 3)))
    wo = unit(ng * rs.uniform(0.02, 1.0, (N, 1)) + rs.normal(size=(N, 3)) * 0.5)
    wo = np.where(np.sum(wo * ng, -1, keepdims=True) < 0, -wo, wo).astype(np.float32)
    dpdu = rs.normal(size=(N, 3)).astype(np.float32)
    dpdv = rs.normal(size=(N, 3)).astype(np.float32)
    cone_w = rs.uniform(1e-4, 0.05, N).astype(np.float32)
    dens = rs.uniform(0.1, 3.0, N).astype(np.float32)
    return cone_w, dens, wo, ng, dpdu, dpdv


def test_footprint_and_ewa_match_reference(pools):
    jp, tp = pools
    tex, uv, _, _ = _lookups()
    cone_w, dens, wo, ng, dpdu, dpdv = _surface()
    j_args = [jnp.asarray(a) for a in (cone_w, dens, wo, ng, dpdu, dpdv)]
    t_args = [_t(a) for a in (cone_w, dens, wo, ng, dpdu, dpdv)]
    j_major, j_minor = JT.cone_ellipse_uv(*j_args)
    major, minor = TT.cone_ellipse_uv(*t_args)
    _close(major, j_major)
    _close(minor, j_minor)
    j_lod = JT.raycone_lod(jp, jnp.asarray(tex), j_args[0], j_args[1])
    lod = TT.raycone_lod(tp, _t(tex), t_args[0], t_args[1])
    _close(lod, j_lod)
    _close(TT.sample_ewa(tp, _t(tex), _t(uv), major, lod),
           JT.sample_ewa(jp, jnp.asarray(tex), jnp.asarray(uv), j_major, j_lod))


def test_uv_density_and_cone_spread_match_reference():
    rs = np.random.default_rng(17)
    tri_uv = rs.uniform(0.0, 1.0, (512, 3, 2)).astype(np.float32)
    e0 = rs.normal(size=(512, 3)).astype(np.float32)
    e1 = rs.normal(size=(512, 3)).astype(np.float32)
    tri_uv[:4] = e0[:4] = e1[:4] = 0.0  # pad rows: zero density
    ours = TT.uv_density(_t(tri_uv), _t(e0), _t(e1)).numpy()
    ref = np.asarray(JT.uv_density(jnp.asarray(tri_uv), jnp.asarray(e0), jnp.asarray(e1)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert (ours[:4] == 0.0).all()
    from cuda_optix_pathtracing_tpu.ops.camera import camera_from_raster

    m = np.asarray(camera_from_raster(20.0, 36.0, 256, 256))
    _close(TT.pixel_cone_spread(_t(m)), JT.pixel_cone_spread(jnp.asarray(m)), atol=1e-9)


# ---- the environment map -------------------------------------------------------


def _env_images():
    rs = np.random.default_rng(21)
    seeded = rs.uniform(0.0, 3.0, (16, 32, 3)).astype(np.float32)
    veranda = jimageio.srgb_to_linear(jimageio.read_png(os.path.join(SCENES, "veranda_polyhaven_1k.png")))
    return {"seeded": seeded, "veranda": veranda}


def _rotation():
    a, b = 0.4, 1.1
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    return (rx @ rz).astype(np.float32)


@pytest.fixture(scope="module", params=["seeded", "veranda"])
def envs(request):
    img = _env_images()[request.param]
    rot = _rotation()
    return JE.make_envmap(img, rot, 1.25), TE.make_envmap(img, rot, 1.25)


def test_envmap_tables_equal(envs):
    jenv, tenv = envs
    for name in ("func", "cond_cdf", "cond_int", "marg_cdf", "func_int"):
        np.testing.assert_array_equal(
            getattr(tenv.dist, name).numpy(), np.asarray(getattr(jenv.dist, name)), err_msg=name
        )
    np.testing.assert_array_equal(tenv.image.numpy(), np.asarray(jenv.image))
    assert not tenv.uniform


def test_sample_envmap_matches_reference(envs):
    jenv, tenv = envs
    rs = np.random.default_rng(23)
    u1, u2 = rs.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    jd, jrad, jpdf = (np.asarray(x) for x in JE.sample_envmap(jenv, jnp.asarray(u1), jnp.asarray(u2)))
    d, rad, pdf = (x.numpy() for x in TE.sample_envmap(tenv, _t(u1), _t(u2)))
    _close(d, jd)
    np.testing.assert_allclose(rad, jrad, rtol=1e-6, atol=0)
    np.testing.assert_allclose(pdf, jpdf, rtol=1e-6, atol=0)
    assert (pdf > 0).all()


def test_eval_envmap_matches_reference(envs):
    """Radiance within 1e-6 relative; the pdf within 1e-6 relative plus
    what the polar map coordinate v carries into it. XLA's acos and
    torch's differ by an ulp for about a tenth of the directions, which
    the division by π and the subtraction in v = 1 − acos(z)/π round to at
    most two ulps of v; the pdf, pdf_uv / (2π² sin(π(1 − v))), then moves by
    π·|cot θ| times that difference, which near the poles exceeds 1e-6."""
    jenv, tenv = envs
    rs = np.random.default_rng(29)
    d = rs.normal(size=(N, 3))
    d = np.concatenate([d / np.linalg.norm(d, axis=1, keepdims=True), np.eye(3), -np.eye(3)])
    d = d.astype(np.float32)
    jrad, jpdf = (np.asarray(x) for x in JE.eval_envmap(jenv, jnp.asarray(d)))
    rad, pdf = (x.numpy() for x in TE.eval_envmap(tenv, _t(d)))
    np.testing.assert_allclose(rad, jrad, rtol=1e-6, atol=0)
    r = _rotation()
    d_env = np.stack([r[0, i] * d[:, 0] + r[1, i] * d[:, 1] + r[2, i] * d[:, 2] for i in range(3)], -1)
    jv = np.asarray(j_map_to_sphere(jnp.asarray(d_env))[1])
    v = TE._env_uv(tenv, _t(d))[1].numpy()
    dv = np.abs(v.astype(np.float64) - jv)
    ulp = np.maximum(np.spacing(np.abs(jv)), np.spacing(np.float32(1.0) - jv))  # of v or 1 − v
    assert (dv <= 2 * ulp).all() and (dv == 0).mean() > 0.8
    theta = np.pi * (1.0 - jv.astype(np.float64))
    carried = np.pi * np.abs(np.cos(theta) / np.maximum(np.sin(theta), 1e-6)) * dv
    rel = np.abs(pdf.astype(np.float64) - jpdf) / jpdf
    assert (rel <= 1e-6 + 1.01 * carried).all(), rel.max()
    assert (rel[dv == 0] <= 1e-6).all()
    # the radiance-only lookup is the first half of eval_envmap
    np.testing.assert_array_equal(TE.env_radiance(tenv, _t(d)).numpy(), rad)


def test_constant_envmap_keeps_its_shortcut():
    jenv = JE.constant_envmap((0.05, 0.1, 0.2))
    tenv = TE.constant_envmap((0.05, 0.1, 0.2))
    assert tenv.uniform and tenv.image.shape == (32, 1, 3)
    d = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 3)), dtype=torch.float32)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    rad, pdf = TE.eval_envmap(tenv, d)
    jrad, jpdf = JE.eval_envmap(jenv, jnp.asarray(d.numpy()))
    _close(rad, jrad)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(TE.env_radiance(tenv, d).numpy(), rad.numpy())
    np.testing.assert_array_equal(
        tenv.dist.marg_cdf.numpy(), np.asarray(jenv.dist.marg_cdf)
    )


# ---- infinite lights -------------------------------------------------------------


def _gather(mod, light_dict, n):
    lt = mod.make_light_table([light_dict])
    if mod is TL:
        return lt.gather(torch.zeros((n,), dtype=torch.int64))
    return lt.gather(jnp.zeros((n,), jnp.int32))


def _setup(n, seed=1):
    rs = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    normal = np.tile([[0.0, 0.0, 1.0]], (n, 1)).astype(np.float32)
    u = rs.random((2, n)).astype(np.float32)
    return pos, normal, u[0], u[1]


def test_env_light_uniform():
    n = 2048
    lt = _gather(TL, TL.environment_light((0.5, 0.5, 0.5)), n)
    pos, normal, u1, u2 = _setup(n)
    ls = TL.sample_light(lt, _t(pos), _t(u1), _t(u2), _t(normal))
    np.testing.assert_allclose(ls.pdf.numpy(), 1.0 / (4 * np.pi), rtol=1e-5)
    np.testing.assert_allclose(TL.eval_light(lt, ls).numpy(), 0.5, atol=1e-6)
    assert (ls.distance.numpy() > 1e30).all() and not ls.delta.any()


def test_directional_light():
    n = 256
    lt = _gather(TL, TL.directional_light((2.0, 2.0, 2.0), (0.0, 0.0, -1.0), 0.0), n)
    pos, normal, u1, u2 = _setup(n)
    ls = TL.sample_light(lt, _t(pos), _t(u1), _t(u2), _t(normal))
    np.testing.assert_allclose(ls.direction.numpy()[:, 2], 1.0, atol=1e-6)
    assert ls.delta.all()
    np.testing.assert_allclose(TL.eval_light(lt, ls).numpy(), 2.0, atol=1e-6)


def test_eval_infinite():
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    le, pdf = TL.eval_infinite_light(torch.tensor([0.1, 0.2, 0.3]), d)
    _close(le[0], [0.1, 0.2, 0.3])
    np.testing.assert_allclose(pdf.numpy(), 1.0 / (4 * np.pi), atol=1e-7)


def _mixed(mod):
    return [
        mod.point_light((3.0, 2.0, 1.0), (0.0, 0.5, 2.0), 0.3),
        mod.spot_light((1.0, 1.0, 1.0), (0.2, 0.0, 2.0), (0.0, 0.1, -1.0),
                       np.cos(np.pi / 6), np.cos(np.pi / 3), 0.05),
        mod.environment_light((0.5, 0.4, 0.3)),
        mod.directional_light((2.0, 2.0, 2.0), (0.3, -0.2, -1.0), 0.02),
        mod.directional_light((1.0, 0.5, 0.5), (0.0, 0.0, -1.0), 0.0),
    ]


def test_sample_light_matches_reference_on_every_row_type():
    """A table of point, spot, environment and directional rows gathered
    at random: on the infinite rows every field of the sample and the
    radiance as the reference's, at 1e-6; with ``types`` naming only the
    finite rows, the finite rows' samples are unchanged."""
    n = 4096
    rs = np.random.default_rng(31)
    idx = rs.integers(0, 5, n)
    pos = rs.normal(size=(n, 3)).astype(np.float32) * 0.5
    normal = rs.normal(size=(n, 3))
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(np.float32)
    u1, u2 = rs.random((2, n)).astype(np.float32)
    jlt = JL.make_light_table(_mixed(JL)).gather(jnp.asarray(idx, jnp.int32))
    tlt = TL.make_light_table(_mixed(TL)).gather(torch.as_tensor(idx))
    jls = JL.sample_light(jlt, jnp.asarray(pos), jnp.asarray(u1), jnp.asarray(u2),
                          jnp.zeros((n,), bool), jnp.asarray(normal))
    tls = TL.sample_light(tlt, _t(pos), _t(u1), _t(u2), _t(normal))
    inf = idx >= 2
    for name in JL.LightSample._fields:
        a, b = getattr(tls, name).numpy()[inf], np.asarray(getattr(jls, name))[inf]
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(TL.eval_light(tlt, tls).numpy()[inf],
                               np.asarray(JL.eval_light(jlt, jls))[inf], rtol=1e-6, atol=1e-6)
    assert tls.delta.numpy()[idx >= 3].all() and (tls.distance.numpy()[inf] > 1e30).all()
    finite = TL.sample_light(tlt, _t(pos), _t(u1), _t(u2), _t(normal), types=(TL.POINT, TL.SPOT))
    rows = torch.as_tensor(idx < 2)
    for name in TL.LightSample._fields:
        assert torch.equal(getattr(finite, name)[rows], getattr(tls, name)[rows]), name

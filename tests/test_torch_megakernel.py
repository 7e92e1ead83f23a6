"""The port's integrator (``trace_paths``, the fused kernel's plain version)
against the JAX reference's XLA integrator and its fused Pallas kernel in
interpret mode, on the same RNG keys, to the reference's parity bar:
mean abs diff < 1e-4 and fewer than 0.5 % of pixels off by more than 1e-3.
The hash sampler on three scenes; the Halton sampler, and the Mitchell
pixel filter, on the Cornell box."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.megakernel import MegakernelConfig as JCfg
from cuda_optix_pathtracing_tpu.models.megakernel import render as j_render
from cuda_optix_pathtracing_tpu.models.megakernel import render_sample_batch as j_render_batch
from cuda_optix_pathtracing_tpu.models.megakernel import trace_paths as j_trace
from cuda_optix_pathtracing_tpu.models.megakernel_pallas import trace_paths_fused as j_fused
from cuda_optix_pathtracing_tpu.ops import bsdf as JB
from cuda_optix_pathtracing_tpu.ops import lights as JL
from cuda_optix_pathtracing_tpu.ops import rng as JR
from cuda_optix_pathtracing_tpu.ops.camera import CameraConfig as JCam
from cuda_optix_pathtracing_tpu.ops.camera import generate_rays, pixel_centers
from cuda_optix_pathtracing_tpu.scene import cornell_box as j_cornell_box
from cuda_optix_pathtracing_tpu.scene.procedural import cornell_box_mesh as j_cornell_box_mesh
from cuda_optix_pathtracing_tpu.scene.types import HostScene as JHost
from cuda_optix_pathtracing_tpu.scene.types import scene_from_host as j_from_host
from cuda_optix_pathtracing_tpu_torch.models.megakernel import (
    MegakernelConfig,
    render,
    render_sample_batch,
    resolve_fused,
    trace_paths,
)
from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import (
    megakernel_cuda_supported,
    trace_paths_fused,
)
from cuda_optix_pathtracing_tpu_torch.ops import bsdf as TB
from cuda_optix_pathtracing_tpu_torch.ops import lights as TL
from cuda_optix_pathtracing_tpu_torch.ops.camera import CameraConfig as TCam
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh, scene_from_arrays
from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene as THost
from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host as t_from_host
from test_torch_bridge import flatten_scene
from torch_scenes import build_mixed

torch.set_num_threads(2)

W = H = 32
DEPTH = 3
SAMPLES = 4


def _parity(a, b, n):
    diff = np.abs(a - b) / n
    assert np.isfinite(b).all()
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


def _reference_runs(j_scene, samples=SAMPLES, sampler="hash", w=W, h=H):
    """Per-sample radiance sums of the JAX XLA integrator and the JAX
    fused kernel (interpret mode), plus the keys/rays they used."""
    cfg = JCfg(max_depth=DEPTH, remat=False, backend="xla", sampler=sampler)
    acc_x = acc_f = 0.0
    inputs = []
    for k in range(samples):
        samp = jnp.uint32(k)
        pix = pixel_centers(w, h)
        px = pix[:, 0].astype(jnp.uint32)
        py = pix[:, 1].astype(jnp.uint32)
        u1, u2 = JR.Sampler(sampler, 0).sample_2d(px, py, samp, JR.Dim.CAMERA_U)
        o, d = generate_rays(
            pix + jnp.stack([u1, u2], -1), j_scene.cam_from_raster, j_scene.world_from_cam
        )
        acc_x = acc_x + np.asarray(j_trace(j_scene, cfg, px, py, samp, o, d))
        acc_f = acc_f + np.asarray(
            j_fused(j_scene, px, py, samp, o, d, max_depth=DEPTH, interpret=True,
                    sampler=sampler)
        )
        inputs.append(
            tuple(torch.from_numpy(np.asarray(a).astype(np.int64)) for a in (px, py))
            + (k,)
            + tuple(torch.from_numpy(np.array(a)) for a in (o, d))
        )
    return acc_x, acc_f, inputs


def _port_sum(t_scene, inputs, fn):
    acc = 0.0
    for px, py, k, o, d in inputs:
        acc = acc + fn(t_scene, px, py, k, o, d).numpy()
    return acc


def _trace(t_scene, px, py, k, o, d):
    return trace_paths(t_scene, MegakernelConfig(max_depth=DEPTH), px, py, k, o, d, device="cpu")


def _fused_plain(t_scene, px, py, k, o, d):
    return trace_paths_fused(t_scene, px, py, k, o, d, max_depth=DEPTH)


@pytest.fixture(scope="module")
def cornell_case():
    j_scene = j_cornell_box(W, H)
    return scene_from_arrays(flatten_scene(j_scene), "cpu"), _reference_runs(j_scene)


@pytest.fixture(scope="module")
def mixed_case():
    j_scene = j_from_host(build_mixed(JHost, JB, JL, JCam, W, H), use_light_tree=False)
    t_scene = t_from_host(
        build_mixed(THost, TB, TL, TCam, W, H), use_light_tree=False, device="cpu"
    )
    assert t_scene.emissive is not None and j_scene.emissive is not None
    return t_scene, _reference_runs(j_scene)


@pytest.fixture(scope="module")
def mesh_case():
    """The mesh Cornell box with a BVH (subdivision 8: 234 triangles in
    352 packed rows), 2 samples: the port's plain sweep over the packed
    arrays against the reference's XLA integrator and its fused kernel's
    BVH mode in interpret mode."""
    j_scene = j_cornell_box_mesh(W, H, subdiv=8, use_bvh=True)
    t_scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    assert t_scene.bvh is not None and t_scene.num_triangles == 352
    return t_scene, _reference_runs(j_scene, samples=2)


@pytest.mark.parametrize("ref", ["xla", "fused_interpret"])
@pytest.mark.parametrize("case", ["cornell_case", "mixed_case", "mesh_case"])
def test_trace_paths_parity(request, case, ref):
    t_scene, (acc_x, acc_f, inputs) = request.getfixturevalue(case)
    ours = _port_sum(t_scene, inputs, _trace)
    _parity(acc_x if ref == "xla" else acc_f, ours, len(inputs))
    if case == "mixed_case":
        assert ours.max() > 0.1  # the lamp lights the scene


def test_fused_wrapper_on_cpu_is_trace_paths(mixed_case):
    t_scene, (_, _, inputs) = mixed_case
    inputs = inputs[:1]
    np.testing.assert_array_equal(
        _port_sum(t_scene, inputs, _fused_plain), _port_sum(t_scene, inputs, _trace)
    )
    assert trace_paths_fused.launches == 0


def test_render_film_matches_reference():
    spp = 4
    j_film = j_render(j_cornell_box(W, H), W, H, spp, cfg=JCfg(max_depth=DEPTH, remat=False))
    t_film = render(
        cornell_box(W, H, device="cpu"), W, H, spp,
        cfg=MegakernelConfig(max_depth=DEPTH), device="cpu",
    )
    assert float(t_film.n) == spp
    _parity(np.asarray(j_film.mean), t_film.mean.numpy(), 1)


def test_morton_order_same_image():
    scene = cornell_box_mesh(W, H, subdiv=8, use_bvh=True, device="cpu")
    cfg = MegakernelConfig(max_depth=2)
    morton = render_sample_batch(scene, dataclasses.replace(cfg, pixel_order="morton"), W, H, 0, nspp=2)
    linear = render_sample_batch(scene, dataclasses.replace(cfg, pixel_order="linear"), W, H, 0, nspp=2)
    assert morton.shape == (2, H, W, 3)
    np.testing.assert_array_equal(morton.numpy(), linear.numpy())
    one = render_sample_batch(scene, cfg, W, H, 1)  # auto: Morton for a BVH scene
    np.testing.assert_array_equal(one.numpy(), linear[1].numpy())


@pytest.mark.parametrize("case", ["cornell_case", "mesh_case"])
def test_resolve_fused(request, case):
    t_scene = request.getfixturevalue(case)[0]
    cfg = MegakernelConfig()
    assert megakernel_cuda_supported(t_scene, cfg)
    assert not megakernel_cuda_supported(t_scene, dataclasses.replace(cfg, env_nee=True))
    # a CPU scene resolves to the plain path; "on" is validated, as in the
    # reference
    assert resolve_fused(t_scene, cfg).fused == "off"
    assert resolve_fused(t_scene, dataclasses.replace(cfg, fused="on")).fused == "on"
    with pytest.raises(ValueError, match="feature set"):
        resolve_fused(t_scene, MegakernelConfig(fused="on", env_nee=True))


HW_HALTON = 24  # the Halton cases' image: 24 x 24, one sample per pixel


def _trace_halton(t_scene, px, py, k, o, d):
    cfg = MegakernelConfig(max_depth=DEPTH, sampler="halton")
    return trace_paths(t_scene, cfg, px, py, k, o, d, device="cpu")


@pytest.fixture(scope="module")
def halton_case():
    """The Cornell box at 24², one sample, with the Halton sampler: the
    camera jitter and depth 0's light, BSDF and roulette dims are Halton,
    the rest hash."""
    j_scene = j_cornell_box(HW_HALTON, HW_HALTON)
    runs = _reference_runs(j_scene, samples=1, sampler="halton", w=HW_HALTON, h=HW_HALTON)
    return scene_from_arrays(flatten_scene(j_scene), "cpu"), runs


@pytest.mark.parametrize("ref", ["xla", "fused_interpret"])
def test_trace_paths_halton_parity(halton_case, ref):
    t_scene, (acc_x, acc_f, inputs) = halton_case
    ours = _port_sum(t_scene, inputs, _trace_halton)
    _parity(acc_x if ref == "xla" else acc_f, ours, len(inputs))
    assert ours.mean() > 0.0
    if ref == "xla":  # the fused wrapper's plain version is trace_paths
        px, py, k, o, d = inputs[0]
        fused = trace_paths_fused(t_scene, px, py, k, o, d, max_depth=DEPTH, sampler="halton")
        np.testing.assert_array_equal(fused.numpy(), ours)


def test_render_halton_mitchell_matches_reference():
    """``render`` with the Halton sampler and the Mitchell filter against
    the reference's ``render_sample_batch``, averaged over the same
    samples. The reference's own ``render`` cannot take the Mitchell
    filter: under its jit, ``make_filter_sampler`` calls ``np.asarray`` on
    a traced array and raises, so its batch function runs eagerly here."""
    spp, hw = 2, HW_HALTON
    cfg = dict(max_depth=DEPTH, sampler="halton", pixel_filter="mitchell")
    j_scene = j_cornell_box(hw, hw)
    j_mean = sum(
        np.asarray(j_render_batch(j_scene, JCfg(remat=False, **cfg), hw, hw, jnp.uint32(k)))
        for k in range(spp)
    ) / spp
    t_film = render(cornell_box(hw, hw, device="cpu"), hw, hw, spp,
                    cfg=MegakernelConfig(**cfg), device="cpu")
    assert float(t_film.n) == spp
    _parity(j_mean, t_film.mean.numpy(), 1)
    box = render(cornell_box(hw, hw, device="cpu"), hw, hw, spp,
                 cfg=MegakernelConfig(max_depth=DEPTH, sampler="halton"), device="cpu")
    assert not np.array_equal(box.mean.numpy(), t_film.mean.numpy())  # the filter acts


@pytest.mark.parametrize("case", ["cornell", "mixed", "tables_over_48kb"])
def test_brute_tables_built_once_per_scene(case):
    """A brute-force scene carries its fused kernel's shared-memory blob,
    built once with the scene: 48 B rows that unpack to tri_v0 / e0 / e1
    and tri_mat exactly (the id as int32 bits, zero padding), then the
    shading tables; ``table_bytes`` is its size. A BVH scene has none."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import table_bytes
    from cuda_optix_pathtracing_tpu_torch.ops.shade_tables import BRUTE_ROW_WORDS
    from cuda_optix_pathtracing_tpu_torch.scene.types import scene_to

    if case == "mixed":
        scene = t_from_host(build_mixed(THost, TB, TL, TCam, W, H), use_light_tree=False,
                            device="cpu")
    elif case == "tables_over_48kb":
        scene = cornell_box_mesh(W, H, subdiv=24, use_bvh=False, device="cpu")
    else:
        scene = cornell_box(W, H, device="cpu")
    blob = scene.brute_tables
    n = scene.num_triangles
    assert blob is not None and blob.dtype == torch.float32 and blob.is_contiguous()
    assert table_bytes(scene) == 4 * blob.numel()
    rows = blob[:BRUTE_ROW_WORDS * n].reshape(n, BRUTE_ROW_WORDS)
    for c, a in ((0, scene.tri_v0), (4, scene.tri_e0), (8, scene.tri_e1)):
        np.testing.assert_array_equal(rows[:, c:c + 3].numpy(), a.numpy())
    np.testing.assert_array_equal(rows[:, 3].view(torch.int32).numpy(), scene.tri_mat.numpy())
    assert not rows[:, 7].any() and not rows[:, 11].any()
    np.testing.assert_array_equal(blob[BRUTE_ROW_WORDS * n:].numpy(), scene.shade_tables.numpy())
    assert scene_to(scene, "cpu").brute_tables is blob
    mesh = cornell_box_mesh(8, 8, subdiv=8, use_bvh=True, device="cpu")
    assert mesh.brute_tables is None and table_bytes(mesh) == 4 * mesh.shade_tables.numel()

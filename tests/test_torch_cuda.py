"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no GPU is present, and run on a
GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which the port and
these tests do not need). Imports nothing of JAX or the reference."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    return cornell_box(32, 32, device=dev)


def _rays(dev, n=8192, seed=3):
    rs = np.random.default_rng(seed)
    o = rs.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = 0.0
    t_max = rs.uniform(0.05, 6.0, n)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return f(o), f(d), f(t_max)


def test_closest_kernel_matches_plain(dev, scene):
    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import closest_bruteforce, closest_plain

    o, d, _ = _rays(dev)
    before = closest_bruteforce.launches
    tk, ik = closest_bruteforce(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    tp, ip = closest_plain(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    torch.cuda.synchronize()
    assert closest_bruteforce.launches == before + 1
    dt = (tk - tp).abs()
    tie = dt <= 1e-6 * tp.abs()
    assert bool(((ik == ip) | tie).all())
    both = tp < 3.0e38
    assert bool(((tk < 3.0e38) == both).all())
    assert bool((dt[both] <= 1e-5 * tp[both]).all())
    assert bool((tk[:4] == 3.0e38).all())


def test_anyhit_kernel_matches_plain(dev, scene):
    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import any_plain, anyhit_bruteforce

    o, d, t_max = _rays(dev)
    ok = anyhit_bruteforce(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max)
    op = any_plain(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max)
    assert float((ok == op).float().mean()) >= 0.999
    assert not bool(ok[:4].any())


def _mixed_scene(dev):
    from cuda_optix_pathtracing_tpu_torch.ops import bsdf, lights
    from cuda_optix_pathtracing_tpu_torch.ops.camera import CameraConfig
    from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene, scene_from_host
    from torch_scenes import build_mixed

    hs = build_mixed(HostScene, bsdf, lights, CameraConfig, 32, 32)
    return scene_from_host(hs, use_light_tree=False, device=dev)


# the Cornell box and the conductor / Lambert / area-light scene
@pytest.mark.parametrize("case", ["cornell", "mixed"])
def test_fused_kernel_matches_trace_paths(dev, scene, case):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R
    from cuda_optix_pathtracing_tpu_torch.ops.camera import generate_rays, pixel_centers

    if case == "mixed":
        scene = _mixed_scene(dev)
    spp = 4
    pix = pixel_centers(32, 32, dev).repeat(spp, 1)
    sample = torch.repeat_interleave(torch.arange(spp, device=dev), 32 * 32)
    px, py = pix[:, 0].long(), pix[:, 1].long()
    u1, u2 = R.Sampler("hash", 0).sample_2d(px, py, sample, R.Dim.CAMERA_U)
    o, d = generate_rays(pix + torch.stack([u1, u2], -1), scene.cam_from_raster,
                         scene.world_from_cam)
    rk = trace_paths_fused(scene, px, py, sample, o, d, max_depth=3)
    rp = MK.trace_paths(scene, MK.MegakernelConfig(max_depth=3, backend="torch"),
                        px, py, sample, o, d, device=dev)
    diff = ((rk - rp).reshape(spp, -1, 3).sum(0) / spp).abs()
    assert bool(torch.isfinite(rk).all())
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005
    if case == "mixed":
        assert float(rk.max()) > 0.1  # the lamp lights the scene


def test_render_resolves_to_fused_on_cuda(dev, scene):
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, resolve_fused

    assert resolve_fused(scene, MegakernelConfig()).fused == "on"
    assert resolve_fused(scene, MegakernelConfig(backend="torch")).fused == "off"

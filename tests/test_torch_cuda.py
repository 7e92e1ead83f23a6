"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no GPU is present, and run on a
GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which the port and
these tests do not need). Imports nothing of JAX or the reference."""

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _launches(name: str) -> int:
    """Kernel launches of the wrapper ``name`` so far (the registry of
    ``utils/trace.py``)."""
    from cuda_optix_pathtracing_tpu_torch.utils import trace

    return trace.snapshot()[f"launches.{name}"]


@pytest.fixture(scope="module")
def scene(dev):
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    return cornell_box(32, 32, device=dev)


@pytest.fixture(scope="module")
def mesh(dev):
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh

    return cornell_box_mesh(32, 32, subdiv=16, device=dev)


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
    before = _launches("closest_bruteforce")
    tk, ik = closest_bruteforce(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    tp, ip = closest_plain(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    torch.cuda.synchronize()
    assert _launches("closest_bruteforce") == before + 1
    assert torch.equal(tk, tp) and torch.equal(ik, ip)
    assert bool((tk[:4] == 3.0e38).all())


def test_anyhit_kernel_matches_plain(dev, scene):
    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import any_plain, anyhit_bruteforce

    o, d, t_max = _rays(dev)
    ok = anyhit_bruteforce(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max)
    op = any_plain(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max)
    assert torch.equal(ok, op)
    assert not bool(ok[:4].any())


def _hold_brute_kernels(o, d, v0, e0, e1, t_max, rows=None):
    """Kernels 2 and 3 against their plain versions: t, index and flags
    equal on every row, one launch each."""
    from cuda_optix_pathtracing_tpu_torch.ops import intersect_cuda as IC

    before = _launches("closest_bruteforce"), _launches("anyhit_bruteforce")
    tk, ik = IC.closest_bruteforce(o, d, v0, e0, e1, rows=rows)
    ok = IC.anyhit_bruteforce(o, d, v0, e0, e1, t_max, rows=rows)
    tp, ip = IC.closest_plain(o, d, v0, e0, e1)
    op = IC.any_plain(o, d, v0, e0, e1, t_max)
    torch.cuda.synchronize()
    n = o.shape[0]
    launched = int(n > 0)
    assert (_launches("closest_bruteforce"), _launches("anyhit_bruteforce")) == (
        before[0] + launched, before[1] + launched)
    assert tk.dtype == torch.float32 and ik.dtype == torch.int64 and ok.dtype == torch.bool
    assert tk.shape == ik.shape == ok.shape == (n,)
    assert torch.equal(tk, tp) and torch.equal(ik, ip) and torch.equal(ok, op)
    return tk, ik, ok


# kernels 2 and 3 at a single ray, below one warp and ragged past one launch
# of the main path, with the scene's rows and with rows packed by the wrapper
@pytest.mark.parametrize("n", [0, 1, 31, 65_537])
def test_brute_kernels_any_launch_size(dev, scene, n):
    o, d, t_max = _rays(dev, n=max(n, 4), seed=9)
    o, d, t_max = o[:n], d[:n], t_max[:n]
    tris = scene.tri_v0, scene.tri_e0, scene.tri_e1
    rows = scene.brute_tables[: 12 * scene.tri_v0.shape[0]]
    _hold_brute_kernels(o, d, *tris, t_max, rows=rows)
    _hold_brute_kernels(o, d, *tris, t_max)


def test_brute_kernels_on_duplicated_triangles(dev, scene):
    """Every triangle twice (the copies shuffled): the closest hit ties
    between copies, and the index must be the plain version's, the first,
    on every row."""
    tris = [x.clone() for x in (scene.tri_v0, scene.tri_e0, scene.tri_e1)]
    perm = torch.as_tensor(np.random.default_rng(4).permutation(tris[0].shape[0]), device=dev)
    v0, e0, e1 = (torch.cat([x, x[perm]]) for x in tris)
    o, d, t_max = _rays(dev, n=20_000, seed=5)
    tk, ik, _ = _hold_brute_kernels(o, d, v0, e0, e1, t_max)
    assert int((tk < 3.0e38).sum()) > 1000


def test_anyhit_kernel_t_max_scalar_and_per_ray(dev, scene):
    """t_max as a Python number (by value), a one-element tensor and a 0-d
    tensor (stride 0), per ray and as a strided view of a wider tensor."""
    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import any_plain, anyhit_bruteforce

    o, d, t_max = _rays(dev, n=4099, seed=6)
    tris = scene.tri_v0, scene.tri_e0, scene.tri_e1
    wide = torch.stack([t_max, -t_max], 1).reshape(-1)
    for tm in (2.0, torch.tensor([2.0], device=dev), torch.tensor(0.7, device=dev), t_max,
               wide[::2]):
        ok = anyhit_bruteforce(o, d, *tris, tm)
        op = any_plain(o, d, *tris, tm)
        torch.cuda.synchronize()
        assert torch.equal(ok, op)
        assert 0 < int(ok.sum()) < o.shape[0]


def test_brute_kernels_one_device_kernel_per_call(dev, scene):
    """With the scene's rows, a call of either wrapper runs exactly one
    kernel on the device, its own: no table, cast, compare or copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import (
        anyhit_bruteforce,
        closest_bruteforce,
    )

    o, d, t_max = _rays(dev, n=65_536, seed=8)
    tris = scene.tri_v0, scene.tri_e0, scene.tri_e1
    rows = scene.brute_tables[: 12 * scene.tri_v0.shape[0]]
    calls = (
        ("closest_kernel", lambda: closest_bruteforce(o, d, *tris, rows=rows)),
        ("anyhit_kernel", lambda: anyhit_bruteforce(o, d, *tris, t_max, rows=rows)),
        ("anyhit_kernel", lambda: anyhit_bruteforce(o, d, *tris, 2.0, rows=rows)),
    )
    for name, call in calls:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            call()
            torch.cuda.synchronize()
            time.sleep(0.02)
        rows_dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        assert [(name in e.key, e.count) for e in rows_dev] == [(True, 1)], [
            (e.key, e.count) for e in rows_dev]


def test_brute_kernels_refuse_oversized_tables(dev):
    """The wrappers refuse a table over MAX_TRIS with the BVH hint; the C
    entry points return a CUDA error for a table over the shared memory a
    block can have, called directly, and launch at MAX_TRIS (227 KB: the
    kernels raise their shared-memory limit)."""
    import ctypes

    from cuda_optix_pathtracing_tpu_torch.ops import intersect_cuda as IC
    from cuda_optix_pathtracing_tpu_torch.ops.bvh import pack_tri_rows

    o, d, t_max = _rays(dev, n=64, seed=2)
    big = torch.zeros((IC.MAX_TRIS + 1, 3), device=dev)
    with pytest.raises(ValueError, match="BVH"):
        IC.closest_bruteforce(o, d, big, big, big)
    with pytest.raises(ValueError, match="BVH"):
        IC.anyhit_bruteforce(o, d, big, big, big, t_max)
    rows = pack_tri_rows(big, big, big)
    best_t = torch.empty(64, device=dev)
    best_i = torch.empty(64, dtype=torch.int64, device=dev)
    occ = torch.empty(64, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = IC._lib()
    for n_tris, want in ((IC.MAX_TRIS + 1, False), (IC.MAX_TRIS, True)):
        rc_c = lib.closest_bruteforce(o.data_ptr(), d.data_ptr(), rows.data_ptr(), 64, n_tris,
                                      best_t.data_ptr(), best_i.data_ptr(), stream)
        rc_a = lib.anyhit_bruteforce(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), 1,
                                     ctypes.c_float(0.0), rows.data_ptr(), 64, n_tris,
                                     occ.data_ptr(), stream)
        torch.cuda.synchronize()
        assert (rc_c == 0, rc_a == 0) == (want, want), (n_tris, rc_c, rc_a)
    # a degenerate table: every triangle is parallel to every ray
    assert bool((best_t == 3.0e38).all()) and bool((best_i == 0).all()) and not bool(occ.any())


def _mixed_scene(dev):
    from cuda_optix_pathtracing_tpu_torch.ops import bsdf, lights
    from cuda_optix_pathtracing_tpu_torch.ops.camera import CameraConfig
    from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene, scene_from_host
    from torch_scenes import build_mixed

    hs = build_mixed(HostScene, bsdf, lights, CameraConfig, 32, 32)
    return scene_from_host(hs, use_light_tree=False, device=dev)


def _camera_rays(dev, scene, spp, sampler="hash"):
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R
    from cuda_optix_pathtracing_tpu_torch.ops.camera import generate_rays, pixel_centers

    pix = pixel_centers(32, 32, dev).repeat(spp, 1)
    sample = torch.repeat_interleave(torch.arange(spp, device=dev), 32 * 32)
    px, py = pix[:, 0].long(), pix[:, 1].long()
    u1, u2 = R.Sampler(sampler, 0).sample_2d(px, py, sample, R.Dim.CAMERA_U)
    o, d = generate_rays(pix + torch.stack([u1, u2], -1), scene.cam_from_raster,
                         scene.world_from_cam)
    return px, py, sample, o, d


def test_bvh_kernels_match_plain_and_oracle(dev, mesh):
    from cuda_optix_pathtracing_tpu_torch.ops.bvh import traverse_packed_ref
    from cuda_optix_pathtracing_tpu_torch.ops.bvh_cuda import bvh_any_raw, bvh_closest_raw
    from cuda_optix_pathtracing_tpu_torch.ops.intersect import intersect_any, intersect_closest_raw

    tris = (mesh.tri_v0, mesh.tri_e0, mesh.tri_e1)
    ro, rd, t_max = _rays(dev)
    for o, d in (_camera_rays(dev, mesh, 2)[3:], (ro, rd)):
        before = _launches("bvh_closest_raw")
        tk, ik = bvh_closest_raw(o, d, mesh)
        tp, ip = intersect_closest_raw(o, d, *tris)
        torch.cuda.synchronize()
        assert _launches("bvh_closest_raw") == before + 1
        hit = tp < 3.0e38
        assert bool(((tk < 3.0e38) == hit).all())
        rel = (tk - tp).abs() / tp.abs()
        assert bool((rel[hit] <= 1e-5).all())
        assert bool(((ik == ip) | (rel <= 1e-6)).all())
        # the kernel is the oracle's traversal, step for step
        tr, ir, _ = traverse_packed_ref(mesh.bvh.box, mesh.bvh.meta, *tris, o, d)
        np.testing.assert_array_equal(tk.cpu().numpy(), tr)
        np.testing.assert_array_equal(ik.cpu().numpy(), ir)
        tm = t_max[: o.shape[0]]
        occ = bvh_any_raw(o, d, mesh, tm)
        assert occ.dtype == torch.int32
        assert bool(((occ > 0) == intersect_any(o, d, *tris, tm)).all())
        occ_r, _ = traverse_packed_ref(mesh.bvh.box, mesh.bvh.meta, *tris, o, d, "any", tm)
        np.testing.assert_array_equal(occ.cpu().numpy() > 0, occ_r)


def _hold_traversal_kernels(mesh, o, d, t_max):
    """Kernel 4 on (o, d) against the plain sweep (t within 1e-5, rows
    equal but on ties) and the numpy oracle (t and rows bit for bit,
    flags equal)."""
    from cuda_optix_pathtracing_tpu_torch.ops.bvh import traverse_packed_ref
    from cuda_optix_pathtracing_tpu_torch.ops.bvh_cuda import bvh_any_raw, bvh_closest_raw
    from cuda_optix_pathtracing_tpu_torch.ops.intersect import intersect_any, intersect_closest_raw

    tris = (mesh.tri_v0, mesh.tri_e0, mesh.tri_e1)
    n = o.shape[0]
    before = _launches("bvh_closest_raw"), _launches("bvh_any_raw")
    tk, ik = bvh_closest_raw(o, d, mesh)
    occ = bvh_any_raw(o, d, mesh, t_max)
    torch.cuda.synchronize()
    assert (_launches("bvh_closest_raw"), _launches("bvh_any_raw")) == (before[0] + (n > 0),
                                                                 before[1] + (n > 0))
    assert tk.shape == (n,) and ik.shape == (n,) and occ.shape == (n,)
    tp, ip = intersect_closest_raw(o, d, *tris)
    hit = tp < 3.0e38
    assert bool(((tk < 3.0e38) == hit).all())
    rel = (tk - tp).abs() / tp.abs()
    assert bool((rel[hit] <= 1e-5).all()) and bool(((ik == ip) | (rel <= 1e-6)).all())
    assert bool(((occ > 0) == intersect_any(o, d, *tris, t_max)).all())
    tr, ir, _ = traverse_packed_ref(mesh.bvh.box, mesh.bvh.meta, *tris, o, d)
    np.testing.assert_array_equal(tk.cpu().numpy(), tr)
    np.testing.assert_array_equal(ik.cpu().numpy(), ir)
    occ_r, _ = traverse_packed_ref(mesh.bvh.box, mesh.bvh.meta, *tris, o, d, "any", t_max)
    np.testing.assert_array_equal(occ.cpu().numpy() > 0, occ_r)


# kernel 4 on the compact tables at sizes below one block and ragged
@pytest.mark.parametrize("n", [0, 1, 37, 4133])
def test_bvh_kernels_any_launch_size(dev, mesh, n):
    o, d, t_max = _rays(dev, n=max(n, 4), seed=7)
    _hold_traversal_kernels(mesh, o[:n], d[:n], t_max[:n])


def test_traversal_kernels_on_a_deeper_tree(dev):
    """Kernel 4 on a tree of depth 8 whose 396 KB of compact nodes exceed
    L1 (the mesh Cornell box at subdivision 128), on camera and random
    rays, against the plain sweep and the oracle."""
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh

    big = cornell_box_mesh(32, 32, subdiv=128, device=dev)
    assert big.bvh.depth >= 7 and big.bvh.nodes.numel() * 4 > 256 * 1024
    ro, rd, t_max = _rays(dev, n=2048)
    co, cd = _camera_rays(dev, big, 2)[3:]
    _hold_traversal_kernels(big, co, cd, t_max)
    _hold_traversal_kernels(big, ro, rd, t_max)


# the brute-force fused kernel (1 and 1h) at sizes below one block
@pytest.mark.parametrize("sampler", ["hash", "halton"])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_fused_bruteforce_any_launch_size(dev, scene, sampler, n):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused

    px, py, sample, o, d = (x[:n] for x in _camera_rays(dev, scene, 1, sampler=sampler))
    before = _launches("trace_paths_fused")
    rk = trace_paths_fused(scene, px, py, sample, o, d, max_depth=5, sampler=sampler)
    assert rk.shape == (n, 3)
    assert _launches("trace_paths_fused") == before + (n > 0)
    rp = MK.trace_paths(scene, MK.MegakernelConfig(max_depth=5, sampler=sampler,
                                                   backend="torch"),
                        px, py, sample, o, d, device=dev)
    diff = (rk - rp).abs()
    assert bool(torch.isfinite(rk).all())
    if n:
        assert float(diff.mean()) < 1e-4
        assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005


# the Cornell box, the conductor / Lambert / area-light scene, the mesh
# Cornell box through the fused kernel's BVH mode and through the
# wavefront (fused="off": kernel 4 on sorted rays, and on rays in their
# own order with sort_rays="off"), and a brute-force scene whose tables
# need more than 48 KB of shared memory (the mesh Cornell box at
# subdivision 24 without a BVH, 105 KB of 48 B rows and shading tables:
# the kernel raises its limit)
@pytest.mark.parametrize(
    "case", ["cornell", "mixed", "mesh", "mesh_wavefront", "mesh_wavefront_unsorted",
             "tables_over_48kb"]
)
def test_fused_kernel_matches_trace_paths(dev, scene, mesh, case):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import (
        MAX_SMEM_BYTES,
        table_bytes,
        trace_paths_fused,
    )
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh

    if case == "mixed":
        scene = _mixed_scene(dev)
    if case.startswith("mesh"):
        scene = mesh
    if case == "tables_over_48kb":
        scene = cornell_box_mesh(32, 32, subdiv=24, use_bvh=False, device=dev)
        assert scene.bvh is None and 48 * 1024 < table_bytes(scene) <= MAX_SMEM_BYTES
        assert table_bytes(scene) == 4 * scene.brute_tables.numel()
    spp = 4
    px, py, sample, o, d = _camera_rays(dev, scene, spp)
    before = _launches("trace_paths_fused"), _launches("bvh_closest_raw")
    if case.startswith("mesh_wavefront"):
        sort = "off" if case.endswith("unsorted") else "auto"
        rk = MK.trace_paths(scene, MK.MegakernelConfig(max_depth=3, fused="off", sort_rays=sort),
                            px, py, sample, o, d, device=dev)
        assert _launches("bvh_closest_raw") == before[1] + 3
    else:
        rk = trace_paths_fused(scene, px, py, sample, o, d, max_depth=3)
        assert _launches("trace_paths_fused") == before[0] + 1
    rp = MK.trace_paths(scene, MK.MegakernelConfig(max_depth=3, backend="torch"),
                        px, py, sample, o, d, device=dev)
    diff = ((rk - rp).reshape(spp, -1, 3).sum(0) / spp).abs()
    assert bool(torch.isfinite(rk).all())
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005
    if case == "mixed":
        assert float(rk.max()) > 0.1  # the lamp lights the scene


def test_render_resolves_to_fused_on_cuda(dev, scene, mesh):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    assert MK.resolve_fused(scene, MK.MegakernelConfig()).fused == "on"
    assert MK.resolve_fused(scene, MK.MegakernelConfig(backend="torch")).fused == "off"
    assert MK.resolve_fused(mesh, MK.MegakernelConfig()).fused == "on"


# the Halton variant of the fused kernel in both geometry modes, against
# the plain Halton trace_paths on Halton camera rays
@pytest.mark.parametrize("case", ["cornell", "mesh"])
def test_fused_halton_matches_trace_paths(dev, scene, mesh, case):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused

    scene = mesh if case == "mesh" else scene
    spp = 4
    px, py, sample, o, d = _camera_rays(dev, scene, spp, sampler="halton")
    before = _launches("trace_paths_fused")
    rk = trace_paths_fused(scene, px, py, sample, o, d, max_depth=3, seed=9, sampler="halton")
    assert _launches("trace_paths_fused") == before + 1
    rp = MK.trace_paths(scene, MK.MegakernelConfig(max_depth=3, seed=9, sampler="halton",
                                                   backend="torch"),
                        px, py, sample, o, d, device=dev)
    diff = ((rk - rp).reshape(spp, -1, 3).sum(0) / spp).abs()
    assert bool(torch.isfinite(rk).all()) and float(rk.mean()) > 0.0
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005


def _check_planes(sk, sp):
    """Kernel 6's state rows against bounce_step's, column by column, to the
    tolerances of chip_smoke.py's check_planes: keys and slots equal;
    flags equal on 99.99 % of the paths; o and d within 1e-5; beta,
    eta_scale and prev_pdf within 1e-5 relative on 99 % of the paths and
    1e-3 on 99.9 % (the kernel's shading rounds otherwise, which a sharp
    GGX pdf magnifies); radiance within the parity bar."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC

    ik, ip = sk.view(torch.int32), sp.view(torch.int32)
    for c in (MKC.PX, MKC.PY, MKC.SAMPLE, MKC.SLOT):
        assert bool((ik[:, c] == ip[:, c]).all()), c
    for c in (MKC.ALIVE, MKC.INSIDE, MKC.PREV_DELTA):
        assert int((ik[:, c] != ip[:, c]).sum()) <= 1e-4 * sk.shape[0], c
    gap = (sk[:, :MKC.BETA] - sp[:, :MKC.BETA]).abs()
    assert bool((gap <= 1e-5 * sp[:, :MKC.BETA].abs().clamp(min=1.0)).all())
    for c in (MKC.BETA, MKC.BETA + 1, MKC.BETA + 2, MKC.ETA_SCALE, MKC.PREV_PDF):
        rel = (sk[:, c] - sp[:, c]).abs() / sp[:, c].abs().clamp(min=1e-30)
        assert float((rel > 1e-5).float().mean()) <= 1e-2, c
        assert float((rel > 1e-3).float().mean()) <= 1e-3, c
    rad = slice(MKC.RADIANCE, MKC.RADIANCE + 3)
    diff = (sk[:, rad] - sp[:, rad]).abs()
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(1).values > 1e-3).float().mean()) < 0.005


@pytest.mark.parametrize("sampler", ["hash", "halton"])
def test_bounce_kernel_matches_bounce_step(dev, mesh, sampler):
    """Kernel 6 at depths 0-3, each launch in the order of the keys the
    last one wrote, dead paths included, against the plain bounce on the
    same rows; its keys are path_keys of its own rows."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC

    st = MKC.pack_path_state(*_camera_rays(dev, mesh, 4, sampler=sampler))
    perm = None
    for depth in range(4):
        sk, sp = st.clone(), st.clone()
        before = _launches("bounce_fused")
        kk = MKC.bounce_fused(mesh, sk, depth, seed=3, sampler=sampler, perm=perm)
        assert _launches("bounce_fused") == before + 1
        kp = MKC.bounce_plain(mesh, sp, depth, seed=3, sampler=sampler)
        torch.cuda.synchronize()
        _check_planes(sk, sp)
        assert torch.equal(kk, MKC.path_keys(mesh, sk))
        assert float((kk != kp).float().mean()) <= 1e-3
        dead = st.view(torch.int32)[:, MKC.ALIVE] == 0
        assert bool((sk[dead] == st[dead]).all())  # dead paths untouched
        st, perm = sk, MKC.sort_paths(kk)
    assert int((st.view(torch.int32)[:, MKC.ALIVE] == 0).sum()) > 0


@pytest.mark.parametrize("sampler", ["hash", "halton"])
def test_sorted_route_matches_fused(dev, mesh, sampler):
    """The depth-sorted route equals the fused kernel bit for bit, and both
    meet the parity bar."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC

    spp = 4
    px, py, sample, o, d = _camera_rays(dev, mesh, spp, sampler=sampler)
    before = _launches("bounce_fused")
    rs = MKC.trace_paths_fused_sorted(mesh, px, py, sample, o, d, max_depth=5, sampler=sampler)
    assert _launches("bounce_fused") == before + 5
    rf = MKC.trace_paths_fused(mesh, px, py, sample, o, d, max_depth=5, sampler=sampler)
    assert bool(torch.isfinite(rs).all()) and float(rs.mean()) > 0.0
    assert torch.equal(rs, rf)


# kernel 5 at sizes below one wave of its persistent grid and ragged
@pytest.mark.parametrize("n", [0, 1, 37, 4133])
def test_fused_bvh_any_launch_size(dev, mesh, n):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused

    px, py, sample, o, d = (x[:n] for x in _camera_rays(dev, mesh, 5))
    before = _launches("trace_paths_fused")
    rk = trace_paths_fused(mesh, px, py, sample, o, d, max_depth=5)
    assert rk.shape == (n, 3)
    assert _launches("trace_paths_fused") == before + (n > 0)
    rp = MK.trace_paths(mesh, MK.MegakernelConfig(max_depth=5, backend="torch"),
                        px, py, sample, o, d, device=dev)
    diff = (rk - rp).abs()
    assert bool(torch.isfinite(rk).all())
    if n:
        assert float(diff.mean()) < 1e-4
        assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005


def test_bvh_kernels_on_a_deeper_tree(dev):
    """Kernels 5 and 6 on a tree of depth 8 whose 396 KB of compact nodes
    exceed L1 (the mesh Cornell box at subdivision 128), against their plain
    versions, and bit for bit against each other."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh

    big = cornell_box_mesh(32, 32, subdiv=128, device=dev)
    assert big.bvh.depth >= 7 and big.bvh.nodes.numel() * 4 > 256 * 1024
    px, py, sample, o, d = _camera_rays(dev, big, 2)
    rk = MKC.trace_paths_fused(big, px, py, sample, o, d, max_depth=5)
    rp = MK.trace_paths(big, MK.MegakernelConfig(max_depth=5, backend="torch", tri_chunk=1024),
                        px, py, sample, o, d, device=dev)
    diff = (rk - rp).abs()
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005
    assert torch.equal(MKC.trace_paths_fused_sorted(big, px, py, sample, o, d, max_depth=5), rk)


def test_sorted_route_refuses_brute_force_scene(dev, scene):
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC

    px, py, sample, o, d = _camera_rays(dev, scene, 1)
    with pytest.raises(ValueError, match="BVH"):
        MKC.trace_paths_fused_sorted(scene, px, py, sample, o, d)
    with pytest.raises(ValueError, match="BVH"):
        MKC.bounce_fused(scene, MKC.pack_path_state(px, py, sample, o, d), 0)


def _key_copies() -> int:
    from cuda_optix_pathtracing_tpu_torch.utils import trace

    return trace.snapshot()["fused.key_copies"]


def _words32(k: torch.Tensor) -> torch.Tensor:
    """int32 keys holding the u32 values (low 32 bits) of int64 keys."""
    k = k & 0xFFFFFFFF
    return torch.where(k >= 2**31, k - 2**32, k).to(torch.int32)


# kernels 1 and 5 (1h and 4h with Halton) read int64 keys and a Python int
# sample in place, bit-equal to the same keys copied from int32: at n = 0,
# 1, one below a block of kernel 1 (128) and 65,536, on keys drawn over the
# whole int64 range, so at and above 2^31 and negative
@pytest.mark.parametrize("n", [0, 1, 127, 65_536])
@pytest.mark.parametrize("geo", ["brute", "bvh"])
@pytest.mark.parametrize("sampler", ["hash", "halton"])
def test_fused_keys_in_place_equal_copied(dev, scene, mesh, sampler, geo, n):
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused

    sc = mesh if geo == "bvh" else scene
    o, d = (x[:n] for x in _camera_rays(dev, sc, 64, sampler=sampler)[3:])
    g = torch.Generator().manual_seed(n)
    px, py, sample = (torch.randint(-2**63, 2**63 - 1, (n,), generator=g, dtype=torch.int64)
                      .to(dev) for _ in range(3))
    if n:
        px[0], py[0], sample[0] = 2**31, 2**32 - 1, -1
    s0 = 2**33 + 2**31 + 7  # a Python int whose low 32 bits are at and above 2^31

    def run(*keys):
        launched, copies = _launches("trace_paths_fused"), _key_copies()
        out = trace_paths_fused(sc, *keys, o, d, max_depth=5, seed=2**31 + 3, sampler=sampler)
        assert _launches("trace_paths_fused") == launched + (n > 0)
        return out, _key_copies() - copies

    in_place, c_in_place = run(px, py, sample)
    copied, c_copied = run(_words32(px), _words32(py), _words32(sample))
    scalar, c_scalar = run(px, py, s0)
    scalar_copied, _ = run(_words32(px), _words32(py),
                           _words32(torch.full((n,), s0, dtype=torch.int64, device=dev)))
    assert (c_in_place, c_copied, c_scalar) == (0, 3, 0)
    assert torch.equal(in_place, copied) and torch.equal(scalar, scalar_copied)
    assert in_place.shape == scalar.shape == (n, 3)
    if n > 1:
        assert not torch.equal(in_place, scalar)  # the sample key reaches the kernel


@pytest.mark.parametrize("geo,nspp", [("brute", 1), ("bvh", 4)])
def test_render_route_copies_no_key(dev, scene, mesh, geo, nspp):
    """render_sample_batch hands kernels 1 and 5 the camera kernel's keys
    in place (a Python int sample at one spp a pass, int64 keys at four):
    one fused launch a pass and no key copied."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    sc = mesh if geo == "bvh" else scene
    cfg = MK.MegakernelConfig(max_depth=3)
    launched, copies = _launches("trace_paths_fused"), _key_copies()
    img = MK.render_sample_batch(sc, cfg, 32, 32, 2**31 + 1, nspp=nspp)
    torch.cuda.synchronize()
    assert _launches("trace_paths_fused") == launched + 1
    assert _key_copies() == copies
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0


def test_bvh_wrappers_refuse_trees_the_kernels_cannot_walk(dev, mesh):
    """A tree deeper than the compact stack allows (depth 10) or of 2^24
    nodes is refused by every BVH wrapper before a launch, and the fused
    gate keeps such a scene off the fused kernel."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops.bvh import stack_fits

    o, d, t_max = _rays(dev, n=256)
    px, py, sample, co, cd = _camera_rays(dev, mesh, 1)
    assert stack_fits(9) and not stack_fits(10)
    deep = mesh._replace(bvh=mesh.bvh._replace(depth=10))
    huge = mesh._replace(bvh=mesh.bvh._replace(nodes=mesh.bvh.nodes[:1].expand(1 << 24, -1)))
    counters = (BV.bvh_closest_raw, BV.bvh_any_raw, MKC.trace_paths_fused, MKC.bounce_fused)
    before = [_launches(c.__name__) for c in counters]
    for bad, match in ((deep, "depth 10"), (huge, "2\\^24")):
        with pytest.raises(ValueError, match=match):
            BV.bvh_closest_raw(o, d, bad)
        with pytest.raises(ValueError, match=match):
            BV.bvh_any_raw(o, d, bad, t_max)
        with pytest.raises(ValueError, match=match):
            MKC.trace_paths_fused(bad, px, py, sample, co, cd, max_depth=2)
        with pytest.raises(ValueError, match=match):
            MKC.bounce_fused(bad, MKC.pack_path_state(px, py, sample, co, cd), 0)
    assert not MKC.megakernel_cuda_supported(deep, MegakernelConfig())
    assert [_launches(c.__name__) for c in counters] == before


def test_kernel_entry_points_return_launch_errors(dev, mesh, monkeypatch):
    """The C entry points of bvh.cu and megakernel.cu return a nonzero CUDA
    error for a launch that cannot start (a grid of 0 blocks; a sampler
    code that names no instantiation; more shared memory than a block can
    have), and the wrappers raise on a nonzero return."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV

    stream = torch.cuda.current_stream().cuda_stream
    blib = BV._lib()
    assert blib.bvh_closest(None, None, None, None, -1, None, None, stream) != 0
    assert blib.bvh_anyhit(None, None, None, None, None, -1, None, stream) != 0
    mlib = MKC._lib()
    z = [None] * 5
    k = [*z, 0, None]  # o, d, px, py, sample, sample0, the tables
    assert mlib.pt_fused_bruteforce(*k, 0, 1, 1, 0, 1, 0, 0, 7, 0, 0, None, None) != 0
    assert mlib.pt_fused_bruteforce(*k, 0, 1 << 20, 1, 0, 0, 0, 0, 0, 0, 0, None, None) != 0
    assert mlib.pt_fused_bvh(*k, None, None, None, 0, 1, 1, 0, 1, 0, 7, 0, 0,
                             None, None, None) != 0
    assert mlib.pt_bounce_bvh(*z, None, None, None, 0, 1, 1, 0, 1, 0, 7, 0, 0,
                              None, None) != 0
    torch.cuda.synchronize()  # the errors were launch errors: the card is fine
    o, d, t_max = _rays(dev, n=64)
    assert bool(torch.isfinite(BV.bvh_closest_raw(o, d, mesh)[0]).all())

    class Failing:
        def __getattr__(self, name):
            return lambda *args: 700

    for mod in (BV, MKC):
        monkeypatch.setattr(mod, "_lib", lambda: Failing())
    px, py, sample, co, cd = _camera_rays(dev, mesh, 1)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        BV.bvh_closest_raw(o, d, mesh)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        BV.bvh_any_raw(o, d, mesh, t_max)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        MKC.trace_paths_fused(mesh, px, py, sample, co, cd, max_depth=2)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        MKC.bounce_fused(mesh, MKC.pack_path_state(px, py, sample, co, cd), 0)


def test_textured_bvh_scene_kernel_route_matches_plain(dev):
    """scene_test.json (the textured teapot: 9,216 triangles and a BVH,
    shading normals, a normal map) at 32², 1 spp, depth 4: the kernel
    route (kernel 4, sorted) against backend='torch' at the parity bar;
    the fused kernels never run."""
    import dataclasses
    import os

    from cuda_optix_pathtracing_tpu_torch.models.megakernel import (
        MegakernelConfig,
        render_sample_batch,
        resolve_fused,
    )
    from cuda_optix_pathtracing_tpu_torch.scene.parser import parse_scene
    from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host

    path = os.path.join(os.path.dirname(__file__), "..", "scenes", "scene_test.json")
    hs, _ = parse_scene(path)
    hs.camera = dataclasses.replace(hs.camera, width=32, height=32)
    scene = scene_from_host(hs, device=dev)
    assert scene.bvh is not None and scene.textures is not None
    cfg = MegakernelConfig(max_depth=4)
    assert resolve_fused(scene, cfg).fused == "off"
    before = _launches("bvh_closest_raw"), _launches("bvh_any_raw"), _launches("trace_paths_fused")
    img_k = render_sample_batch(scene, cfg, 32, 32, 0)
    torch.cuda.synchronize()
    after = _launches("bvh_closest_raw"), _launches("bvh_any_raw"), _launches("trace_paths_fused")
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (4, 4, 0)
    img_p = render_sample_batch(scene, dataclasses.replace(cfg, backend="torch"), 32, 32, 0)
    diff = (img_k - img_p).abs()
    assert bool(torch.isfinite(img_k).all()) and float(img_k.mean()) > 0.0
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005


def _counts():
    torch.cuda.synchronize()
    return np.array([_launches("closest_bruteforce"), _launches("anyhit_bruteforce"),
                     _launches("bvh_closest_raw"), _launches("bvh_any_raw"),
                     _launches("trace_paths_fused")])


def _hold_kernel_route(scene, cfg, size, counts):
    """Render one spp on the kernel route (launches per kernel equal
    ``counts``: closest, any-hit, BVH closest, BVH any-hit, fused) and on
    ``backend="torch"``: the same image to the parity bar."""
    import dataclasses

    from cuda_optix_pathtracing_tpu_torch.models.megakernel import render_sample_batch, resolve_fused

    assert resolve_fused(scene, cfg).fused == "off"
    before = _counts()
    img_k = render_sample_batch(scene, cfg, size, size, 0)
    assert (_counts() - before).tolist() == list(counts)
    img_p = render_sample_batch(scene, dataclasses.replace(cfg, backend="torch"), size, size, 0)
    diff = (img_k - img_p).abs()
    assert bool(torch.isfinite(img_k).all()) and float(img_k.mean()) > 0.0
    assert float(diff.mean()) < 1e-4
    assert float((diff.max(-1).values > 1e-3).float().mean()) < 0.005


@pytest.mark.parametrize("use_bvh", [True, False])
def test_instanced_scene_kernel_route_matches_plain(dev, use_bvh):
    """The instanced Cornell box (walls, two sphere meshes: 3 instances):
    each query runs once per instance on its mesh's own tables (kernel 4
    with BVHs, kernels 2 and 3 without), and the image equals the plain
    sweep's to the parity bar."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh_instanced

    scene = cornell_box_mesh_instanced(32, 32, subdiv=8, use_bvh=use_bvh, device=dev)
    assert scene.instances.count == 3
    per = 3 * 3  # 3 instances × depth 3
    counts = (0, 0, per, per, 0) if use_bvh else (per, per, 0, 0, 0)
    _hold_kernel_route(scene, MegakernelConfig(max_depth=3), 32, counts)


@pytest.mark.parametrize("use_bvh", [True, False])
@pytest.mark.parametrize("splits", [1, 4])
def test_tree_scene_kernel_route_matches_plain(dev, use_bvh, splits):
    """A light-tree scene (``cornell_box_many_lights``: an 8×8 grid of
    emissive ceiling quads in the Cornell box, 129 finite records): one
    shadow query per live root of the split and bounce, and the image
    equals the plain sweep's to the parity bar."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights

    scene = cornell_box_many_lights(32, 32, subdiv=8, use_bvh=use_bvh, device=dev)
    assert scene.light_tree is not None and scene.light_tree.n_records == 129
    live = sum(r >= 0 for r in scene.light_tree.frontiers[{1: 0, 4: 2}[splits]])
    depth = 3
    counts = ((0, 0, depth, depth * live, 0) if use_bvh else (depth, depth * live, 0, 0, 0))
    _hold_kernel_route(scene, MegakernelConfig(max_depth=depth, nee_splits=splits), 32, counts)


# ---- gradients (models/differentiable.py) --------------------------------------


def _grad_rays(dev, n=4096):
    o, d, t_max = _rays(dev, n)
    return o.requires_grad_(True), d.requires_grad_(True), t_max


@pytest.mark.parametrize("kernel", ["closest", "anyhit", "bvh_closest", "bvh_anyhit"])
def test_backward_through_wrapped_kernels(dev, scene, mesh, kernel):
    """Each kernel wrapped in nondiff_kernel, called on rays that require
    grad: one launch, outputs equal to a call without grad, integer and
    bool outputs without grad. Closest hit: backward runs through the
    kernel, zero and finite gradients to the rays, and d/dscale of
    sum(scale * t) over the hits is sum(t). Any hit: a weight selected by
    the flags gets its gradient, and no gradient reaches the rays."""
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops import intersect_cuda as IC

    o, d, t_max = _grad_rays(dev)
    tri = (scene.tri_v0, scene.tri_e0, scene.tri_e1)
    call = {
        "closest": (IC.closest_bruteforce, lambda o, d: IC.closest_bruteforce(o, d, *tri)),
        "anyhit": (IC.anyhit_bruteforce, lambda o, d: IC.anyhit_bruteforce(o, d, *tri, t_max)),
        "bvh_closest": (BV.bvh_closest_raw, lambda o, d: BV.bvh_closest_raw(o, d, mesh)),
        "bvh_anyhit": (BV.bvh_any_raw, lambda o, d: BV.bvh_any_raw(o, d, mesh, t_max)),
    }
    wrapper, fn = call[kernel]
    with torch.no_grad():
        want = fn(o, d)
    before = _launches(wrapper.__name__)
    got = fn(o, d)
    assert _launches(wrapper.__name__) == before + 1
    scale = torch.tensor(2.0, device=dev, requires_grad=True)
    if kernel.endswith("closest"):
        t, i = got
        assert torch.equal(t, want[0]) and torch.equal(i, want[1])
        assert t.requires_grad and not i.requires_grad
        hit_t = torch.where(t < 1e30, t, 0.0)
        (scale * hit_t).sum().backward()
        expect = float(hit_t.detach().sum())
        assert abs(float(scale.grad) - expect) < 1e-3 * max(1.0, abs(expect))
        for x in (o, d):
            assert x.grad is not None and bool(torch.isfinite(x.grad).all())
            assert not bool(x.grad.any())
    else:
        assert torch.equal(got, want) and not got.requires_grad
        (scale * (got > 0).float()).sum().backward()
        assert float(scale.grad) == float((want > 0).sum())
        assert o.grad is None and d.grad is None


@pytest.mark.parametrize("case", ["cornell", "mesh"])
def test_kernel_route_gradients_match_plain(dev, scene, mesh, case):
    """The albedo gradient down the kernel route (kernels 2 and 3, or the
    sorted route over kernel 4) equals backend='torch''s, both with path
    replay; each kernel runs in the forward pass and again in the replay."""
    from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops import intersect_cuda as IC

    sc = scene if case == "cornell" else mesh
    counted = (IC.closest_bruteforce, IC.anyhit_bruteforce) if case == "cornell" else (
        BV.bvh_closest_raw, BV.bvh_any_raw)
    target = torch.zeros((32, 32, 3), device=dev)
    grads = {}
    for backend in ("auto", "torch"):
        loss = D.make_loss(sc, MegakernelConfig(max_depth=3, backend=backend), 32, 32, 2,
                           target, spp_per_pass=2)
        params = D.init_params(sc, ("albedo", "light_color"))
        before = [_launches(c.__name__) for c in counted]
        loss(params).backward()
        torch.cuda.synchronize()
        made = [_launches(c.__name__) - b for c, b in zip(counted, before)]
        assert made == ([6, 6] if backend == "auto" else [0, 0]), made
        grads[backend] = params
    for key in ("albedo", "light_color"):
        gk, gp = grads["auto"][key].grad, grads["torch"][key].grad
        assert bool(gp.any()) and bool(torch.isfinite(gk).all())
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-9)


# ---- slice 6: sharded render, wavefronts, NaN guard ------------------------


def test_sharded_blocks_match_one_block(dev, scene):
    """Two shard blocks of a Cornell render at 32², concatenated, equal the
    one-block render bit for bit (kernels 2 and 3, no fused kernel)."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.parallel.render import Mesh, render_sharded

    cfg = MegakernelConfig(max_depth=3, remat=False)
    before = (_launches("closest_bruteforce"), _launches("trace_paths_fused"))
    one = render_sharded(scene, cfg, 32, 32, 2, Mesh(1, 0))
    two = [render_sharded(scene, cfg, 32, 32, 2, Mesh(2, k)) for k in range(2)]
    torch.cuda.synchronize()
    assert _launches("closest_bruteforce") - before[0] == 3 * 2 * 3
    assert _launches("trace_paths_fused") == before[1]
    assert torch.equal(torch.cat([b.mean for b in two]), one.mean)
    assert torch.equal(torch.cat([b.m2 for b in two]), one.m2)
    assert bool(torch.isfinite(one.mean).all()) and float(one.mean.mean()) > 0.0


@pytest.mark.parametrize("case", ["cornell", "mesh"])
def test_dense_wavefront_matches_unfused_render(dev, scene, mesh, case):
    """The dense wavefront's film equals ``render(fused="off")``'s bit for
    bit at 32² (kernels 2 and 3, or the sorted route over kernel 4)."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render
    from cuda_optix_pathtracing_tpu_torch.models.wavefront import WavefrontConfig, render_wavefront

    sc = scene if case == "cornell" else mesh
    kw = dict(max_depth=4, pixel_order="linear")
    a = render(sc, 32, 32, 2, cfg=MegakernelConfig(fused="off", **kw), kspp=2)
    b = render_wavefront(sc, 32, 32, 2, cfg=WavefrontConfig(**kw), kspp=2)
    assert torch.equal(a.mean, b.mean) and torch.equal(a.m2, b.m2)


def test_pool_wavefront_matches_render(dev, scene):
    """The regenerating pool at 32² (512 lanes) within the reference's bar
    of ``render(fused="off")`` (mean 3e-5, M2 3e-4)."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render
    from cuda_optix_pathtracing_tpu_torch.models.wavefront import (
        WavefrontConfig,
        render_pool_wavefront,
    )

    a = render(scene, 32, 32, 4, cfg=MegakernelConfig(max_depth=4, fused="off"), kspp=4)
    before = _launches("anyhit_bruteforce")
    b = render_pool_wavefront(scene, 32, 32, 4, cfg=WavefrontConfig(max_depth=4), pool=512)
    torch.cuda.synchronize()
    assert _launches("anyhit_bruteforce") > before
    torch.testing.assert_close(b.mean, a.mean, rtol=0, atol=3e-5)
    torch.testing.assert_close(b.m2, a.m2, rtol=0, atol=3e-4)
    assert float(b.n) == 4


def test_nan_guard_on_the_card(dev, scene):
    from cuda_optix_pathtracing_tpu_torch.models.differentiable import inject_params
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render

    cfg = MegakernelConfig(max_depth=2, fused="off", debug=True)
    film = render(scene, 32, 32, 1, cfg=cfg, kspp=1)
    assert bool(torch.isfinite(film.mean).all())
    albedo = scene.materials.albedo.clone()
    albedo[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN guard"):
        render(inject_params(scene, {"albedo": albedo}), 32, 32, 1, cfg=cfg, kspp=1)


CAMERA_SEED = 2**31 + 12_345  # a large seed, as the benchmark's are


def _same(a, b):
    """Equal values and dtype, bit for bit (tensors) or equal (ints)."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return not torch.is_tensor(b) and a == b


@pytest.mark.parametrize("base", [7, 2**32 - 5])  # the second wraps sample ^ seed past 2^32
@pytest.mark.parametrize("nspp", [1, 16])
@pytest.mark.parametrize("order,size", [("morton", (32, 32)), ("linear", (32, 32)),
                                        ("linear", (40, 24))])
@pytest.mark.parametrize("sampler", ["hash", "halton"])
def test_camera_kernel_matches_plain(dev, scene, sampler, order, size, nspp, base):
    """The camera kernel's keys and rays equal the plain route's bit for
    bit (px, py, sample, o and d, dtypes too), in one launch a pass."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    w, h = size
    cfg = MK.MegakernelConfig(sampler=sampler, seed=CAMERA_SEED, pixel_order=order)
    before = _launches("camera_rays")
    got = MK.camera_batch(scene, cfg, w, h, base, nspp)
    torch.cuda.synchronize()
    assert _launches("camera_rays") == before + 1
    want = MK.camera_plain(scene, cfg, w, h, base, nspp)
    assert _launches("camera_rays") == before + 1
    names = ("px", "py", "sample", "o", "d")
    for name, a, b in zip(names, got[:5], want[:5]):
        assert _same(a, b), name
    assert got[5] is None and want[5] is None
    assert got[6] == want[6] == (order == "morton")
    assert got[3].shape == (max(nspp, 1) * w * h, 3)


def test_camera_kernel_one_launch_a_pass(dev, scene, mesh):
    """A render pass launches the camera kernel once (one spp a pass on
    the Cornell box, 16 spp in one pass on the mesh); the Mitchell filter
    and a tensor sample stay on the plain route; an empty image launches
    nothing."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    cfg = MK.MegakernelConfig(max_depth=2)
    for sc, nspp in ((scene, 1), (mesh, 16)):
        before = _launches("camera_rays")
        img = MK.render_sample_batch(sc, cfg, 32, 32, 3, nspp=nspp)
        assert _launches("camera_rays") == before + 1
        assert bool(torch.isfinite(img).all())
    before = _launches("camera_rays")
    mitchell = MK.MegakernelConfig(pixel_filter="mitchell")
    MK.camera_batch(scene, mitchell, 32, 32, 0)
    MK.camera_batch(scene, cfg, 32, 32, torch.tensor(0, device=dev))
    px, py, sample, o, d, fw, morton = MK.camera_batch(scene, cfg, 0, 32, 5, nspp=4)
    assert _launches("camera_rays") == before
    assert px.shape == (0,) and o.shape == (0, 3) and sample.shape == (0,)


def test_camera_kernel_entry_point_errors(dev, scene, monkeypatch):
    """pt_camera_rays returns a nonzero CUDA error for a sampler code that
    names no instantiation, negative sizes and Morton order on an image
    that is not a power-of-two square; the wrapper raises on a nonzero
    return and refuses a CPU scene."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    stream = torch.cuda.current_stream().cuda_stream
    lib = MKC._lib()
    z = [None] * 5
    for args in ((4, 4, 1, 0, 0, 7), (-1, 4, 1, 0, 0, 0), (4, 4, -1, 0, 0, 0),
                 (6, 6, 1, 1, 0, 0), (8, 4, 1, 1, 0, 0)):
        w, h, nspp, morton, base, code = args
        assert lib.pt_camera_rays(None, None, w, h, nspp, morton, base, code, 0, 12,
                                  *z, stream) != 0
    torch.cuda.synchronize()

    class Failing:
        def __getattr__(self, name):
            return lambda *args: 700

    monkeypatch.setattr(MKC, "_lib", lambda: Failing())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        MKC.camera_rays_fused(scene, 32, 32, 0)
    with pytest.raises(ValueError, match="CUDA scene"):
        MKC.camera_rays_fused(cornell_box(8, 8, device="cpu"), 8, 8, 0)

"""The upstream's textured teapot (``scenes/scene_test.json``) against the
benchmark's scene builder and plain textured reference, on the CPU.

- The scene builder ``pt_bench/scenes/scene_file.py`` gives the port the
  scene its parser gives: ``to_host_scene`` equals ``parse_scene`` on
  ``scenes/scene_test.json`` array for array.
- The plain reference ``pt_bench/reference/textured.py`` computes the
  port's estimator: the file's scene with the camera reset to 16², depth
  12, 2 samples, the port's plain route (``fused="off"``,
  ``backend="torch"``) against ``textured.pixel_samples`` on the same hash
  keys, to a bar tighter than the port's parity bar against JAX (the two
  agree bit for bit here): mean abs diff < 1e-7 and fewer than 0.5 % of
  pixels off by more than 1e-5. At 16² a pixel's ray cone covers a coarse
  mip of the normal map, so skipping it moves the image by ~2e-6 a pixel,
  which the JAX bar would let through.
- Each of three faults planted in the port (normal map skipped, every
  texture LOD forced to 0, the roughness map ignored) fails that bar, and
  the benchmark's render comparison (``pt_bench.check``) under the limits
  of the cell ``scene_test_d12_render`` reads a two-batch render as
  correct, and each fault as not correct.
- ``textured`` holds to the contract of ``pt_bench/reference/__init__.py``
  at 4×4 in float32 and bfloat16.

The file's environment image (``res/envLight/autumn_field_puresky_4k.png``)
is not in the repository, so here, as in the cell, the parser's constant
environment stands in.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.ops.film import film_new
from cuda_optix_pathtracing_tpu_torch.scene.parser import parse_scene
from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene, scene_from_host
from pt_bench import check, harness
from pt_bench.scenes import scene_file

torch.set_num_threads(2)

SIZE, DEPTH, SPP = 16, 12, 2
SEED = 2**31 + 7
CHUNK = 1024  # triangles per step of the port's plain sweep (the hits do not depend on it)
CELL = harness.load_cell("scene_test_d12_render")
# the cell's configuration with the image cut to SIZE², its mix cut to two
# progressive batches of SPP samples with every pixel checked, and its limits
CONFIG = dict(CELL.config, width=SIZE, height=SIZE)
MIX = dict(CELL.mix, kspp=SPP, spp_per_pass=SPP, check_pixels=SIZE * SIZE)
LIMITS = CELL.limits


@pytest.fixture(scope="module")
def ref_mod():
    return CELL.reference


@pytest.fixture(scope="module")
def spec():
    return scene_file.build(CONFIG)


@pytest.fixture(scope="module")
def port_scene(spec):
    scene = scene_from_host(scene_file.to_host_scene(spec, HostScene), device="cpu")
    assert scene.bvh is not None and scene.textures is not None and scene.tri_ns is not None
    return scene


def _no_roughness(orig):
    def textured_mat(scene, cfg, mat, hit, suv, cone_w, wo):
        out = orig(scene, cfg, mat, hit, suv, cone_w, wo)
        return out._replace(alphax=mat.alphax, alphay=mat.alphay, on_sigma=mat.on_sigma)

    return textured_mat


# fault → (attribute of models/megakernel, its replacement given the original)
FAULTS = {
    "normal_map_skipped": ("_normal_mapped", lambda orig: lambda scene, mat, hit, suv, ns, w: ns),
    "lod_zero": ("raycone_lod", lambda orig: lambda pool, tex, width, dens: torch.zeros_like(width)),
    "roughness_ignored": ("_textured_mat", _no_roughness),
}
CASES = [None, *FAULTS]


def _plant(monkeypatch, fault):
    if fault is not None:
        name, broken = FAULTS[fault]
        monkeypatch.setattr(MK, name, broken(getattr(MK, name)))


def _cfg():
    return MK.MegakernelConfig(max_depth=DEPTH, remat=False, fused="off",
                               backend="torch", seed=SEED, tri_chunk=CHUNK)


def test_builder_gives_the_parsers_scene(spec):
    ours = scene_file.to_host_scene(dataclasses.replace(
        spec, camera=dict(spec.camera, width=256, height=256)), HostScene)
    theirs, parsed = parse_scene(str(scene_file.ROOT / "scenes" / "scene_test.json"))
    assert (parsed.width, parsed.height, parsed.max_depth, parsed.spp) == (256, 256, 12, 32)
    cfg, mix = CELL.config, CELL.mix  # the cell renders the file's own settings
    assert (cfg["width"], cfg["height"], cfg["max_depth"], mix["kspp"]) == (256, 256, 12, 32)
    assert len(ours.triangles) == cfg["triangles"] and DEPTH == cfg["max_depth"]
    for name in ("triangles", "tri_uv", "tri_ns"):
        a, b = np.stack(getattr(ours, name)), np.stack(getattr(theirs, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(ours.triangles) == 9216 and ours.tri_mat == theirs.tri_mat
    assert len(ours.textures) == len(theirs.textures) == 3
    for a, b in zip(ours.textures, theirs.textures):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for rows_a, rows_b in ((ours.materials, theirs.materials), (ours.lights, theirs.lights)):
        assert len(rows_a) == len(rows_b)
        for a, b in zip(rows_a, rows_b):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert [li["ltype"] for li in ours.lights] == [0, 1]  # the placed point light, the spot
    assert ours.env_color == theirs.env_color == scene_file.MISSING_ENV
    assert ours.env_image is None and theirs.env_image is None
    assert ours.camera == theirs.camera


def _parity(ref, ours) -> bool:
    diff = np.abs(ref - ours) / SPP
    assert np.isfinite(ours).all()
    return bool(diff.mean() < 1e-7 and (diff.max(-1) > 1e-5).mean() < 0.005)


@pytest.mark.parametrize("fault", CASES, ids=lambda f: f or "sound")
def test_reference_matches_the_port(ref_mod, spec, port_scene, monkeypatch, fault):
    assert ref_mod.__name__.endswith(".textured")
    ys, xs = torch.meshgrid(torch.arange(SIZE), torch.arange(SIZE), indexing="ij")
    ref = ref_mod.pixel_samples(ref_mod.make_scene(spec, "cpu"), ref_mod.SAMPLERS["hash"](SEED),
                                xs.reshape(-1), ys.reshape(-1), 0, SPP, DEPTH)
    ref = ref.reshape(SPP, SIZE, SIZE, 3).sum(0).numpy()
    _plant(monkeypatch, fault)
    ours = MK.render_sample_batch(port_scene, _cfg(), SIZE, SIZE, 0, nspp=SPP).sum(0).numpy()
    assert _parity(ref, ours) is (fault is None), fault
    assert ours.mean() > 1e-3  # the teapot and its lights show


@pytest.mark.parametrize("fault", CASES, ids=lambda f: f or "sound")
def test_cell_comparison_reads_faults(ref_mod, spec, port_scene, monkeypatch, fault):
    """Two progressive batches of SPP samples, both checked, as a render
    cell checks its window's batches."""
    _plant(monkeypatch, fault)
    film, kept = film_new(SIZE, SIZE, "cpu"), []
    for k in range(2):
        new = MK.render_progressive(port_scene, film, _cfg(), SIZE, SIZE, k * SPP, SPP, SPP,
                                    device="cpu")
        kept.append((k * SPP, film if k else None, new))
        film = new
    numbers = check.render_numbers(ref_mod, spec, CONFIG, MIX, SEED, kept, "cpu")
    correct, checks = check.verdict(numbers, LIMITS)
    assert set(checks) == {"film_gap_p99", "film_count_gap"}
    assert correct is (fault is None), checks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_reference_meets_the_contract(ref_mod, spec, dtype):
    spec = dataclasses.replace(spec, camera=dict(spec.camera, width=4, height=4))
    scene = ref_mod.make_scene(spec, "cpu", dtype)
    for x in (scene.v0, scene.e0, scene.e1):
        assert x.shape == (9216, 3) and x.dtype == dtype
    assert scene.pool.texels.dtype == dtype and scene.materials.albedo.is_floating_point()
    sampler = ref_mod.SAMPLERS[CONFIG["sampler"]](2**31 + 5, dtype)
    px, py = torch.arange(16) % 4, torch.arange(16) // 4

    w = ref_mod.Work(keep_rays=True)
    rad = ref_mod.pixel_samples(scene, sampler, px, py, 0, 2, DEPTH, work=w)
    assert rad.shape == (2, 16, 3) and rad.dtype == dtype and bool(torch.isfinite(rad).all())
    assert w.paths == 32 and w.closest_rays >= w.paths and 0 < w.hits <= w.closest_rays
    assert w.shadow_rays <= w.hits and w.shadow_tests >= 0
    assert sum(o.shape[0] for o, _ in w.closest) == w.closest_rays
    assert sum(o.shape[0] for o, _, _ in w.shadow) == w.shadow_rays

    (mean, m2, n), bmean = ref_mod.film_batch(scene, sampler, px, py, 0, 2, 2, DEPTH)
    assert mean.shape == m2.shape == bmean.shape == (16, 3) and float(n) == 2.0
    film, _ = ref_mod.film_batch(scene, sampler, px, py, 2, 2, 2, DEPTH, before=(mean, m2, n))
    assert float(film[2]) == 4.0 and bool(torch.isfinite(film[0]).all())

    leaf = scene.materials.albedo.detach().clone().requires_grad_(True)
    loss = ref_mod.image_loss(scene, sampler, leaf, 0, 1, 4, 4, 2, 0.0)
    assert isinstance(loss, float) and math.isfinite(loss) and loss > 0.0
    assert leaf.grad.shape == leaf.shape and bool(torch.isfinite(leaf.grad).all())

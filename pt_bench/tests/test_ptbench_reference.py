"""A configuration names its own plain reference: the harness compares a
cell, and counts its work, against the module of ``pt_bench/reference``
that the configuration's ``reference`` names, ``integrator`` where it
names none, and refuses a configuration whose sampler that module does
not give. Each reference a configuration of ``BENCHMARK.json`` names meets
the contract of ``pt_bench/reference/__init__.py``."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from pt_bench import harness
from pt_bench.reference import integrator as plain_integrator

from .ptbench_cells import ROOT, TINY, add_cell, add_config, make_root

SCALED_BY = 1.01
# configuration → its reference; cell → (configuration, traffic mix, real cell)
CONFIGS = {"tiny_echo": "echo", "tiny_scaled": "scaled"}
CELLS = {
    "tiny_echo.render": ("tiny_echo", "tiny_render", "cornell256_d5_render"),
    "tiny_echo.grad": ("tiny_echo", "tiny_grad", "cornell256_d5_grad"),
    "tiny_scaled.render": ("tiny_scaled", "tiny_render", "cornell256_d5_render"),
    "tiny_scaled.grad": ("tiny_scaled", "tiny_grad", "cornell256_d5_grad"),
}
ECHO = ('"""The integrator under another name."""\n\n'
        "from .integrator import SAMPLERS, Work, film_batch, image_loss, make_scene, "
        "pixel_samples  # noqa: F401\n")
RETURN = "    return torch.cat(out).reshape(nspp, px.shape[0], 3)\n"
# each configuration of the manifest → the first cell that runs it
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
FIRST_CELL = {c["name"]: next(w["name"] for w in MANIFEST["workloads"]
                              if w["config"] == c["name"]) for c in MANIFEST["configs"]}


def _scaled_source() -> str:
    """The integrator with ``pixel_samples``' radiance scaled by 1.01, so
    that ``film_batch`` and ``image_loss`` see it too."""
    src = (ROOT / "pt_bench" / "reference" / "integrator.py").read_text()
    assert src.count(RETURN) == 1
    return src.replace(RETURN, RETURN.rstrip("\n") + f" * {SCALED_BY}\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("bench"))
    ref = root / "pt_bench" / "reference"
    (ref / "echo.py").write_text(ECHO)
    (ref / "scaled.py").write_text(_scaled_source())
    for name, module in CONFIGS.items():
        add_config(root, name, dict(TINY, reference=module))
    add_config(root, "tiny_halton", dict(TINY, sampler="halton"))
    add_config(root, "tiny_absent", dict(TINY, reference="absent"))
    for cell, (config, mix, real) in CELLS.items():
        add_cell(root, cell, config, mix, real)
    add_cell(root, "tiny_halton.render", "tiny_halton", "tiny_render", "cornell256_d5_render")
    add_cell(root, "tiny_absent.render", "tiny_absent", "tiny_render", "cornell256_d5_render")
    return root


def test_default_reference_is_the_integrator(root):
    cell = harness.load_cell("tiny.render", root)
    ref = cell.reference
    assert Path(ref.__file__) == root / "pt_bench" / "reference" / "integrator.py"
    assert ref.__name__.endswith(".integrator") and ref.make_scene.__module__ == ref.__name__
    # resolved once a process: every cell of the root holds the same module
    assert harness.load_cell("tiny.grad", root).reference is ref
    # the real cells' configurations name none, and get the checkout's own
    real = harness.load_cell("cornell256_d5_render").reference
    assert Path(real.__file__) == ROOT / "pt_bench" / "reference" / "integrator.py"
    assert harness.load_cell("mesh256_d5_off").reference is real
    # the module loaded from the file computes what the imported one does
    spec, _ = harness.scene_spec(cell)
    px, py = torch.arange(8), torch.arange(8) % 3
    got = real.pixel_samples(real.make_scene(spec, "cpu"), real.SAMPLERS["hash"](5), px, py,
                             0, 2, 3)
    want = plain_integrator.pixel_samples(plain_integrator.make_scene(spec, "cpu"),
                                          plain_integrator.SAMPLERS["hash"](5), px, py, 0, 2, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["tiny_echo.render", "tiny_echo.grad"])
def test_named_reference_runs_and_is_correct(root, cell):
    assert harness.load_cell(cell, root).reference.__name__.endswith(".echo")
    r = harness.run(cell, 2**31 + 21, 0.5, False, device="cpu", root=root)
    assert r["correct"] is True, r["checks"]
    assert not harness.forbidden_modules()


@pytest.mark.parametrize("cell", ["tiny_scaled.render", "tiny_scaled.grad"])
def test_comparison_reads_the_named_reference(root, cell):
    r = harness.run(cell, 2**31 + 21, 0.5, False, device="cpu", root=root)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell, words", [
    ("tiny_halton.render", ("sampler", "'halton'", "'integrator'")),
    ("tiny_absent.render", ("reference", "'absent'")),
])
def test_load_cell_refuses_what_the_reference_cannot_give(root, cell, words):
    with pytest.raises(ValueError) as e:
        harness.load_cell(cell, root)
    assert all(w in str(e.value) for w in words), str(e.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("config", sorted(FIRST_CELL))
def test_manifest_references_meet_the_contract(config, dtype):
    cell = harness.load_cell(FIRST_CELL[config])
    cell = dataclasses.replace(cell, config=dict(cell.config, width=4, height=4))
    cfg, ref = cell.config, cell.reference
    spec, _ = harness.scene_spec(cell)
    scene = ref.make_scene(spec, "cpu", dtype)
    tris = spec.tris.shape[0]
    for x in (scene.v0, scene.e0, scene.e1):
        assert x.shape == (tris, 3) and x.dtype == dtype
    assert scene.materials.albedo.is_floating_point()
    sampler = ref.SAMPLERS[cfg["sampler"]](2**31 + 5, dtype)
    px, py = torch.arange(16) % 4, torch.arange(16) // 4
    depth = cfg["max_depth"]

    w = ref.Work(keep_rays=True)
    rad = ref.pixel_samples(scene, sampler, px, py, 0, 2, depth, work=w)
    assert rad.shape == (2, 16, 3) and rad.dtype == dtype and bool(torch.isfinite(rad).all())
    assert w.paths == 32 and w.closest_rays >= w.paths and 0 < w.hits <= w.closest_rays
    assert w.shadow_rays <= w.hits and w.shadow_tests >= 0
    assert sum(o.shape[0] for o, _ in w.closest) == w.closest_rays
    assert sum(o.shape[0] for o, _, _ in w.shadow) == w.shadow_rays

    for per_pass in (1, 2):
        (mean, m2, n), bmean = ref.film_batch(scene, sampler, px, py, 0, 2, per_pass, depth)
        assert mean.shape == m2.shape == bmean.shape == (16, 3) and float(n) == 2.0
        film, _ = ref.film_batch(scene, sampler, px, py, 2, 2, per_pass, depth,
                                 before=(mean, m2, n))
        assert float(film[2]) == 4.0 and bool(torch.isfinite(film[0]).all())

    leaf = scene.materials.albedo.detach().clone().requires_grad_(True)
    loss = ref.image_loss(scene, sampler, leaf, 0, 1, 4, 4, depth, 0.0)
    assert isinstance(loss, float) and math.isfinite(loss) and loss > 0.0
    assert leaf.grad.shape == leaf.shape and bool(torch.isfinite(leaf.grad).all())

"""The harness on the CPU at a tiny size: cells added from files alone
run through its loader and a whole run, the metric arithmetic, the plain
BVH's work counts, and what the benchmark imports."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pt_bench import harness, stats, work
from pt_bench.reference import geometry

from .ptbench_cells import ROOT, make_root

FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "cuda_optix_pathtracing_tpu", "bench_torch",
                 "chip_smoke"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _imports(path: Path) -> set:
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_nothing_forbidden():
    for path in (ROOT / "pt_bench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN_TOP, path


def test_reference_imports_nothing_of_the_port():
    ref = ROOT / "pt_bench" / "reference"
    for path in ref.glob("*.py"):
        assert "cuda_optix_pathtracing_tpu_torch" not in _imports(path), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, (path, "reaches outside the reference")
    code = ("import sys, torch; from pt_bench.scenes import cornell; "
            "from pt_bench.reference import integrator as RI, rng as RR; "
            "spec = cornell.build(dict(width=4, height=4, sphere_lat=2, sphere_lon=4)); "
            "s = RI.make_scene(spec, 'cpu'); "
            "RI.pixel_samples(s, RR.HashSampler(3), torch.arange(4), torch.arange(4), 0, 1, 2); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "cuda_optix_pathtracing_tpu_torch" not in out
    assert not set(json.loads(out.replace("'", '"'))) & FORBIDDEN_TOP


@pytest.mark.parametrize("cell", ["tiny.render", "tiny.render_pass", "tiny.grad"])
def test_cell_from_files_alone_runs(root, cell):
    r = harness.run(cell, 2**31 + 11, 0.5, False, device="cpu", root=root)
    loaded = harness.load_cell(cell, root)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in loaded.end_to_end}
    assert list(r)[-1] == "checks"
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert not harness.forbidden_modules()


def test_traced_run_reads_per_layer_metrics(root):
    r = harness.run("tiny.render", 5, 0.5, True, device="cpu", root=root)
    assert r["correct"] is True
    # no device on the CPU: only the host-clock readers find something to read
    assert set(r["metrics"]) == {"scene_build_s", "kernel_load_s", "mpaths_s.2s"}
    assert r["metrics"]["mpaths_s.2s"]["value"] > 0
    assert "device_ops" in r["breakdown"] and "window_s" in r["device"]


def test_rate_stretch_moves_no_other_reading(root, monkeypatch):
    # one batch or a second of them before the traced window: the windows
    # after it render the same samples, and the checks read the same
    runs, traffic = [], []
    for seconds in (0.0, 1.0):
        monkeypatch.setattr(harness, "RATE_SECONDS", seconds)
        runs.append(harness.run("tiny.render", 9, 0.5, True, device="cpu", root=root,
                                traffic_hook=traffic.append))
    assert traffic[0].sample == traffic[1].sample
    assert runs[0]["checks"] == runs[1]["checks"]
    assert runs[0]["attempted"] == runs[1]["attempted"]


def test_manifest_metrics_have_readers_and_move_what_their_cells_report():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in manifest["workloads"]]
    for cell in cells:
        loaded = harness.load_cell(cell)
        reported = {m["name"] for m in loaded.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert loaded.per_layer, cell
        for m in loaded.per_layer:
            assert m["moves"] in reported, (cell, m["name"])
    for m in manifest["per_layer"]:
        assert (ROOT / "pt_bench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= set(cells), m["name"]


@pytest.mark.parametrize("kind, paths, seconds, want", [
    ("render", 8_000_000, 2.0, 4.0), ("render", 0, 2.0, 0.0), ("render", 10, 0.0, None),
    ("grad", 8_000_000, 2.0, None)])
def test_rate_of_the_untraced_stretch(kind, paths, seconds, want):
    reader = harness._module(ROOT / "pt_bench" / "metrics" / "mpaths_s.2s.py", "rate_reader")
    rec = harness.TraceRecord(kind, 1, 1, 1, 1.0, None, None, 0.0, 0.0, paths, seconds)
    assert reader.read(rec) == want


def test_run_imports_nothing_forbidden(root):
    code = ("import sys, pathlib; from pt_bench import harness; "
            "harness.run('tiny.render', 1, 0.2, False, device='cpu', "
            f"root=pathlib.Path({str(root)!r})); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"


def test_run_py_refuses_without_a_card():
    r = subprocess.run([sys.executable, "pt_bench/run.py", "--workload", "cornell256_d5_render",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert r.returncode == 2 and r.stdout == ""


def test_rate_is_over_the_whole_window():
    # 10 batches of 1,000 paths in a 2.5 s window, however the batches split it
    assert stats.rate(10 * 1000, 2.5) == 4000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_moves_when_one_batch_stalls():
    lat = [0.010] * 19 + [0.011]
    assert stats.percentile(lat, 95) == 0.010
    stalled = list(lat)
    stalled[3] = 0.5
    assert stats.percentile(stalled, 95) == 0.011
    stalled[7] = 0.5
    assert stats.percentile(stalled, 95) == 0.5
    assert stats.percentile([3.0, 1.0, 2.0], 100) == 3.0


def _quad():
    """The unit square in z = 0 as two triangles: A (0,0)-(1,0)-(1,1) and
    B (0,0)-(1,1)-(0,1)."""
    p = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float64)
    tris = np.array([[p[0], p[1], p[2]], [p[0], p[2], p[3]]])
    return tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]


@pytest.mark.parametrize("xy, t_max, want", [
    # one leaf holds both: the root's box, then both triangles
    ((0.25, 0.75), None, (1, 2)),
    ((2.0, 2.0), None, (1, 0)),  # misses the root's box
])
def test_bvh_work_one_leaf(xy, t_max, want):
    v0, e0, e1 = _quad()
    bvh = work.build_bvh(v0, e0, e1)
    o = np.array([[xy[0], xy[1], 1.0]])
    d = np.array([[0.0, 0.0, -1.0]])
    assert work.walk(bvh, v0, e0, e1, o, d, t_max) == want


@pytest.mark.parametrize("xy, t_max, want", [
    # leaves of one triangle: the split along x puts B (centroid x 1/3)
    # left and A right; both child boxes are the whole square, so every
    # ray that enters tests root + 2 boxes. In B: B hits at t = 1 first
    # and A (entered at t = 1, not nearer) is skipped
    ((0.25, 0.75), None, (3, 1)),
    # in A: B is tested first and missed, then A
    ((0.75, 0.25), None, (3, 2)),
    # a shadow ray in A stops at A, its second test
    ((0.75, 0.25), 2.0, (3, 2)),
    # a shadow ray in B stops at its first test
    ((0.25, 0.75), 2.0, (3, 1)),
    # a shadow ray ending before the square enters nothing past the root
    ((0.25, 0.75), 0.5, (1, 0)),
])
def test_bvh_work_hand_counts(xy, t_max, want):
    v0, e0, e1 = _quad()
    bvh = work.build_bvh(v0, e0, e1, leaf=1)
    assert (len(bvh.lo), list(bvh.count)) == (3, [0, 1, 1])
    assert list(bvh.order) == [1, 0]
    o = np.array([[xy[0], xy[1], 1.0]])
    d = np.array([[0.0, 0.0, -1.0]])
    tm = None if t_max is None else np.array([t_max])
    assert work.walk(bvh, v0, e0, e1, o, d, tm) == want


def test_brute_force_counts_up_to_the_first_occluder():
    v0, e0, e1 = (torch.as_tensor(a, dtype=torch.float32) for a in _quad())
    o = torch.tensor([[0.75, 0.25, 1.0], [0.25, 0.75, 1.0], [2.0, 2.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    occ, tests = geometry.occluded(o, d, v0, e0, e1, torch.full((3,), 2.0),
                                   count=torch.ones(3, dtype=torch.bool))
    # A is first: the ray in A stops at 1 test, the ray in B at 2, the miss tests both
    assert occ.tolist() == [True, True, False] and tests == 1 + 2 + 2


def test_roofline_share_is_against_the_larger_bound():
    r = work.Reckoning(triangles=26, closest_rays=4.0, hits=3.0, shadow_rays=2.0,
                       shadow_tests=30.0)
    t, by = work.fused_brute(r, 1000)
    flops = 1000 * ((4.0 * 26 + 30.0) * work.MT_FLOPS + 3.0 * work.SHADE_FLOPS)
    assert by == "operations" and t == pytest.approx(flops / work.FP32_FLOPS)
    assert work.share_pct(t, 2 * t) == pytest.approx(50.0)

"""Tiny cells for the benchmark's CPU tests, added to a copy of the
benchmark from files alone: a configuration, a traffic mix and limits,
and entries in the manifest. The limits are those of the real cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(scene="cornell", width=16, height=16, max_depth=3, remat=False, sampler="hash",
            sphere_lat=2, sphere_lon=4)
MIXES = {
    "tiny_render": dict(kind="render", kspp=4, spp_per_pass=1, fused="auto", warm_units=1,
                        check_batches=2, check_pixels=64, trace_units=3),
    "tiny_render_pass": dict(kind="render", kspp=4, spp_per_pass=4, fused="off", warm_units=1,
                             check_batches=2, check_pixels=64, trace_units=3),
    "tiny_grad": dict(kind="grad", spp=2, spp_per_pass=2, remat=True, fused="off",
                      param="albedo", lr=0.05, target=0.0, trace_units=2),
}
# tiny cell → (traffic mix, the real cell whose limits it is held to)
CELLS = {
    "tiny.render": ("tiny_render", "cornell256_d5_render"),
    "tiny.render_pass": ("tiny_render_pass", "mesh256_d5_off"),
    "tiny.grad": ("tiny_grad", "cornell256_d5_grad"),
}


def _manifest(root: Path, edit) -> None:
    path = root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    edit(manifest)
    path.write_text(json.dumps(manifest))


def add_config(root: Path, name: str, config: dict) -> None:
    """Configuration ``name`` as ``configs/<name>.json`` and its entry."""
    (root / "pt_bench" / "configs" / f"{name}.json").write_text(json.dumps(config))
    _manifest(root, lambda m: m["configs"].append(
        dict(name=name, source="tests", reduced=[], why="tests",
             file=f"pt_bench/configs/{name}.json")))


def add_cell(root: Path, cell: str, config: str, mix: str, real: str) -> None:
    """Cell ``cell`` of ``config`` under traffic ``mix``, held to the limits
    of the real cell ``real`` and reporting its metrics."""
    shutil.copy(root / "pt_bench" / "limits" / f"{real}.json",
                root / "pt_bench" / "limits" / f"{cell}.json")

    def edit(manifest):
        manifest["workloads"].append(dict(name=cell, config=config, traffic=mix, chips=1,
                                          why="tests"))
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m and real in m["workloads"]:
                m["workloads"].append(cell)

    _manifest(root, edit)


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` with the tiny cells added."""
    bench = tmp / "pt_bench"
    shutil.copytree(ROOT / "pt_bench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    add_config(tmp, "tiny", TINY)
    for name, mix in MIXES.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (mix, real) in CELLS.items():
        add_cell(tmp, cell, "tiny", mix, real)
    return tmp

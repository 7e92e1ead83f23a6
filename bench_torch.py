#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port on one NVIDIA GPU: the port's
counterpart of ``bench.py``.

    python3 bench_torch.py               # bench.py's one JSON line (its three legs)
    python3 bench_torch.py --cell NAME   # one cell (repeatable, or "all"): a JSON line each
    python3 bench_torch.py --smoke       # 64², 1 spp through kernels 1 and 4
    python3 bench_torch.py --seed N ...  # the workload seed (default 0)

It measures on ``cuda`` only: without a card it exits non-zero before any
measurement, and nothing falls back to the CPU. The kernels build from
``cuda_optix_pathtracing_tpu_torch/csrc`` at start (``ops/_cuda_build.py``,
one ``nvcc`` per source, all at once), outside every timed window.

A cell is one scene, configuration and traffic (``CELLS``), driven through
the port's entry points (``render_progressive``, ``make_loss``). Each cell

1. builds its scene: the set-up seconds are a metric of their own;
2. runs one window untimed, then ``WINDOWS`` timed windows, the launch
   counters zeroed before the first and read after the last: each window's
   Mpaths/s by the host clock around work that ends in
   ``torch.cuda.synchronize()`` → the median, the spread (quartile distance
   over the median) and the peak device memory;
3. traces one unit of its traffic (an spp, a pass or a step) under
   ``torch.profiler``, apart from the timed windows, so tracing never
   touches them: the device-busy share against the untraced wall, host
   kernel launches per spp (per step), and per kernel its device ms per
   launch, launches and roofline share, the bound counted by
   ``chip_smoke.py``'s work counters on that unit's own launches;
4. holds what it computed to the plain route on the card: the radiance of
   ``PARITY_SPP`` samples on every ``PARITY_STRIDE``-th path against
   ``backend="torch"``, ``fused="off"`` at the reference's parity bar
   (``tests/test_megakernel_pallas.py:63-65``), the gradient cell's loss
   and albedo gradient at 64² against ``backend="torch"``; every film
   finite and > 0.

A failed check prints ``"correct": false`` and exits 1. Diagnostics go to
standard error; standard output holds only the JSON lines.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as CS
from cuda_optix_pathtracing_tpu_torch import native
from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
from cuda_optix_pathtracing_tpu_torch.ops import _cuda_build
from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
from cuda_optix_pathtracing_tpu_torch.ops.film import film_new
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh, load_scene
from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights

BASELINE_MPATHS_S = 8.63  # the reference megakernel on a GTX 1070 (bench.py:174, BASELINE.md)
SEED_SAMPLES = 1 << 20  # sample indices between two workload seeds' first samples
PARITY_SPP = 2
PARITY_STRIDE = 8  # divides every cell's pixel count: each sample keeps one pixel set
PLAIN_CHUNK = 1024  # triangles per step of the plain sweep (its result does not depend on it)
GRAD_CHECK_SIZE = 64
# timed windows per cell: the host-bound cells' windows vary by up to 1.5x
# within one call (the mesh box's fused="off" pass ran in two regimes, 4.3
# and 6.5 Mpaths/s, on an H100 80GB HBM3), so the median needs many
WINDOWS = 21
SOURCES = ("intersect", "megakernel", "bvh", "bsdf_step")
SCENE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
# chip_smoke.KERNEL_NAMES keys → the kernel's name and its wrapper's launch counter
KERNELS = {
    "fused": ("pt_fused_bruteforce", "trace_paths_fused"),
    "fused_bvh": ("pt_fused_bvh", "trace_paths_fused"),
    "closest": ("closest_bruteforce", "closest_bruteforce"),
    "anyhit": ("anyhit_bruteforce", "anyhit_bruteforce"),
    "bvh_closest": ("bvh_closest", "bvh_closest_raw"),
    "bvh_anyhit": ("bvh_anyhit", "bvh_any_raw"),
}
# the camera kernel's counter: the camera stage before any route, not a
# route's kernel
CAMERA = "camera_rays"
# the BSDF stage's kernel's counter: one launch a bounce of every forward
# render on the unfused route, none on a fused route or in a gradient step
BSDF_STAGE = "bsdf_step"


@dataclasses.dataclass(frozen=True)
class Cell:
    scene: str  # "cornell_box", "cornell_box_mesh", "cornell_box_many_lights" or a file in scenes/
    depth: int
    kspp: int  # samples per render_progressive call (the gradient cell: per step)
    spp_per_pass: int  # samples traced as one flattened ray batch
    iters: int  # render_progressive calls (steps) per timed window
    trace_spp: int  # samples of the traced unit (the gradient cell: one step)
    fused: str  # MegakernelConfig.fused
    kernels: tuple  # chip_smoke.KERNEL_NAMES keys: the route runs these and no other
    source: str
    reduced: str = "none"
    subdiv: int = 0  # the spheres' subdivision of the mesh scenes
    grad: bool = False  # bench.py's albedo-gradient step instead of a render
    size: int = 256


CELLS = {
    "cornell256_d5_fused": Cell(
        "cornell_box", 5, 8, 1, 4, 8, "auto", ("fused",),
        "reference Cornell box (examples/triangles/cuda-core/private/host_utils.cu:402-457), "
        "its GTX 1070 workload in BASELINE.md: 256², depth 5; bench.py:139-152"),
    "mesh256_d5_off": Cell(
        "cornell_box_mesh", 5, 16, 16, 2, 16, "off", ("bvh_closest", "bvh_anyhit"),
        "bench.py:154-164 (cornell_box_mesh subdiv 64, fused='off', 16 spp a pass)", subdiv=64),
    "mesh256_d5_fused": Cell(
        "cornell_box_mesh", 5, 16, 16, 2, 16, "auto", ("fused_bvh",),
        "bench.py:154-164 with render()'s default fused='auto'", subdiv=64),
    "cornell256_d5_fwd_bwd": Cell(
        "cornell_box", 5, 4, 4, 4, 4, "off", ("closest", "anyhit"),
        "bench.py:56-88 (albedo L2 step, 4 spp a pass, remat=True, target 0)", grad=True),
    "many_lights256_d5_tree": Cell(
        "cornell_box_many_lights", 5, 16, 16, 1, 16, "auto", ("bvh_closest", "bvh_anyhit"),
        "scene/procedural.py cornell_box_many_lights (129 light records, light tree), "
        "chip_smoke.py phase 7", subdiv=64),
    "scene_test_json": Cell(
        "scene_test.json", 12, 8, 1, 1, 1, "auto", ("bvh_closest", "bvh_anyhit"),
        "scenes/scene_test.json at its authored 256², depth 12 (the CLI's config, kspp 8)",
        reduced="8 spp a window against the file's 32"),
}
LEGS = ("cornell256_d5_fused", "mesh256_d5_off", "cornell256_d5_fwd_bwd")  # bench.py's three


def metric(value, unit: str) -> dict:
    return {"value": value, "unit": unit}


def build_kernels() -> float:
    """Build every CUDA source (one ``nvcc`` each, all at once) and the
    host library (``g++``) alongside → seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(native.build)
        _cuda_build.build_all(SOURCES)
        gxx.result()
    return time.perf_counter() - t0


def build_scene(cell: Cell, scenes: dict):
    """The cell's scene on the card, built once per process and kept in
    ``scenes`` → (scene, seconds its build took)."""
    key = (cell.scene, cell.subdiv, cell.size)
    if key not in scenes:
        t0 = time.perf_counter()
        n = cell.size
        if cell.scene == "cornell_box":
            scene = cornell_box(n, n)
        elif cell.scene == "cornell_box_mesh":
            scene = cornell_box_mesh(n, n, subdiv=cell.subdiv)
        elif cell.scene == "cornell_box_many_lights":
            scene = cornell_box_many_lights(n, n, subdiv=cell.subdiv)
            records = scene.light_tree.n_records if scene.light_tree is not None else 0
            CS.check(records > 0 and scene.bvh is not None,
                     f"{cell.scene}: a BVH and a light tree of {records} light records")
        else:
            scene, parsed = load_scene(os.path.join(SCENE_DIR, cell.scene))
            CS.check((parsed.width, parsed.height, parsed.max_depth) == (n, n, cell.depth),
                     f"{cell.scene}: {parsed.width}x{parsed.height}, depth {parsed.max_depth} "
                     f"from the file")
        torch.cuda.synchronize()
        scenes[key] = (scene, time.perf_counter() - t0)
    return scenes[key]


def median_spread(vals) -> tuple[float, float]:
    """(median, quartile distance over the median)."""
    q1, med, q3 = np.percentile(vals, [25, 50, 75])
    return float(med), float((q3 - q1) / med)


def film_gate(label: str, mean) -> None:
    CS.check(bool(torch.isfinite(mean).all()) and float(mean.mean()) > 0.0,
             f"{label}: film finite, mean {float(mean.mean()):.6g} > 0")


def parity_gate(label: str, img, px, py, s, rad_p) -> float:
    """The measured route's image ``img`` ((nspp,) H, W, 3) at the paths
    (px, py, sample ``s`` counted from the pass's first) against the plain
    route's radiance ``rad_p`` of the same paths, ``nspp`` blocks of one
    pixel set each: the reference's parity bar on per-pixel means
    (``chip_smoke.check_parity``) → max abs pixel difference."""
    img = img.reshape(-1, *img.shape[-3:])
    nspp = int(s.max()) + 1
    CS.check(bool(torch.isfinite(img).all()), f"{label}: finite image")
    return CS.check_parity(label, img[s, py, px], rad_p, nspp, ref="backend='torch'")


def gradient_gate(label: str, loss_k: float, g_k, loss_p: float, g_p) -> float:
    """One step's loss and albedo gradient on the kernel route against
    ``backend="torch"``: the loss within 1e-6 relative, the gradient within
    chip_smoke's bar (the reference's remat test) → largest relative
    difference of a nonzero entry."""
    CS.check(math.isfinite(loss_k) and loss_k > 0.0 and math.isclose(loss_k, loss_p, rel_tol=1e-6),
             f"{label}: losses agree ({loss_k:.9g}, {loss_p:.9g})")
    nz = g_p != 0
    rel = float(((g_k - g_p).abs()[nz] / g_p.abs()[nz]).max()) if bool(nz.any()) else 0.0
    CS.check(bool(torch.isfinite(g_k).all()) and int(nz.sum()) > 0
             and torch.allclose(g_k, g_p, rtol=CS.GRAD_RTOL, atol=CS.GRAD_ATOL),
             f"{label}: albedo gradients within rtol {CS.GRAD_RTOL:g}, atol {CS.GRAD_ATOL:g} "
             f"(largest relative difference {rel:.3e}, {int(nz.sum())} nonzero entries)")
    return rel


class Renders:
    """A render cell's traffic: ``render_progressive`` batches into one film."""

    def __init__(self, cell: Cell, scene, seed: int):
        self.cell, self.scene = cell, scene
        self.cfg = MK.resolve_fused(scene, MK.MegakernelConfig(
            max_depth=cell.depth, remat=False, fused=cell.fused, seed=seed,
            features=mat_features_from_table(scene.materials)))
        self.sample0 = seed * SEED_SAMPLES
        self.sample = self.sample0
        self.film = film_new(cell.size, cell.size, scene.device)
        self.unit_paths = cell.size * cell.size  # paths per spp
        self.window_paths = self.unit_paths * cell.kspp * cell.iters
        self.unit_count = cell.trace_spp

    def _progressive(self, film, sample, kspp):
        n = self.cell.size
        return MK.render_progressive(self.scene, film, self.cfg, n, n, sample, kspp,
                                     min(self.cell.spp_per_pass, kspp))

    def window(self) -> None:
        for _ in range(self.cell.iters):
            self.film = self._progressive(self.film, self.sample, self.cell.kspp)
            self.sample += self.cell.kspp

    def unit(self) -> None:
        self._progressive(film_new(self.cell.size, self.cell.size, self.scene.device),
                          self.sample0, self.cell.trace_spp)

    def check_output(self, label: str) -> float:
        film_gate(label, self.film.mean)
        n, cfg = self.cell.size, self.cfg
        img = MK.render_sample_batch(self.scene, cfg, n, n, self.sample0, nspp=PARITY_SPP)
        px, py, s, o, d, _, _ = MK.camera_batch(self.scene, cfg, n, n, self.sample0, PARITY_SPP)
        sub = slice(None, None, PARITY_STRIDE)
        plain = dataclasses.replace(cfg, backend="torch", fused="off", tri_chunk=PLAIN_CHUNK)
        rad_p = MK.trace_paths(self.scene, plain, px[sub], py[sub], s[sub], o[sub], d[sub])
        return parity_gate(f"{label}, {PARITY_SPP} spp, every {PARITY_STRIDE}th path", img,
                           px[sub], py[sub], s[sub] - self.sample0, rad_p)


class Steps:
    """The gradient cell's traffic: bench.py's albedo-gradient step."""

    def __init__(self, cell: Cell, scene, seed: int):
        self.cell, self.scene, self.seed = cell, scene, seed
        self.cfg = MK.MegakernelConfig(max_depth=cell.depth, remat=True, fused=cell.fused,
                                       seed=seed)
        self.sample0 = seed * SEED_SAMPLES
        n = cell.size
        self.loss = D.make_loss(scene, self.cfg, n, n, cell.kspp,
                                torch.zeros((n, n, 3), device=scene.device),
                                spp_per_pass=cell.spp_per_pass)
        self.params = D.init_params(scene)
        self.unit_paths = n * n * cell.kspp  # paths per step
        self.window_paths = self.unit_paths * cell.iters
        self.unit_count = 1
        self.value = None

    def unit(self) -> None:
        self.params["albedo"].grad = None
        self.value = self.loss(self.params, self.sample0)
        self.value.backward()

    def window(self) -> None:
        for _ in range(self.cell.iters):
            self.unit()

    def check_output(self, label: str) -> float:
        loss = float(self.value.detach())
        g = self.params["albedo"].grad
        CS.check(math.isfinite(loss) and loss > 0.0 and bool(torch.isfinite(g).all()),
                 f"{label}: the timed step's loss {loss:.9g} finite and > 0, gradient finite")
        n = GRAD_CHECK_SIZE
        small = cornell_box(n, n)
        out = []
        for backend in ("auto", "torch"):
            loss_fn = D.make_loss(small, dataclasses.replace(self.cfg, backend=backend), n, n,
                                  self.cell.kspp, torch.zeros((n, n, 3), device=small.device),
                                  spp_per_pass=self.cell.spp_per_pass)
            p = D.init_params(small)
            val = loss_fn(p, self.sample0)
            val.backward()
            out += [float(val.detach()), p["albedo"].grad]
        return gradient_gate(f"{label}, {n}x{n} step, kernel route vs backend='torch'", *out)


def kernel_bounds(cell: Cell, scene, unit) -> dict:
    """Each route kernel's bound per launch (ms, by), counted by
    chip_smoke's work counters on the launches of one more run of ``unit``
    (the mean over them)."""
    out = {}
    ks = set(cell.kernels)
    if ks & {"fused", "fused_bvh"}:
        rec = CS.record_fused_launches(MKC, unit)
        fn = CS.fused_bvh_bound if scene.bvh is not None else CS.fused_bound
        bs = [fn(MK, scene, MK.MegakernelConfig(backend="torch", fused="off",
                                                tri_chunk=PLAIN_CHUNK, **kw), *rays)[0]
              for rays, kw in rec]
        out["fused_bvh" if scene.bvh is not None else "fused"] = (
            sum(b[0] for b in bs) / len(bs), bs[0][1])
    if ks & {"bvh_closest", "bvh_anyhit"}:
        rec = CS.record_bvh_launches(MK, unit)
        out["bvh_closest"] = CS.traversal_bound(rec["closest"], rec["closest_tables"])[0]
        out["bvh_anyhit"] = CS.traversal_bound(rec["any"], rec["any_tables"], "any")[0]
    if ks & {"closest", "anyhit"}:
        rec = CS.record_brute_launches(MK, unit)
        out["closest"], out["anyhit"], _ = CS.brute_bounds(scene, rec["closest"], rec["any"])
    return out


def run_cell(name: str, scenes: dict, seed: int = 0, windows: int | None = None,
             build_s: float = 0.0) -> dict:
    """Measure one cell on the card (module docstring, steps 1-4) → its
    result: every metric by name with its unit. A failed check raises
    AssertionError."""
    cell = CELLS[name]
    scene, scene_s = build_scene(cell, scenes)
    traffic = (Steps if cell.grad else Renders)(cell, scene, seed)
    per = "step" if cell.grad else "spp"
    zero, read = CS.launch_counters()

    traffic.window()  # warm: first launches, lazily built tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    vals = []
    for _ in range(windows or WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traffic.window()
        torch.cuda.synchronize()
        vals.append(traffic.window_paths / (time.perf_counter() - t0) / 1e6)
    got = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counted = {KERNELS[k][1] for k in cell.kernels}
    unfused_forward = not cell.grad and not {"fused", "fused_bvh"} & set(cell.kernels)
    CS.check(all(got[c] > 0 for c in counted) and (got[BSDF_STAGE] > 0) == unfused_forward
             and all(v == 0 for c, v in got.items() if c not in counted | {CAMERA, BSDF_STAGE}),
             f"{name}: the timed windows launched {got}: {sorted(counted)}, "
             f"{BSDF_STAGE} {'' if unfused_forward else 'not '}and no other kernel of the route")
    med, spread = median_spread(vals)

    # per layer, from a separate traced run of one unit of the traffic
    wall = traffic.unit_paths / (med * 1e6)  # untraced seconds per spp (step)
    busy, per_k, n_launch, n_sync, _ = CS.traced_render(traffic.unit, traffic.unit_count,
                                                        CS.KERNEL_NAMES)
    ran = sorted(k for k, (n, _) in per_k.items() if n)
    CS.check(ran == sorted(cell.kernels),
             f"{name}: the traced {per} ran the route's kernels {ran}, and no other of the port")
    bounds = kernel_bounds(cell, scene, traffic.unit)
    err = traffic.check_output(name)

    e2e = "fwd_bwd_mpaths_s" if cell.grad else "mpaths_s"
    m = {
        e2e: metric(med, "Mpaths/s"),
        "spread": metric(spread, "(Q3 - Q1) / median"),
        "windows": metric(len(vals), "windows"),
        "window_" + e2e: metric(vals, "Mpaths/s"),
        "scene_build_s": metric(scene_s, "s"),
        "kernel_build_s": metric(build_s, "s"),
        "device_busy_share": metric(busy / wall, "device-busy s per untraced s"),
        f"launches_per_{per}": metric(n_launch, f"host kernel launches per {per}"),
        f"syncs_per_{per}": metric(n_sync, f"stream syncs per {per}"),
        "peak_mem_gib": metric(peak, "GiB"),
        "max_abs_err" if not cell.grad else "grad_max_rel_err": metric(
            err, "radiance" if not cell.grad else "relative"),
    }
    bound_by = {}
    for k in cell.kernels:
        label = KERNELS[k][0]
        n, t = per_k[k]
        ms = t * 1e3 / n
        b_ms, bound_by[label] = bounds[k]
        m[f"{label}_ms"] = metric(ms, "device ms per launch")
        m[f"{label}_launches_per_{per}"] = metric(n / traffic.unit_count, f"launches per {per}")
        m[f"{label}_bound_ms"] = metric(b_ms, "ms per launch")
        m[f"{label}_roofline_share"] = metric(b_ms / ms, "bound over measured")
        CS.check(0.0 < b_ms / ms <= 1.0, f"{name}: {label} at {100 * b_ms / ms:.2f} % of its "
                 f"bound (0-100 %)")
    return {"cell": name, "correct": True, "card": CS.card_line(), "seed": seed,
            "metrics": m, "bound_by": bound_by, "source": cell.source, "reduced": cell.reduced}


def headline(results: dict) -> dict:
    """bench.py's one JSON line (bench.py:175-190) from its three legs'
    cells; the v5e VPU fraction gives way to each leg kernel's roofline
    share."""
    fused, mesh, grad = (results[n]["metrics"] for n in LEGS)
    mpaths = fused["mpaths_s"]["value"]
    shares = {k[:-len("_roofline_share")]: v["value"] for r in (fused, mesh, grad)
              for k, v in r.items() if k.endswith("_roofline_share")}
    return {
        "metric": "cornell256_depth5_throughput",
        "value": mpaths,
        "unit": "Mpaths/s",
        "vs_baseline": mpaths / BASELINE_MPATHS_S,
        "extra": {
            "cornell_mesh_bvh_mpaths": mesh["mpaths_s"]["value"],
            "fwd_bwd_mpaths": grad["fwd_bwd_mpaths_s"]["value"],
            "fwd_bwd_spread": grad["spread"]["value"],
            "roofline_share": shares,
            "card": results[LEGS[0]]["card"],
        },
    }


def smoke() -> dict:
    """bench.py --smoke (bench.py:91-127) on the card: 64², 1 spp, the
    Cornell box through kernel 1 and the subdivision-16 mesh box with
    ``fused="off"`` through kernel 4; each film finite and > 0."""
    zero, read = CS.launch_counters()
    results = {}
    for label, scene, fused, counter in (
        ("fused", cornell_box(64, 64), "on", "trace_paths_fused"),
        ("bvh", cornell_box_mesh(64, 64, subdiv=16), "off", "bvh_closest_raw"),
    ):
        cfg = MK.resolve_fused(scene, MK.MegakernelConfig(
            max_depth=4, remat=False, fused=fused,
            features=mat_features_from_table(scene.materials)))
        zero()
        film = MK.render(scene, 64, 64, 1, cfg=cfg, kspp=1)
        got = read()
        film_gate(f"smoke {label}", film.mean)
        CS.check(got[counter] > 0, f"smoke {label}: {got[counter]} launches of {counter}")
        results[label] = {"finite": True, "mean": float(film.mean.mean()),
                          "launches": got[counter]}
    return {"metric": "smoke", "device": torch.cuda.get_device_name(0), "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="64², 1 spp through kernels 1 and 4")
    ap.add_argument("--cell", action="append", choices=[*CELLS, "all"],
                    help="run this cell (repeatable; 'all' for every cell)")
    ap.add_argument("--seed", type=int, default=0, help="the workload seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; the benchmark measures on "
              "an NVIDIA GPU only", file=sys.stderr)
        return 2
    out = sys.stdout
    if args.cell:
        names = list(CELLS) if "all" in args.cell else list(dict.fromkeys(args.cell))
    else:
        names = [] if args.smoke else list(LEGS)
    name = "smoke"
    with contextlib.redirect_stdout(sys.stderr):
        try:
            build_s = build_kernels()
            print(f"{CS.card_line()}; kernels built in {build_s:.1f} s")
            if args.smoke:
                print(json.dumps(smoke()), file=out, flush=True)
            results, scenes = {}, {}
            for name in names:
                results[name] = run_cell(name, scenes, args.seed, build_s=build_s)
                if args.cell:
                    print(json.dumps(results[name]), file=out, flush=True)
        except AssertionError as e:
            print(json.dumps({"cell": name, "correct": False, "error": str(e)}), file=out)
            return 1
    if all(n in results for n in LEGS):
        print(json.dumps(headline(results)), file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

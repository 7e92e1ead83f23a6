"""The benchmark of the PyTorch + CUDA port, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds each by name:

- the configuration: the file the manifest gives it (``configs/<name>.json``),
  whose ``scene`` names a builder in ``scenes/<scene>.py``;
- the plain reference that decides ``correct`` and counts the work of the
  roofline shares: the module ``reference/<reference>.py`` that the
  configuration's ``reference`` names, ``integrator`` where it names none;
  what such a module provides is written in ``reference/__init__.py``;
- the traffic mix: ``traffic/<mix>.json``, whose ``kind`` is ``render``
  (progressive batches into one film) or ``grad`` (steps of an image loss's
  gradient under Adam), read by the one generator below;
- the limits of its comparison: ``limits/<cell>.json``;
- each per-layer metric: a reader in ``metrics/<metric>.py``.

A run: set-up (kernels built or loaded, scene built, warm units), then a
window of ``seconds`` (``--trace 0``: the end-to-end metrics by the host
clock) or, for a render, an untraced stretch of ``RATE_SECONDS`` whose
samples are rendered again after it, and a traced window of the mix's
``trace_units`` units beside an untraced one of as many (``--trace 1``:
the per-layer metrics); the peak device memory; the program's state
freed; then the comparison with the plain reference (``check.py``) on
what the window produced.

The port is reached only through its entry points: ``scene_from_host``,
``MegakernelConfig``, ``resolve_fused``, ``render_progressive``,
``film_new``, ``make_loss``, ``init_params`` and the kernel build.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType

import torch

from . import check, stats, work

ROOT = Path(__file__).resolve().parent.parent
CUDA_SOURCES = ("intersect", "megakernel", "bvh")
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_optix_pathtracing_tpu")
RECKON_PATHS = 2048  # sampled paths of the traced window whose work is counted
RATE_SECONDS = 2.0  # least untraced stretch of a traced render run, timed for its rate
DEFAULT_REFERENCE = "integrator"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list
    root: Path
    reference: ModuleType  # the configuration's plain reference

    @property
    def bench(self) -> Path:
        return self.root / "pt_bench"


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    w = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    c = next(c for c in manifest["configs"] if c["name"] == w["config"])
    read = lambda p: json.loads(Path(p).read_text())  # noqa: E731
    config = read(root / c["file"])
    return Cell(name, w["chips"], config,
                read(root / "pt_bench" / "traffic" / f"{w['traffic']}.json"),
                read(root / "pt_bench" / "limits" / f"{name}.json"),
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)], root,
                reference_module(root / "pt_bench", c["name"], config))


def _module(path: Path, name: str, package: list | None = None):
    spec = importlib.util.spec_from_file_location(name, path,
                                                  submodule_search_locations=package)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_module(bench: Path, config_name: str, config: dict) -> ModuleType:
    """The plain reference module that configuration ``config_name``
    names (its ``reference``, ``DEFAULT_REFERENCE`` where it names none),
    from ``bench/reference``, which is loaded once a process as a package
    of its own. Refuses a module that is not there and a configuration
    whose ``sampler`` the module does not give."""
    name = config.get("reference", DEFAULT_REFERENCE)
    where = bench / "reference"
    if not (isinstance(name, str) and name.isidentifier() and (where / f"{name}.py").is_file()):
        raise ValueError(f"configuration {config_name!r}: its reference {name!r} names no "
                         f"module in {where}")
    package = "pt_bench_reference_" + hashlib.sha1(str(where.resolve()).encode()).hexdigest()[:12]
    if package not in sys.modules:
        _module(where / "__init__.py", package, [str(where)])
    ref = importlib.import_module(f"{package}.{name}")
    if config["sampler"] not in ref.SAMPLERS:
        raise ValueError(f"configuration {config_name!r}: its sampler {config['sampler']!r} "
                         f"is none that its reference module {name!r} gives "
                         f"({', '.join(sorted(ref.SAMPLERS))})")
    return ref


def scene_spec(cell: Cell):
    """The configuration's scene from the benchmark's own builder."""
    builder = _module(cell.bench / "scenes" / f"{cell.config['scene']}.py",
                      f"pt_bench_scene_{cell.config['scene']}")
    return builder.build(cell.config), builder


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Port:
    """The port's entry points, imported when a run starts."""

    def __init__(self):
        from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
        from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
        from cuda_optix_pathtracing_tpu_torch.ops.film import film_new
        from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene, scene_from_host

        self.D, self.MK, self.film_new = D, MK, film_new
        self.HostScene, self.scene_from_host = HostScene, scene_from_host

    @staticmethod
    def load_kernels() -> None:
        """Build the CUDA sources and the host library, or load them from
        the package's ``_build/``."""
        from cuda_optix_pathtracing_tpu_torch import native
        from cuda_optix_pathtracing_tpu_torch.ops import _cuda_build

        native.build()
        _cuda_build.build_all(CUDA_SOURCES)
        for name in CUDA_SOURCES:
            _cuda_build.load(name)


class Render:
    """Progressive batches of ``kspp`` samples into one film, the film read
    (synchronised) after each batch as a viewer reads it."""

    kind = "render"

    def __init__(self, port: Port, scene, cell: Cell, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.port, self.scene, self.cell, self.seed, self.device = port, scene, cell, seed, device
        self.mk_cfg = port.MK.resolve_fused(scene, port.MK.MegakernelConfig(
            max_depth=cfg["max_depth"], remat=cfg["remat"], sampler=cfg["sampler"],
            fused=mix["fused"], seed=seed))
        self.w, self.h = cfg["width"], cfg["height"]
        self.kspp, self.per_pass = mix["kspp"], mix["spp_per_pass"]
        self.unit_paths = self.w * self.h * self.kspp
        self.unit_spp = self.kspp
        self.sample = 0

    def new_film(self):
        return self.port.film_new(self.h, self.w, self.device)

    def batch(self, film):
        out = self.port.MK.render_progressive(self.scene, film, self.mk_cfg, self.w, self.h,
                                              self.sample, self.kspp, self.per_pass,
                                              device=self.device)
        self.sample += self.kspp
        return out

    def warm(self) -> None:
        film = self.new_film()
        for _ in range(self.cell.mix["warm_units"]):
            film = self.batch(film)
        _sync(self.device)

    def run(self, until, keep) -> tuple[list, list]:
        """Batches into a new film until ``until(batch index, now)`` says
        stop; ``keep(batch index, start)`` picks the batches to check →
        (each batch's wall, [(first sample, film before or None, film
        after)])."""
        film, lat, kept, k = self.new_film(), [], [], 0
        while True:
            s0 = self.sample
            t0 = time.perf_counter()
            new = self.batch(film)
            _sync(self.device)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if keep(k, t0):
                kept.append((s0, film if k else None, new))
            film, k = new, k + 1
            if until(k, t1):
                return lat, kept

    def numbers(self, spec, kept, control: bool = False) -> dict:
        return check.render_numbers(self.cell.reference, spec, self.cell.config, self.cell.mix,
                                    self.seed, kept, self.device, control)

    def free(self) -> None:
        self.scene = self.mk_cfg = None


class Grad:
    """Steps of ``make_loss``'s L2 image loss of the materials' albedo:
    the loss, ``backward()`` and an Adam step of the albedo, which the
    benchmark owns; each step's loss is read (synchronised), as a training
    loop logs it. The sample offset advances by ``spp`` each step."""

    kind = "grad"
    CHECK_STEPS = 3

    def __init__(self, port: Port, scene, cell: Cell, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.cell, self.seed, self.device = cell, seed, device
        w, h = cfg["width"], cfg["height"]
        mk_cfg = port.MK.MegakernelConfig(max_depth=cfg["max_depth"], remat=mix["remat"],
                                          sampler=cfg["sampler"], fused=mix["fused"], seed=seed)
        target = torch.full((h, w, 3), float(mix["target"]), device=device)
        self.loss = port.D.make_loss(scene, mk_cfg, w, h, mix["spp"], target,
                                     spp_per_pass=mix["spp_per_pass"])
        self.params = port.D.init_params(scene, (mix["param"],))
        self.leaf = self.params[mix["param"]]
        self.opt = torch.optim.Adam([self.leaf], lr=mix["lr"])
        self.spp = mix["spp"]
        self.unit_paths = w * h * self.spp
        self.unit_spp = self.spp
        self.sample = 0
        self.got = None

    def step(self) -> float:
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(self.params, self.sample)
        loss.backward()
        self.opt.step()
        self.sample += self.spp
        return float(loss.detach())

    def warm(self) -> None:
        """The first three steps, read for the comparison."""
        p0 = self.leaf.detach().clone()
        losses = [self.step()]
        m1 = self.opt.state[self.leaf].get("exp_avg", torch.zeros_like(self.leaf))
        g1 = m1.detach().clone() / (1.0 - check.ADAM_BETAS[0])
        losses += [self.step() for _ in range(self.CHECK_STEPS - 1)]
        self.got = (losses, g1, p0, self.leaf.detach().clone())

    def run(self, until, keep) -> tuple[list, list]:
        lat, k = [], 0
        while True:
            t0 = time.perf_counter()
            self.step()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            k += 1
            if until(k, t1):
                return lat, []

    def numbers(self, spec, kept, control: bool = False) -> dict:
        return check.grad_numbers(self.cell.reference, spec, self.cell.config, self.cell.mix,
                                  self.seed, self.got, self.device, control)

    def free(self) -> None:
        self.loss = self.params = self.opt = None


TRAFFIC = {"render": Render, "grad": Grad}


def _keep_drawn(cell: Cell, seed: int, start: float, seconds: float):
    """The batches to check: the first, and ``check_batches`` more whose
    start crosses times drawn from the seed in the window."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    marks = sorted(float(x) * seconds for x in torch.rand(cell.mix.get("check_batches", 0),
                                                          generator=g))

    def keep(k: int, t0: float) -> bool:
        if k == 0:
            return True
        hit = False
        while marks and t0 - start >= marks[0]:
            marks.pop(0)
            hit = True
        return hit

    return keep


def reckon(cell: Cell, spec, seed: int, sample0: int, device) -> work.Reckoning:
    """The work per path of the traced window, counted on the cell's
    reference's paths of ``RECKON_PATHS`` pixels drawn from the seed at its
    first sample, and the benchmark's own BVH walked over their queries."""
    reference, cfg = cell.reference, cell.config
    ref = reference.make_scene(spec, device)
    px, py = check.check_pixels(seed, -1, cfg["width"], cfg["height"], RECKON_PATHS, device)
    w = reference.Work(keep_rays=True)
    reference.pixel_samples(ref, reference.SAMPLERS[cfg["sampler"]](seed), px, py, sample0, 1,
                            cfg["max_depth"], work=w)
    r = work.Reckoning(triangles=int(ref.v0.shape[0]), closest_rays=w.closest_rays / w.paths,
                       hits=w.hits / w.paths, shadow_rays=w.shadow_rays / w.paths,
                       shadow_tests=w.shadow_tests / w.paths)
    tables = [x.double().cpu().numpy() for x in (ref.v0, ref.e0, ref.e1)]
    bvh = work.build_bvh(*tables)
    r.bvh_nodes = len(bvh.lo)
    cat = lambda xs, i: torch.cat([x[i] for x in xs]).double().cpu().numpy()  # noqa: E731
    if w.closest:
        s, t = work.walk(bvh, *tables, cat(w.closest, 0), cat(w.closest, 1))
        r.closest_slabs, r.closest_tri_tests = s / w.paths, t / w.paths
    if w.shadow:
        s, t = work.walk(bvh, *tables, cat(w.shadow, 0), cat(w.shadow, 1), cat(w.shadow, 2))
        r.shadow_slabs, r.shadow_tri_tests = s / w.paths, t / w.paths
    return r


@dataclasses.dataclass
class TraceRecord:
    """What a per-layer metric's reader reads."""

    kind: str  # the traffic's kind
    units: int  # units (batches or steps) in the traced window
    spp: int  # samples per unit
    paths: int  # paths traced in the traced window
    wall_s: float  # the same units' untraced wall
    trace: object  # devtrace.Trace of the traced window
    reckoning: work.Reckoning
    scene_build_s: float
    kernel_load_s: float
    rate_paths: int = 0  # paths of a render's untraced stretch of RATE_SECONDS
    rate_s: float = 0.0  # its wall


def read_per_layer(cell: Cell, rec: TraceRecord) -> dict:
    """Each per-layer metric of the cell that its reader finds → {name:
    {value, unit}}; a reader that finds nothing returns None, and the
    metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = _module(cell.bench / "metrics" / f"{m['name']}.py",
                         "pt_bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        root: Path = ROOT, traffic_hook=None, control: bool = False) -> dict:
    """One run of the cell → the result line's object. ``t_start``: the
    process's first clock reading (set-up counts from it).
    ``traffic_hook``: called on the traffic before its warm-up (tests
    break the timed path there). ``control``: also the numbers of the
    bfloat16 reference put in the program's place, under ``control``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    cuda = torch.device(device).type == "cuda"
    port = Port()
    t0 = time.perf_counter()
    if cuda:
        port.load_kernels()
    kernel_load_s = time.perf_counter() - t0
    spec, builder = scene_spec(cell)
    t0 = time.perf_counter()
    scene = port.scene_from_host(builder.to_host_scene(spec, port.HostScene), device=device)
    _sync(device)
    scene_build_s = time.perf_counter() - t0
    traffic = TRAFFIC[cell.mix["kind"]](port, scene, cell, seed, device)
    if traffic_hook is not None:
        traffic_hook(traffic)
    traffic.warm()
    setup_s = time.perf_counter() - t_start

    metrics, dev_extra, breakdown = {}, {}, None
    if not trace:
        start = time.perf_counter()
        lat, kept = traffic.run(lambda k, now: now - start >= seconds,
                                _keep_drawn(cell, seed, start, seconds))
        window = time.perf_counter() - start
        units = len(lat)
        values = {"setup_s": setup_s}
        if traffic.kind == "render":
            values["mpaths_s"] = stats.rate(units * traffic.unit_paths, window) / 1e6
            values["batch_ms_p95"] = stats.percentile(lat, 95) * 1e3
        else:
            values["grad_step_ms"] = window / units * 1e3
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        from . import devtrace

        rate_paths, rate_s = 0, 0.0
        if traffic.kind == "render":
            # whole batches for RATE_SECONDS, before the profiler has run; the
            # windows below render the same samples again, as without them
            s0, t0 = traffic.sample, time.perf_counter()
            rate_lat, _ = traffic.run(lambda k, now: now - t0 >= RATE_SECONDS,
                                      lambda k, t: False)
            rate_s, rate_paths = time.perf_counter() - t0, len(rate_lat) * traffic.unit_paths
            traffic.sample = s0
        n = cell.mix["trace_units"]
        t0 = time.perf_counter()
        traffic.run(lambda k, now: k >= n, lambda k, t: False)
        wall = time.perf_counter() - t0
        g = torch.Generator().manual_seed(int(seed) % (1 << 63))
        marks = {0} | {int(x) + 1 for x in torch.randperm(n - 1, generator=g)[
            :cell.mix.get("check_batches", 0)]}
        out = {}
        tr = devtrace.traced(lambda: out.update(r=traffic.run(lambda k, now: k >= n,
                                                             lambda k, t: k in marks)), device)
        lat, kept = out["r"]
        units = len(lat)
        rec = TraceRecord(traffic.kind, units, traffic.unit_spp, units * traffic.unit_paths,
                          wall, tr, reckon(cell, spec, seed, traffic.sample, device),
                          scene_build_s, kernel_load_s, rate_paths, rate_s)
        metrics = read_per_layer(cell, rec)
        dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    window_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traffic.free()
    del scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = traffic.numbers(spec, kept)
    correct, checks = check.verdict(numbers, cell.limits)
    print(f"pt_bench: {name} seed {seed}: set-up {setup_s:.3f} s, window and reading "
          f"{window_end - t_start - setup_s:.3f} s, comparison "
          f"{time.perf_counter() - window_end:.3f} s", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    result = {
        "correct": correct,
        "attempted": units,
        "failed": 0 if correct else units,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak), **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["readings"] = numbers
        result["control"] = traffic.numbers(spec, kept, control=True)
    result["checks"] = checks
    return result

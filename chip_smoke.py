#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails loudly; there is no CPU fallback):

1. card and build: the card's name and power limit, then every kernel of
   the main path built from ``cuda_optix_pathtracing_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once), with ptxas' register/spill lines;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, to the tolerances stated below;
3. the main path: ``render(cornell_box(256, 256), 256, 256, spp=64)`` with
   the default config (fused kernel), the CLI at its defaults (fused
   kernel, 8 spp here), then ``render`` at 8 spp with ``fused="off"``
   (closest-hit and any-hit kernels); launch counters are zeroed just
   before and read just after each run;
4. timing lines: each kernel's device time per launch (torch.profiler),
   the wrapper call's time (CUDA events), its plain version's time,
   launches per spp and its bound; the Mpaths/s of repeated renders and
   one traced render's device-busy share; then one JSON line with every
   kernel, and as the last line ``{"ok": true, "device": ...}``.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
FP32_FLOPS = 67e12  # non-tensor FP32
HBM_BYTES_S = 3.35e12

W = H = 256
DEPTH = 5
SPP_FUSED = 64
SPP_OFF = 8
SPP_TRACE = 8
SPP_CLI = 8
RENDER_REPEATS = 4
PARITY_SPP = 4
N_RAYS = W * H * PARITY_SPP
# flop model of bench.py: ~45 flops per ray-triangle test, ~800 per
# shaded hit. The bounds take the work this run's data needs (tests made,
# hits shaded), counted on the plain versions
MT_FLOPS = 45
SHADE_FLOPS = 800


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def warm_up(fn, seconds: float = 0.3) -> None:
    """Call ``fn`` for ``seconds`` so the card leaves its idle clocks."""
    import torch

    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` windows of the CUDA-event time per call of
    ``fn``, each window ``iters`` calls long, after warm-up. This is the
    time a caller waits per call, host-side work and syncs included."""
    import torch

    warm_up(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[reps // 2]


def profiled(fn):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity) →
    (host seconds, key_averages). Device times come from CUPTI."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def device_rows(rows):
    from torch.autograd import DeviceType

    return [e for e in rows if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, iters: int, kernel: str) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, from the profiler over ``iters`` calls of ``fn`` after
    warm-up. CUDA events around the calls would time the host instead:
    the wrappers' small PyTorch ops and syncs outlast the kernel."""
    warm_up(fn)

    def run():
        for _ in range(iters):
            fn()

    _, rows = profiled(run)
    rows = [e for e in device_rows(rows) if kernel in e.key]
    count = sum(e.count for e in rows)
    check(count == iters, f"profiler saw {count} launches of {kernel} in {iters} calls")
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def first_occluder_tests(o, d, v0, e0, e1, t_max) -> int:
    """Ray-triangle tests an any-hit sweep makes when it stops at the
    first occluder (all T when nothing occludes)."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.ops.intersect import _mt_candidates

    occ = _mt_candidates(o, d, v0, e0, e1) < t_max[:, None]
    first = torch.argmax(occ.to(torch.int32), dim=1)
    return int(torch.where(occ.any(1), first + 1, v0.shape[0]).sum())


def fused_work(MK, scene, cfg, px, py, sample, o, d):
    """(hits shaded, ray-triangle tests) that the fused kernel's paths
    need, counted on a run of its plain version ``MK.trace_paths``: per
    bounce, every live path sweeps all T triangles for its closest hit; a
    hit is shaded and casts a shadow ray when the light sample's
    unoccluded contribution is non-zero, tested up to its first occluder.
    The counts come from wrapping the module's ``bounce_step`` and
    ``_nee`` for this one call."""
    import torch

    n_tris = scene.num_triangles
    count = {"hits": 0, "tests": 0}
    live = {}
    bounce_step, nee, any_hit = MK.bounce_step, MK._nee, MK._any

    def counting_bounce(scene, cfg, sampler, px, py, sample, depth, state):
        live["alive"] = state.alive
        count["tests"] += int(state.alive.sum()) * n_tris
        return bounce_step(scene, cfg, sampler, px, py, sample, depth, state)

    def counting_nee(scene, cfg, *args):
        hit = args[5]
        shaded = live["alive"] & hit.hit
        count["hits"] += int(shaded.sum())
        shadow = {}

        def unoccluded(scene, cfg, so, sd, t_max):
            shadow["rays"] = (so, sd, t_max)
            return torch.zeros(so.shape[0], dtype=torch.bool, device=so.device)

        MK._any = unoccluded
        try:
            free = nee(scene, cfg, *args)
        finally:
            MK._any = any_hit
        so, sd, t_max = shadow["rays"]
        cast = shaded & (free != 0).any(-1)
        count["tests"] += first_occluder_tests(
            so[cast], sd[cast], scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max[cast]
        )
        return nee(scene, cfg, *args)

    MK.bounce_step, MK._nee = counting_bounce, counting_nee
    try:
        MK.trace_paths(scene, cfg, px, py, sample, o, d, device=o.device)
    finally:
        MK.bounce_step, MK._nee = bounce_step, nee
    return count["hits"], count["tests"]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused
    from cuda_optix_pathtracing_tpu_torch.ops import _cuda_build
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R
    from cuda_optix_pathtracing_tpu_torch.ops.camera import generate_rays, pixel_centers
    from cuda_optix_pathtracing_tpu_torch.ops.film import (
        film_sqrt_mse,
        film_variance,
        srgb_encode,
        to_uint8,
    )
    from cuda_optix_pathtracing_tpu_torch.ops.intersect import BIG_T
    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import (
        any_plain,
        anyhit_bruteforce,
        closest_bruteforce,
        closest_plain,
    )
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box
    from cuda_optix_pathtracing_tpu_torch.utils import cli
    from cuda_optix_pathtracing_tpu_torch.utils.imageio import write_png

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    print(card)
    tag = f"[{card}]"
    t0 = time.perf_counter()
    _cuda_build.build_all(["intersect", "megakernel"])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, parallel)")
    for name in ("intersect", "megakernel"):
        for line in _cuda_build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    scene = cornell_box(W, H, device=dev)
    v0, e0, e1 = scene.tri_v0, scene.tri_e0, scene.tri_e1
    n_tris = scene.num_triangles

    # camera rays of PARITY_SPP samples (the fused="off" path's first bounce)
    pix = pixel_centers(W, H, dev).repeat(PARITY_SPP, 1)
    sample = torch.repeat_interleave(
        torch.arange(PARITY_SPP, dtype=torch.int64, device=dev), W * H
    )
    px = pix[:, 0].to(torch.int64)
    py = pix[:, 1].to(torch.int64)
    u1, u2 = R.Sampler("hash", 0).sample_2d(px, py, sample, R.Dim.CAMERA_U)
    cam_o, cam_d = generate_rays(
        pix + torch.stack([u1, u2], -1), scene.cam_from_raster, scene.world_from_cam
    )
    # random rays through the box, from a fixed seed
    rs = np.random.default_rng(0)
    rnd_o = rs.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (N_RAYS, 3))
    rnd_d = rs.normal(size=(N_RAYS, 3))
    rnd_d /= np.linalg.norm(rnd_d, axis=1, keepdims=True)
    rnd_o = torch.as_tensor(rnd_o, dtype=torch.float32, device=dev)
    rnd_d = torch.as_tensor(rnd_d, dtype=torch.float32, device=dev)
    t_max = torch.as_tensor(rs.uniform(0.05, 6.0, N_RAYS), dtype=torch.float32, device=dev)

    # ---- 2. kernels against their plain versions on the card -------------
    print("phase 2: kernels against plain versions "
          f"({N_RAYS} camera + {N_RAYS} random rays, T={n_tris})")
    err = {}
    for label, o, d in (("camera", cam_o, cam_d), ("random", rnd_o, rnd_d)):
        tk, ik = closest_bruteforce(o, d, v0, e0, e1)
        tp, ip = closest_plain(o, d, v0, e0, e1)
        torch.cuda.synchronize()
        both = (tk < BIG_T) & (tp < BIG_T)
        dt = (tk - tp).abs()
        rel = dt / tp.abs().clamp(min=1e-30)
        # indices agree except on ties: rays whose two best t are within
        # 1e-6 relative (shared edges) may pick either triangle
        tie = rel <= 1e-6
        check(bool(((ik == ip) | tie).all()),
              f"closest {label}: best_i equal wherever the two t differ by > 1e-6 rel")
        check(bool(((tk < BIG_T) == (tp < BIG_T)).all()) and float(rel[both].max()) <= 1e-5,
              f"closest {label}: same hits, t within 1e-5 relative "
              f"(max rel {float(rel[both].max()):.2e}, max abs {float(dt[both].max()):.2e})")
        err["closest"] = max(err.get("closest", 0.0), float(dt[both].max()))
        tm = t_max if label == "random" else torch.full_like(t_max, 3.0)
        ok_ = anyhit_bruteforce(o, d, v0, e0, e1, tm)
        op_ = any_plain(o, d, v0, e0, e1, tm)
        torch.cuda.synchronize()
        agree = float((ok_ == op_).float().mean())
        check(agree >= 0.999, f"anyhit {label}: occlusion agrees on {agree:.6f} >= 0.999 of rays")
        err["anyhit"] = max(err.get("anyhit", 0.0), float((ok_ != op_).float().max()))

    cfg_plain = MK.MegakernelConfig(max_depth=DEPTH, backend="torch", fused="off")
    rad_k = trace_paths_fused(scene, px, py, sample, cam_o, cam_d, max_depth=DEPTH)
    rad_p = MK.trace_paths(scene, cfg_plain, px, py, sample, cam_o, cam_d, device=dev)
    torch.cuda.synchronize()
    acc_k = rad_k.reshape(PARITY_SPP, H * W, 3).sum(0)
    acc_p = rad_p.reshape(PARITY_SPP, H * W, 3).sum(0)
    diff = (acc_k - acc_p).abs() / PARITY_SPP
    check(bool(torch.isfinite(rad_k).all()), "fused: finite radiance")
    check(float(diff.mean()) < 1e-4,
          f"fused vs trace_paths: mean abs diff {float(diff.mean()):.2e} < 1e-4")
    frac = float((diff.max(-1).values > 1e-3).float().mean())
    check(frac < 0.005, f"fused vs trace_paths: {frac:.5f} of pixels off by > 1e-3 (< 0.005)")
    err["fused"] = float(diff.max())

    # ---- 3. the main path --------------------------------------------------
    print("phase 3: main path")
    counters = (trace_paths_fused, closest_bruteforce, anyhit_bruteforce)
    main_scene = cornell_box(W, H)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    film_on = MK.render(main_scene, W, H, spp=SPP_FUSED)
    torch.cuda.synchronize()
    dt_on = time.perf_counter() - t0
    launches_on = {c.__name__: c.launches for c in counters}
    print(f"  render fused: {launches_on}")
    check(launches_on["trace_paths_fused"] > 0, "default render went through the fused kernel")
    check(bool(torch.isfinite(film_on.mean).all()), "fused film finite")
    check(float(film_on.mean.mean()) > 0.0, f"fused film mean {float(film_on.mean.mean()):.5f} > 0")
    mpaths = W * H * SPP_FUSED / dt_on / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("cornell.png", "cornell_sqrt_mse.png")]
        for path, img in zip(paths, (film_on.mean, film_sqrt_mse(film_on))):
            write_png(path, to_uint8(srgb_encode(img)).cpu().numpy())
        check(all(os.path.getsize(p) > 0 for p in paths), "wrote the mean and sqrt-MSE PNGs")

    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.png")
        rc = cli.main(["--scene", "cornell", "--out", out, "--spp", str(SPP_CLI),
                       "--log-level", "warning"])
        torch.cuda.synchronize()
        launches_cli = {c.__name__: c.launches for c in counters}
        print(f"  CLI --scene cornell --spp {SPP_CLI}: {launches_cli}")
        check(rc == 0 and launches_cli["trace_paths_fused"] == SPP_CLI,
              "the CLI rendered through the fused kernel, one launch per spp")
        check(os.path.getsize(out) > 0
              and os.path.getsize(os.path.join(tmp, "cli_sqrt_mse.png")) > 0,
              "the CLI wrote the mean and sqrt-MSE PNGs")

    for c in counters:
        c.launches = 0
    film_off = MK.render(main_scene, W, H, spp=SPP_OFF,
                         cfg=MK.MegakernelConfig(fused="off"))
    torch.cuda.synchronize()
    launches_off = {c.__name__: c.launches for c in counters}
    print(f"  render fused='off': {launches_off}")
    check(launches_off["closest_bruteforce"] > 0 and launches_off["anyhit_bruteforce"] > 0,
          "fused='off' render went through the closest-hit and any-hit kernels")
    check(bool(torch.isfinite(film_off.mean).all()), "fused='off' film finite")
    # image means per channel agree within Monte Carlo noise: 5 standard
    # errors, from each film's per-pixel sample variance
    npix = W * H
    m_on = film_on.mean.reshape(-1, 3).mean(0)
    m_off = film_off.mean.reshape(-1, 3).mean(0)
    se2_on = film_variance(film_on).reshape(-1, 3).sum(0) / float(film_on.n) / npix**2
    se2_off = film_variance(film_off).reshape(-1, 3).sum(0) / float(film_off.n) / npix**2
    tol = 5.0 * torch.sqrt(se2_on + se2_off)
    check(bool(((m_on - m_off).abs() <= tol).all()),
          f"fused (64 spp) and fused='off' (8 spp) image means agree within 5 sigma: "
          f"{m_on.tolist()} vs {m_off.tolist()}, tol {tol.tolist()}")

    # ---- 4. timing at the main path's shapes -------------------------------
    print(f"phase 4: timing {tag}")
    n1 = W * H  # one sample per pixel per launch on the main path
    o1, d1 = cam_o[:n1].contiguous(), cam_d[:n1].contiguous()
    px1, py1, s1 = px[:n1], py[:n1], sample[:n1]
    ro1, rd1, tm1 = rnd_o[:n1].contiguous(), rnd_d[:n1].contiguous(), t_max[:n1].contiguous()

    saved = {c: c.launches for c in counters}
    # the main path's spread: repeated untraced renders, back to back,
    # before any profiler session
    mpaths_rep = []
    for _ in range(RENDER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MK.render(main_scene, W, H, spp=SPP_FUSED)
        torch.cuda.synchronize()
        mpaths_rep.append(W * H * SPP_FUSED / (time.perf_counter() - t0) / 1e6)
    calls = {
        "fused": lambda: trace_paths_fused(scene, px1, py1, s1, o1, d1, max_depth=DEPTH),
        "closest": lambda: closest_bruteforce(o1, d1, v0, e0, e1),
        "anyhit": lambda: anyhit_bruteforce(ro1, rd1, v0, e0, e1, tm1),
    }
    kernel_names = {
        "fused": "::pt_fused_bruteforce_kernel(",
        "closest": "::closest_kernel(",
        "anyhit": "::anyhit_kernel(",
    }
    ms = {k: kernel_ms(fn, 20, kernel_names[k]) for k, fn in calls.items()}
    call_ms = {k: cuda_ms(fn, 20) for k, fn in calls.items()}
    plain_ms = {
        "fused": cuda_ms(lambda: MK.trace_paths(scene, cfg_plain, px1, py1, s1, o1, d1, device=dev), 1),
        "closest": cuda_ms(lambda: closest_plain(o1, d1, v0, e0, e1), 10),
        "anyhit": cuda_ms(lambda: any_plain(ro1, rd1, v0, e0, e1, tm1), 10),
    }
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"  after timing: SM clock, max SM clock, power draw: {clocks}")
    # data-dependent work of the timed launches, counted on the plain
    # versions: the any-hit kernel stops at the first occluder
    hits, tests = fused_work(MK, scene, cfg_plain, px1, py1, s1, o1, d1)
    any_tests = first_occluder_tests(ro1, rd1, v0, e0, e1, tm1)
    # where the main path's time goes: one traced render through the
    # fused kernel (the profiler slows the host, so the wall time that
    # counts is dt_on above, untraced)
    wall_tr, rows = profiled(lambda: MK.render(main_scene, W, H, spp=SPP_TRACE))
    dev_rows = device_rows(rows)
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e6
    busy_k = sum(e.self_device_time_total for e in dev_rows
                 if kernel_names["fused"] in e.key) / 1e6
    n_launch = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
    n_sync = sum(e.count for e in rows if e.key == "cudaStreamSynchronize")
    for c, v in saved.items():  # timing launches are not main-path launches
        c.launches = v

    flops_fused = tests * MT_FLOPS + hits * SHADE_FLOPS
    # bytes: o, d in (24), px, py, sample^seed in (12), radiance out (12)
    b_fused = bound(flops_fused, n1 * (24 + 12 + 12))
    # bytes: o, d in (24); t (4) + index (4) out, or t_max in (4) + flag out (4)
    b_closest = bound(n1 * n_tris * MT_FLOPS, n1 * 32)
    b_any = bound(any_tests * MT_FLOPS, n1 * 32)

    launches_main = {
        "fused": launches_on["trace_paths_fused"],
        "closest": launches_off["closest_bruteforce"],
        "anyhit": launches_off["anyhit_bruteforce"],
    }
    spp_of = {"fused": SPP_FUSED, "closest": SPP_OFF, "anyhit": SPP_OFF}
    meta = {
        "fused": ("pt_fused_bruteforce",
                  "cuda_optix_pathtracing_tpu_torch/csrc/megakernel.cu",
                  "cuda_optix_pathtracing_tpu/models/megakernel_pallas.py:498", b_fused),
        "closest": ("closest_bruteforce",
                    "cuda_optix_pathtracing_tpu_torch/csrc/intersect.cu",
                    "cuda_optix_pathtracing_tpu/ops/intersect_pallas.py:39", b_closest),
        "anyhit": ("anyhit_bruteforce",
                   "cuda_optix_pathtracing_tpu_torch/csrc/intersect.cu",
                   "cuda_optix_pathtracing_tpu/ops/intersect_pallas.py:84", b_any),
    }
    kernels = []
    for key, (name, src, repl, (bms, bby)) in meta.items():
        per_spp = launches_main[key] / spp_of[key]
        print(f"  {name}: {ms[key]:.4f} ms/launch on the device at {n1} rays "
              f"({call_ms[key]:.4f} ms per wrapper call), plain {plain_ms[key]:.4f} ms, "
              f"{per_spp:g} launches/spp, bound {bms:.4f} ms ({bby}), library none {tag}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches_main[key], "max_abs_err": err[key],
            "ms": ms[key], "plain_ms": plain_ms[key], "bound_ms": bms,
            "bound_by": bby, "library_ms": None,
        })
    print(f"  fused kernel work: {hits} hits shaded, {tests} ray-triangle tests for "
          f"{n1} paths ({flops_fused / n1:.0f} flop/path); any-hit: {any_tests / n1:.2f} "
          f"tests/ray of {n_tris}")
    print(f"  render fused {W}x{H}x{SPP_FUSED} depth {DEPTH}: {dt_on:.3f} s, "
          f"{mpaths:.2f} Mpaths/s (host clock around render()); "
          f"{RENDER_REPEATS} more renders: "
          f"{', '.join(f'{m:.2f}' for m in mpaths_rep)} Mpaths/s {tag}")
    per = 1e3 / SPP_TRACE
    print(f"  traced render, per spp: {dt_on * 1e3 / SPP_FUSED:.3f} ms untraced wall, "
          f"device busy {busy * per:.3f} ms ({100 * busy * SPP_FUSED / SPP_TRACE / dt_on:.1f} % "
          f"of the untraced wall), fused kernel {busy_k * per:.3f} ms, "
          f"{n_launch / SPP_TRACE:.1f} kernel launches, {n_sync / SPP_TRACE:.1f} stream syncs; "
          f"traced wall {wall_tr * per:.3f} ms {tag}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

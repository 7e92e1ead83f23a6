#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Two procedural scenes, each down every route of the port, then the
bundled scene files (phase 6), then instanced and many-lights scenes
(phase 7), then the multi-rank, wavefront and debugging paths (phase 8):

- the Cornell box (26 triangles, brute force): the fused kernel
  ``pt_fused_bruteforce`` and, with ``fused="off"``, the closest-hit and
  any-hit kernels ``closest_bruteforce`` and ``anyhit_bruteforce``; with
  the hash sampler, and with the Owen-scrambled Halton sampler (the fused
  kernel's Halton instantiation), with and without the Mitchell filter;
- the mesh Cornell box of ``bench.py``'s second leg
  (``cornell_box_mesh(256, 256, subdiv=64)``: 16,138 triangles in 23,568
  packed rows, a 432-node BVH): with ``fused="off"`` the sorted wavefront,
  whose queries go to the traversal kernels ``bvh_closest`` and
  ``bvh_anyhit`` (over the scene's compact tables, as the fused BVH
  kernels); with ``fused="on"`` the fused kernel's BVH mode
  ``pt_fused_bvh`` (hash and Halton; persistent blocks that regenerate
  paths over the compact node table); and the
  depth-sorted fused wavefront ``trace_paths_fused_sorted``, one launch of
  the single-bounce kernel ``pt_bounce_bvh`` per depth (hash and Halton),
  each launch in the order of the sort keys the last one wrote.

Phases (each fails loudly; there is no CPU fallback):

1. card and build: the card's name and power limit, every CUDA source
   built from ``cuda_optix_pathtracing_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) beside the ``g++`` build of the BVH builder, with
   ptxas' register/spill lines;
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, to the tolerances stated below (the mesh kernels also at
   the main path's own launches, in phase 4): the Halton fused kernel in
   both modes, and the single-bounce kernel column by column against
   ``bounce_step`` at depths 0, 1 (sorted) and 3 (sorted, many dead
   paths) of the 1,048,576-path mesh pass, its keys against
   ``path_keys``; the fused BVH kernel at n = 0, 1, 37 and 65,549; both
   BVH kernels on a deeper tree whose nodes exceed L1 (subdivision 128);
   the closest-hit and any-hit kernels on camera and random rays, flags
   equal and the rows that differ printed;
3. the main paths, launch counters zeroed just before and read just after
   each run: ``render(cornell_box)`` at 64 spp (fused kernel), the CLI
   (8 spp), ``render`` at 8 spp with ``fused="off"``; the same renders and
   the CLI with ``sampler="halton"``, and with the Mitchell filter; then
   the bench's mesh leg, ``render(mesh, spp=16, kspp=16, spp_per_pass=16)``
   with ``fused="off"`` and with ``fused="on"`` (hash and Halton), the CLI
   on ``cornell-mesh``, and ``trace_paths_fused_sorted`` on the leg's
   1,048,576 camera rays (hash and Halton), held to ``pt_fused_bvh`` on
   the same rays bit for bit;
4. the kernels against their plain versions at the main path's own
   launches, recorded from one more render of each route: kernels 2 and 3
   at every launch of a Cornell ``fused="off"`` render (8 spp, 40 + 40
   launches of 65,536 rays; t, index and flags equal on every row),
   kernel 4 at a 1,048,576-ray launch (sorted, with parked dead rays;
   every 512th ray also held to the numpy oracle ``traverse_packed_ref``
   bit for bit), kernel 5 at the 1,048,576-path launch (every 8th path
   held to ``trace_paths``); then timing lines: each kernel's device time
   per launch (torch.profiler; kernels 2 and 3 the mean over their
   recorded launches, beside an empty kernel's time, the card's
   per-launch floor; kernels 5 and 6 at their 1,048,576-path
   launches; kernel 1 also at 1,048,576 paths, 16 spp in one launch, to
   tell the fill of the main path's one-wave launch from the cost per path),
   the wrapper call's time (CUDA events), its plain version's time,
   launches per spp and its bound; the single-bounce kernel's device time
   (CUDA events around launches queued behind a device sleep) and bound
   at each depth, the sort between depths op by op, and the share of
   lane-bounces a warp of one path per thread would keep busy; the
   Mpaths/s of repeated renders of both scenes and routes, of the
   ``fused="off"`` route with and without the ray sort and Morton pixel
   order, and of the depth-sorted wavefront against the fused kernel in
   turns; traced renders' device-busy shares;
5. gradients (``models/differentiable.py``; the ``fused="off"`` route with
   path replay, kernels 2 and 3 in the forward pass and again in the
   replay): bench.py's albedo-gradient step (256², depth 5, 4 spp as one
   262,144-path pass, launch counters zeroed just before and read just
   after) on the kernel route against the plain sweep; replay per bounce
   and per two bounces against stored activations, with peak memory;
   finite differences at 32², depth 2; three Adam steps whose loss must
   fall, then the optimised scene through the fused kernel against
   ``trace_paths``; a mesh step through kernel 4 against the plain sweep;
   fwd+bwd Mpaths/s as bench.py times it, and one traced step;
6. scene files (``scene/parser.py``, ``scene/pbrt.py``), launch counters
   zeroed just before and read just after each run: ``scene_test.json``
   (the textured teapot: 9,216 triangles and a BVH, three 1K textures with
   their mip chains, shading normals and a normal map) through
   ``load_scene`` and ``render()`` at its authored 256², 32 spp, depth 12,
   through kernel 4, with Mpaths/s, kernel-4 launches per spp and the
   device-busy share of one traced spp; the kernel route against
   ``backend="torch"`` at 2 spp on ``scene_test.json`` and on
   ``scene_example.json`` (the HDR veranda map, env NEE on; kernels 2 and
   3) at the parity bar; kernel 4 at every recorded launch of one
   textured spp against the plain sweep; ``cornell-box.pbrt`` through
   kernel 1 against ``trace_paths``; no fused kernel in the profiler's
   trace of ``fbx_example.json`` (shading normals) or ``scene_test.json``;
   the CLI on ``scene_test.json`` at its authored settings, writing its
   PNGs to ``chiprun_out/``;
7. the light tree and instancing (``fused="off"``: the fused gate refuses
   both), each render at 256², depth 5, 16 spp as one 1,048,576-path pass
   with the counts zeroed just before and read just after, and one traced
   pass (device-busy share, host launches, no ``pt_fused_*`` or
   ``pt_bounce_*`` kernel): (B) ``cornell_box_mesh_instanced`` (walls as
   an identity instance, two 8,192-triangle sphere meshes, one instance
   each) through kernel 4 once per instance and query, against the baked
   ``cornell_box_mesh`` at the reference's bar, kernel 4 at the pass's
   recorded launches on each instance's mesh against the plain sweep
   (every 4th ray), the rays each instance's box culls; (A)
   ``cornell_box_many_lights`` (an 8×8 grid of emissive ceiling quads:
   129 light records, a tree built on the host) with ``nee_splits`` 1 and
   4 through kernel 4, against uniform selection within 5 sigma, the
   tree's MSE below 0.6× uniform's against a converged tree image, and
   the kernel route bit-equal to ``backend="torch"`` at 2 spp;
8. the sharded render and step, the wavefronts, the NaN guard and the
   CLI's multi-process mode (``parallel/``, ``models/wavefront.py``), at
   256², depth 5, each run with the counts zeroed just before and read
   just after, and no fused kernel in a traced spp: (a) a group of one
   rank on NCCL in this process, ``render_multihost`` of the Cornell box
   (8 spp, kernels 2 and 3) and the mesh box (4 spp, kernel 4), each film
   bit-equal to the unsharded Welford loop, with Mpaths/s; (b) the same
   renders by two processes sharing the card (gloo; this script started
   again with ``--phase8-rank``), the gathered films bit-equal to (a)'s,
   each rank's wall and host launches, the aggregate Mpaths/s; (c)
   bench.py's albedo step (4 spp, ``remat=True``) sharded at world 1 and
   2, loss within 1e-6 relative and gradient within the reference's bar
   of ``make_loss``'s, three Adam steps lowering the loss, fwd+bwd
   Mpaths/s; (d) the dense wavefront bit-equal to ``render(fused="off",
   pixel_order="linear")``, the depth its loop reached; (e) the pool at
   16 spp within 3e-5 (mean) and 3e-4 (M2) of ``render(fused="off")``,
   its iterations, device kernels and device-busy share beside the dense
   route's Mpaths/s; (f) the NaN guard on a poisoned albedo and on a
   clean 64² render; (g) two CLI processes (``--phase8-cli``) at 64², 4
   spp, rank 0's PNGs byte-equal to a one-process run's;
then one JSON line with every kernel, and as the last line
``{"ok": true, "device": ...}``.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
FP32_FLOPS = 67e12  # non-tensor FP32
INT32_OPS = 33.5e12  # 64 of an SM's 128 FP32 lanes also run INT32 (Hopper
# white paper): half the FP32 rate
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
# the mesh leg of bench.py: subdivision 64, 16 spp traced as one pass
MESH_SUBDIV = 64
MESH_SPP = 16
MESH_PARITY_STRIDE = 8  # kernel 5 at its main-path launch: every 8th path
MESH_CLI_SPP = 4
K6_CHECK_DEPTHS = (0, 1, 3)  # kernel 6 held to bounce_step at these depths
K6_STRIDE = 8  # ... on every 8th path of the 1,048,576-path pass
# kernel 6's bytes per path: a live path reads 20 words of its row and
# writes 17 and its key; a dead one reads its flag and writes its key;
# after depth 0 each also reads its row index from the permutation
K6_BYTES_LIVE = 4 * (20 + 17 + 1)
K6_BYTES_DEAD = 4 * (1 + 1)
K6_BYTES_PERM = 8
K5_SIZES = (0, 1, 37, 65_549)  # kernel 5 held to its plain version at these n
MESH_BIG_SUBDIV = 128  # a deeper tree (depth 8) whose 396 KB of nodes exceed L1
# the Halton sampler's integer work: pcg4d for the pixel seed (~36
# operations), then per odd-base digit a division, the digit, the prefix
# hash (pcg_hash and its key, 11), the scrambled digit's sum and modulo,
# the prefix update and the conversion (~20 in all)
PCG4D_OPS = 36
HALTON_DIGIT_OPS = 20
HALTON_BASE2_OPS = 14
# flop model of bench.py: ~45 flops per ray-triangle test, ~800 per
# shaded hit; a BVH slab test of one child box: 6 subtractions, 6
# multiplies, 6 min/max to order the slab ends, 3 max for tn, 3 min for
# tf and the compare. The bounds take the work this run's data needs
# (tests made, boxes tested, hits shaded), counted on the plain versions
# or, for traversals, on traverse_packed_ref over a sample of the rays
# (real triangles only: pad rows are not work the function needs)
MT_FLOPS = 45
SHADE_FLOPS = 800
SLAB_FLOPS = 25
BOUND_SAMPLE = 2048
PROFILE_MARGIN_S = 0.02  # idle card at each end of a profiler session
# the gradient phase: bench.py's fwd_bwd leg (bench.py:56-88): 4 spp traced
# as one 262,144-path pass per step, the albedo gradient, path replay
GRAD_SPP = 4
GRAD_ITERS = 4  # steps per timed run, two runs (bench.py:_fwd_bwd)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-9  # the reference's remat test bar
ADAM_STEPS = 3
# finite differences at a small size and the reference test's depth 2:
# roulette (from depth 2 on) kills paths by comparing a function of the
# albedo with a random number, a step a central difference straddles
FD_SIZE, FD_SPP, FD_DEPTH = 32, 2, 2
FD_CASES = (("albedo", (2, 0)), ("light_color", (0, 0)))  # tests/test_gradients.py
GRAD_MESH_SUBDIV, GRAD_MESH_SIZE, GRAD_MESH_SPP = 16, 64, 2
FLOOR_THREADS = W * H  # the empty kernel's launch: the main path's 65,536 rays
# phase 6, scene files: scene_test.json at its authored 256², 32 spp,
# depth 12 (its film and camera sections), the kernel route against the
# plain one at SCENE_PARITY_SPP samples in one pass, and the PBRT Cornell
# box through kernel 1 at PARITY_SPP
SCENE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
SCENE_PARITY_SPP = 2
SCENE_KSPP = 8  # samples per progressive batch, the CLI's default
SCENE_K4_STRIDE = 4  # kernel 4's recorded launches: every 4th ray held to
# the plain sweep (each ray's result depends on that ray alone)
SCENE_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                         "scene_test.png")
# phase 7, the light tree and instancing: scenes at 256², depth 5,
# MESH_SPP samples in one pass; the many-lights box's converged tree image
# for the MSE check, and the spp at which the kernel and plain routes are
# held bit for bit
TREE_REF_SPP = 128
TREE_BIT_SPP = 2
PLAIN_CHUNK = 256  # triangles per step of phase 7's plain sweeps (their
# results do not depend on it: the first of equal t wins either way)
# phase 8, the sharded render and step, the wavefronts, the NaN guard and
# the CLI's multi-process mode, at 256², depth 5: the sharded and dense
# renders at SPP_OFF samples (Cornell, kernels 2 and 3) and SHARD_MESH_SPP
# (the mesh box, kernel 4); the pool at pool_bench.py's 16 spp; the step
# at GRAD_SPP, sample by sample
SHARD_MESH_SPP = 4
POOL_SPP = 16
POOL_TRACE_SPP = 4  # the traced pool run: its device-busy share and kernels
POOL_MEAN_ATOL, POOL_M2_ATOL = 3e-5, 3e-4  # tests/test_wavefront.py:75-80
SHARD_LOSS_RTOL = 1e-6
SHARD_GRAD_RTOL = 1e-4  # and atol 1e-4·max|g| (tests/test_sharded.py:117-127)
NAN_SIZE = 64
CLI_MP_SIZE, CLI_MP_SPP = 64, 4
WORKER_TIMEOUT_S = 420
# an empty kernel, built beside the port's kernels: the card's per-launch
# floor, timed beside the bounds
FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int n_threads, void* stream) {
  empty_kernel<<<(n_threads + 255) / 256, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


# the profiler's names of the port's kernels (``is_kernel`` parts)
KERNEL_NAMES = {
    "fused": ("::pt_fused_kernel<", "BruteGeo", "HashRng>"),
    "fused_halton": ("::pt_fused_kernel<", "BruteGeo", "HaltonRng>"),
    "closest": "::closest_kernel(",
    "anyhit": "::anyhit_kernel(",
    "bvh_closest": "::bvh_closest_kernel(",
    "bvh_anyhit": "::bvh_anyhit_kernel(",
    "fused_bvh": ("::pt_fused_bvh_kernel<", "HashRng>"),
    "fused_bvh_halton": ("::pt_fused_bvh_kernel<", "HaltonRng>"),
    "bounce": ("::pt_bounce_kernel<", "HashRng>"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_floor_kernel(tmp: str):
    """Compile ``FLOOR_CU`` with the port's nvcc flags in ``tmp`` and load
    it (ctypes)."""
    import ctypes

    from cuda_optix_pathtracing_tpu_torch.ops import _cuda_build

    src, out = os.path.join(tmp, "floor.cu"), os.path.join(tmp, "floor.so")
    with open(src, "w") as f:
        f.write(FLOOR_CU)
    subprocess.run([_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(out)
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def warm_up(fn, seconds: float = 0.3) -> None:
    """Call ``fn`` for ``seconds`` (at least once) so the card leaves its
    idle clocks."""
    import torch

    t_end = time.perf_counter() + seconds
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() >= t_end:
            return


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


def queued_ms(make_launch, n: int = 5, reps: int = 3) -> float:
    """Device time per launch of ``n`` launches run back to back, each
    ``make_launch()`` returning a callable that launches one kernel (its
    inputs made beforehand): the median over ``reps`` windows of CUDA
    events around the launches, queued behind a ~2 ms device sleep so the
    host has queued them all before the first one starts. This times the
    device alone where the profiler loses records: it kept 0-3 of 5 of
    back-to-back single-bounce launches that no PyTorch op precedes."""
    import torch

    for _ in range(3):
        make_launch()()
    times = []
    for _ in range(reps):
        launches = [make_launch() for _ in range(n)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for launch in launches:
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def profiled(fn):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity) →
    (host seconds, key_averages). Device times come from CUPTI. The card
    is idle for ``PROFILE_MARGIN_S`` after the session starts and before
    it stops, so no kernel of ``fn`` lies near the edges of its window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    return wall, prof.key_averages()


def device_rows(rows):
    from torch.autograd import DeviceType

    return [e for e in rows if e.device_type == DeviceType.CUDA]


def is_kernel(key: str, kernel) -> bool:
    """Does the profiler's kernel name ``key`` hold every part of
    ``kernel`` (a string or a tuple of strings)?"""
    parts = (kernel,) if isinstance(kernel, str) else kernel
    return all(p in key for p in parts)


def kernel_ms(fn, iters: int, kernel, per_call: int = 1) -> float:
    """Device time per launch of the CUDA kernel named by ``kernel``
    (``is_kernel``), from the profiler over ``iters`` calls of ``fn`` (each
    launching it ``per_call`` times) after warm-up. CUDA events around the
    calls would time the host instead: the wrappers' small PyTorch ops and
    syncs outlast the kernel.

    The profiler may lose a kernel's record now and then (one of 20 in
    one run on an H100), so the time is the mean over the records it
    kept. A count above the launches made would mean the name matched
    another kernel, and fails, as does a count of 0."""
    warm_up(fn)

    def run():
        for _ in range(iters):
            fn()

    _, rows = profiled(run)
    rows = [e for e in device_rows(rows) if is_kernel(e.key, kernel)]
    count = sum(e.count for e in rows)
    made = iters * per_call
    check(0 < count <= made,
          f"profiler saw {count} of the {made} launches of {kernel} in {iters} calls"
          + ("" if count == made else f" (lost {made - count} records; timed on the rest)"))
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def traced_render(fn, spp: int, kernels: dict):
    """One render under the profiler → (device-busy seconds, {name:
    (launches, device seconds)} of ``kernels`` (name → ``is_kernel`` part),
    host kernel launches and stream syncs), per ``spp``."""
    wall, rows = profiled(fn)
    dev_rows = device_rows(rows)
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e6
    per_kernel = {
        name: (sum(e.count for e in dev_rows if is_kernel(e.key, k)),
               sum(e.self_device_time_total for e in dev_rows if is_kernel(e.key, k)) / 1e6)
        for name, k in kernels.items()
    }
    n_launch = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
    n_sync = sum(e.count for e in rows if e.key == "cudaStreamSynchronize")
    return busy / spp, per_kernel, n_launch / spp, n_sync / spp, wall / spp


def bound(flops: float, nbytes: float, int_ops: float = 0.0):
    t_ops = flops / FP32_FLOPS + int_ops / INT32_OPS
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def halton_int_ops(R, dims) -> int:
    """Integer operations of one Halton draw of each dimension in
    ``dims`` (the kernel's halton_owen)."""
    ops = 0
    for dim in dims:
        base = R.PRIMES[dim % len(R.PRIMES)]
        ops += PCG4D_OPS + (HALTON_BASE2_OPS if base == 2
                            else R.n_digits(base) * HALTON_DIGIT_OPS)
    return ops


def halton_depth0_dims(R, rr_start_depth: int):
    """The Halton dimensions a shaded path draws in the kernel at depth 0
    (light pick and sample, BSDF sample and lobe; roulette only when it
    starts at depth 0), below the default qmc_dims. The camera's two dims
    are drawn outside the kernel."""
    dims = [R.Dim.LIGHT_SELECT, R.Dim.LIGHT_U, R.Dim.LIGHT_U + 1, R.Dim.BSDF_U,
            R.Dim.BSDF_U + 1, R.Dim.BSDF_UC] + ([R.Dim.RR] if rr_start_depth == 0 else [])
    return [int(x) for x in dims if x < R.QMC_DIMS]


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
    count = {"hits": 0, "tests": 0, "hits0": None}
    live = {}
    bounce_step, nee, any_hit = MK.bounce_step, MK._nee, MK._any

    def counting_bounce(scene, cfg, sampler, px, py, sample, depth, state):
        live["alive"] = state.alive
        count["tests"] += int(state.alive.sum()) * n_tris
        return bounce_step(scene, cfg, sampler, px, py, sample, depth, state)

    def counting_nee(scene, cfg, *args, **kw):
        hit = args[5]
        shaded = live["alive"] & hit.hit
        count["hits"] += int(shaded.sum())
        if count["hits0"] is None:
            count["hits0"] = int(shaded.sum())
        shadow = {}

        def unoccluded(scene, cfg, so, sd, t_max, alive=None):
            shadow["rays"] = (so, sd, t_max)
            return torch.zeros(so.shape[0], dtype=torch.bool, device=so.device)

        MK._any = unoccluded
        try:
            free = nee(scene, cfg, *args, **kw)
        finally:
            MK._any = any_hit
        so, sd, t_max = shadow["rays"]
        cast = shaded & (free != 0).any(-1)
        count["tests"] += first_occluder_tests(
            so[cast], sd[cast], scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max[cast]
        )
        return nee(scene, cfg, *args, **kw)

    MK.bounce_step, MK._nee = counting_bounce, counting_nee
    try:
        MK.trace_paths(scene, cfg, px, py, sample, o, d, device=o.device)
    finally:
        MK.bounce_step, MK._nee = bounce_step, nee
    return count["hits"], count["tests"], count["hits0"]


def traversal_counts(scene, o, d, mode="closest", t_max=None):
    """(boxes slab-tested, triangles tested) by the per-ray traversal of
    these rays, walked by ``traverse_packed_ref`` (the kernels' numpy
    oracle, step for step). Only real triangles count: a leaf's pad rows
    never hit, so testing them is not work the traversal needs."""
    from cuda_optix_pathtracing_tpu_torch.ops.bvh import traverse_packed_ref

    b = scene.bvh
    tables = (b.box, b.meta, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    *_, c = traverse_packed_ref(*tables, o, d, mode, t_max, perm=b.perm)
    return int(c["slabs"].sum()), int(c["tests"].sum())


def traversal_work(scene, o, d, mode="closest", t_max=None):
    """(flop, boxes per ray, triangles per ray) that traversing all N
    rays needs: the counts of ``BOUND_SAMPLE`` of them, drawn with a fixed
    seed, scaled to N."""
    import numpy as np
    import torch

    n = o.shape[0]
    pick = np.random.default_rng(0).choice(n, min(BOUND_SAMPLE, n), replace=False)
    pick = torch.as_tensor(pick, device=o.device)
    slabs, tests = traversal_counts(
        scene, o[pick], d[pick], mode, None if t_max is None else t_max[pick]
    )
    k = len(pick)
    return (slabs * SLAB_FLOPS + tests * MT_FLOPS) * n / k, slabs / k, tests / k


def bvh_fused_work(MK, scene, cfg, px, py, sample, o, d):
    """(hits shaded, boxes slab-tested, triangles tested) per depth that
    the BVH kernels' paths need (the fused kernel's, and the single-bounce
    kernel's at each depth), counted on a run of their plain version
    ``MK.trace_paths`` over the same paths: per bounce, every live path's
    closest-hit traversal, and the shadow ray's any-hit traversal where
    the light sample's contribution is non-zero (the rays the plain
    integrator marks live for the BVH kernels), each walked by
    ``traverse_packed_ref`` → three lists, one entry per depth."""
    count = {"hits": [], "slabs": [], "tests": []}
    closest, any_hit, bounce_step = MK._closest, MK._any, MK.bounce_step

    def add(slabs_tests):
        count["slabs"][-1] += slabs_tests[0]
        count["tests"][-1] += slabs_tests[1]

    def counting_bounce(*args):
        for v in count.values():
            v.append(0)
        return bounce_step(*args)

    def counting_closest(scene, cfg, o, d, alive=None):
        hit = closest(scene, cfg, o, d, alive=alive)
        add(traversal_counts(scene, o[alive], d[alive]))
        count["hits"][-1] += int((hit.hit & alive).sum())
        return hit

    def counting_any(scene, cfg, o, d, t_max, alive=None):
        add(traversal_counts(scene, o[alive], d[alive], "any", t_max[alive]))
        return any_hit(scene, cfg, o, d, t_max, alive=alive)

    MK._closest, MK._any, MK.bounce_step = counting_closest, counting_any, counting_bounce
    try:
        MK.trace_paths(scene, cfg, px, py, sample, o, d, device=o.device)
    finally:
        MK._closest, MK._any, MK.bounce_step = closest, any_hit, bounce_step
    return count["hits"], count["slabs"], count["tests"]


def camera_rays(scene, spp: int, morton: bool = False, sampler: str = "hash"):
    """Camera rays of samples 0..spp-1 for every pixel, as
    ``render_sample_batch`` makes them (pixel order Morton or row-major,
    box filter, the given sampler) → (px, py, sample, o, d)."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.ops import rng as R
    from cuda_optix_pathtracing_tpu_torch.ops.camera import generate_rays, pixel_centers
    from cuda_optix_pathtracing_tpu_torch.ops.morton import morton_pixel_order

    dev = scene.device
    pix = pixel_centers(W, H, dev)
    if morton:
        pix = pix[torch.as_tensor(morton_pixel_order(W, H), device=dev)]
    pix = pix.repeat(spp, 1)
    sample = torch.repeat_interleave(torch.arange(spp, dtype=torch.int64, device=dev), W * H)
    px = pix[:, 0].to(torch.int64)
    py = pix[:, 1].to(torch.int64)
    u1, u2 = R.Sampler(sampler, 0).sample_2d(px, py, sample, R.Dim.CAMERA_U)
    o, d = generate_rays(
        pix + torch.stack([u1, u2], -1), scene.cam_from_raster, scene.world_from_cam
    )
    return px, py, sample, o, d


def depth0_rays(MK, scene, cfg, px, py, sample, o, d):
    """The live bounce rays (o, d) and the cast shadow rays (o, d, t_max)
    of one bounce of a plain run of ``MK.bounce_step`` at depth 0."""
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R

    shadow = {}
    any_hit = MK._any

    def recording(scene, cfg, so, sd, t_max, alive=None):
        shadow["rays"] = (so, sd, t_max, alive)
        return any_hit(scene, cfg, so, sd, t_max, alive=alive)

    MK._any = recording
    try:
        st = MK.bounce_step(scene, cfg, R.Sampler("hash", 0), px, py, sample, 0,
                            MK.init_path_state(o.shape[0], o, d))
    finally:
        MK._any = any_hit
    so, sd, t_max, cast = shadow["rays"]
    return (st.o[st.alive], st.d[st.alive]), (so[cast], sd[cast], t_max[cast])


def record_bvh_launches(MK, fn):
    """Run ``fn`` with the integrator's view of the BVH kernels' module
    (``MK.bvh_cuda``) shimmed to keep a copy of every launch's rays →
    {"closest": [(o, d)], "any": [(o, d, t_max)]}, and under
    "closest_tables" and "any_tables" the tables each launch walked (the
    scene's, or an instance mesh's). The wrappers themselves stay in place,
    so their launch counts stay true."""
    import types

    import torch

    rec = {"closest": [], "any": [], "closest_tables": [], "any_tables": []}
    BV = MK.bvh_cuda

    def rec_closest(o, d, scene):
        rec["closest"].append((o.clone(), d.clone()))
        rec["closest_tables"].append(scene)
        return BV.bvh_closest_raw(o, d, scene)

    def rec_any(o, d, scene, t_max):
        t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                               (o.shape[0],))
        rec["any"].append((o.clone(), d.clone(), t.clone()))
        rec["any_tables"].append(scene)
        return BV.bvh_any_raw(o, d, scene, t_max)

    MK.bvh_cuda = types.SimpleNamespace(bvh_closest_raw=rec_closest, bvh_any_raw=rec_any)
    try:
        fn()
    finally:
        MK.bvh_cuda = BV
    return rec


def record_brute_launches(MK, fn):
    """Run ``fn`` with the integrator's view of the brute-force kernels'
    module (``MK.intersect_cuda``) shimmed to keep a copy of every launch's
    rays → {"closest": [((o, d), kw)], "any": [((o, d, t_max), kw)]}, with
    the keyword arguments (``rows=``) the integrator passed, kept as given.
    The wrappers themselves stay in place, so their launch counts stay
    true."""
    import types

    import torch

    rec = {"closest": [], "any": []}
    IC = MK.intersect_cuda

    def rec_closest(o, d, v0, e0, e1, **kw):
        rec["closest"].append(((o.clone(), d.clone()), kw))
        return IC.closest_bruteforce(o, d, v0, e0, e1, **kw)

    def rec_any(o, d, v0, e0, e1, t_max, **kw):
        t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                               (o.shape[0],))
        rec["any"].append(((o.clone(), d.clone(), t.clone()), kw))
        return IC.anyhit_bruteforce(o, d, v0, e0, e1, t_max, **kw)

    MK.intersect_cuda = types.SimpleNamespace(closest_bruteforce=rec_closest,
                                              anyhit_bruteforce=rec_any)
    try:
        fn()
    finally:
        MK.intersect_cuda = IC
    return rec


def record_fused_launches(MKC, fn):
    """Run ``fn`` with the fused kernel's wrapper, which
    ``render_sample_batch`` looks up in ``MKC`` (its module) at each call,
    shimmed to keep a copy of every launch's inputs → [((px, py, sample,
    o, d), keyword arguments)]. The wrapper itself runs, with its module
    name restored for the call (it counts its launches on itself, looked
    up by that name), so its launch count stays true."""
    import torch

    rec = []
    fused = MKC.trace_paths_fused

    def rec_fused(scene, px, py, sample, o, d, **kw):
        sample_c = sample.clone() if torch.is_tensor(sample) else sample
        rec.append(((px.clone(), py.clone(), sample_c, o.clone(), d.clone()), kw))
        MKC.trace_paths_fused = fused
        try:
            return fused(scene, px, py, sample, o, d, **kw)
        finally:
            MKC.trace_paths_fused = rec_fused

    MKC.trace_paths_fused = rec_fused
    try:
        fn()
    finally:
        MKC.trace_paths_fused = fused
    return rec


def launch_counters():
    """(the kernel wrappers, zero, read): ``zero`` sets every wrapper's
    launch count to 0, ``read`` returns them by name, each after a sync."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops import intersect_cuda as IC

    counters = (MKC.trace_paths_fused, IC.closest_bruteforce, IC.anyhit_bruteforce,
                BV.bvh_closest_raw, BV.bvh_any_raw, MKC.bounce_fused)

    def zero():
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0

    def read():
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    return counters, zero, read


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def check_closest(label, tk, ik, tp, ip) -> float:
    """Kernel (tk, ik) against plain (tp, ip) closest hits: the same rays
    hit, t within 1e-5 relative, rows equal except on ties (two t within
    1e-6 relative, shared edges) → max abs t error."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.ops.intersect import BIG_T

    torch.cuda.synchronize()
    both = (tk < BIG_T) & (tp < BIG_T)
    dt = (tk - tp).abs()
    rel = dt / tp.abs().clamp(min=1e-30)
    tie = rel <= 1e-6
    check(bool(((ik == ip) | tie).all()),
          f"{label}: rows equal wherever the two t differ by > 1e-6 rel")
    max_rel = float(rel[both].max()) if bool(both.any()) else 0.0
    max_abs = float(dt[both].max()) if bool(both.any()) else 0.0
    check(bool(((tk < BIG_T) == (tp < BIG_T)).all()) and max_rel <= 1e-5,
          f"{label}: same hits ({int(both.sum())} of {tk.shape[0]}), t within 1e-5 relative "
          f"(max rel {max_rel:.2e}, max abs {max_abs:.2e})")
    return max_abs


def check_parity(label, rad_k, rad_p, spp: int, ref: str = "trace_paths") -> float:
    """The reference parity bar on per-pixel means over ``spp`` samples →
    max abs pixel difference."""
    import torch

    torch.cuda.synchronize()
    acc_k = rad_k.reshape(spp, -1, 3).sum(0)
    acc_p = rad_p.reshape(spp, -1, 3).sum(0)
    diff = (acc_k - acc_p).abs() / spp
    check(bool(torch.isfinite(rad_k).all()), f"{label}: finite radiance")
    check(float(diff.mean()) < 1e-4,
          f"{label} vs {ref}: mean abs diff {float(diff.mean()):.2e} < 1e-4")
    frac = float((diff.max(-1).values > 1e-3).float().mean())
    check(frac < 0.005, f"{label} vs {ref}: {frac:.5f} of pixels off by > 1e-3 (< 0.005)")
    return float(diff.max())


def check_planes(MKC, label, sk, sp) -> float:
    """The single-bounce kernel's state rows ``sk`` against the plain
    bounce's ``sp`` (the same paths), column by column: the keys and slots
    equal; the flags (alive, inside, prev_delta) equal on 99.99 % of the
    paths; o and d within 1e-5 (relative, or absolute near 0); beta,
    eta_scale and prev_pdf within 1e-5 relative on 99 % of the paths and
    within 1e-3 on 99.9 %; radiance within the parity bar → max abs
    radiance error. The kernel rounds the shading math otherwise than
    PyTorch (FMAs, acosf): a few ulp, which a sharp GGX lobe's pdf, a ratio
    f / pdf or the Oren-Nayar term's cancellation can magnify past 1e-5,
    and which can flip a lobe or roulette decision that lies within them."""
    import torch

    torch.cuda.synchronize()
    ik, ip = sk.view(torch.int32), sp.view(torch.int32)
    n = sk.shape[0]
    for name, c in (("px", MKC.PX), ("py", MKC.PY), ("sample", MKC.SAMPLE), ("slot", MKC.SLOT)):
        check(bool((ik[:, c] == ip[:, c]).all()), f"{label}: {name} column equal")
    for name, c in (("alive", MKC.ALIVE), ("inside", MKC.INSIDE), ("prev_delta", MKC.PREV_DELTA)):
        n_diff = int((ik[:, c] != ip[:, c]).sum())
        check(n_diff <= 1e-4 * n, f"{label}: {name} column equal on all but {n_diff} of {n} "
              f"paths (<= 0.01 %)")
    gap = (sk[:, :MKC.BETA] - sp[:, :MKC.BETA]).abs()
    tol = 1e-5 * torch.maximum(sp[:, :MKC.BETA].abs(), torch.ones_like(gap))
    check(bool((gap <= tol).all()),
          f"{label}: o, d within 1e-5 (max abs {float(gap.max()):.2e})")
    for name, c0, c1 in (("beta", MKC.BETA, MKC.BETA + 3), ("eta_scale", MKC.ETA_SCALE, MKC.ETA_SCALE + 1),
                         ("prev_pdf", MKC.PREV_PDF, MKC.PREV_PDF + 1)):
        rel = (sk[:, c0:c1] - sp[:, c0:c1]).abs() / sp[:, c0:c1].abs().clamp(min=1e-30)
        frac = float((rel > 1e-5).float().mean())
        frac3 = float((rel > 1e-3).float().mean())
        check(frac <= 1e-2 and frac3 <= 1e-3,
              f"{label}: {name} within 1e-5 relative on {1 - frac:.6f} of the paths (>= 0.99), "
              f"within 1e-3 on {1 - frac3:.6f} (>= 0.999); max rel {float(rel.max()):.2e}")
    rad = slice(MKC.RADIANCE, MKC.RADIANCE + 3)
    diff = (sk[:, rad] - sp[:, rad]).abs()
    check(float(diff.mean()) < 1e-4 and float((diff.max(1).values > 1e-3).float().mean()) < 0.005,
          f"{label}: radiance mean abs diff {float(diff.mean()):.2e} < 1e-4, "
          f"{float((diff.max(1).values > 1e-3).float().mean()):.5f} of paths off by > 1e-3")
    return float(diff.max())


def check_keys(MKC, label, scene, st, keys) -> None:
    """The single-bounce kernel's sort keys equal ``path_keys`` of the rows
    it wrote, bit for bit, dead paths at 0x7FFFFFFF."""
    import torch

    torch.cuda.synchronize()
    n_dead = int((keys == 0x7FFFFFFF).sum())
    check(torch.equal(keys, MKC.path_keys(scene, st)),
          f"{label}: the kernel's int32 keys equal path_keys of its rows ({n_dead} dead)")


def check_means_agree(label, film_a, film_b) -> None:
    """Image means per channel agree within Monte Carlo noise: 5 standard
    errors, from each film's per-pixel sample variance."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.ops.film import film_variance

    npix = W * H
    m_a = film_a.mean.reshape(-1, 3).mean(0)
    m_b = film_b.mean.reshape(-1, 3).mean(0)
    se2_a = film_variance(film_a).reshape(-1, 3).sum(0) / float(film_a.n) / npix**2
    se2_b = film_variance(film_b).reshape(-1, 3).sum(0) / float(film_b.n) / npix**2
    tol = 5.0 * torch.sqrt(se2_a + se2_b)
    check(bool(((m_a - m_b).abs() <= tol).all()),
          f"{label} image means agree within 5 sigma: "
          f"{m_a.tolist()} vs {m_b.tolist()}, tol {tol.tolist()}")


def gradients_phase(MK, zero, read, tag: str, kernel_names: dict) -> None:
    """Phase 5: gradients on the card, no CPU fallback. (a) The albedo
    gradient of bench.py's step down the kernel route (kernels 2 and 3, in
    the forward pass and in the replay) against the plain sweep; (b) path
    replay (per bounce, per two bounces) against stored activations, with
    peak memory; (c) finite differences at a small size; (d) Adam steps
    from a perturbed albedo, then the optimised scene through the fused
    kernel against trace_paths; (e) a mesh step through kernel 4 against
    the plain sweep; (f) the step's fwd+bwd Mpaths/s as bench.py times it,
    and one traced step."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh

    dev = torch.device("cuda")
    n_paths = W * H * GRAD_SPP
    print(f"phase 5: gradients, fused='off' with path replay ({W}x{H}, depth {DEPTH}, "
          f"{GRAD_SPP} spp as one {n_paths}-path pass, albedo) {tag}")
    scene = cornell_box(W, H, device=dev)
    zeros = torch.zeros((H, W, 3), device=dev)

    def cfg_of(**kw):
        return MK.MegakernelConfig(**{"max_depth": DEPTH, **kw})

    def grad_of(sc, cfg, w=W, h=H, spp=GRAD_SPP, target=None):
        target = torch.zeros((h, w, 3), device=dev) if target is None else target
        loss = D.make_loss(sc, cfg, w, h, spp, target, spp_per_pass=spp)
        params = D.init_params(sc, ("albedo",))
        val = loss(params)
        val.backward()
        torch.cuda.synchronize()
        return float(val.detach()), params["albedo"].grad

    def hold(label, g, g_ref):
        torch.cuda.synchronize()
        nz = g_ref != 0
        rel = float(((g - g_ref).abs()[nz] / g_ref.abs()[nz]).max()) if nz.any() else 0.0
        check(bool(torch.isfinite(g).all()) and int(nz.sum()) > 0
              and torch.allclose(g, g_ref, rtol=GRAD_RTOL, atol=GRAD_ATOL),
              f"{label}: albedo gradients within rtol {GRAD_RTOL:g}, atol {GRAD_ATOL:g} "
              f"(largest relative difference {rel:.3e}, {int(nz.sum())} nonzero entries)")

    # (a) the kernel route against the plain sweep; the step's launches
    zero()
    t0 = time.perf_counter()
    loss_k, g_k = grad_of(scene, cfg_of())
    dt_k = time.perf_counter() - t0
    launches = read()
    print(f"  (a) gradient step, kernel route: {launches}, {dt_k:.3f} s (first step) {tag}")
    check(launches["closest_bruteforce"] == 2 * DEPTH and launches["anyhit_bruteforce"] == 2 * DEPTH
          and launches["trace_paths_fused"] == 0,
          f"the gradient step went through kernels 2 and 3, {DEPTH} + {DEPTH} launches in the "
          f"forward pass and {DEPTH} + {DEPTH} in the replay")
    loss_p, g_p = grad_of(scene, cfg_of(backend="torch"))
    check(math.isclose(loss_k, loss_p, rel_tol=1e-6) and loss_k > 0.0,
          f"(a) losses agree on both routes ({loss_k:.9g}, {loss_p:.9g})")
    hold("(a) kernel route vs backend='torch'", g_k, g_p)

    # (b) path replay against stored activations, with peak memory
    peaks, grads = {}, {}
    for label, kw in (("remat", {}), ("stored", dict(remat=False)),
                      ("remat_every=2", dict(remat_every=2))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, grads[label] = grad_of(scene, cfg_of(**kw))
        peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
    print("  (b) peak memory above the scene's, per step: " + ", ".join(
        f"{k} {v:.3f} GiB" for k, v in peaks.items()) + f" {tag}")
    hold("(b) remat=False vs remat=True", grads["stored"], grads["remat"])
    hold("(b) remat_every=2 vs remat=True", grads["remat_every=2"], grads["remat"])
    hold("(b) remat=True vs phase (a)", grads["remat"], g_k)

    # (c) finite differences at a small size (the reference's bar)
    small = cornell_box(FD_SIZE, FD_SIZE, device=dev)
    loss_s = D.make_loss(small, cfg_of(max_depth=FD_DEPTH), FD_SIZE, FD_SIZE, FD_SPP,
                         torch.zeros((FD_SIZE, FD_SIZE, 3), device=dev))
    for key, idx in FD_CASES:
        auto, fd = D.fd_gradient_check(loss_s, D.init_params(small, (key,)), key, idx, eps=1e-2)
        ok = abs(auto - fd) <= 1e-7 + 2e-2 * abs(fd)
        check(ok and abs(fd) > 1e-9 and math.isfinite(auto),
              f"(c) {key}{idx} at {FD_SIZE}x{FD_SIZE}, {FD_SPP} spp, depth {FD_DEPTH}: autodiff {auto:.6e}, central "
              f"difference {fd:.6e} (rtol 2e-2, atol 1e-7)")

    # (d) a trainer: Adam from a perturbed albedo towards the true one's image
    with torch.no_grad():
        target = D.render_mean(scene, cfg_of(), W, H, GRAD_SPP, spp_per_pass=GRAD_SPP)
    params = {"albedo": torch.clamp(scene.materials.albedo + 0.2, 0.0, 1.0).requires_grad_(True)}
    loss = D.make_loss(scene, cfg_of(), W, H, GRAD_SPP, target, spp_per_pass=GRAD_SPP)
    opt = torch.optim.Adam(params.values(), lr=5e-2)
    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        val = loss(params)
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
    check(losses[-1] < losses[0], f"(d) Adam (lr 5e-2), {ADAM_STEPS} steps: the loss falls "
          f"{', '.join(f'{v:.6e}' for v in losses)}")
    opt_scene = D.inject_params(scene, {"albedo": params["albedo"].detach()})
    check(MK.resolve_fused(opt_scene, MK.MegakernelConfig()).fused == "on",
          "(d) the optimised scene resolves to the fused kernel")
    px, py, sample, o, d = camera_rays(opt_scene, PARITY_SPP)
    rad_k = trace_paths_fused(opt_scene, px, py, sample, o, d, max_depth=DEPTH)
    rad_0 = trace_paths_fused(scene, px, py, sample, o, d, max_depth=DEPTH)
    rad_p = MK.trace_paths(opt_scene, cfg_of(backend="torch", fused="off"), px, py, sample, o, d,
                           device=dev)
    check_parity("(d) fused kernel on the optimised scene", rad_k, rad_p, PARITY_SPP)
    moved = float((rad_k - rad_0).abs().reshape(PARITY_SPP, -1, 3).sum(0).mean()) / PARITY_SPP
    check(moved > 1e-4, f"(d) the fused kernel read the rebuilt tables: mean abs pixel change "
          f"{moved:.3e} from the scene before the steps (> 1e-4, the parity bar)")

    # (e) the mesh Cornell box through kernel 4 (sorted route) vs the sweep
    mesh = cornell_box_mesh(GRAD_MESH_SIZE, GRAD_MESH_SIZE, subdiv=GRAD_MESH_SUBDIV, device=dev)
    mkw = dict(w=GRAD_MESH_SIZE, h=GRAD_MESH_SIZE, spp=GRAD_MESH_SPP)
    zero()
    t0 = time.perf_counter()
    _, gm_k = grad_of(mesh, cfg_of(), **mkw)
    dt_mk = time.perf_counter() - t0
    launches_m = read()
    t0 = time.perf_counter()
    _, gm_p = grad_of(mesh, cfg_of(backend="torch"), **mkw)
    dt_mp = time.perf_counter() - t0
    print(f"  (e) mesh (subdivision {GRAD_MESH_SUBDIV}, {mesh.num_triangles} packed rows, "
          f"{GRAD_MESH_SIZE}x{GRAD_MESH_SIZE}, {GRAD_MESH_SPP} spp in one pass): kernel route "
          f"{launches_m}, {dt_mk:.3f} s; plain sweep {dt_mp:.3f} s {tag}")
    check(launches_m["bvh_closest_raw"] == 2 * DEPTH and launches_m["bvh_any_raw"] == 2 * DEPTH,
          f"(e) the mesh gradient step went through kernel 4, {DEPTH} + {DEPTH} launches in the "
          f"forward pass and {DEPTH} + {DEPTH} in the replay")
    hold("(e) mesh kernel route vs backend='torch'", gm_k, gm_p)

    # (f) timing as bench.py:_fwd_bwd: a warm step, then two runs of
    # GRAD_ITERS steps, each ending in a sync; then one traced step
    loss = D.make_loss(scene, cfg_of(), W, H, GRAD_SPP, zeros, spp_per_pass=GRAD_SPP)
    p = D.init_params(scene)

    def step():
        p["albedo"].grad = None
        loss(p).backward()

    step()
    torch.cuda.synchronize()
    vals = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(GRAD_ITERS):
            step()
        torch.cuda.synchronize()
        vals.append(n_paths * GRAD_ITERS / (time.perf_counter() - t0) / 1e6)
    spread = abs(vals[0] - vals[1]) / max(vals)
    wall = n_paths / (sum(vals) / 2 * 1e6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p["albedo"].grad = None
    val = loss(p)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    val.backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0 - t_fwd
    print(f"  (f) fwd+bwd {max(vals):.4f} Mpaths/s (best of two runs of {GRAD_ITERS} steps: "
          f"{vals[0]:.4f}, {vals[1]:.4f}; spread {spread:.4f}); {1e3 * wall:.1f} ms per step, "
          f"one more step: forward {1e3 * t_fwd:.1f} ms, backward {1e3 * t_bwd:.1f} ms {tag}")
    busy, per_k, n_launch, n_sync, wall_tr = traced_render(
        step, 1, {k: kernel_names[k] for k in ("closest", "anyhit")})
    ks = ", ".join(f"{name} {n} launches {t * 1e3:.4f} ms" for name, (n, t) in per_k.items())
    check(all(n == 2 * DEPTH for n, _ in per_k.values()),
          f"(f) the traced step ran kernels 2 and 3 {2 * DEPTH} times each")
    print(f"  (f) traced step: {n_launch:.0f} kernel launches, {n_sync:.0f} stream syncs; device "
          f"busy {1e3 * busy:.2f} ms ({100 * busy / wall:.1f} % of the untraced {1e3 * wall:.1f} "
          f"ms); {ks} (forward and replay); traced wall {1e3 * wall_tr:.1f} ms {tag}")


def scene_files_phase(MK, zero, read, tag: str, kernel_names: dict) -> None:
    """Phase 6: the bundled scene files on the card, no CPU fallback."""
    import dataclasses

    import torch

    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
    from cuda_optix_pathtracing_tpu_torch.ops.intersect import intersect_any, intersect_closest_raw
    from cuda_optix_pathtracing_tpu_torch.scene import load_pbrt, load_scene
    from cuda_optix_pathtracing_tpu_torch.utils import cli

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    print(f"phase 6: scene files {tag}")

    def cfg_for(scene, **kw):
        return MK.MegakernelConfig(features=mat_features_from_table(scene.materials), **kw)

    # (1) scene_test.json at its authored size through load_scene and render()
    t0 = time.perf_counter()
    test, parsed = load_scene(os.path.join(SCENE_DIR, "scene_test.json"), device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    sw, sh, spp, depth = parsed.width, parsed.height, parsed.spp, parsed.max_depth
    check((sw, sh, spp, depth) == (256, 256, 32, 12),
          f"(1) scene_test.json: {sw}x{sh}, {spp} spp, depth {depth} from the file; "
          f"{int((test.bvh.perm >= 0).sum())} triangles in {test.num_triangles} packed rows, "
          f"BVH depth {test.bvh.depth}; {test.textures.num_textures} textures, "
          f"{test.textures.texels.shape[0]} texels with their mip chains on the device; "
          f"loaded in {t_load:.2f} s")
    cfg = cfg_for(test, max_depth=depth)
    check(MK.resolve_fused(test, cfg).fused == "off",
          "(1) the textured scene resolves to the plain integrator (the fused gate refuses it)")
    MK.render(test, sw, sh, spp=1, cfg=cfg)  # warm: first launches of each op
    zero()
    t0 = time.perf_counter()
    film = MK.render(test, sw, sh, spp=spp, cfg=cfg, kspp=SCENE_KSPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read()
    mpaths = sw * sh * spp / dt / 1e6
    print(f"  (1) render: {launches}")
    check(launches["bvh_closest_raw"] > 0 and launches["bvh_any_raw"] > 0
          and launches["trace_paths_fused"] == 0 and launches["bounce_fused"] == 0,
          f"(1) the render went through kernel 4: {launches['bvh_closest_raw'] / spp:g} closest-hit "
          f"and {launches['bvh_any_raw'] / spp:g} any-hit launches per spp, no fused kernel")
    mean = film.mean
    check(bool(torch.isfinite(mean).all()) and float(mean.mean()) > 0.0 and float(film.n) == spp,
          f"(1) film finite, mean {float(mean.mean()):.5f} > 0, {int(film.n)} samples")
    print(f"  (1) scene_test.json {sw}x{sh}x{spp} depth {depth}: {dt:.3f} s, {mpaths:.4f} Mpaths/s "
          f"(host clock around render(), kspp {SCENE_KSPP}) {tag}")
    one_spp = lambda: MK.render_sample_batch(test, cfg, sw, sh, 0)  # noqa: E731
    one_spp()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_spp()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, per_k, n_launch, n_sync, wall_tr = traced_render(
        one_spp, 1, {k: kernel_names[k] for k in ("bvh_closest", "bvh_anyhit")})
    ks = ", ".join(f"{name} {n} launches {t * 1e3:.3f} ms ({t * 1e3 / max(n, 1):.4f} ms each)"
                   for name, (n, t) in per_k.items())
    print(f"  (1) traced spp: {1e3 * wall:.3f} ms untraced wall, device busy {1e3 * busy:.3f} ms "
          f"({100 * busy / wall:.1f} %); {ks}; {n_launch:.0f} kernel launches, {n_sync:.0f} "
          f"stream syncs; traced wall {1e3 * wall_tr:.3f} ms {tag}")

    # (2) the kernel route against the plain one on the same paths
    def hold_route(label, scene, cfg, counted):
        zero()
        t0 = time.perf_counter()
        img_k = MK.render_sample_batch(scene, cfg, sw, sh, 0, nspp=SCENE_PARITY_SPP)
        got = read()
        t_k = time.perf_counter() - t0
        img_p = MK.render_sample_batch(scene, dataclasses.replace(cfg, backend="torch"), sw, sh, 0,
                                       nspp=SCENE_PARITY_SPP)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0 - t_k
        check(all(got[c] > 0 for c in counted) and got["trace_paths_fused"] == 0,
              f"(2) {label}: the kernel route launched " + ", ".join(
                  f"{c} {got[c]}" for c in counted) + " times, no fused kernel")
        err = check_parity(f"(2) {label}, {SCENE_PARITY_SPP} spp", img_k, img_p, SCENE_PARITY_SPP,
                           ref="backend='torch'")
        print(f"  (2) {label}: films bit-equal: {bool(torch.equal(img_k, img_p))}, max abs "
              f"pixel difference {err:.3e}; one pass of {SCENE_PARITY_SPP} spp: kernel route "
              f"{t_k:.3f} s, plain {t_p:.3f} s (host clock) {tag}")
        return got

    hold_route("scene_test.json", test, cfg, ("bvh_closest_raw", "bvh_any_raw"))
    example, ex_parsed = load_scene(os.path.join(SCENE_DIR, "scene_example.json"), device=dev)
    check(not example.env.uniform and example.env.image.shape[:2] == (512, 1024),
          "(2) scene_example.json carries the 512x1024 veranda map and its sampling tables")
    ex_launch = {}
    for env_nee in (True, False):
        ex_cfg = cfg_for(example, max_depth=ex_parsed.max_depth, env_nee=env_nee)
        check(MK.resolve_fused(example, ex_cfg).fused == "off",
              f"(2) scene_example.json (env_nee={env_nee}) resolves to the plain integrator")
        if env_nee:
            got = hold_route("scene_example.json, env_nee=True", example, ex_cfg,
                             ("closest_bruteforce", "anyhit_bruteforce"))
        else:
            zero()
            MK.render_sample_batch(example, ex_cfg, sw, sh, 0, nspp=SCENE_PARITY_SPP)
            got = read()
        ex_launch[env_nee] = got
    fbx, fbx_parsed = load_scene(os.path.join(SCENE_DIR, "fbx_example.json"), device=dev)
    fbx_cfg = cfg_for(fbx, max_depth=fbx_parsed.max_depth)
    zero()
    MK.render_sample_batch(fbx, fbx_cfg, sw, sh, 0, nspp=SCENE_PARITY_SPP)
    fbx_launch = read()
    for label, got in (("scene_example.json, env_nee=True", ex_launch[True]),
                       ("scene_example.json, env_nee=False", ex_launch[False]),
                       ("fbx_example.json", fbx_launch)):
        print(f"  launches per spp, {label} (depth 12): kernel 2 "
              f"{got['closest_bruteforce'] / SCENE_PARITY_SPP:g}, kernel 3 "
              f"{got['anyhit_bruteforce'] / SCENE_PARITY_SPP:g} (one pass of "
              f"{SCENE_PARITY_SPP} spp)")

    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 6)")

    # (3) kernel 4 at every recorded launch of one textured spp, each
    # launch's output on every SCENE_K4_STRIDE-th ray held to the sweep
    rec = record_bvh_launches(MK, one_spp)
    v0, e0, e1 = test.tri_v0, test.tri_e0, test.tri_e1
    k4_err, n_rays, n_diff = 0.0, 0, 0
    for i, (o, d) in enumerate(rec["closest"]):
        sub = slice(None, None, SCENE_K4_STRIDE)
        tk, ik = BV.bvh_closest_raw(o, d, test)
        tp, ip = intersect_closest_raw(o[sub], d[sub], v0, e0, e1)
        k4_err = max(k4_err, check_closest(f"(3) bvh_closest launch {i}", tk[sub], ik[sub], tp, ip))
        n_rays += tp.shape[0]
    for o, d, t_max in rec["any"]:
        sub = slice(None, None, SCENE_K4_STRIDE)
        occ_k = BV.bvh_any_raw(o, d, test, t_max)[sub] > 0
        occ_p = intersect_any(o[sub], d[sub], v0, e0, e1, t_max[sub])
        torch.cuda.synchronize()
        n_diff += int((occ_k != occ_p).sum())
        n_rays += occ_p.shape[0]
    check(n_diff == 0 and len(rec["closest"]) == depth and len(rec["any"]) == depth,
          f"(3) kernel 4 at the textured render's {len(rec['closest'])} + {len(rec['any'])} "
          f"recorded launches of {rec['closest'][0][0].shape[0]} rays (every "
          f"{SCENE_K4_STRIDE}th, {n_rays} in all): hits as the plain sweep's, any-hit flags "
          f"equal ({n_diff} differ); max abs t error {k4_err:.3e}")
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 6)")

    # (4) the PBRT Cornell box through kernel 1
    box, meta = load_pbrt(os.path.join(SCENE_DIR, "cornell-box.pbrt"), device=dev)
    box_cfg = cfg_for(box, max_depth=DEPTH)
    check(MK.resolve_fused(box, box_cfg).fused == "on" and (meta.width, meta.height) == (W, H),
          f"(4) cornell-box.pbrt ({box.num_triangles} triangles, {box.emissive.v0.shape[0]} "
          f"emissive, {meta.width}x{meta.height}) resolves to the fused kernel")
    px, py, sample, o, d = camera_rays(box, PARITY_SPP)
    zero()
    rad_k = MKC.trace_paths_fused(box, px, py, sample, o, d, max_depth=DEPTH)
    got = read()
    rad_p = MK.trace_paths(box, dataclasses.replace(box_cfg, backend="torch", fused="off"),
                           px, py, sample, o, d, device=dev)
    check(got["trace_paths_fused"] == 1, "(4) one launch of kernel 1")
    err_box = check_parity(f"(4) cornell-box.pbrt through kernel 1 ({PARITY_SPP} spp, depth "
                           f"{DEPTH})", rad_k, rad_p, PARITY_SPP)
    zero()
    MK.render(box, W, H, spp=PARITY_SPP, cfg=box_cfg)
    got = read()
    check(got["trace_paths_fused"] == PARITY_SPP,
          f"(4) render(cornell-box.pbrt): one kernel-1 launch per spp ({got}); max abs pixel "
          f"difference at the parity check {err_box:.3e}")

    # (5) the gate on the card: no fused kernel on the two scenes it refuses
    # (device activity only: the kernels' names are all this reads)
    from torch.profiler import ProfilerActivity, profile

    for label, scene, scfg in (("fbx_example.json", fbx, fbx_cfg), ("scene_test.json", test, cfg)):
        zero()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            MK.render(scene, sw, sh, spp=1, cfg=scfg)
            torch.cuda.synchronize()
        names = [e.key for e in device_rows(prof.key_averages())]
        fused = [k for k in names if "pt_fused" in k or "pt_bounce" in k]
        got = read()
        check(not fused and got["trace_paths_fused"] == 0 and got["bounce_fused"] == 0
              and len(names) > 0,
              f"(5) {label}: the profiler saw {len(names)} device kernels, none of them "
              f"pt_fused_* or pt_bounce_*")

    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 6)")

    # (6) the CLI on scene_test.json at its authored settings
    os.makedirs(os.path.dirname(SCENE_OUT), exist_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = cli.main(["--scene", os.path.join(SCENE_DIR, "scene_test.json"), "--out", SCENE_OUT,
                   "--log-level", "warning"])
    dt_cli = time.perf_counter() - t0
    got = read()
    base, ext = os.path.splitext(SCENE_OUT)
    check(rc == 0 and os.path.getsize(SCENE_OUT) > 0 and os.path.getsize(base + "_sqrt_mse" + ext) > 0
          and got["bvh_closest_raw"] > 0 and got["trace_paths_fused"] == 0,
          f"(6) the CLI rendered scene_test.json ({sw}x{sh}, {spp} spp, depth {depth}) through "
          f"kernel 4 in {dt_cli:.2f} s and wrote {SCENE_OUT} and its sqrt-MSE PNG")
    print(f"  phase 6 took {time.perf_counter() - t_phase:.1f} s {tag}")


def lights_instancing_phase(MK, zero, read, tag: str, kernel_names: dict) -> None:
    """Phase 7: the light tree and instancing on the card, no CPU
    fallback. (B) the instanced mesh Cornell box beside the baked one;
    (A) the many-lights Cornell box, tree against uniform selection."""
    import dataclasses

    import torch

    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
    from cuda_optix_pathtracing_tpu_torch.ops.intersect import intersect_any, intersect_closest_raw
    from cuda_optix_pathtracing_tpu_torch.scene import (
        cornell_box_mesh,
        cornell_box_mesh_instanced,
    )
    from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    print(f"phase 7: the light tree and instancing {tag}")
    n_pass = W * H * MESH_SPP

    def cfg_for(scene, **kw):
        return MK.MegakernelConfig(max_depth=DEPTH, features=mat_features_from_table(scene.materials),
                                   **kw)

    def timed_pass(scene, cfg, label, counted, trace=True):
        """Warm-up spp, then render(MESH_SPP samples in one pass) with the
        counts zeroed just before and read just after, then (``trace``)
        one traced pass → (film, launches, seconds)."""
        check(MK.resolve_fused(scene, cfg).fused == "off",
              f"({label}) resolves to the plain integrator (the fused gate refuses it)")
        MK.render_sample_batch(scene, cfg, W, H, 0)
        zero()
        t0 = time.perf_counter()
        film = MK.render(scene, W, H, spp=MESH_SPP, cfg=cfg, kspp=MESH_SPP, spp_per_pass=MESH_SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read()
        check(bool(torch.isfinite(film.mean).all()) and float(film.mean.mean()) > 0.0
              and all(got[c] > 0 for c in counted) and got["trace_paths_fused"] == 0
              and got["bounce_fused"] == 0,
              f"({label}) render {W}x{H}x{MESH_SPP} (one pass) depth {DEPTH}: finite film, mean "
              f"{float(film.mean.mean()):.5f}; launches per spp: kernel 2 "
              f"{got['closest_bruteforce'] / MESH_SPP:g}, kernel 3 "
              f"{got['anyhit_bruteforce'] / MESH_SPP:g}, kernel 4 "
              f"{got['bvh_closest_raw'] / MESH_SPP:g} + {got['bvh_any_raw'] / MESH_SPP:g}; "
              f"no fused kernel")
        print(f"  ({label}) {dt:.3f} s, {n_pass / dt / 1e6:.4f} Mpaths/s (host clock around "
              f"render()) {tag}")
        if not trace:
            return film, got, dt
        # device activity only, all the device-busy share needs: tracing the
        # host's ops as well costs far longer on these 15,000-54,000-launch passes
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            MK.render_sample_batch(scene, cfg, W, H, 0, nspp=MESH_SPP)
            torch.cuda.synchronize()
        rows = device_rows(prof.key_averages())
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        fused = [e.key for e in rows if "pt_fused" in e.key or "pt_bounce" in e.key]
        check(busy > 0.0 and not fused,
              f"({label}) the profiler saw device work in a traced pass, no pt_fused_* or "
              f"pt_bounce_* kernel")
        per_k = {k: [e for e in rows if is_kernel(e.key, kernel_names[k])]
                 for k in ("bvh_closest", "bvh_anyhit", "closest", "anyhit")}
        ks = ", ".join(f"{k} {sum(e.count for e in es)} launches "
                       f"{sum(e.self_device_time_total for e in es) / 1e3:.3f} ms"
                       for k, es in per_k.items())
        print(f"  ({label}) traced pass: device busy {1e3 * busy:.3f} ms ({100 * busy / dt:.1f} % "
              f"of the untraced wall), {sum(e.count for e in rows)} device kernels per pass; "
              f"{ks} {tag}")
        return film, got, dt

    # (B) instancing: the instanced mesh Cornell box and the baked one
    t0 = time.perf_counter()
    inst = cornell_box_mesh_instanced(W, H, subdiv=MESH_SUBDIV, use_bvh=True, device="cuda")
    torch.cuda.synchronize()
    ti = inst.instances
    starts = ti.tstart.tolist()
    check(ti.count == 3 and all(m.bvh is not None for m in ti.meshes)
          and len({id(m) for m in ti.meshes}) == 3,
          f"(B) instanced scene: {ti.count} instances (walls, two sphere meshes), "
          f"{inst.num_triangles} rows in all, row offsets {starts}, BVH depths "
          f"{[m.bvh.depth for m in ti.meshes]}; built in {time.perf_counter() - t0:.2f} s")
    cfg_i = cfg_for(inst)
    film_i, got_i, dt_i = timed_pass(inst, cfg_i, "B, instanced", ("bvh_closest_raw", "bvh_any_raw"))
    check(got_i["bvh_closest_raw"] == ti.count * DEPTH and got_i["bvh_any_raw"] == ti.count * DEPTH
          and got_i["closest_bruteforce"] == 0 and got_i["anyhit_bruteforce"] == 0,
          f"(B) kernel 4 once per instance and query: {got_i['bvh_closest_raw']} closest-hit and "
          f"{got_i['bvh_any_raw']} any-hit launches per pass of {MESH_SPP} spp (3 instances × "
          f"depth {DEPTH} each)")
    baked = cornell_box_mesh(W, H, subdiv=MESH_SUBDIV, device="cuda")
    film_b, got_b, dt_b = timed_pass(baked, cfg_for(baked, fused="off"), "B, baked, fused='off'",
                                     ("bvh_closest_raw", "bvh_any_raw"))
    diff = (film_i.mean - film_b.mean).abs()
    frac = float((diff.max(-1).values > 1e-2).float().mean())
    check(float(diff.mean()) < 1e-4 and frac < 0.01,
          f"(B) instanced against baked: mean abs diff {float(diff.mean()):.3e} < 1e-4, "
          f"{frac:.5f} of pixels off by > 1e-2 (< 0.01)")
    print(f"  (B) instanced {n_pass / dt_i / 1e6:.4f} against baked {n_pass / dt_b / 1e6:.4f} "
          f"Mpaths/s in this call {tag}")

    # the recorded kernel-4 launches of one pass, every SCENE_K4_STRIDE-th
    # ray held to the plain sweep over the same instance mesh
    rec = record_bvh_launches(
        MK, lambda: MK.render_sample_batch(inst, cfg_i, W, H, 0, nspp=MESH_SPP))
    sub = slice(None, None, SCENE_K4_STRIDE)
    k4_err, n_rays, n_diff = 0.0, 0, 0
    parked = [[] for _ in range(ti.count)]
    for i, ((o, d), mesh) in enumerate(zip(rec["closest"], rec["closest_tables"])):
        tk, ik = BV.bvh_closest_raw(o, d, mesh)
        tp, ip = intersect_closest_raw(o[sub], d[sub], mesh.tri_v0, mesh.tri_e0, mesh.tri_e1,
                                       PLAIN_CHUNK)
        k4_err = max(k4_err, check_closest(f"(B) bvh_closest launch {i}", tk[sub], ik[sub], tp, ip))
        n_rays += tp.shape[0]
        parked[i % ti.count].append(int((o[:, 0] == 1.0e9).sum()))
    for (o, d, t_max), mesh in zip(rec["any"], rec["any_tables"]):
        occ_k = BV.bvh_any_raw(o, d, mesh, t_max)[sub] > 0
        occ_p = intersect_any(o[sub], d[sub], mesh.tri_v0, mesh.tri_e0, mesh.tri_e1, t_max[sub],
                              PLAIN_CHUNK)
        torch.cuda.synchronize()
        n_diff += int((occ_k != occ_p).sum())
        n_rays += occ_p.shape[0]
    check(n_diff == 0 and len(rec["closest"]) == len(rec["any"]) == ti.count * DEPTH,
          f"(B) kernel 4 at the pass's {len(rec['closest'])} + {len(rec['any'])} recorded "
          f"launches of {rec['closest'][0][0].shape[0]} rays, each on its instance's mesh (every "
          f"{SCENE_K4_STRIDE}th ray, {n_rays} in all): hits as the plain sweep's, any-hit flags "
          f"equal ({n_diff} differ); max abs t error {k4_err:.3e}")
    for k in range(ti.count):
        culled = [p - p0 for p, p0 in zip(parked[k], parked[0])]
        print(f"  (B) closest-hit rays parked at instance {k} per depth: {parked[k]} of {n_pass} "
              f"(dead paths and, beyond instance 0's, rays that miss its world box: "
              f"{culled} culled)")
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 7)")

    # (A) many lights: the light tree against uniform selection
    t0 = time.perf_counter()
    many = cornell_box_many_lights(W, H, subdiv=MESH_SUBDIV, use_bvh=True, device="cuda")
    torch.cuda.synchronize()
    tree = many.light_tree
    check(tree is not None and tree.n_records == 129 and many.bvh is not None,
          f"(A) many-lights scene: {many.emissive.v0.shape[0]} emissive triangles and a spot, "
          f"{tree.n_records} light records in a tree of depth {tree.depth} "
          f"({tree.feat.shape[0]} nodes), {int((many.bvh.perm >= 0).sum())} triangles in a BVH; "
          f"built in {time.perf_counter() - t0:.2f} s")
    films = {}
    for splits in (1, 4):
        live = sum(r >= 0 for r in tree.frontiers[{1: 0, 4: 2}[splits]])
        cfg = cfg_for(many, nee_splits=splits)
        film, got, _ = timed_pass(many, cfg, f"A, tree, nee_splits={splits}",
                                  ("bvh_closest_raw", "bvh_any_raw"))
        check(got["bvh_closest_raw"] == DEPTH and got["bvh_any_raw"] == DEPTH * live,
              f"(A) nee_splits={splits}: {got['bvh_closest_raw']} closest-hit and "
              f"{got['bvh_any_raw']} any-hit launches per pass (one shadow query per live root, "
              f"{live}, and depth)")
        films[splits] = film
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 7)")
    film_u, _, _ = timed_pass(many, cfg_for(many, light_strategy="uniform"), "A, uniform",
                              ("bvh_closest_raw", "bvh_any_raw"), trace=False)
    check_means_agree("(A) tree (nee_splits=1) and uniform", films[1], film_u)
    ref = None
    for k in range(0, TREE_REF_SPP, MESH_SPP):
        img = MK.render_sample_batch(many, cfg_for(many, nee_splits=2, seed=1), W, H, k,
                                     nspp=MESH_SPP).sum(0)
        ref = img if ref is None else ref + img
    ref = ref / TREE_REF_SPP
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 7)")
    mse_t = float(((films[1].mean - ref) ** 2).mean())
    mse_u = float(((film_u.mean - ref) ** 2).mean())
    check(mse_t < 0.6 * mse_u,
          f"(A) at {MESH_SPP} spp against a {TREE_REF_SPP}-spp tree image: tree MSE {mse_t:.4e} "
          f"< 0.6 × uniform's {mse_u:.4e} (ratio {mse_t / mse_u:.3f})")
    cfg = cfg_for(many)
    zero()
    img_k = MK.render_sample_batch(many, cfg, W, H, 0, nspp=TREE_BIT_SPP)
    got = read()
    img_p = MK.render_sample_batch(many, dataclasses.replace(cfg, backend="torch",
                                                             tri_chunk=PLAIN_CHUNK),
                                   W, H, 0, nspp=TREE_BIT_SPP)
    torch.cuda.synchronize()
    check(got["bvh_closest_raw"] == DEPTH and bool(torch.equal(img_k, img_p)),
          f"(A) {TREE_BIT_SPP} spp: the kernel route (kernel 4, {got['bvh_closest_raw']} + "
          f"{got['bvh_any_raw']} launches) and backend='torch' give bit-equal films")
    print(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s {tag}")


def unsharded_film(scene, cfg, spp: int):
    """The Welford loop of ``render_sharded`` over every pixel, in one
    block: phase 8's equality oracle (the reference's ``_single_device_film``)."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.ops.film import Film, film_add_sample
    from cuda_optix_pathtracing_tpu_torch.parallel.render import _render_pixels

    ids = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    px, py = ids % W, ids // W
    z = torch.zeros((W * H, 3), dtype=torch.float32, device=scene.device)
    film = Film(z, z.clone(), torch.zeros((), dtype=torch.float32, device=scene.device))
    for s in range(spp):
        film = film_add_sample(film, _render_pixels(scene, cfg, px, py, s))
    return film


def path_trace(fn, spp: int):
    """One run of ``fn`` under the profiler (host and device) → per spp:
    device-busy seconds, host kernel launches and traced wall; the
    launches of kernels 2, 3 and 4 in the trace; the fused and
    single-bounce kernels it holds (none on phase 8's paths)."""
    wall, rows = profiled(fn)
    dev_rows = device_rows(rows)
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e6
    seen = {k: sum(e.count for e in dev_rows if is_kernel(e.key, KERNEL_NAMES[k]))
            for k in ("closest", "anyhit", "bvh_closest", "bvh_anyhit")}
    fused = sorted({e.key[:60] for e in dev_rows if "pt_fused" in e.key or "pt_bounce" in e.key})
    launches = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
    return busy / spp, launches / spp, wall / spp, seen, fused


def phase8_scenes(device):
    """Phase 8's scenes → {name: (scene, spp of the sharded and dense
    renders, the wrappers whose launches its paths must show)}."""
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh

    return {
        "cornell": (cornell_box(W, H, device=device), SPP_OFF,
                    ("closest_bruteforce", "anyhit_bruteforce")),
        "mesh": (cornell_box_mesh(W, H, subdiv=MESH_SUBDIV, use_bvh=True, device=device),
                 SHARD_MESH_SPP,
                 ("bvh_closest_raw", "bvh_any_raw")),
    }


def shows_kernels(name: str, seen: dict) -> bool:
    """Does a trace of scene ``name``'s path hold its kernels: 2 and 3 for
    the Cornell box, 4 (closest and any-hit) for the mesh box?"""
    keys = ("closest", "anyhit") if name == "cornell" else ("bvh_closest", "bvh_anyhit")
    return all(seen[k] > 0 for k in keys)


def went_through(got: dict, counted) -> bool:
    """Did a run launch every wrapper of ``counted`` and no fused kernel?"""
    return (all(got[c] > 0 for c in counted) and got["trace_paths_fused"] == 0
            and got["bounce_fused"] == 0)


def sharded_step_run(MK, scene, mesh, zero, read):
    """``ADAM_STEPS + 1`` Adam steps of bench.py's albedo step (fwd_bwd
    leg), sharded over ``mesh``, from the scene's albedo → dict of the
    first step's averaged loss and gradient (the gradient Adam applied) and
    launches, the losses of every step, fwd+bwd Mpaths/s over the last
    ``ADAM_STEPS`` steps, and the seconds of one all-reduce of the step's
    loss and gradient."""
    import torch

    from cuda_optix_pathtracing_tpu_torch.models.differentiable import init_params, inject_params
    from cuda_optix_pathtracing_tpu_torch.parallel.render import mean_over_ranks, train_step_sharded

    cfg = MK.MegakernelConfig(max_depth=DEPTH, remat=True)
    target = torch.zeros((H, W, 3), device=scene.device)
    params = init_params(scene, ("albedo",))
    step = train_step_sharded(torch.optim.Adam(params.values(), lr=5e-2),
                              lambda p: inject_params(scene, p), cfg, W, H, GRAD_SPP, mesh)
    zero()
    losses = [float(step(params, target, 0))]
    got = read()
    grad = params["albedo"].grad.detach().clone()
    t0 = time.perf_counter()
    for _ in range(ADAM_STEPS):
        losses.append(float(step(params, target, 0)))
    dt = time.perf_counter() - t0
    bufs = [torch.zeros((), device=scene.device), grad]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_over_ranks(bufs, mesh)
    torch.cuda.synchronize()
    t_ar = time.perf_counter() - t0
    return {"loss": losses[0], "grad": grad, "losses": losses, "launches": got,
            "mpaths": W * H * GRAD_SPP * ADAM_STEPS / dt / 1e6, "allreduce_s": t_ar}


def device_trace(fn):
    """One run of ``fn`` under the profiler, device activity only (cheaper
    to trace than the host's ops) → (device-busy seconds, device kernels,
    the launches of kernels 2, 3 and 4, the fused and single-bounce
    kernels seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof.key_averages())
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    seen = {k: sum(e.count for e in rows if is_kernel(e.key, KERNEL_NAMES[k]))
            for k in ("closest", "anyhit", "bvh_closest", "bvh_anyhit")}
    fused = sorted({e.key[:60] for e in rows if "pt_fused" in e.key or "pt_bounce" in e.key})
    return busy, sum(e.count for e in rows), seen, fused


def phase8_rank(rank: int, port: int, out_dir: str) -> int:
    """One of phase 8's two ranks (a process of its own, sharing the card
    with the other; gloo): (b) ``render_multihost`` of both scenes with
    the counts zeroed just before and read just after, a traced spp of the
    rank's block, the gather's time; (c) the sharded step. Writes its
    figures to ``<out_dir>/rank<r>.pt``, and rank 0 the films and the
    gradient."""
    import torch
    import torch.distributed as dist

    from cuda_optix_pathtracing_tpu_torch._device import resolve_device
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.parallel.distributed import (
        gather_film,
        init_distributed,
        render_multihost,
    )
    from cuda_optix_pathtracing_tpu_torch.parallel.render import make_mesh, render_sharded

    torch.set_num_threads(2)
    init_distributed(f"localhost:{port}", 2, rank, device="cuda")
    _, zero, read = launch_counters()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": torch.cuda.get_device_name(torch.cuda.current_device())}
    try:
        mesh = make_mesh()
        cfg = MK.MegakernelConfig(max_depth=DEPTH, remat=False)
        scenes = phase8_scenes(resolve_device("cuda"))
        for name, (scene, spp, _) in scenes.items():
            render_sharded(scene, cfg, W, H, 1, mesh)  # warm-up
            torch.cuda.synchronize()
            dist.barrier()
            zero()
            t0 = time.perf_counter()
            film = render_multihost(scene, cfg, W, H, spp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read()
            block = render_sharded(scene, cfg, W, H, 1, mesh)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            gather_film(block, mesh)
            torch.cuda.synchronize()
            t_gather = time.perf_counter() - t0
            dist.barrier()
            trace = path_trace(lambda: render_sharded(scene, cfg, W, H, 1, mesh), 1)
            out[name] = {"wall": wall, "launches": got, "gather_s": t_gather, "trace": trace}
            if rank == 0:
                out[name]["film"] = (film.mean.cpu(), film.m2.cpu(), float(film.n))
        dist.barrier()
        step = sharded_step_run(MK, scenes["cornell"][0], mesh, zero, read)
        step["grad"] = step["grad"].cpu()
        out["step"] = step
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def phase8_cli(rank: int, port: int, out: str) -> int:
    """One of phase 8 (g)'s two CLI processes: ``cli.main`` in
    multi-process mode with the counts zeroed just before and printed as a
    JSON line just after."""
    from cuda_optix_pathtracing_tpu_torch.utils import cli

    _, zero, read = launch_counters()
    zero()
    rc = cli.main(phase8_cli_args(out) + ["--coordinator", f"localhost:{port}",
                                          "--num-processes", "2", "--process-id", str(rank)])
    print(json.dumps({"rank": rank, "launches": read()}))
    return rc


def phase8_cli_args(out: str):
    return ["--scene", "cornell", "--width", str(CLI_MP_SIZE), "--height", str(CLI_MP_SIZE),
            "--spp", str(CLI_MP_SPP), "--log-level", "warn", "--out", out]


def run_workers(cmds, timeout: float):
    """Start every command at once (this script's directory as the working
    directory), wait for all → their outputs; fails if one fails or
    outlasts ``timeout`` seconds, and kills what is left."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(c, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"worker {p.args} failed ({p.returncode}):\n{o[-6000:]}")
    return outs


def parallel_wavefront_phase(MK, zero, read, tag: str) -> None:
    """Phase 8: the sharded render and step (``parallel/``), the dense and
    pool wavefronts (``models/wavefront.py``), the NaN guard and the CLI's
    multi-process mode on the card, every path through kernels 2 and 3
    (Cornell) or 4 (mesh), no fused kernel, no CPU fallback."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from cuda_optix_pathtracing_tpu_torch._device import resolve_device
    from cuda_optix_pathtracing_tpu_torch.entry import free_port
    from cuda_optix_pathtracing_tpu_torch.models.differentiable import init_params, inject_params, make_loss
    from cuda_optix_pathtracing_tpu_torch.models.wavefront import (
        WavefrontConfig,
        render_pool_wavefront,
        render_wavefront,
    )
    from cuda_optix_pathtracing_tpu_torch.parallel.distributed import (
        gather_film,
        init_distributed,
        render_multihost,
    )
    from cuda_optix_pathtracing_tpu_torch.parallel.render import make_mesh, render_sharded
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box
    from cuda_optix_pathtracing_tpu_torch.utils import cli

    t_phase = time.perf_counter()
    print(f"phase 8: sharded render and step, wavefronts, NaN guard, multi-process CLI ({W}x{H}, "
          f"depth {DEPTH}) {tag}")
    dev = resolve_device("cuda")
    scenes = phase8_scenes(dev)
    cfg = MK.MegakernelConfig(max_depth=DEPTH, remat=False)
    script = os.path.abspath(__file__)

    # (a) world 1, NCCL, in this process
    rank = init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
    check(rank == 0 and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "(a) init_distributed: a group of 1 rank on the NCCL backend")
    mesh1 = make_mesh()
    films_a, walls_a, refs = {}, {}, {}
    for name, (scene, spp, counted) in scenes.items():
        refs[name] = unsharded_film(scene, cfg, spp)
        zero()
        t0 = time.perf_counter()
        film = render_multihost(scene, cfg, W, H, spp)
        torch.cuda.synchronize()
        walls_a[name] = time.perf_counter() - t0
        got = read()
        check(went_through(got, counted),
              f"(a) {name}: render_multihost {W}x{H}x{spp} through {', '.join(counted)} "
              f"({', '.join(str(got[c]) for c in counted)} launches), no fused kernel")
        check(torch.equal(film.mean.reshape(-1, 3), refs[name].mean)
              and torch.equal(film.m2.reshape(-1, 3), refs[name].m2) and float(film.n) == spp,
              f"(a) {name}: the world-1 film equals the unsharded Welford loop bit for bit")
        films_a[name] = film
        busy, launches, _, seen, fused = path_trace(
            lambda: render_sharded(scene, cfg, W, H, 1, mesh1), 1)
        check(not fused and shows_kernels(name, seen),
              f"(a) {name}: the profiler's kernels in one traced spp: {seen}; no pt_fused_* or "
              f"pt_bounce_*")
        wall_spp = walls_a[name] / spp
        print(f"  (a) {name}: {walls_a[name]:.3f} s, {W * H * spp / walls_a[name] / 1e6:.4f} "
              f"Mpaths/s (host clock around render_multihost); traced spp: {launches:.0f} host "
              f"launches, device busy {1e3 * busy:.3f} ms ({100 * busy / wall_spp:.1f} % of the "
              f"untraced {1e3 * wall_spp:.3f} ms) {tag}")
    block = render_sharded(scenes["cornell"][0], cfg, W, H, 1, mesh1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gather_film(block, mesh1)
    torch.cuda.synchronize()
    print(f"  (a) gather_film of a {W}x{H} film at world 1 (NCCL all-gather of mean and m2): "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms {tag}")

    # (c) at world 1: the step against the unsharded make_loss
    cornell = scenes["cornell"][0]
    cfg_g = MK.MegakernelConfig(max_depth=DEPTH, remat=True)
    params = init_params(cornell, ("albedo",))
    ref_loss = make_loss(cornell, cfg_g, W, H, GRAD_SPP, torch.zeros((H, W, 3), device=dev))(params)
    ref_loss.backward()
    ref_loss, g_ref = float(ref_loss.detach()), params["albedo"].grad.detach().clone()

    def hold_step(label, res):
        g = res["grad"].to(g_ref.device)
        atol = 1e-4 * float(g_ref.abs().max())
        check(math.isclose(res["loss"], ref_loss, rel_tol=SHARD_LOSS_RTOL),
              f"(c) {label}: loss {res['loss']:.9g} against make_loss's {ref_loss:.9g} "
              f"(rel {abs(res['loss'] - ref_loss) / ref_loss:.2e} <= {SHARD_LOSS_RTOL:g})")
        check(bool(torch.isfinite(g).all()) and torch.allclose(g, g_ref, rtol=SHARD_GRAD_RTOL, atol=atol),
              f"(c) {label}: averaged gradient within rtol {SHARD_GRAD_RTOL:g}, atol 1e-4·max|g| "
              f"of make_loss's (max abs diff {float((g - g_ref).abs().max()):.3e}, max|g| "
              f"{float(g_ref.abs().max()):.3e})")
        ls = res["losses"]
        check(all(b < a for a, b in zip(ls, ls[1:])),
              f"(c) {label}: {ADAM_STEPS} Adam steps lower the loss: "
              + " → ".join(f"{v:.6g}" for v in ls))

    res1 = sharded_step_run(MK, cornell, mesh1, zero, read)
    check(went_through(res1["launches"], scenes["cornell"][2]),
          f"(c) world 1: the step went through kernels 2 and 3 ({res1['launches']})")
    hold_step("world 1", res1)
    print(f"  (c) world 1: fwd+bwd {res1['mpaths']:.4f} Mpaths/s over {ADAM_STEPS} Adam steps "
          f"({W}x{H}x{GRAD_SPP}, sample by sample); all-reduce of the loss and gradient "
          f"(NCCL) {1e3 * res1['allreduce_s']:.3f} ms {tag}")
    dist.destroy_process_group()
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 8)")

    # (b), (c) at world 2: two processes share the card (gloo)
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        run_workers([[sys.executable, script, "--phase8-rank", str(r), str(port), tmp]
                     for r in range(2)], WORKER_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    check(all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks),
          f"(b) two ranks on one card ({ranks[0]['device']}) chose gloo")
    for name, (scene, spp, counted) in scenes.items():
        mean, m2, n = ranks[0][name]["film"]
        check(all(went_through(r[name]["launches"], counted) for r in ranks),
              f"(b) {name}: each rank's render_multihost through {', '.join(counted)} "
              f"({[[r[name]['launches'][c] for c in counted] for r in ranks]} launches), no "
              f"fused kernel")
        check(torch.equal(mean.to(dev), films_a[name].mean)
              and torch.equal(m2.to(dev), films_a[name].m2)
              and n == spp,
              f"(b) {name}: the gathered world-2 film equals (a)'s bit for bit")
        agg = W * H * spp / max(r[name]["wall"] for r in ranks) / 1e6
        mp_a = W * H * spp / walls_a[name] / 1e6
        for k, r in enumerate(ranks):
            busy, launches, _, seen, fused = r[name]["trace"]
            check(not fused and shows_kernels(name, seen),
                  f"(b) {name} rank {k}: traced spp of its block: {seen}, no fused kernel")
            print(f"  (b) {name} rank {k}: {r[name]['wall']:.3f} s; traced spp: {launches:.0f} host "
                  f"launches, device busy {1e3 * busy:.3f} ms; gather_film (gloo, through the "
                  f"host) {1e3 * r[name]['gather_s']:.3f} ms {tag}")
        print(f"  (b) {name}: aggregate {agg:.4f} Mpaths/s at world 2 (the slower rank's wall) "
              f"against {mp_a:.4f} at world 1 ({agg / mp_a:.3f}x) {tag}")
    for k, r in enumerate(ranks):
        hold_step(f"world 2, rank {k}", r["step"])
        print(f"  (c) world 2, rank {k}: fwd+bwd {r['step']['mpaths']:.4f} Mpaths/s of the whole "
              f"image; all-reduce (gloo, through the host) {1e3 * r['step']['allreduce_s']:.3f} "
              f"ms {tag}")
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 8)")

    # (d) the dense wavefront against render(fused="off"), linear order
    kw = dict(max_depth=DEPTH, pixel_order="linear")
    for name, (scene, spp, counted) in scenes.items():
        t0 = time.perf_counter()
        ref = MK.render(scene, W, H, spp, cfg=MK.MegakernelConfig(fused="off", **kw), kspp=spp)
        torch.cuda.synchronize()
        dt_ref = time.perf_counter() - t0
        zero()
        t0 = time.perf_counter()
        film = render_wavefront(scene, W, H, spp, cfg=WavefrontConfig(**kw), kspp=spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read()
        closest = got[counted[0]]
        check(went_through(got, counted),
              f"(d) {name}: render_wavefront {W}x{H}x{spp} through {', '.join(counted)} "
              f"({', '.join(str(got[c]) for c in counted)} launches), no fused kernel")
        check(torch.equal(film.mean, ref.mean) and torch.equal(film.m2, ref.m2),
              f"(d) {name}: the dense wavefront's film equals render(fused='off', "
              f"pixel_order='linear')'s bit for bit")
        _, _, seen, fused = device_trace(
            lambda: render_wavefront(scene, W, H, 1, cfg=WavefrontConfig(**kw)))
        check(not fused and shows_kernels(name, seen),
              f"(d) {name}: traced spp: {seen}, no fused kernel")
        print(f"  (d) {name}: the loop stopped at depth {closest / spp:g} of {DEPTH} (closest-hit "
              f"launches per spp); {W * H * spp / dt / 1e6:.4f} Mpaths/s against "
              f"render(fused='off')'s {W * H * spp / dt_ref / 1e6:.4f} (host clock) {tag}")

    # (e) the pool wavefront against render(fused="off") at 16 spp
    for name, (scene, _, counted) in scenes.items():
        t0 = time.perf_counter()
        ref = MK.render(scene, W, H, POOL_SPP, cfg=MK.MegakernelConfig(max_depth=DEPTH, fused="off"),
                        kspp=POOL_SPP)
        torch.cuda.synchronize()
        dt_ref = time.perf_counter() - t0
        zero()
        t0 = time.perf_counter()
        film = render_pool_wavefront(scene, W, H, POOL_SPP, cfg=WavefrontConfig(max_depth=DEPTH))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read()
        iters = got[counted[0]]
        dm = float((film.mean - ref.mean).abs().max())
        d2 = float((film.m2 - ref.m2).abs().max())
        check(went_through(got, counted),
              f"(e) {name}: render_pool_wavefront {W}x{H}x{POOL_SPP} (pool {min(W * H, 1 << 16)}) "
              f"through {', '.join(counted)} ({', '.join(str(got[c]) for c in counted)} "
              f"launches), no fused kernel")
        check(dm <= POOL_MEAN_ATOL and d2 <= POOL_M2_ATOL and float(film.n) == POOL_SPP,
              f"(e) {name}: the pool's film within {POOL_MEAN_ATOL:g} (mean, max abs diff "
              f"{dm:.3e}) and {POOL_M2_ATOL:g} (M2, {d2:.3e}) of render(fused='off')'s")
        t0 = time.perf_counter()
        render_pool_wavefront(scene, W, H, POOL_TRACE_SPP, cfg=WavefrontConfig(max_depth=DEPTH))
        torch.cuda.synchronize()
        dt_small = time.perf_counter() - t0
        busy, n_kern, seen, fused = device_trace(lambda: render_pool_wavefront(
            scene, W, H, POOL_TRACE_SPP, cfg=WavefrontConfig(max_depth=DEPTH)))
        check(busy > 0.0 and not fused and shows_kernels(name, seen),
              f"(e) {name}: a traced pool run at {POOL_TRACE_SPP} spp: {seen}, no fused kernel")
        print(f"  (e) {name}: {iters} iterations ({iters * min(W * H, 1 << 16) / (W * H * POOL_SPP):.3f} "
              f"pool-bounces per path); {dt:.3f} s, {W * H * POOL_SPP / dt / 1e6:.4f} Mpaths/s "
              f"against the dense render(fused='off')'s {W * H * POOL_SPP / dt_ref / 1e6:.4f} "
              f"in this call; traced run at {POOL_TRACE_SPP} spp: {n_kern} device kernels "
              f"({n_kern / POOL_TRACE_SPP:.0f} per spp, one per kernel launch), device busy "
              f"{1e3 * busy:.3f} ms ({100 * busy / dt_small:.1f} % of the untraced "
              f"{1e3 * dt_small:.1f} ms) {tag}")
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 8)")

    # (f) the NaN guard
    small = cornell_box(NAN_SIZE, NAN_SIZE, device=dev)
    cfg_dbg = MK.MegakernelConfig(max_depth=DEPTH, fused="off", debug=True)
    zero()
    film = MK.render(small, NAN_SIZE, NAN_SIZE, 2, cfg=cfg_dbg, kspp=1)
    got = read()
    check(bool(torch.isfinite(film.mean).all()) and went_through(got, scenes["cornell"][2]),
          f"(f) NaN guard quiet on a clean {NAN_SIZE}x{NAN_SIZE} Cornell render (kernels 2 and 3)")
    albedo = small.materials.albedo.clone()
    albedo[0, 0] = float("nan")
    try:
        MK.render(inject_params(small, {"albedo": albedo}), NAN_SIZE, NAN_SIZE, 2, cfg=cfg_dbg, kspp=1)
        raised = "nothing"
    except FloatingPointError as e:
        raised = str(e)
    check(raised.startswith("NaN guard"), f"(f) a poisoned albedo raises: {raised}")
    unchecked = MK.render(inject_params(small, {"albedo": albedo}), NAN_SIZE, NAN_SIZE, 2,
                          cfg=dataclasses.replace(cfg_dbg, debug=False), kspp=1)
    check(not bool(torch.isfinite(unchecked.mean).all()),
          "(f) without debug the poisoned film comes back unchecked")
    syncs = {}
    for on in (False, True):
        cfg_on = dataclasses.replace(cfg_dbg, debug=on)
        _, _, n_launch, syncs[on], _ = traced_render(
            lambda: MK.render(small, NAN_SIZE, NAN_SIZE, 1, cfg=cfg_on, kspp=1), 1, {})
    check(syncs[True] - syncs[False] == 1,
          f"(f) the guard costs one stream sync a batch, none when off: {syncs[True]:g} against "
          f"{syncs[False]:g} syncs per one-sample batch ({n_launch:g} kernel launches)")

    # (g) the CLI in multi-process mode, two processes on the card
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        outs = run_workers([[sys.executable, script, "--phase8-cli", str(r), str(port),
                             os.path.join(tmp, f"multi{r}.png")] for r in range(2)],
                           WORKER_TIMEOUT_S)
        counts = [json.loads([ln for ln in o.splitlines() if ln.startswith('{"rank"')][-1])
                  ["launches"] for o in outs]
        zero()
        rc = cli.main(phase8_cli_args(os.path.join(tmp, "single.png"))
                      + ["--coordinator", f"localhost:{free_port()}", "--num-processes", "1"])
        got = read()
        check(rc == 0 and all(went_through(c, scenes["cornell"][2]) for c in counts + [got]),
              f"(g) the CLI's ranks (and the one-process run) went through kernels 2 and 3, no "
              f"fused kernel: {[[c['closest_bruteforce'], c['anyhit_bruteforce']] for c in counts]} "
              f"and {[got['closest_bruteforce'], got['anyhit_bruteforce']]} launches")
        same = all(open(os.path.join(tmp, f"multi0{s}.png"), "rb").read()
                   == open(os.path.join(tmp, f"single{s}.png"), "rb").read()
                   for s in ("", "_sqrt_mse"))
        check(same and not os.path.exists(os.path.join(tmp, "multi1.png")),
              f"(g) two-process CLI ({CLI_MP_SIZE}x{CLI_MP_SIZE}, {CLI_MP_SPP} spp): rank 0's PNGs "
              f"byte-equal to a one-process run's (--num-processes 1); rank 1 wrote none")
    check(not dist.is_initialized(), "no process group left open")
    print(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s {tag}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from cuda_optix_pathtracing_tpu_torch import native
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import trace_paths_fused
    from cuda_optix_pathtracing_tpu_torch.ops import _cuda_build
    from cuda_optix_pathtracing_tpu_torch.ops import bvh_cuda as BV
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R
    from cuda_optix_pathtracing_tpu_torch.ops.filters import filter_sampler
    from cuda_optix_pathtracing_tpu_torch.ops.film import film_sqrt_mse, srgb_encode, to_uint8
    from cuda_optix_pathtracing_tpu_torch.ops.intersect import (
        intersect_any,
        intersect_closest_raw,
    )
    from cuda_optix_pathtracing_tpu_torch.ops.intersect_cuda import (
        any_plain,
        anyhit_bruteforce,
        closest_bruteforce,
        closest_plain,
    )
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh
    from cuda_optix_pathtracing_tpu_torch.utils import cli
    from cuda_optix_pathtracing_tpu_torch.utils.imageio import write_png

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_script = time.perf_counter()

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    print(card)
    tag = f"[{card}]"
    sources = ["intersect", "megakernel", "bvh"]

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    floor_tmp = tempfile.TemporaryDirectory()
    with ThreadPoolExecutor(2) as pool:
        gxx = pool.submit(timed, native.build)
        floor = pool.submit(build_floor_kernel, floor_tmp.name)
        t_nvcc = timed(lambda: _cuda_build.build_all(sources))
        t_gxx = gxx.result()
        floor_lib = floor.result()
    floor_tmp.cleanup()
    print(f"build: nvcc {t_nvcc:.1f} s (sm_90a, {len(sources)} sources in parallel, and an "
          f"empty kernel for the launch floor); g++ BVH builder {t_gxx:.1f} s, alongside")
    for name in sources:
        for line in _cuda_build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    scene = cornell_box(W, H, device=dev)
    v0, e0, e1 = scene.tri_v0, scene.tri_e0, scene.tri_e1
    n_tris = scene.num_triangles
    t0 = time.perf_counter()
    mesh = cornell_box_mesh(W, H, subdiv=MESH_SUBDIV, device=dev)
    mv0, me0, me1 = mesh.tri_v0, mesh.tri_e0, mesh.tri_e1
    print(f"mesh scene (subdiv {MESH_SUBDIV}): {int((mesh.bvh.perm >= 0).sum())} triangles in "
          f"{mesh.num_triangles} packed rows, {mesh.bvh.num_nodes} nodes, depth "
          f"{mesh.bvh.depth}, built in {time.perf_counter() - t0:.2f} s")

    # camera rays of PARITY_SPP samples (the fused="off" path's first bounce)
    px, py, sample, cam_o, cam_d = camera_rays(scene, PARITY_SPP)
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
        e = check_closest(f"closest {label}", tk, ik, tp, ip)
        print(f"  closest {label}: {int(((tk != tp) | (ik != ip)).sum())} of {tk.shape[0]} rows "
              f"differ from the plain version in t or index")
        err["closest"] = max(err.get("closest", 0.0), e)
        tm = t_max if label == "random" else 3.0
        ok_ = anyhit_bruteforce(o, d, v0, e0, e1, tm)
        op_ = any_plain(o, d, v0, e0, e1, tm)
        torch.cuda.synchronize()
        n_diff = int((ok_ != op_).sum())
        check(n_diff == 0, f"anyhit {label}: flags equal to the plain version's "
              f"({int(op_.sum())} occluded, {n_diff} differ)")
        err["anyhit"] = max(err.get("anyhit", 0.0), float(n_diff > 0))

    cfg_plain = MK.MegakernelConfig(max_depth=DEPTH, backend="torch", fused="off")
    rad_k = trace_paths_fused(scene, px, py, sample, cam_o, cam_d, max_depth=DEPTH)
    rad_p = MK.trace_paths(scene, cfg_plain, px, py, sample, cam_o, cam_d, device=dev)
    err["fused"] = check_parity("fused", rad_k, rad_p, PARITY_SPP)
    # kernel 1h, brute force: the Halton instantiation on Halton camera rays
    hpx, hpy, hsample, h_o, h_d = camera_rays(scene, PARITY_SPP, sampler="halton")
    cfg_hplain = MK.MegakernelConfig(max_depth=DEPTH, backend="torch", fused="off",
                                     sampler="halton")
    rad_k = trace_paths_fused(scene, hpx, hpy, hsample, h_o, h_d, max_depth=DEPTH,
                              sampler="halton")
    rad_p = MK.trace_paths(scene, cfg_hplain, hpx, hpy, hsample, h_o, h_d, device=dev)
    err["fused_halton"] = check_parity(f"fused Halton ({h_o.shape[0]} paths)", rad_k, rad_p,
                                       PARITY_SPP)

    # the mesh scene: the traversal kernels on Morton-ordered camera rays and
    # on the live bounce and cast shadow rays of one depth of a plain run
    n1 = W * H
    print(f"phase 2, mesh: traversal kernels against the plain sweep over "
          f"{mesh.num_triangles} packed rows ({n1} rays per set)")
    mpx1, mpy1, ms1, mo1, md1 = camera_rays(mesh, 1, morton=True)
    mpx4, mpy4, ms4, mo4, md4 = camera_rays(mesh, 4, morton=True)
    (bo, bd), (so, sd, stm) = depth0_rays(MK, mesh, cfg_plain, mpx4, mpy4, ms4, mo4, md4)
    check(bo.shape[0] >= n1 and so.shape[0] >= n1,
          f"depth 0 of a plain run over {mo4.shape[0]} paths: {bo.shape[0]} live bounce rays, "
          f"{so.shape[0]} cast shadow rays (>= {n1} each)")
    ray_sets = (
        ("camera", mo1, md1, torch.full((n1,), 3.0, device=dev)),
        ("bounce", bo[:n1], bd[:n1], torch.full((n1,), 3.0, device=dev)),
        ("shadow", so[:n1], sd[:n1], stm[:n1]),
    )
    for label, o, d, tm in ray_sets:
        tk, ik = BV.bvh_closest_raw(o, d, mesh)
        tp, ip = intersect_closest_raw(o, d, mv0, me0, me1)
        e = check_closest(f"bvh_closest {label}", tk, ik, tp, ip)
        err["bvh_closest"] = max(err.get("bvh_closest", 0.0), e)
        ok_ = BV.bvh_any_raw(o, d, mesh, tm) > 0
        op_ = intersect_any(o, d, mv0, me0, me1, tm)
        torch.cuda.synchronize()
        n_diff = int((ok_ != op_).sum())
        check(n_diff == 0, f"bvh_anyhit {label}: flags equal to the plain sweep's "
              f"({int(op_.sum())} occluded, {n_diff} differ)")
        err["bvh_anyhit"] = max(err.get("bvh_anyhit", 0.0), float(n_diff > 0))

    # kernel 1h, BVH mode: all of PARITY_SPP Halton samples of the mesh in
    # Morton order, every 8th path held to the plain version
    mhpx, mhpy, mhs, mho, mhd = camera_rays(mesh, PARITY_SPP, morton=True, sampler="halton")
    rad_k = trace_paths_fused(mesh, mhpx, mhpy, mhs, mho, mhd, max_depth=DEPTH, sampler="halton")
    sub = torch.arange(0, mho.shape[0], MESH_PARITY_STRIDE, device=dev)
    rad_p = MK.trace_paths(mesh, cfg_hplain, mhpx[sub], mhpy[sub], mhs[sub], mho[sub], mhd[sub],
                           device=dev)
    err["fused_bvh_halton"] = check_parity(
        f"fused BVH Halton (every {MESH_PARITY_STRIDE}th of {mho.shape[0]} paths)",
        rad_k[sub], rad_p, PARITY_SPP)

    # kernel 6 on the mesh leg's pass (16 spp of Morton-ordered camera rays,
    # 1,048,576 paths) at the depths of K6_CHECK_DEPTHS, sorted as the
    # route sorts them, against the plain bounce on every 8th path
    n_pass = W * H * MESH_SPP
    print(f"phase 2, kernel 6: pt_bounce_bvh against bounce_step on the {n_pass}-path "
          f"mesh pass, every {K6_STRIDE}th path, depths {K6_CHECK_DEPTHS}")
    err["bounce"] = 0.0
    for smp, depths in (("hash", K6_CHECK_DEPTHS), ("halton", (0,))):
        st = MKC.pack_path_state(*camera_rays(mesh, MESH_SPP, morton=True, sampler=smp))
        perm = None
        for depth in range(max(depths) + 1):
            if depth in depths:
                sub = torch.arange(0, n_pass, K6_STRIDE, device=dev)
                sp = st[sub].clone()
                MKC.bounce_plain(mesh, sp, depth, sampler=smp)
                n_dead = int((st.view(torch.int32)[:, MKC.ALIVE] == 0).sum())
                before = st.clone()
                keys = MKC.bounce_fused(mesh, st, depth, sampler=smp, perm=perm)
                dead = before.view(torch.int32)[:, MKC.ALIVE] == 0
                check(bool((st[dead] == before[dead]).all()),
                      f"kernel 6 {smp} depth {depth}: the {n_dead} dead paths' rows untouched")
                label = f"kernel 6 {smp} depth {depth} ({n_dead} dead of {n_pass})"
                check_keys(MKC, label, mesh, st, keys)
                err["bounce"] = max(err["bounce"], check_planes(MKC, label, st[sub], sp))
                del before
            else:
                keys = MKC.bounce_fused(mesh, st, depth, sampler=smp, perm=perm)
            perm = MKC.sort_paths(keys)
    del st

    # kernel 5 (persistent, regenerating paths) at sizes below one wave of
    # its grid and ragged, against its plain version path by path (the
    # sweep in chunks of 1,024 rows: the same result as 32, fewer launches)
    cfg_check = MK.MegakernelConfig(max_depth=DEPTH, backend="torch", fused="off",
                                    tri_chunk=1024)
    kpx, kpy, ks, ko, kd = camera_rays(mesh, 2, morton=True)
    for n_k in K5_SIZES:
        before = trace_paths_fused.launches
        args = tuple(x[:n_k] for x in (kpx, kpy, ks, ko, kd))
        rk = trace_paths_fused(mesh, *args, max_depth=DEPTH)
        check(rk.shape == (n_k, 3) and trace_paths_fused.launches == before + (n_k > 0),
              f"fused BVH at n = {n_k}: ({n_k}, 3) radiance, {int(n_k > 0)} launch")
        if n_k:
            rp = MK.trace_paths(mesh, cfg_check, *args, device=dev)
            err["fused_bvh"] = max(err.get("fused_bvh", 0.0),
                                   check_parity(f"fused BVH at n = {n_k}", rk, rp, 1))

    # a deeper tree whose nodes exceed L1
    mesh_big = cornell_box_mesh(W, H, subdiv=MESH_BIG_SUBDIV, device=dev)
    print(f"  subdivision {MESH_BIG_SUBDIV}: {mesh_big.bvh.num_nodes} nodes "
          f"({mesh_big.bvh.nodes.numel() * 4 / 1024:.1f} KB), depth {mesh_big.bvh.depth}; "
          f"subdivision {MESH_SUBDIV}: {mesh.bvh.nodes.numel() * 4 / 1024:.1f} KB")
    gpx, gpy, gs, go, gd = camera_rays(mesh_big, 1, morton=True)
    sub = torch.arange(0, n1, MESH_PARITY_STRIDE, device=dev)
    rk = trace_paths_fused(mesh_big, gpx, gpy, gs, go, gd, max_depth=DEPTH)
    rp = MK.trace_paths(mesh_big, cfg_check, gpx[sub], gpy[sub], gs[sub], go[sub], gd[sub],
                        device=dev)
    err["fused_bvh"] = max(err["fused_bvh"], check_parity(
        f"fused BVH, subdivision {MESH_BIG_SUBDIV} (every {MESH_PARITY_STRIDE}th of {n1} paths)",
        rk[sub], rp, 1))
    st = MKC.pack_path_state(gpx, gpy, gs, go, gd)
    sp = st[sub].clone()
    MKC.bounce_plain(mesh_big, sp, 0)
    keys = MKC.bounce_fused(mesh_big, st, 0)
    label = (f"kernel 6, subdivision {MESH_BIG_SUBDIV}, depth 0 (every {MESH_PARITY_STRIDE}th of "
             f"{n1} paths)")
    check_keys(MKC, label, mesh_big, st, keys)
    err["bounce"] = max(err["bounce"], check_planes(MKC, label, st[sub], sp))
    del mesh_big, st

    # ---- 3. the main paths -------------------------------------------------
    print("phase 3: main paths")
    counters, zero, read = launch_counters()

    main_scene = cornell_box(W, H)
    zero()
    t0 = time.perf_counter()
    film_on = MK.render(main_scene, W, H, spp=SPP_FUSED)
    torch.cuda.synchronize()
    dt_on = time.perf_counter() - t0
    launches_on = read()
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

    def run_cli(scene_name: str, spp: int, extra=()):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "cli.png")
            zero()
            rc = cli.main(["--scene", scene_name, "--out", out, "--spp", str(spp),
                           "--log-level", "warning", *extra])
            launches = read()
            print(f"  CLI --scene {scene_name} --spp {spp} {' '.join(extra)}: {launches}")
            check(rc == 0 and os.path.getsize(out) > 0
                  and os.path.getsize(os.path.join(tmp, "cli_sqrt_mse.png")) > 0,
                  f"the CLI on {scene_name} wrote the mean and sqrt-MSE PNGs")
        return launches

    launches_cli = run_cli("cornell", SPP_CLI)
    check(launches_cli["trace_paths_fused"] == SPP_CLI,
          "the CLI rendered through the fused kernel, one launch per spp")

    zero()
    film_off = MK.render(main_scene, W, H, spp=SPP_OFF, cfg=MK.MegakernelConfig(fused="off"))
    launches_off = read()
    print(f"  render fused='off': {launches_off}")
    check(launches_off["closest_bruteforce"] > 0 and launches_off["anyhit_bruteforce"] > 0,
          "fused='off' render went through the closest-hit and any-hit kernels")
    check(bool(torch.isfinite(film_off.mean).all()), "fused='off' film finite")
    check_means_agree(f"fused ({SPP_FUSED} spp) and fused='off' ({SPP_OFF} spp)",
                      film_on, film_off)

    # the Halton sampler, with the box and with the Mitchell filter, down
    # both routes; and the CLI with --sampler halton
    films_h = {}
    launches_h = {}
    for filt in ("box", "mitchell"):
        for route, spp in (("on", SPP_FUSED), ("off", SPP_OFF)):
            cfg_r = MK.MegakernelConfig(sampler="halton", pixel_filter=filt, fused=route)
            zero()
            films_h[filt, route] = MK.render(main_scene, W, H, spp=spp, cfg=cfg_r)
            launches_h[filt, route] = read()
            print(f"  render Halton, {filt} filter, fused='{route}' ({spp} spp): "
                  f"{launches_h[filt, route]}")
            lh = launches_h[filt, route]
            if route == "on":
                check(lh["trace_paths_fused"] == SPP_FUSED and lh["closest_bruteforce"] == 0,
                      f"Halton {filt} render went through the fused kernel, one launch per spp")
            else:
                check(lh["trace_paths_fused"] == 0 and lh["closest_bruteforce"] > 0
                      and lh["anyhit_bruteforce"] > 0,
                      f"Halton {filt} fused='off' render went through the closest-hit and "
                      f"any-hit kernels")
            fm = films_h[filt, route].mean
            check(bool(torch.isfinite(fm).all()) and float(fm.mean()) > 0.0,
                  f"Halton {filt} fused='{route}' film finite, mean {float(fm.mean()):.5f} > 0")
        check_means_agree(f"Halton {filt}: fused ({SPP_FUSED} spp) and fused='off' ({SPP_OFF} spp)",
                          films_h[filt, "on"], films_h[filt, "off"])
    check_means_agree("Halton and hash, box filter, fused", films_h["box", "on"], film_on)
    # sign-weighted filter importance sampling scales the image by
    # sum(f) / sum(|f|) of the filter, so the Mitchell film is held to its
    # own routes above and its mean ratio to the box film only printed
    ftab = filter_sampler(str(dev)).table
    ratio = float(films_h["mitchell", "on"].mean.mean() / films_h["box", "on"].mean.mean())
    print(f"  Mitchell / box film mean {ratio:.5f}; the filter's sum(f)/sum(|f|) "
          f"{float(ftab.sum() / ftab.abs().sum()):.5f}")
    launches_hcli = run_cli("cornell", SPP_CLI, ("--sampler", "halton"))
    check(launches_hcli["trace_paths_fused"] == SPP_CLI,
          "the CLI with --sampler halton rendered through the fused kernel, one launch per spp")

    # the bench's mesh leg: 16 spp traced as one pass, both routes
    mesh_main = cornell_box_mesh(W, H, subdiv=MESH_SUBDIV)
    mesh_kw = dict(spp=MESH_SPP, kspp=MESH_SPP, spp_per_pass=MESH_SPP)
    cfg_moff = MK.MegakernelConfig(fused="off")
    cfg_mon = MK.MegakernelConfig(fused="on")
    zero()
    t0 = time.perf_counter()
    film_moff = MK.render(mesh_main, W, H, cfg=cfg_moff, **mesh_kw)
    torch.cuda.synchronize()
    dt_moff = time.perf_counter() - t0
    launches_moff = read()
    print(f"  render mesh fused='off' ({MESH_SPP} spp, one pass): {launches_moff}")
    check(launches_moff["bvh_closest_raw"] == DEPTH and launches_moff["bvh_any_raw"] == DEPTH
          and launches_moff["trace_paths_fused"] == 0,
          f"the mesh wavefront went through the traversal kernels, closest and any-hit "
          f"once per depth ({DEPTH}) in its one pass")
    check(bool(torch.isfinite(film_moff.mean).all()) and float(film_moff.mean.mean()) > 0.0,
          f"mesh fused='off' film finite, mean {float(film_moff.mean.mean()):.5f} > 0")

    zero()
    t0 = time.perf_counter()
    film_mon = MK.render(mesh_main, W, H, cfg=cfg_mon, **mesh_kw)
    torch.cuda.synchronize()
    dt_mon = time.perf_counter() - t0
    launches_mon = read()
    print(f"  render mesh fused='on' ({MESH_SPP} spp, one pass): {launches_mon}")
    check(launches_mon["trace_paths_fused"] == 1 and launches_mon["bvh_closest_raw"] == 0,
          "the mesh render with fused='on' went through the fused BVH kernel, one launch")
    check(bool(torch.isfinite(film_mon.mean).all()) and float(film_mon.mean.mean()) > 0.0,
          f"mesh fused='on' film finite, mean {float(film_mon.mean.mean()):.5f} > 0")
    check_means_agree("mesh fused='on' and fused='off'", film_mon, film_moff)

    launches_mcli = run_cli("cornell-mesh", MESH_CLI_SPP)
    check(launches_mcli["trace_paths_fused"] == MESH_CLI_SPP,
          "the CLI on cornell-mesh took the fused BVH kernel (auto), one launch per spp")

    # the mesh leg with the Halton sampler through the fused BVH kernel
    cfg_mhal = MK.MegakernelConfig(fused="on", sampler="halton")
    zero()
    film_mhal = MK.render(mesh_main, W, H, cfg=cfg_mhal, **mesh_kw)
    launches_mhal = read()
    print(f"  render mesh Halton fused='on' ({MESH_SPP} spp, one pass): {launches_mhal}")
    check(launches_mhal["trace_paths_fused"] == 1,
          "the mesh render with the Halton sampler went through the fused BVH kernel, one launch")
    check_means_agree("mesh Halton and hash, fused='on'", film_mhal, film_mon)

    # the depth-sorted fused wavefront on the leg's one pass: 1,048,576
    # camera rays in Morton order, one single-bounce launch per depth, held
    # to the fused BVH kernel on the same rays (the reference holds its
    # sorted route to its fused kernel at atol 1e-6, rtol 1e-5)
    sorted_rays = {}
    launches_sorted = {}
    rad_sorted = {}
    for smp in ("hash", "halton"):
        sorted_rays[smp] = camera_rays(mesh_main, MESH_SPP, morton=True, sampler=smp)
        zero()
        rad_sorted[smp] = MKC.trace_paths_fused_sorted(mesh_main, *sorted_rays[smp],
                                                       max_depth=DEPTH, sampler=smp)
        launches_sorted[smp] = read()
        print(f"  trace_paths_fused_sorted {smp} ({n_pass} paths): {launches_sorted[smp]}")
        check(launches_sorted[smp]["bounce_fused"] == DEPTH
              and launches_sorted[smp]["trace_paths_fused"] == 0,
              f"the sorted route ({smp}) went through the single-bounce kernel, once per depth")
        rs = rad_sorted[smp]
        check(bool(torch.isfinite(rs).all()) and rs.shape == (n_pass, 3) and float(rs.mean()) > 0,
              f"sorted route ({smp}): finite radiance of {n_pass} paths, mean {float(rs.mean()):.5f}")
        rf = trace_paths_fused(mesh_main, *sorted_rays[smp], max_depth=DEPTH, sampler=smp)
        torch.cuda.synchronize()
        close = bool(torch.allclose(rs, rf, atol=1e-6, rtol=1e-5))
        n_far = int((~torch.isclose(rs, rf, atol=1e-6, rtol=1e-5)).any(-1).sum())
        print(f"  sorted route ({smp}) against pt_fused_bvh on the same paths: "
              f"atol 1e-6 / rtol 1e-5 {'holds' if close else 'does not hold'} "
              f"({n_far} of {n_pass} paths outside it, max abs diff "
              f"{float((rs - rf).abs().max()):.2e})")
        check_parity(f"sorted route ({smp})", rs, rf, MESH_SPP, ref="pt_fused_bvh")
        check(torch.equal(rs, rf), f"sorted route ({smp}) equals pt_fused_bvh bit for bit on all "
              f"{n_pass} paths")

    # ---- 4. the main paths' own launches, and timing -----------------------
    print(f"phase 4: the kernels at the main path's own launches, and timing {tag}")
    o1, d1 = cam_o[:n1].contiguous(), cam_d[:n1].contiguous()
    px1, py1, s1 = px[:n1], py[:n1], sample[:n1]

    saved = {c: c.launches for c in counters}
    # the main paths' spread: repeated untraced renders, back to back,
    # before any profiler session; the two mesh routes in turns
    mpaths_rep = []
    for _ in range(RENDER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MK.render(main_scene, W, H, spp=SPP_FUSED)
        torch.cuda.synchronize()
        mpaths_rep.append(W * H * SPP_FUSED / (time.perf_counter() - t0) / 1e6)
    cfg_off = MK.MegakernelConfig(fused="off")
    off_rep = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MK.render(main_scene, W, H, spp=SPP_OFF, cfg=cfg_off)
        torch.cuda.synchronize()
        off_rep.append(W * H * SPP_OFF / (time.perf_counter() - t0) / 1e6)
    mesh_first = {"off": W * H * MESH_SPP / dt_moff / 1e6, "on": W * H * MESH_SPP / dt_mon / 1e6}
    mesh_rep = {"off": [], "on": []}
    for route in ("off", "on", "on", "off"):
        cfg_r = cfg_mon if route == "on" else cfg_moff
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MK.render(mesh_main, W, H, cfg=cfg_r, **mesh_kw)
        torch.cuda.synchronize()
        mesh_rep[route].append(W * H * MESH_SPP / (time.perf_counter() - t0) / 1e6)
    # the fused="off" route with and without the ray sort and the Morton
    # pixel order (sort_rays, pixel_order; auto = sorted, Morton): the four
    # choices in turns, twice each. Each film must equal auto's bit for bit:
    # the order of the rays changes no ray's result
    variants = {(srt, order): MK.MegakernelConfig(fused="off", sort_rays=srt, pixel_order=order)
                for srt in ("on", "off") for order in ("morton", "linear")}
    var_rep = {key: [] for key in variants}
    var_diff = {}
    for key in list(variants) + list(variants)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film_v = MK.render(mesh_main, W, H, cfg=variants[key], **mesh_kw)
        torch.cuda.synchronize()
        var_rep[key].append(W * H * MESH_SPP / (time.perf_counter() - t0) / 1e6)
        var_diff[key] = max(var_diff.get(key, 0.0),
                            float((film_v.mean - film_moff.mean).abs().max()))
    check(all(v == 0.0 for v in var_diff.values()),
          f"fused='off' films with and without the ray sort and Morton order equal "
          f"auto's bit for bit (max abs diffs {list(var_diff.values())})")

    # the mesh kernels at the main path's own launches: every launch of one
    # more render of each route (kernel 4: 5 closest-hit and 5 any-hit
    # launches of 1,048,576 rays; kernel 5: one of 1,048,576 paths)
    rec = record_bvh_launches(MK, lambda: MK.render(mesh_main, W, H, cfg=cfg_moff, **mesh_kw))
    n_bvh = rec["closest"][0][0].shape[0]
    recf = record_fused_launches(MKC, lambda: MK.render(mesh_main, W, H, cfg=cfg_mon, **mesh_kw))
    check(len(recf) == 1 and recf[0][0][3].shape[0] == W * H * MESH_SPP,
          f"recorded the mesh leg's one fused launch of {W * H * MESH_SPP} paths")
    (fpx, fpy, fsample, fo, fd), fkw = recf[0]
    rad_k = trace_paths_fused(mesh_main, fpx, fpy, fsample, fo, fd, **fkw)
    # each path's radiance depends on its own inputs only, so a strided
    # subset of the launch is held to the plain version on the same paths
    sub = torch.arange(0, fo.shape[0], MESH_PARITY_STRIDE, device=dev)
    cfg_fkw = MK.MegakernelConfig(backend="torch", fused="off", **fkw)
    rad_p = MK.trace_paths(mesh_main, cfg_fkw, fpx[sub], fpy[sub], fsample[sub], fo[sub],
                           fd[sub], device=dev)
    err["fused_bvh"] = max(err["fused_bvh"], check_parity(
        f"fused BVH at its main-path launch (every {MESH_PARITY_STRIDE}th of "
        f"{fo.shape[0]} paths, {sub.shape[0]})", rad_k[sub], rad_p, MESH_SPP
    ))

    # kernels 2 and 3 at the main path's own launches: every launch of one
    # more Cornell fused="off" render (5 closest-hit and 5 any-hit launches
    # of 65,536 rays per spp), each held to its plain version row by row
    recb = record_brute_launches(MK, lambda: MK.render(main_scene, W, H, spp=SPP_OFF, cfg=cfg_off))
    check(len(recb["closest"]) == DEPTH * SPP_OFF and len(recb["any"]) == DEPTH * SPP_OFF
          and all(a[0].shape[0] == n1 for a, _ in recb["closest"] + recb["any"]),
          f"recorded the Cornell fused='off' render's {DEPTH} + {DEPTH} launches of {n1} rays "
          f"per spp ({SPP_OFF} spp)")
    bv0, be0, be1 = main_scene.tri_v0, main_scene.tri_e0, main_scene.tri_e1
    n_diff = {"closest": 0, "any": 0}
    for (o, d), kw in recb["closest"]:
        tk, ik = closest_bruteforce(o, d, bv0, be0, be1, **kw)
        tp, ip = closest_plain(o, d, bv0, be0, be1)
        n_diff["closest"] += int(((tk != tp) | (ik != ip)).sum())
    n_occ = 0
    for (o, d, tm), kw in recb["any"]:
        ok_ = anyhit_bruteforce(o, d, bv0, be0, be1, tm, **kw)
        op_ = any_plain(o, d, bv0, be0, be1, tm)
        n_diff["any"] += int((ok_ != op_).sum())
        n_occ += int(op_.sum())
    n_rec = n1 * DEPTH * SPP_OFF
    print(f"  closest_bruteforce at its {len(recb['closest'])} main-path launches: "
          f"{n_diff['closest']} of {n_rec} rows differ from the plain version in t or index; "
          f"anyhit_bruteforce at its {len(recb['any'])}: {n_diff['any']} of {n_rec} flags "
          f"differ ({n_occ} occluded)")
    check(n_diff["closest"] == 0 and n_diff["any"] == 0,
          "kernels 2 and 3 at the main path's launches: t, index and flags equal to the plain "
          "versions' on every row")
    err["closest"] = max(err["closest"], float(n_diff["closest"] > 0))
    err["anyhit"] = max(err["anyhit"], float(n_diff["any"] > 0))

    def replay_brute_closest():
        for (o, d), kw in recb["closest"]:
            closest_bruteforce(o, d, bv0, be0, be1, **kw)

    def replay_brute_any():
        for (o, d, tm), kw in recb["any"]:
            anyhit_bruteforce(o, d, bv0, be0, be1, tm, **kw)

    def replay_closest():
        for o, d in rec["closest"]:
            BV.bvh_closest_raw(o, d, mesh_main)

    def replay_any():
        for o, d, tm in rec["any"]:
            BV.bvh_any_raw(o, d, mesh_main, tm)

    hpx1, hpy1, hs1, ho1, hd1 = (x[:n1] for x in (hpx, hpy, hsample, h_o, h_d))
    mhpx1, mhpy1, mhs1, mho1, mhd1 = (x[:n1] for x in (mhpx, mhpy, mhs, mho, mhd))
    calls = {
        "fused": (lambda: trace_paths_fused(scene, px1, py1, s1, o1, d1, max_depth=DEPTH), 1),
        "fused_halton": (lambda: trace_paths_fused(scene, hpx1, hpy1, hs1, ho1, hd1,
                                                   max_depth=DEPTH, sampler="halton"), 1),
        "closest": (replay_brute_closest, len(recb["closest"])),
        "anyhit": (replay_brute_any, len(recb["any"])),
        "bvh_closest": (replay_closest, len(rec["closest"])),
        "bvh_anyhit": (replay_any, len(rec["any"])),
        "fused_bvh": (lambda: trace_paths_fused(mesh_main, fpx, fpy, fsample, fo, fd, **fkw), 1),
        "fused_bvh_halton": (lambda: trace_paths_fused(mesh_main, *sorted_rays["halton"],
                                                       max_depth=DEPTH, sampler="halton"), 1),
    }
    kernel_names = KERNEL_NAMES
    ms = {k: kernel_ms(fn, 4 if per > 1 else 20, kernel_names[k], per)
          for k, (fn, per) in calls.items()}
    # kernel 1 at 1,048,576 paths (16 spp in one launch, as spp_per_pass=16
    # would give): timing only
    fill_rays = camera_rays(scene, MESH_SPP)
    n_fill = fill_rays[3].shape[0]
    ms_fill = kernel_ms(lambda: trace_paths_fused(scene, *fill_rays, max_depth=DEPTH), 5,
                        kernel_names["fused"])

    def empty_launch():
        rc = floor_lib.empty_launch(FLOOR_THREADS, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")

    floor_ms = kernel_ms(empty_launch, 20, "empty_kernel")
    del fill_rays
    call_ms = {k: cuda_ms(fn, 4 if per > 1 else 20) / per for k, (fn, per) in calls.items()}
    # kernels 2 and 3's plain versions timed on their depth-1 launches
    (bo1, bd1), _ = recb["closest"][1]
    (ao1, ad1, atm1), _ = recb["any"][1]
    # kernel 4 against the plain sweep at the main path's depth-1 launches:
    # sorted rays, the paths that ended at depth 0 parked last. The plain
    # sweep is brute force over every packed row, so its time does not
    # depend on which launch it runs; the output of its timed call is kept
    o_c, d_c = rec["closest"][1]
    o_a, d_a, tm_a = rec["any"][1]
    plain_out = {}

    def plain_closest():
        plain_out["closest"] = intersect_closest_raw(o_c, d_c, mv0, me0, me1)

    def plain_any():
        plain_out["any"] = intersect_any(o_a, d_a, mv0, me0, me1, tm_a)

    plain_ms = {
        "fused": cuda_ms(lambda: MK.trace_paths(scene, cfg_plain, px1, py1, s1, o1, d1, device=dev), 1),
        "fused_halton": cuda_ms(lambda: MK.trace_paths(scene, cfg_hplain, hpx1, hpy1, hs1, ho1, hd1,
                                                       device=dev), 1),
        "closest": cuda_ms(lambda: closest_plain(bo1, bd1, bv0, be0, be1), 10),
        "anyhit": cuda_ms(lambda: any_plain(ao1, ad1, bv0, be0, be1, atm1), 10),
        "bvh_closest": cuda_ms(plain_closest, 1, reps=1),
        "bvh_anyhit": cuda_ms(plain_any, 1, reps=1),
        "fused_bvh": cuda_ms(lambda: MK.trace_paths(mesh, cfg_plain, mpx1, mpy1, ms1, mo1, md1,
                                                    device=dev), 1, reps=1),
        "fused_bvh_halton": cuda_ms(lambda: MK.trace_paths(mesh, cfg_hplain, mhpx1, mhpy1, mhs1,
                                                           mho1, mhd1, device=dev), 1, reps=1),
    }

    # kernel 6 per depth at the main path's own launches: the rows and the
    # permutation that one more sorted pass (hash) hands each launch, and
    # the keys that the sort between depths takes
    k6_in, k6_perm, k6_keys = [], [], []
    st = MKC.pack_path_state(*sorted_rays["hash"])
    perm = None
    for depth in range(DEPTH):
        k6_in.append(st.clone())
        k6_perm.append(perm)
        keys = MKC.bounce_fused(mesh_main, st, depth, perm=perm)
        if depth + 1 < DEPTH:
            k6_keys.append(keys.clone())
            perm = MKC.sort_paths(keys)
    check(torch.equal(rad_sorted["hash"], st[:, MKC.RADIANCE:MKC.RADIANCE + 3]),
          "the recorded sorted pass repeats the main path's radiance bit for bit")
    del st
    k6_live = [int((x.view(torch.int32)[:, MKC.ALIVE] != 0).sum()) for x in k6_in]

    # each timed launch on its own copy of its depth's rows
    def k6_launch(x, p, dep, **kw):
        c = x.clone()
        return lambda: MKC.bounce_fused(mesh_main, c, dep, perm=p, **kw)

    def k6_pass_ms():
        return [queued_ms(lambda x=x, p=p, dep=dep: k6_launch(x, p, dep))
                for dep, (x, p) in enumerate(zip(k6_in, k6_perm))]

    k6_ms = k6_pass_ms()
    k6_h0 = MKC.pack_path_state(*sorted_rays["halton"])
    k6_halton0_ms = queued_ms(lambda: k6_launch(k6_h0, None, 0, sampler="halton"))
    del k6_h0
    # the sort between depths, per op on the device (torch.profiler)
    sort_ms, sort_ops = [], {}
    for keys in k6_keys:
        warm_up(lambda k=keys: MKC.sort_paths(k))
        _, rows = profiled(lambda k=keys: [MKC.sort_paths(k) for _ in range(5)])
        dev_r = device_rows(rows)
        sort_ms.append(sum(e.self_device_time_total for e in dev_r) / 1e3 / 5)
        for e in dev_r:
            cnt, t = sort_ops.get(e.key, (0, 0.0))
            sort_ops[e.key] = (cnt + e.count, t + e.self_device_time_total / 1e3)
    # what path regeneration can recover: the lane-bounces that warps of
    # one path per thread (32 consecutive paths of the launch) keep busy,
    # from each path's bounces in the recorded pass (alive at a depth's
    # start: one bounce)
    bounces = sum((x.view(torch.int32)[:, MKC.ALIVE] != 0).to(torch.int32) for x in k6_in)
    warp_max = bounces.reshape(-1, 32).amax(1)
    lane_busy = float(bounces.sum()) / float(32 * warp_max.sum())
    ms["bounce"] = sum(k6_ms) / len(k6_ms)
    call_ms["bounce"] = cuda_ms(
        lambda: MKC.bounce_fused(mesh_main, k6_in[1].clone(), 1, perm=k6_perm[1]), 5)
    k6_plain_state = k6_in[1].clone()
    plain_ms["bounce"] = cuda_ms(lambda: MKC.bounce_plain(mesh_main, k6_plain_state.clone(), 1),
                                 1, reps=1)
    del k6_plain_state
    # the depth-sorted wavefront against the fused kernel on the same
    # 1,048,576 rays, in turns, host clock around each call
    route_rep = {"sorted": [], "fused": []}
    for route in ("sorted", "fused", "fused", "sorted"):
        fn = MKC.trace_paths_fused_sorted if route == "sorted" else trace_paths_fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(mesh_main, *sorted_rays["hash"], max_depth=DEPTH)
        torch.cuda.synchronize()
        route_rep[route].append(n_pass / (time.perf_counter() - t0) / 1e6)
    for label, o, d in (("closest", o_c, d_c), ("any", o_a, d_a)):
        n_dead = int((o[:, 0] == MK._DEAD_ORIGIN).sum())
        print(f"  bvh {label} at the main path's depth-1 launch: {o.shape[0]} sorted rays, "
              f"{n_dead} of them parked dead")
    tk, ik = BV.bvh_closest_raw(o_c, d_c, mesh_main)
    err["bvh_closest"] = max(err["bvh_closest"], check_closest(
        "bvh_closest at its main-path launch", tk, ik, *plain_out["closest"]))
    ok_ = BV.bvh_any_raw(o_a, d_a, mesh_main, tm_a) > 0
    torch.cuda.synchronize()
    n_diff = int((ok_ != plain_out["any"]).sum())
    check(n_diff == 0, f"bvh_anyhit at its main-path launch: flags equal to the plain "
          f"sweep's ({int(plain_out['any'].sum())} occluded, {n_diff} differ)")
    err["bvh_anyhit"] = max(err["bvh_anyhit"], float(n_diff > 0))
    # ... and to the numpy oracle of the reference layout's walk, bit for
    # bit, on every 512th ray of the launches
    from cuda_optix_pathtracing_tpu_torch.ops.bvh import traverse_packed_ref

    ref_tables = (mesh_main.bvh.box, mesh_main.bvh.meta, mesh_main.tri_v0, mesh_main.tri_e0,
                  mesh_main.tri_e1)
    pick_c = torch.arange(0, o_c.shape[0], o_c.shape[0] // BOUND_SAMPLE, device=dev)
    t_r, i_r, _ = traverse_packed_ref(*ref_tables, o_c[pick_c], d_c[pick_c])
    check(np.array_equal(tk[pick_c].cpu().numpy(), t_r)
          and np.array_equal(ik[pick_c].cpu().numpy(), i_r),
          f"bvh_closest at its main-path launch: t and rows of {len(pick_c)} rays equal "
          f"traverse_packed_ref's bit for bit")
    pick_a = torch.arange(0, o_a.shape[0], o_a.shape[0] // BOUND_SAMPLE, device=dev)
    occ_r, _ = traverse_packed_ref(*ref_tables, o_a[pick_a], d_a[pick_a], "any", tm_a[pick_a])
    check(np.array_equal(ok_[pick_a].cpu().numpy(), occ_r),
          f"bvh_anyhit at its main-path launch: flags of {len(pick_a)} rays equal "
          f"traverse_packed_ref's")

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"  after timing: SM clock, max SM clock, power draw: {clocks}")

    # data-dependent work of the timed launches, counted on the plain
    # versions: the any-hit kernel stops at the first occluder
    hits, tests, _ = fused_work(MK, scene, cfg_plain, px1, py1, s1, o1, d1)
    hhits, htests, hhits0 = fused_work(MK, scene, cfg_hplain, hpx1, hpy1, hs1, ho1, hd1)
    h0_dims = halton_depth0_dims(R, 2)
    hint = hhits0 * halton_int_ops(R, h0_dims)
    # (the mean over the recorded any-hit launches)
    any_tests = sum(first_occluder_tests(o, d, bv0, be0, be1, tm)
                    for (o, d, tm), _ in recb["any"]) / len(recb["any"])
    # traversals: traverse_packed_ref over BOUND_SAMPLE rays of each
    # recorded launch, and over every 512th path of the fused BVH launches
    # (1,048,576 paths, hash and Halton)
    work_c = [traversal_work(mesh_main, o, d) for o, d in rec["closest"]]
    work_a = [traversal_work(mesh_main, o, d, "any", tm) for o, d, tm in rec["any"]]
    fb_pick = torch.arange(0, n_pass, n_pass // BOUND_SAMPLE, device=dev)
    bhits, bslabs, btests = (sum(x) for x in bvh_fused_work(
        MK, mesh_main, cfg_fkw, *(x[fb_pick] for x in (fpx, fpy, fsample, fo, fd))))
    bh_work = bvh_fused_work(MK, mesh_main, cfg_hplain,
                             *(x[fb_pick] for x in sorted_rays["halton"]))
    bhh, bhslabs, bhtests = (sum(x) for x in bh_work)
    # kernel 6: the work per depth of BOUND_SAMPLE paths of the pass, drawn
    # with a fixed seed, scaled to its 1,048,576
    pick = torch.as_tensor(np.random.default_rng(0).choice(n_pass, BOUND_SAMPLE, replace=False),
                           device=dev)
    k6_work = bvh_fused_work(MK, mesh_main, cfg_plain, *(x[pick] for x in sorted_rays["hash"]))

    # where the main paths' time goes: one traced render of each (the
    # profiler slows the host, so the wall times that count are the
    # untraced ones above)
    tr_fused = traced_render(lambda: MK.render(main_scene, W, H, spp=SPP_TRACE), SPP_TRACE,
                             {"fused": kernel_names["fused"]})
    tr_off = traced_render(lambda: MK.render(main_scene, W, H, spp=1, cfg=cfg_off), 1,
                           {k: kernel_names[k] for k in ("closest", "anyhit")})
    tr_moff = traced_render(lambda: MK.render(mesh_main, W, H, cfg=cfg_moff, **mesh_kw),
                            MESH_SPP, {k: kernel_names[k] for k in ("bvh_closest", "bvh_anyhit")})
    tr_mon = traced_render(lambda: MK.render(mesh_main, W, H, cfg=cfg_mon, **mesh_kw),
                           MESH_SPP, {"fused_bvh": kernel_names["fused_bvh"]})
    tr_sorted = traced_render(
        lambda: MKC.trace_paths_fused_sorted(mesh_main, *sorted_rays["hash"], max_depth=DEPTH),
        MESH_SPP, {"bounce": kernel_names["bounce"]})
    tr_var = {key: tr_moff if key == ("on", "morton") else traced_render(
        lambda c=c: MK.render(mesh_main, W, H, cfg=c, **mesh_kw), MESH_SPP,
        {k: kernel_names[k] for k in ("bvh_closest", "bvh_anyhit")})
        for key, c in variants.items()}
    for c, v in saved.items():  # timing launches are not main-path launches
        c.launches = v

    flops_fused = tests * MT_FLOPS + hits * SHADE_FLOPS
    # bytes: o, d in (24), px, py, sample^seed in (12), radiance out (12)
    b_fused = bound(flops_fused, n1 * (24 + 12 + 12))
    # bytes: o, d in (24); t (4) + index (4) out, or t_max in (4) + flag out (4)
    b_closest = bound(n1 * n_tris * MT_FLOPS, n1 * 32)
    b_any = bound(any_tests * MT_FLOPS, n1 * 32)
    # the BVH kernels read their tables once, as much of them as a
    # traversal needs: per node the 48 slab floats, 8 slot words and 8
    # permcodes (256 B; the rest of the (M, 128) box is padding), per real
    # triangle (pad rows never hit) v0, e0 and e1 (36 B); the fused kernels
    # also the 4 B material id and the shading tables
    n_real = int((mesh_main.bvh.perm >= 0).sum())
    bvh_bytes = mesh_main.bvh.num_nodes * 256 + n_real * 36
    b_bvh_closest = bound(sum(w[0] for w in work_c) / len(work_c), n_bvh * 32 + bvh_bytes)
    b_bvh_any = bound(sum(w[0] for w in work_a) / len(work_a), n_bvh * 32 + bvh_bytes)
    b_fused_h = bound(htests * MT_FLOPS + hhits * SHADE_FLOPS, n1 * (24 + 12 + 12), hint)
    scale = n_pass / len(fb_pick)
    cbvh_bytes = bvh_bytes + n_real * 4 + mesh_main.shade_tables.numel() * 4
    flops_fbvh = scale * (bslabs * SLAB_FLOPS + btests * MT_FLOPS + bhits * SHADE_FLOPS)
    b_fused_bvh = bound(flops_fbvh, n_pass * 48 + cbvh_bytes)
    flops_fbvh_h = scale * (bhslabs * SLAB_FLOPS + bhtests * MT_FLOPS + bhh * SHADE_FLOPS)
    hint_bvh = scale * bh_work[0][0] * halton_int_ops(R, h0_dims)
    b_fused_bvh_h = bound(flops_fbvh_h, n_pass * 48 + cbvh_bytes, hint_bvh)
    # kernel 6 per depth: live paths read 20 words of their row and write 17
    # and a key, dead paths read their flag and write a key, each reads its
    # row index after depth 0; the tables once
    k6_scale = n_pass / BOUND_SAMPLE
    k6_b = [live * K6_BYTES_LIVE + (n_pass - live) * K6_BYTES_DEAD
            + (n_pass * K6_BYTES_PERM if dep else 0) + cbvh_bytes
            for dep, live in enumerate(k6_live)]
    k6_bounds = [bound(k6_scale * (sl * SLAB_FLOPS + te * MT_FLOPS + hi * SHADE_FLOPS), b)
                 for hi, sl, te, b in zip(*k6_work, k6_b)]
    k6_flops = sum(k6_scale * (sl * SLAB_FLOPS + te * MT_FLOPS + hi * SHADE_FLOPS)
                   for hi, sl, te in zip(*k6_work))
    k6_bytes = sum(k6_b)
    b_bounce = (sum(b[0] for b in k6_bounds) / DEPTH, bound(k6_flops, k6_bytes)[1])

    launches_main = {
        "fused": launches_on["trace_paths_fused"],
        "closest": launches_off["closest_bruteforce"],
        "anyhit": launches_off["anyhit_bruteforce"],
        "bvh_closest": launches_moff["bvh_closest_raw"],
        "bvh_anyhit": launches_moff["bvh_any_raw"],
        "fused_bvh": launches_mon["trace_paths_fused"],
        "fused_halton": launches_h["box", "on"]["trace_paths_fused"],
        "fused_bvh_halton": launches_mhal["trace_paths_fused"],
        "bounce": launches_sorted["hash"]["bounce_fused"] + launches_sorted["halton"]["bounce_fused"],
    }
    spp_of = {"fused": SPP_FUSED, "closest": SPP_OFF, "anyhit": SPP_OFF,
              "bvh_closest": MESH_SPP, "bvh_anyhit": MESH_SPP, "fused_bvh": MESH_SPP,
              "fused_halton": SPP_FUSED, "fused_bvh_halton": MESH_SPP, "bounce": 2 * MESH_SPP}
    rays_of = {"fused": n1, "closest": n1, "anyhit": n1, "bvh_closest": n_bvh,
               "bvh_anyhit": n_bvh, "fused_bvh": n_pass, "fused_halton": n1,
               "fused_bvh_halton": n_pass, "bounce": n_pass}
    plain_rays = dict(rays_of, fused_bvh=n1, fused_bvh_halton=n1)
    csrc = "cuda_optix_pathtracing_tpu_torch/csrc/"
    meta = {
        "fused": ("pt_fused_bruteforce", csrc + "megakernel.cu",
                  "cuda_optix_pathtracing_tpu/models/megakernel_pallas.py:498", b_fused),
        "closest": ("closest_bruteforce", csrc + "intersect.cu",
                    "cuda_optix_pathtracing_tpu/ops/intersect_pallas.py:39", b_closest),
        "anyhit": ("anyhit_bruteforce", csrc + "intersect.cu",
                   "cuda_optix_pathtracing_tpu/ops/intersect_pallas.py:84", b_any),
        "bvh_closest": ("bvh_closest", csrc + "bvh.cu",
                        "cuda_optix_pathtracing_tpu/ops/bvh_pallas.py:489", b_bvh_closest),
        "bvh_anyhit": ("bvh_anyhit", csrc + "bvh.cu",
                       "cuda_optix_pathtracing_tpu/ops/bvh_pallas.py:489", b_bvh_any),
        "fused_bvh": ("pt_fused_bvh", csrc + "megakernel.cu",
                      "cuda_optix_pathtracing_tpu/models/megakernel_pallas.py:1552", b_fused_bvh),
        "fused_halton": ("pt_fused_bruteforce (halton)", csrc + "megakernel.cu",
                         "cuda_optix_pathtracing_tpu/models/megakernel_pallas.py:309", b_fused_h),
        "fused_bvh_halton": ("pt_fused_bvh (halton)", csrc + "megakernel.cu",
                             "cuda_optix_pathtracing_tpu/models/megakernel_pallas.py:309",
                             b_fused_bvh_h),
        "bounce": ("pt_bounce_bvh", csrc + "megakernel.cu",
                   "cuda_optix_pathtracing_tpu/models/megakernel_pallas.py:1725", b_bounce),
    }
    kernels = []
    for key, (name, src, repl, (bms, bby)) in meta.items():
        per_spp = launches_main[key] / spp_of[key]
        print(f"  {name}: {ms[key]:.4f} ms/launch on the device at {rays_of[key]} rays "
              f"({call_ms[key]:.4f} ms per wrapper call), plain {plain_ms[key]:.4f} ms at "
              f"{plain_rays[key]}, "
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
    print(f"  fused Halton kernel work: {hhits} hits shaded ({hhits0} at depth 0), {htests} "
          f"tests ({(htests * MT_FLOPS + hhits * SHADE_FLOPS) / n1:.0f} flop/path), Halton dims "
          f"{h0_dims} at depth 0: {hint / n1:.0f} integer operations/path; BVH mode "
          f"{flops_fbvh_h / n_pass:.0f} flop and {hint_bvh / n_pass:.0f} integer operations/path")
    print(f"  launch floor: an empty kernel of {FLOOR_THREADS} threads {floor_ms:.5f} ms on the "
          f"device; closest_bruteforce {ms['closest']:.5f} ms per launch (bound "
          f"{b_closest[0]:.5f}), anyhit_bruteforce {ms['anyhit']:.5f} (bound {b_any[0]:.5f}), "
          f"means over the {len(recb['closest'])} + {len(recb['any'])} recorded launches {tag}")
    print(f"  pt_fused_bruteforce (hash) at {n_fill} paths (16 spp in one launch): "
          f"{ms_fill:.4f} ms per launch, {1e6 * ms_fill / n_fill:.3f} ns per path, against "
          f"{ms['fused']:.4f} ms and {1e6 * ms['fused'] / n1:.3f} ns per path at {n1} {tag}")
    print(f"  ms per launch, Halton against hash: brute force at {n1} paths "
          f"{ms['fused_halton']:.4f} vs {ms['fused']:.4f}, BVH at {n_pass} "
          f"{ms['fused_bvh_halton']:.4f} vs {ms['fused_bvh']:.4f} {tag}")
    print(f"  paths of the pass: {float(bounces.float().mean()):.3f} bounces each of {DEPTH}; "
          f"warps of one path per thread would keep {100 * lane_busy:.1f} % of their "
          f"lane-bounces busy (regeneration: at most {1 / lane_busy:.3f}x)")
    n_sorts = len(k6_keys)
    print(f"  the sort between depths, per op on the device (mean per sort of {n_pass} int32 "
          f"keys over the {n_sorts} sorts of a pass, 5 each): " + "; ".join(
              f"{key[:70]} x{cnt / (5 * n_sorts):g} {t / (5 * n_sorts):.4f} ms"
              for key, (cnt, t) in sorted(sort_ops.items(), key=lambda kv: -kv[1][1])) + f" {tag}")
    for dep in range(DEPTH):
        hi, sl, te = (w[dep] for w in k6_work)
        sort_txt = f"; sort before it {sort_ms[dep - 1]:.4f} ms" if dep else ""
        print(f"  pt_bounce_bvh depth {dep}: {k6_ms[dep]:.4f} ms on the device, {k6_live[dep]} of "
              f"{n_pass} paths live, bound {k6_bounds[dep][0]:.4f} ms ({k6_bounds[dep][1]}); "
              f"per sampled path {hi / BOUND_SAMPLE:.3f} hits, "
              f"{sl / BOUND_SAMPLE:.1f} boxes, {te / BOUND_SAMPLE:.1f} triangles{sort_txt} {tag}")
    print(f"  pt_bounce_bvh per pass: {sum(k6_ms):.4f} ms (Halton depth 0: {k6_halton0_ms:.4f} "
          f"ms); sorts {sum(sort_ms):.4f} ms; pt_fused_bvh per launch of {n_pass}: "
          f"{ms['fused_bvh']:.4f} ms (Halton {ms['fused_bvh_halton']:.4f}) {tag}")
    busy_s, per_k_s, n_launch_s, _, _ = tr_sorted
    wall_s = 1e3 / (np.mean(route_rep["sorted"]) * 1e6 / (W * H))
    print(f"  routes on the same {n_pass} rays, in turns: sorted "
          f"{', '.join(f'{m:.3f}' for m in route_rep['sorted'])}, fused "
          f"{', '.join(f'{m:.3f}' for m in route_rep['fused'])} Mpaths/s (host clock, "
          f"sync); sorted / fused {np.mean(route_rep['sorted']) / np.mean(route_rep['fused']):.3f} "
          f"{tag}")
    print(f"  traced sorted route, per spp: {wall_s:.3f} ms untraced wall, device busy "
          f"{busy_s * 1e3:.3f} ms ({100 * busy_s * 1e3 / wall_s:.1f} %), kernel 6 "
          f"{per_k_s['bounce'][0]} launches {per_k_s['bounce'][1] * 1e3:.3f} ms in the pass, "
          f"{n_launch_s:.1f} kernel launches per spp {tag}")
    for label, work in (("closest", work_c), ("any-hit", work_a)):
        print(f"  bvh {label} work per depth (sample of {BOUND_SAMPLE} rays of {n_bvh}): "
              + "; ".join(f"{w[1]:.1f} boxes, {w[2]:.1f} triangles, "
                          f"{w[0] / n_bvh:.0f} flop per ray" for w in work))
    k = len(fb_pick)
    print(f"  fused BVH kernel work (every {n_pass // k}th of its {n_pass}-path launch, {k}): "
          f"{bhits / k:.2f} hits, {bslabs / k:.1f} boxes, {btests / k:.1f} triangles per path "
          f"({flops_fbvh / n_pass:.0f} flop/path)")
    print(f"  render fused {W}x{H}x{SPP_FUSED} depth {DEPTH}: {dt_on:.3f} s, "
          f"{mpaths:.2f} Mpaths/s (host clock around render()); "
          f"{RENDER_REPEATS} more renders: "
          f"{', '.join(f'{m:.2f}' for m in mpaths_rep)} Mpaths/s {tag}")
    print(f"  render fused='off' {W}x{H}x{SPP_OFF} depth {DEPTH}: "
          f"{', '.join(f'{m:.3f}' for m in off_rep)} Mpaths/s {tag}")
    for route, reps in mesh_rep.items():
        print(f"  render mesh fused='{route}' {W}x{H}x{MESH_SPP} (one pass) depth {DEPTH}: "
              f"{mesh_first[route]:.3f} Mpaths/s in phase 3 (first render), then "
              f"{', '.join(f'{m:.3f}' for m in reps)} in turns {tag}")
    mean_on, mean_off = np.mean(mesh_rep["on"]), np.mean(mesh_rep["off"])
    print(f"  mesh routes: fused='on' {mean_on:.3f}, fused='off' {mean_off:.3f} Mpaths/s "
          f"(means); faster: {'on' if mean_on > mean_off else 'off'}; auto takes "
          f"{MK.resolve_fused(mesh_main, MK.MegakernelConfig()).fused} {tag}")
    for (srt, order), reps in var_rep.items():
        busy, per_k, n_launch, _, _ = tr_var[(srt, order)]
        k4 = sum(t for _, t in per_k.values()) * 1e3
        print(f"  mesh fused='off', sort_rays='{srt}', pixel_order='{order}': "
              f"{', '.join(f'{m:.3f}' for m in reps)} Mpaths/s in turns; traced: kernel 4 "
              f"{k4:.3f} ms per pass ({per_k['bvh_closest'][1] * 1e3:.3f} closest, "
              f"{per_k['bvh_anyhit'][1] * 1e3:.3f} any-hit), device busy {busy * 1e3:.3f} ms "
              f"and {n_launch:.1f} kernel launches per spp {tag}")
    walls = {"fused": dt_on * 1e3 / SPP_FUSED,
             "off": 1e3 / (np.mean(off_rep) * 1e6 / (W * H)),
             "mesh off": 1e3 / (np.mean(mesh_rep["off"]) * 1e6 / (W * H)),
             "mesh on": 1e3 / (np.mean(mesh_rep["on"]) * 1e6 / (W * H))}
    for label, (busy, per_k, n_launch, n_sync, wall_tr) in (
        ("fused", tr_fused), ("off", tr_off), ("mesh off", tr_moff), ("mesh on", tr_mon)
    ):
        ks = ", ".join(f"{name} {n} launches {t * 1e3:.3f} ms" for name, (n, t) in per_k.items())
        print(f"  traced render {label}, per spp: {walls[label]:.3f} ms untraced wall, "
              f"device busy {busy * 1e3:.3f} ms ({100 * busy * 1e3 / walls[label]:.1f} % of "
              f"the untraced wall); kernels in the whole render: {ks}; "
              f"{n_launch:.1f} kernel launches, {n_sync:.1f} stream syncs; "
              f"traced wall {wall_tr * 1e3:.3f} ms {tag}")
    gradients_phase(MK, zero, read, tag, kernel_names)
    scene_files_phase(MK, zero, read, tag, kernel_names)
    lights_instancing_phase(MK, zero, read, tag, kernel_names)
    parallel_wavefront_phase(MK, zero, read, tag)
    print(f"  chip_smoke total: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # phase 8 starts this script again as its worker processes
    if sys.argv[1:2] == ["--phase8-rank"]:
        sys.exit(phase8_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--phase8-cli"]:
        sys.exit(phase8_cli(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

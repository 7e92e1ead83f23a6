#!/usr/bin/env python3
"""Time the port's redesigned kernels in two or more checkouts on one
NVIDIA GPU, in turns, and show whether their outputs agree bit for bit.

    python3 chip_compare.py [--only GROUPS] [--rounds N] DIR_A DIR_B [DIR_C ...]

Each DIR is the root of a checkout (for example a ``git archive`` of the
parent commit and this tree, or copies of this tree with one design
choice undone). The turns run every checkout twice, mirrored (A, B, B, A
for two; A, B, C, C, B, A for three), each turn a process of its own run
from that checkout, so it imports that checkout's package and builds that
checkout's kernels (all checkouts' kernels are built first, at once).
``--rounds N`` runs the mirrored order N times (default 1), which gives
2N pairs of each checkout with the first, alternating which runs first.
``--only`` takes a comma-separated subset of the groups (default: all):

- ``k1``, the brute-force fused kernel (kernels 1 and 1h): the Cornell
  box at 256², one spp (65,536 camera paths, the main path's launch),
  depth 5: device time per launch (``torch.profiler``), hash and Halton,
  and a SHA-256 digest of each one's radiance;
- ``k23``, the brute-force closest-hit and any-hit kernels (kernels 2
  and 3): every launch of one ``fused="off"`` render of the Cornell box
  at 256², 8 spp, depth 5 (40 + 40 launches of 65,536 rays), recorded
  (``chip_smoke.record_brute_launches``) and replayed with the arguments
  the integrator gave: device time per launch, digests of the (t, index)
  and the flags of all launches, and of the render's film; and, from a
  traced render of one spp, the route's kernel launches on the host and
  device-busy time per spp;
- ``k4``, the traversal kernels (kernel 4): every closest-hit and any-hit
  launch of one ``fused="off"`` render of the mesh leg (below), recorded
  (``chip_smoke.record_bvh_launches``) and replayed: device time per
  launch, digests of the (t, row) and the flags of all launches, and of
  the render's film;
- ``k56``, the BVH path-tracing kernels (kernels 5 and 6) on the mesh
  Cornell box of ``bench.py``'s second leg (subdivision 64, 256², 16 spp
  as one pass of 1,048,576 camera rays in Morton order, depth 5): the
  fused kernel per launch, hash and Halton, and hash at ``max_depth=1``;
  the depth-sorted route's single-bounce kernel per pass and the rest of
  the route (sorts, state packing and reading); the host-clock Mpaths/s
  of the sorted and the fused route in turns and of the mesh render with
  ``fused="on"``; digests of each route's radiance.

A process prints one JSON line; this script prints each turn's line,
the means by checkout, for each timing of each checkout after the first
its median and quartiles beside the first's and the pairs in which it
was lower, and, for each digest, whether it is equal in all turns. It needs one card and prints its name and power limit first. The
camera rays and the profiler timing are ``chip_smoke.py``'s
(``camera_rays``, ``kernel_ms``, ``profiled``), from the directory of
this script.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import chip_smoke as S

SPP = 16
DEPTH = 5
GROUPS = ("k1", "k23", "k4", "k56")


def package():
    """(MK, MKC, cornell_box, cornell_box_mesh) of the current directory's
    checkout."""
    sys.path.insert(0, os.getcwd())
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh

    return MK, MKC, cornell_box, cornell_box_mesh


def digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure_k1(out: dict) -> None:
    import torch

    MK, MKC, cornell_box, _ = package()
    scene = cornell_box(S.W, S.H, device=torch.device("cuda"))
    for smp, policy in (("hash", "HashRng>"), ("halton", "HaltonRng>")):
        rays = S.camera_rays(scene, 1, sampler=smp)

        def run():
            return MKC.trace_paths_fused(scene, *rays, max_depth=DEPTH, sampler=smp)

        out[f"digest_k1_{smp}"] = digest(run())
        out[f"k1_{smp}"] = S.kernel_ms(run, 20, ("::pt_fused_kernel<", "BruteGeo", policy))


def measure_k23(out: dict) -> None:
    import torch

    MK, _, cornell_box, _ = package()
    scene = cornell_box(S.W, S.H, device=torch.device("cuda"))
    tris = scene.tri_v0, scene.tri_e0, scene.tri_e1
    film = {}

    def render():
        film["off"] = MK.render(scene, S.W, S.H, spp=S.SPP_OFF,
                                cfg=MK.MegakernelConfig(fused="off"))

    rec = S.record_brute_launches(MK, render)
    IC = MK.intersect_cuda
    out["digest_k23_film_off"] = digest(film["off"].mean)
    closest = [IC.closest_bruteforce(o, d, *tris, **kw) for (o, d), kw in rec["closest"]]
    anyhit = [IC.anyhit_bruteforce(o, d, *tris, tm, **kw) for (o, d, tm), kw in rec["any"]]
    out["digest_k23_closest"] = digest(*(x for pair in closest for x in pair))
    out["digest_k23_any"] = digest(*anyhit)

    def replay_closest():
        for (o, d), kw in rec["closest"]:
            IC.closest_bruteforce(o, d, *tris, **kw)

    def replay_any():
        for (o, d, tm), kw in rec["any"]:
            IC.anyhit_bruteforce(o, d, *tris, tm, **kw)

    out["k2_closest"] = S.kernel_ms(replay_closest, 4, "::closest_kernel(",
                                    per_call=len(rec["closest"]))
    out["k3_any"] = S.kernel_ms(replay_any, 4, "::anyhit_kernel(", per_call=len(rec["any"]))
    busy, _, n_launch, _, _ = S.traced_render(
        lambda: MK.render(scene, S.W, S.H, spp=1, cfg=MK.MegakernelConfig(fused="off")), 1, {})
    out["k23_off_host_launches_per_spp"] = n_launch
    out["k23_off_device_busy_ms_per_spp"] = busy * 1e3


def measure_k4(out: dict) -> None:
    import torch

    MK, MKC, _, cornell_box_mesh = package()
    mesh = cornell_box_mesh(S.W, S.H, subdiv=S.MESH_SUBDIV, device=torch.device("cuda"))
    cfg = MK.MegakernelConfig(fused="off")
    film = {}

    def render():
        film["off"] = MK.render(mesh, S.W, S.H, cfg=cfg, spp=SPP, kspp=SPP, spp_per_pass=SPP)

    rec = S.record_bvh_launches(MK, render)
    BV = MK.bvh_cuda
    out["digest_k4_film_off"] = digest(film["off"].mean)
    closest = [BV.bvh_closest_raw(o, d, mesh) for o, d in rec["closest"]]
    anyhit = [BV.bvh_any_raw(o, d, mesh, tm) for o, d, tm in rec["any"]]
    out["digest_k4_closest"] = digest(*(x for pair in closest for x in pair))
    out["digest_k4_any"] = digest(*anyhit)

    def replay_closest():
        for o, d in rec["closest"]:
            BV.bvh_closest_raw(o, d, mesh)

    def replay_any():
        for o, d, tm in rec["any"]:
            BV.bvh_any_raw(o, d, mesh, tm)

    out["k4_closest"] = S.kernel_ms(replay_closest, 4, "::bvh_closest_kernel(",
                                    per_call=len(rec["closest"]))
    out["k4_any"] = S.kernel_ms(replay_any, 4, "::bvh_anyhit_kernel(", per_call=len(rec["any"]))


def measure_k56(out: dict) -> None:
    import torch

    MK, MKC, _, cornell_box_mesh = package()
    mesh = cornell_box_mesh(S.W, S.H, subdiv=S.MESH_SUBDIV, device=torch.device("cuda"))
    hash_rays, halton_rays = (S.camera_rays(mesh, SPP, morton=True, sampler=smp)
                              for smp in ("hash", "halton"))
    out.update(
        digest_fused_hash=digest(MKC.trace_paths_fused(mesh, *hash_rays, max_depth=DEPTH)),
        digest_fused_halton=digest(MKC.trace_paths_fused(mesh, *halton_rays, max_depth=DEPTH,
                                                         sampler="halton")),
        digest_sorted_hash=digest(MKC.trace_paths_fused_sorted(mesh, *hash_rays,
                                                               max_depth=DEPTH)),
    )
    for label, smp, r, depth in (("k5_hash", "HashRng", hash_rays, DEPTH),
                                 ("k5_halton", "HaltonRng", halton_rays, DEPTH),
                                 ("k5_hash_depth1", "HashRng", hash_rays, 1)):
        sampler = "halton" if smp == "HaltonRng" else "hash"
        out[label] = S.kernel_ms(
            lambda: MKC.trace_paths_fused(mesh, *r, max_depth=depth, sampler=sampler), 10,
            ("::pt_fused_bvh_kernel<", smp + ">"))

    def sorted_route():
        MKC.trace_paths_fused_sorted(mesh, *hash_rays, max_depth=DEPTH)

    out["k6_pass"] = DEPTH * S.kernel_ms(sorted_route, 5, "::pt_bounce_kernel<", per_call=DEPTH)
    _, rows = S.profiled(lambda: [sorted_route() for _ in range(5)])
    total = sum(e.self_device_time_total for e in S.device_rows(rows)) / 1e3 / 5
    out["sorted_rest"] = total - out["k6_pass"]
    n = S.W * S.H * SPP
    out["sorted_mpaths"], out["fused_mpaths"] = [], []
    for key in ("sorted_mpaths", "fused_mpaths", "fused_mpaths", "sorted_mpaths"):
        fn = MKC.trace_paths_fused_sorted if key == "sorted_mpaths" else MKC.trace_paths_fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(mesh, *hash_rays, max_depth=DEPTH)
        torch.cuda.synchronize()
        out[key].append(n / (time.perf_counter() - t0) / 1e6)
    cfg = MK.MegakernelConfig(fused="on")
    MK.render(mesh, S.W, S.H, cfg=cfg, spp=SPP, kspp=SPP, spp_per_pass=SPP)
    out["render_on_mpaths"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MK.render(mesh, S.W, S.H, cfg=cfg, spp=SPP, kspp=SPP, spp_per_pass=SPP)
        torch.cuda.synchronize()
        out["render_on_mpaths"].append(n / (time.perf_counter() - t0) / 1e6)


def measure(groups) -> dict:
    """One turn, run from the root of the checkout to measure."""
    import torch

    out = {"kind": torch.cuda.get_device_name(0)}
    for g in groups:
        {"k1": measure_k1, "k23": measure_k23, "k4": measure_k4, "k56": measure_k56}[g](out)
    return out


def build(root: str) -> subprocess.Popen:
    """Start building every CUDA source of the checkout at ``root``."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from cuda_optix_pathtracing_tpu_torch.ops import _cuda_build as B; "
            "B.build_all(sorted(p.stem for p in B.CSRC.glob('*.cu')))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--measure":
        os.chdir(argv[1])
        print(json.dumps(measure(argv[2].split(","))))
        return 0
    groups, rounds = list(GROUPS), 1
    while len(argv) > 1 and argv[0] in ("--only", "--rounds"):
        if argv[0] == "--only":
            groups = argv[1].split(",")
        else:
            rounds = int(argv[1])
        argv = argv[2:]
    if len(argv) < 2 or not set(groups) <= set(GROUPS):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    print(S.card_line())
    dirs = [os.path.abspath(a) for a in argv]
    t0 = time.perf_counter()
    for root, proc in [(root, build(root)) for root in dirs]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"build failed in {root}:\n{log[-4000:]}", file=sys.stderr)
            return 1
    print(f"built the kernels of {len(dirs)} checkouts at once in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {root: [] for root in dirs}
    for root in (dirs + dirs[::-1]) * rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                               ",".join(groups)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(root, line)
        runs[root].append(json.loads(line))
    for root, rs in runs.items():
        means = {}
        for key, val in rs[0].items():
            if isinstance(val, (int, float)):
                means[key] = sum(r[key] for r in rs) / len(rs)
            elif isinstance(val, list):
                means[key] = sum(sum(r[key]) / len(r[key]) for r in rs) / len(rs)
        print(f"mean {root}: {json.dumps(means)}")
    base = runs[dirs[0]]
    for root in dirs[1:]:
        for key, val in base[0].items():
            if not isinstance(val, float) or len(base) < 2:
                continue
            a, b = [r[key] for r in base], [r[key] for r in runs[root]]
            qa, qb = statistics.quantiles(a, n=4), statistics.quantiles(b, n=4)
            lower = sum(y < x for x, y in zip(a, b))
            print(f"pairs {key}: {root} median {statistics.median(b):.6f} "
                  f"[{qb[0]:.6f}, {qb[2]:.6f}] against {statistics.median(a):.6f} "
                  f"[{qa[0]:.6f}, {qa[2]:.6f}], lower in {lower} of {len(a)} pairs")
    every = [r for rs in runs.values() for r in rs]
    for key in sorted(k for k in every[0] if k.startswith("digest_")):
        print(f"{key}: {'equal' if len({r[key] for r in every}) == 1 else 'differ'} in all turns")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

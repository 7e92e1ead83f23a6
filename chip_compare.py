#!/usr/bin/env python3
"""Time the BVH path-tracing kernels of two checkouts of the port on one
NVIDIA GPU, in turns.

    python3 chip_compare.py OLD_DIR NEW_DIR

OLD_DIR and NEW_DIR are roots of two checkouts (for example a ``git
archive`` of the parent commit and this tree). Each turn (old, new, new,
old) is a process of its own, run from that checkout so it imports that
checkout's package and builds that checkout's kernels. On the mesh
Cornell box of ``bench.py``'s second leg (subdivision 64, 256², 16 spp as
one pass of 1,048,576 camera rays in Morton order, depth 5) a turn
measures:

- the fused BVH kernel's device time per 1,048,576-path launch
  (``torch.profiler``), hash and Halton, and hash at ``max_depth=1``,
  where every path makes exactly one bounce and no lane of a warp waits
  for another path;
- the depth-sorted route ``trace_paths_fused_sorted`` under the profiler:
  the single-bounce kernel's device time per pass and that of everything
  else (the sorts between depths, state packing and reading);
- the host-clock Mpaths/s of the sorted and the fused route on the same
  rays, in turns, and of the mesh render with ``fused="on"`` after one
  untimed render;
- a SHA-256 digest of each route's radiance (fused hash and Halton,
  sorted hash), so that the turns show whether the two checkouts give
  the same output bit for bit.

A process prints one JSON line; this script prints each turn's line,
the means by checkout and whether the digests agree across turns. It
needs one card and prints its name and power limit first. The camera
rays and the profiler timing are ``chip_smoke.py``'s (``camera_rays``,
``kernel_ms``, ``profiled``), from the directory of this script.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import chip_smoke as S

SPP = 16
DEPTH = 5


def mesh_leg():
    """(MK, MKC, the mesh Cornell box at subdivision 64, its hash and
    Halton camera rays): the package of the current directory's checkout."""
    import torch

    sys.path.insert(0, os.getcwd())
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models import megakernel_cuda as MKC
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh

    mesh = cornell_box_mesh(S.W, S.H, subdiv=S.MESH_SUBDIV, device=torch.device("cuda"))
    rays = {smp: S.camera_rays(mesh, SPP, morton=True, sampler=smp) for smp in ("hash", "halton")}
    return MK, MKC, mesh, rays["hash"], rays["halton"]


def measure() -> dict:
    """One turn, run from the root of the checkout to measure."""
    import torch

    MK, MKC, mesh, hash_rays, halton_rays = mesh_leg()
    # the fused BVH kernel's name, before and after it got its own body
    src = os.path.join("cuda_optix_pathtracing_tpu_torch", "csrc", "megakernel.cu")
    with open(src) as f:
        fused_name = "::pt_fused_bvh_kernel<" if "pt_fused_bvh_kernel" in f.read() else "BvhGeo,"

    def digest(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    out = {"kind": torch.cuda.get_device_name(0),
           "digest_fused_hash": digest(MKC.trace_paths_fused(mesh, *hash_rays, max_depth=DEPTH)),
           "digest_fused_halton": digest(MKC.trace_paths_fused(mesh, *halton_rays,
                                                               max_depth=DEPTH, sampler="halton")),
           "digest_sorted_hash": digest(MKC.trace_paths_fused_sorted(mesh, *hash_rays,
                                                                     max_depth=DEPTH))}
    for label, smp, r, depth in (("k5_hash", "HashRng", hash_rays, DEPTH),
                                 ("k5_halton", "HaltonRng", halton_rays, DEPTH),
                                 ("k5_hash_depth1", "HashRng", hash_rays, 1)):
        sampler = "halton" if smp == "HaltonRng" else "hash"
        out[label] = S.kernel_ms(
            lambda: MKC.trace_paths_fused(mesh, *r, max_depth=depth, sampler=sampler), 10,
            (fused_name, smp + ">"))

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
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--measure":
        os.chdir(argv[1])
        print(json.dumps(measure()))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    print(S.card_line())
    dirs = {"old": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])}
    runs = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", dirs[which]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(which, line)
        runs[which].append(json.loads(line))
    for which, rs in runs.items():
        means = {}
        for key, val in rs[0].items():
            if isinstance(val, (int, float)):
                means[key] = sum(r[key] for r in rs) / len(rs)
            elif isinstance(val, list):
                means[key] = sum(sum(r[key]) / len(r[key]) for r in rs) / len(rs)
        print(f"mean {which}: {json.dumps(means)}")
    every = runs["old"] + runs["new"]
    for key in sorted(k for k in every[0] if k.startswith("digest_")):
        print(f"{key}: {'equal' if len({r[key] for r in every}) == 1 else 'differ'} in all turns")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Driver entry points of the port: a one-device forward step and a dry run
of the sharded render and training step over several ranks.

    python -m cuda_optix_pathtracing_tpu_torch.entry 2               # 2 ranks, cuda
    python -m cuda_optix_pathtracing_tpu_torch.entry 2 --device cpu  # 2 ranks, gloo

On ``cuda`` the ranks take NCCL when each has a card of its own and gloo
when they share one (``parallel.distributed.choose_backend``).
"""

from __future__ import annotations

import os
import socket
import sys
import time

import torch

from ._device import resolve_device

DRYRUN_TIMEOUT_S = 600


def entry(device="cuda"):
    """(fn, example_args): one path-traced sample batch of a 64² Cornell box
    at depth 3 (``render_sample_batch``), on ``device``."""
    from .models.megakernel import MegakernelConfig, render_sample_batch
    from .scene import cornell_box

    width = height = 64
    scene = cornell_box(width, height, device=resolve_device(device))
    cfg = MegakernelConfig(max_depth=3, remat=False)

    def fn(scene, sample):
        return render_sample_batch(scene, cfg, width, height, sample)

    return fn, (scene, 0)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, n: int, port: int, device: str, results) -> None:
    """One rank of ``dryrun_multidevice`` (a spawned process)."""
    import torch.distributed as dist

    from .models.differentiable import init_params, inject_params
    from .models.megakernel import MegakernelConfig
    from .parallel.distributed import init_distributed, render_multihost
    from .parallel.render import make_mesh, train_step_sharded
    from .scene import cornell_box, cornell_box_mesh

    torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // n)))
    init_distributed(f"localhost:{port}", n, rank, device=device)
    try:
        dev = resolve_device(device)
        # the sharded render through the BVH kernels: 64², depth 4, 2 spp
        width = height = 64
        scene_bvh = cornell_box_mesh(width, height, subdiv=8, use_bvh=True, device=dev)
        film = render_multihost(scene_bvh, MegakernelConfig(max_depth=4, remat=False),
                                width, height, 2, device=dev)
        if not bool(torch.isfinite(film.mean).all()):
            raise FloatingPointError("dry run: non-finite film")
        # one sharded Adam step on the albedos (path replay, smaller shapes)
        width, height = 16, n * 2
        scene = cornell_box(width, height, device=dev)
        params = init_params(scene, ("albedo",))
        opt = torch.optim.Adam(params.values(), lr=1e-2)
        step = train_step_sharded(opt, lambda p: inject_params(scene, p),
                                  MegakernelConfig(max_depth=2, remat=True),
                                  width, height, 1, make_mesh(n), device=dev)
        loss = step(params, torch.zeros((height, width, 3)), 0)
        if rank == 0:
            results.put(float(loss))
    finally:
        dist.destroy_process_group()


def dryrun_multidevice(n: int, device="cuda") -> float:
    """Run the sharded render (the BVH mesh box at subdivision 8, 64²,
    depth 4, 2 spp, film gathered) and one sharded Adam step on the albedos
    over ``n`` ranks, one spawned process each → rank 0's loss. Raises if a
    rank fails or the run outlasts ``DRYRUN_TIMEOUT_S``."""
    import torch.multiprocessing as mp

    resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(_dryrun_rank, args=(n, free_port(), str(device), results),
                               nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"dryrun_multidevice({n}) outlasted {DRYRUN_TIMEOUT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    loss = results.get()
    print(f"dryrun_multidevice({n}): loss={loss:.5f} ok")
    return loss


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="multi-rank dry run of the sharded render and step")
    ap.add_argument("n", type=int, help="number of ranks (processes)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args()
    dryrun_multidevice(a.n, a.device)
    sys.exit(0)

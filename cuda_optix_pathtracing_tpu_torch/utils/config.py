"""Run configuration of the CLI (counterpart of the reference
``utils/config.py``): width/height/spp/kspp, sampler, depth, seed,
device, checkpoint and partial-image dumps, and the multi-process
rendezvous (coordinator, process count, rank)."""

from __future__ import annotations

import argparse
from dataclasses import dataclass


DEFAULT_SPP = 128  # a scene file's sample count replaces this default


@dataclass
class RunConfig:
    scene: str = "cornell"  # "cornell" | "cornell-mesh" | a .json/.pbrt path
    out: str = "out/render.png"
    width: int = 256
    height: int = 256
    spp: int = DEFAULT_SPP
    kspp: int = 8  # samples per progressive batch
    max_depth: int = 5
    sampler: str = "hash"  # "hash" | "halton" (Owen-scrambled Halton)
    seed: int = 0
    device: str = "cuda"  # cuda | cpu
    save_partial: bool = False  # dump mean/MSE images every batch
    log_level: str = "info"
    mesh: int = 0  # shard over N ranks (0 = all); parsed, not read, as in the reference
    checkpoint: str = ""  # resume/persist film state (.npz)
    # multi-process (one process per rank, torch.distributed):
    coordinator: str = ""  # "host:port" of rank 0 ("" = single process, or
    # MASTER_ADDR:MASTER_PORT from torchrun's environment with --num-processes)
    num_processes: int = 0  # total processes (0 = single process, or WORLD_SIZE)
    process_id: int = -1  # this process's rank (-1 = RANK from the environment)


def parse_args(argv=None) -> RunConfig:
    p = argparse.ArgumentParser(
        prog="dtpt-render-torch",
        description="Path tracer, PyTorch + CUDA port",
    )
    d = RunConfig()
    p.add_argument("--scene", default=d.scene,
                   help="'cornell', 'cornell-mesh' or a .json/.pbrt scene file")
    p.add_argument("--out", default=d.out, help="output PNG path")
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--spp", type=int, default=d.spp)
    p.add_argument("--kspp", type=int, default=d.kspp, help="samples per batch")
    p.add_argument("--max-depth", type=int, default=d.max_depth)
    p.add_argument("--sampler", choices=["hash", "halton"], default=d.sampler)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--device", choices=["cuda", "cpu"], default=d.device)
    p.add_argument("--save-partial", action="store_true")
    p.add_argument("--log-level", default=d.log_level,
                   choices=["trace", "debug", "info", "warn", "warning", "error"])
    p.add_argument("--mesh", type=int, default=d.mesh,
                   help="shard pixels over N ranks (0 = all)")
    p.add_argument("--checkpoint", default=d.checkpoint,
                   help="film checkpoint .npz to resume from / save to")
    p.add_argument("--coordinator", default=d.coordinator,
                   help="multi-process: host:port of rank 0")
    p.add_argument("--num-processes", type=int, default=d.num_processes,
                   help="multi-process: total number of processes")
    p.add_argument("--process-id", type=int, default=d.process_id,
                   help="multi-process: this process's rank")
    a = p.parse_args(argv)
    return RunConfig(
        scene=a.scene, out=a.out, width=a.width, height=a.height, spp=a.spp,
        kspp=a.kspp, max_depth=a.max_depth, sampler=a.sampler, seed=a.seed,
        device=a.device, save_partial=a.save_partial, log_level=a.log_level,
        mesh=a.mesh, checkpoint=a.checkpoint, coordinator=a.coordinator,
        num_processes=a.num_processes, process_id=a.process_id,
    )

"""Multi-process entry: ``torch.distributed`` wiring and film assembly
across ranks (counterpart of the reference ``parallel/distributed.py``).

One process per rank, joined through a TCP rendezvous at rank 0's
``host:port``. The backend follows from the arguments, never from a
failed attempt:

- NCCL when the ranks are on CUDA and each has a card of its own (the
  ranks on this host do not outnumber its cards);
- gloo on the CPU;
- gloo when ranks share a card (NCCL refuses two ranks on one device):
  the collectives' CUDA tensors then go through host memory, and the
  render itself stays on the card.

The same ``render_sharded`` runs in every rank; ``gather_film`` then
assembles the film on every rank.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..ops.film import Film
from .render import Mesh, _check_alone, group_on, host_staged, make_mesh, render_sharded

TIMEOUT_S = 600  # every collective and the rendezvous give up after this

log = logging.getLogger("dtpt")


def choose_backend(device, local_world_size: int) -> str:
    """"nccl" for CUDA ranks that each have a card of their own, else
    "gloo" (the CPU, or ranks sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> int:
    """Join the ``torch.distributed`` group and return this process's rank.

    Arguments left out come from ``torchrun``'s environment: the
    coordinator from ``MASTER_ADDR``/``MASTER_PORT``, the process count
    from ``WORLD_SIZE``, the rank from ``RANK``; ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (default: the rank and the process count, all
    processes on this host) place the rank on a card; a lone process is
    rank 0. With no coordinator and at most one process there is no group
    to join: returns 0. A no-op returning the rank when a group is already
    initialised. ``device`` is where the ranks render ("cuda": each rank's
    current card is set)."""
    if group_on():
        return dist.get_rank()
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator (host:port of rank 0)")
        return 0
    if process_id is None and num_processes == 1:
        process_id = 0
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the process count and this process's rank")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} out of range for {num_processes} processes")
    if (env.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
            and coordinator.rsplit(":", 1)[-1] != env.get("MASTER_PORT")):
        # every rank would wait for a store that no rank hosts
        raise ValueError(
            f"under torchrun the rendezvous is torchrun's own store (port "
            f"{env.get('MASTER_PORT')}), not {coordinator}: leave the coordinator out or "
            f"start torchrun with --master-port {coordinator.rsplit(':', 1)[-1]}"
        )
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    dev = resolve_device(device)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=TIMEOUT_S),
    )
    log.info("torch.distributed: %s backend, rank %d of %d (%d on this host), device %s",
             backend, process_id, num_processes, local_world,
             f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else dev)
    return process_id


def global_mesh(axis: str = "rays") -> Mesh:
    """1-D mesh over every rank of the default group."""
    return make_mesh(None, axis)


def gather_film(film: Film, mesh: Mesh | None = None) -> Film:
    """Every rank's block of the film, concatenated in rank order, on every
    rank: one all-gather per field (mean, m2), on the film's device; under
    gloo a CUDA film's blocks go through host memory. Without a group, the
    film itself."""
    mesh = mesh or global_mesh()
    if not group_on():
        _check_alone(mesh)
        return film

    def full(x):
        src = x.contiguous()
        if host_staged(src, mesh.group):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src, group=mesh.group)
        return torch.cat(parts).to(x.device)

    return Film(full(film.mean), full(film.m2), film.n)


def render_multihost(scene, cfg, width, height, spp, axis: str = "rays", device="cuda") -> Film:
    """Render on ``device`` with pixels sharded over every rank of the
    default group; the assembled (H, W, 3) film on every rank."""
    mesh = global_mesh(axis)
    film = gather_film(render_sharded(scene, cfg, width, height, spp, mesh, device), mesh)
    return Film(film.mean.reshape(height, width, 3), film.m2.reshape(height, width, 3), film.n)

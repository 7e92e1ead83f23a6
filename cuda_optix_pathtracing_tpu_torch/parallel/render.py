"""Pixels sharded over the ranks of a ``torch.distributed`` group
(counterpart of the reference ``parallel/render.py``).

The reference shards the flattened pixel list over a 1-D device mesh with
``shard_map``. Here a rank is a process: ``Mesh`` holds the mesh's size,
this process's rank in it and the process group of its collectives. The
scene is replicated on every rank; each rank traces only its contiguous,
equal block of the pixel list (what ``P(axis)`` gives), and the RNG keys
on global pixel ids, so the image does not depend on the rank count. The
forward render needs no collective; an inverse-rendering step averages the
ranks' loss and gradients with one all-reduce.

Rays go through ``trace_paths`` (kernels 2 and 3, or 4 on a BVH scene)
with box-filter jitter in linear pixel order, never through the fused
kernel or the Mitchell filter, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..models.megakernel import MegakernelConfig, _validate, trace_paths
from ..ops import rng as R
from ..ops.camera import generate_rays
from ..ops.film import Film, film_add_sample
from ..scene.types import Scene, scene_to


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks in which this process is ``rank`` (-1:
    not a member); ``group`` is the process group of its collectives (None:
    the default group, or no group at all in a single process)."""

    size: int = 1
    rank: int = 0
    axis: str = "rays"
    group: object = None


def group_on() -> bool:
    """Is a ``torch.distributed`` default group initialised?"""
    return dist.is_available() and dist.is_initialized()


def make_mesh(n: int | None = None, axis: str = "rays") -> Mesh:
    """The 1-D mesh over ranks 0..n-1 of the default group (every rank when
    ``n`` is None). Every rank of the group must call it when ``n`` is
    below the world size (``dist.new_group``); ranks outside the mesh get
    ``rank=-1``. In a process with no group: the mesh of this process."""
    if not group_on():
        if n not in (None, 1):
            raise ValueError(
                f"a mesh of {n} ranks needs a torch.distributed group of at least {n} "
                "processes (parallel.distributed.init_distributed); this process has none"
            )
        return Mesh(1, 0, axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"mesh of {n} ranks in a group of {world}")
    if n == world:
        return Mesh(world, rank, axis)
    return Mesh(n, rank if rank < n else -1, axis, dist.new_group(list(range(n))))


def pixel_block(width: int, height: int, mesh: Mesh) -> tuple[int, int]:
    """[lo, hi) of this rank's block of the flattened pixel list."""
    npix = width * height
    if npix % mesh.size:
        raise ValueError(f"{npix} pixels do not split evenly over {mesh.size} ranks")
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")
    per = npix // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _block_pixels(width: int, height: int, mesh: Mesh, device):
    lo, hi = pixel_block(width, height, mesh)
    ids = torch.arange(lo, hi, dtype=torch.int64, device=device)
    return ids % width, ids // width


def _render_pixels(scene: Scene, cfg: MegakernelConfig, px, py, sample):
    """Radiance (N,3) of one sample of the pixel list (px, py), on the
    scene's device."""
    sampler = R.Sampler(cfg.sampler, cfg.seed)
    jx, jy = sampler.sample_2d(px, py, sample, R.Dim.CAMERA_U)
    p_film = torch.stack([px.to(torch.float32) + jx, py.to(torch.float32) + jy], dim=-1)
    o, d = generate_rays(p_film, scene.cam_from_raster, scene.world_from_cam)
    return trace_paths(scene, cfg, px, py, sample, o, d, device=scene.device)


def render_sharded(scene: Scene, cfg: MegakernelConfig, width: int, height: int, spp: int,
                   mesh: Mesh, device="cuda") -> Film:
    """Render ``spp`` samples of this rank's block of pixels on ``device``
    → Film whose mean and m2 are the block's (width·height / mesh.size, 3)
    rows of the flattened film (``distributed.gather_film`` assembles the
    blocks). One Welford update per sample; no collective. Raises if the
    pixel count does not split evenly over the ranks."""
    _validate(cfg)
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    px, py = _block_pixels(width, height, mesh, dev)
    z = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=dev)
    film = Film(z, z.clone(), torch.zeros((), dtype=torch.float32, device=dev))
    for s in range(spp):
        film = film_add_sample(film, _render_pixels(scene, cfg, px, py, s))
    return film


def _check_alone(mesh: Mesh) -> None:
    if mesh.size != 1:
        raise ValueError(f"a mesh of {mesh.size} ranks needs its torch.distributed group")


def host_staged(x: torch.Tensor, group=None) -> bool:
    """Does a collective on ``x`` go through host memory? Under gloo a CUDA
    tensor is copied to the host first (ranks that share a card run
    gloo)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def mean_over_ranks(tensors, mesh: Mesh):
    """Each tensor averaged over the mesh's ranks, with one all-reduce of
    their concatenation: a sum divided by the rank count (gloo has no
    average). Without a group (a mesh of one process), the tensors
    themselves."""
    if not group_on():
        _check_alone(mesh)
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.cpu() if host_staged(flat, mesh.group) else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = buf.to(flat.device) / mesh.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def train_step_sharded(optimizer: torch.optim.Optimizer, scene_of_params, cfg: MegakernelConfig,
                       width: int, height: int, spp: int, mesh: Mesh, device="cuda"):
    """An inverse-rendering step with pixels sharded over the mesh →
    ``step(params, target, sample_offset) → loss``.

    ``scene_of_params(params) -> Scene`` injects the optimisable tensors
    (``params``, a dict of the tensors ``optimizer`` holds) into the scene.
    Each rank renders its block (the mean over ``spp`` samples from
    ``sample_offset`` on), takes the mean squared error over its rows of
    ``target`` (H, W, 3) and back-propagates (path replay per
    ``cfg.remat``); the loss and the gradients are then averaged over the
    ranks (``mean_over_ranks``) and ``optimizer.step()`` applies them. The
    scene renders on ``device``. The returned loss is the average,
    detached."""
    _validate(cfg)
    dev = resolve_device(device)
    lo, hi = pixel_block(width, height, mesh)

    def step(params: dict, target, sample_offset: int = 0):
        scene = scene_to(scene_of_params(params), dev)
        px, py = _block_pixels(width, height, mesh, dev)
        rows = torch.as_tensor(target, dtype=torch.float32, device=dev).reshape(-1, 3)[lo:hi]
        mean = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
        for s in range(spp):
            mean = mean + _render_pixels(scene, cfg, px, py, int(sample_offset) + s) / spp
        loss = torch.mean((mean - rows) ** 2)
        optimizer.zero_grad()
        loss.backward()
        leaves = list(params.values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        loss, *grads = mean_over_ranks([loss.detach(), *grads], mesh)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        return loss

    return step

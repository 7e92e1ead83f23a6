"""Wavefront integrators (counterpart of the reference ``models/wavefront.py``).

Two host-driven loops over the port's ``bounce_step``, whose closest-hit
and shadow queries go to kernels 2 and 3 (brute force) or 4 (BVH) for CUDA
tensors, never to a fused kernel:

- the dense early-exit wavefront (``trace_paths_wavefront``): one bounce
  over the whole ray batch per iteration while a path is alive and the
  depth budget lasts. The ``.any()`` is one host sync a bounce. It is
  ``trace_paths``' estimator on the same RNG keys, so the same image bit
  for bit: a bounce after the last path died adds exact zeros;
- the regenerating path pool (``render_pool_wavefront``): a fixed pool of
  lanes, each with its own depth, pixel and sample. A lane whose path ends
  retires its radiance into the film and takes the next (pixel, sample)
  work item in the same iteration, so every bounce runs on a full pool;
  the loop ends when no lane is alive.

Both take the hash sampler only (a lane's depth, hence its sample
dimension, is a tensor; Halton picks its prime base from a Python int),
and the pool the box filter only (a filter weight would need a per-lane
carry), as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..ops import rng as R
from ..ops.camera import generate_rays
from ..ops.film import Film, film_add_sample, film_new
from ..scene.types import Scene, scene_to
from .megakernel import (
    MegakernelConfig,
    PathState,
    _validate,
    batch_image,
    bounce_step,
    camera_batch,
    camera_path_state,
)


@dataclass(frozen=True)
class WavefrontConfig(MegakernelConfig):
    """Same knobs as the megakernel; sampler must be "hash"."""


def _check_hash(cfg, what: str = "wavefront model") -> None:
    if cfg.sampler != "hash":
        raise ValueError(f"{what} requires the hash sampler (per-lane depth index)")


def trace_paths_wavefront(scene: Scene, cfg, px, py, sample, o, d, device="cuda"):
    """Trace one sample per ray for rays (o, d) → radiance (N,3), bouncing
    while any path is alive (at most ``cfg.max_depth`` times). Inputs as
    ``trace_paths``'; every input moves to ``device``."""
    _check_hash(cfg)
    _validate(cfg)
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    px, py, o, d = (x.to(dev) for x in (px, py, o, d))
    if torch.is_tensor(sample):
        sample = sample.to(dev)
    sampler = R.Sampler(cfg.sampler, cfg.seed)
    state = camera_path_state(scene, cfg, o, d)
    depth = 0
    while depth < cfg.max_depth and bool(state.alive.any()):
        state = bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
        depth += 1
    return state.radiance


def render_sample_batch_wavefront(scene: Scene, cfg, width, height, sample):
    """Render one sample per pixel → (H, W, 3) radiance, with the pixel
    order and filter of ``render_sample_batch``, on the scene's device."""
    _check_hash(cfg)
    px, py, sample, o, d, fw, morton = camera_batch(scene, cfg, width, height, sample)
    radiance = trace_paths_wavefront(scene, cfg, px, py, sample, o, d, device=scene.device)
    return batch_image(radiance, fw, morton, width, height)


def render_progressive_wavefront(scene: Scene, film: Film, cfg, width, height, sample_offset, kspp,
                                 device="cuda"):
    """Accumulate ``kspp`` samples into the film from ``sample_offset`` on."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    film = Film(*(x.to(dev) for x in film))
    for k in range(kspp):
        radiance = render_sample_batch_wavefront(scene, cfg, width, height, int(sample_offset) + k)
        film = film_add_sample(film, radiance)
    return film


def render_wavefront(scene: Scene, width, height, spp, cfg=None, kspp: int = 4, film: Film | None = None,
                     progress_cb=None, device="cuda"):
    """Host-side progressive loop of the dense wavefront."""
    cfg = cfg or WavefrontConfig()
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    film = film if film is not None else film_new(height, width, dev)
    done = int(film.n)
    while done < spp:
        batch = min(kspp, spp - done)
        film = render_progressive_wavefront(scene, film, cfg, width, height, done, batch, device=dev)
        done += batch
        if progress_cb is not None:
            progress_cb(film, done)
    return film


def _select(mask, new: PathState, old: PathState) -> PathState:
    """Per lane: ``new`` where ``mask``, else ``old`` (fields that are None
    stay None)."""

    def sel(a, b):
        if a is None:
            return None
        return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)

    return PathState(*(sel(a, b) for a, b in zip(new, old)))


def render_pool_wavefront(scene: Scene, width: int, height: int, spp: int, cfg=None,
                          pool: int | None = None, device="cuda") -> Film:
    """Full render through the regenerating path pool → Film.

    ``pool`` lanes (default ``min(width·height, 65,536)``) trace work items
    ``w = sample·npix + pixel`` in order, each keyed as the dense render
    keys it, so the film matches ``render``'s sample for sample up to the
    order of floating-point sums. Each iteration the lanes whose path ended
    scatter-add that iteration's moments by pixel (lanes with nothing to
    add go to a dump row past the film, sliced off), which a Chan merge
    folds into the running (mean, M2, count); then those lanes take the
    next work items by prefix rank.
    """
    cfg = cfg or WavefrontConfig()
    _check_hash(cfg, "pool wavefront")
    if cfg.pixel_filter != "box":
        raise ValueError("pool wavefront supports the box pixel filter only")
    _validate(cfg)
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    npix = width * height
    m = pool or min(npix, 1 << 16)
    total = npix * spp
    sampler = R.Sampler(cfg.sampler, cfg.seed)
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def raygen(w):
        """Work item ids → (o, d, px, py, sample, pixel id)."""
        pix = w % npix
        s = w // npix
        px = pix % width
        py = pix // width
        u1, u2 = sampler.sample_2d(px, py, s, R.Dim.CAMERA_U)
        p_film = torch.stack([px.to(torch.float32) + u1, py.to(torch.float32) + u2], dim=-1)
        o, d = generate_rays(p_film, scene.cam_from_raster, scene.world_from_cam)
        return o, d, px, py, s, pix

    w0 = torch.arange(m, **i64)
    o, d, px, py, sample, pix = raygen(w0)
    live = w0 < total
    state = camera_path_state(scene, cfg, o, d)._replace(alive=live)
    pix = torch.where(live, pix, npix)  # inert lanes retire into the dump row
    depth = torch.zeros((m,), **i64)
    next_w = torch.full((), m, **i64)
    mean = torch.zeros((npix, 3), **f32)
    m2 = torch.zeros((npix, 3), **f32)
    cnt = torch.zeros((npix,), **f32)

    while bool(state.alive.any()):
        pre = state.alive
        state = bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
        depth = depth + 1
        finished = pre & (~state.alive | (depth >= cfg.max_depth))

        # retire: this iteration's moments by pixel, Chan-merged
        fpix = torch.where(finished, pix, npix)
        rad = torch.where(finished[:, None], state.radiance, 0.0)
        nb = torch.zeros((npix + 1,), **f32).index_add_(0, fpix, finished.to(torch.float32))[:npix]
        sb = torch.zeros((npix + 1, 3), **f32).index_add_(0, fpix, rad)[:npix]
        qb = torch.zeros((npix + 1, 3), **f32).index_add_(0, fpix, rad * rad)[:npix]
        nb_safe = torch.clamp(nb, min=1.0)[:, None]
        mb = sb / nb_safe
        m2b = torch.clamp(qb - sb * sb / nb_safe, min=0.0)
        ntot = cnt + nb
        wgt = (nb / torch.clamp(ntot, min=1.0))[:, None]
        delta = mb - mean
        has = (nb > 0.0)[:, None]
        mean = torch.where(has, mean + delta * wgt, mean)
        m2 = torch.where(has, m2 + m2b + delta * delta * cnt[:, None] * wgt, m2)
        cnt = ntot

        # refill: finished lanes claim the next work items by prefix rank
        rank = torch.cumsum(finished.to(torch.int64), dim=0) - 1
        w_new = next_w + rank
        valid = finished & (w_new < total)
        o2, d2, px2, py2, s2, pix2 = raygen(torch.where(finished, w_new, 0))
        state = _select(finished, camera_path_state(scene, cfg, o2, d2), state)
        state = state._replace(alive=torch.where(finished, valid, state.alive))
        px = torch.where(finished, px2, px)
        py = torch.where(finished, py2, py)
        sample = torch.where(finished, s2, sample)
        pix = torch.where(finished, torch.where(valid, pix2, npix), pix)
        depth = torch.where(finished, 0, depth)
        next_w = next_w + finished.sum()

    return Film(
        mean=mean.reshape(height, width, 3),
        m2=m2.reshape(height, width, 3),
        n=torch.full((), float(spp), **f32),
    )

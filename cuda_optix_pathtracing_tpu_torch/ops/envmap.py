"""Environment light: an equirectangular radiance map looked up by
direction (counterpart of ``eval_envmap`` in the reference
``ops/envmap.py``), without importance sampling.

Direction ↔ (u, v) follows ``ops/sampling.map_to_sphere``; the texel is
``image[clip(int(v·h)), clip(int(u·w))]`` (nearest, no filtering). Scenes
are built with a constant environment only (``make_constant_envmap``
refuses unequal texels): the reference stores a constant colour as a
1-pixel-wide (32,1,3) map, and the port keeps that image so scenes carry
over field by field. Unequal texels enter a scene only as optimised
parameters (``models/differentiable.inject_params``). HDR maps and their
importance sampling are not ported yet (slice 5).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .sampling import map_to_sphere


class EnvMap(NamedTuple):
    image: torch.Tensor  # (H, W, 3) radiance
    rotation: torch.Tensor  # (3,3) world-from-env rotation
    scale: torch.Tensor  # () radiance multiplier
    uniform: bool = False  # every texel equal (checked when built): a
    # lookup is then the first texel, which eval_envmap returns without
    # one unless the texels require grad


def make_constant_envmap(image, rotation, scale, device=None) -> EnvMap:
    """EnvMap from arrays; raises unless every texel is equal."""
    img = np.asarray(image, np.float32)
    flat = img.reshape(-1, 3)
    if not np.all(flat == flat[0]):
        raise NotImplementedError(
            "HDR environment maps are not ported yet (slice 5: scene "
            "breadth); only a constant environment is"
        )
    return EnvMap(
        torch.tensor(img, device=device),
        torch.tensor(np.asarray(rotation, np.float32), device=device),
        torch.tensor(float(scale), dtype=torch.float32, device=device),
        uniform=True,
    )


def constant_envmap(color, device=None) -> EnvMap:
    img = np.broadcast_to(np.asarray(color, np.float32), (32, 1, 3)).copy()
    return make_constant_envmap(img, np.eye(3, dtype=np.float32), 1.0, device)


def env_color(env: EnvMap):
    """(3,) radiance of the first texel: the colour of a constant
    environment (the fused kernels' shading tables)."""
    return env.image.reshape(-1, 3)[0] * env.scale


def _lookup(env: EnvMap, u, v):
    h, w = env.image.shape[:2]
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env.image.reshape(h * w, 3)[row * w + col] * env.scale


def eval_envmap(env: EnvMap, d_world):
    """Radiance (N,3) arriving from world directions ``d_world``."""
    if env.uniform and not env.image.requires_grad:
        return env_color(env).expand(d_world.shape[0], 3)
    r = env.rotation  # inverse rotation = transpose; explicit f32 mul-adds
    d = torch.stack(
        [
            r[0, i] * d_world[..., 0]
            + r[1, i] * d_world[..., 1]
            + r[2, i] * d_world[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )
    u, v = map_to_sphere(d)
    return _lookup(env, u, v)

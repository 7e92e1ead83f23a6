"""Environment light: the constant environment only (counterpart of
``constant_envmap`` in the reference ``ops/envmap.py``).

The reference stores a constant colour as a 1-pixel-wide (32,1,3) map;
the port keeps that image so scenes carry over field by field, but
evaluates it as the constant it is. HDR maps and their importance
sampling are not ported yet (slice 5).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EnvMap(NamedTuple):
    image: torch.Tensor  # (H, W, 3) radiance, every texel equal
    rotation: torch.Tensor  # (3,3) world-from-env rotation
    scale: torch.Tensor  # () radiance multiplier


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
    )


def constant_envmap(color, device=None) -> EnvMap:
    img = np.broadcast_to(np.asarray(color, np.float32), (32, 1, 3)).copy()
    return make_constant_envmap(img, np.eye(3, dtype=np.float32), 1.0, device)


def env_color(env: EnvMap):
    """(3,) radiance of the constant environment."""
    return env.image.reshape(-1, 3)[0] * env.scale


def eval_envmap(env: EnvMap, d_world):
    """Radiance (N,3) arriving from directions ``d_world``."""
    return env_color(env).expand(d_world.shape[0], 3)

"""Environment light: an equirectangular radiance map with 2D importance
sampling (counterpart of the reference ``ops/envmap.py``).

Direction ↔ (u, v) follows ``ops/sampling.map_to_sphere``
(u = ½ − atan2(x, y)/2π, v = 1 − acos(z)/π); the texel is
``image[clip(int(v·h)), clip(int(u·w))]`` (nearest). Sampling draws (u, v)
from a piecewise-constant 2D distribution over luminance·sinθ
(``ops/distrib.py``, tables built in numpy as the reference builds them),
so a solid-angle pdf is ``pdf_uv / (2π² sinθ)``. A constant colour is a
1-pixel-wide (32,1,3) map, as in the reference, so scenes carry over field
by field; such a map is marked ``uniform`` when built, and its radiance
lookup is then its first texel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .distrib import Piecewise2D, make_piecewise_2d, pdf_piecewise_2d, sample_piecewise_2d
from .sampling import map_to_sphere
from .vecmath import PI, safe_sqrt

TWO_PI = 2.0 * PI


class EnvMap(NamedTuple):
    image: torch.Tensor  # (H, W, 3) radiance
    dist: Piecewise2D  # over luminance·sinθ
    rotation: torch.Tensor  # (3,3) world-from-env rotation
    scale: torch.Tensor  # () radiance multiplier
    uniform: bool = False  # every texel equal (checked when built): a
    # radiance lookup is then the first texel, which env_radiance returns
    # without one unless the texels require grad


def make_envmap(image, rotation=None, scale: float = 1.0, device=None) -> EnvMap:
    """EnvMap from an (H,W,3) radiance image, or from an RGB colour (a
    constant environment)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 1:  # constant colour
        img = np.broadcast_to(img, (32, 1, 3)).copy()
    h = img.shape[0]
    lum = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    # rows: v = 0 at row 0; θ = (1 − v)·π at the row centres
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    sin_theta = np.sin((1.0 - v) * np.pi)
    dist = make_piecewise_2d(lum * sin_theta[:, None]).to(device)
    rot = np.eye(3, dtype=np.float32) if rotation is None else np.asarray(rotation, np.float32)
    flat = img.reshape(-1, 3)
    return EnvMap(
        torch.as_tensor(img, device=device),
        dist,
        torch.as_tensor(rot, device=device),
        torch.tensor(float(scale), dtype=torch.float32, device=device),
        uniform=bool(np.all(flat == flat[0])),
    )


def constant_envmap(color, device=None) -> EnvMap:
    return make_envmap(np.asarray(color, np.float32), device=device)


def env_color(env: EnvMap):
    """(3,) radiance of the first texel: the colour of a constant
    environment (the fused kernels' shading tables)."""
    return env.image.reshape(-1, 3)[0] * env.scale


def _uv_to_dir(u, v):
    theta = (1.0 - v) * PI
    z = torch.cos(theta)
    r = safe_sqrt(1.0 - z * z)
    phi = (0.5 - u) * TWO_PI  # φ = atan2(x, y)
    return torch.stack([r * torch.sin(phi), r * torch.cos(phi), z], dim=-1)


def _lookup(env: EnvMap, u, v):
    h, w = env.image.shape[:2]
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env.image.reshape(h * w, 3)[row * w + col] * env.scale


def _solid_angle_pdf(pdf_uv, v):
    sin_theta = torch.clamp(torch.sin((1.0 - v) * PI), min=1e-6)
    return pdf_uv / (2.0 * PI * PI * sin_theta)


def _env_uv(env: EnvMap, d_world):
    r = env.rotation  # inverse rotation = transpose; explicit f32 mul-adds
    d = torch.stack(
        [
            r[0, i] * d_world[..., 0] + r[1, i] * d_world[..., 1] + r[2, i] * d_world[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )
    return map_to_sphere(d)


def sample_envmap(env: EnvMap, u1, u2):
    """(u1, u2) → (world direction (N,3), radiance (N,3), solid-angle pdf)."""
    u, v, pdf_uv = sample_piecewise_2d(env.dist, u1, u2)
    d_env = _uv_to_dir(u, v)
    r = env.rotation  # explicit f32 mul-adds
    d = torch.stack(
        [r[i, 0] * d_env[..., 0] + r[i, 1] * d_env[..., 1] + r[i, 2] * d_env[..., 2] for i in range(3)],
        dim=-1,
    )
    return d, _lookup(env, u, v), _solid_angle_pdf(pdf_uv, v)


def env_radiance(env: EnvMap, d_world):
    """Radiance (N,3) arriving from world directions ``d_world``."""
    if env.uniform and not env.image.requires_grad:
        return env_color(env).expand(d_world.shape[0], 3)
    u, v = _env_uv(env, d_world)
    return _lookup(env, u, v)


def eval_envmap(env: EnvMap, d_world):
    """World directions → (radiance (N,3), solid-angle pdf (N,) of
    ``sample_envmap`` drawing them)."""
    u, v = _env_uv(env, d_world)
    pdf = _solid_angle_pdf(pdf_piecewise_2d(env.dist, u, v), v)
    if env.uniform and not env.image.requires_grad:
        return env_color(env).expand(d_world.shape[0], 3), pdf
    return _lookup(env, u, v), pdf

"""Differentiable rendering: inverse-rendering losses and gradient checks
(counterpart of the reference ``models/differentiable.py``).

Gradients of the rendered image with respect to material albedos and
tints, light colours and environment texels, by path-replay
backpropagation: ``trace_paths`` checkpoints its bounces
(``MegakernelConfig.remat``), so the backward pass re-traces each bounce
from its counter-based RNG keys instead of storing its intermediates.

Sampling is detached: sampled directions and pdfs are constants of the
estimator. For these parameters the sampling distributions do not depend
on them, so plain autodiff through ``f/pdf`` is the detached estimator and
matches finite differences. The intersection kernels are constants under
autograd (``ops/autodiff.nondiff_kernel``); the fused path-loop kernel has
no backward, so gradients take the ``fused="off"`` route.

Usage::

    params = init_params(scene, ("albedo",))
    loss = make_loss(scene, cfg, w, h, spp, target, spp_per_pass=spp)
    opt = torch.optim.Adam(params.values(), lr=5e-2)
    opt.zero_grad(); loss(params).backward(); opt.step()
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..scene.types import Scene, with_kernel_tables
from .megakernel import MegakernelConfig, render_sample_batch

PARAM_KEYS = ("albedo", "refl_tint", "trans_tint", "light_color", "env_image")


def _detached(x):
    if torch.is_tensor(x):
        return x.detach()
    if hasattr(x, "_fields"):
        return type(x)(*(_detached(f) for f in x))
    return x


def inject_params(scene: Scene, params: dict) -> Scene:
    """Return a scene with optimisable parameters swapped in.

    Supported keys: ``albedo``, ``refl_tint``, ``trans_tint`` (M,3),
    ``light_color`` (L,3) and ``env_image`` (H,W,3, the envmap texels).
    The fused kernels' tables are rebuilt from detached copies, so a
    render of the returned scene through them sees the new values.
    """
    unknown = set(params) - set(PARAM_KEYS)
    if unknown:
        raise ValueError(f"unknown parameter keys {sorted(unknown)}; supported {PARAM_KEYS}")
    materials = scene.materials
    lights = scene.lights
    env = scene.env
    if "albedo" in params:
        materials = materials._replace(albedo=params["albedo"])
    if "refl_tint" in params:
        materials = materials._replace(refl_tint=params["refl_tint"])
    if "trans_tint" in params:
        materials = materials._replace(trans_tint=params["trans_tint"])
    if "light_color" in params:
        lights = lights._replace(color=params["light_color"])
    if "env_image" in params:
        # the texels are looked up per direction from now on (their
        # gradient spreads over the texels the escaped rays map to)
        env = env._replace(image=params["env_image"], uniform=False)
    scene = scene._replace(materials=materials, lights=lights, env=env)
    tables = with_kernel_tables(_detached(scene))
    return scene._replace(
        shade_tables=tables.shade_tables,
        brute_tables=tables.brute_tables,
        bounds=tables.bounds,
    )


def init_params(scene: Scene, keys=("albedo",)) -> dict:
    """The scene's values of ``keys`` as detached copies that require
    grad: the leaves an optimiser updates."""
    src = dict(
        albedo=scene.materials.albedo,
        refl_tint=scene.materials.refl_tint,
        trans_tint=scene.materials.trans_tint,
        light_color=scene.lights.color,
        env_image=scene.env.image,
    )
    return {k: src[k].detach().clone().requires_grad_(True) for k in keys}


def render_mean(scene: Scene, cfg: MegakernelConfig, width, height, spp,
                sample_offset=0, spp_per_pass: int = 1):
    """Mean image over ``spp`` samples (differentiable), on the scene's
    device. ``spp_per_pass`` samples are traced as one flattened ray batch
    per pass. The fused kernel has no backward, so the route is
    ``fused="off"`` whatever ``cfg`` says."""
    cfg = dataclasses.replace(cfg, fused="off")
    if spp % spp_per_pass:
        raise ValueError(f"spp={spp} not divisible by spp_per_pass={spp_per_pass}")
    mean = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    for s in range(0, spp, spp_per_pass):
        r = render_sample_batch(
            scene, cfg, width, height, int(sample_offset) + s, nspp=spp_per_pass
        )
        if spp_per_pass > 1:
            r = torch.sum(r, dim=0)
        mean = mean + r / spp
    return mean


def make_loss(
    scene: Scene, cfg: MegakernelConfig, width: int, height: int, spp: int,
    target, spp_per_pass: int = 1,
) -> Callable:
    """L2 image loss as a function of the optimisable parameters."""
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device)

    def loss(params, sample_offset=0):
        sc = inject_params(scene, params)
        img = render_mean(sc, cfg, width, height, spp, sample_offset, spp_per_pass)
        return torch.mean((img - target) ** 2)

    return loss


def fd_gradient_check(loss_fn, params, key_path, idx, eps=1e-2):
    """Central finite difference of ``loss_fn`` with respect to one scalar
    entry → (autodiff gradient, finite difference) of
    ``params[key_path][idx]``. Both see the same paths: the sample offset
    is fixed, and the counter-based RNG replays them exactly."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss_fn(leaves).backward()
    auto = float(leaves[key_path].grad[idx])

    def perturbed(sign):
        p = {k: v.detach().clone() for k, v in params.items()}
        p[key_path][idx] += sign * eps
        with torch.no_grad():
            return float(loss_fn(p))

    fd = (perturbed(+1.0) - perturbed(-1.0)) / (2 * eps)
    return auto, fd

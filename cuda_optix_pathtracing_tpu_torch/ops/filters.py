"""Pixel reconstruction filter (counterpart of the reference
``ops/filters.py``): Mitchell-Netravali, B = C = 1/3, radius 2, sampled
by importance through a tabulated ``FilterSampler``.

With filter importance sampling every camera sample has weight sign(f)
(|f| / pdf is a constant), so the film stays a plain average.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .distrib import Piecewise2D, make_piecewise_2d, sample_piecewise_2d


def mitchell_1d(x, b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
    """Mitchell-Netravali kernel on radius-2 support: |x| in filter units,
    mapped to the canonical kernel's |x| < 2."""
    x = torch.abs(torch.as_tensor(x, dtype=torch.float32)) * 2.0
    x2 = x * x
    x3 = x2 * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) / 6
    p2 = (
        (-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x + (8 * b + 24 * c)
    ) / 6
    return torch.where(x < 1.0, p1, torch.where(x < 2.0, p2, 0.0))


def mitchell_2d(x, y, radius: float = 2.0):
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    return mitchell_1d(x / radius) * mitchell_1d(y / radius)


class FilterSampler(NamedTuple):
    dist: Piecewise2D
    radius: float
    table: torch.Tensor  # (R, R) signed filter values on the sample grid

    def to(self, device) -> "FilterSampler":
        return FilterSampler(self.dist.to(device), self.radius, self.table.to(device))


def make_filter_sampler(radius: float = 2.0, resolution: int = 32) -> FilterSampler:
    """Tabulate |f| on a resolution² grid over [-r, r]²."""
    xs = (np.arange(resolution) + 0.5) / resolution * 2 * radius - radius
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    f = mitchell_2d(gx.astype(np.float32), gy.astype(np.float32), radius)
    return FilterSampler(make_piecewise_2d(np.abs(f.numpy())), radius, f)


@functools.cache
def filter_sampler(device: str) -> FilterSampler:
    """The default sampler's tables on ``device``, built once."""
    return make_filter_sampler().to(device)


def sample_filter(fs: FilterSampler, u1, u2):
    """(u1, u2) → (dx, dy, weight): the film-plane offset in pixels and
    the sample's weight sign(f)."""
    x01, y01, _ = sample_piecewise_2d(fs.dist, u1, u2)
    res = fs.table.shape[0]
    cx = torch.clamp((x01 * res).to(torch.int64), 0, res - 1)
    cy = torch.clamp((y01 * res).to(torch.int64), 0, res - 1)
    w = torch.sign(fs.table[cy, cx])
    dx = x01 * 2 * fs.radius - fs.radius
    dy = y01 * 2 * fs.radius - fs.radius
    return dx, dy, w

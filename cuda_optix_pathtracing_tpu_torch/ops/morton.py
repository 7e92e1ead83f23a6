"""2D Morton (Z-order) pixel ordering (counterpart of the reference
``ops/morton.py``).

Camera rays of a BVH scene are generated in Morton pixel order, so rays
that sit next to each other in the batch come from a compact square of
pixels and walk the same part of the tree. ``unmorton_image`` puts the
radiance back in row-major order with one reshape/permute, no gather.
"""

from __future__ import annotations

import numpy as np
import torch


def _part1by1(v):
    v = np.asarray(v, np.uint64)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
    return v


def morton_encode2(x, y):
    """Interleave bits: y in odd, x in even positions."""
    return _part1by1(x) | (_part1by1(y) << np.uint64(1))


def is_pot_square(width: int, height: int) -> bool:
    return width == height and width > 0 and (width & (width - 1)) == 0


def morton_pixel_order(width: int, height: int) -> np.ndarray:
    """(N,) row-major pixel index permutation in Morton order (numpy).
    Needs a power-of-two square image."""
    if not is_pot_square(width, height):
        raise ValueError(f"Morton order needs a power-of-two square image, got {width}x{height}")
    ix, iy = np.meshgrid(np.arange(width), np.arange(height))
    return np.argsort(morton_encode2(ix.ravel(), iy.ravel()), kind="stable")


def unmorton_image(flat: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., N, C) values in Morton pixel order → (..., H, W, C) row-major.

    The Morton index bits are [y_{k-1} x_{k-1} … y_0 x_0]: viewing the
    pixel axis as 2k binary axes and permuting them to
    [y_{k-1}…y_0 x_{k-1}…x_0] is the de-interleave."""
    if not is_pot_square(width, height):
        raise ValueError(f"Morton order needs a power-of-two square image, got {width}x{height}")
    k = width.bit_length() - 1
    lead = flat.shape[:-2]
    c = flat.shape[-1]
    nl = len(lead)
    x = flat.reshape(*lead, *(2,) * (2 * k), c)
    y_axes = [nl + i for i in range(0, 2 * k, 2)]
    x_axes = [nl + i for i in range(1, 2 * k, 2)]
    x = x.permute(*range(nl), *y_axes, *x_axes, nl + 2 * k)
    return x.reshape(*lead, height, width, c)

"""Counter-based random numbers of the path tracer: the pcg4d hash sampler
(Jarzynski & Olano 2020). Every draw is a pure function of (pixel x,
pixel y, sample ^ seed, dimension).

u32 arithmetic on int64 tensors holding values in [0, 2^32): every step
masks with 0xFFFFFFFF, and products split one factor into 16-bit halves
so that no intermediate leaves int64's range.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

# per-bounce dimension offsets, in the order the path loop draws them
CAMERA_U = 0  # 2 dims, depth 0 only
LIGHT_SELECT = 2
LIGHT_U = 3  # 2 dims
BSDF_U = 5  # 2 dims
BSDF_UC = 7
RR = 8
DIMS_PER_BOUNCE = 24


def u32(x, device=None) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & M32


def _mul32(a, b):
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & M32


def _lcg(a):
    return (_mul32(a, 1664525) + 1013904223) & M32


def pcg4d(a, b, c, d):
    x, y, z, w = (_lcg(u32(k)) for k in torch.broadcast_tensors(u32(a), u32(b), u32(c), u32(d)))
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    return x, y, z, w


def _to_float01(u):
    """The top 24 bits of a u32 as a float32 in [0, 1) (exact)."""
    return (u >> 8).to(torch.float32) * 5.9604645e-08


class HashSampler:
    """Draws of the hash sampler for one seed, in ``dtype``."""

    def __init__(self, seed: int, dtype=torch.float32):
        self.seed = int(seed)
        self.dtype = dtype

    def _keys(self, px, sample, dim):
        s = u32(sample, px.device) ^ u32(self.seed, px.device)
        return s, u32(dim, px.device)

    def sample_1d(self, px, py, sample, dim: int):
        s, d = self._keys(px, sample, dim)
        x, _, _, _ = pcg4d(px, py, s, d)
        return _to_float01(x).to(self.dtype)

    def sample_2d(self, px, py, sample, dim: int):
        s, d = self._keys(px, sample, dim)
        x, y, _, _ = pcg4d(px, py, s, d)
        return _to_float01(x).to(self.dtype), _to_float01(y).to(self.dtype)

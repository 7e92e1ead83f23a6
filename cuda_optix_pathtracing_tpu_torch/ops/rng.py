"""Counter-based, replayable random numbers: the hash half of the
reference ``ops/rng.py``.

Every sample is a pure function of ``(pixel_x, pixel_y, sample ^ seed,
dimension)`` through ``pcg4d`` (Jarzynski & Olano 2020), so there is no
generator state and any path can be replayed from its keys. The values
are bit-identical to the JAX package's.

u32 arithmetic: PyTorch on the CPU has no uint32 ``+`` or ``>>``, so keys
are int64 tensors holding values in [0, 2^32) and every step masks with
``& 0xFFFFFFFF``. Products go through ``_mul32``, which splits one factor
into 16-bit halves so that no intermediate leaves int64's range. The CUDA
kernels compute the same functions on native ``uint32_t``.

The Owen-scrambled Halton sampler is not ported yet (slice 4).
"""

from __future__ import annotations

import enum

import torch

M32 = 0xFFFFFFFF


class Dim(enum.IntEnum):
    """Per-bounce dimension offsets (consumption order of the reference
    megakernel loop)."""

    CAMERA_U = 0  # 2 dims: pixel-filter jitter (depth 0 only)
    LIGHT_SELECT = 2  # 1 dim: NEE light index
    LIGHT_U = 3  # 2 dims: light sampling
    BSDF_U = 5  # 2 dims: bsdf sampling
    BSDF_UC = 7  # 1 dim: bsdf lobe choice
    RR = 8  # 1 dim: russian roulette
    ENV_SELECT = 9  # 1 dim: infinite-light index on miss
    ENV_U = 10  # 2 dims: envmap NEE importance sample
    TREE_U = 12  # 3 dims × 4 split slots: light-tree NEE


DIMS_PER_BOUNCE = 24


def u32(x, device=None) -> torch.Tensor:
    """int64 tensor of ``x`` reduced mod 2^32."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & M32


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and ``b`` in
    [0, 2^32) (tensor or int)."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & M32


def _lcg(a):
    return (_mul32(a, 1664525) + 1013904223) & M32


def pcg4d(a, b, c, d):
    """4D → 4D hash of u32 keys; returns four int64 tensors in [0, 2^32)."""
    x, y, z, w = (_lcg(u32(k)) for k in torch.broadcast_tensors(
        u32(a), u32(b), u32(c), u32(d)
    ))
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


def pcg_hash(seed):
    """Scalar PCG hash, vectorized."""
    state = (_mul32(u32(seed), 747796405) + 2891336453) & M32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def u32_to_float01(u):
    """u32 → float32 in [0, 1) from the top 24 bits (exact)."""
    return (u >> 8).to(torch.float32) * 5.9604645e-08


def hash_sample_2d(px, py, sample, dim, seed: int = 0):
    """Two uniform floats for key (pixel, sample, dim)."""
    device = px.device if torch.is_tensor(px) else None
    s = u32(sample, device) ^ u32(seed, device)
    x, y, _, _ = pcg4d(px, py, s, u32(dim, device))
    return u32_to_float01(x), u32_to_float01(y)


def hash_sample_1d(px, py, sample, dim, seed: int = 0):
    device = px.device if torch.is_tensor(px) else None
    s = u32(sample, device) ^ u32(seed, device)
    x, _, _, _ = pcg4d(px, py, s, u32(dim, device))
    return u32_to_float01(x)


class Sampler:
    """Stateless sampler facade bound to a generator kind and a seed.
    Only ``"hash"`` is ported; ``"halton"`` arrives with slice 4."""

    def __init__(self, kind: str = "hash", seed: int = 0):
        if kind == "halton":
            raise NotImplementedError(
                "the Owen-scrambled Halton sampler is not ported yet "
                "(slice 4: sampling breadth)"
            )
        if kind != "hash":
            raise ValueError(f"unknown sampler kind: {kind}")
        self.kind = kind
        self.seed = seed

    def sample_1d(self, px, py, sample, dim: int):
        return hash_sample_1d(px, py, sample, dim, self.seed)

    def sample_2d(self, px, py, sample, dim: int):
        return hash_sample_2d(px, py, sample, dim, self.seed)

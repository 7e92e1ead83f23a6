"""Counter-based, replayable random numbers (counterpart of the reference
``ops/rng.py``).

Every sample is a pure function of ``(pixel_x, pixel_y, sample, seed,
dimension)``, so there is no generator state and any path can be replayed
from its keys. Two generators share that keying, both bit-identical to the
JAX package's:

- the hash sampler, ``pcg4d(px, py, sample ^ seed, dim)`` (Jarzynski &
  Olano 2020), the default;
- the Owen-scrambled Halton sampler (``halton_owen_sample``): base-2
  radical inverse with a Laine-Karras nested-uniform scramble, and odd
  prime bases with hash-seeded digit scrambling, decorrelated across
  pixels by ``pcg4d(px, py, dim, seed)``. ``Sampler`` uses it for
  dimensions below ``qmc_dims`` and the hash above.

u32 arithmetic: PyTorch on the CPU has no uint32 ``+`` or ``>>``, so keys
are int64 tensors holding values in [0, 2^32) and every step masks with
``& 0xFFFFFFFF``. Products go through ``_mul32``, which splits one factor
into 16-bit halves so that no intermediate leaves int64's range. The CUDA
kernels compute the same functions on native ``uint32_t``.
"""

from __future__ import annotations

import enum

import numpy as np
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


# ---------------------------------------------------------------------------
# Owen-scrambled Halton
# ---------------------------------------------------------------------------

# dimension d uses base PRIMES[d % 32]
PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
    59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131,
)
_N_DIGITS = {2: 32, 3: 20, 5: 14, 7: 12, 11: 10, 13: 9}  # 8 for larger bases
QMC_DIMS = 12  # Sampler default: Halton below this dimension, hash above
_ONE_MINUS = torch.tensor(1.0 - 1e-7, dtype=torch.float32)


def n_digits(base: int) -> int:
    return _N_DIGITS.get(base, 8)


def reverse_bits32(v):
    v = u32(v)
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return (v >> 16) | ((v << 16) & M32)


def laine_karras_permutation(x, seed):
    """Base-2 nested-uniform (Owen) scramble in reversed-bit space
    (Laine & Karras 2011, Burley 2020)."""
    x = (u32(x) + u32(seed)) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def sobol_owen_base2(index, scramble_seed):
    """Owen-scrambled base-2 radical inverse of ``index`` → float32 in
    [0, 1): the permutation on the raw index, then the bit reverse."""
    return u32_to_float01(reverse_bits32(laine_karras_permutation(index, scramble_seed)))


def radical_inverse_owen(index, base: int, scramble_seed, n_digits: int):
    """Owen-scrambled radical inverse in an odd prime ``base``: digit k is
    permuted to ``(digit + h) % base``, ``h`` a hash of the digit prefix.
    Sums wrap mod 2^32 before the ``%``, as u32 arithmetic does, and the
    digit weight ``inv_mult`` advances in float32."""
    scramble_seed = u32(scramble_seed)
    idx = u32(index, scramble_seed.device)
    idx, scramble_seed = torch.broadcast_tensors(idx, scramble_seed)
    value = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    prefix = torch.zeros_like(idx)
    inv_base = np.float32(1.0 / base)
    inv_mult = inv_base
    for _ in range(n_digits):
        digit = idx % base
        h = pcg_hash(_mul32(prefix, 0x9E3779B9) ^ scramble_seed)
        sdigit = ((digit + h) & M32) % base
        value = value + sdigit.to(torch.float32) * torch.tensor(inv_mult)
        prefix = (prefix * base + digit + 1) & M32
        idx = idx // base
        inv_mult = inv_mult * inv_base
    return torch.minimum(value, _ONE_MINUS.to(value.device))


def halton_owen_sample(px, py, sample, dim: int, seed: int = 0):
    """Owen-scrambled Halton sample of dimension ``dim`` (a Python int: it
    picks the prime base), scrambled per pixel by ``pcg4d(px, py, dim,
    seed)``."""
    base = PRIMES[int(dim) % len(PRIMES)]
    device = px.device if torch.is_tensor(px) else None
    pixel_seed, _, _, _ = pcg4d(px, py, u32(int(dim), device), u32(seed, device))
    if base == 2:
        return sobol_owen_base2(u32(sample, device), pixel_seed)
    return radical_inverse_owen(sample, base, pixel_seed, n_digits(base))


class Sampler:
    """Stateless sampler facade bound to a generator kind, a seed and, for
    ``"halton"``, the number of leading dimensions that are Halton
    (``qmc_dims``; the hash sampler serves the rest). ``dim`` is a Python
    int."""

    def __init__(self, kind: str = "hash", seed: int = 0, qmc_dims: int = QMC_DIMS):
        if kind not in ("hash", "halton"):
            raise ValueError(f"unknown sampler kind: {kind}")
        self.kind = kind
        self.seed = seed
        self.qmc_dims = qmc_dims

    def sample_1d(self, px, py, sample, dim: int):
        if self.kind == "halton" and dim < self.qmc_dims:
            return halton_owen_sample(px, py, sample, dim, self.seed)
        return hash_sample_1d(px, py, sample, dim, self.seed)

    def sample_2d(self, px, py, sample, dim: int):
        if self.kind == "halton" and dim + 1 < self.qmc_dims:
            return (
                halton_owen_sample(px, py, sample, dim, self.seed),
                halton_owen_sample(px, py, sample, dim + 1, self.seed),
            )
        return hash_sample_2d(px, py, sample, dim, self.seed)

// The samplers of ops/rng.py on the card, shared by the path-tracing
// kernels (megakernel.cu) and the BSDF stage of the unfused bounce
// (bsdf_step.cu): pcg4d keyed (px, py, sample ^ seed, dim), and the
// Owen-scrambled Halton sampler for the dimensions below qmc_dims, both
// bit-identical to the plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// RNG (ops/rng.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 pcg4d(uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  uint32_t x = a * 1664525u + 1013904223u;
  uint32_t y = b * 1664525u + 1013904223u;
  uint32_t z = c * 1664525u + 1013904223u;
  uint32_t w = d * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  return make_uint4(x, y, z, w);
}

__device__ __forceinline__ float u01(uint32_t u) {
  return (float)(u >> 8) * 5.9604645e-08f;
}

__device__ __forceinline__ uint32_t pcg_hash(uint32_t seed) {
  const uint32_t state = seed * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

// Owen-scrambled Halton (ops/rng.py halton_owen_sample): dimension dim uses
// base kPrimes[dim % 32], scrambled per pixel by pcg4d(px, py, dim, seed).
// Base 2 is the Laine-Karras permutation of the index, bit-reversed; an
// odd base permutes digit k to (digit + h) % base, h a hash of the digit
// prefix. The digit weight starts at and advances by float32(1 / base)
// (kInvPrimes, rounded from double as the plain version's constant is),
// and the accumulate rounds the product and the sum apart, never
// contracted into an FMA, so the value is bit-equal to the plain version.
__constant__ uint32_t kPrimes[32] = {2,  3,  5,  7,  11, 13, 17, 19, 23, 29, 31,
                                     37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79,
                                     83, 89, 97, 101, 103, 107, 109, 113, 127, 131};
#define INV(p) (float)(1.0 / (p))
__constant__ float kInvPrimes[32] = {
    INV(2),  INV(3),  INV(5),  INV(7),   INV(11),  INV(13),  INV(17),  INV(19),
    INV(23), INV(29), INV(31), INV(37),  INV(41),  INV(43),  INV(47),  INV(53),
    INV(59), INV(61), INV(67), INV(71),  INV(73),  INV(79),  INV(83),  INV(89),
    INV(97), INV(101), INV(103), INV(107), INV(109), INV(113), INV(127), INV(131)};
#undef INV

__device__ __noinline__ float halton_owen(uint32_t px, uint32_t py, uint32_t sample,
                                          uint32_t dim, uint32_t seed) {
  const uint32_t pixel_seed = pcg4d(px, py, dim, seed).x;
  const uint32_t base = kPrimes[dim % 32u];
  if (base == 2u) {
    uint32_t x = sample + pixel_seed;
    x ^= x * 0x6C50B47Cu;
    x ^= x * 0xB82F1E52u;
    x ^= x * 0xC7AFE638u;
    x ^= x * 0x8D22F6E6u;
    return u01(__brev(x));
  }
  const int n_digits = base == 3u ? 20 : base == 5u ? 14 : base == 7u ? 12
                     : base == 11u ? 10 : base == 13u ? 9 : 8;
  const float inv_base = kInvPrimes[dim % 32u];
  uint32_t idx = sample, prefix = 0u;
  float value = 0.0f, inv_mult = inv_base;
  for (int k = 0; k < n_digits; ++k) {
    const uint32_t quot = idx / base;
    const uint32_t digit = idx - quot * base;
    const uint32_t h = pcg_hash(prefix * 0x9E3779B9u ^ pixel_seed);
    const uint32_t sdigit = (digit + h) % base;
    value = __fadd_rn(value, __fmul_rn(__uint2float_rn(sdigit), inv_mult));
    prefix = prefix * base + digit + 1u;
    idx = quot;
    inv_mult = __fmul_rn(inv_mult, inv_base);
  }
  return fminf(value, (float)(1.0 - 1e-7));
}

// The samplers, keyed (px, py, sample, dim) with the seed (ops/rng.py
// Sampler). The hash keys pcg4d on sample ^ seed; Halton serves the
// dimensions below qmc_dims (a 2-D request needs both) and the hash the
// rest.
struct HashRng {
  uint32_t px, py, ss;
  __device__ HashRng(uint32_t px_, uint32_t py_, uint32_t sample, uint32_t seed, int)
      : px(px_), py(py_), ss(sample ^ seed) {}
  __device__ float u1(uint32_t dim) const { return u01(pcg4d(px, py, ss, dim).x); }
  __device__ float2 u2(uint32_t dim) const {
    const uint4 h = pcg4d(px, py, ss, dim);
    return make_float2(u01(h.x), u01(h.y));
  }
};

struct HaltonRng {
  HashRng hash;
  uint32_t sample, seed, qmc_dims;
  __device__ HaltonRng(uint32_t px_, uint32_t py_, uint32_t sample_, uint32_t seed_,
                       int qmc_dims_)
      : hash(px_, py_, sample_, seed_, 0), sample(sample_), seed(seed_),
        qmc_dims((uint32_t)qmc_dims_) {}
  __device__ float u1(uint32_t dim) const {
    return dim < qmc_dims ? halton_owen(hash.px, hash.py, sample, dim, seed) : hash.u1(dim);
  }
  __device__ float2 u2(uint32_t dim) const {
    if (dim + 1u < qmc_dims)
      return make_float2(halton_owen(hash.px, hash.py, sample, dim, seed),
                         halton_owen(hash.px, hash.py, sample, dim + 1u, seed));
    return hash.u2(dim);
  }
};

// Path r's sampler from its keys as the fused kernels take them, in place
// from the render route: the low 32 bits of the (n,) int64 px, py and
// sample that the camera kernel writes; a null sample gives every path
// sample0 (a pass of one sample a pixel).
template <class Smp>
__device__ __forceinline__ Smp path_rng(const int64_t* __restrict__ px,
                                        const int64_t* __restrict__ py,
                                        const int64_t* __restrict__ sample, uint32_t sample0,
                                        int r, uint32_t seed, int qmc_dims) {
  return Smp((uint32_t)px[r], (uint32_t)py[r], sample ? (uint32_t)sample[r] : sample0, seed,
             qmc_dims);
}

}  // namespace

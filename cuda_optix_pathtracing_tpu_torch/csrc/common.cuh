// Shared device helpers for the path tracer's CUDA kernels: float3
// arithmetic, the Moller-Trumbore test with the reference tolerances, and
// error reporting for the plain-C entry points.
//
// Built without --use_fast_math: the MT parallel test and the
// 1/where(parallel, 1, det) guard rely on IEEE division.
// (1.0f + MT_TOLERANCE rounds to the float32 the plain version compares
// against: 1 + 2^-23.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MT_TOLERANCE 1e-7f
#define T_MIN 1e-4f
#define BIG_T 3.0e38f

// largest dynamic shared-memory block a Hopper SM grants one block
#define MAX_SMEM_BYTES (227 * 1024)

__device__ __forceinline__ float3 f3(float x, float y, float z) {
  return make_float3(x, y, z);
}
__device__ __forceinline__ float3 operator+(float3 a, float3 b) {
  return f3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 operator-(float3 a, float3 b) {
  return f3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 operator-(float3 a) {
  return f3(-a.x, -a.y, -a.z);
}
__device__ __forceinline__ float3 operator*(float3 a, float s) {
  return f3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float3 operator*(float s, float3 a) {
  return f3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float3 div3(float3 a, float s) {
  return f3(a.x / s, a.y / s, a.z / s);
}
__device__ __forceinline__ float3 mul3(float3 a, float3 b) {
  return f3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return f3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float3 load3(const float* p, int i) {
  return f3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, int i, float3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// a*b - c*d and a0*b0 + a1*b1 + a2*b2, rounded after every operation
// (the _rn intrinsics are never contracted into FMAs)
__device__ __forceinline__ float mul_sub_rn(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float dot3_rn(float a0, float b0, float a1, float b1,
                                         float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// Moller-Trumbore against the triangle (v0, e0 = p1 - p0, e1 = p2 - p0).
// True when the ray hits at T_MIN < t < t_cap; writes t, u, v.
// Every operation rounds as in the plain PyTorch sweep (one elementwise op
// at a time, in the same order): an FMA-contracted cross product moves t
// by a few ulp of the coordinates, which near the ray origin exceeds 1e-5
// of t, so the test is written without contraction and t, u, v and the
// hit decision follow the plain version's arithmetic.
__device__ __forceinline__ bool mt_test(float3 o, float3 d, float3 p0,
                                        float3 e0, float3 e1, float t_cap,
                                        float& t, float& u, float& v) {
  const float px = mul_sub_rn(d.y, e1.z, d.z, e1.y);
  const float py = mul_sub_rn(d.z, e1.x, d.x, e1.z);
  const float pz = mul_sub_rn(d.x, e1.y, d.y, e1.x);
  const float det = dot3_rn(px, e0.x, py, e0.y, pz, e0.z);
  const bool parallel = fabsf(det) < MT_TOLERANCE;
  const float inv_det = 1.0f / (parallel ? 1.0f : det);
  const float tx = o.x - p0.x, ty = o.y - p0.y, tz = o.z - p0.z;
  const float qx = mul_sub_rn(ty, e0.z, tz, e0.y);
  const float qy = mul_sub_rn(tz, e0.x, tx, e0.z);
  const float qz = mul_sub_rn(tx, e0.y, ty, e0.x);
  u = __fmul_rn(inv_det, dot3_rn(px, tx, py, ty, pz, tz));
  v = __fmul_rn(inv_det, dot3_rn(qx, d.x, qy, d.y, qz, d.z));
  t = __fmul_rn(inv_det, dot3_rn(qx, e1.x, qy, e1.y, qz, e1.z));
  return !parallel && u >= -MT_TOLERANCE && v >= -MT_TOLERANCE &&
         __fadd_rn(u, v) <= 1.0f + MT_TOLERANCE && t > T_MIN && t < t_cap;
}

// The same against one triangle row [v0 | e0 | e1] (9 floats).
__device__ __forceinline__ bool mt_test(float3 o, float3 d,
                                        const float* __restrict__ tri,
                                        float t_cap, float& t, float& u,
                                        float& v) {
  return mt_test(o, d, f3(tri[0], tri[1], tri[2]), f3(tri[3], tri[4], tri[5]),
                 f3(tri[6], tri[7], tri[8]), t_cap, t, u, v);
}

// Copy n floats from global to shared memory with the whole block.
__device__ __forceinline__ void block_copy(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

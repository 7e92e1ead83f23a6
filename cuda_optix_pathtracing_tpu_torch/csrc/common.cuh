// Shared device helpers for the path tracer's CUDA kernels: float3
// arithmetic, the Moller-Trumbore test with the reference tolerances, the
// brute-force sweeps' test of a 48 B row with a cull before the division
// (sweep_test: the fused kernel's BruteGeo and the any-hit kernel of
// intersect.cu), and the shared-memory limit of a block.
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

// The brute-force sweep's cull: a triangle is rejected before the
// division only where mt_test would reject it. With a = |det| >= 1e-7 (a
// parallel triangle is rejected as mt_test rejects it) and the numerators
// U, V, T of u, v, t signed by det, mt_test's u = fl(fl(1/det) * U/sign)
// is (U / a)(1 + e), |e| < 3 * 2^-24, and the products a * c below round
// once more (the arguments are normal floats: a * c >= 1e-14):
// - U < -a * CULL_LO gives u < -2e-7 (1 - 2^-22) < -MT_TOLERANCE; V alike;
// - U + V > a * CULL_HI (the sum rounded once; u, v >= -2e-7 there) gives
//   fl(u + v) > 1 + 3.7e-6 > 1 + MT_TOLERANCE;
// - T <= a * CULL_TMIN gives t <= 0.99e-4 (1 + 2^-22) < T_MIN, which takes
//   in T of the opposite sign to det (t < 0);
// - T >= a * (t_cap * CULL_TCAP) gives t > t_cap, which mt_test rejects
//   too (an overflow to inf culls nothing; t_cap <= T_MIN rejects all).
// A triangle that passes runs the rest of mt_test on the same rounded
// values (the division and the hit decision), so t, u, v and the hit are
// mt_test's bit for bit. ops/intersect.py mt_cull is its plain version.
#define CULL_LO 2e-7f
#define CULL_HI 1.000004f
#define CULL_TMIN 0.99e-4f
#define CULL_TCAP 1.000004f

// mt_test against row r = [v0, . | e0, . | e1, .] with the cull before the
// division; cap = t_cap * CULL_TCAP.
__device__ __forceinline__ bool sweep_test(float3 o, float3 d, const float4* r, float t_cap,
                                           float cap, float& t, float& u, float& v) {
  const float4 p0 = r[0], e0 = r[1], e1 = r[2];
  const float px = mul_sub_rn(d.y, e1.z, d.z, e1.y);
  const float py = mul_sub_rn(d.z, e1.x, d.x, e1.z);
  const float pz = mul_sub_rn(d.x, e1.y, d.y, e1.x);
  const float det = dot3_rn(px, e0.x, py, e0.y, pz, e0.z);
  const float tx = o.x - p0.x, ty = o.y - p0.y, tz = o.z - p0.z;
  const float qx = mul_sub_rn(ty, e0.z, tz, e0.y);
  const float qy = mul_sub_rn(tz, e0.x, tx, e0.z);
  const float qz = mul_sub_rn(tx, e0.y, ty, e0.x);
  const float un = dot3_rn(px, tx, py, ty, pz, tz);
  const float vn = dot3_rn(qx, d.x, qy, d.y, qz, d.z);
  const float tn = dot3_rn(qx, e1.x, qy, e1.y, qz, e1.z);
  const float a = fabsf(det);
  const bool neg = det < 0.0f;
  const float us = neg ? -un : un, vs = neg ? -vn : vn, ts = neg ? -tn : tn;
  const float lo = -__fmul_rn(a, CULL_LO);
  // one predicate, one branch: a warp whose lanes all cull skips the rest
  if ((a < MT_TOLERANCE) | (us < lo) | (vs < lo) |
      (__fadd_rn(us, vs) > __fmul_rn(a, CULL_HI)) | (ts <= __fmul_rn(a, CULL_TMIN)) |
      (ts >= __fmul_rn(a, cap)))
    return false;
  const float inv_det = 1.0f / det;
  u = __fmul_rn(inv_det, un);
  v = __fmul_rn(inv_det, vn);
  t = __fmul_rn(inv_det, tn);
  return (u >= -MT_TOLERANCE) & (v >= -MT_TOLERANCE) &
         (__fadd_rn(u, v) <= 1.0f + MT_TOLERANCE) & (t > T_MIN) & (t < t_cap);
}

// Copy n floats from global to shared memory with the whole block.
__device__ __forceinline__ void block_copy(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

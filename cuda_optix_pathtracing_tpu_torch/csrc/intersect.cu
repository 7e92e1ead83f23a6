// Brute-force ray-triangle kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels in cuda_optix_pathtracing_tpu/ops/intersect_pallas.py:
//   closest_bruteforce <- _closest_kernel (launched by _closest_call)
//   anyhit_bruteforce  <- _anyhit_kernel  (launched by _any_call)
// Semantics are those of ops/intersect.py in both packages: Moller-Trumbore
// with the reference tolerances, strict t < t_best so the first index wins
// a tie, BIG_T / index 0 on a miss, d = 0 rays never hit (det = 0). The
// test rounds after every operation, as the plain sweep does (mt_test in
// common.cuh).
//
// What bounds it on the card: arithmetic. Each ray reads 24-28 bytes and
// does ~45 flops per triangle, so at the main path's T = 26 a ray costs
// ~1.2 kflop against ~32 bytes: ~36 flop/byte, well above the H100's
// ~20 flop/byte FP32 ridge (67 TFLOP/s over 3.35 TB/s).
//
// Design: one thread per ray, the whole (T, 9) triangle table staged once
// per block in shared memory. Every thread of a warp reads the same
// triangle at the same time, so each shared load is a broadcast with no
// bank conflict and the sweep runs from registers and shared memory only.
// The TPU kernel's (rows, 128) lane tiles and SMEM-scalar streaming are
// not carried over: they exist for the TPU's vector unit. The any-hit
// kernel leaves its loop at the first hit.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tri, int n_rays, int n_tris,
                   float* __restrict__ best_t, int* __restrict__ best_i) {
  extern __shared__ float s_tri[];
  block_copy(s_tri, tri, 9 * n_tris);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float3 ro = load3(o, r);
  const float3 rd = load3(d, r);
  float tb = BIG_T;
  int ib = 0;
  for (int i = 0; i < n_tris; ++i) {
    float t, u, v;
    if (mt_test(ro, rd, s_tri + 9 * i, tb, t, u, v)) {
      tb = t;
      ib = i;
    }
  }
  best_t[r] = tb;
  best_i[r] = ib;
}

__global__ void __launch_bounds__(kBlock)
    anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max,
                  const float* __restrict__ tri, int n_rays, int n_tris,
                  int* __restrict__ occ) {
  extern __shared__ float s_tri[];
  block_copy(s_tri, tri, 9 * n_tris);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float3 ro = load3(o, r);
  const float3 rd = load3(d, r);
  const float tm = t_max[r];
  int hit = 0;
  for (int i = 0; i < n_tris; ++i) {
    float t, u, v;
    if (mt_test(ro, rd, s_tri + 9 * i, tm, t, u, v)) {
      hit = 1;
      break;
    }
  }
  occ[r] = hit;
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (smem > MAX_SMEM_BYTES) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace

// Plain-C entry points (ctypes). Pointers are device pointers; o and d
// are (n, 3) row-major, tri is (T, 9) rows [v0 | e0 | e1]. Return the
// CUDA error code of the launch (0 = launched).
extern "C" int closest_bruteforce(const float* o, const float* d,
                                  const float* tri, int n_rays, int n_tris,
                                  float* best_t, int* best_i, void* stream) {
  const size_t smem = sizeof(float) * 9 * (size_t)n_tris;
  cudaError_t err = prepare((const void*)closest_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  closest_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      o, d, tri, n_rays, n_tris, best_t, best_i);
  return (int)cudaGetLastError();
}

extern "C" int anyhit_bruteforce(const float* o, const float* d,
                                 const float* t_max, const float* tri,
                                 int n_rays, int n_tris, int* occ,
                                 void* stream) {
  const size_t smem = sizeof(float) * 9 * (size_t)n_tris;
  cudaError_t err = prepare((const void*)anyhit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  anyhit_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      o, d, t_max, tri, n_rays, n_tris, occ);
  return (int)cudaGetLastError();
}

// Brute-force ray-triangle kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels in cuda_optix_pathtracing_tpu/ops/intersect_pallas.py:
//   closest_bruteforce <- _closest_kernel (launched by _closest_call)
//   anyhit_bruteforce  <- _anyhit_kernel  (launched by _any_call)
// Semantics are those of ops/intersect.py in both packages: Moller-Trumbore
// with the reference tolerances, strict t < t_best so the first index wins
// a tie, BIG_T / index 0 on a miss, d = 0 rays never hit (det = 0). The
// test rounds after every operation, as the plain sweep does (mt_test in
// common.cuh, and sweep_test, the same arithmetic with a cull before the
// division).
//
// What bounds it on the card: instruction issue. Each ray reads 24-28
// bytes and tests every triangle, ~45 floating-point operations a test:
// at the main path's T = 26, ~36 flop/byte, above the H100's ~20 flop/byte
// FP32 ridge (67 TFLOP/s over 3.35 TB/s). The test cannot use FMAs (it
// rounds as the plain sweep does), so with its compares, selects and
// loads it issues ~60 instructions, and a launch of 65,536 rays keeps the
// whole card busy for a few microseconds beside a ~1 us launch floor
// (PERF.md, an H100 at 700 W).
//
// Design: the triangle rows [v0, . | e0, 0 | e1, 0] (48 B, three float4s;
// the first 12 T words of a brute-force scene's brute_tables, built once
// per scene) are staged once per block in shared memory and read as three
// 16-byte loads a test. Each ray takes kLanes consecutive lanes of a warp;
// lane k sweeps triangles k, k + kLanes, ... A closest-hit lane keeps the
// first index of its least t; a warp shuffle then reduces the ray's lanes
// to the lexicographic least (t, index), which is the sequential sweep's
// winner. An any-hit lane leaves its loop at its first hit, and the lanes
// OR their flags. The any-hit lanes test with sweep_test, which culls a
// triangle before the division where the division could not accept it
// (t_max is a tight cap: 1.9 % faster than without); the closest-hit
// lanes with mt_test, since there the cull measured 4.7 % slower (a warp
// divides as soon as one lane passes, and a lane's cap falls only as it
// finds hits). Two lanes a ray measured fastest of 1, 2, 4 and 8 at the
// main path's launches: they halve the chain of dependent tests, and more
// lanes add warps (a second wave at 8) and idle lanes where T is not a
// multiple of kLanes. (Ten alternating pairs each; PERF.md.) The outputs
// are written in the wrapper's types
// (int64 index, bool flag), so a call is this one launch. The TPU
// kernel's (rows, 128) lane tiles and SMEM-scalar streaming are not
// carried over: they exist for the TPU's vector unit.
#include "common.cuh"

namespace {

constexpr int kLanes = 2;    // consecutive lanes per ray: 1, 2, 4, 8, 16 or 32
constexpr int kBlock = 256;  // threads per block, a multiple of 32
constexpr unsigned kWarp = 0xffffffffu;

// Copy n float4s from global to shared memory with the whole block.
__device__ __forceinline__ void stage_rows(float4* __restrict__ dst,
                                           const float4* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += kBlock) dst[k] = src[k];
}

// mt_test against row r = [v0, . | e0, 0 | e1, 0].
__device__ __forceinline__ bool row_test(float3 o, float3 d, const float4* r, float t_cap,
                                         float& t, float& u, float& v) {
  const float4 a = r[0], b = r[1], c = r[2];
  return mt_test(o, d, f3(a.x, a.y, a.z), f3(b.x, b.y, b.z), f3(c.x, c.y, c.z), t_cap, t, u,
                 v);
}

// The ray and lane of this thread; r may be past the last ray, and such a
// thread still takes part in its warp's shuffles.
__device__ __forceinline__ void ray_lane(int& r, int& lane) {
  const long long g = (long long)blockIdx.x * kBlock + threadIdx.x;
  r = (int)(g / kLanes);
  lane = (int)(g % kLanes);
}

__global__ void __launch_bounds__(kBlock)
    closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float4* __restrict__ rows, int n_rays, int n_tris,
                   float* __restrict__ best_t, long long* __restrict__ best_i) {
  extern __shared__ float4 s_rows[];
  stage_rows(s_rows, rows, 3 * n_tris);
  __syncthreads();
  int r, lane;
  ray_lane(r, lane);
  float tb = BIG_T;
  int ib = 0;
  if (r < n_rays) {
    const float3 ro = load3(o, r);
    const float3 rd = load3(d, r);
    for (int i = lane; i < n_tris; i += kLanes) {
      float t, u, v;
      if (row_test(ro, rd, s_rows + 3 * i, tb, t, u, v)) {
        tb = t;
        ib = i;
      }
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) {
    const float t2 = __shfl_xor_sync(kWarp, tb, m);
    const int i2 = __shfl_xor_sync(kWarp, ib, m);
    if (t2 < tb || (t2 == tb && i2 < ib)) {
      tb = t2;
      ib = i2;
    }
  }
  if (r < n_rays && lane == 0) {
    best_t[r] = tb;
    best_i[r] = ib;
  }
}

// t_max[r * tm_stride] (stride 0: one value for all rays), or tm_value
// where t_max is null.
__global__ void __launch_bounds__(kBlock)
    anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, int tm_stride, float tm_value,
                  const float4* __restrict__ rows, int n_rays, int n_tris,
                  uint8_t* __restrict__ occ) {
  extern __shared__ float4 s_rows[];
  stage_rows(s_rows, rows, 3 * n_tris);
  __syncthreads();
  int r, lane;
  ray_lane(r, lane);
  int hit = 0;
  if (r < n_rays) {
    const float3 ro = load3(o, r);
    const float3 rd = load3(d, r);
    const float tm = t_max ? t_max[(long long)r * tm_stride] : tm_value;
    const float cap = tm * CULL_TCAP;
    for (int i = lane; i < n_tris; i += kLanes) {
      float t, u, v;
      if (sweep_test(ro, rd, s_rows + 3 * i, tm, cap, t, u, v)) {
        hit = 1;
        break;
      }
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) hit |= __shfl_xor_sync(kWarp, hit, m);
  if (r < n_rays && lane == 0) occ[r] = (uint8_t)hit;
}

// Raise the kernel's dynamic shared-memory limit where the table needs
// more than the default 48 KB; refuse a table no block can hold.
cudaError_t prepare(const void* fn, size_t smem) {
  if (smem > MAX_SMEM_BYTES) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

unsigned grid_of(int n_rays) {
  return (unsigned)(((long long)n_rays * kLanes + kBlock - 1) / kBlock);
}

}  // namespace

// Plain-C entry points (ctypes). Pointers are device pointers; o and d
// are (n, 3) row-major, rows is (T, 12) float32 rows [v0, . | e0, 0 |
// e1, 0], 16-byte aligned; best_i is int64, occ one byte (0/1) a ray.
// Return the CUDA error code of the launch (0 = launched).
extern "C" int closest_bruteforce(const float* o, const float* d, const float* rows,
                                  int n_rays, int n_tris, float* best_t, long long* best_i,
                                  void* stream) {
  const size_t smem = 48 * (size_t)n_tris;
  cudaError_t err = prepare((const void*)closest_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  closest_kernel<<<grid_of(n_rays), kBlock, smem, (cudaStream_t)stream>>>(
      o, d, reinterpret_cast<const float4*>(rows), n_rays, n_tris, best_t, best_i);
  return (int)cudaGetLastError();
}

extern "C" int anyhit_bruteforce(const float* o, const float* d, const float* t_max,
                                 int tm_stride, float tm_value, const float* rows,
                                 int n_rays, int n_tris, uint8_t* occ, void* stream) {
  const size_t smem = 48 * (size_t)n_tris;
  cudaError_t err = prepare((const void*)anyhit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  anyhit_kernel<<<grid_of(n_rays), kBlock, smem, (cudaStream_t)stream>>>(
      o, d, t_max, tm_stride, tm_value, reinterpret_cast<const float4*>(rows), n_rays,
      n_tris, occ);
  return (int)cudaGetLastError();
}

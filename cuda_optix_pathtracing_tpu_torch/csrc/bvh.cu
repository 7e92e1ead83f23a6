// BVH traversal kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel cuda_optix_pathtracing_tpu/ops/bvh_pallas.py
// _traverse_kernel (-> tile_traverse), launched by _call through
// pl.pallas_call in its "closest" and "any" modes:
//   bvh_closest <- "closest": (t, packed row) of the closest hit, BIG_T / 0
//                  on a miss
//   bvh_anyhit  <- "any": 1 where a triangle occludes T_MIN < t < t_max
// The traversal itself is bvh_trace in bvh.cuh (one thread per ray, its
// own stack, near-first by its own octant). The triangle test rounds as
// the plain sweep does (mt_test in common.cuh), so a hit's t is the plain
// version's t for the same row.
//
// What bounds it on the card: arithmetic, at the data's own work. A
// camera or bounce ray of the mesh Cornell box pops a few internal nodes
// (8 slab tests of ~22 flop each) and tests a few leaves (16 triangle
// tests of ~45 flop each), ~1-4 kflop against 32-36 bytes of ray and
// result: far above the H100's ~20 flop/byte FP32 ridge. The node and
// triangle tables (~1.1 MB at 16k triangles) are read many times but
// stay in L2. In practice divergence sets the time: the threads of a
// warp walk different paths through the tree and wait for each other,
// which ray sorting (ops/raysort.py) before the launch reduces.
//
// Design: one thread per ray, 128 threads a block, the stack in
// registers/local memory (64 entries of 8 bytes), tables read through the
// read-only cache. The HBM-streaming tier of the TPU kernel (leaf rows
// DMA'd into VMEM) has no counterpart: all tables are in device memory.
#include "bvh.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       BvhTables bt, int n, float* __restrict__ t_out,
                       int* __restrict__ i_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float t, u, v;
  int row = 0;
  bvh_trace<false>(bt, load3(o, r), load3(d, r), BIG_T, t, u, v, row);
  t_out[r] = t;
  i_out[r] = row;
}

__global__ void __launch_bounds__(kBlock)
    bvh_anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, BvhTables bt, int n,
                      int* __restrict__ occ) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float t, u, v;
  int row;
  occ[r] = bvh_trace<true>(bt, load3(o, r), load3(d, r), t_max[r], t, u, v, row) ? 1 : 0;
}

}  // namespace

// Plain-C entry points (ctypes). Device pointers: o, d (n, 3); box
// (M, 128) f32; meta (M * 16) i32; v0, e0, e1 (Tp, 3) in packed-BVH order;
// t_max (n,). Return the CUDA error code of the launch (0 = launched).
extern "C" int bvh_closest(const float* o, const float* d, const float* box,
                           const int* meta, const float* v0, const float* e0,
                           const float* e1, int n, float* t_out, int* i_out,
                           void* stream) {
  const BvhTables bt{box, meta, v0, e0, e1};
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_closest_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(o, d, bt, n, t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" int bvh_anyhit(const float* o, const float* d, const float* t_max,
                          const float* box, const int* meta, const float* v0,
                          const float* e0, const float* e1, int n, int* occ,
                          void* stream) {
  const BvhTables bt{box, meta, v0, e0, e1};
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_anyhit_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(o, d, t_max, bt, n, occ);
  return (int)cudaGetLastError();
}

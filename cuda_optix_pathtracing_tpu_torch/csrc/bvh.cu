// BVH traversal kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel cuda_optix_pathtracing_tpu/ops/bvh_pallas.py
// _traverse_kernel (-> tile_traverse), launched by _call through
// pl.pallas_call in its "closest" and "any" modes:
//   bvh_closest <- "closest": (t, packed row) of the closest hit, BIG_T / 0
//                  on a miss
//   bvh_anyhit  <- "any": 1 where a triangle occludes T_MIN < t < t_max
// The traversal is cbvh_trace in bvh_compact.cuh, the walk the fused
// kernels use, over the compact copy of the tree that every BVH scene
// carries (ops/bvh.py pack_nodes, pack_tri_rows): one thread per ray, its
// own 32 B stack of one entry per level, near-first by its own octant,
// leaves cut at their last real row. The triangle test rounds as the plain
// sweep does (mt_test in common.cuh), so a hit's t is the plain version's
// t for the same row, and t and rows are those of the reference's layout
// walked step for step (ops/bvh.py traverse_compact_ref gives
// traverse_packed_ref's).
//
// What bounds it on the card: table bytes at the mesh leg's launches
// (1,048,576 sorted rays, 432 nodes, 16k real triangles); a ray's own work
// is a few node expansions (8 slab tests of ~25 flop each) and 1-6
// triangle tests of ~45 flop. In practice divergence and the latency of
// dependent node and row loads set the time: the threads of a warp walk
// different paths through the tree and wait for each other, which ray
// sorting (ops/raysort.py) before the launch reduces.
//
// Design: one thread per ray and no persistent loop (each lane's work is
// one traversal, so regenerating rays would only add the counter's
// atomics), 128 threads a block. Nodes (256 B) and rows (48 B) are read
// through the read-only path; the kernels use no shared memory. The
// HBM-streaming tier of the TPU kernel (leaf rows DMA'd into VMEM) has no
// counterpart: all tables are in device memory.
#include "bvh_compact.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       CompactBvh bv, int n, float* __restrict__ t_out,
                       int* __restrict__ i_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float t, u, v;
  int row = 0;
  cbvh_trace<false>(bv, load3(o, r), load3(d, r), BIG_T, t, u, v, row);
  t_out[r] = t;
  i_out[r] = row;
}

__global__ void __launch_bounds__(kBlock)
    bvh_anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, CompactBvh bv, int n,
                      int* __restrict__ occ) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float t, u, v;
  int row;
  occ[r] = cbvh_trace<true>(bv, load3(o, r), load3(d, r), t_max[r], t, u, v, row) ? 1 : 0;
}

CompactBvh compact(const float* nodes, const float* rows) {
  return CompactBvh{reinterpret_cast<const float4*>(nodes),
                    reinterpret_cast<const float4*>(rows)};
}

}  // namespace

// Plain-C entry points (ctypes). Device pointers: o, d (n, 3); nodes
// (M, 64) compact nodes (ops/bvh.py pack_nodes, 16-byte aligned); rows
// (Tp, 12) f32 triangle rows in packed-BVH order (pack_tri_rows); t_max
// (n,). Return the CUDA error code of the launch (0 = launched).
extern "C" int bvh_closest(const float* o, const float* d, const float* nodes,
                           const float* rows, int n, float* t_out, int* i_out,
                           void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_closest_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(o, d, compact(nodes, rows),
                                                                n, t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" int bvh_anyhit(const float* o, const float* d, const float* t_max,
                          const float* nodes, const float* rows, int n, int* occ,
                          void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_anyhit_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(o, d, t_max,
                                                               compact(nodes, rows), n, occ);
  return (int)cudaGetLastError();
}

// Per-ray stack traversal of the packed 8-wide BVH (ops/bvh.py layout) for
// the traversal kernels (bvh.cu). The fused path-tracing kernels
// (megakernel.cu) walk the compact copy of the tree instead
// (bvh_compact.cuh).
//
// Computes what the TPU's tile_traverse (ops/bvh_pallas.py) computes: the
// closest hit T_MIN < t < t_cap over all triangles, or whether any
// triangle occludes the ray before t_max, with the same slab test
// (tn = max(..., T_MIN) <= tf = min(..., limit)) and reciprocal guard
// (1 / where(|d| < 1e-12, 1e-12, d)). What only a TPU needs is not carried
// over: the tile's shared stack and majority octant, the degenerate
// substitute rows, the DRAIN batching and the leaf stack. Each thread walks
// the tree for its own ray, as the reference CPU/CUDA renderers do.
//
// Stack entries are (slotword, tn): internal nodes and leaves alike. An
// internal node pushes its non-empty children that pass the slab test in
// the far-to-near order of the ray's own octant permcode, so pops come
// near-first, and a pop skips an entry whose tn exceeds the current limit
// (t_best for the closest hit, t_max for occlusion). A leaf tests its
// LEAF_SIZE rows, pad rows included (zero edges: det 0, no hit). Each pop
// of an internal node grows the stack by at most 7, so a tree of depth D
// needs 7 D + 1 entries; the wrappers refuse deeper trees.
//
// Nodes (box 512 B and meta 64 B per node) and triangles are read from
// global memory through the read-only path; the tables of a mesh scene
// (~0.9 MB of triangles at 16k triangles) sit in the 50 MB L2.
#pragma once

#include "common.cuh"

#define BVH_STACK 64  // ops/bvh.py STACK_SIZE
#define BVH_LEAF_ROWS 16  // ops/bvh.py LEAF_SIZE
#define BVH_CODE_EMPTY 0
#define BVH_CODE_LEAF 2
#define BVH_CODE_INTERNAL 1

struct BvhTables {
  const float* __restrict__ box;  // (M, 128) child slabs, comp-major
  const int* __restrict__ meta;   // (M * 16) slotwords | octant permcodes
  const float* __restrict__ v0;   // (Tp, 3) packed-BVH order
  const float* __restrict__ e0;
  const float* __restrict__ e1;
};

__device__ __forceinline__ float3 ldg3(const float* __restrict__ p, int i) {
  return f3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}

// ANY = false: closest hit with t < t_cap; returns true on a hit and writes
// t, u, v and the packed row. ANY = true: true when a triangle occludes the
// ray at T_MIN < t < t_cap (stops at the first one).
template <bool ANY>
__device__ bool bvh_trace(const BvhTables& bt, float3 o, float3 d,
                          float t_cap, float& t_out, float& u_out,
                          float& v_out, int& row_out) {
  const float tiny = 1e-12f;
  const float3 inv = f3(1.0f / (fabsf(d.x) < tiny ? tiny : d.x),
                        1.0f / (fabsf(d.y) < tiny ? tiny : d.y),
                        1.0f / (fabsf(d.z) < tiny ? tiny : d.z));
  const int oct = (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
  int st_w[BVH_STACK];
  float st_t[BVH_STACK];
  st_w[0] = (0 << 6) | BVH_CODE_INTERNAL;  // the root
  st_t[0] = 0.0f;
  int sp = 1;
  float tb = t_cap;  // closest: best t so far; any: t_max
  bool hit = false;
  while (sp > 0) {
    --sp;
    if (st_t[sp] > tb) continue;
    const int w = st_w[sp];
    const int payload = w >> 6;
    if ((w & 63) == BVH_CODE_LEAF) {
      const int base = payload * 8;
      for (int k = 0; k < BVH_LEAF_ROWS; ++k) {
        const int row = base + k;
        float t, u, v;
        if (mt_test(o, d, ldg3(bt.v0, row), ldg3(bt.e0, row), ldg3(bt.e1, row), tb, t, u, v)) {
          if (ANY) return true;
          tb = t;
          u_out = u;
          v_out = v;
          row_out = row;
          hit = true;
        }
      }
      continue;
    }
    // internal node: slab-test and push the children far-to-near
    const float* __restrict__ bx = bt.box + (size_t)payload * 128;
    const int* __restrict__ mt = bt.meta + payload * 16;
    const int pc = __ldg(mt + 8 + oct);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ch = (pc >> (3 * k)) & 7;
      const int wc = __ldg(mt + ch);
      if ((wc & 63) == BVH_CODE_EMPTY) continue;
      const float t0x = (__ldg(bx + ch) - o.x) * inv.x;
      const float t0y = (__ldg(bx + 8 + ch) - o.y) * inv.y;
      const float t0z = (__ldg(bx + 16 + ch) - o.z) * inv.z;
      const float t1x = (__ldg(bx + 24 + ch) - o.x) * inv.x;
      const float t1y = (__ldg(bx + 32 + ch) - o.y) * inv.y;
      const float t1z = (__ldg(bx + 40 + ch) - o.z) * inv.z;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), T_MIN));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), tb));
      if (tn <= tf) {
        st_w[sp] = wc;
        st_t[sp] = tn;
        ++sp;
      }
    }
  }
  t_out = tb;
  return hit;
}

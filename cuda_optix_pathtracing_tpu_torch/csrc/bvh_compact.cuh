// Per-ray traversal of the compact 8-wide BVH (ops/bvh.py pack_nodes,
// pack_tri_rows): the one BVH walk of the port's kernels, in the traversal
// kernels (bvh.cu) and the fused path-tracing kernels (megakernel.cu,
// BvhGeo).
//
// It computes what a per-ray stack walk of the reference's layout computes
// (ops/bvh.py traverse_packed_ref, the (M, 128) box rows and (M, 16) meta
// rows), with the same slab test, the same near-first visit order and the
// same culls, so t, u, v and the row are that walk's bit for bit (ops/bvh.py
// traverse_compact_ref, this walk's numpy oracle, gives
// traverse_packed_ref's). What differs is the layout and the stack, the
// two things that held that walk back on an H100 (512-544 B of stack and
// spills a thread):
//
// - A node is 256 B: 48 slab floats comp-major, 8 slot words, 8 octant
//   permcodes (the TPU lane padding of the (M, 128) box rows dropped). An
//   expansion reads 12 float4s of slabs and 2 of slot words and tests the
//   children four at a time, one axis after another, so few registers are
//   live at once. Nodes and rows are read through the read-only path: the
//   mesh leg's 432 nodes (110.6 KB) stay in L1. Staging them in shared
//   memory instead measured slower on an H100 80GB HBM3 at 700 W
//   (PERF.md), since it takes that room from L1, which the triangle rows
//   use.
// - The stack holds one 32-bit entry per level, (node << 8) | the mask of
//   the node's children not yet taken, in near-first order, instead of a
//   (slotword, tn) entry per child: 8 entries (32 B) walk a tree of depth
//   9, the depth a 64-entry stack of children allows. A child taken after
//   the limit may have shrunk is slab-tested again, which is the cull a
//   walk with stored tn makes (tn does not depend on the limit).
// - A leaf tests its rows up to its last real one (the row count sits in
//   the slot word's spare bits 2-5); the pad rows after it never hit.
//   Rows are [v0,0|e0,0|e1,0], three float4 loads.
#pragma once

#include "common.cuh"

#define CBVH_STACK 8       // ops/bvh.py COMPACT_STACK
#define CBVH_NODE_F4 16    // float4s per node (ops/bvh.py NODE_WORDS / 4)
#define CBVH_ROW_F4 3      // float4s per triangle row (ROW_WORDS / 4)
#define CBVH_SLOTS 48      // word offset of the slot words in a node
#define CBVH_PERMS 56      // word offset of the permcodes
#define CBVH_CODE_EMPTY 0
#define CBVH_CODE_LEAF 2

struct CompactBvh {
  const float4* __restrict__ nodes;  // (M, 16), read-only path
  const float4* __restrict__ rows;   // (Tp, 3), read-only path
};

__device__ __forceinline__ bool cbvh_slab(float lox, float loy, float loz, float hix,
                                          float hiy, float hiz, int word, float3 o,
                                          float3 inv, float limit) {
  const float t0x = (lox - o.x) * inv.x;
  const float t0y = (loy - o.y) * inv.y;
  const float t0z = (loz - o.z) * inv.z;
  const float t1x = (hix - o.x) * inv.x;
  const float t1y = (hiy - o.y) * inv.y;
  const float t1z = (hiz - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), T_MIN));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), limit));
  return (word & 3) != CBVH_CODE_EMPTY && tn <= tf;
}

// One axis of the slab test of 4 children at once: their slab ends lo, hi
// on this axis fold into tn (max of the near ends) and tf (min of the far
// ends). max and min of finite floats are exact in any order, so this is
// cbvh_slab's tn and tf.
__device__ __forceinline__ void cbvh_axis4(float4 lo, float4 hi, float o, float inv,
                                           float4& tn, float4& tf, bool first) {
  const float ax = (lo.x - o) * inv, ay = (lo.y - o) * inv, az = (lo.z - o) * inv,
              aw = (lo.w - o) * inv;
  const float bx = (hi.x - o) * inv, by = (hi.y - o) * inv, bz = (hi.z - o) * inv,
              bw = (hi.w - o) * inv;
  if (first) {
    tn = make_float4(fminf(ax, bx), fminf(ay, by), fminf(az, bz), fminf(aw, bw));
    tf = make_float4(fmaxf(ax, bx), fmaxf(ay, by), fmaxf(az, bz), fmaxf(aw, bw));
  } else {
    tn = make_float4(fmaxf(tn.x, fminf(ax, bx)), fmaxf(tn.y, fminf(ay, by)),
                     fmaxf(tn.z, fminf(az, bz)), fmaxf(tn.w, fminf(aw, bw)));
    tf = make_float4(fminf(tf.x, fmaxf(ax, bx)), fminf(tf.y, fmaxf(ay, by)),
                     fminf(tf.z, fmaxf(az, bz)), fminf(tf.w, fmaxf(aw, bw)));
  }
}

// The children of node nd that pass the slab test against limit, as a
// mask over the near-first positions of permcode pc (bit j: the j-th
// nearest child, slot (pc >> (21 - 3 j)) & 7).
__device__ __forceinline__ unsigned cbvh_expand(const float4* nd, int pc, float3 o,
                                                float3 inv, float limit) {
  unsigned by_slot = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 tn, tf;
    cbvh_axis4(__ldg(nd + h), __ldg(nd + 6 + h), o.x, inv.x, tn, tf, true);
    cbvh_axis4(__ldg(nd + 2 + h), __ldg(nd + 8 + h), o.y, inv.y, tn, tf, false);
    cbvh_axis4(__ldg(nd + 4 + h), __ldg(nd + 10 + h), o.z, inv.z, tn, tf, false);
    const int4 w = __ldg(reinterpret_cast<const int4*>(nd) + 12 + h);
    const unsigned m =
        ((w.x & 3) != CBVH_CODE_EMPTY && fmaxf(tn.x, T_MIN) <= fminf(tf.x, limit) ? 1u : 0u) |
        ((w.y & 3) != CBVH_CODE_EMPTY && fmaxf(tn.y, T_MIN) <= fminf(tf.y, limit) ? 2u : 0u) |
        ((w.z & 3) != CBVH_CODE_EMPTY && fmaxf(tn.z, T_MIN) <= fminf(tf.z, limit) ? 4u : 0u) |
        ((w.w & 3) != CBVH_CODE_EMPTY && fmaxf(tn.w, T_MIN) <= fminf(tf.w, limit) ? 8u : 0u);
    by_slot |= m << (4 * h);
  }
  unsigned mask = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) mask |= ((by_slot >> ((pc >> (21 - 3 * j)) & 7)) & 1u) << j;
  return mask;
}

// Test the rows [row, end) of a leaf against the ray; ANY: true at the
// first hit; closest: keeps the nearest in tb, u, v, row_out.
template <bool ANY>
__device__ __forceinline__ bool cbvh_leaf(const float4* __restrict__ rows, int row, int end,
                                          float3 o, float3 d, float& tb, float& u_out,
                                          float& v_out, int& row_out, bool& hit) {
  for (; row < end; ++row) {
    const float4* r = rows + (size_t)row * CBVH_ROW_F4;
    const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
    float t, u, v;
    if (mt_test(o, d, f3(a.x, a.y, a.z), f3(b.x, b.y, b.z), f3(c.x, c.y, c.z), tb, t, u, v)) {
      if (ANY) return true;
      tb = t;
      u_out = u;
      v_out = v;
      row_out = row;
      hit = true;
    }
  }
  return false;
}

// ANY = false: closest hit with t < t_cap; returns true on a hit and writes
// t, u, v and the packed row. ANY = true: true when a triangle occludes the
// ray at T_MIN < t < t_cap (stops at the first one).
template <bool ANY>
__device__ bool cbvh_trace(const CompactBvh& bv, float3 o, float3 d, float t_cap,
                           float& t_out, float& u_out, float& v_out, int& row_out) {
  const float tiny = 1e-12f;
  const float3 inv = f3(1.0f / (fabsf(d.x) < tiny ? tiny : d.x),
                        1.0f / (fabsf(d.y) < tiny ? tiny : d.y),
                        1.0f / (fabsf(d.z) < tiny ? tiny : d.z));
  const int oct = (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
  unsigned stack[CBVH_STACK];
  int sp = 0;
  float tb = t_cap;  // closest: best t so far; any: t_max
  bool hit = false;
  int node = 0;
  const float4* nd = bv.nodes;
  int pc = __ldg(reinterpret_cast<const int*>(nd) + CBVH_PERMS + oct);
  unsigned left = cbvh_expand(nd, pc, o, inv, tb);
  bool fresh = true;  // no child of this expansion taken yet: tb as tested
  while (true) {
    if (left == 0u) {
      if (sp == 0) break;
      const unsigned e = stack[--sp];
      node = (int)(e >> 8);
      left = e & 255u;
      nd = bv.nodes + (size_t)node * CBVH_NODE_F4;
      pc = __ldg(reinterpret_cast<const int*>(nd) + CBVH_PERMS + oct);
      fresh = false;
      continue;
    }
    const int j = __ffs(left) - 1;
    left &= left - 1u;
    const int ch = (pc >> (21 - 3 * j)) & 7;
    const int* nw = reinterpret_cast<const int*>(nd);
    const int w = __ldg(nw + CBVH_SLOTS + ch);
    if (!ANY && !fresh) {
      const float* f = reinterpret_cast<const float*>(nd);
      if (!cbvh_slab(__ldg(f + ch), __ldg(f + 8 + ch), __ldg(f + 16 + ch),
                     __ldg(f + 24 + ch), __ldg(f + 32 + ch), __ldg(f + 40 + ch), w, o,
                     inv, tb))
        continue;
    }
    fresh = false;
    if ((w & 3) == CBVH_CODE_LEAF) {
      const int base = (w >> 6) * 8;
      if (cbvh_leaf<ANY>(bv.rows, base, base + ((w >> 2) & 15) + 1, o, d, tb, u_out, v_out,
                         row_out, hit))
        return true;
      continue;
    }
    // internal: keep the rest of this node for later, descend near-first
    if (left) stack[sp++] = ((unsigned)node << 8) | left;
    node = w >> 6;
    nd = bv.nodes + (size_t)node * CBVH_NODE_F4;
    pc = __ldg(reinterpret_cast<const int*>(nd) + CBVH_PERMS + oct);
    left = cbvh_expand(nd, pc, o, inv, tb);
    fresh = true;
  }
  t_out = tb;
  return hit;
}

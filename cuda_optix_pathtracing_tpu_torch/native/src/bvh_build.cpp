// Host-side BVH build of the PyTorch port: binned-SAH binary build
// collapsed to an 8-wide tree, exported over a plain C interface (ctypes).
//
// The port's own copy of the BVH part of the reference's native runtime
// (cuda_optix_pathtracing_tpu/native/src/native.cpp: dtpt_bvh_build,
// dtpt_bvh_copy, dtpt_bvh_free), kept line for line so both packages
// build the same tree from the same triangles. Built by native/__init__.py
// with the reference's flags (g++ -O3 -march=native -shared -fPIC
// -std=c++17).
//
// Exported layout matches ops/bvh.py BVHArrays:
//   child_lo/child_hi (M,8,3) f32, child_node (M,8) i32,
//   child_leaf_start/count (M,8) i32, tri_order (T,) i32.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

static inline double area(const V3 &lo, const V3 &hi) {
  double dx = std::max(0.0f, hi.x - lo.x);
  double dy = std::max(0.0f, hi.y - lo.y);
  double dz = std::max(0.0f, hi.z - lo.z);
  return 2.0 * (dx * dy + dy * dz + dz * dx);
}

// Binary SAH node (pool-indexed; -1 children = leaf).
struct BNode {
  V3 lo, hi;
  int32_t left = -1, right = -1;
  int64_t start = -1;
  int32_t count = 0;
  bool is_leaf() const { return left < 0; }
};

struct Builder {
  const float *v0, *e0, *e1;
  int64_t T;
  int leaf_size, n_bins;
  std::vector<V3> tri_lo, tri_hi, cent;
  std::vector<int64_t> order, out_order;
  std::vector<BNode> pool;

  int32_t new_node() {
    pool.emplace_back();
    return (int32_t)pool.size() - 1;
  }

  // Iterative build over [start,end) of `order` (explicit work stack, as
  // the reference's buildRecursive does, core-bvh-builder.cpp:58-223).
  int32_t build(int64_t start0, int64_t end0) {
    struct Work {
      int64_t start, end;
      int32_t node;
    };
    int32_t root = new_node();
    std::vector<Work> stack{{start0, end0, root}};
    std::vector<int64_t> tmp;
    while (!stack.empty()) {
      Work w = stack.back();
      stack.pop_back();
      BNode &n = pool[w.node];
      V3 lo = tri_lo[order[w.start]], hi = tri_hi[order[w.start]];
      for (int64_t i = w.start + 1; i < w.end; ++i) {
        lo = vmin(lo, tri_lo[order[i]]);
        hi = vmax(hi, tri_hi[order[i]]);
      }
      n.lo = lo;
      n.hi = hi;
      int64_t count = w.end - w.start;
      if (count <= leaf_size) {
        n.start = w.start;
        n.count = (int32_t)count;
        std::memcpy(&out_order[w.start], &order[w.start],
                    count * sizeof(int64_t));
        continue;
      }
      V3 clo = cent[order[w.start]], chi = clo;
      for (int64_t i = w.start + 1; i < w.end; ++i) {
        clo = vmin(clo, cent[order[i]]);
        chi = vmax(chi, cent[order[i]]);
      }
      float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
      int axis = 0;
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;
      int64_t mid;
      if (ext[axis] < 1e-12f) {
        mid = w.start + count / 2;
      } else {
        // binned SAH (reference evaluateSAH, core-bvh-builder.cpp:14-47)
        const float cmin = axis == 0 ? clo.x : axis == 1 ? clo.y : clo.z;
        const float inv = (float)n_bins / ext[axis];
        std::vector<int32_t> bin_of(count);
        std::vector<int64_t> bin_n(n_bins, 0);
        std::vector<V3> bin_lo(n_bins, {INFINITY, INFINITY, INFINITY});
        std::vector<V3> bin_hi(n_bins, {-INFINITY, -INFINITY, -INFINITY});
        for (int64_t i = 0; i < count; ++i) {
          int64_t t = order[w.start + i];
          const V3 &c = cent[t];
          float cv = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
          int b = (int)((cv - cmin) * inv);
          b = std::min(std::max(b, 0), n_bins - 1);
          bin_of[i] = b;
          bin_n[b]++;
          bin_lo[b] = vmin(bin_lo[b], tri_lo[t]);
          bin_hi[b] = vmax(bin_hi[b], tri_hi[t]);
        }
        // prefix/suffix sweeps → O(bins) SAH evaluation
        std::vector<double> suf_a(n_bins + 1, 0.0);
        std::vector<int64_t> suf_n(n_bins + 1, 0);
        {
          V3 lo_s = {INFINITY, INFINITY, INFINITY};
          V3 hi_s = {-INFINITY, -INFINITY, -INFINITY};
          for (int b = n_bins - 1; b >= 0; --b) {
            if (bin_n[b]) {
              lo_s = vmin(lo_s, bin_lo[b]);
              hi_s = vmax(hi_s, bin_hi[b]);
            }
            suf_n[b] = suf_n[b + 1] + bin_n[b];
            suf_a[b] = suf_n[b] ? area(lo_s, hi_s) : 0.0;
          }
        }
        double best_cost = INFINITY;
        int best_bin = -1;
        {
          V3 lo_p = {INFINITY, INFINITY, INFINITY};
          V3 hi_p = {-INFINITY, -INFINITY, -INFINITY};
          int64_t n_p = 0;
          for (int b = 1; b < n_bins; ++b) {
            if (bin_n[b - 1]) {
              lo_p = vmin(lo_p, bin_lo[b - 1]);
              hi_p = vmax(hi_p, bin_hi[b - 1]);
            }
            n_p += bin_n[b - 1];
            int64_t n_r = suf_n[b];
            if (n_p == 0 || n_r == 0) continue;
            double cost = area(lo_p, hi_p) * (double)n_p + suf_a[b] * (double)n_r;
            if (cost < best_cost) {
              best_cost = cost;
              best_bin = b;
            }
          }
        }
        if (best_bin < 0) {
          mid = w.start + count / 2;
        } else {
          tmp.resize(count);
          int64_t nl = 0, nr = count;
          for (int64_t i = 0; i < count; ++i)
            if (bin_of[i] < best_bin) tmp[nl++] = order[w.start + i];
          nr = nl;
          for (int64_t i = 0; i < count; ++i)
            if (bin_of[i] >= best_bin) tmp[nr++] = order[w.start + i];
          std::memcpy(&order[w.start], tmp.data(), count * sizeof(int64_t));
          mid = w.start + nl;
          if (mid == w.start || mid == w.end) mid = w.start + count / 2;
        }
      }
      int32_t li = new_node(), ri = new_node();
      pool[w.node].left = li;  // n may be dangling after new_node
      pool[w.node].right = ri;
      stack.push_back({w.start, mid, li});
      stack.push_back({mid, w.end, ri});
    }
    return root;
  }
};

// 8-wide emitted node row.
struct WideRow {
  float lo[8][3], hi[8][3];
  int32_t node[8], lstart[8], lcount[8];
};

struct WideOut {
  std::vector<WideRow> rows;
  std::vector<int64_t> tri_order;
};

static void collapse8(const std::vector<BNode> &pool, int32_t id,
                      int32_t out[8], int &n_out) {
  // Greedy: split the internal child with the largest surface area
  // (ops/bvh.py _collapse8 parity).
  int32_t kids[8];
  int n = 2;
  kids[0] = pool[id].left;
  kids[1] = pool[id].right;
  while (n < 8) {
    int best = -1;
    double besta = -1.0;
    for (int i = 0; i < n; ++i) {
      const BNode &k = pool[kids[i]];
      if (!k.is_leaf()) {
        double a = area(k.lo, k.hi) * 0.5;  // relative ordering only
        if (a > besta) {
          besta = a;
          best = i;
        }
      }
    }
    if (best < 0) break;
    int32_t k = kids[best];
    // pop preserving order (match Python list.pop + extend-at-end)
    for (int i = best; i < n - 1; ++i) kids[i] = kids[i + 1];
    --n;
    kids[n++] = pool[k].left;
    kids[n++] = pool[k].right;
  }
  for (int i = 0; i < n; ++i) out[i] = kids[i];
  n_out = n;
}

static int32_t emit(const std::vector<BNode> &pool, int32_t id, WideOut &w) {
  int32_t kids[8];
  int n_kids;
  collapse8(pool, id, kids, n_kids);
  int32_t row = (int32_t)w.rows.size();
  w.rows.emplace_back();
  {
    WideRow &r = w.rows[row];
    for (int i = 0; i < 8; ++i) {
      r.lo[i][0] = r.lo[i][1] = r.lo[i][2] = INFINITY;
      r.hi[i][0] = r.hi[i][1] = r.hi[i][2] = -INFINITY;
      r.node[i] = 0;
      r.lstart[i] = 0;
      r.lcount[i] = -1;
    }
  }
  for (int i = 0; i < n_kids; ++i) {
    const BNode &k = pool[kids[i]];
    // (re-fetch the row pointer each child: recursion may reallocate)
    w.rows[row].lo[i][0] = k.lo.x;
    w.rows[row].lo[i][1] = k.lo.y;
    w.rows[row].lo[i][2] = k.lo.z;
    w.rows[row].hi[i][0] = k.hi.x;
    w.rows[row].hi[i][1] = k.hi.y;
    w.rows[row].hi[i][2] = k.hi.z;
    if (k.is_leaf()) {
      w.rows[row].lstart[i] = (int32_t)k.start;
      w.rows[row].lcount[i] = k.count;
    } else {
      w.rows[row].lcount[i] = 0;
      int32_t child_row = emit(pool, kids[i], w);
      w.rows[row].node[i] = child_row;
    }
  }
  return row;
}

struct BvhHandle {
  WideOut wide;
};

}  // namespace

extern "C" {

// Build a BVH over T triangles given as v0/e0/e1 (T,3) row-major f32.
// Returns an opaque handle; *out_n_nodes receives the 8-wide node count.
void *dtpt_bvh_build(const float *v0, const float *e0, const float *e1,
                     int64_t T, int32_t leaf_size, int32_t n_bins,
                     int64_t *out_n_nodes) {
  Builder b;
  b.v0 = v0;
  b.e0 = e0;
  b.e1 = e1;
  b.T = T;
  b.leaf_size = leaf_size;
  b.n_bins = n_bins;
  b.tri_lo.resize(T);
  b.tri_hi.resize(T);
  b.cent.resize(T);
  for (int64_t t = 0; t < T; ++t) {
    V3 a = {v0[3 * t], v0[3 * t + 1], v0[3 * t + 2]};
    V3 p1 = {a.x + e0[3 * t], a.y + e0[3 * t + 1], a.z + e0[3 * t + 2]};
    V3 p2 = {a.x + e1[3 * t], a.y + e1[3 * t + 1], a.z + e1[3 * t + 2]};
    b.tri_lo[t] = vmin(vmin(a, p1), p2);
    b.tri_hi[t] = vmax(vmax(a, p1), p2);
    b.cent[t] = {(b.tri_lo[t].x + b.tri_hi[t].x) * 0.5f,
                 (b.tri_lo[t].y + b.tri_hi[t].y) * 0.5f,
                 (b.tri_lo[t].z + b.tri_hi[t].z) * 0.5f};
  }
  b.order.resize(T);
  b.out_order.resize(T);
  for (int64_t i = 0; i < T; ++i) b.order[i] = i;
  int32_t root = b.build(0, T);

  auto *h = new BvhHandle();
  if (b.pool[root].is_leaf()) {
    // single-leaf scene: one row whose child 0 is the leaf
    h->wide.rows.emplace_back();
    WideRow &r = h->wide.rows[0];
    for (int i = 0; i < 8; ++i) {
      r.lo[i][0] = r.lo[i][1] = r.lo[i][2] = INFINITY;
      r.hi[i][0] = r.hi[i][1] = r.hi[i][2] = -INFINITY;
      r.node[i] = 0;
      r.lstart[i] = 0;
      r.lcount[i] = -1;
    }
    const BNode &n = b.pool[root];
    r.lo[0][0] = n.lo.x;
    r.lo[0][1] = n.lo.y;
    r.lo[0][2] = n.lo.z;
    r.hi[0][0] = n.hi.x;
    r.hi[0][1] = n.hi.y;
    r.hi[0][2] = n.hi.z;
    r.lstart[0] = (int32_t)n.start;
    r.lcount[0] = n.count;
  } else {
    emit(b.pool, root, h->wide);
  }
  h->wide.tri_order = std::move(b.out_order);
  *out_n_nodes = (int64_t)h->wide.rows.size();
  return h;
}

// Copy the built arrays into caller-allocated buffers, then free with
// dtpt_bvh_free. Shapes: child_lo/hi (M,8,3), node/lstart/lcount (M,8),
// tri_order (T,).
void dtpt_bvh_copy(void *handle, float *child_lo, float *child_hi,
                   int32_t *child_node, int32_t *leaf_start,
                   int32_t *leaf_count, int32_t *tri_order) {
  auto *h = (BvhHandle *)handle;
  int64_t M = (int64_t)h->wide.rows.size();
  for (int64_t m = 0; m < M; ++m) {
    const WideRow &r = h->wide.rows[m];
    std::memcpy(child_lo + m * 24, r.lo, 24 * sizeof(float));
    std::memcpy(child_hi + m * 24, r.hi, 24 * sizeof(float));
    std::memcpy(child_node + m * 8, r.node, 8 * sizeof(int32_t));
    std::memcpy(leaf_start + m * 8, r.lstart, 8 * sizeof(int32_t));
    std::memcpy(leaf_count + m * 8, r.lcount, 8 * sizeof(int32_t));
  }
  for (size_t i = 0; i < h->wide.tri_order.size(); ++i)
    tri_order[i] = (int32_t)h->wide.tri_order[i];
}

void dtpt_bvh_free(void *handle) { delete (BvhHandle *)handle; }

}  // extern "C"

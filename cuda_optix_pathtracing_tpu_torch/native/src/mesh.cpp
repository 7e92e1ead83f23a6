// Host-side mesh attributes of the port: per-corner smooth normals and
// affine transforms of triangle soups (counterparts of the reference's
// dtpt_smooth_normals and dtpt_transform_tris, with the same arithmetic
// in the same order, so that world-space triangles and normals agree).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

}  // namespace

extern "C" {

// Per-corner smooth shading normals of a (T,3,3) soup: weld identical
// positions, accumulate area-weighted face normals per welded vertex, and
// per corner include only faces within `crease_deg` of the corner's own
// face. out: (T,3,3) unit normals.
void dtpt_smooth_normals(const float *tris, int64_t T, float crease_deg,
                         float *out) {
  struct Key {
    float x, y, z;
    bool operator==(const Key &o) const {
      return x == o.x && y == o.y && z == o.z;
    }
  };
  struct KeyHash {
    size_t operator()(const Key &k) const {
      uint32_t a, b, c;
      std::memcpy(&a, &k.x, 4);
      std::memcpy(&b, &k.y, 4);
      std::memcpy(&c, &k.z, 4);
      size_t h = a * 0x9E3779B1u;
      h = (h ^ b) * 0x85EBCA77u;
      h = (h ^ c) * 0xC2B2AE3Du;
      return h;
    }
  };
  std::unordered_map<Key, int32_t, KeyHash> weld;
  weld.reserve(T * 2);
  std::vector<int32_t> corner_v(T * 3);
  std::vector<V3> face_n(T);   // area-weighted
  std::vector<V3> face_nn(T);  // unit
  for (int64_t t = 0; t < T; ++t) {
    const float *p = tris + 9 * t;
    V3 a = {p[0], p[1], p[2]}, b = {p[3], p[4], p[5]}, c = {p[6], p[7], p[8]};
    V3 e0 = {b.x - a.x, b.y - a.y, b.z - a.z};
    V3 e1 = {c.x - a.x, c.y - a.y, c.z - a.z};
    V3 n = {e0.y * e1.z - e0.z * e1.y, e0.z * e1.x - e0.x * e1.z,
            e0.x * e1.y - e0.y * e1.x};
    face_n[t] = n;
    float l = std::sqrt(n.x * n.x + n.y * n.y + n.z * n.z);
    face_nn[t] = l > 0 ? V3{n.x / l, n.y / l, n.z / l} : V3{0, 0, 1};
    for (int k = 0; k < 3; ++k) {
      Key key = {p[3 * k], p[3 * k + 1], p[3 * k + 2]};
      auto it = weld.find(key);
      int32_t vid;
      if (it == weld.end()) {
        vid = (int32_t)weld.size();
        weld.emplace(key, vid);
      } else {
        vid = it->second;
      }
      corner_v[3 * t + k] = vid;
    }
  }
  // incident faces of each welded vertex (CSR)
  int64_t V = (int64_t)weld.size();
  std::vector<int32_t> deg(V, 0);
  for (int64_t i = 0; i < T * 3; ++i) deg[corner_v[i]]++;
  std::vector<int64_t> off(V + 1, 0);
  for (int64_t v = 0; v < V; ++v) off[v + 1] = off[v] + deg[v];
  std::vector<int32_t> inc(T * 3);
  std::vector<int64_t> cur(off.begin(), off.end() - 1);
  for (int64_t t = 0; t < T; ++t)
    for (int k = 0; k < 3; ++k) inc[cur[corner_v[3 * t + k]]++] = (int32_t)t;
  float cos_crease = std::cos(crease_deg * 3.14159265358979f / 180.0f);
  for (int64_t t = 0; t < T; ++t) {
    for (int k = 0; k < 3; ++k) {
      int32_t v = corner_v[3 * t + k];
      V3 acc = {0, 0, 0};
      const V3 &fn = face_nn[t];
      for (int64_t j = off[v]; j < off[v + 1]; ++j) {
        int32_t g = inc[j];
        const V3 &gn = face_nn[g];
        if (fn.x * gn.x + fn.y * gn.y + fn.z * gn.z >= cos_crease) {
          acc.x += face_n[g].x;
          acc.y += face_n[g].y;
          acc.z += face_n[g].z;
        }
      }
      float l = std::sqrt(acc.x * acc.x + acc.y * acc.y + acc.z * acc.z);
      V3 o = l > 1e-20f ? V3{acc.x / l, acc.y / l, acc.z / l} : face_nn[t];
      out[9 * t + 3 * k] = o.x;
      out[9 * t + 3 * k + 1] = o.y;
      out[9 * t + 3 * k + 2] = o.z;
    }
  }
}

// (T,3,3) soup times a row-major (4,4) affine matrix, one f32 mul-add
// chain per output coordinate: m[r,0]·x + m[r,1]·y + m[r,2]·z + m[r,3].
void dtpt_transform_tris(const float *tris, int64_t T, const float *m,
                         float *out) {
  for (int64_t i = 0; i < T * 3; ++i) {
    const float *p = tris + 3 * i;
    for (int r = 0; r < 3; ++r)
      out[3 * i + r] =
          m[4 * r] * p[0] + m[4 * r + 1] * p[1] + m[4 * r + 2] * p[2] + m[4 * r + 3];
  }
}

}  // extern "C"

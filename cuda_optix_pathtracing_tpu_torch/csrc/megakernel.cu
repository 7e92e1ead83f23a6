// Path-tracing kernels for Hopper (sm_90a): the fused whole-path kernel in
// brute-force and BVH modes, and the single-bounce kernel of the
// depth-sorted wavefront.
//
// Replaces the TPU kernel cuda_optix_pathtracing_tpu/models/megakernel_pallas.py
// _pt_kernel, launched through pl.pallas_call:
// - pt_fused_bruteforce <- trace_paths_fused, use_bvh=False (the call at
//   megakernel_pallas.py:1574): pt_fused_kernel<BruteGeo, Smp>;
//   pt_fused_bvh <- use_bvh=True (:1552, tile_traverse "attrs" and "any"
//   inside): pt_fused_bvh_kernel<Smp>. The geometry policy (BruteGeo,
//   BvhGeo) answers the closest hit and the shadow query, the sampler
//   policy (HashRng; HaltonRng for sampler="halton", halton_1d:309) the
//   random numbers.
// - pt_bounce_bvh <- trace_paths_fused_sorted, single-depth mode (depth0,
//   the call at :1725): one bounce per launch over a path state of one row
//   per path, so the host can re-sort paths between depths.
// All run the same bounce() below. It computes the estimator of the plain
// PyTorch integrator (models/megakernel.py bounce_step, the XLA
// integrator's twin): Moller-Trumbore closest hit, material fetch,
// Oren-Nayar multiscatter / Lambert / GGX dielectric (reflection,
// transmission, anisotropy, delta) / GGX conductor with the Kulla-Conty
// E/Eavg polynomials, NEE to point / spot / area lights with a shadow
// any-hit and power-heuristic MIS, emitter-hit MIS through the previous
// bounce's pdf, Russian roulette from rr_start_depth and the constant
// environment on a miss. Random numbers are bit-identical to ops/rng.py:
// pcg4d keyed (px, py, sample ^ seed, depth * 24 + dim), or Owen-scrambled
// Halton for the dimensions below qmc_dims.
//
// What bounds the whole-path kernel on the card (brute force): at its
// data's own work, arithmetic. A path reads 36 bytes and writes 12, and
// does ~(T * 90 + 800) flops per bounce (two triangle sweeps and the
// shading), ~22 kflop for the Cornell box at depth 5. In practice latency:
// the main path launches 65,536 paths, one wave of about 4 warps per
// scheduler, too few to hide the dependent chains of a sweep and of the
// shading, and a warp lasts as long as its longest path. The closest-hit
// sweeps take about 30 % of the time, the shading most of the rest; a
// launch of 1,048,576 paths costs only 10 % less per path (PERF.md). The
// Halton sampler adds integer work at depth 0 only (qmc_dims = 12 < 24
// dims per bounce): ~70 digit steps per path.
//
// Design: one thread per path, the whole depth loop in registers, as the
// reference CUDA renderer's megakernel does. The triangle, material,
// light and emissive tables are staged once per block into dynamic shared
// memory from a blob built once per scene, where every thread of a warp
// reads the same row (a broadcast). The E/Eavg polynomial coefficients
// travel in the same table. A finished path leaves the loop at once
// instead of running masked bounces, and a shadow ray is traced only when
// its contribution is non-zero. The sweeps (BruteGeo) read 48 B rows as
// three 16-byte loads and reject a triangle before the division where the
// division could not accept it (a warp whose lanes all reject skips it).
// The TPU kernel's lane tiles, SMEM scalar streaming and second "fetch"
// sweep are not carried over; the winner's barycentrics are kept during
// the sweep instead.
//
// BVH mode: the closest hit and the shadow ray walk the compact 8-wide BVH
// per thread (cbvh_trace in bvh_compact.cuh: 256 B nodes, a 32 B stack of
// one entry per level, leaves cut at their last real row), both read
// through the read-only path: the mesh leg's 432 nodes (110.6 KB) stay in
// L1, the (Tp, 12) triangle rows (1.1 MB at 16k triangles) in L2. Only
// the shading tables go to shared memory. The winner's (u, v) come from the
// traversal, its vertices from its row and its material from tri_mat,
// which is what the TPU kernel's "attrs" mode gathers during its sweep.
// Bound by arithmetic at the data's own work (node expansions and leaf
// tests per bounce). Paths end at different depths (3.4 bounces of 5 on
// the mesh leg), so a warp of one path per thread idles a third of its
// lanes; the kernel regenerates paths instead: persistent blocks whose
// lanes take a new path index from a counter as soon as theirs ends.
//
// The single-bounce kernel answers the divergence of decohered paths the
// wavefront way: it writes each path's sort key (direction octant, origin
// Morton code) for the next depth, the host sorts the keys, and the next
// launch runs the paths in that order through the permutation, so a
// warp's paths start near each other and head the same way. The state
// stays in slot order, one 96 B row per path, read and written in place:
// a live path reads 80 B and writes 68 B and its key, against ~1.7 kflop
// of traversal and shading per bounce, so bytes bound it at depth 0 on the
// mesh Cornell box. A dead path reads its flag and writes its key.
#include <cooperative_groups.h>

#include "bvh_compact.cuh"

#define INV_PI_F 0.318309886183790671538f
#define DELTA_ALPHA 1e-3f
#define THROUGHPUT_EPS 1e-6f
#define DIMS_PER_BOUNCE 24u
#define GAMMA7 4.172326840e-07f  // float32 7 eps / (1 - 7 eps), eps = 2^-24

// material ids (ops/bsdf.py) and light types (ops/lights.py)
#define OREN_NAYAR 0
#define GGX_DIELECTRIC 1
#define GGX_CONDUCTOR 2
#define LAMBERT 3
#define SPOT 1
#define AREA 4

// table row widths (models/megakernel_cuda.py packs them)
#define MAT_W 24
#define LIGHT_W 13
#define EM_W 15

// E(cos, alpha^2) tensor-product and Eavg(alpha^2) polynomial coefficients
#define E_DEG 6
#define EPOLY_N ((E_DEG + 1) * (E_DEG + 1) + (E_DEG + 1))

namespace {

// The brute-force kernel: 128 threads a block and at most 128 registers a
// thread (four blocks, 16 warps, per SM), so the main path's launch of
// 65,536 paths (512 blocks) fits the card in one wave.
constexpr int kBlock = 128;
constexpr int kMinBlocks = 4;

// ---------------------------------------------------------------------------
// RNG (ops/rng.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 pcg4d(uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  uint32_t x = a * 1664525u + 1013904223u;
  uint32_t y = b * 1664525u + 1013904223u;
  uint32_t z = c * 1664525u + 1013904223u;
  uint32_t w = d * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  return make_uint4(x, y, z, w);
}

__device__ __forceinline__ float u01(uint32_t u) {
  return (float)(u >> 8) * 5.9604645e-08f;
}

__device__ __forceinline__ uint32_t pcg_hash(uint32_t seed) {
  const uint32_t state = seed * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

// Owen-scrambled Halton (ops/rng.py halton_owen_sample): dimension dim uses
// base kPrimes[dim % 32], scrambled per pixel by pcg4d(px, py, dim, seed).
// Base 2 is the Laine-Karras permutation of the index, bit-reversed; an
// odd base permutes digit k to (digit + h) % base, h a hash of the digit
// prefix. The digit weight starts at and advances by float32(1 / base)
// (kInvPrimes, rounded from double as the plain version's constant is),
// and the accumulate rounds the product and the sum apart, never
// contracted into an FMA, so the value is bit-equal to the plain version.
__constant__ uint32_t kPrimes[32] = {2,  3,  5,  7,  11, 13, 17, 19, 23, 29, 31,
                                     37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79,
                                     83, 89, 97, 101, 103, 107, 109, 113, 127, 131};
#define INV(p) (float)(1.0 / (p))
__constant__ float kInvPrimes[32] = {
    INV(2),  INV(3),  INV(5),  INV(7),   INV(11),  INV(13),  INV(17),  INV(19),
    INV(23), INV(29), INV(31), INV(37),  INV(41),  INV(43),  INV(47),  INV(53),
    INV(59), INV(61), INV(67), INV(71),  INV(73),  INV(79),  INV(83),  INV(89),
    INV(97), INV(101), INV(103), INV(107), INV(109), INV(113), INV(127), INV(131)};
#undef INV

__device__ __noinline__ float halton_owen(uint32_t px, uint32_t py, uint32_t sample,
                                          uint32_t dim, uint32_t seed) {
  const uint32_t pixel_seed = pcg4d(px, py, dim, seed).x;
  const uint32_t base = kPrimes[dim % 32u];
  if (base == 2u) {
    uint32_t x = sample + pixel_seed;
    x ^= x * 0x6C50B47Cu;
    x ^= x * 0xB82F1E52u;
    x ^= x * 0xC7AFE638u;
    x ^= x * 0x8D22F6E6u;
    return u01(__brev(x));
  }
  const int n_digits = base == 3u ? 20 : base == 5u ? 14 : base == 7u ? 12
                     : base == 11u ? 10 : base == 13u ? 9 : 8;
  const float inv_base = kInvPrimes[dim % 32u];
  uint32_t idx = sample, prefix = 0u;
  float value = 0.0f, inv_mult = inv_base;
  for (int k = 0; k < n_digits; ++k) {
    const uint32_t quot = idx / base;
    const uint32_t digit = idx - quot * base;
    const uint32_t h = pcg_hash(prefix * 0x9E3779B9u ^ pixel_seed);
    const uint32_t sdigit = (digit + h) % base;
    value = __fadd_rn(value, __fmul_rn(__uint2float_rn(sdigit), inv_mult));
    prefix = prefix * base + digit + 1u;
    idx = quot;
    inv_mult = __fmul_rn(inv_mult, inv_base);
  }
  return fminf(value, (float)(1.0 - 1e-7));
}

// The samplers, keyed (px, py, sample, dim) with the seed (ops/rng.py
// Sampler). The hash keys pcg4d on sample ^ seed; Halton serves the
// dimensions below qmc_dims (a 2-D request needs both) and the hash the
// rest.
struct HashRng {
  uint32_t px, py, ss;
  __device__ HashRng(uint32_t px_, uint32_t py_, uint32_t sample, uint32_t seed, int)
      : px(px_), py(py_), ss(sample ^ seed) {}
  __device__ float u1(uint32_t dim) const { return u01(pcg4d(px, py, ss, dim).x); }
  __device__ float2 u2(uint32_t dim) const {
    const uint4 h = pcg4d(px, py, ss, dim);
    return make_float2(u01(h.x), u01(h.y));
  }
};

struct HaltonRng {
  HashRng hash;
  uint32_t sample, seed, qmc_dims;
  __device__ HaltonRng(uint32_t px_, uint32_t py_, uint32_t sample_, uint32_t seed_,
                       int qmc_dims_)
      : hash(px_, py_, sample_, seed_, 0), sample(sample_), seed(seed_),
        qmc_dims((uint32_t)qmc_dims_) {}
  __device__ float u1(uint32_t dim) const {
    return dim < qmc_dims ? halton_owen(hash.px, hash.py, sample, dim, seed) : hash.u1(dim);
  }
  __device__ float2 u2(uint32_t dim) const {
    if (dim + 1u < qmc_dims)
      return make_float2(halton_owen(hash.px, hash.py, sample, dim, seed),
                         halton_owen(hash.px, hash.py, sample, dim + 1u, seed));
    return hash.u2(dim);
  }
};

// ---------------------------------------------------------------------------
// vector math (ops/vecmath.py, ops/sampling.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sqr(float x) { return x * x; }
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(fmaxf(x, 0.0f)); }
__device__ __forceinline__ float avg3(float3 v) { return (v.x + v.y + v.z) / 3.0f; }
__device__ __forceinline__ float max3(float3 v) { return fmaxf(fmaxf(v.x, v.y), v.z); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// exact 1/sqrt (IEEE sqrt and division), as the plain version's rsqrt
__device__ __forceinline__ float3 normalize3(float3 v) {
  const float l2 = dot3(v, v);
  return l2 > 0.0f ? v * (1.0f / sqrtf(fmaxf(l2, 1e-38f))) : f3(0.f, 0.f, 0.f);
}

__device__ __forceinline__ void gram_schmidt(float3 n, float3& t, float3& b) {
  const bool near_diag = fabsf(n.x - n.y) <= 1e-3f && fabsf(n.x - n.z) <= 1e-3f;
  const float3 a = f3(n.z - n.y, near_diag ? n.x + n.z : n.x - n.z,
                      near_diag ? -n.y - n.x : n.y - n.x);
  t = normalize3(a);
  b = cross3(n, t);
}

__device__ __forceinline__ float2 sample_uniform_disk(float u1, float u2) {
  const float a = 2.0f * u1 - 1.0f;
  const float b = 2.0f * u2 - 1.0f;
  const bool a_dom = fabsf(a) > fabsf(b);
  const float rho = a_dom ? a : b;
  const float ratio = a_dom ? b / (a == 0.0f ? 1.0f : a) : a / (b == 0.0f ? 1.0f : b);
  const float phi = a_dom ? (float)(M_PI / 4.0) * ratio
                          : (float)(M_PI / 2.0) - (float)(M_PI / 4.0) * ratio;
  if (a == 0.0f && b == 0.0f) return make_float2(0.0f, 0.0f);
  return make_float2(rho * cosf(phi), rho * sinf(phi));
}

__device__ __forceinline__ float3 sample_cos_hemisphere(float3 n, float u1,
                                                        float u2, float& pdf) {
  const float2 xy = sample_uniform_disk(u1, u2);
  const float cos_theta = safe_sqrt(1.0f - (xy.x * xy.x + xy.y * xy.y));
  float3 t, b;
  gram_schmidt(n, t, b);
  pdf = cos_theta * INV_PI_F;
  return xy.x * t + xy.y * b + cos_theta * n;
}

__device__ __forceinline__ float3 sample_uniform_cone(float3 n, float omc,
                                                      float u1, float u2,
                                                      float& cos_theta,
                                                      float& pdf, bool& delta) {
  const float2 xy = sample_uniform_disk(u1, u2);
  const float r2 = xy.x * xy.x + xy.y * xy.y;
  const bool cone = omc > 0.0f;
  cos_theta = cone ? 1.0f - r2 * omc : 1.0f;
  const float scale = safe_sqrt(r2 * omc * (2.0f - r2 * omc));
  pdf = cone ? 0.5f / ((float)M_PI * fmaxf(omc, 1e-8f)) : 1.0f;
  delta = !cone;
  if (!cone) return n;
  float3 t, b;
  gram_schmidt(n, t, b);
  return (xy.x * scale) * t + (xy.y * scale) * b + cos_theta * n;
}

__device__ __forceinline__ float sin_sqr_to_one_minus_cos(float s_sq) {
  return s_sq > 0.0004f ? 1.0f - safe_sqrt(1.0f - s_sq) : 0.5f * s_sq;
}

__device__ __forceinline__ float smoothstep(float a, float b, float x) {
  const float t = clamp01((x - a) / (b - a));
  return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ float3 offset_ray_origin(float3 p, float3 err,
                                                    float3 ng, float3 w) {
  const float dm = fabsf(ng.x) * err.x + fabsf(ng.y) * err.y + fabsf(ng.z) * err.z;
  float3 off = ng * dm;
  if (dot3(w, ng) < 0.0f) off = -off;
  const float3 po = p + off;
  return f3(nextafterf(po.x, off.x > 0.0f ? INFINITY : -INFINITY),
            nextafterf(po.y, off.y > 0.0f ? INFINITY : -INFINITY),
            nextafterf(po.z, off.z > 0.0f ? INFINITY : -INFINITY));
}

// ---------------------------------------------------------------------------
// materials (ops/bsdf.py)
// ---------------------------------------------------------------------------

struct Mat {
  int type;
  float3 albedo;
  float sigma, ax, ay, phi0, eta;
  float3 refl, trans, ceta, ck, emission;
};

__device__ __forceinline__ float3 row3(const float* r) { return f3(r[0], r[1], r[2]); }

__device__ __forceinline__ Mat load_mat(const float* r) {
  Mat m;
  m.type = (int)r[0];
  m.albedo = row3(r + 1);
  m.sigma = r[4];
  m.ax = r[5];
  m.ay = r[6];
  m.phi0 = r[7];
  m.eta = r[8];
  m.refl = row3(r + 9);
  m.trans = row3(r + 12);
  m.ceta = row3(r + 15);
  m.ck = row3(r + 18);
  m.emission = row3(r + 21);
  return m;
}

__device__ __forceinline__ float ggx_lambda_tan(float s) {
  return 0.5f * (sqrtf(1.0f + s) - 1.0f);
}
__device__ __forceinline__ float ggx_d(float alpha2, float cos_nh) {
  const float c2 = fminf(sqr(cos_nh), 1.0f);
  return alpha2 / ((float)M_PI * sqr((1.0f - c2) + alpha2 * c2));
}
__device__ __forceinline__ float ggx_lambda(float alpha2, float cos_n) {
  return ggx_lambda_tan(alpha2 * fmaxf(1.0f / fmaxf(sqr(cos_n), 1e-12f) - 1.0f, 0.0f));
}
__device__ __forceinline__ float ggx_aniso_d(float ax, float ay, float3 h) {
  const float hx = h.x / ax, hy = h.y / ay;
  const float len2 = hx * hx + hy * hy + h.z * h.z;
  return INV_PI_F / fmaxf(ax * ay * sqr(len2), 1e-20f);
}
__device__ __forceinline__ float ggx_aniso_lambda(float ax, float ay, float3 v) {
  return ggx_lambda_tan((sqr(ax * v.x) + sqr(ay * v.y)) / fmaxf(sqr(v.z), 1e-12f));
}

__device__ float3 sample_ggx_vndf(float3 lo, float u1, float u2, float ax, float ay) {
  const float3 v = normalize3(f3(ax * lo.x, ay * lo.y, lo.z));
  const float lensq = sqr(v.x) + sqr(v.y);
  const float inv_len = 1.0f / sqrtf(fmaxf(lensq, 1e-14f));
  const bool use_frame = lensq > 1e-7f;
  const float3 t1 = use_frame ? f3(-v.y * inv_len, v.x * inv_len, 0.0f) : f3(1.f, 0.f, 0.f);
  const float3 t2 = use_frame ? cross3(v, t1) : f3(0.f, 1.f, 0.f);
  const float2 dd = sample_uniform_disk(u1, u2);
  const float tt = 0.5f * (1.0f + v.z);
  const float dy = safe_sqrt(1.0f - sqr(dd.x)) * (1.0f - tt) + dd.y * tt;
  const float3 nh = dd.x * t1 + dy * t2 + safe_sqrt(1.0f - sqr(dd.x) - sqr(dy)) * v;
  return normalize3(f3(ax * nh.x, ay * nh.y, fmaxf(nh.z, 0.0f)));
}

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta, float& cos_t) {
  cos_i = clamp01(cos_i);
  const float sin_i = safe_sqrt(1.0f - sqr(cos_i));
  const float sin_t = sin_i / eta;
  cos_t = safe_sqrt(1.0f - sqr(sin_t));
  if (sin_t >= 1.0f) return 1.0f;
  const float r_parl = (eta * cos_i - cos_t) / fmaxf(eta * cos_i + cos_t, 1e-12f);
  const float r_perp = (cos_i - eta * cos_t) / fmaxf(cos_i + eta * cos_t, 1e-12f);
  return 0.5f * (sqr(r_parl) + sqr(r_perp));
}

__device__ float fresnel_conductor1(float cos_i, float e, float k) {
  cos_i = fminf(fmaxf(cos_i, -1.0f), 1.0f);
  const float cos2 = sqr(cos_i);
  const float sin2 = 1.0f - cos2;
  const float e2 = sqr(e), k2 = sqr(k);
  const float t0 = e2 - k2 - sin2;
  const float a2b2 = sqrtf(fmaxf(sqr(t0) + 4.0f * e2 * k2, 0.0f));
  const float t1 = a2b2 + cos2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * cos_i * a;
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-12f);
  const float t3 = cos2 * a2b2 + sqr(sin2);
  const float t4 = t2 * sin2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-12f);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float3 fresnel_conductor(float cos_i, float3 e, float3 k) {
  return f3(fresnel_conductor1(cos_i, e.x, k.x), fresnel_conductor1(cos_i, e.y, k.y),
            fresnel_conductor1(cos_i, e.z, k.z));
}

__device__ float lookup_e(const float* ep, float alpha2, float cos_no) {
  const float x = clamp01(cos_no), y = clamp01(alpha2);
  float acc = 0.0f;
  for (int i = E_DEG; i >= 0; --i) {
    float row = 0.0f;
    for (int j = E_DEG; j >= 0; --j) row = row * y + ep[i * (E_DEG + 1) + j];
    acc = acc * x + row;
  }
  return fminf(fmaxf(acc, 1e-3f), 1.0f);
}

__device__ float lookup_eavg(const float* ep, float alpha2) {
  const float y = clamp01(alpha2);
  float acc = 0.0f;
  for (int i = E_DEG; i >= 0; --i) acc = acc * y + ep[(E_DEG + 1) * (E_DEG + 1) + i];
  return fminf(fmaxf(acc, 1e-3f), 1.0f);
}

__device__ __forceinline__ float fss_conductor1(float e, float k) {
  const float f0 = fresnel_conductor1(1.0f, e, k);
  const float f82 = fresnel_conductor1((float)(1.0 / 7.0), e, k);
  const float b = (f0 * (float)(1.0 - 0.46266436) + 0.46266436f - f82) * 17.651384f;
  return f0 * (float)(1.0 - 1.0 / 21.0) + (float)(1.0 / 21.0) - b * (float)(1.0 / 126.0);
}

// Kulla-Conty multiple-scattering multiplier 1 + Fms (1 - E) / E
__device__ float3 ggx_multiscatter(const float* ep, const Mat& m, float cos_no) {
  const float alpha2 = m.ax * m.ay;
  const float e = lookup_e(ep, alpha2, cos_no);
  const float eavg = lookup_eavg(ep, alpha2);
  float3 fss = m.trans;
  if (m.type == GGX_CONDUCTOR)
    fss = f3(fss_conductor1(m.ceta.x, m.ck.x), fss_conductor1(m.ceta.y, m.ck.y),
             fss_conductor1(m.ceta.z, m.ck.z));
  const float missing = (1.0f - e) / e;
  return f3(1.0f + fss.x * eavg / fmaxf(1.0f - fss.x * (1.0f - eavg), 1e-4f) * missing,
            1.0f + fss.y * eavg / fmaxf(1.0f - fss.y * (1.0f - eavg), 1e-4f) * missing,
            1.0f + fss.z * eavg / fmaxf(1.0f - fss.z * (1.0f - eavg), 1e-4f) * missing);
}

__device__ float oren_nayar_g(float cos_theta) {
  const bool small = cos_theta < 1e-6f;
  const float c = small ? 0.5f : cos_theta;
  const float sin_t = safe_sqrt(1.0f - sqr(c));
  const float theta = acosf(fminf(fmaxf(c, -1.0f), 1.0f));
  const float main = sin_t * (theta - (float)(2.0 / 3.0) - sin_t * c) +
                     (float)(2.0 / 3.0) * (sin_t / c) * (1.0f - sqr(sin_t) * sin_t);
  return small ? (float)(M_PI / 2.0 - 2.0 / 3.0) - cos_theta : main;
}

__device__ float3 oren_nayar_fcos(const Mat& m, float3 n, float3 wo, float3 wi) {
  const float a = 1.0f / ((float)M_PI + (float)(M_PI / 2.0 - 2.0 / 3.0) * m.sigma);
  const float b = a * m.sigma;
  const float nl = fmaxf(dot3(n, wi), 0.0f);
  const float nv = fmaxf(dot3(n, wo), 0.0f);
  float t = dot3(wi, wo) - nl * nv;
  if (t > 0.0f) t = t / (fmaxf(nl, nv) + 1e-38f);
  const float single = a + b * t;
  const float e_l = a * (float)M_PI + b * oren_nayar_g(nl);
  const float e_v = a * (float)M_PI + b * oren_nayar_g(nv);
  const float3 ms = f3(fmaxf(m.albedo.x * (1.0f - e_v), 0.0f) * (1.0f - e_l),
                       fmaxf(m.albedo.y * (1.0f - e_v), 0.0f) * (1.0f - e_l),
                       fmaxf(m.albedo.z * (1.0f - e_v), 0.0f) * (1.0f - e_l));
  return f3(m.albedo.x * nl * (single + ms.x), m.albedo.y * nl * (single + ms.y),
            m.albedo.z * nl * (single + ms.z));
}

__device__ __forceinline__ void ggx_frame(float3 ns, float phi0, float3& x, float3& y) {
  float3 t, b;
  gram_schmidt(ns, t, b);
  x = cosf(phi0) * t + sinf(phi0) * b;
  y = cross3(ns, x);
}

__device__ __forceinline__ bool is_ggx_type(int t) {
  return t == GGX_DIELECTRIC || t == GGX_CONDUCTOR;
}

// f cos(theta_i) and pdf toward wi (flat shading: ns == ng == n, facing wo's
// side of the incident ray). Delta lobes evaluate to zero.
__device__ void eval_bsdf(const float* ep, const Mat& m, float3 wo, float3 wi, float3 n,
                          bool inside, float3& f, float& pdf) {
  f = f3(0.f, 0.f, 0.f);
  pdf = 0.0f;
  const float cos_no = dot3(n, wo);
  if (!(cos_no > 0.0f)) return;  // valid_side
  const float cos_ni = dot3(n, wi);
  if (!is_ggx_type(m.type)) {
    if (!(cos_ni > 0.0f)) return;
    f = m.type == OREN_NAYAR ? oren_nayar_fcos(m, n, wo, wi)
                             : m.albedo * fmaxf(cos_ni, 0.0f) * INV_PI_F;
    pdf = fmaxf(cos_ni, 0.0f) * INV_PI_F;
    return;
  }
  const bool cond = m.type == GGX_CONDUCTOR;
  const bool is_trans = cos_ni < 0.0f;
  const bool has_refl = cond || avg3(m.refl) > THROUGHPUT_EPS;
  const bool has_trans = !cond && avg3(m.trans) > THROUGHPUT_EPS;
  if (fmaxf(m.ax, m.ay) < DELTA_ALPHA || (!has_refl && cos_ni > 0.0f) ||
      (!has_trans && cos_ni < 0.0f))
    return;  // ggx_bad
  const float alpha2 = m.ax * m.ay;
  const float eta_eff = inside ? 1.0f / m.eta : m.eta;
  const float ior = is_trans ? eta_eff : 1.0f;
  const float3 h_raw = ior * wi + wo;
  const float inv_len_h = 1.0f / fmaxf(sqrtf(dot3(h_raw, h_raw)), 1e-12f);
  float3 h = h_raw * inv_len_h;
  if (dot3(h, n) < 0.0f) h = -h;
  const float cos_ho = dot3(h, wo);
  float cos_t;
  const float f_diel = fresnel_dielectric(cos_ho, eta_eff, cos_t);
  const float3 refl = cond ? fresnel_conductor(cos_ho, m.ceta, m.ck) : f_diel * m.refl;
  const float3 trans = cond ? f3(0.f, 0.f, 0.f) : (1.0f - f_diel) * m.trans;
  const float cos_nh = dot3(n, h);
  float d_val, lam_i, lam_o;
  if (m.ax == m.ay || is_trans) {
    d_val = ggx_d(alpha2, cos_nh);
    lam_i = ggx_lambda(alpha2, fabsf(cos_ni));
    lam_o = ggx_lambda(alpha2, cos_no);
  } else {
    float3 xa, ya;
    ggx_frame(n, m.phi0, xa, ya);
    d_val = ggx_aniso_d(m.ax, m.ay, f3(dot3(xa, h), dot3(ya, h), cos_nh));
    lam_i = ggx_aniso_lambda(m.ax, m.ay, f3(dot3(xa, wi), dot3(ya, wi), cos_ni));
    lam_o = ggx_aniso_lambda(m.ax, m.ay, f3(dot3(xa, wo), dot3(ya, wo), cos_no));
  }
  const float jac =
      is_trans ? sqr(ior * inv_len_h) * fabsf(cos_ho * dot3(h, wi)) : 0.25f;
  const float common = d_val / fmaxf(cos_no, 1e-6f) * jac;
  const float denom = fmaxf(avg3(refl + trans), 1e-12f);
  const float pr = clamp01(avg3(refl) / denom);
  const float lobe = is_trans ? 1.0f - pr : pr;
  pdf = lobe * common / (1.0f + lam_o);
  const float3 f_sel = is_trans ? trans : mul3(refl, ggx_multiscatter(ep, m, cos_no));
  f = f_sel * (common / (1.0f + lam_o + lam_i));
}

struct BsdfSample {
  float3 wi, f;
  float pdf, eta;
  bool delta, refract;
};

__device__ BsdfSample sample_bsdf(const float* ep, const Mat& m, float3 wo, float3 n,
                                  float u1, float u2, float uc, bool inside) {
  BsdfSample s;
  s.eta = 1.0f;
  s.delta = false;
  s.refract = false;
  const float cos_no = dot3(n, wo);
  if (!is_ggx_type(m.type)) {
    float pdf_d;
    s.wi = sample_cos_hemisphere(n, u1, u2, pdf_d);
    if (dot3(n, s.wi) > 0.0f) {
      s.f = m.type == OREN_NAYAR ? oren_nayar_fcos(m, n, wo, s.wi) : m.albedo * pdf_d;
      s.pdf = pdf_d;
    } else {
      s.f = f3(0.f, 0.f, 0.f);
      s.pdf = 0.0f;
    }
  } else {
    const bool cond = m.type == GGX_CONDUCTOR;
    const bool is_delta = fmaxf(m.ax, m.ay) < DELTA_ALPHA;
    float3 xa, ya;
    ggx_frame(n, m.phi0, xa, ya);
    const float3 lo = f3(dot3(xa, wo), dot3(ya, wo), cos_no);
    float3 lh = sample_ggx_vndf(lo, u1, u2, m.ax, m.ay);
    float3 h = lh.x * xa + lh.y * ya + lh.z * n;
    if (is_delta) {
      h = n;
      lh = f3(0.f, 0.f, 1.f);
    }
    const float cos_ho = dot3(h, wo);
    const float eta_eff = inside ? 1.0f / m.eta : m.eta;
    float cos_hi;
    const float f_diel = fresnel_dielectric(cos_ho, eta_eff, cos_hi);
    const float3 refl = cond ? fresnel_conductor(cos_ho, m.ceta, m.ck) : f_diel * m.refl;
    const float3 trans = cond ? f3(0.f, 0.f, 0.f) : (1.0f - f_diel) * m.trans;
    const float inv_eta = 1.0f / eta_eff;
    const float denom = fmaxf(avg3(refl + trans), 1e-12f);
    const float pr = clamp01(avg3(refl) / denom);
    const bool do_refract = uc > pr;
    const float3 wi = do_refract
                          ? (inv_eta * dot3(wo, h) - cos_hi) * h - inv_eta * wo
                          : (2.0f * cos_ho) * h - wo;
    const bool bad_hemi = dot3(n, wi) <= 0.0f && !do_refract;
    const bool zero_fres = avg3(refl) < THROUGHPUT_EPS && avg3(trans) < THROUGHPUT_EPS;
    const bool invalid = bad_hemi || zero_fres;
    const float lobe = do_refract ? 1.0f - pr : pr;
    const float3 f_g = do_refract ? trans : refl;
    s.wi = wi;
    s.delta = is_delta;
    s.refract = do_refract && !invalid;
    s.eta = s.refract ? eta_eff : 1.0f;
    if (invalid) {
      s.f = f3(0.f, 0.f, 0.f);
      s.pdf = 0.0f;
    } else if (is_delta) {
      // f/pdf must equal the Fresnel-weighted tint; encoded with pdf = lobe
      s.f = f_g * lobe;
      s.pdf = lobe;
    } else {
      const float alpha2 = m.ax * m.ay;
      const float cos_ni = dot3(n, wi);
      float d_val, lam_i, lam_o;
      if (m.ax == m.ay || do_refract) {
        d_val = ggx_d(alpha2, lh.z);
        lam_i = ggx_lambda(alpha2, cos_ni);
        lam_o = ggx_lambda(alpha2, cos_no);
      } else {
        const float3 li = (2.0f * cos_ho) * lh - lo;
        d_val = ggx_aniso_d(m.ax, m.ay, lh);
        lam_i = ggx_aniso_lambda(m.ax, m.ay, li);
        lam_o = ggx_aniso_lambda(m.ax, m.ay, lo);
      }
      const float jac = do_refract ? fabsf(cos_ho * cos_hi) /
                                         fmaxf(sqr(cos_hi + cos_ho * inv_eta), 1e-8f)
                                   : 0.25f;
      const float common = d_val / fmaxf(cos_no, 1e-6f) * jac;
      s.pdf = lobe * common / (1.0f + lam_o);
      s.f = f_g * (common / (1.0f + lam_o + lam_i));
      if (!do_refract) s.f = mul3(s.f, ggx_multiscatter(ep, m, cos_no));
    }
  }
  if (!(cos_no > 0.0f)) {  // valid_side
    s.f = f3(0.f, 0.f, 0.f);
    s.pdf = 0.0f;
  }
  return s;
}

// ---------------------------------------------------------------------------
// lights (ops/lights.py)
// ---------------------------------------------------------------------------

// point/spot row r = [type, color3, pos3, dir3, cos0, cos_e, radius]
__device__ void sample_point_spot(const float* r, float3 pos, float3 normal, float u1,
                                  float u2, float3& dir, float& dist_out, float& pdf,
                                  float3& le) {
  const bool is_spot = (int)r[0] == SPOT;
  const float3 lpos = row3(r + 4), sdir = row3(r + 7);
  const float cos0 = r[10], cose = r[11], radius = r[12];
  const float radius_sqr = sqr(radius);
  const float3 to_p = pos - lpos;
  const float dist_sqr = fmaxf(dot3(to_p, to_p), 1e-20f);
  const float dist = sqrtf(dist_sqr);
  const float3 light_n = div3(to_p, dist);
  const bool outside = dist_sqr > radius_sqr;
  const bool eff_delta0 = (radius / dist) < 1e-3f;
  const float omc_sphere = sin_sqr_to_one_minus_cos(radius_sqr / dist_sqr);
  float cos_theta;
  bool delta;
  float3 d;
  if (outside) {
    bool delta_out;
    d = sample_uniform_cone(-light_n, omc_sphere, u1, u2, cos_theta, pdf, delta_out);
    delta = delta_out || eff_delta0;
  } else {
    d = sample_cos_hemisphere(normal, u1, u2, pdf);
    cos_theta = -dot3(d, light_n);
    delta = false;
  }
  if (delta) pdf = 1.0f;
  float distance = dist * cos_theta -
                   copysignf(safe_sqrt(radius_sqr - dist_sqr + dist_sqr * sqr(cos_theta)),
                             dist_sqr - radius_sqr);
  float3 p_light = pos + d * distance;
  float factor = 1.0f;
  if (is_spot) {
    const float omc_spread = 1.0f - cose;
    if (outside && !(omc_sphere < omc_spread)) {
      // the spread cone is tighter than the sphere's: sample it and hit
      // the sphere along the sample
      float cos_c, pdf_c;
      bool delta_c;
      const float3 dc = sample_uniform_cone(-sdir, omc_spread, u1, u2, cos_c, pdf_c, delta_c);
      const float3 dv = lpos - pos;
      const float d_sq = dot3(dv, dv);
      const float d_cos = dot3(dv, dc);
      const bool away = d_sq > radius_sqr && d_cos < 0.0f;
      const float3 perp = dv - d_cos * dc;
      const float sin_sq = dot3(perp, perp);
      const float t_s = d_cos - copysignf(safe_sqrt(radius_sqr - sin_sq), d_sq - radius_sqr);
      const bool hit_s = !away && !(sin_sq > radius_sqr) && t_s > 0.0f && t_s < 3.0e38f;
      d = dc;
      pdf = hit_s ? pdf_c : 0.0f;
      delta = delta_c && hit_s;
      distance = t_s;
      p_light = pos + dc * t_s;
    }
    const float att = smoothstep(cose, cos0, dot3(-d, sdir));
    factor = att;
    if (att <= 0.0f) pdf = 0.0f;
    if (eff_delta0 && pdf > 0.0f) {
      delta = true;
      pdf = 1.0f;
    }
    if (pdf > 0.0f) {
      // re-project the sample onto the sphere and fix the direction
      const float3 p_proj = normalize3(p_light - lpos) * radius + lpos;
      const float3 nd = p_proj - pos;
      const float nl = sqrtf(dot3(nd, nd));
      if (nl > 1e-8f) {
        d = div3(nd, fmaxf(nl, 1e-8f));
        distance = nl;
      }
    }
  }
  dir = d;
  dist_out = distance;
  const float atten = 1.0f / fmaxf(sqr(distance), 1e-12f);
  le = row3(r + 1) * factor * atten;
}

// emissive row e = [v0 3, e0 3, e1 3, rad 3, cdf_lo, cdf_hi, area]
__device__ void sample_area(const float* em, int k_em, float3 pos, float u1, float u2,
                            float3& dir, float& dist, float& pdf, float3& le) {
  // searchsorted(cdf, u1, right) - 1, clipped: the last CDF entry <= u1
  int cnt = 0;
  for (int k = 0; k < k_em; ++k) cnt += em[k * EM_W + 12] <= u1;
  cnt += em[(k_em - 1) * EM_W + 13] <= u1;
  const int tri = min(max(cnt - 1, 0), k_em - 1);
  const float* e = em + tri * EM_W;
  const float du = (u1 - e[12]) / fmaxf(e[13] - e[12], 1e-12f);
  const float su = safe_sqrt(du);
  const float3 te0 = row3(e + 3), te1 = row3(e + 6);
  const float3 p = row3(e) + (1.0f - su) * te0 + (u2 * su) * te1;
  float3 n_e = cross3(te0, te1);
  n_e = div3(n_e, fmaxf(sqrtf(dot3(n_e, n_e)), 1e-12f));
  const float3 to_p = p - pos;
  const float dist_sqr = fmaxf(dot3(to_p, to_p), 1e-12f);
  dist = sqrtf(dist_sqr);
  dir = div3(to_p, dist);
  const float cos_l = fabsf(dot3(dir, n_e));
  const bool lit = cos_l > 1e-6f;
  pdf = lit ? dist_sqr / fmaxf(cos_l * e[14], 1e-12f) : 0.0f;
  le = lit ? row3(e + 9) : f3(0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// geometry policies: the closest hit and the shadow query
// ---------------------------------------------------------------------------

// Brute force: every triangle, staged in shared memory as rows of three
// float4s [v0, material id (int32 bits) | e0, 0 | e1, 0] (48 B: three
// 16-byte loads a test), built once per scene (ops/shade_tables.py
// pack_brute_tables), tested with sweep_test (common.cuh: the cull before the
// division). The winner is the first index of the least t (strict t < tb,
// in index order).
struct BruteGeo {
  int n_tris;
  const float4* rows;
  __host__ __device__ int smem_floats() const { return 12 * n_tris; }
  __device__ void bind(const float* smem) { rows = reinterpret_cast<const float4*>(smem); }
  __device__ bool test(float3 o, float3 d, int i, float t_cap, float cap, float& t, float& u,
                       float& v) const {
    return sweep_test(o, d, rows + 3 * i, t_cap, cap, t, u, v);
  }
  // sweep all triangles, keep the winner's (u, v)
  __device__ bool closest(float3 o, float3 d, float& tb, float& ub, float& vb,
                          int& ib) const {
    tb = BIG_T;
    ub = vb = 0.0f;
    ib = 0;
    float cap = BIG_T * CULL_TCAP;
    for (int i = 0; i < n_tris; ++i) {
      float t, u, v;
      if (test(o, d, i, tb, cap, t, u, v)) {
        tb = t;
        cap = t * CULL_TCAP;
        ib = i;
        ub = u;
        vb = v;
      }
    }
    return tb < BIG_T;
  }
  __device__ bool occluded(float3 o, float3 d, float t_max) const {
    const float cap = t_max * CULL_TCAP;
    for (int i = 0; i < n_tris; ++i) {
      float t, u, v;
      if (test(o, d, i, t_max, cap, t, u, v)) return true;
    }
    return false;
  }
  __device__ void triangle(int i, float3& p0, float3& e0, float3& e1) const {
    const float4 a = rows[3 * i], b = rows[3 * i + 1], c = rows[3 * i + 2];
    p0 = f3(a.x, a.y, a.z);
    e0 = f3(b.x, b.y, b.z);
    e1 = f3(c.x, c.y, c.z);
  }
  __device__ int material(int i) const { return __float_as_int(rows[3 * i].w); }
};

// BVH: per-thread traversal of the compact tables (bvh_compact.cuh).
struct BvhGeo {
  CompactBvh bv;
  const int* __restrict__ tri_mat;  // (Tp,) packed-BVH order
  __device__ bool closest(float3 o, float3 d, float& tb, float& ub, float& vb,
                          int& ib) const {
    ub = vb = 0.0f;
    ib = 0;
    return cbvh_trace<false>(bv, o, d, BIG_T, tb, ub, vb, ib);
  }
  __device__ bool occluded(float3 o, float3 d, float t_max) const {
    float t, u, v;
    int row;
    return cbvh_trace<true>(bv, o, d, t_max, t, u, v, row);
  }
  __device__ void triangle(int i, float3& p0, float3& e0, float3& e1) const {
    const float4* r = bv.rows + (size_t)i * CBVH_ROW_F4;
    const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
    p0 = f3(a.x, a.y, a.z);
    e0 = f3(b.x, b.y, b.z);
    e1 = f3(c.x, c.y, c.z);
  }
  __device__ int material(int i) const { return __ldg(tri_mat + i); }
};

// ---------------------------------------------------------------------------
// one bounce, shared by the whole-path kernel and the single-bounce kernel
// ---------------------------------------------------------------------------

// A path's state between bounces (models/megakernel.py PathState).
struct PathRegs {
  float3 o, d, beta, radiance;
  float eta_scale, prev_pdf;
  bool inside, prev_delta;
};

// The shading tables in shared memory: mat (M,24) | light (L,13) |
// emissive (K,15) | env (3) | E/Eavg coefficients (56).
struct Shade {
  const float* mat;
  const float* light;
  const float* em;
  const float* ep;
  float3 env;
  int n_lights, n_em;
  __device__ Shade(const float* s, int n_mats, int n_lights_, int n_em_)
      : mat(s), light(s + MAT_W * n_mats), em(light + LIGHT_W * n_lights_),
        ep(em + EM_W * n_em_ + 3), env(row3(em + EM_W * n_em_)), n_lights(n_lights_),
        n_em(n_em_) {}
};

__host__ __device__ inline int shade_floats(int n_mats, int n_lights, int n_em) {
  return MAT_W * n_mats + LIGHT_W * n_lights + EM_W * n_em + 3 + EPOLY_N;
}

// One bounce of a live path at `depth` (models/megakernel.py bounce_step
// for one ray): closest hit, emitter MIS, NEE, BSDF sample, roulette.
// Returns whether the path lives on. A path that ends here (miss, pdf <=
// 0, roulette) keeps o, d, beta, prev_pdf and prev_delta as they were;
// radiance always, and inside and eta_scale after a refraction, are
// updated, as in bounce_step.
template <class Geo, class Smp>
__device__ __forceinline__ bool bounce(const Geo& g, const Smp& rng, const Shade& sh,
                                       int depth, int rr_start_depth, PathRegs& s) {
  const uint32_t dim = (uint32_t)depth * DIMS_PER_BOUNCE;
  const float pmf = 1.0f / (float)sh.n_lights;
  const float3 d = s.d;
  // ---- closest hit, with the winner's (u, v) ----
  float tb, ub, vb;
  int ib;
  if (!g.closest(s.o, d, tb, ub, vb, ib)) {  // miss: environment, path ends
    s.radiance = s.radiance + mul3(s.beta, sh.env);
    return false;
  }
  float3 p0, e0, e1;
  g.triangle(ib, p0, e0, e1);
  const float3 pos = p0 + ub * e0 + vb * e1;
  float3 ng = normalize3(cross3(e1, e0));
  if (dot3(d, ng) > 0.0f) ng = -ng;
  const float wb = 1.0f - ub - vb;
  const float3 p1 = p0 + e0, p2 = p0 + e1;
  const float3 err =
      f3(GAMMA7 * (fabsf(ub * p0.x) + fabsf(vb * p1.x) + fabsf(wb * p2.x)),
         GAMMA7 * (fabsf(ub * p0.y) + fabsf(vb * p1.y) + fabsf(wb * p2.y)),
         GAMMA7 * (fabsf(ub * p0.z) + fabsf(vb * p1.z) + fabsf(wb * p2.z)));
  const float3 wo = -d;
  const Mat m = load_mat(sh.mat + MAT_W * g.material(ib));

  if (sh.n_em > 0) {  // directly-hit emitter, MIS against area NEE
    const float cos_l = fabsf(dot3(d, ng));
    const float pdf_hit = sqr(tb) / fmaxf(cos_l * sh.em[14], 1e-12f) * pmf;
    const float w_em =
        s.prev_delta ? 1.0f
                     : sqr(s.prev_pdf) / fmaxf(sqr(s.prev_pdf) + sqr(pdf_hit), 1e-24f);
    s.radiance = s.radiance + mul3(s.beta, m.emission) * w_em;
  }

  // ---- NEE: uniform light pick ----
  {
    const float ul = rng.u1(dim + 2u);
    const int li = min((int)(ul * (float)sh.n_lights), sh.n_lights - 1);
    const float2 ulu = rng.u2(dim + 3u);
    const float* lrow = sh.light + LIGHT_W * li;
    const bool is_area = (int)lrow[0] == AREA;
    float3 ldir, le;
    float ldist, lpdf;
    if (is_area) {
      sample_area(sh.em, sh.n_em, pos, ulu.x, ulu.y, ldir, ldist, lpdf, le);
      ldist *= 0.999f;
    } else {
      sample_point_spot(lrow, pos, ng, ulu.x, ulu.y, ldir, ldist, lpdf, le);
    }
    float3 f_l;
    float pdf_l;
    eval_bsdf(sh.ep, m, wo, ldir, ng, s.inside, f_l, pdf_l);
    if (lpdf > 0.0f && max3(f_l) > 0.0f) {
      const float3 so = offset_ray_origin(pos, err, ng, ldir);
      if (!g.occluded(so, ldir, ldist)) {
        if (is_area) {
          const float pdf_tot = lpdf * pmf;
          const float w = sqr(pdf_tot) / fmaxf(sqr(pdf_tot) + sqr(pdf_l), 1e-24f);
          const float scale = w / fmaxf(pdf_tot, 1e-12f);
          s.radiance = s.radiance + mul3(s.beta, mul3(le, f_l) * scale);
        } else {
          s.radiance = s.radiance + mul3(s.beta, div3(mul3(le, f_l), pmf));
        }
      }
    }
  }

  // ---- bounce ----
  const float2 ub2 = rng.u2(dim + 5u);
  const float uc = rng.u1(dim + 7u);
  const BsdfSample bs = sample_bsdf(sh.ep, m, wo, ng, ub2.x, ub2.y, uc, s.inside);
  if (!(bs.pdf > 0.0f)) return false;
  float3 beta = mul3(s.beta, div3(bs.f, fmaxf(bs.pdf, 1e-12f)));
  const float3 o_new = offset_ray_origin(pos, err, ng, bs.wi);
  if (bs.refract) {
    s.inside = !s.inside;
    s.eta_scale *= sqr(bs.eta);
  }
  // Russian roulette on beta * prod(eta^2) from rr_start_depth on
  const float rr_beta = max3(beta) * s.eta_scale;
  if (rr_beta < 1.0f && depth >= rr_start_depth) {
    const float q = fmaxf(0.0f, 1.0f - rr_beta);
    if (rng.u1(dim + 8u) < q) return false;
    beta = beta * (1.0f / fmaxf(1.0f - q, 1e-6f));
  }
  s.o = o_new;
  s.d = bs.wi;
  s.beta = beta;
  s.prev_pdf = bs.pdf;
  s.prev_delta = bs.delta;
  return true;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// The whole path loop per thread, brute force (TPU kernel: _pt_kernel,
// depth0=None).
template <class Geo, class Smp>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    pt_fused_kernel(Geo geo, const float* __restrict__ o_in, const float* __restrict__ d_in,
                    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                    const uint32_t* __restrict__ sample, const float* __restrict__ tables,
                    int n, int n_mats, int n_lights, int n_em, int max_depth,
                    int rr_start_depth, uint32_t seed, int qmc_dims,
                    float* __restrict__ out) {
  // shared layout: geometry rows (16-byte aligned) | shading tables
  extern __shared__ float4 smem_rows[];
  float* smem = reinterpret_cast<float*>(smem_rows);
  const int n_geo = geo.smem_floats();
  block_copy(smem, tables, n_geo + shade_floats(n_mats, n_lights, n_em));
  __syncthreads();
  Geo g = geo;
  g.bind(smem);
  const Shade sh(smem + n_geo, n_mats, n_lights, n_em);

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Smp rng(px[r], py[r], sample[r], seed, qmc_dims);
  // the camera counts as delta
  PathRegs s{load3(o_in, r), load3(d_in, r), f3(1.f, 1.f, 1.f), f3(0.f, 0.f, 0.f),
             1.0f, 0.0f, false, true};
  for (int depth = 0; depth < max_depth; ++depth)
    if (!bounce(g, rng, sh, depth, rr_start_depth, s)) break;
  store3(out, r, s.radiance);
}

// ---- the BVH kernels: persistent blocks over the compact tables ----------

// 256 threads a block and at most 128 registers a thread (two blocks, 16
// warps, per SM): the bounce holds the path, the traversal's ray and stack
// and the shading state at once, and fits in 128 without spilling.
constexpr int kBvhBlock = 256;
constexpr int kBvhMinBlocks = 2;
#define DEAD_KEY32 0x7FFFFFFF  // a dead path's sort key: after every live one

// The next path index for each calling lane: one atomicAdd per converged
// group of lanes on the launch's counter (zeroed by the wrapper).
__device__ __forceinline__ int next_path(int* counter) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group grp = cg::coalesced_threads();
  int base = 0;
  if (grp.thread_rank() == 0) base = atomicAdd(counter, (int)grp.size());
  return grp.shfl(base, 0) + (int)grp.thread_rank();
}

// The whole path loop, BVH mode, with path regeneration: about as many
// blocks as fit on the card at once, each lane taking a path index from
// the counter, running its bounces and taking the next index as soon as
// its path ends, so the warp stays full until the counter runs out. One
// loop iteration is one bounce of whichever path a lane holds: the lanes
// of a warp run bounce() together whatever their paths' depths. A path's
// radiance depends on its index alone (its ray, keys and depth-keyed
// random numbers), so the output is that of one thread per path.
template <class Smp>
__global__ void __launch_bounds__(kBvhBlock, kBvhMinBlocks)
    pt_fused_bvh_kernel(BvhGeo g, const float* __restrict__ o_in,
                        const float* __restrict__ d_in, const uint32_t* __restrict__ px,
                        const uint32_t* __restrict__ py, const uint32_t* __restrict__ sample,
                        const float* __restrict__ shade, int n, int n_mats, int n_lights,
                        int n_em, int max_depth, int rr_start_depth, uint32_t seed,
                        int qmc_dims, int* __restrict__ counter, float* __restrict__ out) {
  extern __shared__ float smem[];
  block_copy(smem, shade, shade_floats(n_mats, n_lights, n_em));
  __syncthreads();
  const Shade sh(smem, n_mats, n_lights, n_em);
  PathRegs s{};
  int r = 0, depth = 0;
  bool fetch = true;
  while (true) {
    if (fetch) {
      r = next_path(counter);
      if (r >= n) break;
      // the camera counts as delta
      s = PathRegs{load3(o_in, r), load3(d_in, r), f3(1.f, 1.f, 1.f), f3(0.f, 0.f, 0.f),
                   1.0f, 0.0f, false, true};
      depth = 0;
      if (max_depth <= 0) {
        store3(out, r, s.radiance);
        continue;
      }
    }
    const Smp rng(px[r], py[r], sample[r], seed, qmc_dims);
    const bool alive = bounce(g, rng, sh, depth, rr_start_depth, s);
    fetch = !alive || ++depth >= max_depth;
    if (fetch) store3(out, r, s.radiance);
  }
}

// Morton spread of 10 bits to every 3rd position (ops/raysort.py _part3)
__device__ __forceinline__ uint32_t part3(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// ops/raysort.py ray_sort_key of a live ray (7 Morton bits per axis) as an
// int32: [30:28] direction octant, the origin's Morton code top-aligned
// below it, bit 31 clear. ext = clamp(hi - lo, min=1e-6).
__device__ __forceinline__ int ray_sort_key32(float3 o, float3 d, float3 lo, float3 ext) {
  const uint32_t oct = (d.x < 0.0f ? 1u : 0u) | (d.y < 0.0f ? 2u : 0u) | (d.z < 0.0f ? 4u : 0u);
  const uint32_t qx = (uint32_t)(clamp01((o.x - lo.x) / ext.x) * 127.0f);
  const uint32_t qy = (uint32_t)(clamp01((o.y - lo.y) / ext.y) * 127.0f);
  const uint32_t qz = (uint32_t)(clamp01((o.z - lo.z) / ext.z) * 127.0f);
  const uint32_t m = part3(qx) | (part3(qy) << 1) | (part3(qz) << 2);
  return (int)((oct << 28) | (m << 7));
}

// One bounce per launch over the path state (TPU kernel: _pt_kernel,
// single-depth mode, trace_paths_fused_sorted). st is (n, 24) 32-bit rows
// in slot order, 96 B = 6 float4s per path: 0-2 o, 3-5 d, 6-8 beta, 9-11
// radiance (f32); 12 alive, 13 inside (i32); 14 eta_scale, 15 prev_pdf
// (f32); 16 prev_delta (i32); 17 px, 18 py, 19 sample (u32); 20 slot; 21-23
// padding. Thread t of the launch runs row perm[t] (t itself without a
// perm), reading it as 5 float4 loads and writing it back as 4 float4s and
// one word in place, so the state is never copied; then it writes the
// row's sort key for the next depth to keys[row] (DEAD_KEY32 for a path
// that is or becomes dead). A dead path's row is left as it was.
// Persistent blocks as in the fused kernel, each warp taking 32
// consecutive t at a time from the counter (chunks of a whole block ran
// faster on an H100 80GB HBM3 at 700 W but spilled the Halton
// instantiation, PERF.md).
template <class Smp>
__global__ void __launch_bounds__(kBvhBlock, kBvhMinBlocks)
    pt_bounce_kernel(BvhGeo g, float* __restrict__ st,
                     const int64_t* __restrict__ perm, int* __restrict__ keys,
                     const float* __restrict__ bounds, const float* __restrict__ shade, int n,
                     int n_mats, int n_lights, int n_em, int depth, int rr_start_depth,
                     uint32_t seed, int qmc_dims, int* __restrict__ counter) {
  extern __shared__ float smem[];
  block_copy(smem, shade, shade_floats(n_mats, n_lights, n_em));
  __syncthreads();
  const Shade sh(smem, n_mats, n_lights, n_em);
  const int lane = threadIdx.x & 31;
  float4* __restrict__ st4 = reinterpret_cast<float4*>(st);
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (base >= n) break;
    const int t = base + lane;
    if (t >= n) continue;
    const int row = perm ? (int)perm[t] : t;
    const float4* p = st4 + (size_t)row * 6;
    const float4 q3 = p[3];  // alive, inside, eta_scale, prev_pdf
    if (__float_as_int(q3.x) == 0) {
      keys[row] = DEAD_KEY32;
      continue;
    }
    const float4 q0 = p[0], q1 = p[1], q2 = p[2], q4 = p[4];
    PathRegs s{f3(q0.x, q0.y, q0.z), f3(q0.w, q1.x, q1.y), f3(q1.z, q1.w, q2.x),
               f3(q2.y, q2.z, q2.w), q3.z, q3.w, __float_as_int(q3.y) != 0,
               __float_as_int(q4.x) != 0};
    const Smp rng(__float_as_uint(q4.y), __float_as_uint(q4.z), __float_as_uint(q4.w), seed,
                  qmc_dims);
    const bool alive = bounce(g, rng, sh, depth, rr_start_depth, s);
    float4* w = st4 + (size_t)row * 6;
    w[0] = make_float4(s.o.x, s.o.y, s.o.z, s.d.x);
    w[1] = make_float4(s.d.y, s.d.z, s.beta.x, s.beta.y);
    w[2] = make_float4(s.beta.z, s.radiance.x, s.radiance.y, s.radiance.z);
    w[3] = make_float4(__int_as_float(alive ? 1 : 0), __int_as_float(s.inside ? 1 : 0),
                       s.eta_scale, s.prev_pdf);
    reinterpret_cast<int*>(w)[16] = s.prev_delta ? 1 : 0;
    int key = DEAD_KEY32;
    if (alive) {  // the sort box, read here so that it is not live across the bounce
      const float3 lo = f3(bounds[0], bounds[1], bounds[2]);
      const float3 ext = f3(fmaxf(bounds[3] - lo.x, 1e-6f), fmaxf(bounds[4] - lo.y, 1e-6f),
                            fmaxf(bounds[5] - lo.z, 1e-6f));
      key = ray_sort_key32(s.o, s.d, lo, ext);
    }
    keys[row] = key;
  }
}

template <class K>
int set_smem(K kernel, size_t smem) {
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <class Geo, class Smp>
int launch(const Geo& geo, const float* o, const float* d,
           const uint32_t* px, const uint32_t* py, const uint32_t* sample,
           const float* tables, int n, int n_mats, int n_lights, int n_em,
           int max_depth, int rr_start_depth, uint32_t seed, int qmc_dims, float* out,
           void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)(geo.smem_floats() + shade_floats(n_mats, n_lights, n_em));
  if (const int err = set_smem(pt_fused_kernel<Geo, Smp>, smem)) return err;
  const int grid = (n + kBlock - 1) / kBlock;
  pt_fused_kernel<Geo, Smp><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      geo, o, d, px, py, sample, tables, n, n_mats, n_lights, n_em, max_depth,
      rr_start_depth, seed, qmc_dims, out);
  return (int)cudaGetLastError();
}

// The grid of a persistent BVH kernel over n items: the blocks that fit
// on the card at once at smem bytes each, and no more than n needs.
template <class K>
int persistent_grid(K kernel, size_t smem, int n, int& grid) {
  if (const int err = set_smem(kernel, smem)) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBvhBlock, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int need = (n + kBvhBlock - 1) / kBvhBlock;
  grid = sms * per_sm < need ? sms * per_sm : need;
  return 0;
}

template <class Smp>
int launch_fused_bvh(const BvhGeo& geo, const float* o, const float* d,
                     const uint32_t* px, const uint32_t* py, const uint32_t* sample,
                     const float* shade, int n, int n_mats, int n_lights, int n_em,
                     int max_depth, int rr_start_depth, uint32_t seed, int qmc_dims,
                     int* counter, float* out, void* stream) {
  const size_t smem = sizeof(float) * (size_t)shade_floats(n_mats, n_lights, n_em);
  int grid = 0;
  if (const int err = persistent_grid(pt_fused_bvh_kernel<Smp>, smem, n, grid)) return err;
  pt_fused_bvh_kernel<Smp><<<grid, kBvhBlock, smem, (cudaStream_t)stream>>>(
      geo, o, d, px, py, sample, shade, n, n_mats, n_lights, n_em, max_depth,
      rr_start_depth, seed, qmc_dims, counter, out);
  return (int)cudaGetLastError();
}

template <class Smp>
int launch_bounce(const BvhGeo& geo, float* st, const int64_t* perm,
                  int* keys, const float* bounds, const float* shade, int n, int n_mats,
                  int n_lights, int n_em, int depth, int rr_start_depth, uint32_t seed,
                  int qmc_dims, int* counter, void* stream) {
  const size_t smem = sizeof(float) * (size_t)shade_floats(n_mats, n_lights, n_em);
  int grid = 0;
  if (const int err = persistent_grid(pt_bounce_kernel<Smp>, smem, n, grid)) return err;
  pt_bounce_kernel<Smp><<<grid, kBvhBlock, smem, (cudaStream_t)stream>>>(
      geo, st, perm, keys, bounds, shade, n, n_mats, n_lights, n_em, depth,
      rr_start_depth, seed, qmc_dims, counter);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain-C entry points (ctypes). Device pointers; return the CUDA error
// code (0 = launched). sampler: 0 hash, 1 Halton (qmc_dims leading
// dimensions); seed is the sampler's seed.
//
// The whole-path kernel: o, d (n,3); px, py, sample (n,) u32; out (n,3).
// Brute force: tables = triangle rows (T,12) [v0, material id | e0, 0 |
// e1, 0] | shading tables, as packed once per scene by ops/shade_tables.py
// (pack_brute_tables), 16-byte aligned.
extern "C" int pt_fused_bruteforce(const float* o, const float* d, const uint32_t* px,
                                   const uint32_t* py, const uint32_t* sample,
                                   const float* tables, int n, int n_tris, int n_mats,
                                   int n_lights, int n_em, int max_depth,
                                   int rr_start_depth, int sampler, uint32_t seed,
                                   int qmc_dims, float* out, void* stream) {
  const BruteGeo geo{n_tris, nullptr};
  if (sampler == 0)
    return launch<BruteGeo, HashRng>(geo, o, d, px, py, sample, tables, n, n_mats, n_lights,
                                     n_em, max_depth, rr_start_depth, seed, qmc_dims, out,
                                     stream);
  if (sampler == 1)
    return launch<BruteGeo, HaltonRng>(geo, o, d, px, py, sample, tables, n, n_mats, n_lights,
                                       n_em, max_depth, rr_start_depth, seed, qmc_dims, out,
                                       stream);
  return (int)cudaErrorInvalidValue;
}

// BVH: shade = the shading tables (pack_shade_tables); nodes (M, 64)
// compact nodes (ops/bvh.py pack_nodes); rows (Tp, 12) f32 triangle rows
// and tri_mat (Tp,) i32 in packed-BVH order; counter one zeroed int32.
extern "C" int pt_fused_bvh(const float* o, const float* d, const uint32_t* px,
                            const uint32_t* py, const uint32_t* sample,
                            const float* shade, const float* nodes, const float* rows,
                            const int* tri_mat, int n, int n_mats,
                            int n_lights, int n_em, int max_depth, int rr_start_depth,
                            int sampler, uint32_t seed, int qmc_dims, int* counter,
                            float* out, void* stream) {
  const BvhGeo geo{CompactBvh{reinterpret_cast<const float4*>(nodes),
                              reinterpret_cast<const float4*>(rows)},
                   tri_mat};
  if (sampler == 0)
    return launch_fused_bvh<HashRng>(geo, o, d, px, py, sample, shade, n, n_mats,
                                     n_lights, n_em, max_depth, rr_start_depth, seed,
                                     qmc_dims, counter, out, stream);
  if (sampler == 1)
    return launch_fused_bvh<HaltonRng>(geo, o, d, px, py, sample, shade, n, n_mats,
                                       n_lights, n_em, max_depth, rr_start_depth, seed,
                                       qmc_dims, counter, out, stream);
  return (int)cudaErrorInvalidValue;
}

// One bounce at `depth` over the (n, 24) path-state rows st (layout at
// pt_bounce_kernel), in place, thread t on row perm[t] (perm (n,) int64,
// or null for the identity); keys (n,) int32 receives each row's sort key;
// bounds (2, 3) f32 the sort box; the BVH tables as for pt_fused_bvh.
extern "C" int pt_bounce_bvh(float* st, const int64_t* perm, int* keys, const float* bounds,
                             const float* shade, const float* nodes, const float* rows,
                             const int* tri_mat, int n, int n_mats,
                             int n_lights, int n_em, int depth, int rr_start_depth,
                             int sampler, uint32_t seed, int qmc_dims, int* counter,
                             void* stream) {
  const BvhGeo geo{CompactBvh{reinterpret_cast<const float4*>(nodes),
                              reinterpret_cast<const float4*>(rows)},
                   tri_mat};
  if (sampler == 0)
    return launch_bounce<HashRng>(geo, st, perm, keys, bounds, shade, n, n_mats,
                                  n_lights, n_em, depth, rr_start_depth, seed, qmc_dims,
                                  counter, stream);
  if (sampler == 1)
    return launch_bounce<HaltonRng>(geo, st, perm, keys, bounds, shade, n, n_mats,
                                    n_lights, n_em, depth, rr_start_depth, seed, qmc_dims,
                                    counter, stream);
  return (int)cudaErrorInvalidValue;
}

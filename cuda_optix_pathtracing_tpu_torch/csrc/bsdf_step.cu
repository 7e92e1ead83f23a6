// The BSDF stage of the unfused bounce (models/megakernel.py bounce_step,
// span pt.bsdf) in one launch: pt_bsdf_step, one thread a row. It replaces
// no TPU kernel (the reference runs this stage as XLA ops, as the plain
// route runs it as some 1,370 PyTorch launches a bounce); like the camera
// kernel it is port-only, and it serves every scene outside the fused gate
// (textures, shading normals, instances, light trees, env NEE).
//
// Each row draws BSDF_U, BSDF_UC and RR at depth * 24 from its own keys
// (rng.cuh, the hash or the Halton sampler), samples its material about
// its shading normal (Oren-Nayar, Lambert, GGX dielectric and conductor,
// isotropic or not, delta or rough; eta flipped inside a dielectric),
// updates beta, the transmission state and eta_scale, applies Russian
// roulette from rr_start_depth, spawns the ray off the surface and keeps
// the old state where the path ends, as the plain stage's torch.where
// rules do; in textured scenes it carries the ray cone, with a light tree
// the shading normal (prev_n). It reads the gathered material columns as
// the shading stage left them (textured or not), one pointer a column.
//
// Arithmetic: models/bsdf_step.py bsdf_step_plain and ops/bsdf.py
// sample_bsdf, op for op in the plain route's order, every product, sum,
// quotient and square root rounded on its own as one PyTorch elementwise
// kernel rounds it (the _rn intrinsics are never contracted into FMAs);
// the libm calls PyTorch's CUDA kernels make (cosf, sinf, acosf, the
// approximate rsqrtf of torch.rsqrt, nextafterf); a Python scalar divisor
// as PyTorch applies it on the card, as a product with its float
// reciprocal, and a scalar over a tensor as the tensor's reciprocal times
// the scalar (Tensor.__rtruediv__); torch.clamp and torch.maximum keep a
// NaN. The lobes a scene lacks are dropped as cfg.features drops them. So
// the new state is the plain stage's bit for bit.
//
// Bound by bytes: a live row reads ~230 B (state, hit, normals, eleven
// material columns, keys) and writes ~70-90 B; a dead row reads its flag
// and copies its state. The shading arithmetic (a few hundred flops, two
// to five transcendental calls) stays well under the bytes' time, so the
// design is one pass over the rows with nothing staged: no shared memory,
// coalesced row-major loads.
#include "rng.cuh"

#define INV_PI_F 0.318309886183790671538f
#define DELTA_ALPHA 1e-3f
#define THROUGHPUT_EPS 1e-6f
#define DIMS_PER_BOUNCE 24
#define DIFFUSE_CONE_SPREAD 0.3f  // models/bsdf_step.py

// material ids (ops/bsdf.py)
#define OREN_NAYAR 0
#define GGX_DIELECTRIC 1
#define GGX_CONDUCTOR 2
#define LAMBERT 3

// ops/bsdf.py MatFeatures, as the wrapper packs them
#define FT_OREN_NAYAR 1
#define FT_LAMBERT 2
#define FT_GGX 4
#define FT_CONDUCTOR 8
#define FT_TRANSMISSION 16
#define FT_ANISO 32

// the E(cos, alpha^2) and Eavg(alpha^2) polynomials (ops/shade_tables.py _epoly)
#define E_DEG 6

// The kernel's arguments (models/bsdf_step.py mirrors this struct with
// ctypes). (n, 3) and (n,) rows, row-major and contiguous; float32, the
// flags one byte each (torch.bool), mtype int32, keys and depth int64.
struct BsdfStepArgs {
  // path state in
  const float* o;
  const float* d;
  const float* beta;
  const float* eta_scale;
  const float* prev_pdf;
  const uint8_t* alive;  // the shading stage's: state.alive & hit
  const uint8_t* inside;
  const uint8_t* prev_delta;
  const float* cone_w;       // textured scenes, else null (with cone_s,
  const float* cone_s;       // cone_at_hit and their outputs)
  const float* cone_at_hit;  // the cone's width at the hit
  const float* prev_n;       // light tree, else null (with prev_n_out)
  // hit and shading normal
  const float* ns;
  const float* pos;
  const float* error;
  const float* normal;
  // gathered material columns
  const int* mtype;
  const float* albedo;
  const float* on_sigma;
  const float* alphax;
  const float* alphay;
  const float* phi0;
  const float* eta;
  const float* refl_tint;
  const float* trans_tint;
  const float* cond_eta;
  const float* cond_k;
  // keys: px, py (n,); sample (n,) or null for sample0; depth (n,) or null
  // for depth0
  const int64_t* px;
  const int64_t* py;
  const int64_t* sample;
  const int64_t* depth;
  const float* epoly;  // 49 E and 7 Eavg coefficients
  // path state out
  float* o_out;
  float* d_out;
  float* beta_out;
  float* eta_scale_out;
  float* prev_pdf_out;
  uint8_t* alive_out;
  uint8_t* inside_out;
  uint8_t* prev_delta_out;
  float* cone_w_out;
  float* cone_s_out;
  float* prev_n_out;
  long long n;
  long long depth0;
  uint32_t sample0;
  uint32_t seed;
  int rr_start_depth;
  int sampler;  // 0 hash, 1 Halton
  int qmc_dims;
  int features;  // FT_* bits
};

namespace {

constexpr int kBsdfBlock = 256;

// ---- one PyTorch elementwise op each ----------------------------------------

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fmul_rn(a, a); }
// torch.reciprocal: 1 / x, and 1.0 / x in Python (reciprocal times 1)
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
// torch.clamp and torch.maximum, which keep a NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float safe_sqrt(float x) { return __fsqrt_rn(clamp_min(x, 0.0f)); }

// (x + y + z) / 3.0: a Python scalar divisor is a product with its
// reciprocal on the card
__device__ __forceinline__ float avg3(float3 v) {
  return mul(add(add(v.x, v.y), v.z), 1.0f / 3.0f);
}

__device__ __forceinline__ float3 f3(float x, float y, float z) { return make_float3(x, y, z); }
__device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return f3(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z));
}
__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return f3(sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z));
}
__device__ __forceinline__ float3 scale3(float3 a, float s) {
  return f3(mul(a.x, s), mul(a.y, s), mul(a.z, s));
}
__device__ __forceinline__ float3 mul3(float3 a, float3 b) {
  return f3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}
__device__ __forceinline__ float3 neg3(float3 a) { return f3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return f3(sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x)));
}
__device__ __forceinline__ float3 zero3() { return f3(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float3 load3(const float* __restrict__ p, long long r) {
  return f3(p[3 * r], p[3 * r + 1], p[3 * r + 2]);
}
__device__ __forceinline__ void store3(float* __restrict__ p, long long r, float3 v) {
  p[3 * r] = v.x;
  p[3 * r + 1] = v.y;
  p[3 * r + 2] = v.z;
}

// ---- ops/vecmath.py, ops/sampling.py ----------------------------------------

// v * where(l2 > 0, rsqrt(clamp(l2, 1e-38)), 0): torch.rsqrt is the
// approximate rsqrtf on the card
__device__ __forceinline__ float3 normalize3(float3 v) {
  const float l2 = dot3(v, v);
  return scale3(v, l2 > 0.0f ? rsqrtf(clamp_min(l2, 1e-38f)) : 0.0f);
}

__device__ __forceinline__ void gram_schmidt(float3 n, float3& t, float3& b) {
  const bool near_diag = fabsf(sub(n.x, n.y)) <= 1e-3f && fabsf(sub(n.x, n.z)) <= 1e-3f;
  const float3 a = f3(sub(n.z, n.y), near_diag ? add(n.x, n.z) : sub(n.x, n.z),
                      near_diag ? sub(-n.y, n.x) : sub(n.y, n.x));
  t = normalize3(a);
  b = cross3(n, t);
}

__device__ __forceinline__ float2 sample_uniform_disk(float u1, float u2) {
  const float a = sub(mul(2.0f, u1), 1.0f);
  const float b = sub(mul(2.0f, u2), 1.0f);
  if (a == 0.0f && b == 0.0f) return make_float2(0.0f, 0.0f);
  const bool a_dom = fabsf(a) > fabsf(b);
  const float rho = a_dom ? a : b;
  const float ratio = a_dom ? dvd(b, a == 0.0f ? 1.0f : a) : dvd(a, b == 0.0f ? 1.0f : b);
  const float q = mul((float)(M_PI / 4.0), ratio);
  const float phi = a_dom ? q : sub((float)(M_PI / 2.0), q);
  return make_float2(mul(rho, cosf(phi)), mul(rho, sinf(phi)));
}

__device__ __forceinline__ float3 sample_cos_hemisphere(float3 n, float u1, float u2,
                                                        float& pdf) {
  const float2 xy = sample_uniform_disk(u1, u2);
  const float cos_theta = safe_sqrt(sub(1.0f, add(mul(xy.x, xy.x), mul(xy.y, xy.y))));
  float3 t, b;
  gram_schmidt(n, t, b);
  pdf = mul(cos_theta, INV_PI_F);
  return add3(add3(scale3(t, xy.x), scale3(b, xy.y)), scale3(n, cos_theta));
}

// offset_ray_origin: off the surface along +-ng by the error bound, then one
// ulp away from it
__device__ __forceinline__ float3 offset_ray_origin(float3 p, float3 err, float3 ng,
                                                    float3 w) {
  const float dm =
      add(add(mul(fabsf(ng.x), err.x), mul(fabsf(ng.y), err.y)), mul(fabsf(ng.z), err.z));
  float3 off = scale3(ng, dm);
  if (dot3(w, ng) < 0.0f) off = neg3(off);
  const float3 po = add3(p, off);
  return f3(nextafterf(po.x, off.x > 0.0f ? INFINITY : -INFINITY),
            nextafterf(po.y, off.y > 0.0f ? INFINITY : -INFINITY),
            nextafterf(po.z, off.z > 0.0f ? INFINITY : -INFINITY));
}

// ---- ops/bsdf.py ----------------------------------------------------------------

struct Mat {
  int type;
  float3 albedo;
  float sigma, ax, ay, phi0, eta;
  float3 refl, trans, ceta, ck;
};

__device__ __forceinline__ float ggx_lambda_tan(float s) {
  return mul(0.5f, sub(__fsqrt_rn(add(1.0f, s)), 1.0f));
}
__device__ __forceinline__ float ggx_d(float alpha2, float cos_nh) {
  const float c2 = clamp_max(sqr(cos_nh), 1.0f);
  return dvd(alpha2, mul((float)M_PI, sqr(add(sub(1.0f, c2), mul(alpha2, c2)))));
}
__device__ __forceinline__ float ggx_lambda(float alpha2, float cos_n) {
  const float s = mul(alpha2, clamp_min(sub(rcp(clamp_min(sqr(cos_n), 1e-12f)), 1.0f), 0.0f));
  return ggx_lambda_tan(s);
}
__device__ __forceinline__ float ggx_aniso_d(float ax, float ay, float3 h) {
  const float hx = dvd(h.x, ax), hy = dvd(h.y, ay);
  const float len2 = add(add(mul(hx, hx), mul(hy, hy)), mul(h.z, h.z));
  // INV_PI / t: t's reciprocal times INV_PI
  return mul(rcp(clamp_min(mul(mul(ax, ay), sqr(len2)), 1e-20f)), INV_PI_F);
}
__device__ __forceinline__ float ggx_aniso_lambda(float ax, float ay, float3 v) {
  return ggx_lambda_tan(
      dvd(add(sqr(mul(ax, v.x)), sqr(mul(ay, v.y))), clamp_min(sqr(v.z), 1e-12f)));
}

__device__ float3 sample_ggx_vndf(float3 lo, float u1, float u2, float ax, float ay) {
  const float3 v = normalize3(f3(mul(ax, lo.x), mul(ay, lo.y), lo.z));
  const float lensq = add(sqr(v.x), sqr(v.y));
  const float inv_len = rcp(__fsqrt_rn(clamp_min(lensq, 1e-14f)));
  float3 t1 = f3(1.0f, 0.0f, 0.0f), t2 = f3(0.0f, 1.0f, 0.0f);
  if (lensq > 1e-7f) {
    t1 = f3(mul(-v.y, inv_len), mul(v.x, inv_len), 0.0f);
    t2 = cross3(v, t1);
  }
  const float2 dd = sample_uniform_disk(u1, u2);
  const float tt = mul(0.5f, add(1.0f, v.z));
  // lerp(a, b, t) = a (1 - t) + b t
  const float dy = add(mul(safe_sqrt(sub(1.0f, sqr(dd.x))), sub(1.0f, tt)), mul(dd.y, tt));
  const float3 nh =
      add3(add3(scale3(t1, dd.x), scale3(t2, dy)),
           scale3(v, safe_sqrt(sub(sub(1.0f, sqr(dd.x)), sqr(dy)))));
  return normalize3(f3(mul(ax, nh.x), mul(ay, nh.y), clamp_min(nh.z, 0.0f)));
}

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta, float& cos_t) {
  cos_i = clamp(cos_i, 0.0f, 1.0f);
  const float sin_i = safe_sqrt(sub(1.0f, sqr(cos_i)));
  const float sin_t = dvd(sin_i, eta);
  cos_t = safe_sqrt(sub(1.0f, sqr(sin_t)));
  if (sin_t >= 1.0f) return 1.0f;
  const float r_parl =
      dvd(sub(mul(eta, cos_i), cos_t), clamp_min(add(mul(eta, cos_i), cos_t), 1e-12f));
  const float r_perp =
      dvd(sub(cos_i, mul(eta, cos_t)), clamp_min(add(cos_i, mul(eta, cos_t)), 1e-12f));
  return mul(0.5f, add(sqr(r_parl), sqr(r_perp)));
}

__device__ float fresnel_conductor1(float cos_i, float e, float k) {
  cos_i = clamp(cos_i, -1.0f, 1.0f);
  const float cos2 = sqr(cos_i);
  const float sin2 = sub(1.0f, cos2);
  const float e2 = sqr(e), k2 = sqr(k);
  const float t0 = sub(sub(e2, k2), sin2);
  const float a2b2 = __fsqrt_rn(clamp_min(add(sqr(t0), mul(mul(4.0f, e2), k2)), 0.0f));
  const float t1 = add(a2b2, cos2);
  const float a = __fsqrt_rn(clamp_min(mul(0.5f, add(a2b2, t0)), 0.0f));
  const float t2 = mul(mul(2.0f, cos_i), a);
  const float rs = dvd(sub(t1, t2), clamp_min(add(t1, t2), 1e-12f));
  const float t3 = add(mul(cos2, a2b2), sqr(sin2));
  const float t4 = mul(t2, sin2);
  const float rp = dvd(mul(rs, sub(t3, t4)), clamp_min(add(t3, t4), 1e-12f));
  return mul(0.5f, add(rp, rs));
}

__device__ __forceinline__ float3 fresnel_conductor(float cos_i, float3 e, float3 k) {
  return f3(fresnel_conductor1(cos_i, e.x, k.x), fresnel_conductor1(cos_i, e.y, k.y),
            fresnel_conductor1(cos_i, e.z, k.z));
}

// lerp(f0, 1, 0.46266436), lerp(f0, 1, 1/21): the scalars' (1 - t) in double
__device__ __forceinline__ float fss_conductor1(float e, float k) {
  const float f0 = fresnel_conductor1(1.0f, e, k);
  const float f82 = fresnel_conductor1((float)(1.0 / 7.0), e, k);
  const float b =
      mul(sub(add(mul(f0, (float)(1.0 - 0.46266436)), 0.46266436f), f82), 17.651384f);
  return sub(add(mul(f0, (float)(1.0 - 1.0 / 21.0)), (float)(1.0 / 21.0)),
             mul(b, (float)(1.0 / 126.0)));
}

__device__ float lookup_e(const float* __restrict__ ep, float alpha2, float cos_no) {
  const float x = clamp(cos_no, 0.0f, 1.0f), y = clamp(alpha2, 0.0f, 1.0f);
  float acc = 0.0f;
  for (int i = E_DEG; i >= 0; --i) {
    float row = 0.0f;
    for (int j = E_DEG; j >= 0; --j) row = add(mul(row, y), __ldg(ep + i * (E_DEG + 1) + j));
    acc = add(mul(acc, x), row);
  }
  return clamp(acc, 1e-3f, 1.0f);
}

__device__ float lookup_eavg(const float* __restrict__ ep, float alpha2) {
  const float y = clamp(alpha2, 0.0f, 1.0f);
  float acc = 0.0f;
  for (int i = E_DEG; i >= 0; --i)
    acc = add(mul(acc, y), __ldg(ep + (E_DEG + 1) * (E_DEG + 1) + i));
  return clamp(acc, 1e-3f, 1.0f);
}

// Kulla-Conty multiple-scattering multiplier 1 + Fms (1 - E) / E
__device__ float3 ggx_multiscatter(const float* __restrict__ ep, const Mat& m, float cos_no,
                                   int ft) {
  const float alpha2 = mul(m.ax, m.ay);
  const float e = lookup_e(ep, alpha2, cos_no);
  const float eavg = lookup_eavg(ep, alpha2);
  float3 fss = m.trans;
  if ((ft & FT_CONDUCTOR) && m.type == GGX_CONDUCTOR)
    fss = f3(fss_conductor1(m.ceta.x, m.ck.x), fss_conductor1(m.ceta.y, m.ck.y),
             fss_conductor1(m.ceta.z, m.ck.z));
  const float missing = dvd(sub(1.0f, e), e);
  const float one_m = sub(1.0f, eavg);
  float r[3];
  const float f[3] = {fss.x, fss.y, fss.z};
  for (int c = 0; c < 3; ++c)
    r[c] = add(1.0f, mul(dvd(mul(f[c], eavg), clamp_min(sub(1.0f, mul(f[c], one_m)), 1e-4f)),
                         missing));
  return f3(r[0], r[1], r[2]);
}

__device__ float oren_nayar_g(float cos_theta) {
  const bool small = cos_theta < 1e-6f;
  const float c = small ? 0.5f : cos_theta;
  const float sin_t = safe_sqrt(sub(1.0f, sqr(c)));
  const float theta = acosf(clamp(c, -1.0f, 1.0f));
  const float main =
      add(mul(sin_t, sub(sub(theta, (float)(2.0 / 3.0)), mul(sin_t, c))),
          mul(mul((float)(2.0 / 3.0), dvd(sin_t, c)), sub(1.0f, mul(sqr(sin_t), sin_t))));
  return small ? sub((float)(M_PI / 2.0 - 2.0 / 3.0), cos_theta) : main;
}

__device__ float3 oren_nayar_fcos(const Mat& m, float3 n, float3 wo, float3 wi) {
  // a = 1.0 / (PI + (PI / 2 - 2 / 3) sigma), b = a sigma
  const float a = rcp(add(mul(m.sigma, (float)(M_PI / 2.0 - 2.0 / 3.0)), (float)M_PI));
  const float b = mul(a, m.sigma);
  const float nl = clamp_min(dot3(n, wi), 0.0f);
  const float nv = clamp_min(dot3(n, wo), 0.0f);
  float t = sub(dot3(wi, wo), mul(nl, nv));
  if (t > 0.0f) t = dvd(t, add(maximum(nl, nv), 1e-38f));
  const float single = add(a, mul(b, t));
  const float e_l = add(mul(a, (float)M_PI), mul(b, oren_nayar_g(nl)));
  const float e_v = add(mul(a, (float)M_PI), mul(b, oren_nayar_g(nv)));
  const float one_v = sub(1.0f, e_v), one_l = sub(1.0f, e_l);
  const float al[3] = {m.albedo.x, m.albedo.y, m.albedo.z};
  float r[3];
  for (int c = 0; c < 3; ++c) {
    const float ms = mul(clamp_min(mul(al[c], one_v), 0.0f), one_l);
    r[c] = mul(mul(al[c], nl), add(single, ms));
  }
  return f3(r[0], r[1], r[2]);
}

struct BsdfSample {
  float3 wi, f;
  float pdf, eta;
  bool delta, refract;
};

// ops/bsdf.py sample_bsdf on one row: the lobe of the row's material, as
// the plain version's torch.where picks it from every lobe's values
__device__ BsdfSample sample_bsdf(const float* __restrict__ ep, const Mat& m, float3 wo,
                                  float3 ns, float3 ng, float u1, float u2, float uc,
                                  bool inside, int ft) {
  BsdfSample s;
  s.eta = 1.0f;
  s.delta = false;
  s.refract = false;
  const bool valid_side = dot3(wo, ng) > 0.0f;
  if (dot3(ns, ng) < 0.0f) ns = neg3(ns);  // face_forward
  const float cos_no = dot3(ns, wo);
  const bool diffuse = ft & (FT_OREN_NAYAR | FT_LAMBERT);
  const bool is_ggx =
      !(ft & FT_GGX) ? false
                     : !diffuse || m.type == GGX_DIELECTRIC || m.type == GGX_CONDUCTOR;
  if (!is_ggx) {
    float pdf_d;
    s.wi = sample_cos_hemisphere(ns, u1, u2, pdf_d);
    const bool on = (ft & FT_OREN_NAYAR) && (!(ft & FT_LAMBERT) || m.type == OREN_NAYAR);
    if (dot3(ng, s.wi) > 0.0f) {
      s.f = on ? oren_nayar_fcos(m, ns, wo, s.wi) : scale3(m.albedo, pdf_d);
      s.pdf = pdf_d;
    } else {
      s.f = zero3();
      s.pdf = 0.0f;
    }
  } else {
    const bool cond = (ft & FT_CONDUCTOR) && m.type == GGX_CONDUCTOR;
    const bool is_delta = maximum(m.ax, m.ay) < DELTA_ALPHA;
    float3 t, b;
    gram_schmidt(ns, t, b);
    const float c = cosf(m.phi0), sn = sinf(m.phi0);
    const float3 xa = add3(scale3(t, c), scale3(b, sn));
    const float3 ya = cross3(ns, xa);
    const float3 lo = f3(dot3(xa, wo), dot3(ya, wo), cos_no);
    float3 lh = sample_ggx_vndf(lo, u1, u2, m.ax, m.ay);
    float3 h = add3(add3(scale3(xa, lh.x), scale3(ya, lh.y)), scale3(ns, lh.z));
    if (is_delta) {
      h = ns;
      lh = f3(0.0f, 0.0f, 1.0f);
    }
    const float cos_ho = dot3(h, wo);
    const float eta_eff = inside ? rcp(m.eta) : m.eta;
    float cos_hi;
    const float f_diel = fresnel_dielectric(cos_ho, eta_eff, cos_hi);
    const float3 refl = cond ? fresnel_conductor(cos_ho, m.ceta, m.ck) : scale3(m.refl, f_diel);
    const float3 trans = cond ? zero3() : scale3(m.trans, sub(1.0f, f_diel));
    const float inv_eta = rcp(eta_eff);
    float pr = 1.0f;
    bool do_refract = false;
    float3 wi;
    if (ft & FT_TRANSMISSION) {
      const float denom = clamp_min(avg3(add3(refl, trans)), 1e-12f);
      pr = clamp(dvd(avg3(refl), denom), 0.0f, 1.0f);
      do_refract = uc > pr;
    }
    if (do_refract) {  // refract_angle(wo, h, cos_hi, inv_eta)
      const float cr = sub(mul(inv_eta, dot3(wo, h)), cos_hi);
      wi = sub3(scale3(h, cr), scale3(wo, inv_eta));
    } else {
      wi = sub3(scale3(h, mul(2.0f, cos_ho)), wo);
    }
    const bool bad_hemi = dot3(ng, wi) <= 0.0f && !do_refract;
    const float lobe = do_refract ? sub(1.0f, pr) : pr;
    const float3 f_g = do_refract ? trans : refl;
    const bool zero_fres = avg3(refl) < THROUGHPUT_EPS && avg3(trans) < THROUGHPUT_EPS;
    const bool invalid = bad_hemi || zero_fres;
    s.wi = wi;
    s.delta = is_delta;
    s.refract = do_refract && !invalid;
    s.eta = s.refract ? eta_eff : 1.0f;
    if (invalid) {
      s.f = zero3();
      s.pdf = 0.0f;
    } else if (is_delta) {
      // f/pdf must equal the Fresnel-weighted tint; encoded with pdf = lobe
      s.f = scale3(f_g, lobe);
      s.pdf = lobe;
    } else {
      const float alpha2 = mul(m.ax, m.ay);
      float d_val, lam_i, lam_o;
      if (!(ft & FT_ANISO) || m.ax == m.ay || do_refract) {
        d_val = ggx_d(alpha2, lh.z);
        lam_i = ggx_lambda(alpha2, dot3(ns, wi));
        lam_o = ggx_lambda(alpha2, cos_no);
      } else {
        const float3 li = sub3(scale3(lh, mul(2.0f, cos_ho)), lo);
        d_val = ggx_aniso_d(m.ax, m.ay, lh);
        lam_i = ggx_aniso_lambda(m.ax, m.ay, li);
        lam_o = ggx_aniso_lambda(m.ax, m.ay, lo);
      }
      const float jac =
          do_refract ? dvd(fabsf(mul(cos_ho, cos_hi)),
                           clamp_min(sqr(add(cos_hi, mul(cos_ho, inv_eta))), 1e-8f))
                     : 0.25f;
      const float common = mul(dvd(d_val, clamp_min(cos_no, 1e-6f)), jac);
      s.pdf = dvd(mul(lobe, common), add(1.0f, lam_o));
      s.f = scale3(f_g, dvd(common, add(add(1.0f, lam_o), lam_i)));
      if (!do_refract) s.f = mul3(s.f, ggx_multiscatter(ep, m, cos_no, ft));
    }
  }
  if (!valid_side) {
    s.f = zero3();
    s.pdf = 0.0f;
  }
  return s;
}

// ---- the stage ----------------------------------------------------------------

template <class Smp>
__global__ void __launch_bounds__(kBsdfBlock) pt_bsdf_step_kernel(const BsdfStepArgs a) {
  const long long r = (long long)blockIdx.x * kBsdfBlock + threadIdx.x;
  if (r >= a.n) return;
  const bool textured = a.cone_w != nullptr;
  const bool tree = a.prev_n != nullptr;
  const float3 o = load3(a.o, r), d = load3(a.d, r), beta = load3(a.beta, r);
  const bool inside = a.inside[r] != 0;
  float eta_scale = a.eta_scale[r];
  bool alive = a.alive[r] != 0;
  // the old state, kept where the path ends
  float3 o_new = o, d_new = d, beta_new = beta;
  float prev_pdf = a.prev_pdf[r];
  bool prev_delta = a.prev_delta[r] != 0, inside_new = inside;
  float cone_w = textured ? a.cone_w[r] : 0.0f, cone_s = textured ? a.cone_s[r] : 0.0f;
  float3 prev_n = tree ? load3(a.prev_n, r) : zero3();
  if (alive) {
    const long long depth = a.depth ? a.depth[r] : a.depth0;
    const uint32_t dim = (uint32_t)(depth * DIMS_PER_BOUNCE);
    const Smp rng = path_rng<Smp>(a.px, a.py, a.sample, a.sample0, (int)r, a.seed, a.qmc_dims);
    const float2 u = rng.u2(dim + 5u);  // Dim.BSDF_U
    const float uc = rng.u1(dim + 7u);  // Dim.BSDF_UC
    Mat m;
    m.type = a.mtype[r];
    m.albedo = load3(a.albedo, r);
    m.sigma = a.on_sigma[r];
    m.ax = a.alphax[r];
    m.ay = a.alphay[r];
    m.phi0 = a.phi0[r];
    m.eta = a.eta[r];
    m.refl = load3(a.refl_tint, r);
    m.trans = load3(a.trans_tint, r);
    m.ceta = load3(a.cond_eta, r);
    m.ck = load3(a.cond_k, r);
    const float3 ns = load3(a.ns, r), ng = load3(a.normal, r);
    const BsdfSample bs =
        sample_bsdf(a.epoly, m, neg3(d), ns, ng, u.x, u.y, uc, inside, a.features);

    const bool valid = bs.pdf > 0.0f;
    const float pdf = clamp_min(bs.pdf, 1e-12f);
    float3 b = mul3(beta, valid ? f3(dvd(bs.f.x, pdf), dvd(bs.f.y, pdf), dvd(bs.f.z, pdf))
                                : f3(1.0f, 1.0f, 1.0f));
    alive = valid;
    const bool flip = bs.refract && alive;
    inside_new = inside != flip;
    if (flip) eta_scale = mul(eta_scale, sqr(bs.eta));

    // russian roulette on beta * prod(eta^2) from rr_start_depth on
    const float rr_beta = mul(maximum(maximum(b.x, b.y), b.z), eta_scale);
    const float u_rr = rng.u1(dim + 8u);  // Dim.RR
    const float q = clamp_min(sub(1.0f, rr_beta), 0.0f);
    const bool do_rr = rr_beta < 1.0f && depth >= a.rr_start_depth;
    const bool killed = do_rr && u_rr < q;
    const float survived = do_rr && !killed ? rcp(clamp_min(sub(1.0f, q), 1e-6f)) : 1.0f;
    b = scale3(b, survived);
    alive = alive && !killed;
    if (alive) {
      o_new = offset_ray_origin(load3(a.pos, r), load3(a.error, r), ng, bs.wi);
      d_new = bs.wi;
      beta_new = b;
      prev_pdf = bs.pdf;
      prev_delta = bs.delta;
      if (textured) {
        cone_w = a.cone_at_hit[r];
        if (!bs.delta) cone_s = clamp_min(cone_s, DIFFUSE_CONE_SPREAD);
      }
      if (tree) prev_n = ns;
    }
  }
  store3(a.o_out, r, o_new);
  store3(a.d_out, r, d_new);
  store3(a.beta_out, r, beta_new);
  a.eta_scale_out[r] = eta_scale;
  a.prev_pdf_out[r] = prev_pdf;
  a.alive_out[r] = alive;
  a.inside_out[r] = inside_new;
  a.prev_delta_out[r] = prev_delta;
  if (textured) {
    a.cone_w_out[r] = cone_w;
    a.cone_s_out[r] = cone_s;
  }
  if (tree) store3(a.prev_n_out, r, prev_n);
}

template <class Smp>
int launch_bsdf_step(const BsdfStepArgs& a, void* stream) {
  const long long grid = (a.n + kBsdfBlock - 1) / kBsdfBlock;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  pt_bsdf_step_kernel<Smp><<<(unsigned)grid, kBsdfBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain-C entry point (ctypes): one launch of the stage over a->n rows on
// `stream`, device pointers in *a (layout above). Returns the CUDA error code
// (0 = launched); launches nothing for n = 0.
extern "C" int pt_bsdf_step(const BsdfStepArgs* a, void* stream) {
  if (a->n < 0 || (a->cone_w == nullptr) != (a->cone_at_hit == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  if (a->sampler == 0) return launch_bsdf_step<HashRng>(*a, stream);
  if (a->sampler == 1) return launch_bsdf_step<HaltonRng>(*a, stream);
  return (int)cudaErrorInvalidValue;
}

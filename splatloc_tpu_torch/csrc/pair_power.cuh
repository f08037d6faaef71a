// Shared by the forward and backward pair walks: the per-pair table layout,
// the per-pair records the walks keep in shared memory, their staging, and
// the evaluation of a pair's power at a pixel, rounded as the JAX package's
// kernels round it (see fwd_pairwalk.cu for why the rounding is kept: the
// tile-local quadratic is ill-conditioned for pairs far from the tile
// origin).
#pragma once

#include <cuda_bf16.h>

namespace pairwalk {

// attribute-major row layout of the per-pair table gpair [rows, PC]; the
// walks read its first N_FIXED + C rows
constexpr int R_X = 0, R_Y = 1, R_CA = 2, R_CB = 3, R_CC = 4, R_OP = 5,
              R_DEPTH = 6, N_FIXED = 7;
constexpr int MAX_CHANNELS = 24;
constexpr float POWER_KEEP_EPS = 1e-5f;
constexpr float KEEP_EPS_SCALE = 6.103515625e-05f;   // 2^-14
constexpr unsigned FULL = 0xffffffffu;
// segment alignment: every tile's segment starts at a multiple of CHUNK and
// spans a multiple of CHUNK pairs
constexpr int CHUNK = 128;
// most threads a walk block has: two pixels per thread, 32x32 tiles
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float bf16_limb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The pair's six power coefficients in tile-local pixel coordinates, given
// its centre relative to the tile origin (ex, ey) and its conic (ca, cb,
// cc), formed with the reference's fused multiply-adds, and split into
// their bf16 limbs hi[i] and remainders lo[i]. Returns the keep epsilon of
// the power <= 0 test: max(mag * 2^-14, 1e-5), mag the coefficients'
// largest possible contribution over the tile (tm1 = ts - 1).
__device__ __forceinline__ float power_limbs(float ex, float ey, float ca,
                                             float cb, float cc, float tm1,
                                             float* hi, float* lo) {
  const float a_ex = __fmul_rn(ca, ex);
  const float c_ey = __fmul_rn(cc, ey);
  const float b_ex = __fmul_rn(cb, ex);
  float cf[6];
  cf[0] = __fsub_rn(
      __fmul_rn(-0.5f, __fmaf_rn(a_ex, ex, __fmul_rn(c_ey, ey))),
      __fmul_rn(b_ex, ey));
  cf[1] = __fmaf_rn(ca, ex, __fmul_rn(cb, ey));
  cf[2] = __fmaf_rn(cc, ey, b_ex);
  cf[3] = __fmul_rn(-0.5f, ca);
  cf[4] = -cb;
  cf[5] = __fmul_rn(-0.5f, cc);
  const float mag = __fadd_rn(
      __fadd_rn(fabsf(cf[0]),
                __fmul_rn(tm1, __fadd_rn(fabsf(cf[1]), fabsf(cf[2])))),
      __fmul_rn(__fmul_rn(tm1, tm1),
                __fadd_rn(__fadd_rn(fabsf(cf[3]), fabsf(cf[4])),
                          fabsf(cf[5]))));
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float h = bf16_limb(cf[i]);
    hi[i] = h;
    lo[i] = __fsub_rn(cf[i], h);
  }
  return fmaxf(__fmul_rn(mag, KEEP_EPS_SCALE), POWER_KEEP_EPS);
}

// A power below which the pair's alpha is certainly cut (op * exp(power)
// below alpha_min), so a pixel there needs no expf: ln(alpha_min / op)
// less a margin of 1e-3 that covers the roundings of logf, expf (2 ulp)
// and the product, and at most 0, so that such a power passes the keep
// test and alpha = op * expf(power) <= op. -inf (no pixel skips) unless op
// and alpha_min are positive. A walk skips a pixel only where power < cut
// (a NaN power is never skipped), so the skip changes no value.
__device__ __forceinline__ float alpha_cut(float op, float alpha_min) {
  if (!(op > 0.f) || !(alpha_min > 0.f)) return -INFINITY;
  return fminf(logf(alpha_min / op) - 1e-3f, 0.f);
}

// A pair's evaluation record in shared memory: 16 floats, read as four
// float4: [h0 h1 h2 h3] [h4 h5 l0 l1] [l2 l3 l4 l5] [keep_eps op cut 0],
// the coefficients' bf16 limbs h, their remainders l, the keep epsilon,
// the opacity and alpha_cut.
struct EvalRec {
  float4 a, b, c, d;
};

__device__ __forceinline__ void make_eval_rec(float ex, float ey, float ca,
                                              float cb, float cc, float op,
                                              float tm1, float alpha_min,
                                              EvalRec* rec) {
  float h[6], l[6];
  const float eps = power_limbs(ex, ey, ca, cb, cc, tm1, h, l);
  rec->a = make_float4(h[0], h[1], h[2], h[3]);
  rec->b = make_float4(h[4], h[5], l[0], l[1]);
  rec->c = make_float4(l[2], l[3], l[4], l[5]);
  rec->d = make_float4(eps, op, alpha_cut(op, alpha_min), 0.f);
}

// power at the pixel with monomials (p, q, pp, pq, qq): the sum of the two
// limbs, each a running sum of exact products (every fmaf rounds only the
// sum), as the reference's limb-split matrix product computes it
__device__ __forceinline__ float eval_power(const EvalRec& r, float p,
                                            float q, float pp, float pq,
                                            float qq) {
  float ph = __fmaf_rn(r.a.y, p, r.a.x);
  ph = __fmaf_rn(r.a.z, q, ph);
  ph = __fmaf_rn(r.a.w, pp, ph);
  ph = __fmaf_rn(r.b.x, pq, ph);
  ph = __fmaf_rn(r.b.y, qq, ph);
  float pl = __fmaf_rn(r.b.w, p, r.b.z);
  pl = __fmaf_rn(r.c.x, q, pl);
  pl = __fmaf_rn(r.c.y, pp, pl);
  pl = __fmaf_rn(r.c.z, pq, pl);
  pl = __fmaf_rn(r.c.w, qq, pl);
  return __fadd_rn(ph, pl);
}

// Floats of a pair's attribute record for the instantiation that takes
// MAXC channels: the channels in slots 0..MAXC-1 (zero past C), the depth
// in slot MAXC, padded to a whole number of float4.
template <int MAXC>
__host__ __device__ constexpr int attr_stride() {
  return (MAXC + 1 + 3) / 4 * 4;
}

// ---- a thread's PIX adjacent pixels of an attribute-major [., P] plane ----

__device__ __forceinline__ void load_pixels(const float* src, float (&v)[1]) {
  v[0] = *src;
}
__device__ __forceinline__ void load_pixels(const float* src, float (&v)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(src);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void store_pixels(float* o, const float (&v)[1]) {
  *o = v[0];
}
__device__ __forceinline__ void store_pixels(float* o, const float (&v)[2]) {
  *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
}

// ---- staging: raw gpair columns into shared memory with cp.async ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most one of this thread's committed groups is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issues the copy of gpair's first n_rows rows, columns [col, col + S),
// into raw [n_rows][S]: every thread of the block takes 16-byte pieces.
// gpair's rows start 16-byte aligned (PC % 4 == 0) and col is a multiple
// of 4. The caller commits the group.
template <int S>
__device__ __forceinline__ void stage_rows(float* raw,
                                           const float* __restrict__ gpair,
                                           long long pc, long long col,
                                           int n_rows) {
  constexpr int PIECES = S / 4;
  for (int e = threadIdx.x; e < n_rows * PIECES; e += blockDim.x) {
    const int r = e / PIECES, c4 = (e % PIECES) * 4;
    cp_async16(raw + r * S + c4, gpair + r * pc + col + c4);
  }
}

}  // namespace pairwalk

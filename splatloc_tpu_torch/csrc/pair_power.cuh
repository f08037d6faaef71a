// Shared by the forward and backward pair walks: the per-pair table layout
// and the evaluation of a pair's power at a pixel, rounded as the JAX
// package's kernels round it (see fwd_pairwalk.cu for why the rounding is
// kept: the tile-local quadratic is ill-conditioned for pairs far from the
// tile origin).
#pragma once

#include <cuda_bf16.h>

namespace pairwalk {

// attribute-major row layout of the per-pair table gpair [rows, PC]
constexpr int R_X = 0, R_Y = 1, R_CA = 2, R_CB = 3, R_CC = 4, R_OP = 5,
              R_DEPTH = 6, N_FIXED = 7;
constexpr int MAX_CHANNELS = 24;
constexpr float POWER_KEEP_EPS = 1e-5f;
constexpr float KEEP_EPS_SCALE = 6.103515625e-05f;   // 2^-14

__device__ __forceinline__ float bf16_limb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The pair's six power coefficients in tile-local pixel coordinates, given
// its centre relative to the tile origin (ex, ey) and its conic (ca, cb,
// cc), formed with the reference's fused multiply-adds, and split into
// their bf16 limbs hi[i * stride] and remainders lo[i * stride]. Returns
// the keep epsilon of the power <= 0 test: max(mag * 2^-14, 1e-5), mag the
// coefficients' largest possible contribution over the tile (tm1 = ts - 1).
__device__ __forceinline__ float power_limbs(float ex, float ey, float ca,
                                             float cb, float cc, float tm1,
                                             float* hi, float* lo,
                                             int stride) {
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
    hi[i * stride] = h;
    lo[i * stride] = __fsub_rn(cf[i], h);
  }
  return fmaxf(__fmul_rn(mag, KEEP_EPS_SCALE), POWER_KEEP_EPS);
}

// power at the pixel with monomials (p, q, pp, pq, qq): the sum of the two
// limbs, each a running sum of exact products (every fmaf rounds only the
// sum), as the reference's limb-split matrix product computes it
__device__ __forceinline__ float eval_power(const float* h, const float* l,
                                            int stride, float p, float q,
                                            float pp, float pq, float qq) {
  float ph = __fmaf_rn(h[1 * stride], p, h[0]);
  ph = __fmaf_rn(h[2 * stride], q, ph);
  ph = __fmaf_rn(h[3 * stride], pp, ph);
  ph = __fmaf_rn(h[4 * stride], pq, ph);
  ph = __fmaf_rn(h[5 * stride], qq, ph);
  float pl = __fmaf_rn(l[1 * stride], p, l[0]);
  pl = __fmaf_rn(l[2 * stride], q, pl);
  pl = __fmaf_rn(l[3 * stride], pp, pl);
  pl = __fmaf_rn(l[4 * stride], pq, pl);
  pl = __fmaf_rn(l[5 * stride], qq, pl);
  return __fadd_rn(ph, pl);
}

}  // namespace pairwalk

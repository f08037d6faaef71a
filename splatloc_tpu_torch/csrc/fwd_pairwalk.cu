// Forward pair-walk: front-to-back alpha compositing of each tile's
// depth-sorted (Gaussian, tile) pair segment.
//
// Replaces splatloc_tpu/raster/pallas_raster.py::_fwd_kernel (launched by
// _run_fwd_kernel). Same per-pixel math as that kernel:
//   power  = c0 + c1 p + c2 q + c3 p^2 + c4 p q + c5 q^2 in tile-local pixel
//            coordinates (p, q), coefficients from the pair's centre
//            relative to the tile origin (_power_coeffs), kept where
//            power <= keep_eps = max(mag * 2^-14, 1e-5)
//   alpha  = op * exp(min(power, 0)), cut below alpha_min, clamped at
//            alpha_max
//   blend  while T - alpha T >= t_eps; n_contrib = absolute position of the
//          last blended pair; T_blend = product over blended pairs
// Output is attribute-major out[t, c, pix]: C channels, depth, weight sum,
// n_contrib, T_blend (the [T, C+4, P] contract the backward reads).
//
// The TPU kernel's triangular-matmul cumprod, DMA prefetch ring and
// cross-tile handoff change no value and are not carried over: T is
// multiplied directly. Its evaluation of power is kept, because its rounding
// is part of the result: the tile-local polynomial is ill-conditioned for
// pairs far from the tile origin (|c0| reaches ~1e3 while power is O(1)), so
// the order of roundings moves power by ~1e-4 and T_blend by ~4e-5. Power is
// therefore the sum of two limbs, the coefficients rounded to bf16 and their
// remainders, each a running sum of exact products (as the reference's
// limb-split matrix product computes it), and the coefficients are formed
// with the reference's fused multiply-adds. fwd_pairwalk_plain does the same,
// so kernel and plain version agree on power and differ only in expf and in
// how T is carried. Built without --use_fast_math: __expf would move alpha.
//
// What bounds it: operations. Each pixel evaluates the pairs of its tile
// (~16 f32 operations with one expf each) until it saturates; the pair
// table is read once and the output written once. At the main path's size
// (100k Gaussians, 640x480) that is ~50 M evaluations against ~19 MB moved:
// ~0.012 ms of f32 work against ~0.006 ms of memory traffic on an H100.
//
// Design (the simple first version): one CTA per tile, one thread per
// pixel. The block stages STAGE pairs at a time into shared memory,
// computing each pair's coefficient limbs and keep-eps once for all pixels,
// then every thread composites the staged pairs in order. The block leaves
// the segment once no pixel is still live (__syncthreads_count). Not yet
// tuned: no double buffering of the staging, no TMA, one block per tile
// whatever the segment length.

#include <cuda_runtime.h>

#include "pair_power.cuh"

namespace {

using namespace pairwalk;

constexpr int STAGE = 256;              // pairs staged per step

// Shared-memory layout, each row STAGE floats: 0..5 the coefficients' bf16
// limbs, 6..11 their remainders, 12 keep_eps, 13 opacity, 14..14+C-1
// channels, 14+C depth.
constexpr int S_HI = 0, S_LO = 6, S_EPS = 12, S_OP = 13, S_ATTR = 14;

template <int MAXC>
__global__ void fwd_pairwalk_kernel(const float* __restrict__ gpair,
                                    long long pc,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ origins,
                                    float* __restrict__ out,
                                    int n_channels, int ts, float alpha_max,
                                    float alpha_min, float t_eps) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int P = ts * ts;
  const int pix = threadIdx.x;
  const int count = counts[t];
  const int start = starts[t];
  const float ox = static_cast<float>(origins[2 * t]);
  const float oy = static_cast<float>(origins[2 * t + 1]);
  const float p = static_cast<float>(pix % ts);
  const float q = static_cast<float>(pix / ts);
  const float pp = p * p, pq = p * q, qq = q * q;   // small integers: exact
  const float tm1 = static_cast<float>(ts - 1);

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  float acc_depth = 0.f, acc_w = 0.f;
  float T = 1.f;
  float n_contrib = -1.f;
  bool done = false;

  // empty tiles (count == 0, start possibly clamped to the capacity) read
  // nothing: the loop body never runs
  for (int base = 0; base < count; base += STAGE) {
    const int n = min(STAGE, count - base);
    __syncthreads();                     // previous stage fully consumed
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const long long col = static_cast<long long>(start) + base + k;
      const float ex = __fsub_rn(gpair[R_X * pc + col], ox);
      const float ey = __fsub_rn(gpair[R_Y * pc + col], oy);
      smem[S_EPS * STAGE + k] = power_limbs(
          ex, ey, gpair[R_CA * pc + col], gpair[R_CB * pc + col],
          gpair[R_CC * pc + col], tm1, smem + S_HI * STAGE + k,
          smem + S_LO * STAGE + k, STAGE);
      smem[S_OP * STAGE + k] = gpair[R_OP * pc + col];
      for (int c = 0; c < n_channels; ++c)
        smem[(S_ATTR + c) * STAGE + k] = gpair[(N_FIXED + c) * pc + col];
      smem[(S_ATTR + n_channels) * STAGE + k] = gpair[R_DEPTH * pc + col];
    }
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float power = eval_power(smem + S_HI * STAGE + k,
                                       smem + S_LO * STAGE + k, STAGE, p, q,
                                       pp, pq, qq);
        const float pm =
            power <= smem[S_EPS * STAGE + k] ? fminf(power, 0.f) : -40.f;
        const float raw = __fmul_rn(smem[S_OP * STAGE + k], expf(pm));
        const float alpha = raw >= alpha_min ? fminf(raw, alpha_max) : 0.f;
        if (alpha == 0.f) continue;      // weight 0, T unchanged
        const float w = __fmul_rn(alpha, T);
        const float test_t = __fsub_rn(T, w);
        if (test_t < t_eps) {            // saturated: nothing more blends
          done = true;
          break;
        }
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < n_channels)
            acc[c] = __fmaf_rn(w, smem[(S_ATTR + c) * STAGE + k], acc[c]);
        acc_depth =
            __fmaf_rn(w, smem[(S_ATTR + n_channels) * STAGE + k], acc_depth);
        acc_w = __fadd_rn(acc_w, w);
        T = test_t;
        n_contrib = static_cast<float>(start + base + k);
      }
    }
    if (__syncthreads_count(!done) == 0) break;
  }

  float* o = out + static_cast<long long>(t) * (n_channels + 4) * P;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < n_channels) o[c * P + pix] = acc[c];
  o[n_channels * P + pix] = acc_depth;
  o[(n_channels + 1) * P + pix] = acc_w;
  o[(n_channels + 2) * P + pix] = n_contrib;
  o[(n_channels + 3) * P + pix] = T;
}

using WalkKernel = void (*)(const float*, long long, const int*, const int*,
                           const int*, float*, int, int, float, float, float);

// the instantiation whose register accumulators cover n_channels
WalkKernel kernel_for(int n_channels) {
  if (n_channels <= 4) return fwd_pairwalk_kernel<4>;
  if (n_channels <= 8) return fwd_pairwalk_kernel<8>;
  if (n_channels <= 16) return fwd_pairwalk_kernel<16>;
  return fwd_pairwalk_kernel<MAX_CHANNELS>;
}

size_t smem_bytes(int n_channels) {
  return static_cast<size_t>(S_ATTR + n_channels + 1) * STAGE *
         sizeof(float);
}

bool valid(int n_channels, int ts) {
  return n_channels >= 1 && n_channels <= MAX_CHANNELS && ts >= 1 &&
         ts * ts <= 1024;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fwd_pairwalk_launch(const float* gpair, long long pc,
                                   const int* starts, const int* counts,
                                   const int* origins, float* out,
                                   int n_tiles, int n_channels, int ts,
                                   float alpha_max, float alpha_min,
                                   float t_eps, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!valid(n_channels, ts)) return static_cast<int>(cudaErrorInvalidValue);
  kernel_for(n_channels)<<<n_tiles, ts * ts, smem_bytes(n_channels),
                           static_cast<cudaStream_t>(stream)>>>(
      gpair, pc, starts, counts, origins, out, n_channels, ts, alpha_max,
      alpha_min, t_eps);
  return static_cast<int>(cudaGetLastError());
}

// The launch's dynamic shared memory per block and how many blocks of it
// fit on one SM (registers and shared memory together). Returns a CUDA
// error code (0 = ok).
extern "C" int fwd_pairwalk_info(int n_channels, int ts, int* smem,
                                 int* blocks_per_sm) {
  if (!valid(n_channels, ts)) return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<int>(smem_bytes(n_channels));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_for(n_channels), ts * ts, smem_bytes(n_channels)));
}

// Backward pair-walk: per-pair gradients of the blend, one slab row per
// (Gaussian, tile) pair.
//
// Replaces splatloc_tpu/raster/pallas_raster.py::_bwd_kernel (launched by
// _run_bwd_kernel). Per tile, the walk goes back to front over the tile's
// 128-aligned pair segment, from the end of chunk jhi[t] (the last chunk
// with a blended pair, from the forward's n_contrib) down to its start.
// Per pixel and pair, with power, alpha and the keep test evaluated exactly
// as the forward does (pair_power.cuh):
//   blended = kept and position <= n_contrib[pixel] (the forward's output,
//             never re-derived)
//   T_before = T / (1 - alpha), starting from T = t_final and dividing
//             over blended pairs only
//   u       = sum of cot[c] * attr[c] over the C channels, depth and ones
//   w       = alpha * T_before;  s = sum of w * u over later blended pairs
//   dalpha  = T_before * u - s / (1 - alpha)
//   dpower  = dalpha * alpha where raw < alpha_max and power <= 0
//   dop     = dalpha * exp(power) where raw < alpha_max
// and, summed over the tile's pixels: the six power-coefficient grads
// sum(mono_k * dpower), chained back to x, y and conic a, b, c; sum(dop);
// depth and channel grads sum(cot * w). Row layout as gpair's (R_X..R_DEPTH,
// N_FIXED + c); the rect and padding rows are zero. Chunks of the segment
// past jhi are zero-filled (the JAX package's BWD_INIT = "kernel_fill");
// the slab past the last tile's segment is not written: its pair ids are
// the sentinel K, which the reduction discards. The slab is pair-major
// [PC, rows] in float32 or bfloat16 (rounded to nearest even).
//
// The TPU kernel's triangular-matmul suffix products, DMA rings and [PC,
// 128] lane padding change no value and are not carried over: T and s are
// carried directly per pixel.
//
// What bounds it: operations. Every pixel re-evaluates each pair of its
// tile up to the tile's last contributor (~16 f32 operations and one expf),
// and every evaluation enters a block-wide sum of 8 + C values (warp
// shuffles); the bytes are the pair table read once, the forward output and
// cotangent read once and the slab written once (~40 MB at 100k Gaussians,
// 640x480, bf16 slab: ~0.012 ms on an H100, well below the work).
//
// Design (the simple first version): one CTA per tile, one thread per
// pixel. The block stages STAGE pairs at a time in shared memory (their
// coefficient limbs, keep-eps, opacity, channels and depth), walks them in
// reverse, and sums each pair's per-pixel terms with a fixed shuffle tree
// per warp (skipped when no pixel of the warp blends it) into per-warp
// partials in shared memory; after the stage, one thread per pair adds the
// warp partials in warp order, applies the chain and writes the pair's
// row. No atomics: every 128-aligned segment has one owning tile, so every
// slab row has one writer, and the sums are taken in a fixed order, so the
// result does not change from run to run. Not yet tuned: no double
// buffering, no TMA, one block per tile whatever the segment length.
// Built without --use_fast_math: __expf would move alpha.

#include <cuda_runtime.h>

#include "pair_power.cuh"

namespace {

using namespace pairwalk;

constexpr int CHUNK = 128;   // segment alignment
constexpr int STAGE = 32;    // pairs staged per step (divides CHUNK)
constexpr unsigned FULL = 0xffffffffu;

// staged rows, each STAGE floats: 0..5 coefficient limbs, 6..11 their
// remainders, 12 keep_eps, 13 opacity, 14..18 ex, ey, ca, cb, cc (for the
// chain), 19..19+C-1 channels, 19+C depth
constexpr int S_HI = 0, S_LO = 6, S_EPS = 12, S_OP = 13, S_EX = 14, S_EY = 15,
              S_CA = 16, S_CB = 17, S_CC = 18, S_ATTR = 19;
// values summed over pixels per pair: 0..5 the coefficient grads, 6 opacity,
// 7 depth, 8..8+C-1 channels
constexpr int V_OP = 6, V_DEPTH = 7, V_CH = 8;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int MAXC, typename SlabT>
__global__ void bwd_pairwalk_kernel(const float* __restrict__ gpair,
                                    long long pc,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ origins,
                                    const int* __restrict__ jhi,
                                    const float* __restrict__ fwd_out,
                                    const float* __restrict__ cot,
                                    SlabT* __restrict__ slab, int rows,
                                    int n_channels, int ts, float alpha_max,
                                    float alpha_min) {
  extern __shared__ float smem[];
  const int C = n_channels;
  const int nv = V_CH + C;
  const int P = ts * ts;
  const int n_warps = P >> 5;
  float* stage = smem;
  float* part = smem + (S_ATTR + C + 1) * STAGE;   // [n_warps][STAGE][nv]
  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31, warp = pix >> 5;
  const long long lo = starts[t];
  const int nchunks = (counts[t] + CHUNK - 1) / CHUNK;
  const int j_hi = jhi[t];
  const float ox = static_cast<float>(origins[2 * t]);
  const float oy = static_cast<float>(origins[2 * t + 1]);
  const float p = static_cast<float>(pix % ts);
  const float q = static_cast<float>(pix / ts);
  const float pp = p * p, pq = p * q, qq = q * q;   // small integers: exact
  const float tm1 = static_cast<float>(ts - 1);

  const float* fo = fwd_out + static_cast<long long>(t) * (C + 4) * P;
  const float n_contrib = fo[(C + 2) * P + pix];
  float T = fo[(C + 3) * P + pix];
  const float* ct = cot + static_cast<long long>(t) * (C + 2) * P;
  float cot_c[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) cot_c[c] = c < C ? ct[c * P + pix] : 0.f;
  const float cot_depth = ct[C * P + pix];
  const float cot_one = ct[(C + 1) * P + pix];
  float s = 0.f;

  const long long end = lo + static_cast<long long>(j_hi + 1) * CHUNK;
  for (long long base = end - STAGE; base >= lo; base -= STAGE) {
    __syncthreads();                     // previous stage fully consumed
    for (int k = pix; k < STAGE; k += blockDim.x) {
      const long long col = base + k;
      const float ex = __fsub_rn(gpair[R_X * pc + col], ox);
      const float ey = __fsub_rn(gpair[R_Y * pc + col], oy);
      const float ca = gpair[R_CA * pc + col];
      const float cb = gpair[R_CB * pc + col];
      const float cc = gpair[R_CC * pc + col];
      stage[S_EPS * STAGE + k] =
          power_limbs(ex, ey, ca, cb, cc, tm1, stage + S_HI * STAGE + k,
                      stage + S_LO * STAGE + k, STAGE);
      stage[S_OP * STAGE + k] = gpair[R_OP * pc + col];
      stage[S_EX * STAGE + k] = ex;
      stage[S_EY * STAGE + k] = ey;
      stage[S_CA * STAGE + k] = ca;
      stage[S_CB * STAGE + k] = cb;
      stage[S_CC * STAGE + k] = cc;
      for (int c = 0; c < C; ++c)
        stage[(S_ATTR + c) * STAGE + k] = gpair[(N_FIXED + c) * pc + col];
      stage[(S_ATTR + C) * STAGE + k] = gpair[R_DEPTH * pc + col];
    }
    __syncthreads();

    for (int k = STAGE - 1; k >= 0; --k) {
      const float power = eval_power(stage + S_HI * STAGE + k,
                                     stage + S_LO * STAGE + k, STAGE, p, q,
                                     pp, pq, qq);
      const float pm =
          power <= stage[S_EPS * STAGE + k] ? fminf(power, 0.f) : -40.f;
      const float e = expf(pm);
      const float raw = __fmul_rn(stage[S_OP * STAGE + k], e);
      const bool keep = raw >= alpha_min;
      const float alpha = keep ? fminf(raw, alpha_max) : 0.f;
      const bool blended =
          keep && static_cast<float>(base + k) <= n_contrib;
      float v[V_CH + MAXC];
#pragma unroll
      for (int i = 0; i < V_CH + MAXC; ++i) v[i] = 0.f;
      if (blended) {
        const float one_m = 1.f - alpha;
        const float t_before = T / one_m;
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) u = fmaf(cot_c[c], stage[(S_ATTR + c) * STAGE + k], u);
        u = fmaf(cot_depth, stage[(S_ATTR + C) * STAGE + k], u);
        u += cot_one;
        const float w = alpha * t_before;
        const float dalpha = t_before * u - s / one_m;
        s = fmaf(w, u, s);
        T = t_before;
        const bool not_clamped = raw < alpha_max;
        const float dpower =
            (not_clamped && power <= 0.f) ? dalpha * alpha : 0.f;
        v[0] = dpower;
        v[1] = dpower * p;
        v[2] = dpower * q;
        v[3] = dpower * pp;
        v[4] = dpower * pq;
        v[5] = dpower * qq;
        v[V_OP] = not_clamped ? dalpha * e : 0.f;
        v[V_DEPTH] = w * cot_depth;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) v[V_CH + c] = w * cot_c[c];
      }
      float* dst = part + (static_cast<long long>(warp) * STAGE + k) * nv;
      if (__any_sync(FULL, blended)) {
#pragma unroll
        for (int i = 0; i < V_CH + MAXC; ++i) {
          if (i < nv) {
            float x = v[i];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              x += __shfl_down_sync(FULL, x, off);
            if (lane == 0) dst[i] = x;
          }
        }
      } else if (lane == 0) {
        for (int i = 0; i < nv; ++i) dst[i] = 0.f;
      }
    }
    __syncthreads();

    for (int k = pix; k < STAGE; k += blockDim.x) {
      float d[V_CH + MAXC];
#pragma unroll
      for (int i = 0; i < V_CH + MAXC; ++i) {
        float acc = 0.f;
        if (i < nv)
          for (int wp = 0; wp < n_warps; ++wp)
            acc += part[(static_cast<long long>(wp) * STAGE + k) * nv + i];
        d[i] = acc;
      }
      const float ex = stage[S_EX * STAGE + k], ey = stage[S_EY * STAGE + k];
      const float ca = stage[S_CA * STAGE + k], cb = stage[S_CB * STAGE + k];
      const float cc = stage[S_CC * STAGE + k];
      SlabT* row = slab + (base + k) * rows;
      store(row + R_X, d[0] * (-ca * ex - cb * ey) + d[1] * ca + d[2] * cb);
      store(row + R_Y, d[0] * (-cc * ey - cb * ex) + d[1] * cb + d[2] * cc);
      store(row + R_CA, d[0] * (-0.5f * ex * ex) + d[1] * ex - 0.5f * d[3]);
      store(row + R_CB,
            d[0] * (-ex * ey) + d[1] * ey + d[2] * ex - d[4]);
      store(row + R_CC, d[0] * (-0.5f * ey * ey) + d[2] * ey - 0.5f * d[5]);
      store(row + R_OP, d[V_OP]);
      store(row + R_DEPTH, d[V_DEPTH]);
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) store(row + N_FIXED + c, d[V_CH + c]);
      for (int r = N_FIXED + C; r < rows; ++r) store(row + r, 0.f);
    }
  }

  // zero-fill the segment's chunks past jhi
  const long long z_end = (lo + static_cast<long long>(nchunks) * CHUNK) *
                          rows;
  for (long long i = end * rows + pix; i < z_end; i += blockDim.x)
    store(slab + i, 0.f);
}

template <int MAXC, typename SlabT>
int launch(const float* gpair, long long pc, const int* starts,
           const int* counts, const int* origins, const int* jhi,
           const float* fwd_out, const float* cot, void* slab, int n_tiles,
           int rows, int n_channels, int ts, float alpha_max,
           float alpha_min, size_t smem, cudaStream_t stream) {
  auto kernel = bwd_pairwalk_kernel<MAXC, SlabT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_tiles, ts * ts, smem, stream>>>(
      gpair, pc, starts, counts, origins, jhi, fwd_out, cot,
      static_cast<SlabT*>(slab), rows, n_channels, ts, alpha_max, alpha_min);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation whose register arrays cover n_channels
template <typename SlabT>
int launch_for(int n_channels, const float* gpair, long long pc,
               const int* starts, const int* counts, const int* origins,
               const int* jhi, const float* fwd_out, const float* cot,
               void* slab, int n_tiles, int rows, int ts, float alpha_max,
               float alpha_min, size_t smem, cudaStream_t stream) {
#define BWD_LAUNCH(M)                                                        \
  launch<M, SlabT>(gpair, pc, starts, counts, origins, jhi, fwd_out, cot,    \
                   slab, n_tiles, rows, n_channels, ts, alpha_max,           \
                   alpha_min, smem, stream)
  if (n_channels <= 4) return BWD_LAUNCH(4);
  if (n_channels <= 8) return BWD_LAUNCH(8);
  if (n_channels <= 16) return BWD_LAUNCH(16);
  return BWD_LAUNCH(MAX_CHANNELS);
#undef BWD_LAUNCH
}

size_t smem_bytes(int n_channels, int ts) {
  const int n_warps = ts * ts / 32;
  return (static_cast<size_t>(S_ATTR + n_channels + 1) * STAGE +
          static_cast<size_t>(n_warps) * STAGE * (V_CH + n_channels)) *
         sizeof(float);
}

bool valid(int n_channels, int ts, int rows) {
  return n_channels >= 1 && n_channels <= MAX_CHANNELS && ts >= 1 &&
         ts * ts <= 1024 && (ts * ts) % 32 == 0 &&
         (rows == 8 || rows == 16 || rows == 32) &&
         rows >= N_FIXED + n_channels;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bwd_pairwalk_launch(const float* gpair, long long pc,
                                   const int* starts, const int* counts,
                                   const int* origins, const int* jhi,
                                   const float* fwd_out, const float* cot,
                                   void* slab, int n_tiles, int rows,
                                   int n_channels, int ts, int slab_bf16,
                                   float alpha_max, float alpha_min,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  if (!valid(n_channels, ts, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_channels, ts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab_bf16)
    return launch_for<__nv_bfloat16>(n_channels, gpair, pc, starts, counts,
                                     origins, jhi, fwd_out, cot, slab,
                                     n_tiles, rows, ts, alpha_max, alpha_min,
                                     smem, st);
  return launch_for<float>(n_channels, gpair, pc, starts, counts, origins,
                           jhi, fwd_out, cot, slab, n_tiles, rows, ts,
                           alpha_max, alpha_min, smem, st);
}

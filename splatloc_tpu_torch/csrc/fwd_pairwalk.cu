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
// ~0.012 ms of f32 work against ~0.006 ms of memory traffic on an H100. In
// practice the walk is bound by the latency of the longest tiles: a block
// walks its tile's pairs one after another, and at that size the tenth of
// the tiles with the most pairs (~500 each) takes most of the launch's
// time on its own.
//
// Design: one CTA per tile, two horizontally adjacent pixels per thread
// (128 threads for a 16x16 tile), so each shared-memory read of a pair
// serves two pixels. The segment is walked in stages of STAGE pairs. The
// raw gpair columns of the next stages arrive by cp.async, issued by every
// thread, into a two-buffer ring while the current stage is walked; each
// stage's raw columns are then turned, by all threads at once, into
// pair-major records: an evaluation record (the coefficients' limbs,
// keep-eps, opacity and alpha_cut, read as four float4) and an attribute
// record (the channels and depth, read only when a pixel blends). A warp
// evaluates the powers of UNROLL pairs at once, so that their dependent
// chains interleave, and skips the expf and the blend of a pair that is
// below alpha_cut at all of its live pixels (alpha is certainly cut there,
// see pair_power.cuh). Every pixel keeps the order of roundings of the walk
// above, pair by pair, so neither the pixels per thread nor the pairs per
// step nor the skip move a bit of the output. The block leaves the segment
// once no pixel is still live (__syncthreads_count).

#include <cuda_runtime.h>

#include "pair_power.cuh"

namespace {

using namespace pairwalk;

constexpr int STAGE = 64;   // pairs per stage (divides CHUNK)
constexpr int PIX = 2;      // pixels per thread: pix0 and pix0 + 1 of a row
constexpr int UNROLL = 2;   // pairs whose powers a warp evaluates together

template <int MAXC>
__global__ void __launch_bounds__(MAX_THREADS)
    fwd_pairwalk_kernel(const float* __restrict__ gpair, long long pc,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const int* __restrict__ origins,
                        float* __restrict__ out, int n_channels, int ts,
                        float alpha_max, float alpha_min, float t_eps) {
  constexpr int CA = attr_stride<MAXC>();
  extern __shared__ float4 smem4[];
  EvalRec* rec = reinterpret_cast<EvalRec*>(smem4);     // [STAGE]
  float* attr = reinterpret_cast<float*>(rec + STAGE);  // [STAGE][CA]
  float* raw = attr + STAGE * CA;       // 2 x [N_FIXED + C][STAGE]
  const int C = n_channels;
  const int n_rows = N_FIXED + C;
  const int t = blockIdx.x;
  const int P = ts * ts;
  const int pix0 = PIX * threadIdx.x;
  const int count = counts[t];
  const int start = starts[t];
  const float ox = static_cast<float>(origins[2 * t]);
  const float oy = static_cast<float>(origins[2 * t + 1]);
  const float q = static_cast<float>(pix0 / ts);
  const float qq = q * q;                  // small integers: exact
  float p[PIX], pp[PIX], pq[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    p[j] = static_cast<float>(pix0 % ts + j);
    pp[j] = p[j] * p[j];
    pq[j] = p[j] * q;
  }
  const float tm1 = static_cast<float>(ts - 1);

  float acc[PIX][MAXC], acc_depth[PIX], acc_w[PIX], T[PIX], n_contrib[PIX];
  bool done[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[j][c] = 0.f;
    acc_depth[j] = 0.f;
    acc_w[j] = 0.f;
    T[j] = 1.f;
    n_contrib[j] = -1.f;
    done[j] = false;
  }

  // empty tiles (count == 0, start possibly clamped to the capacity) read
  // nothing. Stages are whole STAGE-pair runs of the 128-aligned segment;
  // pairs past count are staged but not walked.
  const int n_stages = (count + STAGE - 1) / STAGE;
  if (n_stages > 0) stage_rows<STAGE>(raw, gpair, pc, start, n_rows);
  cp_async_commit();
  if (n_stages > 1)
    stage_rows<STAGE>(raw + n_rows * STAGE, gpair, pc, start + STAGE, n_rows);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();
  for (int i = 0; i < n_stages; ++i) {
    const int base = i * STAGE;
    const int n = min(STAGE, count - base);
    float* buf = raw + (i & 1) * n_rows * STAGE;
    // records: evaluation records on one half of the jobs, attribute
    // records on the other
    for (int job = threadIdx.x; job < 2 * STAGE; job += blockDim.x) {
      const int k = job % STAGE;
      if (job < STAGE) {
        make_eval_rec(__fsub_rn(buf[R_X * STAGE + k], ox),
                      __fsub_rn(buf[R_Y * STAGE + k], oy),
                      buf[R_CA * STAGE + k], buf[R_CB * STAGE + k],
                      buf[R_CC * STAGE + k], buf[R_OP * STAGE + k], tm1,
                      alpha_min, rec + k);
      } else {
        float* a = attr + k * CA;
#pragma unroll
        for (int c = 0; c < CA; ++c)
          a[c] = c < C ? buf[(N_FIXED + c) * STAGE + k]
                       : (c == MAXC ? buf[R_DEPTH * STAGE + k] : 0.f);
      }
    }
    __syncthreads();                     // records ready, buf free
    if (i + 2 < n_stages)
      stage_rows<STAGE>(buf, gpair, pc, start + base + 2 * STAGE, n_rows);
    cp_async_commit();

    bool live = false;
#pragma unroll
    for (int j = 0; j < PIX; ++j) live |= !done[j];
    // the warp walks while one of its pixels is live (warp-uniform, for
    // the votes)
    for (int k0 = 0; k0 < n && __any_sync(FULL, live); k0 += UNROLL) {
      // the powers of UNROLL pairs at once, so that their evaluations
      // interleave (a pair past n repeats pair n - 1 and is not near)
      EvalRec r[UNROLL];
      float power[UNROLL][PIX];
      bool near[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        r[u] = rec[min(k0 + u, n - 1)];
        near[u] = false;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          power[u][j] = eval_power(r[u], p[j], q, pp[j], pq[j], qq);
          near[u] |= !done[j] && !(power[u][j] < r[u].d.z);
        }
        near[u] &= k0 + u < n;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        // below alpha_cut for every live pixel of the warp: alpha 0 for
        // all of them, nothing changes
        if (!__any_sync(FULL, near[u])) continue;
        const int k = k0 + u;
        // every pixel's alpha, without branches, so that the pixels'
        // evaluations interleave; a done pixel's is not used
        float alpha[PIX];
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          const float pw = power[u][j];
          const float pm = pw <= r[u].d.x ? fminf(pw, 0.f) : -40.f;
          const float raw_a = __fmul_rn(r[u].d.y, expf(pm));
          alpha[j] = raw_a >= alpha_min ? fminf(raw_a, alpha_max) : 0.f;
        }
        float w[PIX];
        bool blend[PIX];
        bool any = false;
        live = false;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          // alpha 0: weight 0, T unchanged; T - w below t_eps: saturated,
          // nothing more blends
          w[j] = __fmul_rn(alpha[j], T[j]);
          const float test_t = __fsub_rn(T[j], w[j]);
          const bool act = !done[j] && alpha[j] != 0.f;
          const bool saturated = act && test_t < t_eps;
          blend[j] = act && !saturated;
          done[j] = done[j] || saturated;
          T[j] = blend[j] ? test_t : T[j];
          any |= blend[j];
          live |= !done[j];
        }
        if (!any) continue;
        float a[CA];
        const float4* a4 = reinterpret_cast<const float4*>(attr + k * CA);
#pragma unroll
        for (int g = 0; g < CA / 4; ++g) {
          const float4 x = a4[g];
          a[4 * g] = x.x;
          a[4 * g + 1] = x.y;
          a[4 * g + 2] = x.z;
          a[4 * g + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          if (!blend[j]) continue;
#pragma unroll
          for (int c = 0; c < MAXC; ++c)
            acc[j][c] = __fmaf_rn(w[j], a[c], acc[j][c]);
          acc_depth[j] = __fmaf_rn(w[j], a[MAXC], acc_depth[j]);
          acc_w[j] = __fadd_rn(acc_w[j], w[j]);
          n_contrib[j] = static_cast<float>(start + base + k);
        }
      }
    }
    cp_async_wait_one();                 // stage i + 1 landed (own pieces)
    if (__syncthreads_count(live) == 0) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  float* o = out + static_cast<long long>(t) * (C + 4) * P + pix0;
  float v[PIX];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= C) break;
#pragma unroll
    for (int j = 0; j < PIX; ++j) v[j] = acc[j][c];
    store_pixels(o + c * P, v);
  }
  store_pixels(o + C * P, acc_depth);
  store_pixels(o + (C + 1) * P, acc_w);
  store_pixels(o + (C + 2) * P, n_contrib);
  store_pixels(o + (C + 3) * P, T);
}

using WalkKernel = void (*)(const float*, long long, const int*, const int*,
                           const int*, float*, int, int, float, float, float);

// the instantiation whose register accumulators cover n_channels
template <int MAXC>
WalkKernel kernel_of() {
  return fwd_pairwalk_kernel<MAXC>;
}

template <int MAXC>
size_t smem_of(int n_channels) {
  return (static_cast<size_t>(STAGE) * (16 + attr_stride<MAXC>()) +
          2 * static_cast<size_t>(N_FIXED + n_channels) * STAGE) *
         sizeof(float);
}

WalkKernel kernel_for(int n_channels, size_t* smem) {
#define FWD_PICK(M)                   \
  {                                   \
    *smem = smem_of<M>(n_channels);   \
    return kernel_of<M>();            \
  }
  if (n_channels <= 4) FWD_PICK(4);
  if (n_channels <= 8) FWD_PICK(8);
  if (n_channels <= 16) FWD_PICK(16);
  FWD_PICK(MAX_CHANNELS);
#undef FWD_PICK
}

// tile sizes the layout takes: whole pixel pairs per row, whole warps
bool valid(int n_channels, int ts) {
  return n_channels >= 1 && n_channels <= MAX_CHANNELS && ts >= 1 &&
         ts % PIX == 0 && (ts * ts) % (32 * PIX) == 0 &&
         ts * ts <= PIX * MAX_THREADS;
}

cudaError_t prepare(WalkKernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). gpair's
// segments start at multiples of 128 and span multiples of 128 pairs
// inside its PC columns, PC % 4 == 0 and gpair 16-byte aligned.
extern "C" int fwd_pairwalk_launch(const float* gpair, long long pc,
                                   const int* starts, const int* counts,
                                   const int* origins, float* out,
                                   int n_tiles, int n_channels, int ts,
                                   float alpha_max, float alpha_min,
                                   float t_eps, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!valid(n_channels, ts)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const WalkKernel kernel = kernel_for(n_channels, &smem);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, ts * ts / PIX, smem,
           static_cast<cudaStream_t>(stream)>>>(
      gpair, pc, starts, counts, origins, out, n_channels, ts, alpha_max,
      alpha_min, t_eps);
  return static_cast<int>(cudaGetLastError());
}

// The launch's threads and dynamic shared memory per block and how many
// blocks of it fit on one SM (registers and shared memory together).
// Returns a CUDA error code (0 = ok).
extern "C" int fwd_pairwalk_info(int n_channels, int ts, int* threads,
                                 int* smem, int* blocks_per_sm) {
  if (!valid(n_channels, ts)) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  const WalkKernel kernel = kernel_for(n_channels, &bytes);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = ts * ts / PIX;
  *smem = static_cast<int>(bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, bytes));
}

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
// What bounds it: operations. Every pixel evaluates each pair of its tile
// up to its own last blended pair (~16 f32 operations and one expf), and
// the ~11 % of evaluations that blend add ~48 more; the bytes are the pair
// table read once, the forward output and cotangent read once and the slab
// written once (~35 MB at 100k Gaussians, 640x480, bf16 slab: ~0.011 ms on
// an H100, below the work). In practice the walk is bound by instruction
// issue and by the latency of the longest tiles: a block walks its tile's
// pairs one after another, and each pair that a warp keeps costs it an
// expf, a division and a five-level shuffle reduction in sequence.
//
// Design: one CTA per tile, one thread per pixel up to 16x16 tiles and two
// horizontally adjacent pixels per thread past them (a block has at most
// MAX_THREADS threads; two pixels per thread at 16x16 were slower: a warp
// then spans 64 pixels, so fewer pairs miss all of them). The segment is
// walked back to front in stages of STAGE pairs. The raw gpair columns of
// the next stages arrive by cp.async, issued by every thread, into a
// two-buffer ring while the current stage is walked; each stage's raw
// columns are turned, by all threads at once, into pair-major records: an
// evaluation record (the coefficients' limbs, keep-eps, opacity and
// alpha_cut: four float4), an attribute record (channels and depth, read
// only by a pixel that blends) and a chain record (the centre offset and
// the conic, read only by the finalize). A warp skips, with zero terms:
// the pairs past the largest n_contrib of its pixels; the expf and the
// rest of a pair that is below alpha_cut at all of its pixels (alpha is
// certainly cut there, see pair_power.cuh); and the shuffles of a pair
// that none of its pixels blends. Otherwise each thread adds its pixels'
// 8 + C terms, and the warp sums them over its lanes in one
// transpose-reduce of the 8 + C values padded to NV (16 or 32): at each of
// five levels a lane keeps half of its values and trades the other half
// with its partner lane, so the sums of all values cost 8 + 4 + 2 + 1 + 1 =
// 16 shuffles (31 for NV = 32) and land one per lane. After the stage, all
// threads add the per-warp partials in warp order, then one thread per pair
// applies the chain and writes the pair's row with 16-byte stores. No
// atomics: every 128-aligned segment has one owning tile, so every slab row
// has one writer, and every sum is taken in a fixed order, so the result
// does not change from run to run. Built without --use_fast_math: __expf
// would move alpha.

#include <cuda_runtime.h>

#include "pair_power.cuh"

namespace {

using namespace pairwalk;

constexpr int STAGE = 64;   // pairs per stage (divides CHUNK)
// values summed over pixels per pair: 0..5 the coefficient grads, 6
// opacity, 7 depth, 8..8+C-1 channels
constexpr int V_OP = 6, V_DEPTH = 7, V_CH = 8;

// values a warp sums per pair, padded to a power of two the transpose-
// reduce takes
template <int MAXC>
__host__ __device__ constexpr int n_sums() {
  return V_CH + MAXC <= 16 ? 16 : 32;
}

// One level of the transpose-reduce: lanes with bit O set keep the upper
// half v[H..2H) of their values and send the lower half, the others the
// reverse, and each adds what its partner lane (lane ^ O) sent; then the
// next level on the H values left.
template <int H, int O>
__device__ __forceinline__ void trade_halves(float* v, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
  if constexpr (H > 1) trade_halves<H / 2, O / 2>(v, lane);
}

// Sums v[0..N) over the warp's lanes for every index at once (N = 16 or
// 32; v is clobbered): lane l ends with the warp's sum of value l >> 1 (N
// = 16; lanes l and l ^ 1 agree) or value l (N = 32). The pattern is
// fixed, so the sums are the same on every run.
template <int N>
__device__ __forceinline__ float warp_transpose_sum(float* v, int lane) {
  trade_halves<N / 2, 16>(v, lane);
  float x = v[0];
  if constexpr (N == 16) x += __shfl_xor_sync(FULL, x, 1);
  return x;
}

__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&x)[8]) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// Writes a slab row of `rows` values: vals[r] for r < n_real, zeros after,
// in 16-byte pieces (rows * sizeof(SlabT) is a multiple of 16).
template <typename SlabT, int NR>
__device__ __forceinline__ void store_row(SlabT* row, const float (&vals)[NR],
                                          int n_real, int rows) {
  constexpr int EPC = 16 / sizeof(SlabT);
  constexpr int NCH = (NR + EPC - 1) / EPC;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    if (ch * EPC >= rows) break;
    float x[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const int r = ch * EPC + e;
      x[e] = (r < NR && r < n_real) ? vals[r < NR ? r : 0] : 0.f;
    }
    store16(row + ch * EPC, x);
  }
  const float zeros[EPC] = {};
  for (int r = NCH * EPC; r < rows; r += EPC) store16(row + r, zeros);
}

// PIX pixels per thread: pix0, pix0 + 1, ... of a tile row
template <int MAXC, typename SlabT, int PIX>
__global__ void __launch_bounds__(MAX_THREADS)
    bwd_pairwalk_kernel(const float* __restrict__ gpair, long long pc,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const int* __restrict__ origins,
                        const int* __restrict__ jhi,
                        const float* __restrict__ fwd_out,
                        const float* __restrict__ cot,
                        SlabT* __restrict__ slab, int rows, int n_channels,
                        int ts, float alpha_max, float alpha_min) {
  constexpr int CA = attr_stride<MAXC>();
  constexpr int NV = n_sums<MAXC>();
  extern __shared__ float4 smem4[];
  EvalRec* rec = reinterpret_cast<EvalRec*>(smem4);       // [STAGE]
  float* attr = reinterpret_cast<float*>(rec + STAGE);    // [STAGE][CA]
  float4* chain = reinterpret_cast<float4*>(attr + STAGE * CA);  // [STAGE][2]
  float* raw = reinterpret_cast<float*>(chain + 2 * STAGE);
  const int C = n_channels;
  const int n_rows = N_FIXED + C;
  const int nv = V_CH + C;
  const int nvs = (nv + 3) / 4 * 4;      // partial stride: whole float4
  float* part = raw + 2 * n_rows * STAGE;  // [n_warps][STAGE][nvs]
  const int P = ts * ts;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int t = blockIdx.x;
  const long long lo = starts[t];
  const int nchunks = (counts[t] + CHUNK - 1) / CHUNK;
  const int j_hi = jhi[t];
  const float ox = static_cast<float>(origins[2 * t]);
  const float oy = static_cast<float>(origins[2 * t + 1]);
  const int pix0 = PIX * tid;
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

  const float* fo = fwd_out + static_cast<long long>(t) * (C + 4) * P + pix0;
  float n_contrib[PIX], T[PIX], s[PIX], cot_depth[PIX], cot_one[PIX];
  float cot_c[PIX][MAXC];
  load_pixels(fo + (C + 2) * P, n_contrib);
  load_pixels(fo + (C + 3) * P, T);
  const float* ct = cot + static_cast<long long>(t) * (C + 2) * P + pix0;
  load_pixels(ct + C * P, cot_depth);
  load_pixels(ct + (C + 1) * P, cot_one);
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    float x[PIX];
    if (c < C) {
      load_pixels(ct + c * P, x);
    } else {
#pragma unroll
      for (int j = 0; j < PIX; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < PIX; ++j) cot_c[j][c] = x[j];
  }
  int last = -1;
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    s[j] = 0.f;
    last = max(last, static_cast<int>(n_contrib[j]));
  }
  // the warp's last blended pair: no pixel of the warp blends past it
  const int warp_last = __reduce_max_sync(FULL, last);
  // the lane's sum after the transpose-reduce, and whether it is stored
  const int sum_idx = NV == 16 ? lane >> 1 : lane;
  const bool sum_lane = (NV == 32 || (lane & 1) == 0) && sum_idx < nv;
  float* wpart = part + warp * STAGE * nvs + sum_idx;

  const long long end = lo + static_cast<long long>(j_hi + 1) * CHUNK;
  const int n_stages = (j_hi + 1) * (CHUNK / STAGE);
  // stage i covers pairs [end - (i + 1) STAGE, end - i STAGE)
  if (n_stages > 0) stage_rows<STAGE>(raw, gpair, pc, end - STAGE, n_rows);
  cp_async_commit();
  if (n_stages > 1)
    stage_rows<STAGE>(raw + n_rows * STAGE, gpair, pc, end - 2 * STAGE,
                      n_rows);
  cp_async_commit();
  for (int i = 0; i < n_stages; ++i) {
    const long long base = end - static_cast<long long>(i + 1) * STAGE;
    float* buf = raw + (i & 1) * n_rows * STAGE;
    cp_async_wait_one();                 // stage i landed (own pieces)
    __syncthreads();                     // ... all pieces; records free
    for (int job = tid; job < 2 * STAGE; job += blockDim.x) {
      const int k = job % STAGE;
      if (job < STAGE) {
        const float ex = __fsub_rn(buf[R_X * STAGE + k], ox);
        const float ey = __fsub_rn(buf[R_Y * STAGE + k], oy);
        const float ca = buf[R_CA * STAGE + k];
        const float cb = buf[R_CB * STAGE + k];
        const float cc = buf[R_CC * STAGE + k];
        make_eval_rec(ex, ey, ca, cb, cc, buf[R_OP * STAGE + k], tm1,
                      alpha_min, rec + k);
        chain[2 * k] = make_float4(ex, ey, ca, cb);
        chain[2 * k + 1] = make_float4(cc, 0.f, 0.f, 0.f);
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
      stage_rows<STAGE>(buf, gpair, pc, end - (i + 3) * STAGE, n_rows);
    cp_async_commit();

    for (int k = STAGE - 1; k >= 0; --k) {
      const long long pos = base + k;
      float x = 0.f;
      if (pos <= warp_last) {
        const EvalRec r = rec[k];
        float power[PIX];
        bool near = false;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          power[j] = eval_power(r, p[j], q, pp[j], pq[j], qq);
          near |= !(power[j] < r.d.z);
        }
        // below alpha_cut no pixel of the warp keeps the pair: its terms
        // are zero
        if (__any_sync(FULL, near)) {
          const float fpos = static_cast<float>(pos);
          float v[NV];
#pragma unroll
          for (int i2 = 0; i2 < NV; ++i2) v[i2] = 0.f;
          bool blended_any = false;
#pragma unroll
          for (int j = 0; j < PIX; ++j) {
            const float pm =
                power[j] <= r.d.x ? fminf(power[j], 0.f) : -40.f;
            const float e = expf(pm);
            const float raw_a = __fmul_rn(r.d.y, e);
            if (!(raw_a >= alpha_min && fpos <= n_contrib[j])) continue;
            blended_any = true;
            float a[CA];
            const float4* a4 =
                reinterpret_cast<const float4*>(attr + k * CA);
#pragma unroll
            for (int g = 0; g < CA / 4; ++g) {
              const float4 y = a4[g];
              a[4 * g] = y.x;
              a[4 * g + 1] = y.y;
              a[4 * g + 2] = y.z;
              a[4 * g + 3] = y.w;
            }
            const float alpha = fminf(raw_a, alpha_max);
            const float inv = 1.f / (1.f - alpha);
            const float t_before = T[j] * inv;
            float u = 0.f;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) u = fmaf(cot_c[j][c], a[c], u);
            u = fmaf(cot_depth[j], a[MAXC], u);
            u += cot_one[j];
            const float w = alpha * t_before;
            const float dalpha = t_before * u - s[j] * inv;
            s[j] = fmaf(w, u, s[j]);
            T[j] = t_before;
            const bool not_clamped = raw_a < alpha_max;
            const float dpower =
                (not_clamped && power[j] <= 0.f) ? dalpha * alpha : 0.f;
            v[0] += dpower;
            v[1] = fmaf(dpower, p[j], v[1]);
            v[2] = fmaf(dpower, q, v[2]);
            v[3] = fmaf(dpower, pp[j], v[3]);
            v[4] = fmaf(dpower, pq[j], v[4]);
            v[5] = fmaf(dpower, qq, v[5]);
            v[V_OP] += not_clamped ? dalpha * e : 0.f;
            v[V_DEPTH] = fmaf(w, cot_depth[j], v[V_DEPTH]);
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
              v[V_CH + c] = fmaf(w, cot_c[j][c], v[V_CH + c]);
          }
          if (__any_sync(FULL, blended_any))
            x = warp_transpose_sum<NV>(v, lane);
        }
      }
      if (sum_lane) wpart[k * nvs] = x;
    }
    __syncthreads();                     // partials complete

    // per-pair sums over the warps, in warp order, into warp 0's partials
    float4* part4 = reinterpret_cast<float4*>(part);
    const int n4 = STAGE * nvs / 4;
    for (int e4 = tid; e4 < n4; e4 += blockDim.x) {
      float4 acc = part4[e4];
      for (int w = 1; w < n_warps; ++w) {
        const float4 y = part4[w * n4 + e4];
        acc.x += y.x;
        acc.y += y.y;
        acc.z += y.z;
        acc.w += y.w;
      }
      part4[e4] = acc;
    }
    __syncthreads();                     // sums complete

    for (int k = tid; k < STAGE; k += blockDim.x) {
      float d[NV];
      const float4* d4 = part4 + k * (nvs / 4);
#pragma unroll
      for (int g = 0; g < NV / 4; ++g) {
        const float4 y = g < nvs / 4 ? d4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
        d[4 * g] = y.x;
        d[4 * g + 1] = y.y;
        d[4 * g + 2] = y.z;
        d[4 * g + 3] = y.w;
      }
      const float4 c0 = chain[2 * k], c1 = chain[2 * k + 1];
      const float ex = c0.x, ey = c0.y, ca = c0.z, cb = c0.w, cc = c1.x;
      float vals[N_FIXED + MAXC];
      vals[R_X] = d[0] * (-ca * ex - cb * ey) + d[1] * ca + d[2] * cb;
      vals[R_Y] = d[0] * (-cc * ey - cb * ex) + d[1] * cb + d[2] * cc;
      vals[R_CA] = d[0] * (-0.5f * ex * ex) + d[1] * ex - 0.5f * d[3];
      vals[R_CB] = d[0] * (-ex * ey) + d[1] * ey + d[2] * ex - d[4];
      vals[R_CC] = d[0] * (-0.5f * ey * ey) + d[2] * ey - 0.5f * d[5];
      vals[R_OP] = d[V_OP];
      vals[R_DEPTH] = d[V_DEPTH];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) vals[N_FIXED + c] = d[V_CH + c];
      store_row(slab + (base + k) * rows, vals, N_FIXED + C, rows);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // zero-fill the segment's chunks past jhi, 16 bytes per store
  const long long z_from = end * rows * static_cast<long long>(sizeof(SlabT));
  const long long z_to = (lo + static_cast<long long>(nchunks) * CHUNK) *
                         rows * static_cast<long long>(sizeof(SlabT));
  uint4* z = reinterpret_cast<uint4*>(reinterpret_cast<char*>(slab) + z_from);
  for (long long i = tid; i < (z_to - z_from) / 16; i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// pixels per thread: one up to 16x16 tiles, two past them (at most
// MAX_THREADS threads)
int pix_for(int ts) { return ts * ts <= 256 ? 1 : 2; }

template <int MAXC>
size_t smem_of(int n_channels, int ts) {
  const int n_warps = ts * ts / pix_for(ts) / 32;
  const int nvs = (V_CH + n_channels + 3) / 4 * 4;
  return (static_cast<size_t>(STAGE) * (16 + attr_stride<MAXC>() + 8) +
          2 * static_cast<size_t>(N_FIXED + n_channels) * STAGE +
          static_cast<size_t>(n_warps) * STAGE * nvs) *
         sizeof(float);
}

// Calls op.run<MAXC, SlabT, PIX>() for the instantiation whose register
// arrays cover n_channels, the slab's type and the tile's pixels per
// thread.
template <typename SlabT, int PIX, typename Op>
int dispatch_c(int n_channels, Op& op) {
  if (n_channels <= 4) return op.template run<4, SlabT, PIX>();
  if (n_channels <= 8) return op.template run<8, SlabT, PIX>();
  if (n_channels <= 16) return op.template run<16, SlabT, PIX>();
  return op.template run<MAX_CHANNELS, SlabT, PIX>();
}

template <typename Op>
int dispatch(int n_channels, int ts, int slab_bf16, Op& op) {
  if (pix_for(ts) == 1)
    return slab_bf16 ? dispatch_c<__nv_bfloat16, 1>(n_channels, op)
                     : dispatch_c<float, 1>(n_channels, op);
  return slab_bf16 ? dispatch_c<__nv_bfloat16, 2>(n_channels, op)
                   : dispatch_c<float, 2>(n_channels, op);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Launch {
  const float* gpair;
  long long pc;
  const int *starts, *counts, *origins, *jhi;
  const float *fwd_out, *cot;
  void* slab;
  int n_tiles, rows, n_channels, ts;
  float alpha_max, alpha_min;
  cudaStream_t stream;

  template <int MAXC, typename SlabT, int PIX>
  int run() {
    auto kernel = bwd_pairwalk_kernel<MAXC, SlabT, PIX>;
    const size_t smem = smem_of<MAXC>(n_channels, ts);
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_tiles, ts * ts / PIX, smem, stream>>>(
        gpair, pc, starts, counts, origins, jhi, fwd_out, cot,
        static_cast<SlabT*>(slab), rows, n_channels, ts, alpha_max,
        alpha_min);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int n_channels, ts;
  int *threads, *smem, *blocks_per_sm;

  template <int MAXC, typename SlabT, int PIX>
  int run() {
    auto kernel = bwd_pairwalk_kernel<MAXC, SlabT, PIX>;
    const size_t bytes = smem_of<MAXC>(n_channels, ts);
    const cudaError_t err = prepare(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = ts * ts / PIX;
    *smem = static_cast<int>(bytes);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, *threads, bytes));
  }
};

// tile sizes the layout takes: whole pixel groups per row, whole warps
bool valid(int n_channels, int ts, int rows) {
  const int pix = pix_for(ts);
  return n_channels >= 1 && n_channels <= MAX_CHANNELS && ts >= 1 &&
         ts % pix == 0 && (ts * ts) % (32 * pix) == 0 &&
         ts * ts <= pix * MAX_THREADS &&
         (rows == 8 || rows == 16 || rows == 32) &&
         rows >= N_FIXED + n_channels;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). gpair's
// segments start at multiples of 128 and span multiples of 128 pairs
// inside its PC columns, PC % 4 == 0 and gpair 16-byte aligned.
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
  Launch op{gpair, pc, starts, counts, origins, jhi, fwd_out, cot, slab,
            n_tiles, rows, n_channels, ts, alpha_max, alpha_min,
            static_cast<cudaStream_t>(stream)};
  return dispatch(n_channels, ts, slab_bf16, op);
}

// The launch's threads and dynamic shared memory per block and how many
// blocks of it fit on one SM (registers and shared memory together), for
// a slab of 16 rows (32 past 9 channels). Returns a CUDA error code (0 =
// ok).
extern "C" int bwd_pairwalk_info(int n_channels, int ts, int slab_bf16,
                                 int* threads, int* smem,
                                 int* blocks_per_sm) {
  if (!valid(n_channels, ts, N_FIXED + n_channels <= 16 ? 16 : 32))
    return static_cast<int>(cudaErrorInvalidValue);
  Info op{n_channels, ts, threads, smem, blocks_per_sm};
  return dispatch(n_channels, ts, slab_bf16, op);
}

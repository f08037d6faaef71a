// Per-Gaussian reduction of the backward's per-pair gradient slab:
// per-pair rows -> per-rank rows, without sorting the pairs.
//
// Replaces, from splatloc_tpu/raster/pallas_raster.py::_reduce_to_gauss:
//   - the stable sort of the pairs by depth rank (sort_key_val) and the
//     gather of slab rows through its permutation;
//   - _compact_copy_kernel (launched by _force_compact): its upcast of the
//     slab to float32 is this reduction's load, which reads the slab's dtype
//     (bfloat16 or float32) and accumulates in float32. Its other half,
//     pinning the TPU's compact (rows-sublane, PC-lane) layout for the scan,
//     has no meaning on Hopper and is dropped;
//   - _segscan_kernel (launched by _segscan), the inclusive segmented prefix
//     sum over the sorted pairs, together with the run-end read that is all
//     the reference consumes of it.
//
// What the reference computes, stated without a sort. With cnt[r] the number
// of pair positions holding id r < K, S the exclusive prefix sum of cnt, E
// the inclusive prefix sum of the emitted counts (per_rank_counts) and
// at = clip(E[r] - 1, 0, PC - 1): rank r is valid iff S[r] <= at <
// S[r] + cnt[r]; a valid rank gets the float32 sum of the slab rows of its
// first at - S[r] + 1 pair positions in ascending order (all of them when
// nothing was dropped), every other rank zeros. Ids >= K (filler, sentinel,
// the slab's unwritten tail) reach no rank.
//
// What bounds it: bytes. pair_idx read once, the surviving pairs' slab rows
// read once, one 4-byte bucket entry per pair written and read, K-sized
// counters and the [K, rows] float32 output; a few additions per value.
//
// Design, four launches and no float atomics:
//   1. prep:   one block per chunk of 256 ranks: the chunk's exclusive scan of
//              the emitted counts (each rank's bucket offset in the chunk),
//              the chunk's totals, and the counters zeroed.
//   2. fill:   one thread per pair position reads pair_idx coalesced; an
//              integer atomicAdd on cnt[r] gives the pair a slot in r's
//              bucket, which is sized by the emitted count (never below the
//              surviving count). Only integers race, so the set of positions
//              in every bucket is the same in every run.
//   3. tally:  one block per chunk sums its counters (the chunk totals that
//              the reduce blocks' prefix sums need). Counting them in the
//              fill, once per warp and chunk (__match_any_sync), cost the
//              fill 3-4x: a warp's pairs fall in ~32 different chunks.
//   4. reduce: one block per chunk of 256 ranks: the run tests above from
//              block scans of cnt and the emitted counts, then the chunk's
//              buckets are staged in shared memory, each rank's positions
//              put in ascending order (each entry's index is the count of
//              smaller entries of its rank), so the float additions run in
//              one fixed order, and the rows summed with 16-byte loads:
//              runs of up to SHORT_RUN pairs by a group of ROWS * size / 16
//              lanes (several ranks per warp), longer ones by a whole warp
//              with a fixed shuffle tree. Results go out as 16-byte stores.
//              A valid rank whose bucket could not hold its pairs (a run
//              longer than CAP pairs, which only a view of more than CAP
//              tiles can give, or counts below the surviving pairs, never
//              from build_pairs) is summed by the whole block, which scans
//              pair_idx in order: slow, and exact. So the kernel takes runs
//              of any length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;          // every kernel's block
constexpr int CHUNK = 256;            // ranks per prep / reduce block
constexpr int MAX_CHUNKS = 4096;      // so at most 2^20 ranks
constexpr int FILL_PER_THREAD = 4;    // pair positions per fill thread
constexpr int CAP = 4096;             // bucket entries a block stages at once
constexpr int SHORT_RUN = 32;         // longer runs are summed by a warp
constexpr int UNROLL = 4;             // row loads in flight per lane
constexpr int SCAN_UNROLL = 8;        // pair_idx loads in flight (slow path)
static_assert(CHUNK == THREADS, "one rank per thread in the chunk scans");

template <typename V>
__device__ __forceinline__ V warp_incl_scan(V x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum over the block's threads in thread order; *total gets
// the block's sum. Every thread of the block calls it.
template <typename V>
__device__ V block_excl_scan(V v, V* total) {
  __shared__ V warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const V incl = warp_incl_scan(v, lane);
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  V before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    const V s = warp_sums[i];
    if (i < w) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// A rank's bucket holds at most CAP entries: the emitted count, clamped.
__device__ __forceinline__ int bucket_size(int emitted) {
  return min(max(emitted, 0), CAP);
}

__global__ void __launch_bounds__(THREADS)
prep_kernel(const int* __restrict__ emitted, int n_ranks,
            int2* __restrict__ binfo, int* __restrict__ cnt,
            int* __restrict__ esum, long long* __restrict__ rsum) {
  const int r = blockIdx.x * CHUNK + threadIdx.x;
  const int e = r < n_ranks ? emitted[r] : 0;
  int size_total;
  const int excl = block_excl_scan(bucket_size(e), &size_total);
  long long e_total;
  block_excl_scan(static_cast<long long>(e), &e_total);
  if (r < n_ranks) {
    binfo[r] = make_int2(excl, e);       // bucket offset in the chunk, count
    cnt[r] = 0;
  }
  if (threadIdx.x == 0) {
    esum[blockIdx.x] = size_total;
    rsum[blockIdx.x] = e_total;
  }
}

__global__ void __launch_bounds__(THREADS)
fill_kernel(const int* __restrict__ pair_idx, long long pc, int n_ranks,
            int n_chunks, const int2* __restrict__ binfo,
            const int* __restrict__ esum, int* __restrict__ cnt,
            int* __restrict__ bucket) {
  const long long first =
      static_cast<long long>(blockIdx.x) * (THREADS * FILL_PER_THREAD) +
      threadIdx.x;
  int r[FILL_PER_THREAD];
  bool mine[FILL_PER_THREAD];
#pragma unroll
  for (int u = 0; u < FILL_PER_THREAD; ++u) {
    const long long p = first + u * THREADS;
    r[u] = p < pc ? pair_idx[p] : -1;
  }
  int slot[FILL_PER_THREAD];
  int2 bi[FILL_PER_THREAD];
#pragma unroll
  for (int u = 0; u < FILL_PER_THREAD; ++u) {
    mine[u] = r[u] >= 0 && r[u] < n_ranks;
    if (mine[u]) {
      slot[u] = atomicAdd(cnt + r[u], 1);
      bi[u] = binfo[r[u]];
    }
  }
  // every chunk's bucket start (clamped to pc: nothing is written past it),
  // while the loads and atomics above are in flight
  __shared__ int cpre[MAX_CHUNKS];
  {
    const int per = (n_chunks + THREADS - 1) / THREADS;
    const int lo = threadIdx.x * per;
    long long s = 0;
    for (int i = 0; i < per; ++i)
      if (lo + i < n_chunks) s += esum[lo + i];
    long long total;
    long long run = block_excl_scan(s, &total);
    for (int i = 0; i < per; ++i) {
      if (lo + i < n_chunks) {
        cpre[lo + i] = static_cast<int>(run < pc ? run : pc);
        run += esum[lo + i];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < FILL_PER_THREAD; ++u) {
    if (!mine[u]) continue;
    const long long at =
        static_cast<long long>(cpre[r[u] / CHUNK]) + bi[u].x + slot[u];
    if (slot[u] < bucket_size(bi[u].y) && at < pc)
      bucket[at] = static_cast<int>(first + u * THREADS);
  }
}

__global__ void __launch_bounds__(THREADS)
tally_kernel(const int* __restrict__ cnt, int n_ranks,
             int* __restrict__ csum) {
  const int r = blockIdx.x * CHUNK + threadIdx.x;
  int total;
  block_excl_scan(r < n_ranks ? cnt[r] : 0, &total);
  if (threadIdx.x == 0) csum[blockIdx.x] = total;
}

// 16 bytes of a slab row -> VEC float32 values added into acc
template <int VEC>
__device__ __forceinline__ void add_vec(float (&acc)[VEC], const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (VEC == 8) {          // bfloat16: the upcast is exact
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += __uint_as_float(w[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&acc)[VEC]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i)
    d[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                       acc[4 * i + 3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the last of the window's ranks [lo, hi] whose staged entries start at or
// before x (ranks with no entries share the next one's start)
__device__ __forceinline__ int owner(const int* s_soff, int lo, int hi,
                                     int x) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_soff[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A rank whose bucket could not hold its pairs, summed by the whole block:
// each warp scans its own contiguous part of pair_idx, 32 * SCAN_UNROLL
// positions a step, twice. First it counts the rank's pairs there; then it
// sums, in ascending position, those of them among the rank's first n, and
// the parts' sums are added in warp order. Out of line, and called only in
// a block that holds such a rank, so the main path does not carry it.
// Every thread of the block calls it.
template <typename T, int ROWS>
__device__ __noinline__ void scan_rank(const T* __restrict__ slab,
                                       long long pc,
                                       const int* __restrict__ pair_idx,
                                       int rank, int n,
                                       float* __restrict__ out) {
  constexpr int NW = THREADS / 32;
  __shared__ int s_cnt[NW];
  __shared__ float s_part[NW][ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (pc + NW - 1) / NW;
  const long long lo = warp * per, hi = min(pc, lo + per);
  int c = 0;
  for (long long p0 = lo; p0 < hi; p0 += 32 * SCAN_UNROLL) {
    int id[SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const long long p = p0 + u * 32 + lane;
      id[u] = p < hi ? __ldg(pair_idx + p) : -1;
    }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u)
      c += __popc(__ballot_sync(FULL, id[u] == rank));
  }
  if (lane == 0) s_cnt[warp] = c;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_cnt[w];
  const int mine = min(max(n - before, 0), c);
  float acc = 0.f;
  int taken = 0;
  for (long long p0 = lo; p0 < hi && taken < mine; p0 += 32 * SCAN_UNROLL) {
    int id[SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const long long p = p0 + u * 32 + lane;
      id[u] = p < hi ? __ldg(pair_idx + p) : -1;
    }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      unsigned hits = __ballot_sync(FULL, id[u] == rank);
      while (hits && taken < mine) {
        const long long p = p0 + u * 32 + (__ffs(hits) - 1);
        hits &= hits - 1;
        if (lane < ROWS) acc += to_float(slab[p * ROWS + lane]);
        ++taken;
      }
    }
  }
  if (lane < ROWS) s_part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && lane < ROWS) {
    float sum = 0.f;
    for (int w = 0; w < NW; ++w) sum += s_part[w][lane];
    out[static_cast<long long>(rank) * ROWS + lane] = sum;
  }
  __syncthreads();                      // s_cnt and s_part are reused
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const T* __restrict__ slab, long long pc,
              const int* __restrict__ pair_idx, int n_ranks,
              const int2* __restrict__ binfo, const int* __restrict__ cnt,
              const int* __restrict__ esum, const long long* __restrict__ rsum,
              const int* __restrict__ csum, const int* __restrict__ bucket,
              float* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);   // values per 16-byte load
  constexpr int G = ROWS / VEC;         // lanes per row
  constexpr int NG = 32 / G;            // row groups per warp
  static_assert(ROWS % VEC == 0 && 32 % G == 0, "rows 8, 16 or 32");
  __shared__ int raw[CAP];              // staged bucket entries
  __shared__ int sorted_pos[CAP];       // the same, ascending per rank
  __shared__ int s_soff[CHUNK];         // a rank's first staged entry
  __shared__ int s_m[CHUNK];            // its staged entries
  __shared__ int s_need[CHUNK];         // pairs it sums (0: a zero row)
  __shared__ bool s_slow[CHUNK];
  __shared__ long long s_gb[CHUNK];     // its bucket in global memory

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * CHUNK;
  // this chunk's counters, and the earlier chunks' bucket sizes, emitted
  // and surviving pairs
  const int r = r0 + tid;
  const bool in = r < n_ranks;
  const int2 bi = in ? binfo[r] : make_int2(0, 0);
  const int c = in ? cnt[r] : 0;
  long long pe = 0, pr = 0;
  int pcn = 0;
  for (int i = tid; i < static_cast<int>(blockIdx.x); i += THREADS) {
    pe += esum[i];
    pr += rsum[i];
    pcn += csum[i];
  }
  block_excl_scan(pe, &pe);
  block_excl_scan(pr, &pr);
  block_excl_scan(pcn, &pcn);
  const long long gbase = (pe < pc ? pe : pc) + bi.x;   // as fill placed it
  int itot;
  long long ltot;
  const long long S = pcn + block_excl_scan(c, &itot);
  const long long E =
      pr + block_excl_scan(static_cast<long long>(bi.y), &ltot) + bi.y;
  long long at = E - 1;
  at = at < 0 ? 0 : (at > pc - 1 ? pc - 1 : at);
  const bool valid = in && S <= at && at < S + c;
  const int need = valid ? static_cast<int>(at - S + 1) : 0;
  const bool complete = c <= bucket_size(bi.y) && gbase + c <= pc;
  const int m = valid && complete ? c : 0;
  const int soff = block_excl_scan(m, &itot);
  s_soff[tid] = soff;
  s_m[tid] = m;
  s_need[tid] = need;
  s_slow[tid] = valid && !complete;
  s_gb[tid] = gbase;
  const bool any_slow = __syncthreads_or(valid && !complete);

  const uint4* rows4 = reinterpret_cast<const uint4*>(slab);
  const int end = soff + m;
  // windows of whole ranks whose entries fit CAP (m <= CAP, so each window
  // takes at least one rank; nearly always one window per chunk)
  int w0 = 0;
  while (w0 < CHUNK) {
    const int base_off = s_soff[w0];
    const int w1 = __syncthreads_count(end <= base_off + CAP);
    const int n_ent = s_soff[w1 - 1] + s_m[w1 - 1] - base_off;
    for (int j = tid; j < n_ent; j += THREADS) {
      const int i = owner(s_soff, w0, w1 - 1, base_off + j);
      raw[j] = bucket[s_gb[i] + (base_off + j - s_soff[i])];
    }
    __syncthreads();
    for (int j = tid; j < n_ent; j += THREADS) {
      const int i = owner(s_soff, w0, w1 - 1, base_off + j);
      const int lo = s_soff[i] - base_off, hi = lo + s_m[i];
      const int v = raw[j];
      int k = 0;
      for (int q = lo; q < hi; ++q) k += raw[q] < v;
      sorted_pos[lo + k] = v;
    }
    __syncthreads();
    // short runs (and zero rows): a group of G lanes per rank
    {
      const int li = tid % G;
      for (int i = w0 + tid / G; i < w1; i += THREADS / G) {
        const int n = s_need[i];
        if (r0 + i >= n_ranks || s_slow[i] || n > SHORT_RUN) continue;
        const int* ps = sorted_pos + (s_soff[i] - base_off);
        float acc[VEC] = {};
        for (int k = 0; k < n; k += UNROLL) {
          uint4 v[UNROLL] = {};
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (k + u < n)
              v[u] = __ldg(rows4 + static_cast<long long>(ps[k + u]) * G + li);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (k + u < n) add_vec<VEC>(acc, v[u]);
        }
        store_vec<VEC>(out + static_cast<long long>(r0 + i) * ROWS + li * VEC,
                       acc);
      }
    }
    // long runs: a warp per rank, NG strided sub-sums and a fixed tree
    {
      const int sub = lane / G, li = lane % G;
      for (int i = w0 + warp; i < w1; i += THREADS / 32) {
        const int n = s_need[i];
        if (r0 + i >= n_ranks || s_slow[i] || n <= SHORT_RUN) continue;
        const int* ps = sorted_pos + (s_soff[i] - base_off);
        float acc[VEC] = {};
        for (int k = sub; k < n; k += UNROLL * NG) {
          uint4 v[UNROLL] = {};
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (k + u * NG < n)
              v[u] = __ldg(rows4 + static_cast<long long>(ps[k + u * NG]) * G +
                           li);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (k + u * NG < n) add_vec<VEC>(acc, v[u]);
        }
#pragma unroll
        for (int o = NG / 2; o > 0; o >>= 1)
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[q] += __shfl_down_sync(FULL, acc[q], o * G);
        if (sub == 0)
          store_vec<VEC>(out + static_cast<long long>(r0 + i) * ROWS + li * VEC,
                         acc);
      }
    }
    w0 = w1;
  }

  // ranks whose bucket could not hold their pairs, one at a time
  if (any_slow)
    for (int i = 0; i < CHUNK; ++i)
      if (s_slow[i])
        scan_rank<T, ROWS>(slab, pc, pair_idx, r0 + i, s_need[i], out);
}

struct Layout {              // the scratch buffer, in int32 units
  long long binfo, cnt, esum, rsum, csum, bucket, total;
};

Layout layout(int n_ranks, long long pc) {
  const long long nb = (n_ranks + CHUNK - 1) / CHUNK;
  Layout l;
  l.binfo = 0;
  l.cnt = 2LL * n_ranks;
  l.rsum = (3LL * n_ranks + 1) / 2 * 2;   // 8-byte aligned
  l.esum = l.rsum + 2 * nb;
  l.csum = l.esum + nb;
  l.bucket = l.csum + nb;
  l.total = l.bucket + pc;
  return l;
}

template <typename T, int ROWS>
void launch_reduce(unsigned blocks, cudaStream_t st, const void* slab,
                   long long pc, const int* pair_idx, int n_ranks, int* s,
                   const Layout& l, float* out) {
  reduce_kernel<T, ROWS><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(slab), pc, pair_idx, n_ranks,
      reinterpret_cast<const int2*>(s + l.binfo), s + l.cnt, s + l.esum,
      reinterpret_cast<const long long*>(s + l.rsum), s + l.csum,
      s + l.bucket, out);
}

template <typename T>
void launch_reduce_rows(int rows, unsigned blocks, cudaStream_t st,
                        const void* slab, long long pc, const int* pair_idx,
                        int n_ranks, int* s, const Layout& l, float* out) {
  if (rows == 8)
    launch_reduce<T, 8>(blocks, st, slab, pc, pair_idx, n_ranks, s, l, out);
  else if (rows == 16)
    launch_reduce<T, 16>(blocks, st, slab, pc, pair_idx, n_ranks, s, l, out);
  else
    launch_reduce<T, 32>(blocks, st, slab, pc, pair_idx, n_ranks, s, l, out);
}

}  // namespace

// int32 elements of the scratch buffer seg_reduce_launch needs.
extern "C" long long seg_reduce_scratch_ints(int n_ranks, long long pc) {
  return layout(n_ranks, pc).total;
}

// slab [pc, rows] (bfloat16 if slab_bf16, else float32, 16-byte aligned),
// pair_idx [pc] and emitted [n_ranks] int32, scratch of
// seg_reduce_scratch_ints(n_ranks, pc) int32, out [n_ranks, rows] float32.
// Returns cudaGetLastError() after the four launches (0 = launched), or
// cudaErrorInvalidValue, launching nothing, for other rows, pc >= 2^31 or
// more than MAX_CHUNKS * CHUNK = 2^20 ranks.
extern "C" int seg_reduce_launch(const void* slab, int slab_bf16, int rows,
                                 long long pc, const int* pair_idx,
                                 const int* emitted, int n_ranks, int* scratch,
                                 float* out, void* stream) {
  if (n_ranks <= 0) return 0;
  if (!(rows == 8 || rows == 16 || rows == 32) || pc <= 0 ||
      pc >= (1LL << 31) || n_ranks > MAX_CHUNKS * CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n_ranks, pc);
  const int nb = (n_ranks + CHUNK - 1) / CHUNK;
  int2* binfo = reinterpret_cast<int2*>(scratch + l.binfo);
  long long* rsum = reinterpret_cast<long long*>(scratch + l.rsum);
  prep_kernel<<<nb, THREADS, 0, st>>>(emitted, n_ranks, binfo,
                                      scratch + l.cnt, scratch + l.esum, rsum);
  const long long per_block = THREADS * FILL_PER_THREAD;
  fill_kernel<<<static_cast<unsigned>((pc + per_block - 1) / per_block),
                THREADS, 0, st>>>(pair_idx, pc, n_ranks, nb, binfo,
                                  scratch + l.esum, scratch + l.cnt,
                                  scratch + l.bucket);
  tally_kernel<<<nb, THREADS, 0, st>>>(scratch + l.cnt, n_ranks,
                                       scratch + l.csum);
  if (slab_bf16)
    launch_reduce_rows<__nv_bfloat16>(rows, nb, st, slab, pc, pair_idx,
                                      n_ranks, scratch, l, out);
  else
    launch_reduce_rows<float>(rows, nb, st, slab, pc, pair_idx, n_ranks,
                              scratch, l, out);
  return static_cast<int>(cudaGetLastError());
}

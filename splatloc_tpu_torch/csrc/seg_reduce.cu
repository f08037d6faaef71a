// Segmented per-rank reduction of the backward's per-pair gradient slab:
// per-pair rows -> per-Gaussian rows.
//
// Replaces, from splatloc_tpu/raster/pallas_raster.py::_reduce_to_gauss:
//   - the gather of slab rows through the rank-sort permutation;
//   - _compact_copy_kernel (launched by _force_compact): its upcast of the
//     slab to float32 is this kernel's load, which reads the slab's dtype
//     (bfloat16 or float32) and accumulates in float32. Its other half,
//     pinning the TPU's compact (rows-sublane, PC-lane) layout for the scan,
//     has no meaning on Hopper and is dropped;
//   - _segscan_kernel (launched by _segscan), the inclusive segmented prefix
//     sum along the pairs, together with the run-end read that is all the
//     reference consumes of it.
// For every rank r < K it writes what the reference reads at
// at = clip(ends[r] - 1, 0, PC - 1): where si[at] == r, the float32 sum of
// the slab rows perm[p] for p from the first position of r's run in the
// sorted ids si up to at; else zeros. With nothing dropped that is the whole
// run [ends[r-1], ends[r]); with dropped pairs it is the reference's partial
// run. Pair ids past the last tile's segment are the sentinel K, so the
// unwritten tail of the slab never reaches a rank below K.
//
// What bounds it: bytes. It moves the slab once (random rows of `rows`
// values through perm), the perm / si / ends index arrays and the [K, rows]
// float32 output; a few additions per value.
//
// Design (the simple first version): one warp per rank. The warp finds the
// start of the rank's run by stepping back from `at` 32 ids at a time (a
// ballot over si), then reads the run's rows in order, 32 / rows pairs per
// step with one lane per row value, and adds the lanes' partial sums with a
// fixed shuffle tree. No atomics and a fixed order of additions: the result
// does not change from run to run. Runs of any length work (a giant splat's
// run is up to its tile cap long).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename SlabT>
__global__ void seg_reduce_kernel(const SlabT* __restrict__ slab, int rows,
                                  long long pc, const int* __restrict__ perm,
                                  const int* __restrict__ si,
                                  const int* __restrict__ ends, int n_ranks,
                                  float* __restrict__ out) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_ranks) return;                // whole warps leave together
  const int rank = static_cast<int>(r);
  float* o = out + r * rows;
  long long at = static_cast<long long>(ends[rank]) - 1;
  at = at < 0 ? 0 : (at > pc - 1 ? pc - 1 : at);
  if (si[at] != rank) {
    for (int i = lane; i < rows; i += 32) o[i] = 0.f;
    return;
  }
  // first position of the run: ids ascend, so every id before it differs
  long long first = at;
  while (true) {
    const long long p = first - 1 - lane;
    const bool same = p >= 0 && si[p] == rank;
    const unsigned differ = __ballot_sync(FULL, !same);
    if (differ == 0) {
      first -= 32;
      continue;
    }
    first -= __ffs(differ) - 1;
    break;
  }
  // rows is 8, 16 or 32: lane = sub * rows + row
  const int per_step = 32 / rows;
  const int row = lane % rows;
  const int sub = lane / rows;
  float acc = 0.f;
  for (long long p = first + sub; p <= at; p += per_step)
    acc += load(slab + static_cast<long long>(perm[p]) * rows + row);
  for (int off = rows; off < 32; off <<= 1)
    acc += __shfl_down_sync(FULL, acc, off);
  if (lane < rows) o[row] = acc;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int seg_reduce_launch(const void* slab, int slab_bf16, int rows,
                                 long long pc, const int* perm, const int* si,
                                 const int* ends, int n_ranks, float* out,
                                 void* stream) {
  if (n_ranks <= 0) return 0;
  if (!(rows == 8 || rows == 16 || rows == 32) || pc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * WARPS_PER_BLOCK;
  const long long blocks =
      (static_cast<long long>(n_ranks) + WARPS_PER_BLOCK - 1) /
      WARPS_PER_BLOCK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab_bf16)
    seg_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(slab), rows, pc, perm, si, ends,
        n_ranks, out);
  else
    seg_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(slab), rows, pc, perm, si, ends, n_ranks,
        out);
  return static_cast<int>(cudaGetLastError());
}

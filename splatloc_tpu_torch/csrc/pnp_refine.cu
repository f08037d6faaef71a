// PnP's Gauss-Newton fits: every iteration of the masked fit of one pose in
// one thread block.
//
// Replaces no Pallas kernel: the JAX package's PnP (splatloc_tpu/match/
// pnp.py) is jnp code that XLA fuses. In PyTorch the same fit
// (match/pnp.py::_gauss_newton_refine) issues each iteration as hundreds of
// small launches (vmap(jacfwd(_residual)), the residual, a bmm, solve_ex,
// the twist update): ~15 ms of host time an iteration, whatever the batch.
// This kernel computes that iteration, so that a RANSAC solve fits its poses
// in two launches:
//   hypotheses (best == nullptr): block b fits pose b of n_poses on the
//     valid pairs within weight_thresh (3 x thresh) of that pose's own
//     reprojection, then scores the fitted pose as the plain version does:
//     its strict inliers (valid pairs reprojected within thresh), or -1
//     where the DLT was not ok or the fitted t is not finite;
//   final (best != nullptr): one block reads the winner's index from device
//     memory (torch.argmax's output, so the host waits for nothing), fits
//     that pose on its strict inliers (weight_thresh = thresh) and writes
//     the fitted pose, its inlier mask and their count.
// The iteration is gauss_newton_fit_plain's, step for step: the twist xi
// starts at 0 and accumulates (xi -= dx); each iteration linearises the
// weighted residual (proj(se3_exp(xi) (R, t), X) - x) w at the current xi,
// with the Jacobian in forward mode as jacfwd takes it: a value and one
// tangent for each of the 6 twist directions, carried through
// core.transforms.se3_exp (its theta^2 < 1e-14 branch chosen on the value,
// as torch.where chooses) and through the projection (z clamped at 1e-6,
// its tangent kept where z >= 1e-6, as torch.clamp keeps it); then
// dx = (J^T J + 1e-8 I)^-1 J^T r; after the last iteration se3_exp(xi) is
// applied to (R, t). A pair of weight 0 adds nothing (in the plain version
// it adds 0 x its terms, which is nothing where they are finite).
//
// Precision: residuals and Jacobians in float32, the precision the plain
// version states (full_float32). The 21 entries of J^T J and the 6 of J^T r
// are summed in float64, where each product of two float32 values is exact,
// in a fixed order: each thread over its pairs in turn, a warp shuffle tree,
// then the warps in order. The 6x6 system is solved in float64 by LU with
// partial pivoting (a singular or non-finite system gives a non-finite step,
// as solve_ex does). So two launches agree bit for bit.
//
// What bounds it: latency. The work is small: the hypotheses' launch at
// 1,024 poses, 5 iterations and ~900 pairs is ~0.3 GFLOP of float64 sums
// and ~0.9 GFLOP of float32, ~10-15 us at the card's rates, on inputs of
// tens of KB. But each iteration is a chain of dependent steps behind
// barriers: the twist's exponential (6 threads, one tangent each), the
// pairs, a block reduction, a serial 6x6 solve by one thread.
//
// Design: one block of THREADS threads a pose, because a pose's iterations
// depend on each other and on nothing outside the pose. The block keeps xi
// and the transformed pose with its 6 tangents in shared memory, and its
// threads take strided shares of the pairs, so any number of pairs fits.
// 1,024 poses are 1,024 blocks, a few blocks on each of the 132 SMs at once,
// so their serial chains run side by side. The pairs (20 bytes each, the
// same for every block) are read through the read-only cache in every
// iteration, and a pair's weight is recomputed from the starting pose rather
// than stored, so shared memory does not grow with the pairs.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int N_JTJ = 21;          // J^T J's upper triangle, row by row
constexpr int N_SUMS = N_JTJ + 6;  // then J^T r
constexpr unsigned FULL = 0xffffffffu;

// A float32 value with its tangent along one direction of the twist.
struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual cst(float v) { return {v, 0.f}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float s = sqrtf(a.v);
  return {s, a.d / (2.f * s)};
}
__device__ __forceinline__ Dual dsin(Dual a) {
  return {sinf(a.v), cosf(a.v) * a.d};
}
__device__ __forceinline__ Dual dcos(Dual a) {
  return {cosf(a.v), -sinf(a.v) * a.d};
}

// core.transforms.se3_exp(xi): rotation E and translation e, each with its
// tangent along the direction that xi's tangents carry.
__device__ void se3_exp(const Dual xi[6], Dual E[3][3], Dual e[3]) {
  const Dual* rho = xi;
  const Dual* w = xi + 3;
  const Dual zero = cst(0.f);
  const Dual S[3][3] = {{zero, -w[2], w[1]},
                        {w[2], zero, -w[0]},
                        {-w[1], w[0], zero}};
  const Dual theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  Dual V[3][3];
  if (theta2.v < 1e-14f) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const Dual id = cst(i == j ? 1.f : 0.f);
        E[i][j] = id + S[i][j];
        V[i][j] = id + cst(0.5f) * S[i][j];
      }
  } else {
    const Dual theta = dsqrt(theta2);
    Dual K[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) K[i][j] = S[i][j] / theta;
    const Dual s = dsin(theta), one_c = cst(1.f) - dcos(theta);
    const Dual b = one_c / theta, g = (theta - s) / theta;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const Dual kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] +
                        K[i][2] * K[2][j];
        const Dual id = cst(i == j ? 1.f : 0.f);
        E[i][j] = id + s * K[i][j] + one_c * kk;
        V[i][j] = id + b * K[i][j] + g * kk;
      }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    e[i] = V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2];
}

// se3_exp(xi) applied to the pose P (R row-major, then t): E R and E t + e.
// Writes the value into column 0 of out (when dir == 0) and the tangent
// along twist direction dir into column dir + 1.
__device__ void linearise(const float* xi_v, int dir, const float P[12],
                          float (*out)[7]) {
  Dual xi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) xi[k] = {xi_v[k], k == dir ? 1.f : 0.f};
  Dual E[3][3], e[3];
  se3_exp(xi, E, e);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const Dual r = E[i][0] * cst(P[j]) + E[i][1] * cst(P[3 + j]) +
                     E[i][2] * cst(P[6 + j]);
      if (dir == 0) out[3 * i + j][0] = r.v;
      out[3 * i + j][dir + 1] = r.d;
    }
    const Dual tt = E[i][0] * cst(P[9]) + E[i][1] * cst(P[10]) +
                    E[i][2] * cst(P[11]) + e[i];
    if (dir == 0) out[9 + i][0] = tt.v;
    out[9 + i][dir + 1] = tt.d;
  }
}

// pnp._reproj_errors of one pair under pose P: the normalized reprojection
// error, inf where the point is not 0.01 in front of the camera.
__device__ __forceinline__ float reproj_err(const float P[12], const float X[3],
                                            const float x[2]) {
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = P[3 * i] * X[0] + P[3 * i + 1] * X[1] + P[3 * i + 2] * X[2] +
           P[9 + i];
  const float zs = fabsf(c[2]) > 1e-6f ? c[2] : 1e-6f;
  const float ex = c[0] / zs - x[0], ey = c[1] / zs - x[1];
  const float err = sqrtf(ex * ex + ey * ey);
  return c[2] > 0.01f ? err : INFINITY;
}

__device__ __forceinline__ void load_pair(const float* __restrict__ pts2d,
                                          const float* __restrict__ pts3d,
                                          int p, float X[3], float x[2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) X[i] = __ldg(pts3d + 3 * p + i);
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __ldg(pts2d + 2 * p + i);
}

// Solves (A + 1e-8 I) dx = g in float64 by LU with partial pivoting, from
// the warps' partial sums, and steps xi -= dx.
__device__ void solve_step(const double (*sums)[N_SUMS], float* xi) {
  double A[6][7];
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++s) {
      double v = sums[0][s];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += sums[w][s];
      A[i][j] = v;
      A[j][i] = v;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] += static_cast<double>(1e-8f);
    double v = sums[0][N_JTJ + i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += sums[w][N_JTJ + i];
    A[i][6] = v;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    double big = fabs(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabs(A[r][c]) > big) {
        big = fabs(A[r][c]);
        piv = r;
      }
#pragma unroll
    for (int k = c; k < 7; ++k) {
      const double tmp = A[c][k];
      A[c][k] = A[piv][k];
      A[piv][k] = tmp;
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const double f = A[r][c] / A[c][c];
#pragma unroll
      for (int k = c + 1; k < 7; ++k) A[r][k] -= f * A[c][k];
    }
  }
  double dx[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double v = A[i][6];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= A[i][k] * dx[k];
    dx[i] = v / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] -= static_cast<float>(dx[i]);
}

struct Shared {
  float pose[12];     // the starting pose: R row-major, then t
  float fitted[12];   // the fitted pose
  float xi[6];
  float lin[12][7];   // se3_exp(xi) applied to the pose: value, 6 tangents
  double sums[WARPS][N_SUMS];
  int counts[WARPS];
};

template <bool FINAL>
__global__ void __launch_bounds__(THREADS) pnp_refine_kernel(
    const float* __restrict__ R, const float* __restrict__ t,
    const unsigned char* __restrict__ ok, const long long* __restrict__ best,
    const float* __restrict__ pts2d, const float* __restrict__ pts3d,
    const unsigned char* __restrict__ valid, int n_pairs, float weight_thresh,
    float thresh, int iters, float* __restrict__ R_out,
    float* __restrict__ t_out, long long* __restrict__ score,
    unsigned char* __restrict__ inliers, long long* __restrict__ count) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = FINAL ? *best : static_cast<long long>(blockIdx.x);
  if (tid < 12) sh.pose[tid] = tid < 9 ? R[b * 9 + tid] : t[b * 3 + tid - 9];
  if (tid < 6) sh.xi[tid] = 0.f;
  __syncthreads();
  float P[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = sh.pose[k];

  for (int it = 0; it < iters; ++it) {
    if (tid < 6) linearise(sh.xi, tid, P, sh.lin);
    __syncthreads();
    double acc[N_SUMS];
#pragma unroll
    for (int s = 0; s < N_SUMS; ++s) acc[s] = 0.0;
    for (int p = tid; p < n_pairs; p += THREADS) {
      float X[3], x[2];
      load_pair(pts2d, pts3d, p, X, x);
      if (!(valid[p] && reproj_err(P, X, x) < weight_thresh)) continue;
      float c[3][7];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 7; ++k)
          c[i][k] = sh.lin[3 * i][k] * X[0] + sh.lin[3 * i + 1][k] * X[1] +
                    sh.lin[3 * i + 2][k] * X[2] + sh.lin[9 + i][k];
      // torch.clamp(z, min=1e-6): NaN stays NaN; the tangent passes where
      // z >= 1e-6
      const float z = c[2][0] < 1e-6f ? 1e-6f : c[2][0];
      const bool pass = c[2][0] >= 1e-6f;
      float r[2], J[2][6];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float q = c[a][0] / z;
        r[a] = q - x[a];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float dz = pass ? c[2][k + 1] : 0.f;
          J[a][k] = (c[a][k + 1] - q * dz) / z;
        }
      }
      int s = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++s)
          acc[s] += static_cast<double>(J[0][i]) * J[0][j] +
                    static_cast<double>(J[1][i]) * J[1][j];
#pragma unroll
      for (int i = 0; i < 6; ++i)
        acc[N_JTJ + i] += static_cast<double>(J[0][i]) * r[0] +
                          static_cast<double>(J[1][i]) * r[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int s = 0; s < N_SUMS; ++s)
        acc[s] += __shfl_down_sync(FULL, acc[s], off);
    if (lane == 0)
#pragma unroll
      for (int s = 0; s < N_SUMS; ++s) sh.sums[warp][s] = acc[s];
    __syncthreads();
    if (tid == 0) solve_step(sh.sums, sh.xi);
    __syncthreads();
  }

  if (tid == 0) {
    // the fitted pose, se3_exp(xi) applied to (R, t): the values of
    // linearise along any direction
    linearise(sh.xi, 0, P, sh.lin);
#pragma unroll
    for (int k = 0; k < 12; ++k) sh.fitted[k] = sh.lin[k][0];
  }
  __syncthreads();
  float F[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) F[k] = sh.fitted[k];
  const long long o = FINAL ? 0 : b;
  if (tid < 12) {
    if (tid < 9)
      R_out[o * 9 + tid] = F[tid];
    else
      t_out[o * 3 + tid - 9] = F[tid];
  }
  int n = 0;
  for (int p = tid; p < n_pairs; p += THREADS) {
    float X[3], x[2];
    load_pair(pts2d, pts3d, p, X, x);
    const bool in = valid[p] && reproj_err(F, X, x) < thresh;
    if (FINAL) inliers[p] = in;
    n += in;
  }
  n = __reduce_add_sync(FULL, n);
  if (lane == 0) sh.counts[warp] = n;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += sh.counts[w];
    if (FINAL) {
      *count = total;
    } else {
      const bool finite =
          isfinite(F[9]) && isfinite(F[10]) && isfinite(F[11]);
      score[b] = ok[b] && finite ? total : -1;
    }
  }
}

}  // namespace

// R [n_poses, 3, 3] and t [n_poses, 3] float32, pts2d [n_pairs, 2] and
// pts3d [n_pairs, 3] float32, valid [n_pairs] bool bytes, all contiguous.
// With best == nullptr (hypotheses): ok [n_poses] bool bytes; writes
// R_out/t_out [n_poses] and score [n_poses] int64. With best (final): the
// int64 index of the pose to fit, in [0, n_poses); writes R_out/t_out [1],
// inliers [n_pairs] bool bytes and count [1] int64. Launches on stream and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue,
// launching nothing, for n_poses < 1, n_pairs < 0 or iters < 0.
extern "C" int pnp_refine_launch(const float* R, const float* t,
                                 const unsigned char* ok,
                                 const long long* best, int n_poses,
                                 const float* pts2d, const float* pts3d,
                                 const unsigned char* valid, int n_pairs,
                                 float weight_thresh, float thresh, int iters,
                                 float* R_out, float* t_out, long long* score,
                                 unsigned char* inliers, long long* count,
                                 void* stream) {
  if (n_poses < 1 || n_pairs < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (best == nullptr)
    pnp_refine_kernel<false><<<n_poses, THREADS, 0, st>>>(
        R, t, ok, best, pts2d, pts3d, valid, n_pairs, weight_thresh, thresh,
        iters, R_out, t_out, score, inliers, count);
  else
    pnp_refine_kernel<true><<<1, THREADS, 0, st>>>(
        R, t, ok, best, pts2d, pts3d, valid, n_pairs, weight_thresh, thresh,
        iters, R_out, t_out, score, inliers, count);
  return static_cast<int>(cudaGetLastError());
}

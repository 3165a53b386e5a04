// Banded Cholesky factor, conditional Gaussian draw and preconditioner
// solve on Hopper, one thread per banded SPD system.
//
// Replaces the lax.scan recurrences of deconv3d_tpu/ops/banded.py (no
// Pallas kernel there): cholesky_banded (:77-117), sample_conditional
// (:184-192, the forward solve of :120-151 and the backward solve of
// :154-181), and the two solves of the direct sampler's Fourier-banded
// preconditioner (deconv3d_tpu/ops/direct.py:397-400, :548-549).  Band
// storage as there: bands[sys, l, k] = A[l, l+k] for k = 0..P
// (P = lw - 1 <= 10), zero past the matrix edge.
//
//   cholesky:  A = R^T R,  R[l, l+k] at out[sys, l, k]
//              R[l,l]   = sqrt(max((A[l,l] - sum_m R[l-m,l]^2)(1+jitter), eps))
//              R[l,l+k] = (A[l,l+k] - sum_m R[l-m,l] R[l-m,l+k]) / R[l,l]
//   sample:    R^T z = b  (forward),  R x = z + noise  (backward)
//              -> x ~ N(A^-1 b, A^-1) for standard-normal noise
//   solve:     R^T z = b,  R x = z  -> x = A^-1 b, for lambda-major
//              columns that name their factor (banded_solve_kernel below)
//
// Design.  Every step l depends on the P steps before it, so a system is
// one sequential chain of L steps: one thread walks it with what the next
// steps need in registers (Cholesky: the last P rows of R; forward solve:
// P partial sums; backward solve: the last P solution values).
// Systems are independent: a block is one warp of up to 32 systems.  The
// warp stages a chunk of rows of all its systems into shared memory with
// coalesced loads (a system's rows are contiguous), then each thread runs
// its system through the chunk; chunks are as long as 48 KB allow, so one
// system (the global coarse pass) streams 1000-row chunks and a batch of
// 32 a few dozen rows.  Outputs are stored straight from registers.
//
// What bounds it.  Latency, by design: the L steps of a system are serial
// (a division and a P-term dependent sum per step), so at L = 3681 one
// system is ~3681 x (a few dependent flops) no matter how many threads the
// card has; bytes (L x (P+1) floats in and out) and flops (~P^2 L) are
// tiny.  The staging keeps memory latency off the chain: one load round
// trip per chunk, not per step.

#include <cuda_runtime.h>

namespace deconv3d_banded {

constexpr int kWarp = 32;                 // systems (threads) per block
constexpr int kMaxP = 10;                 // lw <= 11
constexpr int kSmemFloats = 48 * 1024 / 4;

// Rows per staged chunk for `nsys` systems of `width` floats per row; a
// padding float after each system's rows (two per system at most) keeps
// the threads' rows in distinct banks.
__host__ __device__ inline int chunk_rows(int nsys, int width, int L) {
  const int rows = (kSmemFloats / nsys - 2) / width;
  return rows < L ? rows : L;
}

// Copy rows [l0, l0 + rows) of `nsys` systems (rows of `width` floats,
// `L` rows per system) from `src` into `dst` (system stride `stride`).
__device__ inline void stage(float* dst, const float* src, int sys0, int nsys,
                             int L, int l0, int rows, int width, int stride) {
  const int per = rows * width;
  for (int e = threadIdx.x; e < nsys * per; e += blockDim.x) {
    const int s = e / per, r = e - s * per;
    dst[s * stride + r] =
        src[(static_cast<long long>(sys0 + s) * L + l0) * width + r];
  }
}

template <int P>
__global__ void __launch_bounds__(kWarp)
    banded_cholesky_kernel(const float* __restrict__ bands,
                           float* __restrict__ out, int n_sys, int L,
                           float jitter) {
  constexpr int W = P + 1;
  __shared__ float smem[kSmemFloats];
  const int sys0 = blockIdx.x * kWarp;
  const int nsys = min(kWarp, n_sys - sys0);
  const int t = threadIdx.x;
  const int rows_max = chunk_rows(nsys, W, L);
  const int stride = rows_max * W + 1;
  // prev[m][k] = R[l-1-m, l-1-m+k]: the last P rows
  float prev[P > 0 ? P : 1][W];
#pragma unroll
  for (int m = 0; m < (P > 0 ? P : 1); ++m)
#pragma unroll
    for (int k = 0; k < W; ++k) prev[m][k] = 0.f;
  for (int l0 = 0; l0 < L; l0 += rows_max) {
    const int rows = min(rows_max, L - l0);
    __syncthreads();
    stage(smem, bands, sys0, nsys, L, l0, rows, W, stride);
    __syncthreads();
    if (t >= nsys) continue;
    const float* a = smem + t * stride;
    float* o = out + (static_cast<long long>(sys0 + t) * L + l0) * W;
    for (int r = 0; r < rows; ++r, a += W, o += W) {
      float s0 = a[0];
#pragma unroll
      for (int m = 1; m <= P; ++m) s0 -= prev[m - 1][m] * prev[m - 1][m];
      float row[W];
      row[0] = sqrtf(fmaxf(s0 * (1.f + jitter), 1e-30f));
#pragma unroll
      for (int k = 1; k <= P; ++k) {
        float sk = a[k];
#pragma unroll
        for (int m = 1; m <= P - k; ++m)
          sk -= prev[m - 1][m] * prev[m - 1][m + k];
        row[k] = sk / row[0];
      }
#pragma unroll
      for (int m = P - 1; m > 0; --m)
#pragma unroll
        for (int k = 0; k < W; ++k) prev[m][k] = prev[m - 1][k];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (P > 0) prev[0][k] = row[k];
        o[k] = row[k];
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kWarp)
    banded_sample_kernel(const float* __restrict__ R,
                         const float* __restrict__ b,
                         const float* __restrict__ noise, float* out,
                         int n_sys, int L) {
  constexpr int W = P + 1;
  constexpr int H = P > 0 ? P : 1;
  __shared__ float smem[kSmemFloats];
  const int sys0 = blockIdx.x * kWarp;
  const int nsys = min(kWarp, n_sys - sys0);
  const int t = threadIdx.x;
  // staged per row: the R row, then two vector entries (b and noise, or y)
  const int rows_max = chunk_rows(nsys, W + 2, L);
  const int rstride = rows_max * W + 1;
  const int vstride = 2 * rows_max + 1;
  float* sr = smem;                            // [nsys][rows][W]
  float* sv = smem + nsys * rstride;           // [nsys][2][rows]
  float* o = out + static_cast<long long>(sys0 + t) * L;

  // forward: R^T z = b, right-looking: acc[k] holds the sum of
  // R[i, l+1+k] z[i] over the rows i <= l done so far; y = z + noise -> out
  float acc[H];
#pragma unroll
  for (int k = 0; k < H; ++k) acc[k] = 0.f;
  for (int l0 = 0; l0 < L; l0 += rows_max) {
    const int rows = min(rows_max, L - l0);
    __syncthreads();
    stage(sr, R, sys0, nsys, L, l0, rows, W, rstride);
    stage(sv, b, sys0, nsys, L, l0, rows, 1, vstride);
    stage(sv + rows_max, noise, sys0, nsys, L, l0, rows, 1, vstride);
    __syncthreads();
    if (t >= nsys) continue;
    const float* rr = sr + t * rstride;
    const float* vb = sv + t * vstride;
    for (int r = 0; r < rows; ++r, rr += W) {
      const float z = (vb[r] - (P > 0 ? acc[0] : 0.f)) / rr[0];
#pragma unroll
      for (int k = 0; k < P; ++k)
        acc[k] = (k + 1 < P ? acc[k + 1] : 0.f) + rr[k + 1] * z;
      o[l0 + r] = z + vb[rows_max + r];
    }
  }
  __syncthreads();   // y of every system written and visible to the block

  // backward: R x = y from the last row up, hist[m] = x[l+1+m]; x
  // overwrites y (a chunk is staged before it is written)
  float hist[H];
#pragma unroll
  for (int m = 0; m < H; ++m) hist[m] = 0.f;
  for (int hi = L; hi > 0; hi -= rows_max) {
    const int l0 = max(0, hi - rows_max);
    const int rows = hi - l0;
    __syncthreads();
    stage(sr, R, sys0, nsys, L, l0, rows, W, rstride);
    stage(sv, out, sys0, nsys, L, l0, rows, 1, vstride);
    __syncthreads();
    if (t >= nsys) continue;
    const float* rr = sr + t * rstride;
    const float* vy = sv + t * vstride;
    for (int r = rows - 1; r >= 0; --r) {
      float s = vy[r];
#pragma unroll
      for (int m = 1; m <= P; ++m) s -= rr[r * W + m] * hist[m - 1];
      const float x = s / rr[r * W];
#pragma unroll
      for (int m = P - 1; m > 0; --m) hist[m] = hist[m - 1];
      if (P > 0) hist[0] = x;
      o[l0 + r] = x;
    }
  }
}

// x = R^-1 R^-T b for n right-hand-side columns that share factors: column
// c solves against R[fidx[c]] (the preconditioner of the direct sampler:
// one factor per spatial frequency, or per radial bin of frequencies).
// The columns are lambda-major, b[l, c] (the real view of an rfft2 cube,
// [L, Y, X//2+1, 2]): one thread per column, each step's b and out loads
// coalesced across the warp.  z, the forward solve, is kept in `out` and
// read back in reverse by the same thread, so b and out may be one buffer.
// A factor row is W contiguous floats, read through the read-only cache:
// columns of one factor (real and imaginary parts, the frequencies of one
// bin) share it.
template <int P>
__global__ void __launch_bounds__(128)
    banded_solve_kernel(const float* __restrict__ R,
                        const int* __restrict__ fidx, const float* b,
                        float* out, int n, int L) {
  constexpr int W = P + 1;
  constexpr int H = P > 0 ? P : 1;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const float* Rc = R + static_cast<long long>(__ldg(fidx + c)) * L * W;

  // forward: R^T z = b, right-looking as in banded_sample_kernel
  float acc[H];
#pragma unroll
  for (int k = 0; k < H; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const float* row = Rc + static_cast<long long>(l) * W;
    const long long at = static_cast<long long>(l) * n + c;
    const float z = (b[at] - (P > 0 ? acc[0] : 0.f)) / __ldg(row);
#pragma unroll
    for (int k = 0; k < P; ++k)
      acc[k] = (k + 1 < P ? acc[k + 1] : 0.f) + __ldg(row + k + 1) * z;
    out[at] = z;
  }

  // backward: R x = z from the last row up, hist[m] = x[l+1+m]
  float hist[H];
#pragma unroll
  for (int m = 0; m < H; ++m) hist[m] = 0.f;
#pragma unroll 4
  for (int l = L - 1; l >= 0; --l) {
    const float* row = Rc + static_cast<long long>(l) * W;
    const long long at = static_cast<long long>(l) * n + c;
    float s = out[at];
#pragma unroll
    for (int m = 1; m <= P; ++m) s -= __ldg(row + m) * hist[m - 1];
    const float x = s / __ldg(row);
#pragma unroll
    for (int m = P - 1; m > 0; --m) hist[m] = hist[m - 1];
    if (P > 0) hist[0] = x;
    out[at] = x;
  }
}

template <int P>
int launch_cholesky(const float* bands, float* out, int n_sys, int L,
                    float jitter, cudaStream_t st) {
  const int blocks = (n_sys + kWarp - 1) / kWarp;
  banded_cholesky_kernel<P><<<blocks, kWarp, 0, st>>>(bands, out, n_sys, L,
                                                      jitter);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_sample(const float* R, const float* b, const float* noise,
                  float* out, int n_sys, int L, cudaStream_t st) {
  const int blocks = (n_sys + kWarp - 1) / kWarp;
  banded_sample_kernel<P><<<blocks, kWarp, 0, st>>>(R, b, noise, out, n_sys,
                                                    L);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_solve(const float* R, const int* fidx, const float* b, float* out,
                 int n, int L, cudaStream_t st) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  banded_solve_kernel<P><<<blocks, kThreads, 0, st>>>(R, fidx, b, out, n, L);
  return static_cast<int>(cudaGetLastError());
}

#define BANDED_DISPATCH(FN, ...)            \
  switch (p) {                              \
    case 0: return FN<0>(__VA_ARGS__);      \
    case 1: return FN<1>(__VA_ARGS__);      \
    case 2: return FN<2>(__VA_ARGS__);      \
    case 3: return FN<3>(__VA_ARGS__);      \
    case 4: return FN<4>(__VA_ARGS__);      \
    case 5: return FN<5>(__VA_ARGS__);      \
    case 6: return FN<6>(__VA_ARGS__);      \
    case 7: return FN<7>(__VA_ARGS__);      \
    case 8: return FN<8>(__VA_ARGS__);      \
    case 9: return FN<9>(__VA_ARGS__);      \
    case 10: return FN<10>(__VA_ARGS__);    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace deconv3d_banded

extern "C" {

// Upper banded Cholesky of `n_sys` systems of `L` rows and bandwidth `p`
// (rows of p + 1 floats) on `stream`.  Returns a cudaError_t (0 on
// success), checked right after the launch.
int banded_cholesky_launch(const float* bands, float* out, int n_sys, int L,
                           int p, float jitter, void* stream) {
  using namespace deconv3d_banded;
  if (n_sys < 1 || L < 1 || p < 0 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BANDED_DISPATCH(launch_cholesky, bands, out, n_sys, L, jitter, st)
}

// x ~ N(A^-1 b, A^-1) for A = R^T R of `n_sys` systems: `out` [n_sys, L]
// from R [n_sys, L, p + 1], b and noise [n_sys, L], on `stream`.
int banded_sample_launch(const float* R, const float* b, const float* noise,
                         float* out, int n_sys, int L, int p, void* stream) {
  using namespace deconv3d_banded;
  if (n_sys < 1 || L < 1 || p < 0 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BANDED_DISPATCH(launch_sample, R, b, noise, out, n_sys, L, st)
}

// x = R^-1 R^-T b for `n` lambda-major columns b [L, n] -> out [L, n]
// (may be b itself), column c against the factor R[fidx[c]] of R
// [n_factors, L, p + 1], on `stream`.
int banded_solve_launch(const float* R, const int* fidx, const float* b,
                        float* out, int n, int L, int p, void* stream) {
  using namespace deconv3d_banded;
  if (n < 1 || L < 1 || p < 0 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BANDED_DISPATCH(launch_solve, R, fidx, b, out, n, L, st)
}

}  // extern "C"

// Pieces shared by the sweep kernels (mh_sweep.cu, gibbs_sweep.cu,
// tiled_sweep.cu): the step geometry, the patch contraction and commit of
// one (chain, spaxel, 32-wavelength chunk) task, and the cooperative launch.
//
// Layout (lambda-contiguous; the wrapper transposes at the segment
// boundary): residual [C, Hp, Wp, L], weights [Hp, Wp, L], clean
// [C, Yc, Xc, L], quad/qvox [Yc, Xc, L].  A task's block holds 32 x nw
// threads: lanes on wavelengths (one 128-byte load per warp), warps on
// patch rows dy = warp, warp + nw, ...
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace deconv3d {

constexpr int kMaxRank = 8;
constexpr int kChunk = 32;          // wavelengths per task (one per lane)
// a block holds min(f, 18) warps (one per patch row; MUSE's f = 17), so a
// thread may use up to 113 registers; a larger f loops the warps over rows
constexpr int kMaxWarps = 18;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr float kPi = 3.14159265358979323846f;

// One step of a sweep: the spaxels of color (cy, cx) in block rows
// [by0, by0 + nyt) and block columns [bx0, bx0 + nxt) -- the whole field
// for the whole-cube kernels, one tile for the tiled one.  Local spaxel i
// of the step is global spaxel row ij(i); every per-spaxel array, output
// and random number is indexed by the global row, so a spaxel's visit
// computes the same bits under any tiling.
struct Step {
  int c, cy, cx, by0, bx0, nyt, nxt;
  __device__ Step(int c_, int f, int by0_, int bx0_, int nyt_, int nxt_)
      : c(c_), cy(c_ / f), cx(c_ % f), by0(by0_), bx0(bx0_), nyt(nyt_),
        nxt(nxt_) {}
  __device__ int spaxels() const { return nyt * nxt; }
  __device__ int ij(int i, int nx) const {
    return (by0 + i / nxt) * nx + bx0 + i % nxt;
  }
};

// Geometry checks shared by every launch (0 = fine).
inline int check_dims(int C, int L, int f, int ny, int nx, int S, int lw,
                      int nyt, int nxt) {
  if (C < 1 || S < 1 || S > kMaxRank || L < 1 || f < 1 || ny < 1 || nx < 1 ||
      lw < 1 || lw % 2 == 0 || ny * nx >= (1 << 24) || nyt < 1 || nxt < 1 ||
      ny % nyt != 0 || nx % nxt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Copy the S FSF images [S, f, f] into shared memory (whole block).
__device__ __forceinline__ void load_images(float* img_s, const float* imgs,
                                            int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) img_s[k] = imgs[k];
  __syncthreads();
}

// The per-element arithmetic of a sweep, every rounding explicit (the
// compiler contracts nothing), shared by every kernel: the classic, tiled
// and resident kernels compute the same bits wherever they sum in the same
// order.
__device__ __forceinline__ float pool_term(float acc, float img, float rw) {
  return __fmaf_rn(img, rw, acc);               // rw = resid * w
}
__device__ __forceinline__ float lin_term(float lin, float spec, float p) {
  return __fmaf_rn(spec, p, lin);               // p = sum of the partials
}
__device__ __forceinline__ float band_term(float acc, float m, float x) {
  return __fmaf_rn(m, x, acc);                  // one LSF band product
}
// resid -= sum_s gs[s] * img_s at patch pixel `px` (gs[s] = spec[s, l] * g)
__device__ __forceinline__ float commit_term(float resid, const float* gs,
                                             const float* img_s, int px,
                                             int ff, int S) {
  float delta = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxRank; ++s)
    if (s < S) delta = __fmaf_rn(gs[s], img_s[s * ff + px], delta);
  return __fsub_rn(resid, delta);
}

// This warp's share of the patch contraction at wavelength l:
//   pool_s[(warp * S + s) * kChunk + lane] =
//     sum_{dy = warp, warp+nw, ...} sum_dx img_s[s, dy, dx] * (resid * w)[dy, dx]
// where `row0` is the offset of patch pixel (0, 0) at wavelength l in the
// chain's residual and in the weights.  The caller syncs the block before
// reading the partials.
__device__ __forceinline__ void patch_partials(const float* resid,
                                               const float* w,
                                               const float* img_s,
                                               float* pool_s, size_t row0,
                                               bool on, int Wp, int L, int f,
                                               int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float pooled[kMaxRank];
#pragma unroll
  for (int s = 0; s < kMaxRank; ++s) pooled[s] = 0.0f;
  if (on) {
    for (int dy = warp; dy < f; dy += nw) {
      const size_t row = row0 + static_cast<size_t>(dy) * Wp * L;
#pragma unroll 8
      for (int dx = 0; dx < f; ++dx) {
        const size_t off = row + static_cast<size_t>(dx) * L;
        const float rw = __fmul_rn(resid[off], w[off]);
#pragma unroll
        for (int s = 0; s < kMaxRank; ++s)
          if (s < S) pooled[s] = pool_term(pooled[s], img_s[(s * f + dy) * f + dx], rw);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxRank; ++s)
    if (s < S) pool_s[(warp * S + s) * kChunk + lane] = pooled[s];
}

// lin at wavelength l (lane's) from the per-warp partials, summed over the
// warps in a fixed order: lin = sum_s spec[s, l] * sum_r pool_s[r, s].
__device__ __forceinline__ float partials_to_lin(const float* pool_s,
                                                 const float* spec, int l,
                                                 int L, int S) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float lin = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxRank; ++s) {
    if (s < S) {
      float p = 0.0f;
      for (int r = 0; r < nw; ++r)
        p = __fadd_rn(p, pool_s[(r * S + s) * kChunk + lane]);
      lin = lin_term(lin, spec[s * L + l], p);
    }
  }
  return lin;
}

// resid -= sum_s (spec[s, l] * g) * img_s over this warp's patch rows at
// wavelength l (row0 as in patch_partials).
__device__ __forceinline__ void patch_commit(float* resid, const float* img_s,
                                             const float* spec, float g,
                                             size_t row0, int l, int Wp,
                                             int L, int f, int S) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float gs[kMaxRank];
#pragma unroll
  for (int s = 0; s < kMaxRank; ++s)
    gs[s] = s < S ? __fmul_rn(spec[s * L + l], g) : 0.0f;
  for (int dy = warp; dy < f; dy += nw) {
    const size_t row = row0 + static_cast<size_t>(dy) * Wp * L;
#pragma unroll 8
    for (int dx = 0; dx < f; ++dx) {
      float* r = resid + row + static_cast<size_t>(dx) * L;
      *r = commit_term(*r, gs, img_s, dy * f + dx, f * f, S);
    }
  }
}

// Launch `kernel(args)` cooperatively with `threads` threads and `smem`
// bytes of dynamic shared memory, on as many blocks as fit the card at
// once (at most `tasks`); the kernel walks its tasks grid-stride.
template <typename Kernel, typename Args>
inline int launch_cooperative(Kernel kernel, Args* args, int threads,
                              size_t smem, long long tasks,
                              cudaStream_t stream) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  long long grid = static_cast<long long>(per_sm) * sms;
  if (grid > tasks) grid = tasks;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* params[] = {args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(static_cast<unsigned>(grid)),
                                  dim3(threads), params, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace deconv3d

// One Metropolis-Hastings sweep of the color-decomposed sampler on Hopper.
//
// Replaces the TPU kernel deconv3d_tpu/ops/pallas_sweep.py::_make_kernel
// (mode="mh", chain batch C=1), launched there by _kernel_segment.  It
// computes what that kernel computes for every color (cy, cx) of one sweep:
//
//   lin[l]  = sum_s spec[s,l] * sum_ab img_s[a,b] * (resid*w)[y+a, x+b, l]
//   jump[l] = exp(log_scale) * clip(tan(pi*(u_l - 1/2)), +-1e3) * valid
//   g       = band-LSF(jump)
//   dchi2   = sum_l g^2 * quad - 2 g * lin
//   accept  = log(u_acc) < -dchi2/2  and valid
//   on accept: resid -= sum_s (spec_s * g) (x) img_s,  clean += jump
//   log_scale += adapt * (accept - target) * valid     (Robbins-Monro)
//
// Design.  Same-color FSF patches are disjoint (stride == footprint), so
// the spaxels of one color are independent, and within a spaxel every
// wavelength of the patch contraction and of the commit is independent.
// The work of one color is cut into TASKS of (spaxel, 32-wavelength chunk):
// a thread block of 32 x min(f, 32) threads takes a task, lanes on
// wavelengths and warps on patch rows.  Colors depend on each other, so the
// sweep is ONE cooperative launch; per color:
//
//   phase 1  every task: lin over its chunk (f x f x 32 patch), the jump
//            spectrum with the LSF halo, g, and its share of dchi2
//   --- grid barrier ---
//   phase 2  every task: dchi2 of its spaxel summed over the chunks in a
//            fixed order, the accept decision (identical in all chunks),
//            and on accept the commit of its chunk
//   --- grid barrier ---
//
// The state is lambda-contiguous inside a segment ([Hp, Wp, L] residual and
// weights, [Yc, Xc, L] clean and quad; the wrapper transposes at the
// segment boundary), so each warp load is 32 consecutive wavelengths of one
// pixel (128 bytes).  Random numbers come from the in-kernel Philox
// (philox.cuh), or from an injected uniform tensor for parity tests.
//
// What bounds it.  Each color reads the whole f x f x L patch of residual
// and weights of each of its spaxels (2 x 4 x f^2 x L bytes: 1.4 MB per
// spaxel at f=17, L=600) and writes the residual patch back on accept;
// summed over a sweep, every residual voxel is read f^2 times.  On a 30x30
// MUSE subcube that is 1.6 GB per sweep out of L2 (the 12 MB state fits
// it) spread over only 4 spaxels x 19 chunks = 76 blocks, and 578 grid
// barriers per sweep: the sweep is bound by L2 latency and barriers, not
// by bandwidth.  On the full MUSE range (L=3681) the state leaves L2 and
// the f^2 re-reads go to HBM.
//
// Per-(color, spaxel) outputs: the accept flag and the proposed dchi2; the
// wrapper sums accepted dchi2 in a fixed order and applies the Kahan chi2
// update per sweep, as _assemble does in the JAX package.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

constexpr int kMaxRank = 8;
constexpr int kChunk = 32;          // wavelengths per task (one per lane)
constexpr int kMaxWarps = 32;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kCauchyClip = 1.0e3f;

struct SweepArgs {
  float* resid;            // [Hp, Wp, L]
  const float* w;          // [Hp, Wp, L]
  const float* quad;       // [Yc, Xc, L]
  float* clean;            // [Yc, Xc, L]
  float* log_scale;        // [Yc, Xc]
  const float* valid;      // [Yc, Xc] 1.0 / 0.0
  const float* spec;       // [S, L]
  const float* imgs;       // [S, f, f]
  const float* lsf;        // [L, lw]
  const float* uniforms;   // [f*f, nij, L+1] or null (Philox)
  float* accept_out;       // [f*f, nij]
  float* dchi_out;         // [f*f, nij]
  float* uniforms_out;     // [f*f, nij, L+1] or null
  float* scratch;          // [tasks * (2 * kChunk + 1)]
  int L, f, ny, nx, S, lw;
  uint32_t k0, k1, sweep;
  float adapt, target;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

__global__ void __launch_bounds__(1024) mh_sweep_kernel(SweepArgs a) {
  extern __shared__ float smem[];
  const int L = a.L, f = a.f, S = a.S, lw = a.lw, half = lw / 2;
  const int nij = a.ny * a.nx;
  const int Xc = a.nx * f;
  const int Wp = f - 1 + Xc;
  const int P = (L + kChunk - 1) / kChunk;       // chunks per spaxel
  const int tasks = nij * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  float* img_s = smem;                            // [S * f * f]
  float* pool_s = img_s + S * f * f;              // [nw * S * kChunk]
  float* jump_s = pool_s + nw * S * kChunk;       // [kChunk + 2 * half]
  float* g_buf = a.scratch;                       // [tasks * kChunk]
  float* jump_buf = g_buf + static_cast<size_t>(tasks) * kChunk;
  float* part_buf = jump_buf + static_cast<size_t>(tasks) * kChunk;  // [tasks]
  for (int k = threadIdx.x; k < S * f * f; k += nt) img_s[k] = a.imgs[k];
  __syncthreads();
  cg::grid_group grid = cg::this_grid();

  for (int c = 0; c < f * f; ++c) {
    const int cy = c / f, cx = c % f;
    // ---------------- phase 1: lin, jumps, g, partial dchi2 -------------
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int ij = t / P, l0 = (t % P) * kChunk;
      const int ys = (ij / a.nx) * f + cy;     // spaxel row == patch top row
      const int xs = (ij % a.nx) * f + cx;
      const int sp = ys * Xc + xs;
      const int l = l0 + lane;
      const bool on = l < L;
      const float v = a.valid[sp];
      const size_t ubase = (static_cast<size_t>(c) * nij + ij) * (L + 1);

      float pooled[kMaxRank];
#pragma unroll
      for (int s = 0; s < kMaxRank; ++s) pooled[s] = 0.0f;
      if (on) {
        for (int dy = warp; dy < f; dy += nw) {
          const size_t row = (static_cast<size_t>(ys + dy) * Wp + xs) * L + l;
#pragma unroll 8
          for (int dx = 0; dx < f; ++dx) {
            const size_t off = row + static_cast<size_t>(dx) * L;
            const float rw = a.resid[off] * a.w[off];
#pragma unroll
            for (int s = 0; s < kMaxRank; ++s)
              if (s < S) pooled[s] += img_s[(s * f + dy) * f + dx] * rw;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kMaxRank; ++s)
        if (s < S) pool_s[(warp * S + s) * kChunk + lane] = pooled[s];

      // jump spectrum over the chunk plus the LSF halo
      const float scale = expf(a.log_scale[sp]);
      for (int k = threadIdx.x; k < kChunk + 2 * half; k += nt) {
        const int m = l0 - half + k;
        float jump = 0.0f;
        if (m >= 0 && m < L) {
          const float u = a.uniforms
                              ? a.uniforms[ubase + m]
                              : jump_uniform(a.k0, a.k1, a.sweep, c, ij, m);
          if (a.uniforms_out && k >= half && k < half + kChunk)
            a.uniforms_out[ubase + m] = u;
          const float tn = fminf(fmaxf(tanf(kPi * (u - 0.5f)), -kCauchyClip),
                                 kCauchyClip);
          jump = scale * tn * v;
        }
        jump_s[k] = jump;
      }
      __syncthreads();
      if (warp == 0) {
        float part = 0.0f, g = 0.0f;
        if (on) {
          float lin = 0.0f;
#pragma unroll
          for (int s = 0; s < kMaxRank; ++s) {
            if (s < S) {
              float p = 0.0f;
              for (int r = 0; r < nw; ++r) p += pool_s[(r * S + s) * kChunk + lane];
              lin += a.spec[s * L + l] * p;
            }
          }
          for (int d = 0; d < lw; ++d) g += a.lsf[l * lw + d] * jump_s[lane + d];
          const float q = a.quad[static_cast<size_t>(sp) * L + l];
          part = g * g * q - 2.0f * g * lin;
        }
        part = warp_sum(part);
        g_buf[static_cast<size_t>(t) * kChunk + lane] = g;
        jump_buf[static_cast<size_t>(t) * kChunk + lane] = jump_s[lane + half];
        if (lane == 0) part_buf[t] = part;
      }
      __syncthreads();   // shared buffers are reused by the next task
    }
    grid.sync();
    // ---------------- phase 2: accept, commit ---------------------------
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int ij = t / P, chunk = t % P, l0 = chunk * kChunk;
      const int ys = (ij / a.nx) * f + cy;
      const int xs = (ij % a.nx) * f + cx;
      const int sp = ys * Xc + xs;
      const int l = l0 + lane;
      const float v = a.valid[sp];
      // dchi2 of the spaxel: every warp sums the P chunk partials in the
      // same fixed order, so every thread holds the same value
      float dchi = 0.0f;
      for (int q = lane; q < P; q += 32) dchi += part_buf[ij * P + q];
      dchi = warp_sum(dchi);
      const float u2 = a.uniforms ? a.uniforms[(static_cast<size_t>(c) * nij + ij) * (L + 1) + L]
                                  : accept_uniform(a.k0, a.k1, a.sweep, c, ij);
      const bool acc = (logf(u2) < -0.5f * dchi) && (v > 0.0f);
      if (acc && l < L) {
        const float g = g_buf[static_cast<size_t>(t) * kChunk + lane];
        float gs[kMaxRank];
#pragma unroll
        for (int s = 0; s < kMaxRank; ++s)
          gs[s] = s < S ? a.spec[s * L + l] * g : 0.0f;
        for (int dy = warp; dy < f; dy += nw) {
          const size_t row = (static_cast<size_t>(ys + dy) * Wp + xs) * L + l;
#pragma unroll 8
          for (int dx = 0; dx < f; ++dx) {
            float delta = 0.0f;
#pragma unroll
            for (int s = 0; s < kMaxRank; ++s)
              if (s < S) delta += gs[s] * img_s[(s * f + dy) * f + dx];
            a.resid[row + static_cast<size_t>(dx) * L] -= delta;
          }
        }
        if (warp == 0)
          a.clean[static_cast<size_t>(sp) * L + l] +=
              jump_buf[static_cast<size_t>(t) * kChunk + lane];
      }
      if (chunk == 0 && threadIdx.x == 0) {
        const size_t ubase = (static_cast<size_t>(c) * nij + ij) * (L + 1);
        if (a.uniforms_out) a.uniforms_out[ubase + L] = u2;
        const float accf = acc ? 1.0f : 0.0f;
        a.accept_out[c * nij + ij] = accf;
        a.dchi_out[c * nij + ij] = dchi;
        a.log_scale[sp] += a.adapt * (accf - a.target) * v;
      }
    }
    grid.sync();         // color c is committed before color c+1 reads
  }
}

}  // namespace deconv3d

extern "C" {

// Floats of scratch one sweep needs (per-task g, jumps and dchi2 shares).
long long mh_sweep_scratch_floats(int L, int ny, int nx) {
  const long long tasks =
      static_cast<long long>(ny) * nx * ((L + deconv3d::kChunk - 1) / deconv3d::kChunk);
  return tasks * (2 * deconv3d::kChunk + 1);
}

// Launch one sweep on `stream`.  Returns a cudaError_t (0 on success),
// checked right after the launch; the kernel itself runs asynchronously.
int mh_sweep_launch(float* resid, const float* w, const float* quad,
                    float* clean, float* log_scale, const float* valid,
                    const float* spec, const float* imgs, const float* lsf,
                    const float* uniforms, float* accept_out, float* dchi_out,
                    float* uniforms_out, float* scratch, int L, int f, int ny,
                    int nx, int S, int lw, unsigned k0, unsigned k1,
                    unsigned sweep, float adapt, float target, void* stream) {
  using deconv3d::SweepArgs;
  if (S < 1 || S > deconv3d::kMaxRank || L < 1 || f < 1 || ny < 1 || nx < 1 ||
      lw < 1 || lw % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepArgs a{resid, w, quad, clean, log_scale, valid, spec, imgs, lsf,
              uniforms, accept_out, dchi_out, uniforms_out, scratch, L, f, ny,
              nx, S, lw, k0, k1, sweep, adapt, target};
  const int nw = f < deconv3d::kMaxWarps ? f : deconv3d::kMaxWarps;
  const int threads = 32 * nw;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(S) * f * f +
                       static_cast<size_t>(nw) * S * deconv3d::kChunk +
                       deconv3d::kChunk + 2 * (lw / 2));
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(deconv3d::mh_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, deconv3d::mh_sweep_kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  const long long tasks = static_cast<long long>(ny) * nx *
                          ((L + deconv3d::kChunk - 1) / deconv3d::kChunk);
  long long grid = static_cast<long long>(per_sm) * sms;
  if (grid > tasks) grid = tasks;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(deconv3d::mh_sweep_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(threads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

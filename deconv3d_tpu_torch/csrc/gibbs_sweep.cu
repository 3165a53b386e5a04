// One exact-Gibbs sweep of the color-decomposed sampler on Hopper, for a
// batch of C independent chains.
//
// Replaces the TPU kernel deconv3d_tpu/ops/pallas_sweep.py::_make_kernel,
// mode="gibbs" (the phase loop at :243-284 and the commit at :286-314),
// launched there by _kernel_segment.  For every chain and every color
// (cy, cx) of one sweep it draws each voxel of the color's spaxels from its
// exact Gaussian conditional, the wavelengths of a spaxel in lw phases
// (voxels lambda = phase mod lw; their LSF footprints are disjoint):
//
//   lin[l]   = sum_s spec[s,l] * sum_ab img_s[a,b] * (resid*w)[y+a, x+b, l]
//   normal   = sqrt(-2 log u1) * cos(2 pi u2)              (per voxel)
//   for each phase ph = 0 .. lw-1:
//     linT[l] = sum_mu M[mu,l] lin[mu]                       (transpose band)
//     jump[l] = live ? linT/qvox + normal * rsqrt(qvox) : 0,
//               live = valid and qvox > 0 and l = ph (mod lw)
//     g       = band-LSF(jump)
//     lin    -= g * quad          (exact: same-color patches are disjoint)
//     clean  += jump,  gacc += g
//   dchi2 = sum_mu gacc^2 quad - 2 gacc lin0 + sum_mu gacc^2 quad_lo
//   resid -= sum_s (spec_s * gacc) (x) img_s
//
// dchi2 of the summed jump against the color's first lin (lin0) equals the
// phases' sum.  quad_lo = float64 quad - quad is the float32 rounding's
// remainder: the rounding is the same at every spaxel of uniform weight,
// so without it the running chi2 drifts linearly; its term sits below the
// ulp of gacc^2 quad and is summed on its own.
//
// Design: one cooperative launch per sweep for all chains, three grid
// barriers per color.
//
//   (a) lin   every (chain, spaxel, 32-wavelength chunk) task: the patch
//             contraction of mh_sweep.cu (sweep_common.cuh), lin to scratch
//   --- grid barrier ---
//   (b) draws every (chain, spaxel) task: one block runs the lw phases over
//             the whole spectrum in shared memory (lin, quad, the normals
//             that each phase overwrites with its jumps, and gacc: 4 L
//             floats, 59 KB at L=3681), linT and g reaching +-lw/2 around
//             each live voxel; it adds the jumps into clean and writes
//             gacc, the color's dchi2 and the live count
//   --- grid barrier ---
//   (c) commit every (chain, spaxel, chunk) task: resid -= patch(gacc)
//   --- grid barrier ---
//
// What bounds it.  (a) and (c) read and write every residual voxel f^2
// times per sweep, as the MH kernel does (1.6 GB per sweep out of L2 on the
// 30x30x600 MUSE subcube with one chain); (b) is a serial chain of 2 lw
// block barriers per color on only C x nij blocks (4 per chain on that
// subcube), each step a few wavelengths per thread.  A batch of chains
// runs its (b) blocks side by side and pays the 3 f^2 grid barriers once.
//
// Random numbers: Philox streams 2 and 3 (philox.cuh) under each chain's
// key, or an injected [C, f*f, nij, 2, L] tensor of (u1, u2) for parity
// tests.  Per-(chain, color, spaxel) outputs: the number of voxels drawn
// and the committed dchi2; the wrapper sums dchi2 in a fixed order into
// each chain's Kahan chi2 update per sweep, as _assemble does in the JAX
// package (acceptance 1: accepts == proposals == voxels drawn).

#include "philox.cuh"
#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

struct GibbsArgs {
  float* resid;            // [C, Hp, Wp, L]
  const float* w;          // [Hp, Wp, L]
  const float* quad;       // [Yc, Xc, L]
  const float* quad_lo;    // [Yc, Xc, L] or null (zero)
  const float* qvox;       // [Yc, Xc, L]
  float* clean;            // [C, Yc, Xc, L]
  const float* valid;      // [Yc, Xc] 1.0 / 0.0
  const float* spec;       // [S, L]
  const float* imgs;       // [S, f, f]
  const float* lsf;        // [L, lw]
  const uint32_t* keys;    // [C, 2] Philox key words
  const float* uniforms;   // [C, f*f, nij, 2, L] or null (Philox)
  float* live_out;         // [C, f*f, nij]
  float* dchi_out;         // [C, f*f, nij]
  float* uniforms_out;     // [C, f*f, nij, 2, L] or null
  float* scratch;          // [2 * C * nij * L]: lin, gacc
  int C, L, f, ny, nx, S, lw;
  uint32_t sweep;
};

__global__ void __launch_bounds__(kMaxThreads)
    gibbs_sweep_kernel(GibbsArgs a) {
  extern __shared__ float smem[];
  const int L = a.L, f = a.f, S = a.S, lw = a.lw, half = lw / 2;
  const int nij = a.ny * a.nx, n_colors = f * f;
  const int Yc = a.ny * f, Xc = a.nx * f;
  const int Hp = f - 1 + Yc, Wp = f - 1 + Xc;
  const int P = (L + kChunk - 1) / kChunk;       // chunks per spaxel
  const int spaxels = a.C * nij;                 // (chain, spaxel) tasks
  const int tasks = spaxels * P;                 // (chain, spaxel, chunk)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  float* img_s = smem;                            // [S * f * f]
  float* pool_s = img_s + S * f * f;              // [nw * S * kChunk]
  float* lin_s = pool_s + nw * S * kChunk;        // [L]
  float* quad_s = lin_s + L;                      // [L]
  float* nj_s = quad_s + L;                       // [L] normals, then jumps
  float* gacc_s = nj_s + L;                       // [L]
  float* red_s = gacc_s + L;                      // [3 * nw]
  uint32_t* key_s = reinterpret_cast<uint32_t*>(red_s + 3 * nw);  // [2 * C]
  float* lin_buf = a.scratch;                     // [C * nij * L]
  float* g_buf = lin_buf + static_cast<size_t>(spaxels) * L;
  for (int k = threadIdx.x; k < 2 * a.C; k += nt) key_s[k] = a.keys[k];
  load_images(img_s, a.imgs, S * f * f);
  cg::grid_group grid = cg::this_grid();

  for (int c = 0; c < n_colors; ++c) {
    const int cy = c / f, cx = c % f;
    // ---------------- (a) lin of every (chain, spaxel, chunk) -----------
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int cs = t / P, l0 = (t % P) * kChunk;
      const int ch = cs / nij, ij = cs % nij;
      const int ys = (ij / a.nx) * f + cy, xs = (ij % a.nx) * f + cx;
      const int sp = ys * Xc + xs;
      if (a.valid[sp] == 0.0f) continue;        // uniform across the block
      const int l = l0 + lane;
      const size_t row0 = (static_cast<size_t>(ys) * Wp + xs) * L + l;
      patch_partials(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, a.w,
                     img_s, pool_s, row0, l < L, Wp, L, f, S);
      __syncthreads();
      if (warp == 0 && l < L)
        lin_buf[static_cast<size_t>(cs) * L + l] =
            partials_to_lin(pool_s, a.spec, l, L, S);
      __syncthreads();   // pool_s is reused by the next task
    }
    grid.sync();
    // ---------------- (b) the lw phases of every (chain, spaxel) --------
    for (int cs = blockIdx.x; cs < spaxels; cs += gridDim.x) {
      const int ch = cs / nij, ij = cs % nij;
      const int ys = (ij / a.nx) * f + cy, xs = (ij % a.nx) * f + cx;
      const int sp = ys * Xc + xs;
      const size_t out = static_cast<size_t>(ch * n_colors + c) * nij + ij;
      const float* qv = a.qvox + static_cast<size_t>(sp) * L;
      const uint32_t k0 = key_s[2 * ch], k1 = key_s[2 * ch + 1];
      for (int l = threadIdx.x; l < L; l += nt) {
        lin_s[l] = lin_buf[static_cast<size_t>(cs) * L + l];
        quad_s[l] = a.quad[static_cast<size_t>(sp) * L + l];
        gacc_s[l] = 0.0f;
        float u1, u2;
        if (a.uniforms) {
          u1 = a.uniforms[out * 2 * L + l];
          u2 = a.uniforms[out * 2 * L + L + l];
        } else {
          u1 = lambda_uniform(k0, k1, a.sweep, c, ij, l, kStreamNormalU1);
          u2 = lambda_uniform(k0, k1, a.sweep, c, ij, l, kStreamNormalU2);
        }
        if (a.uniforms_out) {
          a.uniforms_out[out * 2 * L + l] = u1;
          a.uniforms_out[out * 2 * L + L + l] = u2;
        }
        nj_s[l] = sqrtf(-2.0f * logf(u1)) * cosf(2.0f * kPi * u2);
      }
      __syncthreads();
      if (a.valid[sp] == 0.0f) {                // frozen spaxel: no draws
        if (threadIdx.x == 0) a.live_out[out] = a.dchi_out[out] = 0.0f;
        continue;                               // (its lin was never made)
      }
      float live = 0.0f;
      for (int ph = 0; ph < lw; ++ph) {
        // draws of this phase: at most one live voxel in any lw-window
        for (int l = ph + threadIdx.x * lw; l < L; l += nt * lw) {
          const float q = qv[l];
          float jump = 0.0f;
          if (q > 0.0f) {
            float linT = 0.0f;
            for (int d = 0; d < lw; ++d) {
              const int mu = l + half - d;
              if (mu >= 0 && mu < L) linT += a.lsf[mu * lw + d] * lin_s[mu];
            }
            const float qs = fmaxf(q, 1.0e-30f);
            jump = linT / qs + nj_s[l] * rsqrtf(qs);
            live += 1.0f;
          }
          nj_s[l] = jump;
        }
        __syncthreads();
        // g of the phase's jumps, and lin <- lin - g * quad
        for (int mu = threadIdx.x; mu < L; mu += nt) {
          const int lo = mu - half;
          int r = (ph - lo) % lw;
          if (r < 0) r += lw;
          const int l = lo + r;                 // the phase voxel near mu
          if (l >= 0 && l < L) {
            const float g = a.lsf[mu * lw + (l - lo)] * nj_s[l];
            lin_s[mu] -= g * quad_s[mu];
            gacc_s[mu] += g;
          }
        }
        __syncthreads();
      }
      // dchi2 of the summed jump against lin0 (still in lin_buf)
      float dchi = 0.0f, dlo = 0.0f;
      const float* lin0 = lin_buf + static_cast<size_t>(cs) * L;
      const float* qlo =
          a.quad_lo ? a.quad_lo + static_cast<size_t>(sp) * L : nullptr;
      float* clean = a.clean + (static_cast<size_t>(ch) * Yc * Xc + sp) * L;
      for (int l = threadIdx.x; l < L; l += nt) {
        const float ga = gacc_s[l];
        dchi += ga * ga * quad_s[l] - 2.0f * ga * lin0[l];
        if (qlo) dlo += ga * ga * qlo[l];
        clean[l] += nj_s[l];
        g_buf[static_cast<size_t>(cs) * L + l] = ga;
      }
      // block sums in a fixed order: lanes, then warps
      dchi = warp_sum(dchi);
      live = warp_sum(live);
      dlo = warp_sum(dlo);
      if (lane == 0) {
        red_s[warp] = dchi;
        red_s[nw + warp] = live;
        red_s[2 * nw + warp] = dlo;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float sd = 0.0f, sl = 0.0f, so = 0.0f;
        for (int r = 0; r < nw; ++r) {
          sd += red_s[r];
          sl += red_s[nw + r];
          so += red_s[2 * nw + r];
        }
        a.dchi_out[out] = sd + so;
        a.live_out[out] = sl;
      }
      __syncthreads();   // shared buffers are reused by the next task
    }
    grid.sync();
    // ---------------- (c) commit of every (chain, spaxel, chunk) --------
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int cs = t / P, l0 = (t % P) * kChunk;
      const int ch = cs / nij, ij = cs % nij;
      const int ys = (ij / a.nx) * f + cy, xs = (ij % a.nx) * f + cx;
      const int sp = ys * Xc + xs;
      const int l = l0 + lane;
      if (a.valid[sp] == 0.0f || l >= L) continue;
      const size_t row0 = (static_cast<size_t>(ys) * Wp + xs) * L + l;
      patch_commit(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, img_s,
                   a.spec, g_buf[static_cast<size_t>(cs) * L + l], row0, l,
                   Wp, L, f, S);
    }
    grid.sync();         // color c is committed before color c+1 reads
  }
}

}  // namespace deconv3d

extern "C" {

// Floats of scratch one sweep of C chains needs (lin and gacc spectra).
long long gibbs_sweep_scratch_floats(int C, int L, int ny, int nx) {
  return 2LL * C * ny * nx * L;
}

// Launch one sweep of C chains on `stream`.  Returns a cudaError_t (0 on
// success), checked right after the launch; the kernel itself runs
// asynchronously.
int gibbs_sweep_launch(float* resid, const float* w, const float* quad,
                       const float* quad_lo, const float* qvox, float* clean,
                       const float* valid,
                       const float* spec, const float* imgs, const float* lsf,
                       const unsigned* keys, const float* uniforms,
                       float* live_out, float* dchi_out, float* uniforms_out,
                       float* scratch, int C, int L, int f, int ny, int nx,
                       int S, int lw, unsigned sweep, void* stream) {
  using namespace deconv3d;
  if (C < 1 || S < 1 || S > kMaxRank || L < 1 || f < 1 || ny < 1 || nx < 1 ||
      lw < 1 || lw % 2 == 0 || ny * nx >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  GibbsArgs a{resid, w, quad, quad_lo, qvox, clean, valid, spec, imgs, lsf, keys,
              uniforms, live_out, dchi_out, uniforms_out, scratch, C, L, f,
              ny, nx, S, lw, sweep};
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(S) * f * f +
                       static_cast<size_t>(nw) * S * kChunk +
                       4 * static_cast<size_t>(L) + 3 * nw +
                       2 * static_cast<size_t>(C));
  const long long tasks =
      static_cast<long long>(C) * ny * nx * ((L + kChunk - 1) / kChunk);
  return launch_cooperative(gibbs_sweep_kernel, &a, 32 * nw, smem, tasks,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

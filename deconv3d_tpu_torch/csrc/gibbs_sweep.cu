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
// Design: one cooperative launch per sweep for all chains, one step per
// color: the three phases and three grid barriers of gibbs_step.cuh
// (shared with the tiled kernel, tiled_sweep.cu) over every spaxel of the
// color.
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

#include "gibbs_step.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

__global__ void __launch_bounds__(kMaxThreads)
    gibbs_sweep_kernel(GibbsArgs a) {
  extern __shared__ float smem[];
  const GibbsShared sh = gibbs_shared(a, smem);
  cg::grid_group grid = cg::this_grid();
  for (int c = 0; c < a.f * a.f; ++c)
    gibbs_step(a, sh, Step(c, a.f, 0, 0, a.ny, a.nx), grid);
}

}  // namespace deconv3d

extern "C" {

// Floats of scratch one step over ny x nx spaxels of C chains needs (lin
// and gacc spectra).
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
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, ny, nx)) return e;
  GibbsArgs a{resid, w, quad, quad_lo, qvox, clean, valid, spec, imgs, lsf, keys,
              uniforms, live_out, dchi_out, uniforms_out, scratch, C, L, f,
              ny, nx, S, lw, ny, nx, sweep};
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  const long long tasks =
      static_cast<long long>(C) * ny * nx * ((L + kChunk - 1) / kChunk);
  return launch_cooperative(gibbs_sweep_kernel, &a, 32 * nw,
                            gibbs_smem_bytes(S, f, L, C), tasks,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

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
// times per sweep, as the MH kernel does ((a) with the bfloat16 weights:
// 1.2 GB per sweep out of L2 on the 30x30x600 MUSE subcube with one
// chain), through the ring of asynchronous copies; (b) is a serial chain of
// 2 lw block barriers per color, spread over C x nij x ceil(L / lam_b)
// blocks, each running its slab's window.  A batch of chains runs its (b)
// blocks side by side and pays the 3 f^2 grid barriers once.
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

template <int kS, bool kPos>
__global__ void __launch_bounds__(kMaxThreads)
    gibbs_sweep_kernel(GibbsArgs a, const __grid_constant__ CUtensorMap map_r,
                       const __grid_constant__ CUtensorMap map_w) {
  extern __shared__ __align__(128) float smem[];
  PatchMaps maps{&map_r, &map_w};
  const GibbsShared sh = gibbs_shared(a, smem, maps);
  cg::grid_group grid = cg::this_grid();
  TaskClocks clk(smem);
  for (int c = 0; c < a.f * a.f; ++c)
    gibbs_step<kS, kPos>(a, sh, smem, maps, Step::whole(c, a.f, a.ny, a.nx),
                         grid, clk);
  clk.flush();
}

// The sweeps' truncated-normal draw elementwise (gibbs_step.cuh
// trunc_normal: the same device functions as their lambda-phases), a check
// of that arithmetic against ops/truncnorm.py on the card; no sweep
// launches it.
__global__ void trunc_normal_kernel(const float* __restrict__ alpha,
                                    const float* __restrict__ u_body,
                                    const float* __restrict__ u_tail,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = trunc_normal(alpha[i], u_body[i], u_tail[i]);
}

}  // namespace deconv3d

extern "C" {

// out[i] = z ~ TN[alpha[i], inf) from (u_body[i], u_tail[i]), i < n, on
// `stream`.  Returns a cudaError_t (0 on success).
int trunc_normal_launch(const float* alpha, const float* u_body,
                        const float* u_tail, float* out, int n,
                        void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  deconv3d::trunc_normal_kernel<<<(n + 255) / 256, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      alpha, u_body, u_tail, out, n);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch a step over `spaxels` (chain, spaxel)s needs (lin,
// gacc, the per-wavelength dchi2 and quad_lo terms; with `positivity` the
// jumps too).
long long gibbs_sweep_scratch_floats(int L, long long spaxels,
                                     int positivity) {
  return (positivity ? 5LL : 4LL) * spaxels * L;
}

// Launch one sweep of C chains on `stream`; the rows of `resid` (float)
// and `w` (bfloat16) hold `Ls` >= L elements, Ls % 8 == 0 for the ring;
// `stages` ring stages (< 0: as many as fit, 0: synchronous loads), `lam_b`
// wavelengths per slab of phase (b); `positivity` draws every voxel
// truncated to clean >= 0.  Returns a cudaError_t (0 on success), checked
// right after the launch; the kernel itself runs asynchronously.
int gibbs_sweep_launch(float* resid, const __nv_bfloat16* w,
                       const float* quad,
                       const float* quad_lo, const float* qvox, float* clean,
                       const float* valid,
                       const float* spec, const float* imgs, const float* lsf,
                       const unsigned* keys, const float* uniforms,
                       float* live_out, float* dchi_out, float* uniforms_out,
                       float* scratch, int C, int L, int Ls, int f, int ny,
                       int nx, int S, int lw, int stages, int lam_b,
                       int positivity, unsigned sweep, void* stream) {
  using namespace deconv3d;
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, ny, nx)) return e;
  GibbsArgs a{resid, w, quad, quad_lo, qvox, clean, valid, spec, imgs, lsf, keys,
              uniforms, live_out, dchi_out, uniforms_out, scratch, nullptr,
              nullptr, C, L, Ls, f, ny, nx, S, lw, ny, nx, 1, stages, lam_b,
              C * ny * nx, sweep, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_variant(S, positivity != 0, [&](auto rank, auto pos) {
    return launch_gibbs(
        gibbs_sweep_kernel<decltype(rank)::value, decltype(pos)::value>, &a,
        pos, st);
  });
}

}  // extern "C"

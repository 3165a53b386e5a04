// One Metropolis-Hastings sweep of the color-decomposed sampler on Hopper,
// for a batch of C independent chains.
//
// Replaces the TPU kernel deconv3d_tpu/ops/pallas_sweep.py::_make_kernel
// (mode="mh", any chain batch C), launched there by _kernel_segment.  It
// computes what that kernel computes for every chain and every color
// (cy, cx) of one sweep:
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
// the spaxels of one color are independent, and so are the chains; within
// a spaxel every wavelength of the patch contraction and of the commit is
// independent.  The work of one color is cut into TASKS of (chain, spaxel,
// 32-wavelength chunk): a thread block of min(f, 18) row warps (and two
// service warps) takes a task, lanes on wavelengths and warps on patch rows
// (sweep_common.cuh).
// Colors depend on each other, so the sweep is ONE cooperative launch for
// all chains, one step per color: the two phases and two grid barriers of
// mh_step.cuh (shared with the tiled kernel, tiled_sweep.cu) over every
// spaxel of the color, each block walking its tasks with the next ones'
// patches in flight (the ring of sweep_common.cuh) and two service warps
// beside the row warps.
//
// The chains share the weights, quad, FSF and LSF, and the barriers: a
// batch of C chains pays the 2 f^2 barriers of a sweep once.  A task's
// arithmetic does not depend on the batch, so a chain computes the same
// bits alone or in a batch.  Random numbers come from the in-kernel Philox
// (philox.cuh) under each chain's key, or from an injected uniform tensor
// for parity tests.
//
// What bounds it.  Each color reads the whole f x f x L patch of residual
// and weights of each of its spaxels ((4 + 2) x f^2 x L bytes, the weights
// in bfloat16: 1.04 MB per spaxel at f=17, L=600) and writes the residual
// patch back on accept; summed over a sweep, every residual voxel is read
// f^2 times.  On a 30x30 MUSE subcube with one chain that is 1.2 GB per
// sweep out of L2 spread over only 4 spaxels x 19 chunks = 76 tasks, and
// 578 grid barriers per sweep: the sweep is bound by L2 latency and
// barriers, not by bandwidth.  A batch of chains multiplies the tasks per
// barrier (32 chains: 2432 tasks).  On the full MUSE range (L=3681) the
// state leaves L2 and the f^2 re-reads go to HBM: the ring's copies then
// run the card's memory at about two thirds of its rate, and that is the
// sweep's time (PERF.md).
//
// Per-(chain, color, spaxel) outputs: the accept flag and the proposed
// dchi2; the wrapper sums accepted dchi2 in a fixed order and applies each
// chain's Kahan chi2 update per sweep, as _assemble does in the JAX
// package.

#include "mh_step.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

template <int kS, bool kPos>
__global__ void __launch_bounds__(kMaxThreads)
    mh_sweep_kernel(MhArgs a, const __grid_constant__ CUtensorMap map_r,
                    const __grid_constant__ CUtensorMap map_w) {
  extern __shared__ __align__(128) float smem[];
  PatchMaps maps{&map_r, &map_w};
  const MhShared sh = mh_shared(a, smem, maps);
  cg::grid_group grid = cg::this_grid();
  TaskClocks clk(smem);
  for (int c = 0; c < a.f * a.f; ++c)
    mh_step<kS, kPos>(a, sh, smem, maps, Step::whole(c, a.f, a.ny, a.nx), grid,
                      clk);
  clk.flush();
}

}  // namespace deconv3d

extern "C" {

// Floats of scratch a step over `spaxels` (chain, spaxel)s needs (per-task
// g, jumps and dchi2 shares).
long long mh_sweep_scratch_floats(int L, long long spaxels) {
  const long long tasks =
      spaxels * ((L + deconv3d::kChunk - 1) / deconv3d::kChunk);
  return tasks * (2 * deconv3d::kChunk + 1);
}

// Launch one sweep of C chains on `stream`; the rows of `resid` (float)
// and `w` (bfloat16) hold `Ls` >= L elements, Ls % 8 == 0 for the ring;
// `stages` ring stages (< 0: as many as fit, 0: synchronous loads);
// `positivity` reflects every proposal into clean >= 0.  Returns a
// cudaError_t (0 on success), checked right after the launch; the kernel
// itself runs asynchronously.
int mh_sweep_launch(float* resid, const __nv_bfloat16* w,
                    const float* quad,
                    float* clean, float* log_scale, const float* valid,
                    const float* spec, const float* imgs, const float* lsf,
                    const unsigned* keys, const float* uniforms,
                    float* accept_out, float* dchi_out, float* uniforms_out,
                    float* scratch, int C, int L, int Ls, int f, int ny, int nx,
                    int S, int lw, int stages, int positivity, unsigned sweep,
                    float adapt, float target, void* stream) {
  using namespace deconv3d;
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, ny, nx)) return e;
  MhArgs a{resid, w, quad, clean, log_scale, valid, spec, imgs, lsf, keys,
           uniforms, accept_out, dchi_out, uniforms_out, scratch, nullptr,
           nullptr, C, L, Ls, f, ny, nx, S, lw, ny, nx, 1, stages, sweep, adapt,
           target, 0, 0};
  const long long spaxels = static_cast<long long>(C) * ny * nx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_variant(S, positivity != 0, [&](auto rank, auto pos) {
    return launch_mh(
        mh_sweep_kernel<decltype(rank)::value, decltype(pos)::value>, &a,
        spaxels, st);
  });
}

}  // extern "C"

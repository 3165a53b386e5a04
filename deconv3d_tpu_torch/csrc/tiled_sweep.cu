// One tiled sweep of the color-decomposed sampler on Hopper, modes MH and
// exact Gibbs, for a batch of C independent chains.
//
// Replaces the TPU kernel deconv3d_tpu/ops/pallas_tiled.py::
// _make_tiled_kernel (mode "mh" at :309-327, mode "gibbs" at :328-381),
// launched there by _tiled_segment_arrays.  It computes that kernel's scan:
// the field's spaxel grid (ny x nx blocks of f x f) is cut into tiles of
// nyt x nxt blocks; a sweep walks the tiles in raster order and, inside
// each tile, all f^2 colors; each (tile, color) step updates the tile's
// nyt * nxt spaxels of that color with the per-spaxel math of the
// whole-cube kernels (mh_step.cuh, gibbs_step.cuh).  A step sees every
// earlier step's commit: the windows of neighbouring tiles overlap by
// f - 1 rows and columns of halo, so the steps run one after another,
// separated by grid barriers -- the last color of tile t is committed
// before the first color of tile t + 1 reads.  This is a different fixed
// scan than the whole-cube kernels' color-major one, and an equally valid
// MH-within-Gibbs scan of the same posterior.
//
// Random numbers are keyed as in the whole-cube kernels, by (lambda >> 2,
// absolute sweep, color, stream << 24 | GLOBAL spaxel row) (philox.cuh),
// not by the tile as on the TPU: a spaxel's visit draws the same numbers
// under any tiling, so the tiled and whole-cube engines differ only in
// the order of their visits, and one tile (nyt, nxt) = (ny, nx) is the
// whole-cube kernel's sweep bit for bit.
//
// Design: one cooperative launch per sweep for all chains; per step the
// two (MH) or three (gibbs) phases and grid barriers of the whole-cube
// kernels, restricted to the tile's (chain, spaxel, 32-wavelength chunk)
// tasks.  The TPU kernel copies each tile's window (owned rows + f - 1
// halo) into VMEM at its first color and back at its last; here the window
// is not copied: it is the region of the residual and weights the tile's
// f^2 steps touch, and it stays in the 50 MB L2 across them when the tile
// is planned under the L2 budget (ops/tiled.py plan_tiles).
//
// What bounds it.  The dependent steps: n_tiles * f^2 per sweep, each
// with 2 (MH) or 3 (gibbs) grid barriers (the full MUSE field, 18 x 18
// spaxel blocks at f = 17, with (1, 2) tiles: 162 * 289 = 46,818 steps),
// and only C * nyt * nxt spaxels of work per step (2 spaxels x 116 chunks
// per chain at L = 3681; gibbs phase (b) on 2 blocks while the rest of the
// grid waits).  Then L2 -> HBM traffic where a window spills.  Against the
// whole-cube kernel the trade is fewer re-reads from HBM (each residual
// voxel is still read f^2 times, but from L2) for n_tiles times more
// barriers and phase loops; on the H100 the second weighs more (PERF.md).
// Running tiles that share no halo concurrently (a wavefront keeping
// raster semantics) and pinning the window in L2 are later work.

#include "gibbs_step.cuh"
#include "mh_step.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

__global__ void __launch_bounds__(kMaxThreads) tiled_mh_kernel(MhArgs a) {
  extern __shared__ float smem[];
  const MhShared sh = mh_shared(a, smem);
  cg::grid_group grid = cg::this_grid();
  const int n_colors = a.f * a.f, ntx = a.nx / a.nxt;
  const int n_steps = (a.ny / a.nyt) * ntx * n_colors;
  for (int k = 0; k < n_steps; ++k) {      // tiles in raster order, colors
    const int t = k / n_colors;            // inside each tile
    mh_step(a, sh, Step(k % n_colors, a.f, (t / ntx) * a.nyt,
                        (t % ntx) * a.nxt, a.nyt, a.nxt), grid);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    tiled_gibbs_kernel(GibbsArgs a) {
  extern __shared__ float smem[];
  const GibbsShared sh = gibbs_shared(a, smem);
  cg::grid_group grid = cg::this_grid();
  const int n_colors = a.f * a.f, ntx = a.nx / a.nxt;
  const int n_steps = (a.ny / a.nyt) * ntx * n_colors;
  for (int k = 0; k < n_steps; ++k) {
    const int t = k / n_colors;
    gibbs_step(a, sh, Step(k % n_colors, a.f, (t / ntx) * a.nyt,
                           (t % ntx) * a.nxt, a.nyt, a.nxt), grid);
  }
}

}  // namespace deconv3d

extern "C" {

// Launch one tiled MH sweep of C chains with nyt x nxt tiles on `stream`;
// `scratch` holds mh_sweep_scratch_floats(C, L, nyt, nxt) floats.  Returns
// a cudaError_t (0 on success), checked right after the launch.
int tiled_mh_launch(float* resid, const float* w, const float* quad,
                    float* clean, float* log_scale, const float* valid,
                    const float* spec, const float* imgs, const float* lsf,
                    const unsigned* keys, const float* uniforms,
                    float* accept_out, float* dchi_out, float* uniforms_out,
                    float* scratch, int C, int L, int f, int ny, int nx, int S,
                    int lw, int nyt, int nxt, unsigned sweep, float adapt,
                    float target, void* stream) {
  using namespace deconv3d;
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, nyt, nxt)) return e;
  MhArgs a{resid, w, quad, clean, log_scale, valid, spec, imgs, lsf, keys,
           uniforms, accept_out, dchi_out, uniforms_out, scratch, C, L, f,
           ny, nx, S, lw, nyt, nxt, sweep, adapt, target};
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  const long long tasks =
      static_cast<long long>(C) * nyt * nxt * ((L + kChunk - 1) / kChunk);
  return launch_cooperative(tiled_mh_kernel, &a, 32 * nw,
                            mh_smem_bytes(S, f, lw, C), tasks,
                            static_cast<cudaStream_t>(stream));
}

// Launch one tiled exact-Gibbs sweep of C chains with nyt x nxt tiles on
// `stream`; `scratch` holds gibbs_sweep_scratch_floats(C, L, nyt, nxt)
// floats.  Returns a cudaError_t (0 on success).
int tiled_gibbs_launch(float* resid, const float* w, const float* quad,
                       const float* quad_lo, const float* qvox, float* clean,
                       const float* valid, const float* spec,
                       const float* imgs, const float* lsf,
                       const unsigned* keys, const float* uniforms,
                       float* live_out, float* dchi_out, float* uniforms_out,
                       float* scratch, int C, int L, int f, int ny, int nx,
                       int S, int lw, int nyt, int nxt, unsigned sweep,
                       void* stream) {
  using namespace deconv3d;
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, nyt, nxt)) return e;
  GibbsArgs a{resid, w, quad, quad_lo, qvox, clean, valid, spec, imgs, lsf,
              keys, uniforms, live_out, dchi_out, uniforms_out, scratch, C, L,
              f, ny, nx, S, lw, nyt, nxt, sweep};
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  const long long tasks =
      static_cast<long long>(C) * nyt * nxt * ((L + kChunk - 1) / kChunk);
  return launch_cooperative(tiled_gibbs_kernel, &a, 32 * nw,
                            gibbs_smem_bytes(S, f, L, C), tasks,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

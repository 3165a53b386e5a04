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
// f - 1 rows and columns of halo.  This is a different fixed scan than the
// whole-cube kernels' color-major one, and an equally valid
// MH-within-Gibbs scan of the same posterior.
//
// Random numbers are keyed as in the whole-cube kernels, by (lambda >> 2,
// absolute sweep, color, stream << 24 | GLOBAL spaxel row) (philox.cuh),
// not by the tile as on the TPU: a spaxel's visit draws the same numbers
// under any tiling, so the tiled and whole-cube engines differ only in
// the order of their visits, and one tile (nyt, nxt) = (ny, nx) is the
// whole-cube kernel's sweep bit for bit.
//
// Design, redone for this card.  The TPU runs its grid in order on one
// core and copies each tile's window into VMEM; on the H100 a raster of
// tiles leaves 130 of 132 SMs idle -- a (1, 2) tile of the full MUSE field
// is 2 spaxels, 232 tasks, per step, and 162 * 289 = 46,818 dependent
// steps per sweep.  So:
//   * The schedule is data: a table of waves, each a list of tiles, and a
//     step is one color over ALL tiles of a wave.  The wavefront schedule
//     (ops/tiled.py wave_schedule) puts tile (ti, tj) in wave 2 ti + tj:
//     every neighbour that precedes it in raster order -- (ti, tj-1),
//     (ti-1, tj-1), (ti-1, tj), (ti-1, tj+1) -- is in an earlier wave,
//     every later one in a later wave, and the tiles of one wave share no
//     window (two tile columns apart: nxt f - f + 1 >= 1 columns between
//     their windows), so the sweep is the raster sweep bit for bit in
//     2 (Ty - 1) + Tx waves instead of Ty Tx.  The raster is the schedule
//     of one tile per wave.
//   * Each block walks its (chain, spaxel, 32-wavelength chunk) tasks with
//     the next patches in flight (the ring of sweep_common.cuh).
//   * Gibbs phase (b) of one (chain, spaxel) runs on ceil(L / lam_b)
//     blocks, each over its slab's window (gibbs_step.cuh).
// One cooperative launch per sweep for all chains; per step the two (MH)
// or three (gibbs) grid barriers of the whole-cube kernels.  The window is
// not copied: it is the region of the residual and weights a tile's f^2
// steps touch; a raster of tiles planned under the L2 budget keeps it in
// the 50 MB L2, the windows of a wave together do not fit it.
//
// A band launch (the y_base argument of the TPU kernel, :155, :190-192,
// which parallel/kernel_sharded.py passes) sweeps only the block rows [by0,
// by0 + nyb) of the carried grid -- a shard's residual with its f - 1
// replica rows -- in nyb / nyt tile rows: the band's window starts by0 * f
// rows down the carried residual, and its spaxels keep their carried rows
// for every per-spaxel array and output.  gy0, the field's block row of the
// carried row 0, keys the random numbers, so a band draws the numbers of
// its spaxels' field rows in any shard.  by0 = 0, nyb = ny, gy0 = 0 is the
// whole field: the same bits as before the band arguments.
//
// What bounds it.  Every residual and weight voxel is read f^2 times per
// sweep (and the residual written back at every commit): 289 x 2.29 GB at
// the full field (the weights in bfloat16: 0.76 of the 2.29), 0.20 s of
// HBM time for the reads alone unless a window stays in L2.  Then the
// dependent steps: (waves) * f^2, each with 2 or 3 grid barriers.  PERF.md
// has the measured split.

#include "gibbs_step.cuh"
#include "mh_step.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

template <int kS, bool kPos>
__global__ void __launch_bounds__(kMaxThreads)
    tiled_mh_kernel(MhArgs a, const __grid_constant__ CUtensorMap map_r,
                    const __grid_constant__ CUtensorMap map_w) {
  extern __shared__ __align__(128) float smem[];
  PatchMaps maps{&map_r, &map_w};
  const MhShared sh = mh_shared(a, smem, maps);
  cg::grid_group grid = cg::this_grid();
  TaskClocks clk(smem);
  const int n_colors = a.f * a.f, ntx = a.nx / a.nxt;
  for (int wv = 0; wv < a.n_waves; ++wv) {     // waves in order; inside each
    const int t0 = a.wave_start[wv];           // wave, the colors in order
    const int n = a.wave_start[wv + 1] - t0;   // over all its tiles
    for (int c = 0; c < n_colors; ++c)
      mh_step<kS, kPos>(a, sh, smem, maps,
              Step(c, a.f, a.nyt, a.nxt, ntx, a.wave_tiles + t0, n, a.by0),
              grid, clk);
  }
  clk.flush();
}

template <int kS, bool kPos>
__global__ void __launch_bounds__(kMaxThreads)
    tiled_gibbs_kernel(GibbsArgs a, const __grid_constant__ CUtensorMap map_r,
                       const __grid_constant__ CUtensorMap map_w) {
  extern __shared__ __align__(128) float smem[];
  PatchMaps maps{&map_r, &map_w};
  const GibbsShared sh = gibbs_shared(a, smem, maps);
  cg::grid_group grid = cg::this_grid();
  TaskClocks clk(smem);
  const int n_colors = a.f * a.f, ntx = a.nx / a.nxt;
  for (int wv = 0; wv < a.n_waves; ++wv) {
    const int t0 = a.wave_start[wv];
    const int n = a.wave_start[wv + 1] - t0;
    for (int c = 0; c < n_colors; ++c)
      gibbs_step<kS, kPos>(a, sh, smem, maps,
                 Step(c, a.f, a.nyt, a.nxt, ntx, a.wave_tiles + t0, n, a.by0),
                 grid, clk);
  }
  clk.flush();
}

inline int check_schedule(const void* wave_start, const void* wave_tiles,
                          int n_waves, int max_tiles) {
  if (!wave_start || !wave_tiles || n_waves < 1 || max_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace deconv3d

extern "C" {

#ifdef TASK_PHASE_CLOCKS
// Copy out and clear the task clocks of a measurement build.
int task_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(
      out, deconv3d::task_clocks,
      deconv3d::kTaskClocks * sizeof(unsigned long long));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[deconv3d::kTaskClocks] = {0};
  return static_cast<int>(
      cudaMemcpyToSymbol(deconv3d::task_clocks, zero, sizeof(zero)));
}
#endif

// Launch one tiled MH sweep of C chains with nyt x nxt tiles on `stream`,
// in the order of the schedule `wave_start` [n_waves + 1] / `wave_tiles`
// (device ints; at most `max_tiles` tiles in a wave, raster indices of the
// band's tiles); the band: block rows [by0, by0 + nyb) of the carried
// ny x nx grid, whose row 0 is the field's block row gy0 (check_band); the
// rows of `resid` (float) and `w` (bfloat16) hold `Ls` >= L elements,
// Ls % 8 == 0 for the ring; `scratch` holds mh_sweep_scratch_floats(L,
// C * max_tiles * nyt * nxt) floats; `positivity` as in mh_sweep_launch.
// Returns a cudaError_t (0 on success), checked right after the launch.
int tiled_mh_launch(float* resid, const __nv_bfloat16* w,
                    const float* quad,
                    float* clean, float* log_scale, const float* valid,
                    const float* spec, const float* imgs, const float* lsf,
                    const unsigned* keys, const float* uniforms,
                    float* accept_out, float* dchi_out, float* uniforms_out,
                    float* scratch, const int* wave_start,
                    const int* wave_tiles, int C, int L, int Ls, int f, int ny,
                    int nx, int S, int lw, int nyt, int nxt, int n_waves,
                    int max_tiles, int stages, int by0, int nyb, int gy0,
                    int positivity, unsigned sweep, float adapt, float target,
                    void* stream) {
  using namespace deconv3d;
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, 1, nxt)) return e;
  if (const int e = check_band(ny, nx, nyt, by0, nyb, gy0)) return e;
  if (const int e = check_schedule(wave_start, wave_tiles, n_waves, max_tiles))
    return e;
  MhArgs a{resid, w, quad, clean, log_scale, valid, spec, imgs, lsf, keys,
           uniforms, accept_out, dchi_out, uniforms_out, scratch, wave_start,
           wave_tiles, C, L, Ls, f, ny, nx, S, lw, nyt, nxt, n_waves, stages,
           sweep, adapt, target, by0, gy0 * nx};
  const long long spaxels = static_cast<long long>(C) * max_tiles * nyt * nxt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_variant(S, positivity != 0, [&](auto rank, auto pos) {
    return launch_mh(
        tiled_mh_kernel<decltype(rank)::value, decltype(pos)::value>, &a,
        spaxels, st);
  });
}

// Launch one tiled exact-Gibbs sweep of C chains (and band), as
// tiled_mh_launch;
// `lam_b` wavelengths per slab of phase (b); `scratch` holds
// gibbs_sweep_scratch_floats(L, C * max_tiles * nyt * nxt,
// positivity) floats;
// `positivity` as in gibbs_sweep_launch.  Returns a cudaError_t (0 on
// success).
int tiled_gibbs_launch(float* resid, const __nv_bfloat16* w,
                       const float* quad,
                       const float* quad_lo, const float* qvox, float* clean,
                       const float* valid, const float* spec,
                       const float* imgs, const float* lsf,
                       const unsigned* keys, const float* uniforms,
                       float* live_out, float* dchi_out, float* uniforms_out,
                       float* scratch, const int* wave_start,
                       const int* wave_tiles, int C, int L, int Ls, int f,
                       int ny, int nx, int S, int lw, int nyt, int nxt, int n_waves,
                       int max_tiles, int stages, int by0, int nyb, int gy0,
                       int lam_b, int positivity, unsigned sweep,
                       void* stream) {
  using namespace deconv3d;
  if (const int e = check_dims(C, L, f, ny, nx, S, lw, 1, nxt)) return e;
  if (const int e = check_band(ny, nx, nyt, by0, nyb, gy0)) return e;
  if (const int e = check_schedule(wave_start, wave_tiles, n_waves, max_tiles))
    return e;
  GibbsArgs a{resid, w, quad, quad_lo, qvox, clean, valid, spec, imgs, lsf,
              keys, uniforms, live_out, dchi_out, uniforms_out, scratch,
              wave_start, wave_tiles, C, L, Ls, f, ny, nx, S, lw, nyt, nxt,
              n_waves, stages, lam_b, C * max_tiles * nyt * nxt, sweep, by0,
              gy0 * nx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_variant(S, positivity != 0, [&](auto rank, auto pos) {
    return launch_gibbs(
        tiled_gibbs_kernel<decltype(rank)::value, decltype(pos)::value>, &a,
        pos, st);
  });
}

}  // extern "C"

// The resident whole-cube sweep on Hopper, modes MH and exact Gibbs, for a
// batch of C chains: the state stays in the SMs' shared memory for the
// whole sweep, split by wavelength.
//
// Replaces the TPU kernel deconv3d_tpu/ops/pallas_sweep.py::_make_kernel
// (mode "mh", and mode "gibbs" at :243-314), launched there by
// _kernel_segment, as a redesign of classic K1 (mh_sweep.cu,
// gibbs_sweep.cu): it computes classic K1's function bit for bit -- the
// same per-element arithmetic (the explicit-rounding helpers of
// sweep_common.cuh, mh_step.cuh, gibbs_step.cuh) summed in the same order.
// The TPU kernel keeps the residual resident in VMEM for a segment
// (pallas_sweep.py:3-5); the H100's counterpart is the aggregate shared
// memory of its 132 SMs (~30 MB), which holds the MUSE 30x30x600 state once
// it is split by wavelength.
//
// Design.  One cooperative launch per sweep, one block per SM; block b owns
// the wavelength slab [a, a + nl), a = b * lam_b, and loads its slab of the
// residual (C chains), the weights, the clean cube (C chains) and, for MH,
// quad into shared memory once, and writes resid and clean back at the end.
// Everything a color step does at one wavelength -- the patch contraction,
// the commit, clean += jump -- runs on the slab.  What crosses wavelengths:
//
//   MH, per color: (1) row-group partials of lin over the slab (classic
//   K1's warps become threads: rows dy = r, r + nw, ...) on the low
//   threads, and (2) on the high ones the jumps of the slab and its +-lw/2
//   LSF halo, recomputed from Philox or read from the injected uniforms,
//   and the accept uniforms; (3) lin, g and the per-wavelength dchi2 share
//   g^2 q - 2 g lin, written to a global buffer (two halves by color
//   parity);  --- grid barrier ---  (4) every block reduces all L shares
//   of every spaxel in classic K1's order, a warp per (chain, spaxel) and
//   straight from global memory into registers: lane l reads wavelength
//   32 q + l of every 32-wavelength chunk q, a register transpose of
//   shuffles gives lane q chunk q's sum with the bits of classic K1's
//   32-lane warp_sum tree, lane q adds chunk q's and then chunk q + 32's,
//   and warp_sum of the lanes gives dchi2; so every block reaches the same
//   dchi2 and decision and keeps the same log-scales; block 0 writes the
//   spaxel's outputs; (5) the block commits its slab.
//   No second barrier: the next color reads only the block's own slab.
//   f^2 barriers per sweep against classic's 2 f^2.
//
//   gibbs, per color: (a) lin over the slab, written to global (two halves
//   by parity);  --- grid barrier ---  (b) every block runs the lw
//   lambda-phases redundantly over its window [a - 2(lw-1), a + nl +
//   lw(lw-1)) of lin, quad, qvox and the normals, a group of warps per
//   (chain, spaxel) on a named barrier: a phase's jump at lambda reads lin
//   within +-lw/2 and its lin update the jumps within +-lw/2, so a window
//   edge's error moves inwards by at most lw - 1 per phase, and since phase
//   ph draws lambda = ph (mod lw) the lower edge's by exactly 1 after the
//   first phase: the slab's jumps and g come out exact (ops/resident.py
//   window_margins); (c) the slab's dchi2 terms go to global per
//   wavelength, clean += jumps, resid -= patch(gacc).  After the last color
//   one more barrier and a tail that reduces the terms of every (color,
//   chain, spaxel) in classic (b)'s order (thread-strided over 32 min(f, 18)
//   threads, warp_sum, warps in order).  f^2 + 1 barriers per sweep against
//   classic's 3 f^2, and phase (b) on every block instead of one block per
//   spaxel.
//
//   Both modes build every color's geometry table once per launch, and
//   kS = 1 compiles the rank-1 FSF (MUSE's) without the rank loop.
//
//   Positivity (kPos, compile-time; the flag-off code is unchanged) needs
//   each proposal's or draw's clean, over the halo and the window too,
//   which belong to other blocks' slabs.  A spaxel's clean changes only at
//   its own visit and global clean is written only after the sweep, so
//   every block reads the visit's starting clean there: MH reflects the
//   jumps of its slab and halo, gibbs keeps the window's clean and log u2
//   beside it (7 window arrays, not 5) for truncated_jump.
//
// What bounds it.  The chain of f^2 dependent color steps -- not bytes or
// flops: at 30x30x600 a sweep moves ~26 MB (MH) and does ~0.6 GFLOP, ~9 us
// of the card's bandwidth or float32 rate.  Each step pays one grid barrier
// (~1.1 us on the H100) and a few block-level phases whose dependent
// chains of shared-memory loads, integer index math and libm calls run on
// a handful of busy warps per SM; gibbs adds 2 lw group barriers in its
// phase loop.  PERF.md has the measured split.
//
// Shared memory of one block (4-byte words; ops/resident.py smem_bytes
// mirrors resident_layout below), cs = C ny nx (chain, spaxel) pairs of a
// color, nw = min(f, 18):
//   S f^2 + 2C + (C + 1) Hp Wp lam_b + C Yc Xc lam_b + S lam_b + f^2
//     + 7 f^2 cs + cs lam_b (nw S + 2)
//   MH    + C Yc Xc + Yc Xc lam_b + lam_b lw + cs (lam_b + lw - 1) + 2 cs
//   gibbs + wd lw + 5 cs wd + 3 nw,   wd = min(L, lam_b + 2(lw-1) + lw(lw-1))
//         (+ 2 cs wd with positivity)
// MUSE 30x30x600 at lam_b = 5 (120 blocks): 188 KB (MH), 176 KB (gibbs) of
// the 227 KB a block may opt in to.  The wrapper launches this kernel only
// where the plan fits (ops/resident.py plan_slabs) and classic K1
// elsewhere.

#include "gibbs_step.cuh"
#include "mh_step.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

struct ResidentArgs {
  float* resid;            // [C, Hp, Wp, L]
  const float* w;          // [Hp, Wp, L]
  const float* quad;       // [Yc, Xc, L]
  const float* quad_lo;    // [Yc, Xc, L] or null (gibbs)
  const float* qvox;       // [Yc, Xc, L] (gibbs)
  float* clean;            // [C, Yc, Xc, L]
  float* log_scale;        // [C, Yc, Xc] (MH)
  const float* valid;      // [Yc, Xc] 1.0 / 0.0
  const float* spec;       // [S, L]
  const float* imgs;       // [S, f, f]
  const float* lsf;        // [L, lw]
  const uint32_t* keys;    // [C, 2] Philox key words
  const float* uniforms;   // MH [C, f*f, nij, L+1], gibbs [.., 2, L] or null
  float* out_a;            // [C, f*f, nij] MH accept flag, gibbs voxels drawn
  float* dchi_out;         // [C, f*f, nij]
  float* uniforms_out;     // as uniforms, or null
  float* scratch;          // resident_*_scratch_floats
  int C, L, f, ny, nx, S, lw, lam_b;
  uint32_t sweep;
  float adapt, target;
};

__host__ __device__ inline int window_lo_margin(int lw) { return 2 * (lw - 1); }
__host__ __device__ inline int window_hi_margin(int lw) { return lw * (lw - 1); }

constexpr int kGeo = 6;    // ints per (chain, spaxel) of a color: see Geo
// A resident block holds min(f, 18) row warps and no service warp, and its
// shared memory leaves room for one block per SM.  The kernels say so in
// their launch bounds: without the 1, ptxas may aim at two blocks per SM
// and cap a thread at 56 registers, which spills (measured: 8% slower).
constexpr int kResidentThreads = 32 * kMaxWarps;

// Offsets (4-byte words) of the block's shared arrays.
struct ResidentLayout {
  size_t img, key, rs, ws, cl, spec, off, geo, vt, pool, lin, g;
  size_t lsmap, quad, lsf, jump, u2, acc;     // MH (lsf: the slab's rows)
  size_t win, red;                             // gibbs (lsf: the window's)
  size_t total;
  int wd;                                      // gibbs window stride
};

__host__ __device__ inline ResidentLayout resident_layout(
    bool gibbs, bool pos, int C, int f, int ny, int nx, int L, int S, int lw,
    int lb) {
  const size_t nw = f < kMaxWarps ? f : kMaxWarps;
  const size_t cs = static_cast<size_t>(C) * ny * nx;
  const size_t Hp = f - 1 + ny * f, Wp = f - 1 + nx * f;
  const size_t Yc = static_cast<size_t>(ny) * f, Xc = static_cast<size_t>(nx) * f;
  const size_t ff = static_cast<size_t>(f) * f;
  ResidentLayout o{};
  size_t n = 0;
  o.img = n;   n += S * ff;                    // FSF images
  o.key = n;   n += 2 * static_cast<size_t>(C);  // Philox keys
  o.rs = n;    n += C * Hp * Wp * lb;          // resid slab
  o.ws = n;    n += Hp * Wp * lb;              // weights slab
  o.cl = n;    n += C * Yc * Xc * lb;          // clean slab
  o.spec = n;  n += static_cast<size_t>(S) * lb;  // spectra of the slab
  o.off = n;   n += ff;                        // patch pixel -> slab offset
  o.geo = n;   n += kGeo * ff * cs;            // every color's (chain, spaxel)s
  o.vt = n;    n += ff * cs;                   // and their valid flags
  o.pool = n;  n += cs * lb * nw * S;          // row-group partials of lin
  o.lin = n;   n += cs * lb;                   // lin of the slab
  o.g = n;     n += cs * lb;                   // g (MH) / gacc (gibbs)
  if (!gibbs) {
    o.lsmap = n; n += C * Yc * Xc;             // log-scales of every spaxel
    o.quad = n;  n += Yc * Xc * lb;            // quad slab
    o.lsf = n;   n += static_cast<size_t>(lb) * lw;
    o.jump = n;  n += cs * (lb + lw - 1);      // jumps with the LSF halo
    o.u2 = n;    n += cs;                      // accept uniforms
    o.acc = n;   n += cs;                      // decisions
  } else {
    const int wd = lb + window_lo_margin(lw) + window_hi_margin(lw);
    o.wd = wd < L ? wd : L;
    o.lsf = n;   n += static_cast<size_t>(o.wd) * lw;
    o.win = n;                                 // lin, quad, qvox, jumps, gacc
    n += gibbs_window_arrays(pos) * cs * o.wd; // (+ u2, clean: positivity)
    o.red = n;   n += 3 * nw;                  // the tail's warp sums
  }
  o.total = n;
  return o;
}

// Phase clocks of a measurement build (-DRESIDENT_PHASE_CLOCKS; python -m
// deconv3d_tpu_torch.resident_phases): thread 0 of block 0 adds the SM
// clocks of each phase of the color loop to resident_clocks[k].
#ifdef RESIDENT_PHASE_CLOCKS
__device__ unsigned long long resident_clocks[8];
#define PHASE_CLOCKS_BEGIN \
  long long clk_sum_[8] = {0}, clk_last_ = clock64()
#define PHASE(k)                                                        \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                            \
    const long long t_ = clock64();                                     \
    clk_sum_[k] += t_ - clk_last_;                                      \
    clk_last_ = t_;                                                     \
  }
#define PHASE_CLOCKS_END                                                \
  if (threadIdx.x == 0 && blockIdx.x == 0)                              \
    for (int k = 0; k < 8; ++k) resident_clocks[k] += clk_sum_[k]
#else
#define PHASE_CLOCKS_BEGIN
#define PHASE(k)
#define PHASE_CLOCKS_END
#endif

// The phase loop's warp groups synchronise on named barriers 1..kMaxGroups
// (0 is __syncthreads); a group of one warp on __syncwarp.
constexpr int kMaxGroups = 15;
__device__ __forceinline__ void group_sync(int gi, int G) {
  if (G == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + gi), "r"(G * 32) : "memory");
}

// The geometry of one launch and this block's slab.
struct Resident {
  int C, L, f, S, lw, half, lb, nij, n_colors, ff, Yc, Xc, Hp, Wp, P, nw, ncs;
  int l0, nl;              // the slab [l0, l0 + nl)
  __device__ explicit Resident(const ResidentArgs& a)
      : C(a.C), L(a.L), f(a.f), S(a.S), lw(a.lw), half(a.lw / 2),
        lb(a.lam_b), nij(a.ny * a.nx), n_colors(a.f * a.f), ff(a.f * a.f),
        Yc(a.ny * a.f), Xc(a.nx * a.f), Hp(a.f - 1 + a.ny * a.f),
        Wp(a.f - 1 + a.nx * a.f), P((a.L + kChunk - 1) / kChunk),
        nw(a.f < kMaxWarps ? a.f : kMaxWarps), ncs(a.C * a.ny * a.nx),
        l0(blockIdx.x * a.lam_b),
        nl(min(a.lam_b, a.L - static_cast<int>(blockIdx.x) * a.lam_b)) {}
};

// One (chain, spaxel) cs of the color: offsets of its patch's top-left
// pixel in the resid and weights slabs and of the spaxel in the clean slab
// (all at the slab's first wavelength), the spaxel, its row, its chain.
struct Geo {
  int rb, wb, cb, sp, ij, ch;
};

// The geometry table of every color (and the valid flags); the caller
// syncs.  Color c's (chain, spaxel)s start at geo + c * ncs * kGeo.
__device__ __forceinline__ void all_geometry(const Resident& g, int ny,
                                             int nx, const float* valid,
                                             int* geo, float* vt) {
  for (int t = threadIdx.x; t < g.n_colors * g.ncs; t += blockDim.x) {
    const int c = t / g.ncs, cs = t - c * g.ncs;
    const Step st = Step::whole(c, g.f, ny, nx);
    const int ch = cs / g.nij, ij = st.ij(cs % g.nij, nx);
    const int ys = (ij / nx) * g.f + st.cy, xs = (ij % nx) * g.f + st.cx;
    int* e = geo + kGeo * t;
    e[0] = ((ch * g.Hp + ys) * g.Wp + xs) * g.lb;
    e[1] = (ys * g.Wp + xs) * g.lb;
    e[2] = ((ch * g.Yc + ys) * g.Xc + xs) * g.lb;
    e[3] = ys * g.Xc + xs;
    e[4] = ij;
    e[5] = ch;
    vt[t] = valid[ys * g.Xc + xs];
  }
}
__device__ __forceinline__ Geo geo_of(const int* geo, int cs) {
  const int* e = geo + kGeo * cs;
  return Geo{e[0], e[1], e[2], e[3], e[4], e[5]};
}

// rows x [L] (global, the slab's columns) <-> rows x [lb] (shared)
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          int rows, const Resident& g) {
  for (int i = threadIdx.x; i < rows * g.nl; i += blockDim.x) {
    const int row = i / g.nl, j = i - row * g.nl;
    dst[row * g.lb + j] = src[static_cast<size_t>(row) * g.L + g.l0 + j];
  }
}
__device__ __forceinline__ void store_slab(float* dst, const float* src,
                                           int rows, const Resident& g) {
  for (int i = threadIdx.x; i < rows * g.nl; i += blockDim.x) {
    const int row = i / g.nl, j = i - row * g.nl;
    dst[static_cast<size_t>(row) * g.L + g.l0 + j] = src[row * g.lb + j];
  }
}

// What both modes load at the start: keys, images, the resid / weights /
// clean slabs, valid, the slab's spectra, the patch offset table.
__device__ __forceinline__ void load_common(const ResidentArgs& a,
                                            const Resident& g,
                                            const ResidentLayout& o,
                                            float* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t* key = reinterpret_cast<uint32_t*>(smem + o.key);
  int* off = reinterpret_cast<int*>(smem + o.off);
  for (int k = tid; k < 2 * g.C; k += nt) key[k] = a.keys[k];
  for (int k = tid; k < g.S * g.ff; k += nt) smem[o.img + k] = a.imgs[k];
  all_geometry(g, a.ny, a.nx, a.valid, reinterpret_cast<int*>(smem + o.geo),
               smem + o.vt);
  for (int k = tid; k < g.S * g.nl; k += nt) {
    const int s = k / g.nl, j = k - s * g.nl;
    smem[o.spec + s * g.lb + j] = a.spec[s * g.L + g.l0 + j];
  }
  for (int px = tid; px < g.ff; px += nt)
    off[px] = ((px / g.f) * g.Wp + px % g.f) * g.lb;
  load_slab(smem + o.rs, a.resid, g.C * g.Hp * g.Wp, g);
  load_slab(smem + o.ws, a.w, g.Hp * g.Wp, g);
  load_slab(smem + o.cl, a.clean, g.C * g.Yc * g.Xc, g);
}

// Row-group partials of lin over the slab (classic K1's patch_partials with
// its warps as threads): pool[(item * S + s) * nw + r] for every item
// (chain, spaxel, slab wavelength) of the step and r < nw; spaxels whose
// `on` is 0 are skipped when `skip_off`.
template <int kS>
__device__ __forceinline__ void slab_partials(const Resident& g,
                                              const float* smem,
                                              const ResidentLayout& o,
                                              const int* geo, float* pool,
                                              const float* on, bool skip_off) {
  const float* img = smem + o.img;
  const int items = g.ncs * g.nl;
  const size_t row = static_cast<size_t>(g.Wp) * g.lb;
  for (int t = threadIdx.x; t < items * g.nw; t += blockDim.x) {
    const int item = t / g.nw, r = t - item * g.nw;
    const int cs = item / g.nl, j = item - cs * g.nl;
    if (skip_off && on[cs] == 0.0f) continue;
    const Geo e = geo_of(geo, cs);
    const float* rp = smem + o.rs + e.rb + j;
    const float* wp = smem + o.ws + e.wb + j;
    float pooled[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) pooled[s] = 0.0f;
    for (int dy = r; dy < g.f; dy += g.nw) {
      const float* rr = rp + dy * row;
      const float* wr = wp + dy * row;
      const float* im = img + dy * g.f;
      for (int dx = 0; dx < g.f; ++dx) {
        const float rw = __fmul_rn(rr[dx * g.lb], wr[dx * g.lb]);
#pragma unroll
        for (int s = 0; s < kS; ++s)
          if (s < g.S) pooled[s] = pool_term(pooled[s], im[s * g.ff + dx], rw);
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (s < g.S) pool[(item * g.S + s) * g.nw + r] = pooled[s];
  }
}

// lin of one item from its partials (classic K1's partials_to_lin).
__device__ __forceinline__ float slab_lin(const Resident& g, const float* pool,
                                          const float* spec_s, int item,
                                          int j) {
  float lin = 0.0f;
  for (int s = 0; s < g.S; ++s) {
    float p = 0.0f;
#pragma unroll 6
    for (int r = 0; r < g.nw; ++r)
      p = __fadd_rn(p, pool[(item * g.S + s) * g.nw + r]);
    lin = lin_term(lin, spec_s[s * g.lb + j], p);
  }
  return lin;
}

// resid -= patch(gsl) on the slab for every item whose `on` is set
// (classic K1's patch_commit and commit_term for kS >= S): a warp per
// item, lanes over patch pixels.
template <int kS>
__device__ __forceinline__ void slab_commit(const Resident& g, float* smem,
                                            const ResidentLayout& o,
                                            const int* geo, const float* gsl,
                                            const float* on) {
  const int* off = reinterpret_cast<const int*>(smem + o.off);
  const int lane = threadIdx.x & 31, nwb = blockDim.x >> 5;
  const int items = g.ncs * g.nl;
  for (int item = threadIdx.x >> 5; item < items; item += nwb) {
    const int cs = item / g.nl, j = item - cs * g.nl;
    if (on[cs] == 0.0f) continue;
    float gs[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s)
      gs[s] = s < g.S ? __fmul_rn(smem[o.spec + s * g.lb + j], gsl[item]) : 0.0f;
    float* r = smem + o.rs + geo[kGeo * cs] + j;
    const float* img = smem + o.img;
    for (int px = lane; px < g.ff; px += 32) {
      float delta = 0.0f;
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (s < g.S) delta = __fmaf_rn(gs[s], img[s * g.ff + px], delta);
      r[off[px]] = __fsub_rn(r[off[px]], delta);
    }
  }
}

// kS: a compile-time bound on the FSF rank (1, or kMaxRank for any S);
// kPos: positivity.
template <int kS, bool kPos>
__global__ void __launch_bounds__(kResidentThreads, 1)
    resident_mh_kernel(ResidentArgs a) {
  extern __shared__ float smem[];
  PHASE_CLOCKS_BEGIN;
  cg::grid_group grid = cg::this_grid();
  const Resident g(a);
  const ResidentLayout o =
      resident_layout(false, kPos, a.C, a.f, a.ny, a.nx, a.L, a.S, a.lw,
                      a.lam_b);
  const uint32_t* key = reinterpret_cast<const uint32_t*>(smem + o.key);
  const int* geo_all = reinterpret_cast<const int*>(smem + o.geo);
  float *cls = smem + o.cl, *spec_s = smem + o.spec;
  float *pool = smem + o.pool, *gsl = smem + o.g, *lsmap = smem + o.lsmap;
  float *qd = smem + o.quad, *lsf = smem + o.lsf, *jmp = smem + o.jump;
  float *acc = smem + o.acc, *u2s = smem + o.u2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwb = nt >> 5;
  const int L = g.L, half = g.half, lw = g.lw, nx = a.nx;
  const int jst = g.lb + lw - 1, hw = g.nl + lw - 1;   // jumps + halo
  const int items = g.ncs * g.nl;

  load_common(a, g, o, smem);
  load_slab(qd, a.quad, g.Yc * g.Xc, g);
  for (int k = tid; k < g.nl * lw; k += nt) lsf[k] = a.lsf[g.l0 * lw + k];
  for (int k = tid; k < g.C * g.Yc * g.Xc; k += nt) lsmap[k] = a.log_scale[k];

  for (int c = 0; c < g.n_colors; ++c) {
    float* shares = a.scratch + static_cast<size_t>(c & 1) * g.ncs * L;
    const int* geo = geo_all + kGeo * c * g.ncs;
    const float* vt = smem + o.vt + c * g.ncs;
    __syncthreads();                         // the previous color is done
    PHASE(0);                                // the previous color's commit
    // (1) row-group partials of lin (the low threads) and (2) the jumps of
    // the slab and its LSF halo and the accept uniforms (the high ones)
    slab_partials<kS>(g, smem, o, geo, pool, acc, false);
    for (int t = nt - 1 - tid; t < g.ncs * (hw + 1); t += nt) {
      if (t >= g.ncs * hw) {                 // an accept uniform
        const int cs = t - g.ncs * hw;
        const Geo e = geo_of(geo, cs);
        const size_t out =
            static_cast<size_t>(e.ch * g.n_colors + c) * g.nij + e.ij;
        u2s[cs] = a.uniforms ? a.uniforms[out * (L + 1) + L]
                             : accept_uniform(key[2 * e.ch], key[2 * e.ch + 1],
                                              a.sweep, c, e.ij);
        continue;
      }
      const int cs = t / hw, k = t - cs * hw;
      const int m = g.l0 - half + k;
      float jump = 0.0f;
      if (m >= 0 && m < L) {
        const Geo e = geo_of(geo, cs);
        const size_t ubase =
            (static_cast<size_t>(e.ch * g.n_colors + c) * g.nij + e.ij) * (L + 1);
        const float u = a.uniforms ? a.uniforms[ubase + m]
                                   : jump_uniform(key[2 * e.ch], key[2 * e.ch + 1],
                                                  a.sweep, c, e.ij, m);
        if (a.uniforms_out && k >= half && k < half + g.nl)
          a.uniforms_out[ubase + m] = u;
        const float scale = expf(lsmap[e.ch * g.Yc * g.Xc + e.sp]);
        jump = mh_jump(u, scale, vt[cs]);
        if (kPos)
          jump = reflect(jump, a.clean[(static_cast<size_t>(e.ch) * g.Yc * g.Xc +
                                        e.sp) * L + m]);
      }
      jmp[cs * jst + k] = jump;
    }
    __syncthreads();
    PHASE(1);                                // partials, jumps
    // (3) lin, g and the dchi2 share of every slab wavelength
    for (int item = tid; item < items; item += nt) {
      const int cs = item / g.nl, j = item - cs * g.nl;
      const Geo e = geo_of(geo, cs);
      const float lin = slab_lin(g, pool, spec_s, item, j);
      float gg = 0.0f;
#pragma unroll 4
      for (int d = 0; d < lw; ++d)
        gg = band_term(gg, lsf[j * lw + d], jmp[cs * jst + j + d]);
      gsl[item] = gg;
      shares[static_cast<size_t>(cs) * L + g.l0 + j] =
          mh_share(gg, qd[e.sp * g.lb + j], lin);
    }
    PHASE(2);                                // lin, g, shares
    grid.sync();
    PHASE(3);                                // the grid barrier
    // (4) every block: dchi2 and the decision of every (chain, spaxel), a
    // warp each, in classic K1's order.  Lane l reads wavelength 32 q + l
    // of each of 32 chunks q into registers (zero past L).  Five exchange
    // steps reduce the 32 chunks at once: at offset off a lane keeps the
    // half of its chunk slots that its bit off selects and adds lane
    // l ^ off's values of them, so after offset 1 lane q holds chunk q's
    // sum.  Each chunk meets the same pairs at the same levels as in
    // warp_sum's shuffle-down tree (classic K1's), so its sum has the same
    // bits; 31 shuffles for 32 chunks, where warp_sum takes 6 for each.
    // Lane q adds chunk q's sum, then chunk q + 32's; warp_sum of the
    // lanes gives dchi2
    for (int cs = warp; cs < g.ncs; cs += nwb) {
      const float* sh = shares + static_cast<size_t>(cs) * L;
      float dchi = 0.0f;
      for (int q0 = 0; q0 < g.P; q0 += 32) {   // chunks q0 .. q0 + 31
        float v[32];                           // every load in flight
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int l = (q0 + i) * kChunk + lane;
          v[i] = l < L ? sh[l] : 0.0f;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const bool up = (lane & off) != 0;
#pragma unroll
          for (int i = 0; i < off; ++i) {
            const float send = up ? v[i] : v[i + off];
            const float keep = up ? v[i + off] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        if (q0 + lane < g.P) dchi += v[0];
      }
      dchi = warp_sum(dchi);
      const Geo e = geo_of(geo, cs);
      const size_t out = static_cast<size_t>(e.ch * g.n_colors + c) * g.nij + e.ij;
      const float u2 = u2s[cs];
      const float v = vt[cs];
      const bool ok = (logf(u2) < -0.5f * dchi) && (v > 0.0f);
      if (lane == 0) {
        const float accf = ok ? 1.0f : 0.0f;
        acc[cs] = accf;
        // every block keeps the same log-scales; block 0 writes them out
        float* ls = lsmap + e.ch * g.Yc * g.Xc + e.sp;
        *ls = log_scale_step(*ls, a.adapt, accf, a.target, v);
        if (blockIdx.x == 0) {
          if (a.uniforms_out) a.uniforms_out[out * (L + 1) + L] = u2;
          a.out_a[out] = accf;
          a.dchi_out[out] = dchi;
          a.log_scale[e.ch * g.Yc * g.Xc + e.sp] = *ls;
        }
      }
    }
    __syncthreads();
    PHASE(4);                                // dchi2, decision
    // (5) commit the accepted spaxels on the slab
    slab_commit<kS>(g, smem, o, geo, gsl, acc);
    for (int item = tid; item < items; item += nt) {
      const int cs = item / g.nl, j = item - cs * g.nl;
      if (acc[cs] == 0.0f) continue;
      float* cl = cls + geo[kGeo * cs + 2] + j;
      *cl = __fadd_rn(*cl, jmp[cs * jst + half + j]);
    }
  }
  __syncthreads();
  store_slab(a.resid, smem + o.rs, g.C * g.Hp * g.Wp, g);
  store_slab(a.clean, cls, g.C * g.Yc * g.Xc, g);
  PHASE_CLOCKS_END;
}

template <int kS, bool kPos>
__global__ void __launch_bounds__(kResidentThreads, 1)
    resident_gibbs_kernel(ResidentArgs a) {
  extern __shared__ float smem[];
  PHASE_CLOCKS_BEGIN;
  cg::grid_group grid = cg::this_grid();
  const Resident g(a);
  const ResidentLayout o =
      resident_layout(true, kPos, a.C, a.f, a.ny, a.nx, a.L, a.S, a.lw,
                      a.lam_b);
  const uint32_t* key = reinterpret_cast<const uint32_t*>(smem + o.key);
  const int* geo_all = reinterpret_cast<const int*>(smem + o.geo);
  float *cls = smem + o.cl, *spec_s = smem + o.spec;
  float *pool = smem + o.pool, *lin0 = smem + o.lin, *gsl = smem + o.g;
  float *lsfw = smem + o.lsf, *red = smem + o.red;
  const int wd = o.wd;
  float* wlin = smem + o.win;                            // the window: lin,
  float* wq = wlin + static_cast<size_t>(g.ncs) * wd;    // quad,
  float* wqv = wq + static_cast<size_t>(g.ncs) * wd;     // qvox,
  float* wnj = wqv + static_cast<size_t>(g.ncs) * wd;    // normals -> jumps,
  float* wg = wnj + static_cast<size_t>(g.ncs) * wd;     // gacc,
  float* wu2 = wg + static_cast<size_t>(g.ncs) * wd;     // (positivity) log u2,
  float* wcl = wu2 + static_cast<size_t>(g.ncs) * wd;    // starting clean
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwb = nt >> 5;
  const int L = g.L, half = g.half, lw = g.lw, nx = a.nx;
  const int wlo = max(0, g.l0 - window_lo_margin(lw));
  const int whi = min(L, g.l0 + g.nl + window_hi_margin(lw));
  const int wn = whi - wlo;
  // warps per (chain, spaxel) in the phase loop, and groups of them
  const int G = max(1, nwb / g.ncs), groups = min(nwb / G, kMaxGroups);
  const int items = g.ncs * g.nl;
  const size_t per_color = static_cast<size_t>(g.ncs) * L;
  float* terms = a.scratch + 2 * per_color;                  // [f^2, cs, L]
  float* lo_terms = terms + g.n_colors * per_color;          // quad_lo part

  load_common(a, g, o, smem);
  for (int k = tid; k < wn * lw; k += nt) lsfw[k] = a.lsf[wlo * lw + k];

  for (int c = 0; c < g.n_colors; ++c) {
    float* lins = a.scratch + static_cast<size_t>(c & 1) * per_color;
    const int* geo = geo_all + kGeo * c * g.ncs;
    const float* on = smem + o.vt + c * g.ncs;    // valid (chain, spaxel)s
    __syncthreads();                         // the previous color is done
    PHASE(0);                                // the previous color's commit
    // (a) lin over the slab (valid spaxels)
    slab_partials<kS>(g, smem, o, geo, pool, on, true);
    __syncthreads();
    PHASE(1);                                // partials
    for (int item = tid; item < items; item += nt) {
      const int cs = item / g.nl, j = item - cs * g.nl;
      if (on[cs] == 0.0f) continue;
      const float lin = slab_lin(g, pool, spec_s, item, j);
      lin0[item] = lin;
      lins[static_cast<size_t>(cs) * L + g.l0 + j] = lin;
    }
    PHASE(2);                                // lin
    grid.sync();
    PHASE(3);                                // the grid barrier
    // (b) the lw phases over the window
    for (int t = tid; t < g.ncs * wn; t += nt) {
      const int cs = t / wn, k = t - cs * wn, l = wlo + k;
      const Geo e = geo_of(geo, cs);
      const size_t out = static_cast<size_t>(e.ch * g.n_colors + c) * g.nij + e.ij;
      float u1, u2;
      if (a.uniforms) {
        u1 = a.uniforms[out * 2 * L + l];
        u2 = a.uniforms[out * 2 * L + L + l];
      } else {
        u1 = lambda_uniform(key[2 * e.ch], key[2 * e.ch + 1], a.sweep, c,
                            e.ij, l, kStreamNormalU1);
        u2 = lambda_uniform(key[2 * e.ch], key[2 * e.ch + 1], a.sweep, c,
                            e.ij, l, kStreamNormalU2);
      }
      if (a.uniforms_out && l >= g.l0 && l < g.l0 + g.nl) {
        a.uniforms_out[out * 2 * L + l] = u1;
        a.uniforms_out[out * 2 * L + L + l] = u2;
      }
      if (on[cs] == 0.0f) continue;          // frozen spaxel: no draws
      const size_t wi = static_cast<size_t>(cs) * wd + k;
      wlin[wi] = lins[static_cast<size_t>(cs) * L + l];
      wq[wi] = a.quad[static_cast<size_t>(e.sp) * L + l];
      wqv[wi] = a.qvox[static_cast<size_t>(e.sp) * L + l];
      if (kPos) {
        wnj[wi] = u1;
        wu2[wi] = logf(u2);
        wcl[wi] = a.clean[(static_cast<size_t>(e.ch) * g.Yc * g.Xc + e.sp) * L + l];
      } else {
        wnj[wi] = box_muller(u1, u2);
      }
      wg[wi] = 0.0f;
    }
    __syncthreads();
    PHASE(4);                                // window
    // a group of G warps runs the phases of one (chain, spaxel) over the
    // window (named barrier 1 + group; one warp: __syncwarp)
    if (warp < groups * G) {
      const int gi = warp / G, gt = tid - gi * G * 32, tg = G * 32;
      const int dstep = tg % lw;
      for (int cs = gi; cs < g.ncs; cs += groups) {
        if (on[cs] == 0.0f) continue;
        float *wl = wlin + cs * wd, *q_ = wq + cs * wd, *qv = wqv + cs * wd;
        float *nj = wnj + cs * wd, *ga = wg + cs * wd;
        const float *lu2 = wu2 + cs * wd, *cl_ = wcl + cs * wd;
        // phase ph draws window index first + i lw, first = (ph - wlo) mod
        // lw; at window index k its update reads the phase voxel k - half +
        // r, r = (ph - (wlo + k - half)) mod lw: both step by one per phase
        int first = ((-wlo) % lw + lw) % lw;
        int r0 = ((half - wlo - gt) % lw + lw) % lw;
        for (int ph = 0; ph < lw; ++ph) {
          for (int k = first + gt * lw; k < wn; k += tg * lw) {
            const float q = qv[k];
            float jump = 0.0f;
            if (q > 0.0f) {
              // linT = sum_d lsf[mu, d] lin[mu], mu = k + half - d
              const int d0 = max(0, k + half - (wn - 1)), d1 = min(lw, k + half + 1);
              const float* lp = lsfw + (k + half - d0) * lw + d0;
              const float* np = wl + (k + half - d0);
              float linT = 0.0f;
#pragma unroll 4
              for (int d = d0; d < d1; ++d, lp -= lw - 1, --np)
                linT = band_term(linT, *lp, *np);
              jump = kPos ? truncated_jump(linT, fmaxf(q, 1.0e-30f), cl_[k],
                                           nj[k], lu2[k])
                          : gibbs_jump(linT, fmaxf(q, 1.0e-30f), nj[k]);
            }
            nj[k] = jump;
          }
          group_sync(gi, G);
          // g of the phase's jumps, and lin <- lin - g * quad
          for (int k = gt, r = r0; k < wn; k += tg) {
            const int kl = k - half + r;
            if (kl >= 0 && kl < wn) {
              const float gg = __fmul_rn(lsfw[k * lw + r], nj[kl]);
              wl[k] = lin_after(wl[k], gg, q_[k]);
              ga[k] = __fadd_rn(ga[k], gg);
            }
            r -= dstep;
            if (r < 0) r += lw;
          }
          group_sync(gi, G);
          if (++first == lw) first = 0;
          if (++r0 == lw) r0 = 0;
        }
      }
    }
    __syncthreads();
    PHASE(5);                                // the lw phases
    // (c) the slab: dchi2 terms, clean += jumps, resid -= patch(gacc)
    for (int item = tid; item < items; item += nt) {
      const int cs = item / g.nl, j = item - cs * g.nl, l = g.l0 + j;
      if (on[cs] == 0.0f) continue;
      const Geo e = geo_of(geo, cs);
      const size_t wi = static_cast<size_t>(cs) * wd + (l - wlo);
      const float gacc = wg[wi];
      const size_t ti = c * per_color + static_cast<size_t>(cs) * L + l;
      terms[ti] = gibbs_dchi_term(gacc, wq[wi], lin0[item]);
      if (a.quad_lo)
        lo_terms[ti] = gibbs_dlo_term(gacc, a.quad_lo[static_cast<size_t>(e.sp) * L + l]);
      cls[e.cb + j] = __fadd_rn(cls[e.cb + j], wnj[wi]);
      gsl[item] = gacc;
    }
    __syncthreads();
    PHASE(6);                                // dchi2 terms, clean
    slab_commit<kS>(g, smem, o, geo, gsl, on);
  }
  grid.sync();
  // the tail: dchi2 and voxel count of every (color, chain, spaxel), summed
  // in classic (b)'s order (this block's threads are classic's)
  for (int task = blockIdx.x; task < g.n_colors * g.ncs; task += gridDim.x) {
    const int c = task / g.ncs, cs = task - c * g.ncs;
    const Geo e = geo_of(geo_all + kGeo * c * g.ncs, cs);
    const int sp = e.sp;
    const size_t out = static_cast<size_t>(e.ch * g.n_colors + c) * g.nij + e.ij;
    if (smem[o.vt + task] == 0.0f) {         // frozen spaxel: no draws
      if (tid == 0) a.out_a[out] = a.dchi_out[out] = 0.0f;
      continue;
    }
    const float* tr = terms + c * per_color + static_cast<size_t>(cs) * L;
    const float* lr = lo_terms + c * per_color + static_cast<size_t>(cs) * L;
    const float* qv = a.qvox + static_cast<size_t>(sp) * L;
    float dchi = 0.0f, dlo = 0.0f, live = 0.0f;
    for (int l = tid; l < L; l += nt) {
      dchi = __fadd_rn(dchi, tr[l]);
      if (a.quad_lo) dlo = __fadd_rn(dlo, lr[l]);
      if (qv[l] > 0.0f) live += 1.0f;
    }
    dchi = warp_sum(dchi);
    live = warp_sum(live);
    dlo = warp_sum(dlo);
    if (lane == 0) {
      red[warp] = dchi;
      red[nwb + warp] = live;
      red[2 * nwb + warp] = dlo;
    }
    __syncthreads();
    if (tid == 0) {
      float sd = 0.0f, sl = 0.0f, so = 0.0f;
      for (int r = 0; r < nwb; ++r) {
        sd += red[r];
        sl += red[nwb + r];
        so += red[2 * nwb + r];
      }
      a.dchi_out[out] = sd + so;
      a.out_a[out] = sl;
    }
    __syncthreads();
  }
  store_slab(a.resid, smem + o.rs, g.C * g.Hp * g.Wp, g);
  store_slab(a.clean, cls, g.C * g.Yc * g.Xc, g);
  PHASE_CLOCKS_END;
}

// n grid barriers and nothing else: the cost of one barrier of a grid.
__global__ void resident_barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// Launch `kernel` cooperatively on exactly `blocks` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory; refuses what cannot
// be co-resident.
template <typename Kernel>
inline int launch_exact(Kernel kernel, void** params, int blocks, int threads,
                        size_t smem, cudaStream_t stream) {
  cudaError_t e;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin) || blocks < 1 || blocks > sms)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                         smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(static_cast<unsigned>(blocks)),
                                  dim3(threads), params, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
inline int launch_resident(Kernel kernel, ResidentArgs* a, bool gibbs,
                           bool pos, cudaStream_t stream) {
  if (const int e = check_dims(a->C, a->L, a->f, a->ny, a->nx, a->S, a->lw,
                               a->ny, a->nx))
    return e;
  if (a->lam_b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ResidentLayout o = resident_layout(gibbs, pos, a->C, a->f, a->ny,
                                           a->nx, a->L, a->S, a->lw, a->lam_b);
  const int nw = a->f < kMaxWarps ? a->f : kMaxWarps;
  void* params[] = {a};
  return launch_exact(kernel, params, (a->L + a->lam_b - 1) / a->lam_b,
                      32 * nw, o.total * sizeof(float), stream);
}

}  // namespace deconv3d

extern "C" {

#ifdef RESIDENT_PHASE_CLOCKS
// Copy out and clear the phase clocks of a measurement build.
int resident_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, deconv3d::resident_clocks,
                                       8 * sizeof(unsigned long long));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[8] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(deconv3d::resident_clocks, zero,
                                             sizeof(zero)));
}
#endif

// Floats of global scratch one resident sweep needs: MH the per-wavelength
// dchi2 shares of one color (two halves), gibbs lin of one color (two
// halves) and the per-wavelength dchi2 and quad_lo terms of every color.
long long resident_mh_scratch_floats(int C, int L, int f, int ny, int nx) {
  return 2LL * C * ny * nx * L;
}
long long resident_gibbs_scratch_floats(int C, int L, int f, int ny, int nx) {
  return 2LL * C * ny * nx * L * (1LL + static_cast<long long>(f) * f);
}

// Dynamic shared memory (bytes) of one resident block; ops/resident.py
// smem_bytes must agree.  `mode`: bit 0 gibbs (else MH), bit 1 positivity.
long long resident_smem_bytes(int mode, int C, int f, int ny, int nx, int L,
                              int S, int lw, int lam_b) {
  return static_cast<long long>(
      deconv3d::resident_layout((mode & 1) != 0, (mode & 2) != 0, C, f, ny, nx,
                                L, S, lw, lam_b).total *
      sizeof(float));
}

// Launch one sweep of C chains on `stream` over ceil(L / lam_b) blocks;
// `positivity` as in mh_sweep_launch / gibbs_sweep_launch.  Returns a
// cudaError_t (0 on success), checked right after the launch.
int resident_mh_launch(float* resid, const float* w, const float* quad,
                       float* clean, float* log_scale, const float* valid,
                       const float* spec, const float* imgs, const float* lsf,
                       const unsigned* keys, const float* uniforms,
                       float* accept_out, float* dchi_out, float* uniforms_out,
                       float* scratch, int C, int L, int f, int ny, int nx,
                       int S, int lw, int lam_b, int positivity,
                       unsigned sweep, float adapt, float target,
                       void* stream) {
  using namespace deconv3d;
  ResidentArgs a{resid, w, quad, nullptr, nullptr, clean, log_scale, valid,
                 spec, imgs, lsf, keys, uniforms, accept_out, dchi_out,
                 uniforms_out, scratch, C, L, f, ny, nx, S, lw, lam_b, sweep,
                 adapt, target};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_variant(a.S, positivity != 0, [&](auto rank, auto pos) {
    return launch_resident(
        resident_mh_kernel<decltype(rank)::value, decltype(pos)::value>, &a,
        false, pos, st);
  });
}

int resident_gibbs_launch(float* resid, const float* w, const float* quad,
                          const float* quad_lo, const float* qvox, float* clean,
                          const float* valid, const float* spec,
                          const float* imgs, const float* lsf,
                          const unsigned* keys, const float* uniforms,
                          float* live_out, float* dchi_out, float* uniforms_out,
                          float* scratch, int C, int L, int f, int ny, int nx,
                          int S, int lw, int lam_b, int positivity,
                          unsigned sweep, void* stream) {
  using namespace deconv3d;
  ResidentArgs a{resid, w, quad, quad_lo, qvox, clean, nullptr, valid, spec,
                 imgs, lsf, keys, uniforms, live_out, dchi_out, uniforms_out,
                 scratch, C, L, f, ny, nx, S, lw, lam_b, sweep, 0.0f, 0.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_variant(a.S, positivity != 0, [&](auto rank, auto pos) {
    return launch_resident(
        resident_gibbs_kernel<decltype(rank)::value, decltype(pos)::value>,
        &a, true, pos, st);
  });
}

// n grid barriers on `blocks` blocks of `threads` threads holding `smem`
// bytes each (a resident launch's grid): timed against n = 0, the cost of
// one barrier.
int resident_barrier_launch(int blocks, int threads, long long smem, int n,
                            void* stream) {
  void* params[] = {&n};
  return deconv3d::launch_exact(deconv3d::resident_barrier_kernel, params,
                                blocks, threads, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"

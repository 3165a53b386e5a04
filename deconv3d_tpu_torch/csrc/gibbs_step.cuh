// One exact-Gibbs step of the color-decomposed sweep: every chain's spaxels
// of one Step (a color over the whole field in gibbs_sweep.cu, a color
// inside the tiles of one wave in tiled_sweep.cu), with its three grid
// barriers.
//
//   (a) lin   every (chain, spaxel, 32-wavelength chunk) task: the patch
//             contraction out of the ring of asynchronous copies
//             (sweep_common.cuh) on the row warps, while one service warp
//             asks for the next patches and the other sums the previous
//             task's lin to scratch
//   --- grid barrier ---
//   (b) draws every (chain, spaxel, wavelength slab) task: one block runs
//             the lw phases over the slab's window [a - 2(lw-1), b +
//             lw(lw-1)) in shared memory (lin, quad, qvox, the normals that
//             each phase overwrites with its jumps, and gacc), linT and g
//             reaching +-lw/2 around each live voxel.  A window edge's
//             error moves inwards by at most lw - 1 per phase -- and by 1
//             at the lower edge, since phase ph draws lambda = ph (mod lw)
//             -- so the slab's jumps and g are the full spectrum's bit for
//             bit (ops/resident.py window_margins).  The block adds its
//             slab's jumps into clean and writes gacc and the per-wavelength
//             dchi2 terms.  One slab of lam_b = L is the whole spectrum on
//             one block; lam_b spreads a step of few spaxels over the card.
//   --- grid barrier ---
//   (c) commit every (chain, spaxel): dchi2 from the terms, summed in a
//             fixed order (thread-strided over the block, lanes, warps),
//             and the live count; every (chain, spaxel, chunk) task:
//             resid -= patch(gacc), the patch streamed through the ring
//   --- grid barrier ---
//
// Positivity (kPos, a compile-time flag: the flag-off code is unchanged)
// draws each voxel from its conditional truncated to clean >= 0
// (truncated_jump) from the same two uniforms.  Its mean depends on the
// voxel's clean, so the window also keeps the uniforms (u1, log u2) and
// the step's starting clean (7 arrays, not 5), read from global memory in
// (b); and since the windows of a spaxel's slabs overlap, (b) writes the
// slab's jumps to scratch and (c) adds them to clean, after every window
// is read.
//
// A task's arithmetic depends neither on the chain batch nor on the step's
// extent, nor on lam_b (see mh_step.cuh).
#pragma once

#include "philox.cuh"
#include "sweep_common.cuh"

namespace deconv3d {

// The per-element arithmetic of a gibbs visit (explicit roundings; shared
// with the resident kernel, resident_sweep.cu).
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(2.0f * kPi, u2)));
}
// a live voxel's draw from N(linT / q, 1 / q), qs = max(q, 1e-30)
__device__ __forceinline__ float gibbs_jump(float linT, float qs, float n) {
  return __fmaf_rn(n, rsqrtf(qs), __fdiv_rn(linT, qs));
}
// lin at mu after the phase's g (= lsf * jump): lin - g quad
__device__ __forceinline__ float lin_after(float lin, float g, float q) {
  return __fmaf_rn(-g, q, lin);
}
// the color's dchi2 at one wavelength, and its quad_lo part
__device__ __forceinline__ float gibbs_dchi_term(float ga, float q, float lin0) {
  return __fsub_rn(__fmul_rn(__fmul_rn(ga, ga), q),
                   __fmul_rn(__fmul_rn(2.0f, ga), lin0));
}
__device__ __forceinline__ float gibbs_dlo_term(float ga, float qlo) {
  return __fmul_rn(__fmul_rn(ga, ga), qlo);
}

// Positivity: z ~ N(0, 1) truncated to z >= alpha from two uniforms, as
// ops/truncnorm.py computes it: the inverse CDF for alpha <= 2; above, the
// excess d = z - alpha of the root of log Phi(-z) = log Phi(-alpha) +
// log u_tail, from d0 = -2 log u / (alpha + sqrt(alpha^2 - 2 log u)) by
// kTailSteps Newton steps on F(d) = E(alpha + d) - E(alpha) - d (alpha +
// d/2) - log u, E(z) = log erfcx(z / sqrt 2), each multiplying by erfcx
// where it would divide by the hazard.  erfcx neither saturates nor
// cancels in float32 at any alpha.  The sweeps draw through
// truncated_jump, with log u_tail taken at the window fill; every kernel
// calls it, so their draws stay bit-equal.
constexpr float kTailSwitch = 2.0f;
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kSqrtPiOver2 = 1.2533141373155003f;
constexpr int kTailSteps = 2;
// d = z - alpha of the tail draw, alpha > 2 (truncnorm.py tail_excess)
__device__ __forceinline__ float tail_excess(float alpha, float log_u) {
  const float z0 = sqrtf(__fsub_rn(__fmul_rn(alpha, alpha),
                                   __fmul_rn(2.0f, log_u)));
  float d = __fdiv_rn(__fmul_rn(-2.0f, log_u), __fadd_rn(alpha, z0));
  const float e_alpha = logf(erfcxf(__fmul_rn(alpha, kSqrtHalf)));
#pragma unroll
  for (int i = 0; i < kTailSteps; ++i) {
    const float ez = erfcxf(__fmul_rn(__fadd_rn(alpha, d), kSqrtHalf));
    const float f = __fsub_rn(
        __fsub_rn(__fsub_rn(logf(ez), e_alpha),
                  __fmul_rn(d, __fadd_rn(alpha, __fmul_rn(0.5f, d)))),
        log_u);
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(f, ez), kSqrtPiOver2));
  }
  return d;
}
// z of the body draw, alpha <= 2: p may round to 1, capped at alpha + 9
__device__ __forceinline__ float body_normal(float alpha, float u_body) {
  const float cdf = normcdff(alpha);
  const float p = __fadd_rn(cdf, __fmul_rn(u_body, __fsub_rn(1.0f, cdf)));
  return fminf(normcdfinvf(p), __fadd_rn(alpha, 9.0f));
}
// z itself (truncnorm.py transform_uniforms; the elementwise check kernel)
__device__ __forceinline__ float trunc_normal(float alpha, float u_body,
                                              float u_tail) {
  return alpha > kTailSwitch
             ? __fadd_rn(alpha, tail_excess(alpha, logf(u_tail)))
             : body_normal(alpha, u_body);
}
// a live voxel's positivity draw as a jump from its clean `cur`, qs =
// max(q, 1e-30) (ops/sweep.py truncated_jump): c' = sigma d ~ N(mu, 1 / qs)
// truncated to c' >= 0, mu = cur + linT / qs, sigma = rsqrt(qs), and c'
// clamped at 0, where float32 rounding can land a hair below it
__device__ __forceinline__ float truncated_jump(float linT, float qs,
                                                float cur, float u1,
                                                float log_u2) {
  const float sig = rsqrtf(qs);
  // alpha = -mu / sigma as -sigma (cur qs + linT): no division
  const float alpha = __fmul_rn(-sig, __fadd_rn(__fmul_rn(cur, qs), linT));
  // the excess d = z - alpha of either region (truncnorm.py excess)
  const float d = alpha > kTailSwitch
                      ? tail_excess(alpha, log_u2)
                      : __fsub_rn(body_normal(alpha, u1), alpha);
  return __fsub_rn(fmaxf(__fmul_rn(sig, d), 0.0f), cur);
}

struct GibbsArgs {
  float* resid;            // [C, Hp, Wp, Ls] (the first L of a row are data)
  const __nv_bfloat16* w;  // [Hp, Wp, Ls] (bfloat16 values: exact)
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
  float* scratch;          // [5 * C * spaxels of the largest step * L]:
                           // lin, gacc, dchi2 terms, quad_lo terms, jumps
                           // (positivity)
  const int* wave_start;   // [n_waves + 1] into wave_tiles (tiled kernel)
  const int* wave_tiles;   // raster indices of every wave's tiles
  int C, L, Ls, f, ny, nx, S, lw;
  int nyt, nxt;            // block rows / columns of a tile
  int n_waves;
  int stages;              // ring stages (0: synchronous loads)
  int lam_b;               // wavelengths per slab of phase (b)
  int max_spaxels;         // (chain, spaxel)s of the largest step
  uint32_t sweep;
  int by0;                 // tiled band launch: its first carried block row
  int ij0;                 // the field's spaxel row of carried row 0
};

__host__ __device__ inline int gibbs_window_lo(int lw) { return 2 * (lw - 1); }
__host__ __device__ inline int gibbs_window_hi(int lw) { return lw * (lw - 1); }
// widest window of a slab of lam_b wavelengths
__host__ __device__ inline int gibbs_window(int L, int lw, int lam_b) {
  const int wd = lam_b + gibbs_window_lo(lw) + gibbs_window_hi(lw);
  return wd < L ? wd : L;
}
// arrays of phase (b)'s window: lin, quad, qvox, normals/jumps, gacc, and
// with positivity the second uniforms and the starting clean
__host__ __device__ inline int gibbs_window_arrays(bool pos) {
  return pos ? 7 : 5;
}

// Shared memory of one block: the ring's barriers, FSF images, per-warp
// pooled partials (two buffers: warp 0 finishes task i while the others
// fill task i + 1), block sums, Philox keys; then the ring of (a) and (c),
// which is also (b)'s window: lin, quad, qvox, normals/jumps and gacc, 5 x
// the window's width (7 with positivity).
struct GibbsShared {
  float* img;              // [S * f * f]
  float* pool;             // [2][nw * S * kChunk]
  float* red;              // [3 * nw]
  uint32_t* key;           // [2 * C]
  float* ring;             // [max(stages * ring_stage_floats, 5|7 * window)]
};

__host__ __device__ inline size_t gibbs_fixed_floats(int S, int f, int C) {
  const int nw = row_warps(f);
  return ring_aligned(kBarFloats + static_cast<size_t>(S) * f * f +
                      2 * static_cast<size_t>(nw) * S * kChunk + 3 * nw +
                      2 * static_cast<size_t>(C));
}

// Carve the block's shared memory, set up the ring's barriers and load the
// keys and images.
__device__ __forceinline__ GibbsShared gibbs_shared(const GibbsArgs& a,
                                                    float* smem,
                                                    PatchMaps& maps) {
  const int nw = row_warps(a.f);
  GibbsShared s;
  s.img = smem + kBarFloats;
  s.pool = s.img + a.S * a.f * a.f;
  s.red = s.pool + 2 * nw * a.S * kChunk;
  s.key = reinterpret_cast<uint32_t*>(s.red + 3 * nw);
  s.ring = smem + gibbs_fixed_floats(a.S, a.f, a.C);
  ring_init(smem, maps);
  for (int k = threadIdx.x; k < 2 * a.C; k += blockDim.x) s.key[k] = a.keys[k];
  load_images(s.img, a.imgs, a.S * a.f * a.f);
  return s;
}

template <int kS, bool kPos>
__device__ __forceinline__ void gibbs_step(const GibbsArgs& a,
                                           const GibbsShared& sh,
                                           float* smem, PatchMaps& maps,
                                           const Step& st,
                                           cooperative_groups::grid_group& grid,
                                           TaskClocks& clk) {
  const int L = a.L, Ls = a.Ls, f = a.f, S = a.S, lw = a.lw, half = lw / 2;
  const int nij = a.ny * a.nx, n_colors = f * f;
  const int Yc = a.ny * f, Xc = a.nx * f;
  const int Hp = f - 1 + Yc, Wp = f - 1 + Xc;
  const int P = (L + kChunk - 1) / kChunk;       // chunks per spaxel
  const int nst = st.spaxels();
  const int spaxels = a.C * nst;                 // (chain, spaxel) tasks
  const int tasks = spaxels * P;                 // (chain, spaxel, chunk)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = blockDim.x, nw = nt >> 5, nwv = row_warps(f);
  const int c = st.c;
  const int stages = a.stages;
  const Ring ring(smem, sh.ring, stages, S, f, lw);
  const int npool = nwv * S * kChunk;
  const int mine = block_share(tasks);
  const size_t chain = static_cast<size_t>(Hp) * Wp * Ls;
  const size_t per = static_cast<size_t>(a.max_spaxels) * L;
  float* lin_buf = a.scratch;                     // [spaxels * L]
  float* g_buf = lin_buf + per;
  float* terms = g_buf + per;                     // dchi2 per wavelength
  float* lo_terms = terms + per;                  // its quad_lo part
  float* jump_buf = lo_terms + per;               // the jumps (positivity)
  auto task = [&](int i) {
    return task_of(static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x),
                   P, nst, st, a.nx, f, Xc);
  };

  // ---------------- (a) lin of every (chain, spaxel, chunk) ---------------
  const bool asks = warp == nwv, finishes = warp == nwv + 1;
  // the asking warp's lane 0: the patches of task i into their stage (none
  // for a frozen spaxel, which nobody waits for either)
  auto produce_a = [&](int i) {
    if (asks && lane == 0 && i < mine) {
      const Task k = task(i);
      if (a.valid[k.sp] != 0.0f)
        ring.produce(maps, i % stages, k.l0, k.xs, k.ys, k.ch, true);
    }
  };
  for (int i = 0; i < stages; ++i) produce_a(i);
  clk.mark(0);                                   // decode, first copies
  int nb = 0;                                    // block barriers so far
  for (int i = 0; i < mine; ++i) {
    const Task k = task(i);
    const int slot = stages ? i % stages : 0;
    const int l = k.l0 + lane;
    float* pool = sh.pool + (nb & 1) * npool;
    if (a.valid[k.sp] == 0.0f) {                 // uniform across the block
      if (stages) produce_a(i + stages);
      continue;
    }
    if (stages) ring.consume(maps, slot, warp < nwv);
    clk.mark(2);                                 // waiting for the copies
    if (warp < nwv) {
      if (stages)
        staged_partials<kS>(ring.rs(slot), ring.ws(slot), sh.img, pool, l < L, f, S);
      else
        patch_partials<kS>(a.resid + k.ch * chain, a.w, sh.img, pool,
                       (static_cast<size_t>(k.ys) * Wp + k.xs) * Ls + l, l < L,
                       Wp, Ls, f, S);
    }
    clk.mark(3);                                 // partials
    __syncthreads();       // the partials are whole; the stage is consumed
    ++nb;
    clk.mark(4);                                 // block barrier
    if (stages) produce_a(i + stages);
    if (finishes && l < L)
      lin_buf[static_cast<size_t>(k.cs) * L + l] =
          partials_to_lin<kS>(pool, a.spec + l, L, S, nwv);
    clk.count(12);
  }
  grid.sync();
  clk.mark(6);                                   // grid barrier 1
  // ---------------- (b) the lw phases of every (chain, spaxel, slab) ------
  const int lam_b = a.lam_b, n_slabs = (L + lam_b - 1) / lam_b;
  const int wd = gibbs_window(L, lw, lam_b);
  float* wlin = sh.ring;                          // the window: lin,
  float* wq = wlin + wd;                          // quad,
  float* wqv = wq + wd;                           // qvox,
  float* wnj = wqv + wd;                          // normals -> jumps,
  float* wg = wnj + wd;                           // gacc,
  float* wu2 = wg + wd;                           // (positivity) log u2,
  float* wcl = wu2 + wd;                          // the starting clean
  for (int t = blockIdx.x; t < spaxels * n_slabs; t += gridDim.x) {
    const int cs = t / n_slabs, slab = t - cs * n_slabs;
    const int ch = cs / nst, ij = st.ij(cs - ch * nst, a.nx);
    const int ys = (ij / a.nx) * f + st.cy, xs = (ij % a.nx) * f + st.cx;
    const int sp = ys * Xc + xs;
    const size_t out = static_cast<size_t>(ch * n_colors + c) * nij + ij;
    const int s0 = slab * lam_b, s1 = min(L, s0 + lam_b);   // the slab
    const int wlo = max(0, s0 - gibbs_window_lo(lw));
    const int whi = min(L, s1 + gibbs_window_hi(lw));
    const int wn = whi - wlo;
    const bool valid = a.valid[sp] != 0.0f;      // uniform across the block
    const uint32_t k0 = sh.key[2 * ch], k1 = sh.key[2 * ch + 1];
    const float* lin0 = lin_buf + static_cast<size_t>(cs) * L;
    __syncthreads();                             // the window is reused
    for (int k = threadIdx.x; k < wn; k += nt) {
      const int l = wlo + k;
      float u1, u2;
      if (a.uniforms) {
        u1 = a.uniforms[out * 2 * L + l];
        u2 = a.uniforms[out * 2 * L + L + l];
      } else {
        u1 = lambda_uniform(k0, k1, a.sweep, c, ij + a.ij0, l, kStreamNormalU1);
        u2 = lambda_uniform(k0, k1, a.sweep, c, ij + a.ij0, l, kStreamNormalU2);
      }
      if (a.uniforms_out && l >= s0 && l < s1) {
        a.uniforms_out[out * 2 * L + l] = u1;
        a.uniforms_out[out * 2 * L + L + l] = u2;
      }
      if (!valid) continue;                      // (its lin was never made)
      wlin[k] = lin0[l];
      wq[k] = a.quad[static_cast<size_t>(sp) * L + l];
      wqv[k] = a.qvox[static_cast<size_t>(sp) * L + l];
      if (kPos) {
        wnj[k] = u1;
        wu2[k] = logf(u2);
        wcl[k] = a.clean[(static_cast<size_t>(ch) * Yc * Xc + sp) * L + l];
      } else {
        wnj[k] = box_muller(u1, u2);
      }
      wg[k] = 0.0f;
    }
    __syncthreads();
    clk.mark(7);                                 // window load, normals
    if (!valid) continue;                        // frozen spaxel: no draws
    // phase ph draws window index first + i lw, first = (ph - wlo) mod lw;
    // at window index k its update reads the phase voxel k - half + r,
    // r = (ph - (wlo + k - half)) mod lw: both step by one per phase
    const float* lsfw = a.lsf + static_cast<size_t>(wlo) * lw;
    const int dstep = nt % lw;
    int first = ((-wlo) % lw + lw) % lw;
    int r0 = ((half - wlo - static_cast<int>(threadIdx.x)) % lw + lw) % lw;
    for (int ph = 0; ph < lw; ++ph) {
      // draws of this phase: at most one live voxel in any lw-window
      for (int k = first + threadIdx.x * lw; k < wn; k += nt * lw) {
        const float q = wqv[k];
        float jump = 0.0f;
        if (q > 0.0f) {
          // linT = sum_d lsf[mu, d] lin[mu], mu = k + half - d
          const int d0 = max(0, k + half - (wn - 1)), d1 = min(lw, k + half + 1);
          float linT = 0.0f;
          for (int d = d0; d < d1; ++d) {
            const int mu = k + half - d;
            linT = band_term(linT, lsfw[mu * lw + d], wlin[mu]);
          }
          jump = kPos ? truncated_jump(linT, fmaxf(q, 1.0e-30f), wcl[k], wnj[k],
                                       wu2[k])
                      : gibbs_jump(linT, fmaxf(q, 1.0e-30f), wnj[k]);
        }
        wnj[k] = jump;
      }
      __syncthreads();
      // g of the phase's jumps, and lin <- lin - g * quad
      for (int k = threadIdx.x, r = r0; k < wn; k += nt) {
        const int kl = k - half + r;             // the phase voxel near k
        if (kl >= 0 && kl < wn) {
          const float g = __fmul_rn(lsfw[k * lw + r], wnj[kl]);
          wlin[k] = lin_after(wlin[k], g, wq[k]);
          wg[k] = __fadd_rn(wg[k], g);
        }
        r -= dstep;
        if (r < 0) r += lw;
      }
      __syncthreads();
      if (++first == lw) first = 0;
      if (++r0 == lw) r0 = 0;
    }
    clk.mark(8);                                 // the lw phases
    // the slab: dchi2 terms of the summed jump against lin0, clean, gacc
    const float* qlo =
        a.quad_lo ? a.quad_lo + static_cast<size_t>(sp) * L : nullptr;
    float* clean = a.clean + (static_cast<size_t>(ch) * Yc * Xc + sp) * L;
    for (int l = s0 + threadIdx.x; l < s1; l += nt) {
      const int k = l - wlo;
      const float ga = wg[k];
      terms[static_cast<size_t>(cs) * L + l] =
          gibbs_dchi_term(ga, wq[k], lin0[l]);
      if (qlo)
        lo_terms[static_cast<size_t>(cs) * L + l] = gibbs_dlo_term(ga, qlo[l]);
      if (kPos)              // other slabs' windows still read clean
        jump_buf[static_cast<size_t>(cs) * L + l] = wnj[k];
      else
        clean[l] = __fadd_rn(clean[l], wnj[k]);
      g_buf[static_cast<size_t>(cs) * L + l] = ga;
    }
    clk.mark(9);                                 // terms, clean, gacc
    clk.count(13);
  }
  if (stages) fence_async_proxy();   // the window, before (c)'s copies
  grid.sync();
  clk.mark(10);                                  // grid barrier 2
  // ---------------- (c) dchi2 of every (chain, spaxel); the commit --------
  // task i into its stage: thread 0 asks for the residual patch, every
  // thread copies gacc at its lane's wavelength (one copy group per task)
  auto copy_c = [&](int i) {
    if (i < mine) {
      const Task k = task(i);
      const int slot = i % stages, l = k.l0 + lane;
      if (a.valid[k.sp] != 0.0f) {
        if (threadIdx.x == 0)
          ring.produce(maps, slot, k.l0, k.xs, k.ys, k.ch, false);
        if (l < L)
          cp_async4(ring.own(slot) + threadIdx.x,
                    g_buf + static_cast<size_t>(k.cs) * L + l);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < stages; ++i) copy_c(i);
  // the sums, on the blocks with the fewest commits (the last ones)
  for (int cs = gridDim.x - 1 - blockIdx.x; cs < spaxels; cs += gridDim.x) {
    const int ch = cs / nst, ij = st.ij(cs - ch * nst, a.nx);
    const int ys = (ij / a.nx) * f + st.cy, xs = (ij % a.nx) * f + st.cx;
    const int sp = ys * Xc + xs;
    const size_t out = static_cast<size_t>(ch * n_colors + c) * nij + ij;
    if (a.valid[sp] == 0.0f) {                   // frozen spaxel: no draws
      if (threadIdx.x == 0) a.live_out[out] = a.dchi_out[out] = 0.0f;
      continue;
    }
    const float* tr = terms + static_cast<size_t>(cs) * L;
    const float* lr = lo_terms + static_cast<size_t>(cs) * L;
    const float* qv = a.qvox + static_cast<size_t>(sp) * L;
    // block sums in a fixed order: thread-strided over the row warps'
    // threads, lanes, then warps
    for (int vw = warp; vw < nwv; vw += nw) {
      float dchi = 0.0f, dlo = 0.0f, live = 0.0f;
      for (int l = vw * 32 + lane; l < L; l += 32 * nwv) {
        dchi = __fadd_rn(dchi, tr[l]);
        if (a.quad_lo) dlo = __fadd_rn(dlo, lr[l]);
        if (qv[l] > 0.0f) live += 1.0f;
      }
      dchi = warp_sum(dchi);
      live = warp_sum(live);
      dlo = warp_sum(dlo);
      if (lane == 0) {
        sh.red[vw] = dchi;
        sh.red[nwv + vw] = live;
        sh.red[2 * nwv + vw] = dlo;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sd = 0.0f, sl = 0.0f, so = 0.0f;
      for (int r = 0; r < nwv; ++r) {
        sd += sh.red[r];
        sl += sh.red[nwv + r];
        so += sh.red[2 * nwv + r];
      }
      a.dchi_out[out] = sd + so;
      a.live_out[out] = sl;
    }
    __syncthreads();   // red is reused by the next sum
  }
  clk.mark(11);                                  // the dchi2 sums
  for (int i = 0; i < mine; ++i) {
    const Task k = task(i);
    const int slot = stages ? i % stages : 0;
    const int l = k.l0 + lane;
    const bool valid = a.valid[k.sp] != 0.0f;    // uniform across the block
    const size_t row0 = (static_cast<size_t>(k.ys) * Wp + k.xs) * Ls + l;
    if (kPos && valid && warp == 0 && l < L) {
      float* cl = a.clean + (static_cast<size_t>(k.ch) * Yc * Xc + k.sp) * L + l;
      *cl = __fadd_rn(*cl, jump_buf[static_cast<size_t>(k.cs) * L + l]);
    }
    if (stages) {
      cp_async_wait(stages - 1);
      if (valid) {
        ring.consume(maps, slot);
        if (l < L)
          staged_commit<kS>(a.resid + k.ch * chain, ring.rs(slot), sh.img, a.spec,
                        ring.own(slot)[threadIdx.x], row0, l, Wp, L, Ls, f, S);
        __syncthreads();                         // the stage is consumed
      }
      copy_c(i + stages);
    } else if (valid && l < L) {
      patch_commit<kS>(a.resid + k.ch * chain, sh.img, a.spec,
                   g_buf[static_cast<size_t>(k.cs) * L + l], row0, l, Wp, L,
                   Ls, f, S);
    }
    clk.count(14);
  }
  if (stages) {
    cp_async_wait(0);
    fence_async_proxy();             // the commits, before the next copies
  }
  clk.mark(15);                                  // commits
  grid.sync();         // the step is committed before the next one reads
}

// Launch `kernel(args, map of the residual, map of the weights)`: the ring's
// stages (`a->stages` < 0: as many as fit; the ring needs rows padded to 16
// bytes: Ls % 8 == 0), the shared memory (the ring and phase (b)'s window
// share it), and a grid for `a->max_spaxels` (chain, spaxel)s in the largest
// step; `pos`: the kernel draws with positivity (a wider window).
template <typename Kernel>
inline int launch_gibbs(Kernel kernel, GibbsArgs* a, bool pos,
                        cudaStream_t stream) {
  const int threads = block_threads(a->f);
  const int Hp = a->f - 1 + a->ny * a->f, Wp = a->f - 1 + a->nx * a->f;
  if (a->lam_b < 1 || a->Ls < a->L) return static_cast<int>(cudaErrorInvalidValue);
  const size_t fixed = sizeof(float) * gibbs_fixed_floats(a->S, a->f, a->C);
  const size_t stage =
      sizeof(float) * ring_stage_floats(a->S, a->f, a->lw, threads);
  const size_t window = sizeof(float) * gibbs_window_arrays(pos) *
                        static_cast<size_t>(gibbs_window(a->L, a->lw, a->lam_b));
  size_t optin = 0;
  if (const int e = smem_optin(&optin)) return e;
  if (fixed + window > optin) return static_cast<int>(cudaErrorInvalidValue);
  a->stages = pick_stages(a->Ls % 8 == 0 ? optin - fixed : 0, stage, a->stages);
  if (a->stages < 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_r{}, map_w{};
  if (a->stages > 0) {
    if (const int e = patch_map(&map_r, a->resid, a->C, Hp, Wp, a->L, a->Ls, a->f))
      return e;
    if (const int e = patch_map(&map_w, a->w, 1, Hp, Wp, a->L, a->Ls, a->f))
      return e;
  }
  const size_t ring = a->stages * stage;
  void* params[] = {a, &map_r, &map_w};
  return launch_cooperative(
      kernel, params, threads, fixed + (ring > window ? ring : window),
      static_cast<long long>(a->max_spaxels) * ((a->L + kChunk - 1) / kChunk),
      stream);
}

}  // namespace deconv3d

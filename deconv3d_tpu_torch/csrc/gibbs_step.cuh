// One exact-Gibbs step of the color-decomposed sweep: every chain's spaxels
// of one Step (a color over the whole field in gibbs_sweep.cu, a color
// inside one tile in tiled_sweep.cu), with its three grid barriers.
//
//   (a) lin   every (chain, spaxel, 32-wavelength chunk) task: the patch
//             contraction (sweep_common.cuh), lin to scratch
//   --- grid barrier ---
//   (b) draws every (chain, spaxel) task: one block runs the lw phases over
//             the whole spectrum in shared memory (lin, quad, the normals
//             that each phase overwrites with its jumps, and gacc: 4 L
//             floats, 59 KB at L=3681), linT and g reaching +-lw/2 around
//             each live voxel; it adds the jumps into clean and writes
//             gacc, the step's dchi2 and the live count
//   --- grid barrier ---
//   (c) commit every (chain, spaxel, chunk) task: resid -= patch(gacc)
//   --- grid barrier ---
//
// A task's arithmetic depends neither on the chain batch nor on the step's
// extent (see mh_step.cuh).
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
  float* scratch;          // [2 * C * spaxels of a step * L]: lin, gacc
  int C, L, f, ny, nx, S, lw;
  int nyt, nxt;            // block rows / columns of a step
  uint32_t sweep;
};

// Shared memory of one block: FSF images, per-warp pooled partials, one
// spectrum's lin, quad, normals/jumps and gacc, block sums, Philox keys.
struct GibbsShared {
  float* img;              // [S * f * f]
  float* pool;             // [nw * S * kChunk]
  float* lin;              // [L]
  float* quad;             // [L]
  float* nj;               // [L] normals, then jumps
  float* gacc;             // [L]
  float* red;              // [3 * nw]
  uint32_t* key;           // [2 * C]
};

inline size_t gibbs_smem_bytes(int S, int f, int L, int C) {
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  return sizeof(float) * (static_cast<size_t>(S) * f * f +
                          static_cast<size_t>(nw) * S * kChunk +
                          4 * static_cast<size_t>(L) + 3 * nw +
                          2 * static_cast<size_t>(C));
}

// Carve the block's shared memory and load the keys and images.
__device__ __forceinline__ GibbsShared gibbs_shared(const GibbsArgs& a,
                                                    float* smem) {
  const int nw = blockDim.x >> 5;
  GibbsShared s;
  s.img = smem;
  s.pool = s.img + a.S * a.f * a.f;
  s.lin = s.pool + nw * a.S * kChunk;
  s.quad = s.lin + a.L;
  s.nj = s.quad + a.L;
  s.gacc = s.nj + a.L;
  s.red = s.gacc + a.L;
  s.key = reinterpret_cast<uint32_t*>(s.red + 3 * nw);
  for (int k = threadIdx.x; k < 2 * a.C; k += blockDim.x) s.key[k] = a.keys[k];
  load_images(s.img, a.imgs, a.S * a.f * a.f);
  return s;
}

__device__ __forceinline__ void gibbs_step(const GibbsArgs& a,
                                           const GibbsShared& sh,
                                           const Step& st,
                                           cooperative_groups::grid_group& grid) {
  const int L = a.L, f = a.f, S = a.S, lw = a.lw, half = lw / 2;
  const int nij = a.ny * a.nx, n_colors = f * f;
  const int Yc = a.ny * f, Xc = a.nx * f;
  const int Hp = f - 1 + Yc, Wp = f - 1 + Xc;
  const int P = (L + kChunk - 1) / kChunk;       // chunks per spaxel
  const int nst = st.spaxels();
  const int spaxels = a.C * nst;                 // (chain, spaxel) tasks
  const int tasks = spaxels * P;                 // (chain, spaxel, chunk)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const int c = st.c, cy = st.cy, cx = st.cx;
  float* lin_buf = a.scratch;                     // [spaxels * L]
  float* g_buf = lin_buf + static_cast<size_t>(spaxels) * L;

  // ---------------- (a) lin of every (chain, spaxel, chunk) ---------------
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int cs = t / P, l0 = (t % P) * kChunk;
    const int ch = cs / nst, ij = st.ij(cs % nst, a.nx);
    const int ys = (ij / a.nx) * f + cy, xs = (ij % a.nx) * f + cx;
    const int sp = ys * Xc + xs;
    if (a.valid[sp] == 0.0f) continue;        // uniform across the block
    const int l = l0 + lane;
    const size_t row0 = (static_cast<size_t>(ys) * Wp + xs) * L + l;
    patch_partials(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, a.w,
                   sh.img, sh.pool, row0, l < L, Wp, L, f, S);
    __syncthreads();
    if (warp == 0 && l < L)
      lin_buf[static_cast<size_t>(cs) * L + l] =
          partials_to_lin(sh.pool, a.spec, l, L, S);
    __syncthreads();   // pool is reused by the next task
  }
  grid.sync();
  // ---------------- (b) the lw phases of every (chain, spaxel) ------------
  for (int cs = blockIdx.x; cs < spaxels; cs += gridDim.x) {
    const int ch = cs / nst, ij = st.ij(cs % nst, a.nx);
    const int ys = (ij / a.nx) * f + cy, xs = (ij % a.nx) * f + cx;
    const int sp = ys * Xc + xs;
    const size_t out = static_cast<size_t>(ch * n_colors + c) * nij + ij;
    const float* qv = a.qvox + static_cast<size_t>(sp) * L;
    const uint32_t k0 = sh.key[2 * ch], k1 = sh.key[2 * ch + 1];
    for (int l = threadIdx.x; l < L; l += nt) {
      sh.lin[l] = lin_buf[static_cast<size_t>(cs) * L + l];
      sh.quad[l] = a.quad[static_cast<size_t>(sp) * L + l];
      sh.gacc[l] = 0.0f;
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
      sh.nj[l] = box_muller(u1, u2);
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
            if (mu >= 0 && mu < L)
              linT = band_term(linT, a.lsf[mu * lw + d], sh.lin[mu]);
          }
          jump = gibbs_jump(linT, fmaxf(q, 1.0e-30f), sh.nj[l]);
          live += 1.0f;
        }
        sh.nj[l] = jump;
      }
      __syncthreads();
      // g of the phase's jumps, and lin <- lin - g * quad
      for (int mu = threadIdx.x; mu < L; mu += nt) {
        const int lo = mu - half;
        int r = (ph - lo) % lw;
        if (r < 0) r += lw;
        const int l = lo + r;                 // the phase voxel near mu
        if (l >= 0 && l < L) {
          const float g = __fmul_rn(a.lsf[mu * lw + (l - lo)], sh.nj[l]);
          sh.lin[mu] = lin_after(sh.lin[mu], g, sh.quad[mu]);
          sh.gacc[mu] = __fadd_rn(sh.gacc[mu], g);
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
      const float ga = sh.gacc[l];
      dchi = __fadd_rn(dchi, gibbs_dchi_term(ga, sh.quad[l], lin0[l]));
      if (qlo) dlo = __fadd_rn(dlo, gibbs_dlo_term(ga, qlo[l]));
      clean[l] = __fadd_rn(clean[l], sh.nj[l]);
      g_buf[static_cast<size_t>(cs) * L + l] = ga;
    }
    // block sums in a fixed order: lanes, then warps
    dchi = warp_sum(dchi);
    live = warp_sum(live);
    dlo = warp_sum(dlo);
    if (lane == 0) {
      sh.red[warp] = dchi;
      sh.red[nw + warp] = live;
      sh.red[2 * nw + warp] = dlo;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sd = 0.0f, sl = 0.0f, so = 0.0f;
      for (int r = 0; r < nw; ++r) {
        sd += sh.red[r];
        sl += sh.red[nw + r];
        so += sh.red[2 * nw + r];
      }
      a.dchi_out[out] = sd + so;
      a.live_out[out] = sl;
    }
    __syncthreads();   // shared buffers are reused by the next task
  }
  grid.sync();
  // ---------------- (c) commit of every (chain, spaxel, chunk) ------------
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int cs = t / P, l0 = (t % P) * kChunk;
    const int ch = cs / nst, ij = st.ij(cs % nst, a.nx);
    const int ys = (ij / a.nx) * f + cy, xs = (ij % a.nx) * f + cx;
    const int sp = ys * Xc + xs;
    const int l = l0 + lane;
    if (a.valid[sp] == 0.0f || l >= L) continue;
    const size_t row0 = (static_cast<size_t>(ys) * Wp + xs) * L + l;
    patch_commit(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, sh.img,
                 a.spec, g_buf[static_cast<size_t>(cs) * L + l], row0, l,
                 Wp, L, f, S);
  }
  grid.sync();         // the step is committed before the next one reads
}

}  // namespace deconv3d

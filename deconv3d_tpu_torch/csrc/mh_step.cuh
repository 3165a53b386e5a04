// One Metropolis-Hastings step of the color-decomposed sweep: every chain's
// spaxels of one Step (a color over the whole field in mh_sweep.cu, a color
// inside one tile in tiled_sweep.cu), with its two grid barriers.
//
//   phase 1  every (chain, spaxel, 32-wavelength chunk) task: lin over its
//            chunk (f x f x 32 patch), the jump spectrum with the LSF halo,
//            g, and its share of dchi2
//   --- grid barrier ---
//   phase 2  every task: dchi2 of its spaxel summed over the chunks in a
//            fixed order, the accept decision (identical in all chunks),
//            and on accept the commit of its chunk
//   --- grid barrier ---
//
// A task's arithmetic depends neither on the chain batch nor on the step's
// extent, so a chain computes the same bits alone or in a batch, and a
// spaxel's visit the same bits in a tile as in the whole field.
#pragma once

#include "philox.cuh"
#include "sweep_common.cuh"

namespace deconv3d {

constexpr float kCauchyClip = 1.0e3f;

// The per-element arithmetic of an MH visit (explicit roundings; shared
// with the resident kernel, resident_sweep.cu).
// jump = exp(log_scale) * clip(tan(pi (u - 1/2)), +-1e3) * valid
__device__ __forceinline__ float mh_jump(float u, float scale, float v) {
  const float tn = fminf(fmaxf(tanf(__fmul_rn(kPi, __fsub_rn(u, 0.5f))),
                               -kCauchyClip), kCauchyClip);
  return __fmul_rn(__fmul_rn(scale, tn), v);
}
// this wavelength's share of dchi2: g^2 quad - 2 g lin
__device__ __forceinline__ float mh_share(float g, float q, float lin) {
  return __fsub_rn(__fmul_rn(__fmul_rn(g, g), q),
                   __fmul_rn(__fmul_rn(2.0f, g), lin));
}
// Robbins-Monro: log_scale + adapt (accept - target) valid
__device__ __forceinline__ float log_scale_step(float ls, float adapt,
                                                float accf, float target,
                                                float v) {
  return __fadd_rn(ls, __fmul_rn(__fmul_rn(adapt, __fsub_rn(accf, target)), v));
}

struct MhArgs {
  float* resid;            // [C, Hp, Wp, L]
  const float* w;          // [Hp, Wp, L]
  const float* quad;       // [Yc, Xc, L]
  float* clean;            // [C, Yc, Xc, L]
  float* log_scale;        // [C, Yc, Xc]
  const float* valid;      // [Yc, Xc] 1.0 / 0.0
  const float* spec;       // [S, L]
  const float* imgs;       // [S, f, f]
  const float* lsf;        // [L, lw]
  const uint32_t* keys;    // [C, 2] Philox key words
  const float* uniforms;   // [C, f*f, nij, L+1] or null (Philox)
  float* accept_out;       // [C, f*f, nij]
  float* dchi_out;         // [C, f*f, nij]
  float* uniforms_out;     // [C, f*f, nij, L+1] or null
  float* scratch;          // [tasks * (2 * kChunk + 1)] of one step
  int C, L, f, ny, nx, S, lw;
  int nyt, nxt;            // block rows / columns of a step
  uint32_t sweep;
  float adapt, target;
};

// Shared memory of one block: FSF images, per-warp pooled partials, the
// jump spectrum with its LSF halo, the chains' Philox keys.
struct MhShared {
  float* img;              // [S * f * f]
  float* pool;             // [nw * S * kChunk]
  float* jump;             // [kChunk + 2 * half]
  uint32_t* key;           // [2 * C]
};

inline size_t mh_smem_bytes(int S, int f, int lw, int C) {
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  return sizeof(float) * (static_cast<size_t>(S) * f * f +
                          static_cast<size_t>(nw) * S * kChunk + kChunk +
                          2 * (lw / 2) + 2 * static_cast<size_t>(C));
}

// Carve the block's shared memory and load the keys and images.
__device__ __forceinline__ MhShared mh_shared(const MhArgs& a, float* smem) {
  const int nw = blockDim.x >> 5;
  MhShared s;
  s.img = smem;
  s.pool = s.img + a.S * a.f * a.f;
  s.jump = s.pool + nw * a.S * kChunk;
  s.key = reinterpret_cast<uint32_t*>(s.jump + kChunk + 2 * (a.lw / 2));
  for (int k = threadIdx.x; k < 2 * a.C; k += blockDim.x) s.key[k] = a.keys[k];
  load_images(s.img, a.imgs, a.S * a.f * a.f);
  return s;
}

__device__ __forceinline__ void mh_step(const MhArgs& a, const MhShared& sh,
                                        const Step& st,
                                        cooperative_groups::grid_group& grid) {
  const int L = a.L, f = a.f, S = a.S, lw = a.lw, half = lw / 2;
  const int nij = a.ny * a.nx, n_colors = f * f;
  const int Yc = a.ny * f, Xc = a.nx * f;
  const int Hp = f - 1 + Yc, Wp = f - 1 + Xc;
  const int P = (L + kChunk - 1) / kChunk;       // chunks per spaxel
  const int nst = st.spaxels();
  const int tasks = a.C * nst * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = blockDim.x;
  const int c = st.c, cy = st.cy, cx = st.cx;
  float* g_buf = a.scratch;                       // [tasks * kChunk]
  float* jump_buf = g_buf + static_cast<size_t>(tasks) * kChunk;
  float* part_buf = jump_buf + static_cast<size_t>(tasks) * kChunk;  // [tasks]

  // ---------------- phase 1: lin, jumps, g, partial dchi2 -----------------
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int cs = t / P;                      // chain * nst + local spaxel
    const int ch = cs / nst, ij = st.ij(cs % nst, a.nx);
    const int l0 = (t % P) * kChunk;
    const int ys = (ij / a.nx) * f + cy;       // spaxel row == patch top row
    const int xs = (ij % a.nx) * f + cx;
    const int sp = ys * Xc + xs;
    const int l = l0 + lane;
    const bool on = l < L;
    const float v = a.valid[sp];
    patch_partials(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, a.w,
                   sh.img, sh.pool, (static_cast<size_t>(ys) * Wp + xs) * L + l,
                   on, Wp, L, f, S);

    // jump spectrum over the chunk plus the LSF halo
    const size_t ubase = (static_cast<size_t>(ch * n_colors + c) * nij + ij) * (L + 1);
    const uint32_t k0 = sh.key[2 * ch], k1 = sh.key[2 * ch + 1];
    const float scale = expf(a.log_scale[static_cast<size_t>(ch) * Yc * Xc + sp]);
    for (int k = threadIdx.x; k < kChunk + 2 * half; k += nt) {
      const int m = l0 - half + k;
      float jump = 0.0f;
      if (m >= 0 && m < L) {
        const float u = a.uniforms
                            ? a.uniforms[ubase + m]
                            : jump_uniform(k0, k1, a.sweep, c, ij, m);
        if (a.uniforms_out && k >= half && k < half + kChunk)
          a.uniforms_out[ubase + m] = u;
        jump = mh_jump(u, scale, v);
      }
      sh.jump[k] = jump;
    }
    __syncthreads();
    if (warp == 0) {
      float part = 0.0f, g = 0.0f;
      if (on) {
        const float lin = partials_to_lin(sh.pool, a.spec, l, L, S);
        for (int d = 0; d < lw; ++d)
          g = band_term(g, a.lsf[l * lw + d], sh.jump[lane + d]);
        part = mh_share(g, a.quad[static_cast<size_t>(sp) * L + l], lin);
      }
      part = warp_sum(part);
      g_buf[static_cast<size_t>(t) * kChunk + lane] = g;
      jump_buf[static_cast<size_t>(t) * kChunk + lane] = sh.jump[lane + half];
      if (lane == 0) part_buf[t] = part;
    }
    __syncthreads();   // shared buffers are reused by the next task
  }
  grid.sync();
  // ---------------- phase 2: accept, commit --------------------------------
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int cs = t / P, chunk = t % P, l0 = chunk * kChunk;
    const int ch = cs / nst, ij = st.ij(cs % nst, a.nx);
    const int ys = (ij / a.nx) * f + cy;
    const int xs = (ij % a.nx) * f + cx;
    const int sp = ys * Xc + xs;
    const int l = l0 + lane;
    const float v = a.valid[sp];
    const size_t out = static_cast<size_t>(ch * n_colors + c) * nij + ij;
    // dchi2 of the spaxel: every warp sums the P chunk partials in the
    // same fixed order, so every thread holds the same value
    float dchi = 0.0f;
    for (int q = lane; q < P; q += 32) dchi += part_buf[static_cast<size_t>(cs) * P + q];
    dchi = warp_sum(dchi);
    const float u2 = a.uniforms
                         ? a.uniforms[out * (L + 1) + L]
                         : accept_uniform(sh.key[2 * ch], sh.key[2 * ch + 1],
                                          a.sweep, c, ij);
    const bool acc = (logf(u2) < -0.5f * dchi) && (v > 0.0f);
    // the spaxel's outputs first: nothing but the commit's own values
    // stays live across the commit loop
    if (chunk == 0 && threadIdx.x == 0) {
      if (a.uniforms_out) a.uniforms_out[out * (L + 1) + L] = u2;
      const float accf = acc ? 1.0f : 0.0f;
      a.accept_out[out] = accf;
      a.dchi_out[out] = dchi;
      float* ls = a.log_scale + static_cast<size_t>(ch) * Yc * Xc + sp;
      *ls = log_scale_step(*ls, a.adapt, accf, a.target, v);
    }
    if (acc && l < L) {
      if (warp == 0) {
        float* cl = a.clean + (static_cast<size_t>(ch) * Yc * Xc + sp) * L + l;
        *cl = __fadd_rn(*cl, jump_buf[static_cast<size_t>(t) * kChunk + lane]);
      }
      patch_commit(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, sh.img,
                   a.spec, g_buf[static_cast<size_t>(t) * kChunk + lane],
                   (static_cast<size_t>(ys) * Wp + xs) * L + l, l, Wp, L,
                   f, S);
    }
  }
  grid.sync();         // the step is committed before the next one reads
}

}  // namespace deconv3d

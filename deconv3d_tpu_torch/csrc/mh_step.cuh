// One Metropolis-Hastings step of the color-decomposed sweep: every chain's
// spaxels of one Step (a color over the whole field in mh_sweep.cu, a color
// inside the tiles of one wave in tiled_sweep.cu), with its two grid
// barriers.
//
//   phase 1  every (chain, spaxel, 32-wavelength chunk) task: lin over its
//            chunk (f x f x 32 patch), the jump spectrum with the LSF halo,
//            g, and its share of dchi2.  A block walks its tasks with the
//            next ones' patches in flight (the ring of sweep_common.cuh),
//            one block barrier per task: the row warps contract task i + 1
//            while one service warp draws its jumps and asks the Tensor
//            Memory Accelerator for task i + 1 + stages, and the other
//            finishes task i (lin, band, share, stores).
//   --- grid barrier ---
//   phase 2  every task: dchi2 of its spaxel summed over the chunks in a
//            fixed order, the accept decision (identical in all chunks) --
//            one warp per task, a block's warps deciding side by side --
//            and on accept the commit of its chunk, the accepted patches
//            of a batch streamed through the ring
//   --- grid barrier ---
//
// Positivity (kPos, a compile-time flag: the flag-off code is unchanged)
// reflects each proposed spectrum into the positive orthant before dchi2:
// jump = |clean + J| - clean at every wavelength of the chunk and its halo,
// read from the spaxel's clean, which only its own visit changes.
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
// positivity: the reflected proposal |cur + jump| - cur (a symmetric
// folded density: no Metropolis correction)
__device__ __forceinline__ float reflect(float jump, float cur) {
  return __fsub_rn(fabsf(__fadd_rn(cur, jump)), cur);
}
// Robbins-Monro: log_scale + adapt (accept - target) valid
__device__ __forceinline__ float log_scale_step(float ls, float adapt,
                                                float accf, float target,
                                                float v) {
  return __fadd_rn(ls, __fmul_rn(__fmul_rn(adapt, __fsub_rn(accf, target)), v));
}

struct MhArgs {
  float* resid;            // [C, Hp, Wp, Ls] (the first L of a row are data)
  const __nv_bfloat16* w;  // [Hp, Wp, Ls] (bfloat16 values: exact)
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
  float* scratch;          // [tasks * (2 * kChunk + 1)] of the largest step
  const int* wave_start;   // [n_waves + 1] into wave_tiles (tiled kernel)
  const int* wave_tiles;   // raster indices of every wave's tiles
  int C, L, Ls, f, ny, nx, S, lw;
  int nyt, nxt;            // block rows / columns of a tile
  int n_waves;
  int stages;              // ring stages (0: synchronous loads)
  uint32_t sweep;
  float adapt, target;
  int by0;                 // tiled band launch: its first carried block row
  int ij0;                 // the field's spaxel row of carried row 0
};

// Shared memory of one block: the ring's barriers, FSF images, per-warp
// pooled partials and the jump spectrum with its LSF halo (two buffers
// each: task i is finished while task i + 1 fills the other), the
// decisions of a batch of tasks, the chains' Philox keys, the ring.
struct MhShared {
  float* img;              // [S * f * f]
  float* pool;             // [2][row warps * S * kChunk]
  float* jump;             // [2][kChunk + 2 * half]
  float* flag;             // [warps]
  uint32_t* key;           // [2 * C]
  float* ring;             // [stages][ring_stage_floats]
};

__host__ __device__ inline size_t mh_fixed_floats(int S, int f, int lw, int C) {
  const int nw = row_warps(f);
  return ring_aligned(kBarFloats + static_cast<size_t>(S) * f * f +
                      2 * static_cast<size_t>(nw) * S * kChunk +
                      2 * static_cast<size_t>(kChunk + 2 * (lw / 2)) + nw +
                      kServiceWarps + 2 * static_cast<size_t>(C));
}

// Carve the block's shared memory, set up the ring's barriers and load the
// keys and images.
__device__ __forceinline__ MhShared mh_shared(const MhArgs& a, float* smem,
                                              PatchMaps& maps) {
  const int nw = row_warps(a.f);
  MhShared s;
  s.img = smem + kBarFloats;
  s.pool = s.img + a.S * a.f * a.f;
  s.jump = s.pool + 2 * nw * a.S * kChunk;
  s.flag = s.jump + 2 * (kChunk + 2 * (a.lw / 2));
  s.key = reinterpret_cast<uint32_t*>(s.flag + nw + kServiceWarps);
  s.ring = smem + mh_fixed_floats(a.S, a.f, a.lw, a.C);
  ring_init(smem, maps);
  for (int k = threadIdx.x; k < 2 * a.C; k += blockDim.x) s.key[k] = a.keys[k];
  load_images(s.img, a.imgs, a.S * a.f * a.f);
  return s;
}

template <int kS, bool kPos>
__device__ __forceinline__ void mh_step(const MhArgs& a, const MhShared& sh,
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
  const int tasks = a.C * nst * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = blockDim.x, nw = nt >> 5, nwv = row_warps(f);
  const int c = st.c;
  const int stages = a.stages;
  const Ring ring(smem, sh.ring, stages, S, f, lw);
  const int npool = nwv * S * kChunk, njump = kChunk + 2 * half;
  const int mine = block_share(tasks);
  const size_t chain = static_cast<size_t>(Hp) * Wp * Ls;
  float* g_buf = a.scratch;                       // [tasks * kChunk]
  float* jump_buf = g_buf + static_cast<size_t>(tasks) * kChunk;
  float* part_buf = jump_buf + static_cast<size_t>(tasks) * kChunk;  // [tasks]
  auto task = [&](int i) {
    return task_of(static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x),
                   P, nst, st, a.nx, f, Xc);
  };

  // ---------------- phase 1: lin, jumps, g, partial dchi2 -----------------
  const bool draws = warp == nwv, finishes = warp == nwv + 1;
  // the drawing warp's lane 0: the patches of task i into their stage
  auto produce = [&](int i) {
    if (lane == 0 && i < mine) {
      const Task k = task(i);
      ring.produce(maps, i % stages, k.l0, k.xs, k.ys, k.ch, true);
    }
  };
  // the finishing warp: the tail's operands of task i at each lane's
  // wavelength, one copy group per task (empty past the last one)
  auto copy_tail = [&](int i) {
    if (i < mine) {
      const Task k = task(i);
      const int slot = i % stages, l = k.l0 + lane;
      if (l < L) {
        for (int d = 0; d < lw; ++d)
          cp_async4(ring.lsf(slot) + lane * lw + d,
                    a.lsf + static_cast<size_t>(l) * lw + d);
        cp_async4(ring.quad(slot) + lane,
                  a.quad + static_cast<size_t>(k.sp) * L + l);
        for (int s = 0; s < S; ++s)
          cp_async4(ring.spec(slot) + s * kChunk + lane,
                    a.spec + static_cast<size_t>(s) * L + l);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < stages; ++i) {
    if (draws) produce(i);
    if (finishes) copy_tail(i);
  }
  clk.mark(0);                                   // decode, first copies
  for (int i = 0; i < mine; ++i) {
    const Task k = task(i);
    const int slot = stages ? i % stages : 0, buf = i & 1;
    const int l = k.l0 + lane;
    const bool on = l < L;
    float* pool = sh.pool + buf * npool;
    float* jump_s = sh.jump + buf * njump;
    if (stages && (draws || finishes)) ring.consume(maps, slot, false);
    if (draws) {
      // jump spectrum over the chunk plus the LSF halo
      const float v = a.valid[k.sp];
      const size_t ubase =
          (static_cast<size_t>(k.ch * n_colors + c) * nij + k.ij) * (L + 1);
      const uint32_t k0 = sh.key[2 * k.ch], k1 = sh.key[2 * k.ch + 1];
      const float scale =
          expf(a.log_scale[static_cast<size_t>(k.ch) * Yc * Xc + k.sp]);
      const float* cl = a.clean + (static_cast<size_t>(k.ch) * Yc * Xc + k.sp) * L;
      for (int q = lane; q < njump; q += 32) {
        const int m = k.l0 - half + q;
        float jump = 0.0f;
        if (m >= 0 && m < L) {
          const float u = a.uniforms
                              ? a.uniforms[ubase + m]
                              : jump_uniform(k0, k1, a.sweep, c, k.ij + a.ij0, m);
          if (a.uniforms_out && q >= half && q < half + kChunk)
            a.uniforms_out[ubase + m] = u;
          jump = mh_jump(u, scale, v);
          if (kPos) jump = reflect(jump, cl[m]);
        }
        jump_s[q] = jump;
      }
    } else if (!finishes) {
      if (stages) {
        ring.consume(maps, slot);
        clk.mark(2);                             // waiting for the copies
        staged_partials<kS>(ring.rs(slot), ring.ws(slot), sh.img, pool, on, f, S);
      } else {
        patch_partials<kS>(a.resid + k.ch * chain, a.w, sh.img, pool,
                       (static_cast<size_t>(k.ys) * Wp + k.xs) * Ls + l, on,
                       Wp, Ls, f, S);
      }
    }
    clk.mark(3);                                 // partials
    __syncthreads();   // partials and jumps are whole; the stage is consumed
    clk.mark(4);                                 // block barrier
    if (draws && stages) produce(i + stages);
    if (finishes) {
      const int t =
          static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
      float part = 0.0f, g = 0.0f;
      if (stages) cp_async_wait(stages - 1);     // this task's operands
      if (on) {
        const float* spec = stages ? ring.spec(slot) + lane : a.spec + l;
        const float* lsf = stages ? ring.lsf(slot) + lane * lw
                                  : a.lsf + static_cast<size_t>(l) * lw;
        const float q = stages ? ring.quad(slot)[lane]
                               : a.quad[static_cast<size_t>(k.sp) * L + l];
        const float lin =
            partials_to_lin<kS>(pool, spec, stages ? kChunk : L, S, nwv);
        for (int d = 0; d < lw; ++d)
          g = band_term(g, lsf[d], jump_s[lane + d]);
        part = mh_share(g, q, lin);
      }
      part = warp_sum(part);
      g_buf[static_cast<size_t>(t) * kChunk + lane] = g;
      jump_buf[static_cast<size_t>(t) * kChunk + lane] = jump_s[lane + half];
      if (lane == 0) part_buf[t] = part;
      if (stages) copy_tail(i + stages);
    }
    clk.count(12);
  }
  if (stages && finishes) cp_async_wait(0);
  grid.sync();
  clk.mark(6);                                   // grid barrier 1
  // ---------------- phase 2: accept, commit --------------------------------
  for (int i0 = 0; i0 < mine; i0 += nw) {
    // the decisions of nw tasks side by side, one warp each
    if (i0 + warp < mine) {
      const Task k = task(i0 + warp);
      const float v = a.valid[k.sp];
      const size_t out = static_cast<size_t>(k.ch * n_colors + c) * nij + k.ij;
      // dchi2 of the spaxel: the P chunk partials in a fixed order
      float dchi = 0.0f;
      for (int q = lane; q < P; q += 32)
        dchi += part_buf[static_cast<size_t>(k.cs) * P + q];
      dchi = warp_sum(dchi);
      const float u2 = a.uniforms
                           ? a.uniforms[out * (L + 1) + L]
                           : accept_uniform(sh.key[2 * k.ch],
                                            sh.key[2 * k.ch + 1], a.sweep, c,
                                            k.ij + a.ij0);
      const bool acc = (logf(u2) < -0.5f * dchi) && (v > 0.0f);
      if (lane == 0) {
        sh.flag[warp] = acc ? 1.0f : 0.0f;
        if (k.l0 == 0) {                         // the spaxel's outputs
          if (a.uniforms_out) a.uniforms_out[out * (L + 1) + L] = u2;
          const float accf = acc ? 1.0f : 0.0f;
          a.accept_out[out] = accf;
          a.dchi_out[out] = dchi;
          float* ls = a.log_scale + static_cast<size_t>(k.ch) * Yc * Xc + k.sp;
          *ls = log_scale_step(*ls, a.adapt, accf, a.target, v);
        }
      }
    }
    __syncthreads();
    clk.mark(7);                                 // decisions
    const int nb = min(nw, mine - i0);           // tasks of this batch
    // the batch's accepted tasks, in order
    auto next_accepted = [&](int j) {
      do ++j; while (j < nb && sh.flag[j] == 0.0f);
      return j;
    };
    auto commit = [&](int j, const float* rs, float g) {
      const Task k = task(i0 + j);
      const int t = static_cast<int>(blockIdx.x) +
                    (i0 + j) * static_cast<int>(gridDim.x);
      const int l = k.l0 + lane;
      if (l >= L) return;
      if (warp == 0) {
        float* cl = a.clean + (static_cast<size_t>(k.ch) * Yc * Xc + k.sp) * L + l;
        *cl = __fadd_rn(*cl, jump_buf[static_cast<size_t>(t) * kChunk + lane]);
      }
      const size_t row0 = (static_cast<size_t>(k.ys) * Wp + k.xs) * Ls + l;
      if (rs)
        staged_commit<kS>(a.resid + k.ch * chain, rs, sh.img, a.spec, g, row0,
                          l, Wp, L, Ls, f, S);
      else
        patch_commit<kS>(a.resid + k.ch * chain, sh.img, a.spec,
                         g_buf[static_cast<size_t>(t) * kChunk + lane], row0,
                         l, Wp, L, Ls, f, S);
      clk.count(13);
    };
    if (stages) {
      // streamed through the ring: thread 0 asks for the residual patch of
      // the accepted task after `jp`, every thread copies g at its lane's
      // wavelength (one copy group per call, empty past the last task)
      int jp = -1;
      auto ask = [&](int slot) {
        if (jp < nb) jp = next_accepted(jp);
        if (jp < nb) {
          const Task k = task(i0 + jp);
          const int t = static_cast<int>(blockIdx.x) +
                        (i0 + jp) * static_cast<int>(gridDim.x);
          if (threadIdx.x == 0)
            ring.produce(maps, slot, k.l0, k.xs, k.ys, k.ch, false);
          if (k.l0 + lane < L)
            cp_async4(ring.own(slot) + threadIdx.x,
                      g_buf + static_cast<size_t>(t) * kChunk + lane);
        }
        cp_async_commit();
      };
      for (int slot = 0; slot < stages; ++slot) ask(slot);
      int n = 0;
      for (int j = next_accepted(-1); j < nb; j = next_accepted(j), ++n) {
        const int slot = n % stages;
        cp_async_wait(stages - 1);
        ring.consume(maps, slot);
        commit(j, ring.rs(slot), ring.own(slot)[threadIdx.x]);
        __syncthreads();                         // the stage is consumed
        ask(slot);
      }
      cp_async_wait(0);
    } else {
      for (int j = next_accepted(-1); j < nb; j = next_accepted(j))
        commit(j, nullptr, 0.0f);
    }
    __syncthreads();                             // the flags are reused
    clk.mark(8);                                 // commits
  }
  if (stages) fence_async_proxy();   // the commits, before the next copies
  grid.sync();         // the step is committed before the next one reads
  clk.mark(9);                                   // grid barrier 2
}

// Launch `kernel(args, map of the residual, map of the weights)`: the ring's
// stages (`a->stages` < 0: as many as fit; the ring needs rows padded to 16
// bytes: Ls % 8 == 0), the shared memory, and a grid for `spaxels` (chain,
// spaxel)s in the largest step.
template <typename Kernel>
inline int launch_mh(Kernel kernel, MhArgs* a, long long spaxels,
                     cudaStream_t stream) {
  const int threads = block_threads(a->f);
  const int Hp = a->f - 1 + a->ny * a->f, Wp = a->f - 1 + a->nx * a->f;
  const size_t fixed = sizeof(float) * mh_fixed_floats(a->S, a->f, a->lw, a->C);
  const size_t stage =
      sizeof(float) * ring_stage_floats(a->S, a->f, a->lw, threads);
  size_t optin = 0;
  if (const int e = smem_optin(&optin)) return e;
  if (fixed > optin || a->Ls < a->L) return static_cast<int>(cudaErrorInvalidValue);
  a->stages = pick_stages(a->Ls % 8 == 0 ? optin - fixed : 0, stage, a->stages);
  if (a->stages < 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_r{}, map_w{};
  if (a->stages > 0) {
    if (const int e = patch_map(&map_r, a->resid, a->C, Hp, Wp, a->L, a->Ls, a->f))
      return e;
    if (const int e = patch_map(&map_w, a->w, 1, Hp, Wp, a->L, a->Ls, a->f))
      return e;
  }
  void* params[] = {a, &map_r, &map_w};
  return launch_cooperative(kernel, params, threads,
                            fixed + a->stages * stage,
                            spaxels * ((a->L + kChunk - 1) / kChunk), stream);
}

}  // namespace deconv3d

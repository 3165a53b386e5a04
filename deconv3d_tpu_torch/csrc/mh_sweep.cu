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
// 32-wavelength chunk): a thread block of 32 x min(f, 18) threads takes a
// task, lanes on wavelengths and warps on patch rows (sweep_common.cuh).
// Colors depend on each other, so the sweep is ONE cooperative launch for
// all chains; per color:
//
//   phase 1  every task: lin over its chunk (f x f x 32 patch), the jump
//            spectrum with the LSF halo, g, and its share of dchi2
//   --- grid barrier ---
//   phase 2  every task: dchi2 of its spaxel summed over the chunks in a
//            fixed order, the accept decision (identical in all chunks),
//            and on accept the commit of its chunk
//   --- grid barrier ---
//
// The chains share the weights, quad, FSF and LSF, and the barriers: a
// batch of C chains pays the 2 f^2 barriers of a sweep once.  A task's
// arithmetic does not depend on the batch, so a chain computes the same
// bits alone or in a batch.  Random numbers come from the in-kernel Philox
// (philox.cuh) under each chain's key, or from an injected uniform tensor
// for parity tests.
//
// What bounds it.  Each color reads the whole f x f x L patch of residual
// and weights of each of its spaxels (2 x 4 x f^2 x L bytes: 1.4 MB per
// spaxel at f=17, L=600) and writes the residual patch back on accept;
// summed over a sweep, every residual voxel is read f^2 times.  On a 30x30
// MUSE subcube with one chain that is 1.6 GB per sweep out of L2 spread
// over only 4 spaxels x 19 chunks = 76 tasks, and 578 grid barriers per
// sweep: the sweep is bound by L2 latency and barriers, not by bandwidth.
// A batch of chains multiplies the tasks per barrier (32 chains: 2432
// tasks).  On the full MUSE range (L=3681) the state leaves L2 and the f^2
// re-reads go to HBM.
//
// Per-(chain, color, spaxel) outputs: the accept flag and the proposed
// dchi2; the wrapper sums accepted dchi2 in a fixed order and applies each
// chain's Kahan chi2 update per sweep, as _assemble does in the JAX
// package.

#include "philox.cuh"
#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace deconv3d {

constexpr float kCauchyClip = 1.0e3f;

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
  float* scratch;          // [tasks * (2 * kChunk + 1)]
  int C, L, f, ny, nx, S, lw;
  uint32_t sweep;
  float adapt, target;
};

__global__ void __launch_bounds__(kMaxThreads) mh_sweep_kernel(MhArgs a) {
  extern __shared__ float smem[];
  const int L = a.L, f = a.f, S = a.S, lw = a.lw, half = lw / 2;
  const int nij = a.ny * a.nx, n_colors = f * f;
  const int Yc = a.ny * f, Xc = a.nx * f;
  const int Hp = f - 1 + Yc, Wp = f - 1 + Xc;
  const int P = (L + kChunk - 1) / kChunk;       // chunks per spaxel
  const int tasks = a.C * nij * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  float* img_s = smem;                            // [S * f * f]
  float* pool_s = img_s + S * f * f;              // [nw * S * kChunk]
  float* jump_s = pool_s + nw * S * kChunk;       // [kChunk + 2 * half]
  uint32_t* key_s = reinterpret_cast<uint32_t*>(jump_s + kChunk + 2 * half);
  float* g_buf = a.scratch;                       // [tasks * kChunk]
  float* jump_buf = g_buf + static_cast<size_t>(tasks) * kChunk;
  float* part_buf = jump_buf + static_cast<size_t>(tasks) * kChunk;  // [tasks]
  for (int k = threadIdx.x; k < 2 * a.C; k += nt) key_s[k] = a.keys[k];
  load_images(img_s, a.imgs, S * f * f);
  cg::grid_group grid = cg::this_grid();

  for (int c = 0; c < n_colors; ++c) {
    const int cy = c / f, cx = c % f;
    // ---------------- phase 1: lin, jumps, g, partial dchi2 -------------
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int cs = t / P;                    // chain * nij + spaxel row
      const int ch = cs / nij, ij = cs % nij, l0 = (t % P) * kChunk;
      const int ys = (ij / a.nx) * f + cy;     // spaxel row == patch top row
      const int xs = (ij % a.nx) * f + cx;
      const int sp = ys * Xc + xs;
      const int l = l0 + lane;
      const bool on = l < L;
      const float v = a.valid[sp];
      patch_partials(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, a.w,
                     img_s, pool_s, (static_cast<size_t>(ys) * Wp + xs) * L + l,
                     on, Wp, L, f, S);

      // jump spectrum over the chunk plus the LSF halo
      const size_t ubase = (static_cast<size_t>(ch * n_colors + c) * nij + ij) * (L + 1);
      const uint32_t k0 = key_s[2 * ch], k1 = key_s[2 * ch + 1];
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
          const float tn = fminf(fmaxf(tanf(kPi * (u - 0.5f)), -kCauchyClip),
                                 kCauchyClip);
          jump = scale * tn * v;
        }
        jump_s[k] = jump;
      }
      __syncthreads();
      if (warp == 0) {
        float part = 0.0f, g = 0.0f;
        if (on) {
          const float lin = partials_to_lin(pool_s, a.spec, l, L, S);
          for (int d = 0; d < lw; ++d) g += a.lsf[l * lw + d] * jump_s[lane + d];
          const float q = a.quad[static_cast<size_t>(sp) * L + l];
          part = g * g * q - 2.0f * g * lin;
        }
        part = warp_sum(part);
        g_buf[static_cast<size_t>(t) * kChunk + lane] = g;
        jump_buf[static_cast<size_t>(t) * kChunk + lane] = jump_s[lane + half];
        if (lane == 0) part_buf[t] = part;
      }
      __syncthreads();   // shared buffers are reused by the next task
    }
    grid.sync();
    // ---------------- phase 2: accept, commit ---------------------------
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int cs = t / P, chunk = t % P, l0 = chunk * kChunk;
      const int ch = cs / nij, ij = cs % nij;
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
                           : accept_uniform(key_s[2 * ch], key_s[2 * ch + 1],
                                            a.sweep, c, ij);
      const bool acc = (logf(u2) < -0.5f * dchi) && (v > 0.0f);
      // the spaxel's outputs first: nothing but the commit's own values
      // stays live across the commit loop
      if (chunk == 0 && threadIdx.x == 0) {
        if (a.uniforms_out) a.uniforms_out[out * (L + 1) + L] = u2;
        const float accf = acc ? 1.0f : 0.0f;
        a.accept_out[out] = accf;
        a.dchi_out[out] = dchi;
        a.log_scale[static_cast<size_t>(ch) * Yc * Xc + sp] +=
            a.adapt * (accf - a.target) * v;
      }
      if (acc && l < L) {
        if (warp == 0)
          a.clean[(static_cast<size_t>(ch) * Yc * Xc + sp) * L + l] +=
              jump_buf[static_cast<size_t>(t) * kChunk + lane];
        patch_commit(a.resid + static_cast<size_t>(ch) * Hp * Wp * L, img_s,
                     a.spec, g_buf[static_cast<size_t>(t) * kChunk + lane],
                     (static_cast<size_t>(ys) * Wp + xs) * L + l, l, Wp, L,
                     f, S);
      }
    }
    grid.sync();         // color c is committed before color c+1 reads
  }
}

}  // namespace deconv3d

extern "C" {

// Floats of scratch one sweep of C chains needs (per-task g, jumps and
// dchi2 shares).
long long mh_sweep_scratch_floats(int C, int L, int ny, int nx) {
  const long long tasks = static_cast<long long>(C) * ny * nx *
                          ((L + deconv3d::kChunk - 1) / deconv3d::kChunk);
  return tasks * (2 * deconv3d::kChunk + 1);
}

// Launch one sweep of C chains on `stream`.  Returns a cudaError_t (0 on
// success), checked right after the launch; the kernel itself runs
// asynchronously.
int mh_sweep_launch(float* resid, const float* w, const float* quad,
                    float* clean, float* log_scale, const float* valid,
                    const float* spec, const float* imgs, const float* lsf,
                    const unsigned* keys, const float* uniforms,
                    float* accept_out, float* dchi_out, float* uniforms_out,
                    float* scratch, int C, int L, int f, int ny, int nx, int S,
                    int lw, unsigned sweep, float adapt, float target,
                    void* stream) {
  using namespace deconv3d;
  if (C < 1 || S < 1 || S > kMaxRank || L < 1 || f < 1 || ny < 1 || nx < 1 ||
      lw < 1 || lw % 2 == 0 || ny * nx >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  MhArgs a{resid, w, quad, clean, log_scale, valid, spec, imgs, lsf, keys,
           uniforms, accept_out, dchi_out, uniforms_out, scratch, C, L, f,
           ny, nx, S, lw, sweep, adapt, target};
  const int nw = f < kMaxWarps ? f : kMaxWarps;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(S) * f * f +
                       static_cast<size_t>(nw) * S * kChunk + kChunk +
                       2 * (lw / 2) + 2 * static_cast<size_t>(C));
  const long long tasks =
      static_cast<long long>(C) * ny * nx * ((L + kChunk - 1) / kChunk);
  return launch_cooperative(mh_sweep_kernel, &a, 32 * nw, smem, tasks,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

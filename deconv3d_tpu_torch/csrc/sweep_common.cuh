// Pieces shared by the sweep kernels (mh_sweep.cu, gibbs_sweep.cu,
// tiled_sweep.cu): the step geometry, the ring of asynchronous patch copies,
// the patch contraction and commit of one (chain, spaxel, 32-wavelength
// chunk) task, the task clocks of a measurement build, and the cooperative
// launch.
//
// Layout (lambda-contiguous; the wrapper transposes at the segment
// boundary): residual [C, Hp, Wp, Ls] float, weights [Hp, Wp, Ls] bfloat16
// (rows of Ls >= L elements, the first L data), clean [C, Yc, Xc, L],
// quad/qvox [Yc, Xc, L].  The weights are bfloat16 values in the problem
// itself (the sampler rounds them), so the bfloat16 copy is exact:
// __bfloat162float gives back the float every product and sum used before.
// A task's block holds nw row warps and two service warps: lanes on
// wavelengths (one 128-byte row per warp), row warps on patch rows dy =
// warp, warp + nw, ...
//
// The ring.  A task reads f x f x 32 floats of the residual and bfloat16s
// of the weights (55 KB at f = 17) and does a few hundred flops per thread
// on them; loaded by the threads themselves, at most ~35 KB per SM are in
// flight and the card's memory runs at half its rate.  A block therefore
// walks its tasks with the next tasks' patches in flight: one thread asks
// the Tensor Memory Accelerator for each patch -- a [f, f, 32] box of the
// [C, Hp, Wp, Ls] tensor (cp.async.bulk.tensor, completion on an mbarrier)
// -- into a ring of stages in shared memory, and refills a stage as soon as
// the block has consumed it.  A tensor map's strides are multiples of 16
// bytes and L is odd on MUSE, so the wrapper pads the rows of the residual
// and the weights to Ls = 8 ceil(L / 8) elements (16 bytes of bfloat16); a
// box that reaches past L is filled with zeros.  (Per-thread 4-byte
// cp.async copies, which need no padding, were measured first: issuing
// them costs more than they hide.)
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <type_traits>

namespace deconv3d {

constexpr int kMaxRank = 8;
constexpr int kChunk = 32;          // wavelengths per task (one per lane)
// a block holds min(f, 18) row warps (one per patch row; MUSE's f = 17; a
// larger f loops the warps over rows) and two service warps, so a thread
// may use up to 96 registers
constexpr int kMaxWarps = 18;
constexpr int kServiceWarps = 2;
constexpr int kMaxThreads = 32 * (kMaxWarps + kServiceWarps);
constexpr float kPi = 3.14159265358979323846f;

// The row warps of a block: warp r < row_warps(f) holds the patch rows
// dy = r, r + row_warps, ... of the contraction and sums them on its own
// (the sums' order is part of the kernels' function, shared with the
// resident kernel).  The block's last two warps are its service warps: in
// the task loops one draws the jumps and asks for the next patches, the
// other finishes the tasks (lin, band, share, stores), both while the row
// warps contract the next patch.  Everywhere else all warps work alike.
__host__ __device__ inline int row_warps(int f) {
  return f < kMaxWarps ? f : kMaxWarps;
}
__host__ __device__ inline int block_threads(int f) {
  return 32 * (row_warps(f) + kServiceWarps);
}

// One step of a sweep: the spaxels of color (cy, cx) in `n` tiles of
// nyt x nxt spaxel blocks -- the tiles of one wave for the tiled kernel
// (`tiles`: their raster indices in the band's ntx tile columns; the band
// is the block rows from by0 of the carried grid, the whole grid unless a
// band launch says otherwise), the whole field as one tile for the
// whole-cube kernels (`tiles` null).  Local spaxel i of the step is spaxel
// row ij(i) of the carried grid; every per-spaxel array and output is
// indexed by that row, every random number by the field's row (the
// kernel's `ij0` added), so a spaxel's visit computes the same bits under
// any tiling, schedule and band.
struct Step {
  int c, cy, cx, nyt, nxt, ntx, n, by0;
  const int* tiles;
  __device__ Step(int c_, int f, int nyt_, int nxt_, int ntx_,
                  const int* tiles_, int n_, int by0_ = 0)
      : c(c_), cy(c_ / f), cx(c_ % f), nyt(nyt_), nxt(nxt_), ntx(ntx_),
        n(n_), by0(by0_), tiles(tiles_) {}
  // color c over the whole ny x nx field
  __device__ static Step whole(int c, int f, int ny, int nx) {
    return Step(c, f, ny, nx, 1, nullptr, 1);
  }
  __device__ int spaxels() const { return n * nyt * nxt; }
  __device__ int ij(int i, int nx) const {
    const int per = nyt * nxt, t = i / per, k = i - t * per;
    const int tile = tiles ? tiles[t] : 0;
    return (by0 + (tile / ntx) * nyt + k / nxt) * nx + (tile % ntx) * nxt +
           k % nxt;
  }
};

// One (chain, spaxel, 32-wavelength chunk) task t of a step: the chain, the
// (chain, local spaxel) index cs, the global spaxel row ij, the chunk's
// first wavelength, the spaxel (== its patch's top-left pixel) and its
// index sp in [Yc, Xc].
struct Task {
  int cs, ch, ij, l0, ys, xs, sp;
};
__device__ __forceinline__ Task task_of(int t, int P, int nst, const Step& st,
                                        int nx, int f, int Xc) {
  Task k;
  k.cs = t / P;
  k.l0 = (t - k.cs * P) * kChunk;
  k.ch = k.cs / nst;
  k.ij = st.ij(k.cs - k.ch * nst, nx);
  k.ys = (k.ij / nx) * f + st.cy;
  k.xs = (k.ij % nx) * f + st.cx;
  k.sp = k.ys * Xc + k.xs;
  return k;
}

// Tasks of `tasks` that this block takes grid-stride: blockIdx.x + i *
// gridDim.x, i < block_share(tasks).
__device__ __forceinline__ int block_share(int tasks) {
  const int b = static_cast<int>(blockIdx.x), g = static_cast<int>(gridDim.x);
  return tasks > b ? (tasks - 1 - b) / g + 1 : 0;
}

// The SM clock of a measurement build (-DTASK_PHASE_CLOCKS): thread 0 of
// block 0 adds the cycles since its last mark to slot k, and counts
// events; `python -m deconv3d_tpu_torch.task_phases` reads them.  The sums
// live in the block's shared memory (after the ring's barriers), so the
// clocks cost the kernel two registers.  The ordinary build compiles every
// call away.
constexpr int kTaskClocks = 16;
constexpr int kClockFloats = 32;    // where the sums start in shared memory
#ifdef TASK_PHASE_CLOCKS
__device__ unsigned long long task_clocks[kTaskClocks];
struct TaskClocks {
  long long last;
  unsigned long long* sum;
  __device__ explicit TaskClocks(float* smem)
      : sum(reinterpret_cast<unsigned long long*>(smem + kClockFloats)) {
    if (threadIdx.x == 0)
      for (int k = 0; k < kTaskClocks; ++k) sum[k] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    if (threadIdx.x == 0 && blockIdx.x == 0) {
      const long long t = clock64();
      sum[k] += t - last;
      last = t;
    }
  }
  __device__ __forceinline__ void count(int k) {
    if (threadIdx.x == 0 && blockIdx.x == 0) sum[k] += 1;
  }
  __device__ void flush() {
    if (threadIdx.x == 0 && blockIdx.x == 0)
      for (int k = 0; k < kTaskClocks; ++k) task_clocks[k] += sum[k];
  }
};
#else
struct TaskClocks {
  __device__ explicit TaskClocks(float*) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush() {}
};
#endif

// ---- the ring of asynchronous patch copies --------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst_shared, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst_shared)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// One arrival, and `bytes` to come from the copies that name this barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// The box of `map` at (c0, c1, c2, c3) (innermost first) into `dst`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Orders this thread's earlier writes (global and shared) before later
// copies of the Tensor Memory Accelerator that touch the same memory.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

constexpr int kMaxStages = 2;
constexpr int kRingAlign = 32;      // floats: a stage starts on 128 bytes

__host__ __device__ inline size_t ring_aligned(size_t floats) {
  return (floats + kRingAlign - 1) / kRingAlign * kRingAlign;
}

// Floats of a stage's weights patch [f, f, 32] of bfloat16, to 128 bytes.
__host__ __device__ inline size_t ring_w_floats(int f) {
  return ring_aligned(static_cast<size_t>(f) * f * kChunk / 2);
}

// Floats of one stage: the residual patch [f, f, 32] and the weights patch
// (ring_w_floats), each on 128 bytes, the chunk's LSF rows [32, lw], quad
// [32] and spectra [S, 32] (the MH tail's operands), and one float per
// thread (the commit's g).
__host__ __device__ inline size_t ring_stage_floats(int S, int f, int lw,
                                                    int threads) {
  return static_cast<size_t>(f) * f * kChunk + ring_w_floats(f) +
         static_cast<size_t>(kChunk) * lw + kChunk +
         static_cast<size_t>(S) * kChunk + threads;
}

// The stages that fit `room` bytes: at most kMaxStages, or exactly `want`
// when want >= 0 (0: no ring, the tasks load synchronously).  -1 when
// `want` does not fit.
inline int pick_stages(size_t room, size_t stage_bytes, int want) {
  int fit = static_cast<int>(room / stage_bytes);
  if (fit > kMaxStages) fit = kMaxStages;
  if (want < 0) return fit;
  return want <= fit ? want : -1;
}

// The tensor maps of the residual [C, Hp, Wp, Ls] and the bfloat16 weights
// [1, Hp, Wp, Ls] (kernel parameters), and how often each stage's barrier
// has completed (every thread counts alike).
struct PatchMaps {
  const CUtensorMap* resid;
  const CUtensorMap* w;
  unsigned uses[kMaxStages];
};

struct Ring {
  uint64_t* full;          // [stages] one barrier per stage
  float* base;
  int stages, S, f, lw;
  size_t stride;           // floats of a stage
  __device__ Ring(float* smem, float* base_, int stages_, int S_, int f_,
                  int lw_)
      : full(reinterpret_cast<uint64_t*>(smem)), base(base_), stages(stages_),
        S(S_), f(f_), lw(lw_),
        stride(ring_stage_floats(S_, f_, lw_, blockDim.x)) {}
  __device__ float* rs(int slot) const { return base + slot * stride; }
  __device__ __nv_bfloat16* ws(int slot) const {
    return reinterpret_cast<__nv_bfloat16*>(rs(slot) + f * f * kChunk);
  }
  __device__ float* lsf(int slot) const {
    return rs(slot) + f * f * kChunk + ring_w_floats(f);
  }
  __device__ float* quad(int slot) const { return lsf(slot) + kChunk * lw; }
  __device__ float* spec(int slot) const { return quad(slot) + kChunk; }
  __device__ float* own(int slot) const { return spec(slot) + S * kChunk; }
  // bytes of a patch of `T` (a box past L counts whole: it is zero-filled)
  template <typename T>
  __device__ unsigned box_bytes() const {
    return static_cast<unsigned>(f * f * kChunk * sizeof(T));
  }
  // one thread: start the copies of a task's patches into stage `slot`
  // (the residual's of chain `ch`, and the weights' when `w` is set)
  __device__ void produce(const PatchMaps& m, int slot, int l0, int xs, int ys,
                          int ch, bool w) const {
    mbar_expect_tx(full + slot,
                   box_bytes<float>() + (w ? box_bytes<__nv_bfloat16>() : 0u));
    tma_load_4d(rs(slot), m.resid, full + slot, l0, xs, ys, ch);
    if (w) tma_load_4d(ws(slot), m.w, full + slot, l0, xs, ys, 0);
  }
  // every thread, so that all count alike: stage `slot` is used once more;
  // those that read it (`wait`) wait for its copies first
  __device__ void consume(PatchMaps& m, int slot, bool wait = true) const {
    if (wait) mbar_wait(full + slot, m.uses[slot] & 1u);
    ++m.uses[slot];
  }
};

// The first floats of a block's shared memory hold the ring's barriers
// (and, from kClockFloats on, a measurement build's clock sums); thread 0
// initialises the barriers (the caller syncs the block).
constexpr int kBarFloats = kClockFloats + 2 * kTaskClocks;
__device__ __forceinline__ void ring_init(float* smem, PatchMaps& m) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s)
      mbar_init(reinterpret_cast<uint64_t*>(smem) + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int s = 0; s < kMaxStages; ++s) m.uses[s] = 0;
}

// The instantiation a launcher takes, for every sweep kernel: rank 1
// (MUSE's) or any rank up to kMaxRank, positivity compiled in or not.
// `launch(rank, pos)` gets std::integral_constant tags; the kernel is
// `kernel<decltype(rank)::value, decltype(pos)::value>`.
template <typename Launch>
inline int launch_variant(int S, bool pos, Launch&& launch) {
  using One = std::integral_constant<int, 1>;
  using Any = std::integral_constant<int, kMaxRank>;
  if (pos)
    return S == 1 ? launch(One{}, std::true_type{})
                  : launch(Any{}, std::true_type{});
  return S == 1 ? launch(One{}, std::false_type{})
                : launch(Any{}, std::false_type{});
}

// A band launch of the tiled kernel: the step grid is block rows [by0, by0
// + nyb) of the carried ny-row grid, in nyt-row tiles, and the carried
// grid's row 0 is block row gy0 of the field, whose spaxel rows key the
// random numbers (24 bits of the counter).  by0 = 0, nyb = ny, gy0 = 0 is
// the whole field.  0 = fine.
inline int check_band(int ny, int nx, int nyt, int by0, int nyb, int gy0) {
  if (nyt < 1 || nyb < 1 || nyb % nyt != 0 || by0 < 0 || by0 + nyb > ny ||
      gy0 < 0 || static_cast<long long>(gy0 + ny) * nx >= (1LL << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Geometry checks shared by every launch (0 = fine).
inline int check_dims(int C, int L, int f, int ny, int nx, int S, int lw,
                      int nyt, int nxt) {
  if (C < 1 || S < 1 || S > kMaxRank || L < 1 || f < 1 || ny < 1 || nx < 1 ||
      lw < 1 || lw % 2 == 0 || ny * nx >= (1 << 24) || nyt < 1 || nxt < 1 ||
      ny % nyt != 0 || nx % nxt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Copy the S FSF images [S, f, f] into shared memory (whole block).
__device__ __forceinline__ void load_images(float* img_s, const float* imgs,
                                            int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) img_s[k] = imgs[k];
  __syncthreads();
}

// The per-element arithmetic of a sweep, every rounding explicit (the
// compiler contracts nothing), shared by every kernel: the classic, tiled
// and resident kernels compute the same bits wherever they sum in the same
// order.  kS is the FSF rank the code is compiled for: 1 (MUSE's) drops the
// rank loop, kMaxRank takes any S.
__device__ __forceinline__ float pool_term(float acc, float img, float rw) {
  return __fmaf_rn(img, rw, acc);               // rw = resid * w
}
__device__ __forceinline__ float lin_term(float lin, float spec, float p) {
  return __fmaf_rn(spec, p, lin);               // p = sum of the partials
}
__device__ __forceinline__ float band_term(float acc, float m, float x) {
  return __fmaf_rn(m, x, acc);                  // one LSF band product
}
// resid -= sum_s gs[s] * img_s at patch pixel `px` (gs[s] = spec[s, l] * g)
template <int kS>
__device__ __forceinline__ float commit_term(float resid, const float* gs,
                                             const float* img_s, int px,
                                             int ff, int S) {
  float delta = 0.0f;
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (kS == 1 || s < S) delta = __fmaf_rn(gs[s], img_s[s * ff + px], delta);
  return __fsub_rn(resid, delta);
}

// This warp's share of the patch contraction at wavelength l:
//   pool_s[(warp * S + s) * kChunk + lane] =
//     sum_{dy = warp, warp+nw, ...} sum_dx img_s[s, dy, dx] * (resid * w)[dy, dx]
// where `row0` is the offset of patch pixel (0, 0) at wavelength l in the
// chain's residual and in the weights, whose rows hold Ls elements; w is
// widened to float exactly before the product.  Row warps only; the caller
// syncs the block before reading the partials.
template <int kS>
__device__ __forceinline__ void patch_partials(const float* resid,
                                               const __nv_bfloat16* w,
                                               const float* img_s,
                                               float* pool_s, size_t row0,
                                               bool on, int Wp, int Ls, int f,
                                               int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = row_warps(f);
  float pooled[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) pooled[s] = 0.0f;
  if (on) {
    for (int dy = warp; dy < f; dy += nw) {
      const size_t row = row0 + static_cast<size_t>(dy) * Wp * Ls;
#pragma unroll 8
      for (int dx = 0; dx < f; ++dx) {
        const size_t off = row + static_cast<size_t>(dx) * Ls;
        const float rw = __fmul_rn(resid[off], __bfloat162float(w[off]));
#pragma unroll
        for (int s = 0; s < kS; ++s)
          if (kS == 1 || s < S) pooled[s] = pool_term(pooled[s], img_s[(s * f + dy) * f + dx], rw);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (kS == 1 || s < S) pool_s[(warp * S + s) * kChunk + lane] = pooled[s];
}

// The same from a stage of the ring (the caller has waited for its copies).
// The sums run in patch_partials' order.
template <int kS>
__device__ __forceinline__ void staged_partials(const float* rs,
                                                const __nv_bfloat16* ws,
                                                const float* img_s,
                                                float* pool_s, bool on, int f,
                                                int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = row_warps(f);
  float pooled[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) pooled[s] = 0.0f;
  if (on) {
    for (int dy = warp; dy < f; dy += nw) {
      const int idx0 = dy * f * kChunk + lane;
#pragma unroll 8
      for (int dx = 0; dx < f; ++dx) {
        const int idx = idx0 + dx * kChunk;
        const float rw = __fmul_rn(rs[idx], __bfloat162float(ws[idx]));
#pragma unroll
        for (int s = 0; s < kS; ++s)
          if (kS == 1 || s < S) pooled[s] = pool_term(pooled[s], img_s[(s * f + dy) * f + dx], rw);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (kS == 1 || s < S) pool_s[(warp * S + s) * kChunk + lane] = pooled[s];
}

// lin at the lane's wavelength from the per-warp partials, summed over the
// nw row groups in a fixed order: lin = sum_s spec[s * stride] * sum_r pool_s[r, s]
// (`spec` points at the lane's wavelength of spectrum 0: in [S, L] with
// stride L, or in a ring stage with stride 32).
template <int kS>
__device__ __forceinline__ float partials_to_lin(const float* pool_s,
                                                 const float* spec, int stride,
                                                 int S, int nw) {
  const int lane = threadIdx.x & 31;
  float lin = 0.0f;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    if (kS == 1 || s < S) {
      float p = 0.0f;
      for (int r = 0; r < nw; ++r)
        p = __fadd_rn(p, pool_s[(r * S + s) * kChunk + lane]);
      lin = lin_term(lin, spec[s * stride], p);
    }
  }
  return lin;
}

// resid -= sum_s (spec[s, l] * g) * img_s over this warp's patch rows at
// wavelength l (row0 as in patch_partials).
template <int kS>
__device__ __forceinline__ void patch_commit(float* resid, const float* img_s,
                                             const float* spec, float g,
                                             size_t row0, int l, int Wp,
                                             int L, int Ls, int f, int S) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float gs[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s)
    gs[s] = (kS == 1 || s < S) ? __fmul_rn(spec[s * L + l], g) : 0.0f;
  for (int dy = warp; dy < f; dy += nw) {
    const size_t row = row0 + static_cast<size_t>(dy) * Wp * Ls;
#pragma unroll 8
    for (int dx = 0; dx < f; ++dx) {
      float* r = resid + row + static_cast<size_t>(dx) * Ls;
      *r = commit_term<kS>(*r, gs, img_s, dy * f + dx, f * f, S);
    }
  }
}

// The same with the residual patch read from a ring stage and written to
// global memory.
template <int kS>
__device__ __forceinline__ void staged_commit(float* resid, const float* rs,
                                              const float* img_s,
                                              const float* spec, float g,
                                              size_t row0, int l, int Wp,
                                              int L, int Ls, int f, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float gs[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s)
    gs[s] = (kS == 1 || s < S) ? __fmul_rn(spec[s * L + l], g) : 0.0f;
  for (int dy = warp; dy < f; dy += nw) {
    const size_t row = row0 + static_cast<size_t>(dy) * Wp * Ls;
    const int idx0 = dy * f * kChunk + lane;
#pragma unroll 8
    for (int dx = 0; dx < f; ++dx)
      resid[row + static_cast<size_t>(dx) * Ls] =
          commit_term<kS>(rs[idx0 + dx * kChunk], gs, img_s, dy * f + dx, f * f, S);
  }
}

// The tensor map of a [C, Hp, Wp, Ls] tensor of `T` (float or
// __nv_bfloat16) whose first L of every row's Ls elements are data, cut
// into [1, f, f, 32] boxes.  Returns a cudaError_t as an int (0 on
// success).
template <typename T>
inline int patch_map(CUtensorMap* map, const T* base, int C, int Hp, int Wp,
                     int L, int Ls, int f) {
  static_assert(std::is_same<T, float>::value ||
                    std::is_same<T, __nv_bfloat16>::value,
                "patch_map takes float or __nv_bfloat16");
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  // the CUDA library PyTorch has loaded holds the encoder; looking it up
  // at run time keeps this library free of a link-time dependency on it
  static Encode encode = nullptr;
  if (!encode) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY);
    void* fn = lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
    if (!fn) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t row = static_cast<cuuint64_t>(Ls) * sizeof(T);
  if (row % 16 != 0 || Ls < L) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(C)};
  const cuuint64_t strides[3] = {row, row * Wp, row * Wp * Hp};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(f),
                             static_cast<cuuint32_t>(f), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<T*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one block may opt in to on the current device (bytes).
inline int smem_optin(size_t* out) {
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  *out = static_cast<size_t>(optin);
  return 0;
}

// Launch `kernel(params...)` cooperatively with `threads` threads and
// `smem` bytes of dynamic shared memory, on as many blocks as fit the card
// at once (at most `tasks`); the kernel walks its tasks grid-stride.
template <typename Kernel>
inline int launch_cooperative(Kernel kernel, void** params, int threads,
                              size_t smem, long long tasks,
                              cudaStream_t stream) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  long long grid = static_cast<long long>(per_sm) * sms;
  if (grid > tasks) grid = tasks;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(static_cast<unsigned>(grid)),
                                  dim3(threads), params, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace deconv3d

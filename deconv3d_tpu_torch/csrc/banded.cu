// Banded Cholesky factor, conditional Gaussian draw and preconditioner
// solve on Hopper.
//
// Replaces the lax.scan recurrences of deconv3d_tpu/ops/banded.py (no
// Pallas kernel there): cholesky_banded (:77-117), sample_conditional
// (:184-192, the forward solve of :120-151 and the backward solve of
// :154-181), and the two solves of the direct sampler's Fourier-banded
// preconditioner (deconv3d_tpu/ops/direct.py:397-400, :548-549).  Band
// storage as there: bands[sys, l, k] = A[l, l+k] for k = 0..P
// (P = lw - 1 <= 10), zero past the matrix edge.
//
//   cholesky:  A = R^T R,  R[l, l+k] at out[sys, l, k]
//              R[l,l]   = sqrt(max((A[l,l] - sum_m R[l-m,l]^2)(1+jitter), eps))
//              R[l,l+k] = (A[l,l+k] - sum_m R[l-m,l] R[l-m,l+k]) / R[l,l]
//   sample:    R^T z = b  (forward),  R x = z + noise  (backward)
//              -> x ~ N(A^-1 b, A^-1) for standard-normal noise
//   solve:     R^T z = b,  R x = z  -> x = A^-1 b, for lambda-major
//              columns that name their factor (banded_solve_kernel below)
//
// The Cholesky (right-looking): a system's rows run on a group of G lanes,
// G a power of two above P + 1 (16 at P = 10: two systems a warp).  Lane k
// holds entry k of the current row and entry k of each of the P rows below
// it, reduced as far as the rows above have taken them: once row l is
// known, it subtracts R[l, l+i] R[l, l+i+k] from entry k of row l + i
// (i + k <= P), so every entry takes its updates in row order.  Per row,
// every lane forms the pivot x = max(s0 (1 + jitter), eps) from lane 0's
// entry, R[l, l] = x rsqrt(x) and R[l, l+k] = s_k rsqrt(x).  Row l + 1's
// update goes first, by shuffles, and lane 0's entry of row l + 1 reaches
// the other lanes before row l is known, so the chain from row to row is
// two shuffles, an fma, the pivot's rsqrt and a multiply.  The P - 1
// updates of the rows further down run beside it from a copy of row l in
// shared memory (three broadcast 16-byte loads and P - 1 loads of a
// zero-padded row: no masks): with a shuffle for each of their 2 (P - 1)
// operands instead, issuing the shuffles made a row about three times
// longer.
// The bands are read one chunk of kCholRows rows ahead into registers (the
// group's lanes on adjacent floats), the rows stored as they come.  Bound:
// L dependent rows of that chain for one system.
//
// The draw and the solve: a segmented recurrence.  Both solves carry a
// P-vector from row to row (forward: acc[k] = sum over the rows i done of
// R[i, l+k] z[i]; backward: the last P solution values), and the state
// leaving a run of rows is an affine function of the state entering it:
// out = part + T in, part the run solved from a zero state, T (P x P) its
// response to the P unit states.  So the L rows of a system (the draw) or
// a column (the solve) are cut into S segments of m rows (segment_rows:
// ceil(L / S), made odd), one thread each:
//   1. each thread runs its rows from a zero state together with the P
//      unit states: P + 1 independent recurrences, bound by issue, not by
//      latency (T is computed here, per launch: no table);
//   2. the carry: S - 1 rounds in which the thread of segment r - 1 forms
//      part + T in and hands it to segment r (warp shuffles in the draw,
//      shared memory and a block barrier in the solve);
//   3. each thread runs its rows again from its true incoming state.
// The backward solve does the same from the last segment down; the draw
// adds noise to z between the two (y = z + noise).  A row multiplies by
// the reciprocal of its pivot (recip) where the plain loops divide.  Empty
// segments have T = 1 and part = 0; P = 0 has no state, and S = 1 no
// first pass and no carry.
//
// What bounds it now.  The chain of one solve is m + (S - 1) + m dependent
// steps (a carry round is a P x P mat-vec and a hand-over), 2 (2m + S - 1)
// for the pair against 2 L before: 138 against 1,200 at L = 600 (S = 32,
// m = 19) and 530 against 7,362 at L = 3681 (m = 117).  Per row the first
// pass issues ~(P + 1)^2 instructions, which is why S falls at large
// batches.  Bytes: the draw reads R, b and noise once and writes x once;
// the solve reads b once and writes x once, and reads the factors (shared
// by columns) through L1 -- except where z does not fit shared memory
// (L = 3681), where z makes a round trip through `out`.  At S = 1 the 32
// lanes' loads of their columns' factor rows (~12 radial factors a warp)
// hold it far above its bytes, most likely in the L1's wavefronts.
//
// Where the data lie.  The draw (segments): S doubles from 1 while S < 32,
// n S < kFillLanes (32,768 threads fill 132 SMs) and every segment keeps
// max(P, 4) rows or more; a warp holds 32 / S systems, their segments on
// adjacent lanes.  At S = 32 a system whose factor, b and noise fit the
// SM's shared memory (L <= ~4,400 at P = 10; 191 KB at L = 3681) is copied
// there by the copy engine (cp.async.bulk on an mbarrier: one copy per
// array, each at its source's 16-byte phase, the few unaligned floats at
// either end by the lanes), y and x stay there, and x is stored coalesced
// at the end; otherwise the lanes read their rows from global memory and
// keep y in `out`.  The solve (solve_split): columns are lambda-major,
// b[l, c]; a block of 8 warps holds C adjacent columns of S = 8 x 32 / C
// segments (C halves from 32 while the blocks are fewer than 64, so 960
// columns run C = 8, S = 32 and 3720 columns C = 32, S = 8), so that the
// C lanes of a segment move b and x together; z stays in shared memory,
// m floats a thread, when it fits (L = 600), else in `out`.  From 32,768
// columns on (the full field's 90,600) S = 1: a warp of 32 columns.  The
// re-runs load a chunk of 8 rows into registers before they write any
// result, so a load's latency is paid per chunk, not per row, and b may
// be `out` (a thread reads its rows before it writes them).

#include <cuda_runtime.h>

#include <cstdint>

namespace deconv3d_banded {

constexpr int kWarp = 32;                 // threads per block
constexpr int kMaxP = 10;                 // lw <= 11
constexpr int kFillLanes = 32768;         // threads that fill the card
constexpr int kChunk = 8;                 // rows of a chunk
constexpr int kSolveWarps = 8;            // a segmented solve's block: 8
                                          // warps at ~225 registers
constexpr int kSolveBlocks = 64;          // fewer blocks split columns finer

// Segments per system of the draw (the split rule above).
__host__ __device__ inline int segments(int n, int L, int p) {
  const int min_rows = p > 4 ? p : 4;
  int S = 1;
  while (S < kWarp && static_cast<long long>(n) * S < kFillLanes &&
         2 * S * min_rows <= L)
    S *= 2;
  return S;
}

// An odd stride of at least `floats`: lanes `stride` apart hit 32 banks.
__host__ __device__ inline int odd(int floats) { return floats | 1; }

// Rows per segment: ceil(L / S), made odd, so that the draw's lanes, m W
// floats apart for an odd W, read distinct banks (the last segments may
// be shorter or empty).
__host__ __device__ inline int segment_rows(int L, int S) {
  return odd((L + S - 1) / S);
}

// The solve's split: S = 1 (one warp of 32 columns a block) for
// kFillLanes columns or more; else C columns of S = kSolveWarps 32 / C
// segments a block, C halving from 32 while the blocks are fewer than
// kSolveBlocks, and doubling back while a segment would get fewer than
// max(p, 4) rows.  Returns S and sets C.
__host__ __device__ inline int solve_split(int n, int L, int p, int* C) {
  const int min_rows = p > 4 ? p : 4;
  *C = kWarp;
  if (n >= kFillLanes) return 1;
  while (*C > 1 && (n + *C - 1) / *C < kSolveBlocks) *C /= 2;
  while (*C < kWarp && kSolveWarps * (kWarp / *C) * min_rows > L) *C *= 2;
  return kSolveWarps * (kWarp / *C);
}

// The 16-byte phase of `p` in floats, and of `count` floats from `src`
// the unaligned head before the first 16-byte boundary and the aligned
// body after it (whole 16-byte units).
__device__ __forceinline__ int phase4(const float* p) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}
__device__ __forceinline__ int head_floats(const float* src, int count) {
  return min((4 - phase4(src)) & 3, count);
}
__device__ __forceinline__ int body_floats(const float* src, int count) {
  return (count - head_floats(src, count)) & ~3;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// One arrival, and `bytes` to come from the copies that name the barrier.
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
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global `src`
// to shared `dst` by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The Cholesky's blocks and chunks, and its lanes per system: a power of
// two above P + 1, so that lane G - 1 holds zeros (the source of every
// product that falls off the band); P = 0 needs no lanes to talk.
constexpr int kCholThreads = 64;
constexpr int kCholRows = 16;
__host__ __device__ constexpr int chol_lanes(int P) {
  return P < 1 ? 1 : P < 3 ? 4 : P < 7 ? 8 : 16;
}

template <int P>
__global__ void __launch_bounds__(kCholThreads)
    banded_cholesky_kernel(const float* __restrict__ bands,
                           float* __restrict__ out, int n_sys, int L,
                           float jitter) {
  constexpr int W = P + 1, G = chol_lanes(P), K = kCholRows;
  constexpr unsigned kAll = 0xffffffffu;
  static_assert(P == 0 || (W <= 12 && W < G),
                "a row in three float4, and a zero lane");
  // each group's last two rows, zero past entry P (two: the next row's
  // stores may not overwrite the one being read)
  __shared__ __align__(16) float rows[P > 0 ? kCholThreads / G : 1][2][32];
  const int k = threadIdx.x % G, grp = threadIdx.x / G;
  const int sys = blockIdx.x * (kCholThreads / G) + grp;
  // a lane past the row's W entries or a system past n_sys holds zeros
  // (and stores nothing), but takes part in every shuffle
  const bool mine = sys < n_sys && k < W;
  const float* a = bands + static_cast<long long>(mine ? sys : 0) * L * W + k;
  float* o = out + static_cast<long long>(mine ? sys : 0) * L * W + k;
  auto load = [&](int row) { return mine && row < L ? __ldg(a + row * W) : 0.0f; };
  const float scale = 1.0f + jitter;
  if (P > 0) {
    for (int e = k; e < 64; e += G) (&rows[grp][0][0])[e] = 0.0f;
    __syncwarp();
  }
  // w1 = R[l, l+1+k] comes from lane 1 + k, or the zero lane past the band
  const int src1 = 1 + k <= P ? 1 + k : G - 1;
  // s: entry k of the current row, reduced; s0: lane 0's; pend[i]: entry k
  // of the row i + 1 below, reduced by the rows above the current one
  float s = load(0);
  float s0 = __shfl_sync(kAll, s, 0, G);
  float pend[P > 0 ? P : 1];
#pragma unroll
  for (int i = 0; i < P; ++i) pend[i] = load(1 + i);
  // the rows entering pend, one chunk ahead: row l + 1 + P at row l
  float q[K], nq[K];
#pragma unroll
  for (int u = 0; u < K; ++u) q[u] = load(P + 1 + u);
  for (int l0 = 0; l0 < L; l0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) nq[u] = load(l0 + K + P + 1 + u);
#pragma unroll
    for (int u = 0; u < K; ++u) {
      // R[l, l] = sqrt(x) = x rsqrt(x), R[l, l+k] = s_k rsqrt(x)
      const float x = fmaxf(s0 * scale, 1e-30f);
      const float r = (k == 0 ? x : s) * rsqrtf(x);
      if (mine && l0 + u < L) o[(l0 + u) * W] = r;
      if constexpr (P > 0) {
        float* row = rows[grp][u & 1];
        if (k < W) row[k] = r;
        // row l + 1 first, by shuffles: lane 0's entry needs only row l's
        // R[l, l+1]^2
        const float b0 = __shfl_sync(kAll, pend[0], 0, G);
        const float v1 = __shfl_sync(kAll, r, 1, G);
        const float w1 = __shfl_sync(kAll, r, src1, G);
        s = fmaf(-v1, w1, pend[0]);
        s0 = fmaf(-v1, v1, b0);
        // rows l + 2 .. l + P through shared memory: R[l, l+i] by three
        // broadcast 16-byte loads, R[l, l+i+k] from the zero-padded row
        __syncwarp();
        const float4 ra = *reinterpret_cast<const float4*>(row);
        const float4 rb = *reinterpret_cast<const float4*>(row + 4);
        const float4 rc = *reinterpret_cast<const float4*>(row + 8);
        const float v[12] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y,
                             rb.z, rb.w, rc.x, rc.y, rc.z, rc.w};
#pragma unroll
        for (int i = 2; i <= P; ++i)
          pend[i - 1] = fmaf(-v[i], row[i + k], pend[i - 1]);
#pragma unroll
        for (int i = 0; i + 1 < P; ++i) pend[i] = pend[i + 1];
        pend[P - 1] = q[u];
      } else {
        s = s0 = q[u];
      }
    }
#pragma unroll
    for (int u = 0; u < K; ++u) q[u] = nq[u];
  }
}

// 1 / x for a pivot: the hardware's approximate reciprocal (2 ulp), with
// no branch to keep the rows of a chunk apart.  A pivot is never
// denormal: the Cholesky floors its square at 1e-30.
__device__ __forceinline__ float recip(float x) { return __fdividef(1.f, x); }

// The carry over the S segments of a system: st[0] is a segment's state
// out of its rows from a zero state, st[1 + j] from unit state j, so out =
// st[0] + sum_j st[1 + j] in[j].  Upward (forward solve) segment r
// receives segment r - 1's out in round r; downward (backward solve)
// segment S - 1 - r receives segment S - r's.  The segments are the S
// lanes of a group (g = lane within it: the draw), handed on by warp
// shuffles, or with `cbuf` the S segments of a block's columns (the
// solve), through `cbuf` (P x 32 floats of shared memory), the column's
// entries at `col` (< 32).  Every thread of the warp or block takes part.
template <int P>
__device__ __forceinline__ void carry(const float (&st)[P + 1][P],
                                      float (&in)[P], int S, int g, bool up,
                                      float* cbuf, int col) {
#pragma unroll 1
  for (int r = 1; r < S; ++r) {
    const int from = up ? r - 1 : S - r, to = up ? r : S - 1 - r;
    float out[P];
    if (!cbuf || g == from) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float v = st[0][i];
#pragma unroll
        for (int j = 0; j < P; ++j) v = fmaf(st[j + 1][i], in[j], v);
        out[i] = v;
      }
    }
    if (cbuf) {
      if (g == from) {
#pragma unroll
        for (int i = 0; i < P; ++i) cbuf[i * kWarp + col] = out[i];
      }
      __syncthreads();
      if (g == to) {
#pragma unroll
        for (int i = 0; i < P; ++i) in[i] = cbuf[i * kWarp + col];
      }
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float v = up ? __shfl_up_sync(0xffffffffu, out[i], 1, S)
                           : __shfl_down_sync(0xffffffffu, out[i], 1, S);
        if (g == to) in[i] = v;
      }
    }
  }
}

// f(u) for the first `valid` rows u of a chunk of K, in order (up) or from
// the last (down): a whole chunk with no branch between its rows, so that
// the compiler may start every row's loads at once.
template <int K, bool kUp, class F>
__device__ __forceinline__ void each_row(int valid, F f) {
  if (valid >= K) {
#pragma unroll
    for (int v = 0; v < K; ++v) f(kUp ? v : K - 1 - v);
  } else {
#pragma unroll
    for (int v = 0; v < K; ++v) {
      const int u = kUp ? v : K - 1 - v;
      if (u < valid) f(u);
    }
  }
}

// The rows [lo, lo + valid) of a chunk (p: row lo) in registers before
// any result of the chunk is written (a store may alias them as far as
// the compiler knows): rw[u] and 1 / pivot for row lo + u (u >= valid
// repeat row lo).
template <int W, int K>
__device__ __forceinline__ void chunk_in_registers(const float* p, int valid,
                                                   float (&rw)[K][W],
                                                   float (&inv)[K]) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int r = u < valid ? u : 0;
#pragma unroll
    for (int k = 0; k < W; ++k) rw[u][k] = p[r * W + k];
    inv[u] = recip(rw[u][0]);
  }
}

// Forward solve R^T z = b over one thread's segment g (of S) of `len`
// rows: factor row i at Rs + i W, b[i] at b[i bs]; y = z + noise to
// y[i ys] (noise[i] at noise[i ns]; null: none; y may be b).  Every thread
// of the carry's warp or block calls it (`cbuf` and `col` as for carry),
// one without rows with len = 0.  kSeg = false compiles S = 1 only (no
// first pass or carry: the registers of a plain recurrence).
template <int P, bool kSeg>
__device__ __forceinline__ void forward_segment(
    const float* Rs, const float* b, long long bs, const float* noise,
    long long ns, float* y, long long ys, int len, int S, int g,
    float* cbuf, int col) {
  constexpr int W = P + 1;
  constexpr int H = P > 0 ? P : 1;
  constexpr int K = kChunk;
  // acc[k] = sum over the rows i done of R[i, l + k] z[i]: from the
  // segment's true incoming state
  float acc[H];
#pragma unroll
  for (int k = 0; k < H; ++k) acc[k] = 0.f;
  if constexpr (P > 0 && kSeg) {
    if (S > 1) {
      // st[0]: the rows from a zero state; st[1 + j]: from unit state j
      float st[P + 1][P];
#pragma unroll
      for (int r = 0; r <= P; ++r)
#pragma unroll
        for (int k = 0; k < P; ++k) st[r][k] = r == k + 1 ? 1.f : 0.f;
#pragma unroll 1
      for (int i0 = 0; i0 < len; i0 += K) {
        each_row<K, true>(min(K, len - i0), [&](int u) {
          const float* row = Rs + static_cast<long long>(i0 + u) * W;
          const float inv = recip(row[0]);
          const float bu = b[(i0 + u) * bs];
#pragma unroll
          for (int r = 0; r <= P; ++r) {
            const float z = ((r == 0 ? bu : 0.f) - st[r][0]) * inv;
#pragma unroll
            for (int k = 0; k < P; ++k)
              st[r][k] = k + 1 < P ? fmaf(row[k + 1], z, st[r][k + 1])
                                   : row[k + 1] * z;
          }
        });
      }
      carry<P>(st, acc, S, g, true, cbuf, col);
    }
  }
#pragma unroll 1
  for (int i0 = 0; i0 < len; i0 += K) {
    const int valid = min(K, len - i0);
    float rw[K][W], inv[K], bv[K], nv[K];
    chunk_in_registers<W, K>(Rs + static_cast<long long>(i0) * W, valid, rw,
                             inv);
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int i = u < valid ? i0 + u : i0;
      bv[u] = b[i * bs];
      nv[u] = noise ? noise[i * ns] : 0.f;
    }
    each_row<K, true>(valid, [&](int u) {
      const float z = (bv[u] - (P > 0 ? acc[0] : 0.f)) * inv[u];
#pragma unroll
      for (int k = 0; k < P; ++k)
        acc[k] = k + 1 < P ? fmaf(rw[u][k + 1], z, acc[k + 1])
                           : rw[u][k + 1] * z;
      y[(i0 + u) * ys] = z + nv[u];
    });
  }
}

// Backward solve R x = y over one thread's segment, from its last row up:
// y[i] at y[i ys], x[i] to x[i xs] (may be y).  As forward_segment, with
// the state hist[k] = x[l + 1 + k] and the carry running down; chunk
// rows [lo, hi), hi falling from len by K.
template <int P, bool kSeg>
__device__ __forceinline__ void backward_segment(const float* Rs,
                                                 const float* y, long long ys,
                                                 float* x, long long xs,
                                                 int len, int S, int g,
                                                 float* cbuf, int col) {
  constexpr int W = P + 1;
  constexpr int H = P > 0 ? P : 1;
  constexpr int K = kChunk;
  float hist[H];
#pragma unroll
  for (int k = 0; k < H; ++k) hist[k] = 0.f;
  if constexpr (P > 0 && kSeg) {
    if (S > 1) {
      float st[P + 1][P];
#pragma unroll
      for (int r = 0; r <= P; ++r)
#pragma unroll
        for (int k = 0; k < P; ++k) st[r][k] = r == k + 1 ? 1.f : 0.f;
#pragma unroll 1
      for (int hi = len; hi > 0; hi -= K) {
        const int lo = max(0, hi - K);
        each_row<K, false>(hi - lo, [&](int u) {
          const float* row = Rs + static_cast<long long>(lo + u) * W;
          const float inv = recip(row[0]);
          const float yu = y[(lo + u) * ys];
#pragma unroll
          for (int r = 0; r <= P; ++r) {
            float s = r == 0 ? yu : 0.f;
#pragma unroll
            for (int k = 0; k < P; ++k) s = fmaf(-row[k + 1], st[r][k], s);
#pragma unroll
            for (int k = P - 1; k > 0; --k) st[r][k] = st[r][k - 1];
            st[r][0] = s * inv;
          }
        });
      }
      carry<P>(st, hist, S, g, false, cbuf, col);
    }
  }
#pragma unroll 1
  for (int hi = len; hi > 0; hi -= K) {
    const int lo = max(0, hi - K), valid = hi - lo;
    float rw[K][W], inv[K], yv[K];
    chunk_in_registers<W, K>(Rs + static_cast<long long>(lo) * W, valid, rw,
                             inv);
#pragma unroll
    for (int u = 0; u < K; ++u) yv[u] = y[(lo + (u < valid ? u : 0)) * ys];
    each_row<K, false>(valid, [&](int u) {
      float s = yv[u];
#pragma unroll
      for (int k = 0; k < P; ++k) s = fmaf(-rw[u][k + 1], hist[k], s);
      const float xv = s * inv[u];
#pragma unroll
      for (int k = P - 1; k > 0; --k) hist[k] = hist[k - 1];
      if (P > 0) hist[0] = xv;
      x[(lo + u) * xs] = xv;
    });
  }
}

// x ~ N(A^-1 b, A^-1) for A = R^T R: R [n_sys, L, W], b, noise, out
// [n_sys, L].  A block is one warp of 32 / S systems of S segments of m
// rows; `staged` (S = 32: one system) keeps the system in shared memory.
template <int P>
__global__ void __launch_bounds__(kWarp)
    banded_sample_kernel(const float* __restrict__ R,
                         const float* __restrict__ b,
                         const float* __restrict__ noise,
                         float* __restrict__ out, int n_sys, int L, int S,
                         int m, int staged) {
  constexpr int W = P + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x, g = lane & (S - 1);
  const int sys = blockIdx.x * (kWarp / S) + lane / S;
  const bool live = sys < n_sys;
  const int l0 = min(g * m, L);
  const int len = live ? min(m, L - l0) : 0;
  const long long base = live ? static_cast<long long>(sys) * L : 0;
  if (!staged) {
    const float* Rs = R + (base + l0) * W;
    float* y = out + base + l0;
    forward_segment<P, true>(Rs, b + base + l0, 1, noise + base + l0, 1, y,
                             1, len, S, g, nullptr, 0);
    backward_segment<P, true>(Rs, y, 1, y, 1, len, S, g, nullptr, 0);
    return;
  }
  // one system: its factor rows, b (then y, then x) and noise, each in
  // shared memory at the 16-byte phase of its source, so that one bulk
  // copy moves its aligned body; segment g's rows start g m rows in
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const float* src[3] = {R + base * W, b + base, noise + base};
  const int count[3] = {L * W, L, L};
  float* dst[3];
  float* at = smem + 4;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dst[k] = at + phase4(src[k]);
    at += (count[k] + 7) & ~3;
  }
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (lane == 0) {
    unsigned bytes = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) bytes += 4u * body_floats(src[k], count[k]);
    mbar_expect_tx(bar, bytes);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int h = head_floats(src[k], count[k]);
      const int n = body_floats(src[k], count[k]);
      if (n) bulk_load(dst[k] + h, src[k] + h, 4u * n, bar);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {   // the unaligned ends, by the lanes
    const int h = head_floats(src[k], count[k]);
    const int t = h + body_floats(src[k], count[k]);
    for (int e = lane; e < h; e += kWarp) dst[k][e] = src[k][e];
    for (int e = t + lane; e < count[k]; e += kWarp) dst[k][e] = src[k][e];
  }
  mbar_wait(bar, 0);
  __syncthreads();
  const float* Rs = dst[0] + static_cast<long long>(l0) * W;
  float* sb = dst[1] + l0;
  forward_segment<P, true>(Rs, sb, 1, dst[2] + l0, 1, sb, 1, len, S, g,
                           nullptr, 0);
  backward_segment<P, true>(Rs, sb, 1, sb, 1, len, S, g, nullptr, 0);
  __syncthreads();
  for (int e = lane; e < L; e += kWarp) out[base + e] = dst[1][e];
}

// x = R^-1 R^-T b for n right-hand-side columns that share factors: column
// c solves against R[fidx[c]] (the preconditioner of the direct sampler:
// one factor per spatial frequency, or per radial bin of frequencies).
// The columns are lambda-major, b[l, c] (the real view of an rfft2 cube,
// [L, Y, X//2+1, 2]).  A block of kSolveWarps warps holds C columns of S
// segments (solve_split): lane l of warp w is column l % C, segment
// w 32 / C + l / C, so that the C lanes of a segment read C adjacent
// columns' b and write their x together; S = 1 is one warp of 32 columns.
// z stays in shared memory (m floats a thread) with `zsmem`, else in
// `out`; b may be `out` (a thread reads its rows before it writes them).
// kSeg = (S > 1).
template <int P, bool kSeg>
__global__ void __launch_bounds__(kWarp * kSolveWarps)
    banded_solve_kernel(const float* __restrict__ R,
                        const int* __restrict__ fidx, const float* b,
                        float* out, int n, int L, int C, int S, int m,
                        int zsmem) {
  constexpr int W = P + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & (kWarp - 1);
  const int cb = lane & (C - 1);
  const int g = threadIdx.x / kWarp * (kWarp / C) + lane / C;
  const int c = blockIdx.x * C + cb;
  const bool live = c < n;
  const int l0 = min(g * m, L);
  const int len = live ? min(m, L - l0) : 0;
  const int col = live ? c : 0;
  const float* Rs =
      R + (static_cast<long long>(__ldg(fidx + col)) * L + l0) * W;
  const long long at = static_cast<long long>(l0) * n + col;
  float* z = zsmem ? smem + kMaxP * kWarp + threadIdx.x * odd(m) : out + at;
  const long long zs = zsmem ? 1 : n;
  forward_segment<P, kSeg>(Rs, b + at, n, nullptr, 0, z, zs, len, S, g, smem,
                           cb);
  backward_segment<P, kSeg>(Rs, z, zs, out + at, n, len, S, g, smem, cb);
}

// Dynamic shared memory a block of the current device may opt in to.
inline int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory.
template <class Kernel>
int allow_smem(Kernel* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int P>
int launch_cholesky(const float* bands, float* out, int n_sys, int L,
                    float jitter, cudaStream_t st) {
  constexpr int per = kCholThreads / chol_lanes(P);
  banded_cholesky_kernel<P><<<(n_sys + per - 1) / per, kCholThreads, 0, st>>>(
      bands, out, n_sys, L, jitter);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_sample(const float* R, const float* b, const float* noise,
                  float* out, int n_sys, int L, cudaStream_t st) {
  const int S = segments(n_sys, L, P), m = segment_rows(L, S);
  const long long bytes =
      4LL * (4 + ((L * (P + 1) + 7LL) & ~3LL) + 2 * ((L + 7LL) & ~3LL));
  const int staged = S == kWarp && bytes <= smem_optin();
  const int smem = staged ? static_cast<int>(bytes) : 0;
  if (const int err = allow_smem(banded_sample_kernel<P>, smem)) return err;
  const int per = kWarp / S;
  banded_sample_kernel<P><<<(n_sys + per - 1) / per, kWarp, smem, st>>>(
      R, b, noise, out, n_sys, L, S, m, staged);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_solve(const float* R, const int* fidx, const float* b, float* out,
                 int n, int L, cudaStream_t st) {
  int C = kWarp;
  const int S = solve_split(n, L, P, &C), m = segment_rows(L, S);
  const int threads = S == 1 ? kWarp : kWarp * kSolveWarps;
  const long long bytes = 4LL * (kMaxP * kWarp + threads * odd(m));
  const int zsmem = S > 1 && bytes <= smem_optin();
  const int smem = zsmem ? static_cast<int>(bytes) : 4 * kMaxP * kWarp;
  const int blocks = (n + C - 1) / C;
  if (S == 1) {
    banded_solve_kernel<P, false><<<blocks, threads, 0, st>>>(
        R, fidx, b, out, n, L, C, S, m, zsmem);
  } else {
    if (const int err = allow_smem(banded_solve_kernel<P, true>, smem))
      return err;
    banded_solve_kernel<P, true><<<blocks, threads, smem, st>>>(
        R, fidx, b, out, n, L, C, S, m, zsmem);
  }
  return static_cast<int>(cudaGetLastError());
}

#define BANDED_DISPATCH(FN, ...)            \
  switch (p) {                              \
    case 0: return FN<0>(__VA_ARGS__);      \
    case 1: return FN<1>(__VA_ARGS__);      \
    case 2: return FN<2>(__VA_ARGS__);      \
    case 3: return FN<3>(__VA_ARGS__);      \
    case 4: return FN<4>(__VA_ARGS__);      \
    case 5: return FN<5>(__VA_ARGS__);      \
    case 6: return FN<6>(__VA_ARGS__);      \
    case 7: return FN<7>(__VA_ARGS__);      \
    case 8: return FN<8>(__VA_ARGS__);      \
    case 9: return FN<9>(__VA_ARGS__);      \
    case 10: return FN<10>(__VA_ARGS__);    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace deconv3d_banded

extern "C" {

// Upper banded Cholesky of `n_sys` systems of `L` rows and bandwidth `p`
// (rows of p + 1 floats) on `stream`.  Returns a cudaError_t (0 on
// success), checked right after the launch.
int banded_cholesky_launch(const float* bands, float* out, int n_sys, int L,
                           int p, float jitter, void* stream) {
  using namespace deconv3d_banded;
  if (n_sys < 1 || L < 1 || p < 0 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BANDED_DISPATCH(launch_cholesky, bands, out, n_sys, L, jitter, st)
}

// x ~ N(A^-1 b, A^-1) for A = R^T R of `n_sys` systems: `out` [n_sys, L]
// from R [n_sys, L, p + 1], b and noise [n_sys, L], on `stream`.
int banded_sample_launch(const float* R, const float* b, const float* noise,
                         float* out, int n_sys, int L, int p, void* stream) {
  using namespace deconv3d_banded;
  if (n_sys < 1 || L < 1 || p < 0 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BANDED_DISPATCH(launch_sample, R, b, noise, out, n_sys, L, st)
}

// x = R^-1 R^-T b for `n` lambda-major columns b [L, n] -> out [L, n]
// (may be b itself), column c against the factor R[fidx[c]] of R
// [n_factors, L, p + 1], on `stream`.
int banded_solve_launch(const float* R, const int* fidx, const float* b,
                        float* out, int n, int L, int p, void* stream) {
  using namespace deconv3d_banded;
  if (n < 1 || L < 1 || p < 0 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BANDED_DISPATCH(launch_solve, R, fidx, b, out, n, L, st)
}

// Segments per system (`solve` 0) or column (`solve` 1) that the draw or
// the solve cuts `n` systems or columns of `L` rows and bandwidth `p` into.
int banded_segments(int n, int L, int p, int solve) {
  using namespace deconv3d_banded;
  int C = kWarp;
  return solve ? solve_split(n, L, p, &C) : segments(n, L, p);
}

}  // extern "C"

// The running chi2 of a segment: the Kahan recurrence over its sweeps.
//
// Replaces no Pallas kernel: the JAX package carries the compensated chi2
// through the commit of every color step (deconv3d_tpu/sampler.py), inside
// the lax.scan over sweeps of run_sweeps, where XLA fuses it.  The port's sweep
// kernels write each sweep's per-(color, spaxel) Delta chi2 instead, and
// ops/sweep.py::_segment_tail reduces them per (sweep, chain) in float64
// after the segment's launches; this kernel then runs the recurrence
//
//   y = committed[s] - comp;  t = chi2 + y;  comp = (t - chi2) - y;  chi2 = t
//
// in float32, in sweep order, one thread per chain, so the segment's tail
// takes one launch and no host loop (its plain version, chi2_scan_reference
// in ops/sweep.py, is the same recurrence on [C] tensors).  __fadd_rn and
// __fsub_rn round each step to nearest, as torch's float32 add and sub do,
// and keep the compiler from reassociating or contracting it: the kernel
// gives the plain version's bits.
//
// Bound: latency, n dependent steps of four float32 additions per chain;
// the bytes (n C floats read, n C written) and the operations are nothing
// beside it.  The loads do not depend on the carry, so the unrolled loop
// starts them ahead of the chain.

#include <cuda_runtime.h>

namespace deconv3d_chi2 {

// committed [n, C]; chi2_in, comp_in, chi2_out, comp_out [C]; trace [C, n].
__global__ void chi2_scan_kernel(const float* __restrict__ committed,
                                 const float* __restrict__ chi2_in,
                                 const float* __restrict__ comp_in,
                                 float* __restrict__ trace,
                                 float* __restrict__ chi2_out,
                                 float* __restrict__ comp_out, int n, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float chi2 = chi2_in[c];
  float comp = comp_in[c];
  const float* col = committed + c;
  float* row = trace + static_cast<long long>(c) * n;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float y = __fsub_rn(__ldg(col + static_cast<long long>(s) * C), comp);
    const float t = __fadd_rn(chi2, y);
    comp = __fsub_rn(__fsub_rn(t, chi2), y);
    chi2 = t;
    row[s] = t;
  }
  chi2_out[c] = chi2;
  comp_out[c] = comp;
}

}  // namespace deconv3d_chi2

extern "C" {

// The Kahan scan of `n` sweeps of `C` chains on `stream` (layouts above).
// Returns a cudaError_t (0 on success), checked right after the launch.
int chi2_scan_launch(const float* committed, const float* chi2_in,
                     const float* comp_in, float* trace, float* chi2_out,
                     float* comp_out, int n, int C, void* stream) {
  if (n < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = C < 128 ? 32 * ((C + 31) / 32) : 128;
  deconv3d_chi2::chi2_scan_kernel<<<(C + threads - 1) / threads, threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      committed, chi2_in, comp_in, trace, chi2_out, comp_out, n, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// NOMA SIC uplink rate per (channel, decode-sorted user) for Hopper.
//
// Replaces the TPU kernel noma_rate (src/repro/kernels/noma_rate/kernel.py:46,
// body _kernel :28, pallas_call :52).  Plain version:
// repro_torch/kernels/noma_rate/ref.py::noma_rate_ref.
//
//   rate[b, m, i] = bw[b] · log2(1 + sig / (Σ_{j>i, key_j == key_i} contrib_j
//                                          + inter))
//
// What bounds it on an H100: bytes.  It reads four (B, M, U) rows and writes
// one; its arithmetic is U adds per channel for the in-group suffixes plus a
// log2 and a division per element.  At the solver's B=1, M=250 the bytes
// take about 2 µs, below a launch's own latency.
//
// Design: one block per (channel, cell) loads the channel's contrib and key
// rows into shared memory and takes every position's in-group suffix from
// one exclusive segmented suffix scan (seg_scan.cuh, shared with era_step):
// each thread sums a run of consecutive positions, a warp shuffle scan and
// the warps' aggregates in index order carry the sums across runs, and a
// group boundary stops the carry.  A group's last position gets the scan's
// identity, exactly 0.0 (an empty suffix, as the plain version's masked
// matvec gives), not a difference of two sums.  The order is fixed and no
// atomics are used, so repeated calls are bit-identical.  The scan needs
// equal keys in consecutive positions, which holds for the SIC tensors a
// Scenario carries (keys are the non-decreasing group-end indices); the
// wrapper checks it.  It replaces one serial walk per position, whose
// longest group (~U/N = 250 users) set each block's time.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
noma_rate_kernel(const float* contrib, const float* sig, const int* key,
                 const float* inter, const float* bw, float* out, int M,
                 int U) {
  extern __shared__ float smem[];
  __shared__ float red[64];
  float* s_c = smem;
  int* s_k = reinterpret_cast<int*>(smem + U);
  const int m = blockIdx.x, b = blockIdx.y;
  const size_t row = ((size_t)b * M + m) * U;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    s_c[i] = contrib[row + i];
    s_k[i] = key[row + i];
  }
  __syncthreads();
  float* v[1] = {s_c};
  const int* g[1] = {s_k};
  seg_scan<true, 1>(v, g, U, red);        // s_c[i] <- its in-group suffix
  const float w = bw[b];
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const float sinr = sig[row + i] / (s_c[i] + inter[row + i]);
    out[row + i] = w * log2f(1.f + sinr);
  }
}

}  // namespace

extern "C" int noma_rate_launch(const float* contrib, const float* sig,
                                const int* key, const float* inter,
                                const float* bw, float* out, int B, int M,
                                int U, void* stream) {
  const size_t smem = 2 * (size_t)U * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)noma_rate_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  noma_rate_kernel<<<dim3(M, B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      contrib, sig, key, inter, bw, out, M, U);
  return (int)cudaGetLastError();
}

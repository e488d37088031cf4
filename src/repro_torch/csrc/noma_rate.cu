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
// one; its arithmetic is the in-group pairs (about U²/(2N) per channel) plus
// a log2 and a division per element.  As written it stays far from that
// bound (PERF.md has the times): each thread's serial walk over its group
// sets a block's time, as in era_step.
//
// Design: one block per (channel, cell) loads the channel's contrib and key
// rows into shared memory; each thread walks the positions after its own
// while the key stays equal, so it adds only masked-in terms (an empty
// suffix is exactly 0.0) and touches only its group.  That walk needs equal
// keys to sit in consecutive positions, which holds for the SIC tensors a
// Scenario carries (keys are the non-decreasing group-end indices); the
// wrapper checks it.  Simple first: one thread per position, no tiling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
noma_rate_kernel(const float* contrib, const float* sig, const int* key,
                 const float* inter, const float* bw, float* out, int M,
                 int U) {
  extern __shared__ float smem[];
  float* s_c = smem;
  int* s_k = reinterpret_cast<int*>(smem + U);
  const int m = blockIdx.x, b = blockIdx.y;
  const size_t row = ((size_t)b * M + m) * U;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    s_c[i] = contrib[row + i];
    s_k[i] = key[row + i];
  }
  __syncthreads();
  const float w = bw[b];
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const int k = s_k[i];
    float intra = 0.f;
    for (int j = i + 1; j < U && s_k[j] == k; ++j) intra += s_c[j];
    const float sinr = sig[row + i] / (intra + inter[row + i]);
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

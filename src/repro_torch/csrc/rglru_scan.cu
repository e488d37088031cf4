// RG-LRU gated linear recurrence h_t = a_t ⊙ h_{t-1} + b_t from h_0 = 0,
// for Hopper.
//
// Replaces the TPU kernel rglru_scan
// (src/repro/kernels/rglru_scan/kernel.py:39, body _kernel :24,
// pallas_call :47).  Plain version:
// repro_torch/kernels/rglru_scan/ref.py::linear_scan_sequential.
//
// What bounds it on an H100: bytes.  It reads a and b and writes h, three
// (B, L, D) float32 arrays, and does two operations per element.
//
// Design: one thread per (batch, channel) walks L in order, its state in a
// register, so the recurrence needs no cross-thread step and no carry
// between blocks (the TPU kernel's sequential L grid axis and VMEM state
// become the thread's loop).  Neighbouring threads take neighbouring
// channels, so every load and store of a step is one coalesced row
// segment.  Each thread loads eight steps of a and b before it runs them,
// so enough loads are in flight to cover memory latency; the channel
// count times eight steps is the work in flight, which at B·D = 40960
// threads keeps about 2.6 MB of loads outstanding.  The multiply and add
// round separately (no fused multiply-add), as the plain version's two
// tensor operations do, so kernel and plain version agree bit for bit.
// No constraint on L or D: the TPU wrapper's L % lc == 0 is a tiling rule
// of its grid, not of the function.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 8;                 // steps loaded ahead

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int L, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.y * L * D + d;
  float state = 0.f;
  int t = 0;
  for (; t + kSteps <= L; t += kSteps) {
    float av[kSteps], bv[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const size_t i = base + (size_t)(t + u) * D;
      av[u] = __ldg(a + i);
      bv[u] = __ldg(b + i);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      h[base + (size_t)(t + u) * D] = state;
    }
  }
  for (; t < L; ++t) {
    const size_t i = base + (size_t)t * D;
    state = __fadd_rn(__fmul_rn(__ldg(a + i), state), __ldg(b + i));
    h[i] = state;
  }
}

}  // namespace

// a, b, h: (B, L, D) float32, contiguous.
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h,
                                 int B, int L, int D, void* stream) {
  if (B <= 0 || L <= 0 || D <= 0) return 0;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, L, D);
  return (int)cudaGetLastError();
}

// Causal / sliding-window flash attention with native GQA, for Hopper.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:84, body _kernel :30,
// pallas_call :102).  Plain version:
// repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
//   o[i, s] = Σ_t softmax_t(scale · q[i, s] · k[i / group, t])
//             · v[i / group, t]
//   over keys t with t <= s (causal) and t > s - window (window > 0).
//
// What bounds it on an H100: operations.  At the model's shapes (head_dim
// 256, one kv head, window 2048) each key a query reaches costs 4·D
// FLOP against 2·D bytes of k and v read once per kv head, so the tensor
// cores' bf16 rate, not the bytes, sets the least time.  This first kernel
// does its arithmetic in float32 on the CUDA cores (the TPU kernel's f32
// running max, sum and accumulator, and its f32 matmuls), so it runs well
// above that bound: PERF.md has the times.  wgmma/TMA is later work.
//
// Design: one block per (batch·head row, 32-query tile); a loop over
// 32-key tiles inside the block takes the place of the TPU grid's
// sequential third axis, carrying each row's running max m, sum l and
// accumulator in registers.  Four warps own eight query rows each.  The
// q tile (pre-scaled) and each k/v tile are converted to float32 in
// shared memory (at D=256: 32 KB of q, 33 KB of padded k, 32 KB of v, so
// two blocks fit an SM).  Scores: lane j takes key j of the tile and dots
// it with the warp's eight rows (k rows padded by 4 floats, so the 32
// lanes' float4 reads hit distinct banks; q reads are broadcasts).
// Softmax: warp shuffles give each row's tile max and sum.  Values: lane
// j owns columns j, j+32, ..., and takes each key's probability by
// shuffle.  Tiles that the causal/window test proves empty for the whole
// block are never visited (the TPU kernel's `reachable`), so window 2048
// at S=4096 visits 76% of full causal's tiles.  GQA reads the kv
// row i / group in place; k and v are never repeated.  Masked scores are
// the finite -2e38 of the TPU kernel, never -inf: a row whose first
// visited tile holds none of its keys gets exp(0) garbage there, and the
// next tile's alpha = exp(-2e38 - m) = 0 wipes it, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kWarps = 4;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 32;                   // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [r0, r0 + n) of a row-major (rows, D) array into float32 shared
// memory with row stride ld, times mul; rows at or past `limit` read as 0.
// 16-byte global loads, float4 shared stores.
template <typename T, int D>
__device__ void load_tile(const T* __restrict__ src, int r0, int n,
                          int limit, float* dst, int ld, float mul) {
  constexpr int V = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kChunks = D / V;          // loads per row
  for (int c = threadIdx.x; c < n * kChunks; c += blockDim.x) {
    const int r = c / kChunks, col = (c % kChunks) * V;
    float f[V];
    if (r0 + r < limit) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * D + col));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = to_f(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
    }
    float* out = dst + r * ld + col;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * D + kBK * (D + 4) + kBK * D) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int S, int Tk, int causal, int window, float scale) {
  constexpr int KLD = D + 4;              // padded k row (see the note)
  constexpr int DL = D / 32;              // accumulator columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // kBQ x D, pre-scaled
  float* Ks = Qs + kBQ * D;                      // kBK x KLD
  float* Vs = Ks + kBK * KLD;                    // kBK x D

  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // long rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t kv_off = (size_t)(row / group) * Tk * D;
  load_tile<T, D>(q + (size_t)row * S * D, q0, kBQ, S, Qs, D, scale);

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  // the keys any row of this block can reach
  const int k_begin = window ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  const float* qw = Qs + warp * kRows * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                      // the last tile is consumed
    load_tile<T, D>(k + kv_off, k0, kBK, Tk, Ks, KLD, 1.f);
    load_tile<T, D>(v + kv_off, k0, kBK, Tk, Vs, D, 1.f);
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KLD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      bool ok = kpos < Tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window) ok = ok && kpos > qpos - window;
      const float sr = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      s[r] = p;                           // lane j: key j's probability
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = Vs[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)row * S + qpos) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      from_f(acc[r][i] / denom, orow + lane + 32 * i);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int group, int S, int Tk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, S, Tk, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int group, int S, int Tk, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, BH, group, S, Tk, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, group, S, Tk, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, BH, group, S, Tk, causal, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (BH, S, D); k, v (BH / group, T, D).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH,
                                      int group, int S, int T, int D,
                                      int causal, int window, int dtype,
                                      float scale, void* stream) {
  if (BH <= 0 || S <= 0 || T <= 0 || group <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, BH, group, S, T, D, causal, window,
                           scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, BH, group, S, T, D, causal,
                                   window, scale, st);
  return (int)cudaErrorInvalidValue;
}

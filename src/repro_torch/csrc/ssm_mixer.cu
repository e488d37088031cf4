// Mamba-2 mixer's two elementwise passes around the SSD scan, for Hopper:
// the causal depthwise conv with its SiLU, and the gated RMS norm.
//
// Replaces no TPU kernel: the JAX package's Mamba-2 block
// (src/repro/models/ssm.py, _causal_conv and _out) is plain jnp, which
// XLA fuses on the TPU.  The port ran the same chains as separate PyTorch
// ops: the conv as 11 ops over the in_proj output's strided slice (~54
// bytes moved an element where 4 do), the gate and norm as ~10 (~66 where
// 6 do); on the chip's profiles of the mamba2-780m and
// granite-4.0-h-small serve cells they took more device time than the
// mixer's GEMMs and its SSD scan together.  Plain versions:
// repro_torch/kernels/ssm_mixer/ref.py (causal_conv_silu_ref,
// gated_rms_norm_ref), the model's plain ops in their order.
//
//   conv:  o[b, t, c] = silu(Σ_{k<W} x[b, t - W + 1 + k, c] · w[k, c] + bias[c])
//          (x before position 0 of each batch row reads as 0)
//   gate:  g = y · silu(z);  o = g · rsqrt(mean_c(g²) + eps) · w
//
// What bounds both on an H100: bytes (a few operations an element).  Each
// pass reads its operands once and writes its output once: the conv 2
// elements an element (x in, o out), the gate 3 (y and z in, o out); the
// weights are a few KB and stay in L1/L2.  Both keep float32 from load to
// store and round to the output's dtype once, where the plain bf16 path
// rounds after every tap and before the norm.
//
// conv design: each thread owns VEC consecutive channels (one 16-byte
// load in bf16 at the model widths) and a run of consecutive positions of
// one batch row; it keeps the W taps and the bias in registers as float32
// and the last W - 1 inputs in a sliding window, so each input is loaded
// once by its run (plus W - 1 halo rows at the run's start, mostly L2
// hits).  The next U positions load while these U are summed (a software
// pipeline), so each thread keeps U loads in flight.  Neighbouring threads own neighbouring
// channels: the loads and stores of a warp are contiguous.  The input is
// read in place at its batch and row strides (the in_proj output's slice).
//
// gate design: one block per (batch, position) row, of enough warps that
// each thread holds PER vectors of VEC channels; g = y·silu(z) stays in
// float32 registers between the sum of squares (warp shuffles, then the
// warps' sums in shared memory, in a fixed order: bit-identical across
// calls) and the scaled store.  y and z are read at their own strides.
//
// VEC (8, 4, 2 or 1 bf16 elements; 4, 2 or 1 float32) is the widest that
// every pointer, stride and the channel count allow; the wrapper picks it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kConvThreads = 256;
constexpr int kConvWidth = 4;             // W: every Mamba-2 model's conv
constexpr int kRun = 16;                  // positions a conv thread walks
constexpr int kUnroll = 4;                // positions a thread loads ahead
constexpr int kMaxGateThreads = 512;   // registers: up to 128 a thread

// VEC elements of T moved as one aligned load or store and held in
// 32-bit words (a bf16 pair a word, element 0 in the low half), unpacked
// to float32 by shifts and masks: everything stays in registers.
template <int NW> struct Words {
  static constexpr int kN = NW;
  unsigned w[NW];
};

template <typename T, int VEC> struct Io;

template <int VEC> struct Io<float, VEC> {
  typedef Words<VEC> Raw;
  static __device__ __forceinline__ Raw load(const float* p) {
    Raw r;
    if constexpr (VEC == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      r.w[0] = u.x, r.w[1] = u.y, r.w[2] = u.z, r.w[3] = u.w;
    } else if constexpr (VEC == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      r.w[0] = u.x, r.w[1] = u.y;
    } else {
      r.w[0] = *reinterpret_cast<const unsigned*>(p);
    }
    return r;
  }
  static __device__ __forceinline__ void unpack(const Raw& r,
                                                float (&f)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __uint_as_float(r.w[i]);
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&f)[VEC]) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      *p = f[0];
    }
  }
};

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int VEC> struct Io<bf16, VEC> {
  static constexpr int kWords = VEC > 1 ? VEC / 2 : 1;
  typedef Words<kWords> Raw;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    Raw r;
    if constexpr (VEC == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      r.w[0] = u.x, r.w[1] = u.y, r.w[2] = u.z, r.w[3] = u.w;
    } else if constexpr (VEC == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      r.w[0] = u.x, r.w[1] = u.y;
    } else if constexpr (VEC == 2) {
      r.w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      r.w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
    return r;
  }
  static __device__ __forceinline__ void unpack(const Raw& r,
                                                float (&f)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      f[i] = __uint_as_float(i % 2 ? r.w[i / 2] & 0xffff0000u
                                   : r.w[i / 2] << 16);
  }
  static __device__ __forceinline__ void store(bf16* p,
                                               const float (&f)[VEC]) {
    if constexpr (VEC == 1) {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(f[0]);
      return;
    } else {
      unsigned w[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      } else if constexpr (VEC == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<unsigned*>(p) = w[0];
      }
    }
  }
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  Io<T, VEC>::unpack(Io<T, VEC>::load(p), f);
}

// x·sigmoid(x) in float32: the exponential and the reciprocal by the
// special-function unit (__expf, __fdividef), each within a few float32
// ulp, far under the bf16 output's half ulp; the IEEE expf and division
// cost the conv about as many instructions as its bytes allow.  A
// denominator past 2^126 (x below about -87) gives -0, silu's limit.
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// ---------------------------------------------------------------- conv
// x (B, L, C) at batch stride sb and row stride sl (elements), channels
// contiguous; w (W, C) and bias (C,) contiguous; o (B, L, C) contiguous.
// One thread per (batch row, run of kRun positions, VEC channels).
template <typename T, int VEC>
__global__ void __launch_bounds__(kConvThreads)
    conv_silu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ o, int B,
                     int L, int C, long long sb, long long sl, int runs) {
  constexpr int W = kConvWidth;
  const int groups = C / VEC;
  const long long item =
      (long long)blockIdx.x * kConvThreads + threadIdx.x;
  if (item >= (long long)B * runs * groups) return;
  const int c0 = (int)(item % groups) * VEC;
  const long long rest = item / groups;
  const int run = (int)(rest % runs);
  const int b = (int)(rest / runs);

  typedef Io<T, VEC> V;
  typedef typename V::Raw R;
  float wt[W][VEC], bs[VEC];
#pragma unroll
  for (int k = 0; k < W; ++k) load_vec<T, VEC>(w + (long long)k * C + c0, wt[k]);
  load_vec<T, VEC>(bias + c0, bs);

  const T* xb = x + b * sb + c0;
  T* ob = o + (long long)b * L * C + c0;
  const int t0 = run * kRun;
  const int t1 = min(t0 + kRun, L);
  // win[j] holds x at t - (W - 1) + j for the next position t, as loaded
  // (the window and the loads ahead stay in their storage type: half the
  // registers of float32 in bf16)
  R win[W - 1];
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {
    const int t = t0 - (W - 1) + j;
    if (t >= 0) {
      win[j] = V::load(xb + t * sl);
    } else {
#pragma unroll
      for (int i = 0; i < V::Raw::kN; ++i) win[j].w[i] = 0u;  // +0
    }
  }
  // software pipeline: the next kUnroll positions load while these sum
  R nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (t0 + u < t1) nxt[u] = V::load(xb + (t0 + u) * sl);
  for (int t = t0; t < t1; t += kUnroll) {
    R cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t + kUnroll + u < t1) nxt[u] = V::load(xb + (t + kUnroll + u) * sl);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < t1) {
        // the plain version's order: the newest tap first
        float acc[VEC], tap[VEC];
        V::unpack(cur[u], tap);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = tap[v] * wt[W - 1][v];
#pragma unroll
        for (int i = 1; i < W; ++i) {
          V::unpack(win[W - 1 - i], tap);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += tap[v] * wt[W - 1 - i][v];
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = silu(acc[v] + bs[v]);
        V::store(ob + (long long)(t + u) * C, acc);
#pragma unroll
        for (int j = 0; j + 1 < W - 1; ++j) win[j] = win[j + 1];
        win[W - 2] = cur[u];
      }
    }
  }
}

// ---------------------------------------------------------------- gate
// y and z (B, L, C) at their own batch and row strides, channels
// contiguous; w (C,) contiguous; o (B, L, C) contiguous.  One block per
// (batch, position) row; thread i holds vectors i, i + threads, ... (PER
// of them at most).
template <typename T, int VEC, int PER>
__global__ void __launch_bounds__(kMaxGateThreads)
    gated_norm_kernel(const T* __restrict__ y, const T* __restrict__ z,
                      const T* __restrict__ w, T* __restrict__ o, int L,
                      int C, long long y_sb, long long y_sl, long long z_sb,
                      long long z_sl, float eps) {
  __shared__ float warp_sums[kMaxGateThreads / 32];
  const int row = blockIdx.x;
  const int b = row / L, t = row % L;
  const T* yr = y + b * y_sb + t * y_sl;
  const T* zr = z + b * z_sb + t * z_sl;
  const int groups = C / VEC;
  float g[PER][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int gi = threadIdx.x + p * blockDim.x;
    if (gi < groups) {
      float yv[VEC], zv[VEC];
      load_vec<T, VEC>(yr + gi * VEC, yv);
      load_vec<T, VEC>(zr + gi * VEC, zv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        g[p][v] = yv[v] * silu(zv[v]);
        ss += g[p][v] * g[p][v];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < n_warps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) warp_sums[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(warp_sums[0] / (float)C + eps);
  T* orow = o + (long long)row * C;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int gi = threadIdx.x + p * blockDim.x;
    if (gi < groups) {
      float wv[VEC], out[VEC];
      load_vec<T, VEC>(w + gi * VEC, wv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[v] = g[p][v] * r * wv[v];
      Io<T, VEC>::store(orow + gi * VEC, out);
    }
  }
}

// one call's operands and sizes (strides in elements)
struct ConvArgs {
  const void *x, *w, *bias;
  void* o;
  int B, L, C;
  long long sb, sl;
  cudaStream_t stream;
};

struct GateArgs {
  const void *y, *z, *w;
  void* o;
  int B, L, C;
  long long y_sb, y_sl, z_sb, z_sl;
  float eps;
  int per, threads;
  cudaStream_t stream;
};

template <typename T, int VEC>
int conv_launch(const ConvArgs& a) {
  const int runs = (a.L + kRun - 1) / kRun;
  const long long items = (long long)a.B * runs * (a.C / VEC);
  const long long blocks = (items + kConvThreads - 1) / kConvThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  conv_silu_kernel<T, VEC><<<(unsigned)blocks, kConvThreads, 0,
                             a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.bias), static_cast<T*>(a.o), a.B, a.L, a.C,
      a.sb, a.sl, runs);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int PER>
int gate_launch_per(const GateArgs& a) {
  gated_norm_kernel<T, VEC, PER><<<a.B * a.L, a.threads, 0, a.stream>>>(
      static_cast<const T*>(a.y), static_cast<const T*>(a.z),
      static_cast<const T*>(a.w), static_cast<T*>(a.o), a.L, a.C, a.y_sb,
      a.y_sl, a.z_sb, a.z_sl, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int gate_launch(const GateArgs& a) {
  switch (a.per) {
    case 1: return gate_launch_per<T, VEC, 1>(a);
    case 2: return gate_launch_per<T, VEC, 2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the instantiation of dtype (0 float32, 1 bfloat16) and vec
template <template <typename, int> class Launch, typename Args>
int by_type(const Args& a, int dtype, int vec) {
  if (dtype == 0) {
    switch (vec) {
      case 1: return Launch<float, 1>::run(a);
      case 2: return Launch<float, 2>::run(a);
      case 4: return Launch<float, 4>::run(a);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return Launch<bf16, 1>::run(a);
      case 2: return Launch<bf16, 2>::run(a);
      case 4: return Launch<bf16, 4>::run(a);
      case 8: return Launch<bf16, 8>::run(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
struct Conv {
  static int run(const ConvArgs& a) { return conv_launch<T, VEC>(a); }
};

template <typename T, int VEC>
struct Gate {
  static int run(const GateArgs& a) { return gate_launch<T, VEC>(a); }
};

}  // namespace

// x (B, L, C) at batch and row strides sb, sl (elements; channels
// contiguous); w (W, C), bias (C,) and o (B, L, C) contiguous; every
// pointer and stride a multiple of vec elements, C too.  dtype 0 float32
// (vec 1, 2, 4), 1 bfloat16 (vec 1, 2, 4, 8).  W = kConvWidth.
extern "C" int ssm_conv_silu_launch(const void* x, const void* w,
                                    const void* bias, void* o, int B, int L,
                                    int C, long long sb, long long sl,
                                    int vec, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0) return 0;
  if (vec <= 0 || C % vec) return (int)cudaErrorInvalidValue;
  const ConvArgs a{x, w, bias, o, B, L, C, sb, sl,
                   static_cast<cudaStream_t>(stream)};
  return by_type<Conv>(a, dtype, vec);
}

// y and z (B, L, C) at their (batch, row) strides (elements; channels
// contiguous); w (C,) and o (B, L, C) contiguous; pointers, strides and C
// multiples of vec elements.  One block of `threads` (a multiple of 32,
// at most 512) a row, each thread at most `per` (1 or 2) vectors:
// threads · per · vec >= C.  dtype as above.  Per 2 is the most a model
// layout needs: granite-4.0-h-small's 8192 channels in bf16 vectors of 8
// (float32 mamba2-780m's 3072 in vectors of 4, too).
extern "C" int ssm_gated_norm_launch(const void* y, const void* z,
                                     const void* w, void* o, int B, int L,
                                     int C, long long y_sb, long long y_sl,
                                     long long z_sb, long long z_sl,
                                     float eps, int vec, int per, int threads,
                                     int dtype, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0) return 0;
  if (vec <= 0 || C % vec || threads <= 0 || threads % 32 ||
      threads > kMaxGateThreads || (long long)threads * per * vec < C ||
      (long long)B * L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const GateArgs a{y, z, w, o, B, L, C, y_sb, y_sl, z_sb, z_sl, eps, per,
                   threads, static_cast<cudaStream_t>(stream)};
  return by_type<Gate>(a, dtype, vec);
}

// Mamba-2 SSD (state-space duality) chunked scan, for Hopper.
//
// Replaces the TPU kernel ssd_bhcqp (src/repro/kernels/ssd/kernel.py:74,
// body _kernel :28, pallas_call :83).  Plain version:
// repro_torch/kernels/ssd/ref.py::ssd_chunked.
//
// Per (batch b, head h), over chunks of Q rows with in-chunk inclusive
// cumsum cs of dt·A and total = cs at the chunk's last row:
//   y_i = Σ_{j<=i} exp(cs_i - cs_j) (C_i·B_j) dt_j x_j      (intra-chunk)
//       + exp(cs_i) C_i·S                                   (inter-chunk)
//       + D_h x_i
//   S  <- exp(total) S + Σ_j exp(total - cs_j) dt_j x_j B_jᵀ  (S: P x N)
// and the final S of every (b, h).
//
// What bounds it on an H100: at mamba2-780m's shape (H=48, P=64, N=128,
// Q=256, bf16 x/B/C) the bytes (x and y once, B and C once) bound it at
// about 0.14 ms; the operations (the causal half of C·Bᵀ and of the
// weighted sum, the state in and out: ~80 GFLOP) at about 0.08 ms on the
// tensor cores.  This first kernel does its arithmetic in float32 on the
// CUDA cores and recomputes C·Bᵀ for every head, so it runs well above
// either bound: PERF.md has the times.  mma.sync / wgmma are later work.
//
// Design: one block per (batch, head) walks the chunks in order, the
// (P, N) float32 state in shared memory all the way (the TPU grid's
// sequential chunk axis and its VMEM scratch state become the block's
// loop; blocks run in no order, so the carry cannot cross blocks).  The
// (Q, Q) decay matrix is never formed (256 KB in float32 at Q=256, more
// than a block's shared memory): a chunk is walked in 64-row query tiles
// and, for each, the 32-row key tiles at or below the diagonal; each
// pair's weight exp(cs_i - cs_j)·(C_i·B_j) is formed in a 64x32 tile and
// applied to dt_j x_j at once.  Pairs with j > i are skipped, not masked
// with a sentinel.  Only non-positive differences are exponentiated
// (cs_i - cs_j for i >= j, cs_i, total - cs_j): A runs down to -48, and
// exp(-cs_j) alone would overflow.  Order within a chunk: every query
// tile reads the state *entering* the chunk; then a second walk over the
// key tiles updates the state.  y = intra + inter + D·x in float32,
// rounded once to x's dtype.  x, B and C are read in the model's layout
// in place (row strides given), float32 or bfloat16; rows at or past L
// read as zero with dt = 0, so a ragged last chunk decays by exactly 1
// and adds exactly 0.  Every sum runs in a fixed order with no atomics,
// so repeated runs are bit-identical.  Shared memory at P=64, N=128:
// 98 KB (state 32, C tile 32, B tile 16, dt·x 8, weights 8, cs and dt 2),
// so two blocks fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;                // rows of a chunk
constexpr int kTI = 64;                   // query rows per tile
constexpr int kTJ = 32;                   // key rows per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// R consecutive floats from 16-byte (R >= 4) or 8-byte aligned shared
// memory.
template <int R>
__device__ __forceinline__ void lds(const float* p, float (&v)[R]) {
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

// One 16-byte load of V = 16 / sizeof(T) elements as float32, or zeros
// where the row is not valid.
template <typename T>
__device__ __forceinline__ void ldg16(const T* src, bool valid,
                                      float (&f)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  if (valid) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = 0.f;
  }
}

// Rows [r0, r0 + ROWS) of a (rows, W) array with row stride `ld` into
// float32 shared memory, transposed: dst[w * ROWS + r].  Rows at or past
// `nvalid` read as 0.  Neighbouring threads take neighbouring rows, so
// the transposed stores hit distinct banks.
template <typename T, int W, int ROWS>
__device__ void load_transposed(const T* __restrict__ src, long long ld,
                                int r0, int nvalid, float* dst) {
  constexpr int V = 16 / sizeof(T);
  for (int c = threadIdx.x; c < ROWS * (W / V); c += kThreads) {
    const int r = c % ROWS, col = (c / ROWS) * V;
    float f[V];
    ldg16<T>(src + (size_t)(r0 + r) * ld + col, r0 + r < nvalid, f);
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(col + e) * ROWS + r] = f[e];
  }
}

// Rows [r0, r0 + ROWS) of a (rows, W) array with row stride `ld` into
// float32 shared memory, row-major: dst[r * W + w], each row times
// mul[r0 + r] (dt) and, with kDecay, times exp(total - cs[r0 + r]).
// Rows at or past `nvalid` read as 0.  With mul == nullptr, no scaling.
template <typename T, int W, int ROWS, bool kDecay>
__device__ void load_rows(const T* __restrict__ src, long long ld, int r0,
                          int nvalid, float* dst, const float* mul,
                          const float* cs, float total) {
  constexpr int V = 16 / sizeof(T);
  for (int c = threadIdx.x; c < ROWS * (W / V); c += kThreads) {
    const int r = c / (W / V), col = (c % (W / V)) * V;
    float f[V];
    ldg16<T>(src + (size_t)(r0 + r) * ld + col, r0 + r < nvalid, f);
    if (mul != nullptr) {
      const float m = mul[r0 + r];
      const float dec = kDecay ? expf(total - cs[r0 + r]) : 1.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        f[e] = __fmul_rn(f[e], m);
        if (kDecay) f[e] = __fmul_rn(f[e], dec);
      }
    }
    float* out = dst + r * W + col;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(out + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <int P, int N>
constexpr size_t smem_bytes() {
  return (size_t)(N * P + N * kTI + N * kTJ + kTJ * P + kTJ * kTI +
                  2 * kMaxQ) * sizeof(float);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ D,
           T* __restrict__ y, float* __restrict__ fin, int L, int Q,
           long long x_sb, long long x_st, long long b_sb, long long b_st,
           long long c_sb, long long c_st) {
  constexpr int RP = P / 16;              // state / output columns a thread
  constexpr int RN = N / 16;              // state rows a thread
  extern __shared__ float4 smem4[];
  float* St = reinterpret_cast<float*>(smem4);  // N x P: St[n][p] = S[p][n]
  float* Ct = St + N * P;                 // N x kTI, C tile transposed
  float* Bt = Ct + N * kTI;               // N x kTJ (G) or kTJ x N (state)
  float* Xb = Bt + N * kTJ;               // kTJ x P, dt_j x_j
  float* Wt = Xb + kTJ * P;               // kTJ x kTI, weights transposed
  float* cs = Wt + kTJ * kTI;             // kMaxQ
  float* dts = cs + kMaxQ;                // kMaxQ

  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, t16 = tid % 16, s16 = tid / 16;
  const float a = A[h], dd = D[h];
  const T* xh = x + (size_t)b * x_sb + (size_t)h * P;   // row t: + t*x_st
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cc = Cm + (size_t)b * c_sb;
  const float* dth = dt + (size_t)b * L * H + h;        // row t: + t*H
  T* yh = y + ((size_t)b * L * H + h) * P;              // row t: + t*H*P

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int qv = min(Q, L - c0);        // valid rows of this chunk
    const T* xc = xh + (size_t)c0 * x_st;
    const T* bc = bb + (size_t)c0 * b_st;
    const T* ccur = cc + (size_t)c0 * c_st;
    __syncthreads();                      // the last chunk is done
    for (int r = tid; r < kMaxQ; r += kThreads)
      dts[r] = r < qv ? dth[(size_t)(c0 + r) * H] : 0.f;
    __syncthreads();
    if (tid < 32) {                       // inclusive cumsum of dt·A
      constexpr int kPer = kMaxQ / 32;
      float v[kPer], run = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        v[k] = run = __fadd_rn(run, __fmul_rn(dts[tid * kPer + k], a));
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(kFull, incl, o);
        if (tid >= o) incl = __fadd_rn(incl, up);
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        cs[tid * kPer + k] = __fadd_rn(excl, v[k]);
    }
    __syncthreads();
    const float total = cs[qv - 1];

    // ---- outputs: query tiles against the state entering the chunk ----
    for (int i0 = 0; i0 < qv; i0 += kTI) {
      load_transposed<T, N, kTI>(ccur, c_st, i0, qv, Ct);
      __syncthreads();
      // thread: rows 4*s16 .. +3 of the tile, columns RP*t16 .. +RP-1
      float acc_e[4][RP], acc_a[4][RP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) acc_e[r][q] = acc_a[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {       // C_i · S
        float cv[4], sv[RP];
        lds<4>(Ct + n * kTI + 4 * s16, cv);
        lds<RP>(St + n * P + RP * t16, sv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q)
            acc_e[r][q] = fmaf(cv[r], sv[q], acc_e[r][q]);
      }
      const int j_end = min(i0 + kTI, qv);
      for (int j0 = 0; j0 < j_end; j0 += kTJ) {
        __syncthreads();                  // the last key tile is consumed
        load_transposed<T, N, kTJ>(bc, b_st, j0, qv, Bt);
        load_rows<T, P, kTJ, false>(xc, x_st, j0, qv, Xb, dts, cs, total);
        __syncthreads();
        // weights: thread rows 4*t16 .. +3, keys 2*s16, 2*s16 + 1
        float g[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) g[r][0] = g[r][1] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[2];
          lds<4>(Ct + n * kTI + 4 * t16, cv);
          lds<2>(Bt + n * kTJ + 2 * s16, bv);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            g[r][0] = fmaf(cv[r], bv[0], g[r][0]);
            g[r][1] = fmaf(cv[r], bv[1], g[r][1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 2 * s16 + e;
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + 4 * t16 + r;
            w[r] = j <= i ? expf(cs[i] - cs[j]) * g[r][e] : 0.f;
          }
          *reinterpret_cast<float4*>(Wt + (2 * s16 + e) * kTI + 4 * t16) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        for (int j = 0; j < kTJ; ++j) {   // Σ_j w_ij dt_j x_j
          float wv[4], xv[RP];
          lds<4>(Wt + j * kTI + 4 * s16, wv);
          lds<RP>(Xb + j * P + RP * t16, xv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < RP; ++q)
              acc_a[r][q] = fmaf(wv[r], xv[q], acc_a[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * s16 + r;
        if (i >= qv) continue;
        const float ei = expf(cs[i]);
        const T* xr = xc + (size_t)i * x_st + RP * t16;
        T* yr = yh + (size_t)(c0 + i) * H * P + RP * t16;
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          const float v = fmaf(ei, acc_e[r][q], acc_a[r][q]);
          from_f(fmaf(dd, to_f(xr[q]), v), yr + q);
        }
      }
      __syncthreads();                    // Ct is consumed
    }

    // ---- state update: S <- e^total S + Σ_j e^(total-cs_j) dt_j x_j B_jᵀ
    // thread: state rows n = RN*t16 .. +RN-1, columns p = RP*s16 .. +RP-1
    float acc[RN][RP];
    const float et = expf(total);
#pragma unroll
    for (int k = 0; k < RN; ++k) {
      float sv[RP];
      lds<RP>(St + (RN * t16 + k) * P + RP * s16, sv);
#pragma unroll
      for (int q = 0; q < RP; ++q) acc[k][q] = et * sv[q];
    }
    for (int j0 = 0; j0 < qv; j0 += kTJ) {
      __syncthreads();
      load_rows<T, N, kTJ, false>(bc, b_st, j0, qv, Bt, nullptr, cs, total);
      load_rows<T, P, kTJ, true>(xc, x_st, j0, qv, Xb, dts, cs, total);
      __syncthreads();
      for (int j = 0; j < kTJ; ++j) {
        float bv[RN], xv[RP];
        lds<RN>(Bt + j * N + RN * t16, bv);
        lds<RP>(Xb + j * P + RP * s16, xv);
#pragma unroll
        for (int k = 0; k < RN; ++k)
#pragma unroll
          for (int q = 0; q < RP; ++q)
            acc[k][q] = fmaf(bv[k], xv[q], acc[k][q]);
      }
    }
#pragma unroll
    for (int k = 0; k < RN; ++k)
#pragma unroll
      for (int q = 0; q < RP; ++q)
        St[(RN * t16 + k) * P + RP * s16 + q] = acc[k][q];
  }
  __syncthreads();
  float* fh = fin + ((size_t)b * H + h) * P * N;        // (P, N)
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    fh[i] = St[n * P + p];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, void* y, float* fin, int Bt,
           int L, int H, int Q, long long x_sb, long long x_st,
           long long b_sb, long long b_st, long long c_sb, long long c_st,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)ssd_kernel<T, P, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, Bt);
  ssd_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), fin, L, Q, x_sb,
      x_st, b_sb, b_st, c_sb, c_st);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_n(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, void* y, float* fin, int Bt,
             int L, int H, int N, int Q, long long x_sb, long long x_st,
             long long b_sb, long long b_st, long long c_sb, long long c_st,
             cudaStream_t stream) {
  switch (N) {
    case 32:
      return launch<T, P, 32>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, Q, x_sb,
                              x_st, b_sb, b_st, c_sb, c_st, stream);
    case 64:
      return launch<T, P, 64>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, Q, x_sb,
                              x_st, b_sb, b_st, c_sb, c_st, stream);
    case 128:
      return launch<T, P, 128>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, Q,
                               x_sb, x_st, b_sb, b_st, c_sb, c_st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, void* y, float* fin, int Bt,
             int L, int H, int P, int N, int Q, long long x_sb,
             long long x_st, long long b_sb, long long b_st, long long c_sb,
             long long c_st, cudaStream_t stream) {
  switch (P) {
    case 32:
      return launch_n<T, 32>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, N, Q,
                             x_sb, x_st, b_sb, b_st, c_sb, c_st, stream);
    case 64:
      return launch_n<T, 64>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, N, Q,
                             x_sb, x_st, b_sb, b_st, c_sb, c_st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  x (Bt, L, H, P)
// with batch stride x_sb and row stride x_st (elements), heads and the
// head dim contiguous; dt (Bt, L, H) float32, contiguous; A, D (H,)
// float32; B, C (Bt, L, N) with batch and row strides, N contiguous;
// y (Bt, L, H, P) contiguous; fin (Bt, H, P, N) float32.  P in {32, 64},
// N in {32, 64, 128}, 1 <= Q <= 256.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, const float* D,
                          void* y, float* fin, int Bt, int L, int H, int P,
                          int N, int Q, long long x_sb, long long x_st,
                          long long b_sb, long long b_st, long long c_sb,
                          long long c_st, int dtype, void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0) return 0;
  if (Q <= 0 || Q > kMaxQ) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, P, N, Q,
                           x_sb, x_st, b_sb, b_st, c_sb, c_st, st);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, fin, Bt, L, H, P,
                                   N, Q, x_sb, x_st, b_sb, b_st, c_sb, c_st,
                                   st);
  return (int)cudaErrorInvalidValue;
}

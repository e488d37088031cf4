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
// tensor cores.  The first port walked the chunks of each (batch, head) in
// one block, in order, in float32 on the CUDA cores, and recomputed C·Bᵀ
// for every head: about 1.6x the operations the function needs, at the
// CUDA cores' rate (PERF.md has the times).
//
// bf16 design: the SSD algorithm of the Mamba-2 paper (arXiv:2405.21060,
// §6) in three launches, every product on the tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulate), every sum in a fixed order with
// no atomics, so repeated calls are bit-identical:
//   1. states <<<(chunk x head group of 4, batch)>>>: each chunk's own
//      state s_c = Σ_j x_j (w_j B_j)ᵀ with w_j = exp(total - cs_j)·dt_j,
//      chunks in parallel.  x enters as its own exact bf16 (A operand,
//      ldmatrix.trans of the row-major tile); w_j·B_j is formed in float32
//      in the B fragments and enters as a bf16 head plus a bf16 remainder,
//      two products, so the state carries ~16 bits of the weights.  B's
//      tile is loaded once for the head group.  Writes s_c to a float32
//      scratch and total to another.
//   2. pass: S_c = exp(total_c)·S_{c-1} + s_c in chunk order, one thread
//      per 4 state entries with 8 chunks' loads in flight; writes each
//      entering state as a bf16 head plane and a remainder plane (the same
//      bytes as float32) and the final state.  Not in place over s_c: the
//      planes are what the out kernel's products read, split once here
//      instead of in each of its four query-tile blocks; the price is a
//      second 201 MB buffer at the model shape, not more traffic.
//   3. out <<<(chunk x head group of 8 x 64-row query tile, batch)>>>, 4
//      warps of 16 rows, two blocks an SM: the tile's G = C·Bᵀ against
//      every key up to the diagonal is computed ONCE for the 8 heads and
//      kept in registers (at most 128 floats a thread) in the accumulator
//      layout, which is the A-fragment layout of the next product, so no
//      (Q, Q) matrix is stored.  Per head: Y = exp(cs_i)·(C_i·S_{c-1}) on
//      the state's two planes while the head's x lands, then Y += W·X
//      while the next head's state lands, W_ij = exp(cs_i - cs_j)·G_ij·dt_j
//      formed from G's registers as bf16 head + remainder and x exact, then
//      y = Y + D·x rounded once to bf16.  G is counted back from the
//      diagonal, so the diagonal k-step (keys past the row zeroed, each
//      exponent taken as it is) has one copy of its code and the unrolled
//      loop stays small (a copy per k-step ran markedly slower on an
//      H100, likely as the unrolled loop outgrew the instruction cache).
//      Below the diagonal exp(cs_i - cs_j) = exp(cs_i - cs_r)·exp(cs_r -
//      cs_j) at the k-step's last key r, both exponents <= 0: a per-head
//      key table holds exp(cs_r - cs_j)·dt_j, so each weight costs two
//      multiplies and each k-step two exponentials a thread.
// The chunk states are the design's price in bytes: at the model shape one
// set is 201 MB, written by 1, read by 2, written as planes by 2 and read
// by 3 (its four query-tile blocks run side by side, so three of the four
// reads mostly hit L2): 805 MB beside the bound's 451 MB.
// Only non-positive differences are exponentiated (cs_i - cs_j for
// i >= j, cs_i, total - cs_j, total): A runs down to -48, and exp(-cs_j)
// alone would overflow.  x, B, C and the state planes are read in place
// at their strides with cp.async 16-byte copies; rows at or past L read
// as zero with dt = 0, so a ragged last chunk decays by exactly 1 and adds
// exactly 0.
//
// float32 design (dtype 0: the f32 model and tests, held at 1e-4): the
// first port's kernel, kept on the CUDA cores as flash_attention's float32
// path is (TF32 would miss the bar): one block per (batch, head) walks the
// chunks in order with the (P, N) state in shared memory; a chunk is walked
// in 64-row query tiles and, for each, the 32-row key tiles at or below the
// diagonal; every query tile reads the state entering the chunk, then a
// second walk over the key tiles updates it.  98 KB of shared memory at
// P=64, N=128, two blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kMaxQ = 256;                // rows of a chunk
constexpr unsigned kFull = 0xffffffffu;

// ============================================================ float32

constexpr int kThreads = 256;
constexpr int kTI = 64;                   // query rows per tile
constexpr int kTJ = 32;                   // key rows per tile

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

// One 16-byte load of 4 floats, or zeros where the row is not valid.
__device__ __forceinline__ void ldg16(const float* src, bool valid,
                                      float (&f)[4]) {
  const float4 t = valid ? __ldg(reinterpret_cast<const float4*>(src))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  f[0] = t.x;
  f[1] = t.y;
  f[2] = t.z;
  f[3] = t.w;
}

// Rows [r0, r0 + ROWS) of a (rows, W) array with row stride `ld` into
// shared memory, transposed: dst[w * ROWS + r].  Rows at or past `nvalid`
// read as 0.  Neighbouring threads take neighbouring rows, so the
// transposed stores hit distinct banks.
template <int W, int ROWS>
__device__ void load_transposed(const float* __restrict__ src, long long ld,
                                int r0, int nvalid, float* dst) {
  for (int c = threadIdx.x; c < ROWS * (W / 4); c += kThreads) {
    const int r = c % ROWS, col = (c / ROWS) * 4;
    float f[4];
    ldg16(src + (size_t)(r0 + r) * ld + col, r0 + r < nvalid, f);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(col + e) * ROWS + r] = f[e];
  }
}

// Rows [r0, r0 + ROWS) of a (rows, W) array with row stride `ld` into
// shared memory, row-major: dst[r * W + w], each row times mul[r0 + r]
// (dt) and, with kDecay, times exp(total - cs[r0 + r]).  Rows at or past
// `nvalid` read as 0.  With mul == nullptr, no scaling.
template <int W, int ROWS, bool kDecay>
__device__ void load_rows(const float* __restrict__ src, long long ld, int r0,
                          int nvalid, float* dst, const float* mul,
                          const float* cs, float total) {
  for (int c = threadIdx.x; c < ROWS * (W / 4); c += kThreads) {
    const int r = c / (W / 4), col = (c % (W / 4)) * 4;
    float f[4];
    ldg16(src + (size_t)(r0 + r) * ld + col, r0 + r < nvalid, f);
    if (mul != nullptr) {
      const float m = mul[r0 + r];
      const float dec = kDecay ? expf(total - cs[r0 + r]) : 1.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = __fmul_rn(f[e], m);
        if (kDecay) f[e] = __fmul_rn(f[e], dec);
      }
    }
    *reinterpret_cast<float4*>(dst + r * W + col) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <int P, int N>
constexpr size_t f32_smem_bytes() {
  return (size_t)(N * P + N * kTI + N * kTJ + kTJ * P + kTJ * kTI +
                  2 * kMaxQ) * sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ D,
               float* __restrict__ y, float* __restrict__ fin, int L, int Q,
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
  const float* xh = x + (size_t)b * x_sb + (size_t)h * P;  // row t: + t*x_st
  const float* bb = Bm + (size_t)b * b_sb;
  const float* cc = Cm + (size_t)b * c_sb;
  const float* dth = dt + (size_t)b * L * H + h;           // row t: + t*H
  float* yh = y + ((size_t)b * L * H + h) * P;             // row t: + t*H*P

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int qv = min(Q, L - c0);        // valid rows of this chunk
    const float* xc = xh + (size_t)c0 * x_st;
    const float* bc = bb + (size_t)c0 * b_st;
    const float* ccur = cc + (size_t)c0 * c_st;
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
      load_transposed<N, kTI>(ccur, c_st, i0, qv, Ct);
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
        load_transposed<N, kTJ>(bc, b_st, j0, qv, Bt);
        load_rows<P, kTJ, false>(xc, x_st, j0, qv, Xb, dts, cs, total);
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
        const float* xr = xc + (size_t)i * x_st + RP * t16;
        float* yr = yh + (size_t)(c0 + i) * H * P + RP * t16;
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          const float v = fmaf(ei, acc_e[r][q], acc_a[r][q]);
          yr[q] = fmaf(dd, xr[q], v);
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
      load_rows<N, kTJ, false>(bc, b_st, j0, qv, Bt, nullptr, cs, total);
      load_rows<P, kTJ, true>(xc, x_st, j0, qv, Xb, dts, cs, total);
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

// =============================================================== bf16

constexpr int kWarps = 4;                 // warps of the states/out blocks
constexpr int kBlock = 32 * kWarps;
constexpr int kHS = 4;                    // heads per states block
constexpr int kHO = 8;                    // heads per out block: share G
constexpr int kTQ = 16 * kWarps;          // query rows per out block
constexpr int kPer = kMaxQ / 32;          // chunk rows per lane in a scan
constexpr int kPassThreads = 256;
constexpr int kPassDepth = 8;             // chunks' loads in flight

// Strides and sizes of one call, in elements.
struct Geom {
  int Bt, L, H, Q, nc;
  long long x_sb, x_st, b_sb, b_st, c_sb, c_st;
};

// bf16 tiles are row-major with 8 elements of padding a row, so the 8
// row addresses of an ldmatrix land in 8 distinct 16-byte bank groups.
template <int W>
__host__ __device__ constexpr int ld_of() { return W + 8; }

template <int P, int N>
constexpr size_t states_smem_bytes() {
  return (size_t)kMaxQ * (ld_of<N>() + ld_of<P>()) * sizeof(bf16) +
         (size_t)kHS * kMaxQ * sizeof(float);
}

// the out kernel's shared region: B's tile, or x's and the state's halves
template <int P, int N>
__host__ __device__ constexpr size_t out_region_bytes() {
  const size_t g = (size_t)kMaxQ * ld_of<N>();
  const size_t h = (size_t)kMaxQ * ld_of<P>() + 2 * (size_t)P * ld_of<N>();
  return (g > h ? g : h) * sizeof(bf16);
}

template <int P, int N>
constexpr size_t out_smem_bytes() {   // + cs, dt and the decay table
  return (size_t)kTQ * ld_of<N>() * sizeof(bf16) + out_region_bytes<P, N>() +
         3 * (size_t)kHO * kMaxQ * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a · b, m16n8k16, bf16 in, float32 accumulate; a pure register
// operation (not volatile), so the compiler may schedule it freely
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> their bf16 heads and the bf16 of what the heads leave out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                          uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const uint32_t hu = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __uint_as_float(hu << 16), x1 - __uint_as_float(hu & 0xffff0000u));
  *hi = hu;
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the two bf16 of a packed pair as float32, first element first
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Rows [0, rows) of a (rows, W) bf16 array with row stride `ld` into a
// padded shared tile by cp.async; rows at or past `nvalid` are zeros.
template <int W>
__device__ __forceinline__ void copy_rows(const bf16* src, long long ld,
                                          int rows, int nvalid, bf16* dst) {
  constexpr int kChunks = W / 8;          // 16-byte pieces a row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < nvalid;
    cp_async_16(dst + r * ld_of<W>() + c, ok ? src + r * ld + c : src, ok);
  }
}

// dt of the chunk's kMaxQ rows for heads h0 .. h0 + HG - 1 into
// out[hh * kMaxQ + r]: zeros past the chunk's qv rows and past H.
// Neighbouring threads take neighbouring heads of one row.
template <int HG>
__device__ __forceinline__ void load_dt(const float* dt, const Geom& g,
                                        int b, int c0, int qv, int h0,
                                        float* out) {
  for (int i = threadIdx.x; i < HG * kMaxQ; i += blockDim.x) {
    const int hh = i % HG, r = i / HG;
    out[hh * kMaxQ + r] =
        r < qv && h0 + hh < g.H
            ? dt[((size_t)b * g.L + c0 + r) * g.H + h0 + hh] : 0.f;
  }
}

// Inclusive cumsum of dt·a over the chunk's kMaxQ rows by one warp; the
// lane holds rows kPer·lane .. +kPer-1.  The same arithmetic in every
// launch, so the states, the pass and the outputs agree bit for bit.
__device__ __forceinline__ void chunk_cumsum(const float (&d)[kPer], float a,
                                             float (&cs)[kPer], int lane) {
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    cs[k] = run = __fadd_rn(run, __fmul_rn(d[k], a));
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, up);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) cs[k] = __fadd_rn(excl, cs[k]);
}

// ---- 1. each chunk's own state s_c = Σ_j x_j (w_j B_j)ᵀ, into st -------
template <int P, int N>
__global__ void __launch_bounds__(kBlock, 2)
ssd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  float* __restrict__ st, float* __restrict__ tot, Geom g) {
  constexpr int LB = ld_of<N>(), LX = ld_of<P>();
  constexpr int MT = P / 16;              // m16 tiles: all of P
  constexpr int NW = N / kWarps;          // state columns a warp
  constexpr int NT = NW / 8;              // n8 tiles a warp
  extern __shared__ float4 smem4[];
  bf16* Bs = reinterpret_cast<bf16*>(smem4);      // kMaxQ x LB
  bf16* Xs = Bs + kMaxQ * LB;                     // kMaxQ x LX
  float* wS = reinterpret_cast<float*>(Xs + kMaxQ * LX);  // kHS x kMaxQ

  const int groups = (g.H + kHS - 1) / kHS;
  const int c = blockIdx.x / groups, h0 = (blockIdx.x % groups) * kHS;
  const int b = blockIdx.y, c0 = c * g.Q, qv = min(g.Q, g.L - c0);
  const int kq = (qv + 15) & ~15;         // keys, rounded up to a k-step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q4 = lane & 3, mi = lane >> 3, r8 = lane & 7;

  copy_rows<N>(Bm + (size_t)b * g.b_sb + (size_t)c0 * g.b_st, g.b_st, kq,
               qv, Bs);
  cp_async_commit();
  load_dt<kHS>(dt, g, b, c0, qv, h0, wS);
  __syncthreads();
  // w_j = exp(total - cs_j)·dt_j in place of dt; total to tot
  for (int hh = warp; hh < kHS; hh += kWarps) {
    if (h0 + hh >= g.H) break;
    float d[kPer], cs[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) d[k] = wS[hh * kMaxQ + lane * kPer + k];
    chunk_cumsum(d, A[h0 + hh], cs, lane);
    float mine = cs[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k)
      if (k == (qv - 1) % kPer) mine = cs[k];
    const float total = __shfl_sync(kFull, mine, (qv - 1) / kPer);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      wS[hh * kMaxQ + lane * kPer + k] = __fmul_rn(expf(total - cs[k]), d[k]);
    if (lane == 0) tot[((size_t)b * g.nc + c) * g.H + h0 + hh] = total;
  }

  for (int hh = 0; hh < kHS && h0 + hh < g.H; ++hh) {
    const int h = h0 + hh;
    __syncthreads();                      // the last head's x is consumed
    copy_rows<P>(x + (size_t)b * g.x_sb + (size_t)c0 * g.x_st + h * P,
                 g.x_st, kq, qv, Xs);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float* w = wS + hh * kMaxQ;
    const int n0 = warp * NW;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
    for (int j0 = 0; j0 < kq; j0 += 16) {
      // A = xᵀ (rows p, depth j): the transposed read of x's (j, p) tile
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4_t(a[m], Xs + (j0 + (mi >> 1) * 8 + r8) * LX + m * 16 +
                            (mi & 1) * 8);
      // B = w·B (depth j, columns n): B's (j, n) tile read transposed,
      // scaled by w_j in float32 and split into bf16 head + remainder
      const float2 wa = *reinterpret_cast<const float2*>(w + j0 + 2 * q4);
      const float2 wb = *reinterpret_cast<const float2*>(w + j0 + 8 + 2 * q4);
      uint32_t braw[NT][2];
      if constexpr (NT == 1) {
        ldsm_x2_t(braw[0], Bs + (j0 + (mi & 1) * 8 + r8) * LB + n0);
      } else {
#pragma unroll
        for (int t = 0; t < NT; t += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, Bs + (j0 + (mi & 1) * 8 + r8) * LB + n0 + t * 8 +
                           (mi >> 1) * 8);
          braw[t][0] = r[0];
          braw[t][1] = r[1];
          braw[t + 1][0] = r[2];
          braw[t + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float2 f0 = unpack_bf16(braw[t][0]);
        const float2 f1 = unpack_bf16(braw[t][1]);
        uint32_t h0b, l0b, h1b, l1b;
        split_bf16(__fmul_rn(f0.x, wa.x), __fmul_rn(f0.y, wa.y), &h0b, &l0b);
        split_bf16(__fmul_rn(f1.x, wb.x), __fmul_rn(f1.y, wb.y), &h1b, &l1b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][t], a[m], h0b, h1b);
          mma(acc[m][t], a[m], l0b, l1b);
        }
      }
    }
    float* sh = st + (((size_t)b * g.nc + c) * g.H + h) * P * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int p = m * 16 + gq, n = n0 + t * 8 + 2 * q4;
        *reinterpret_cast<float2*>(sh + (size_t)p * N + n) =
            make_float2(acc[m][t][0], acc[m][t][1]);
        *reinterpret_cast<float2*>(sh + (size_t)(p + 8) * N + n) =
            make_float2(acc[m][t][2], acc[m][t][3]);
      }
  }
}

// ---- 2. S_c = exp(total_c)·S_{c-1} + s_c ---------------------------------
// eb[b, c] <- the state entering chunk c as two (P, N) bf16 planes, its
// head and its remainder; fin[b] <- the state after the last chunk.
// Thread: 4 consecutive entries of one (batch, head) state.
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ st, const float* __restrict__ tot,
                bf16* __restrict__ eb, float* __restrict__ fin, int H, int nc,
                int pn4, long long n4) {
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= n4) return;
  const int e = (int)(i % pn4);
  const long long bh = i / pn4;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const float4* s4 = reinterpret_cast<const float4*>(st);
  float4 E = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 v[kPassDepth];
    float dec[kPassDepth];
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      if (c0 + k < nc) {
        const size_t row = ((size_t)b * nc + c0 + k) * H + h;
        v[k] = s4[row * pn4 + e];
        dec[k] = expf(tot[row]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      if (c0 + k < nc) {
        const size_t row = ((size_t)b * nc + c0 + k) * H + h;
        uint32_t hi[2], lo[2];
        split_bf16(E.x, E.y, &hi[0], &lo[0]);
        split_bf16(E.z, E.w, &hi[1], &lo[1]);
        uint2* out = reinterpret_cast<uint2*>(eb + row * 2 * (4 * pn4));
        out[e] = make_uint2(hi[0], hi[1]);
        out[pn4 + e] = make_uint2(lo[0], lo[1]);
        E.x = __fadd_rn(__fmul_rn(dec[k], E.x), v[k].x);
        E.y = __fadd_rn(__fmul_rn(dec[k], E.y), v[k].y);
        E.z = __fadd_rn(__fmul_rn(dec[k], E.z), v[k].z);
        E.w = __fadd_rn(__fmul_rn(dec[k], E.w), v[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(fin)[bh * pn4 + e] = E;
}

// ---- 3. y = exp(cs_i)·C_i·S_{c-1} + Σ_{j<=i} W_ij x_j + D·x_i ----------
// W for one k-step of 16 keys from G's two n8 tiles g0 (keys j, j+1) and
// g1 (keys j+8, j+9), j = j0 + 2·(lane % 4), as the A fragment's bf16
// heads and remainders: a0 (row ia; j, j+1), a1 (ib; j, j+1), a2 (ia;
// j+8, j+9), a3 (ib; j+8, j+9).  The diagonal k-step (j0 == the warp's
// first row) exponentiates each cs_i - cs_j <= 0 and zeroes keys past
// the row.
__device__ __forceinline__ void weights_diag(
    const float (&g0)[4], const float (&g1)[4], const float* cs,
    const float* dt, int j, int ia, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 c0 = *reinterpret_cast<const float2*>(cs + j);
  const float2 c1 = *reinterpret_cast<const float2*>(cs + j + 8);
  const float2 d0 = *reinterpret_cast<const float2*>(dt + j);
  const float2 d1 = *reinterpret_cast<const float2*>(dt + j + 8);
  const float kc[4] = {c0.x, c0.y, c1.x, c1.y};
  const float kd[4] = {d0.x, d0.y, d1.x, d1.y};
  const float ca = cs[ia], cb = cs[ia + 8];
  float w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int kk = (e >> 2) * 2 + (e & 1);    // key j + {0, 1, 8, 9}
    const bool rb = (e >> 1) & 1;             // row ib, else ia
    const float gv = (e >> 2 ? g1 : g0)[(rb ? 2 : 0) + (e & 1)];
    const float dec = expf((rb ? cb : ca) - kc[kk]);
    w[e] = j + (kk >> 1) * 8 + (kk & 1) <= ia + (rb ? 8 : 0)
               ? __fmul_rn(__fmul_rn(dec, gv), kd[kk]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split_bf16(w[2 * r], w[2 * r + 1], &ah[r], &al[r]);
}

// Below the diagonal every key precedes every row, and the decay factors
// at the k-step's last key jr = j0 + 15: exp(cs_i - cs_j) =
// exp(cs_i - cs_jr)·exp(cs_jr - cs_j), both exponents <= 0 (so neither
// factor overflows, and neither underflows unless the product does).
// colf_j = exp(cs_jr - cs_j)·dt_j is the head's per-key table; fa, fb the
// rows' factors.
__device__ __forceinline__ void weights_below(
    const float (&g0)[4], const float (&g1)[4], const float* colf, int j,
    float fa, float fb, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 f0 = *reinterpret_cast<const float2*>(colf + j);
  const float2 f1 = *reinterpret_cast<const float2*>(colf + j + 8);
  const float kf[4] = {f0.x, f0.y, f1.x, f1.y};
  float w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int kk = (e >> 2) * 2 + (e & 1);
    const bool rb = (e >> 1) & 1;
    const float gv = (e >> 2 ? g1 : g0)[(rb ? 2 : 0) + (e & 1)];
    w[e] = __fmul_rn(__fmul_rn(gv, kf[kk]), rb ? fb : fa);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split_bf16(w[2 * r], w[2 * r + 1], &ah[r], &al[r]);
}

template <int P, int N>
__global__ void __launch_bounds__(kBlock, 2)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const float* __restrict__ D,
               const bf16* __restrict__ eb, bf16* __restrict__ y, Geom g) {
  constexpr int LB = ld_of<N>(), LX = ld_of<P>();
  constexpr int PT = P / 8;               // n8 tiles of the output
  constexpr int KT = kMaxQ / 8;           // n8 tiles of G's keys, at most
  extern __shared__ float4 smem4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem4);      // kTQ x LB
  bf16* R = Cs + kTQ * LB;
  bf16* Bs = R;                                   // kMaxQ x LB (G only)
  bf16* Xs = R;                                   // kMaxQ x LX (per head)
  bf16* Eh = Xs + kMaxQ * LX;                     // P x LB: S's bf16 head
  bf16* El = Eh + P * LB;                         // ... and remainder
  float* csS = reinterpret_cast<float*>(
      reinterpret_cast<char*>(R) + out_region_bytes<P, N>());
  float* dtS = csS + kHO * kMaxQ;
  float* colS = dtS + kHO * kMaxQ;        // exp(cs_{j|15} - cs_j)·dt_j

  const int nqt = (g.Q + kTQ - 1) / kTQ, groups = (g.H + kHO - 1) / kHO;
  const int qt = blockIdx.x % nqt, rest = blockIdx.x / nqt;
  const int h0 = (rest % groups) * kHO, c = rest / groups;
  const int b = blockIdx.y, c0 = c * g.Q, qv = min(g.Q, g.L - c0);
  const int i0 = qt * kTQ;
  if (i0 >= qv) return;
  const int kend = min(i0 + kTQ, (qv + 15) & ~15);  // keys this tile reads
  const int nh = min(kHO, g.H - h0);      // heads of this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int r0 = i0 + 16 * warp;          // the warp's first row
  const bool active = r0 < qv;
  const int ns = (r0 + 16) / 16;          // k-steps up to the diagonal
  const bf16* xb = x + (size_t)b * g.x_sb + (size_t)c0 * g.x_st;
  // the entering state of head h, as cp.async copies of its two planes
  auto load_state = [&](int h) {
    const bf16* e = eb + (((size_t)b * g.nc + c) * g.H + h) * 2 * P * N;
    copy_rows<N>(e, N, P, P, Eh);
    copy_rows<N>(e + P * N, N, P, P, El);
    cp_async_commit();
  };

  copy_rows<N>(Cm + (size_t)b * g.c_sb + (size_t)(c0 + i0) * g.c_st, g.c_st,
               kTQ, qv - i0, Cs);
  copy_rows<N>(Bm + (size_t)b * g.b_sb + (size_t)c0 * g.b_st, g.b_st, kend,
               qv, Bs);
  cp_async_commit();
  load_dt<kHO>(dt, g, b, c0, qv, h0, dtS);
  __syncthreads();
  for (int hh = warp; hh < nh; hh += kWarps) {
    float d[kPer], cs[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) d[k] = dtS[hh * kMaxQ + lane * kPer + k];
    chunk_cumsum(d, A[h0 + hh], cs, lane);
    // cs at the last row of the lane's 16-row k-step: lanes 2m, 2m + 1
    // hold its rows, 2m + 1 its last
    const float cref = __shfl_sync(kFull, cs[kPer - 1], lane | 1);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      csS[hh * kMaxQ + lane * kPer + k] = cs[k];
      colS[hh * kMaxQ + lane * kPer + k] =
          __fmul_rn(expf(cref - cs[k]), d[k]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // G = C·Bᵀ for the warp's 16 rows, once for every head of the group,
  // counted back from the diagonal: G[2u], G[2u + 1] hold the keys of
  // k-step ns - 1 - u, so the diagonal sits at a fixed register index
  const bf16* crow = Cs + (16 * warp + (lane & 15)) * LB + (lane >> 4) * 8;
  float G[KT][4];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) G[t][e] = 0.f;
  if (active) {
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, crow + k0);
#pragma unroll
      for (int u = 0; u < KT / 2; ++u) {
        if (u < ns) {
          uint32_t bb[4];
          ldsm_x4(bb, Bs + (16 * (ns - 1 - u) + (mi >> 1) * 8 + r8) * LB +
                          k0 + (mi & 1) * 8);
          mma(G[2 * u], a, bb[0], bb[1]);
          mma(G[2 * u + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  __syncthreads();                        // B is consumed
  load_state(h0);
  copy_rows<P>(xb + h0 * P, g.x_st, kend, qv, Xs);
  cp_async_commit();

  // Per head: C·S while x is in flight, then W·X while the next head's
  // state is; only the next head's x waits behind the barriers.
  const int ia = r0 + gq, ib = ia + 8;    // the thread's two rows
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    cp_async_wait_but_one();
    __syncthreads();                      // this head's state landed
    const float* cs = csS + hh * kMaxQ;
    const float* dth = dtS + hh * kMaxQ;
    const float* colf = colS + hh * kMaxQ;
    float Y[PT][4];
#pragma unroll
    for (int t = 0; t < PT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) Y[t][e] = 0.f;
    // inter-chunk: C_i · S_{c-1} (depth n)
    if (active) {
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, crow + k0);
#pragma unroll
        for (int t = 0; t < PT; t += 2) {
          const int off =
              (8 * t + (mi >> 1) * 8 + r8) * LB + k0 + (mi & 1) * 8;
          uint32_t eh[4], el[4];
          ldsm_x4(eh, Eh + off);
          ldsm_x4(el, El + off);
          mma(Y[t], a, eh[0], eh[1]);
          mma(Y[t], a, el[0], el[1]);
          mma(Y[t + 1], a, eh[2], eh[3]);
          mma(Y[t + 1], a, el[2], el[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();                      // x landed; S is consumed
    if (hh + 1 < nh) load_state(h + 1);   // lands while W·X runs
    if (active) {
      const float ca = cs[ia], cb = cs[ib];
      const float ea = expf(ca), eb_ = expf(cb);
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        Y[t][0] *= ea;
        Y[t][1] *= ea;
        Y[t][2] *= eb_;
        Y[t][3] *= eb_;
      }
      // intra-chunk: W (rows i, depth j) from G's registers, x (j, p);
      // the diagonal k-step first, then the keys below it, last to first
      // (one copy of the diagonal's code keeps the unrolled loop small)
      auto wx = [&](const uint32_t (&ah)[4], const uint32_t (&al)[4],
                    int j0) {
#pragma unroll
        for (int t = 0; t < PT; t += 2) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xs + (j0 + (mi & 1) * 8 + r8) * LX + t * 8 +
                            (mi >> 1) * 8);
          mma(Y[t], ah, xf[0], xf[1]);
          mma(Y[t], al, xf[0], xf[1]);
          mma(Y[t + 1], ah, xf[2], xf[3]);
          mma(Y[t + 1], al, xf[2], xf[3]);
        }
      };
      {
        uint32_t ah[4], al[4];
        weights_diag(G[0], G[1], cs, dth, r0 + 2 * q4, ia, ah, al);
        wx(ah, al, r0);
      }
#pragma unroll
      for (int u = 1; u < KT / 2; ++u) {
        if (u < ns) {
          const int j0 = 16 * (ns - 1 - u);
          const float cr = cs[j0 + 15];
          uint32_t ah[4], al[4];
          weights_below(G[2 * u], G[2 * u + 1], colf, j0 + 2 * q4,
                        expf(ca - cr), expf(cb - cr), ah, al);
          wx(ah, al, j0);
        }
      }
      // y = Y + D·x, rounded once to bf16
      const float dd = D[h];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? ib : ia;
        if (i >= qv) continue;
        bf16* yr = y + (((size_t)b * g.L + c0 + i) * g.H + h) * P + 2 * q4;
        const bf16* xr = Xs + i * LX + 2 * q4;
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          const float2 xv = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(xr + 8 * t));
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              fmaf(dd, xv.x, Y[t][2 * half]),
              fmaf(dd, xv.y, Y[t][2 * half + 1]));
          *reinterpret_cast<__nv_bfloat162*>(yr + 8 * t) = v;
        }
      }
    }
    __syncthreads();                      // every warp is done with x
    if (hh + 1 < nh) {
      copy_rows<P>(xb + (h + 1) * P, g.x_st, kend, qv, Xs);
      cp_async_commit();
    }
  }
}

// ============================================================= launch

// Past 48 KB of dynamic shared memory, and with the SM's whole 228 KB
// carveout, so two blocks of the bf16 kernels share an SM.
template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *D;
  void* y;
  float *fin, *scratch;
  Geom g;
  cudaStream_t stream;
};

template <int P, int N>
int launch_f32(const Args& a) {
  constexpr size_t smem = f32_smem_bytes<P, N>();
  if (int err = allow_smem(ssd_f32_kernel<P, N>, smem)) return err;
  const Geom& g = a.g;
  ssd_f32_kernel<P, N><<<dim3(g.H, g.Bt), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.x), a.dt, a.A,
      static_cast<const float*>(a.Bm), static_cast<const float*>(a.Cm), a.D,
      static_cast<float*>(a.y), a.fin, g.L, g.Q, g.x_sb, g.x_st, g.b_sb,
      g.b_st, g.c_sb, g.c_st);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_bf16(const Args& a) {
  constexpr size_t s1 = states_smem_bytes<P, N>(), s3 = out_smem_bytes<P, N>();
  if (int err = allow_smem(ssd_states_kernel<P, N>, s1)) return err;
  if (int err = allow_smem(ssd_out_kernel<P, N>, s3)) return err;
  const Geom& g = a.g;
  const auto* x = static_cast<const bf16*>(a.x);
  const auto* Bm = static_cast<const bf16*>(a.Bm);
  const int gs = (g.H + kHS - 1) / kHS, go = (g.H + kHO - 1) / kHO;
  const int nqt = (g.Q + kTQ - 1) / kTQ;
  // the scratch: the chunks' own states, the entering states' bf16 planes
  // (the same bytes), the chunk totals
  const size_t n_st = (size_t)g.Bt * g.nc * g.H * P * N;
  float* st = a.scratch;
  bf16* eb = reinterpret_cast<bf16*>(a.scratch + n_st);
  float* tot = a.scratch + 2 * n_st;
  ssd_states_kernel<P, N><<<dim3(g.nc * gs, g.Bt), kBlock, s1, a.stream>>>(
      x, a.dt, a.A, Bm, st, tot, g);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const int pn4 = P * N / 4;
  const long long n4 = (long long)g.Bt * g.H * pn4;
  ssd_pass_kernel<<<(unsigned)((n4 + kPassThreads - 1) / kPassThreads),
                    kPassThreads, 0, a.stream>>>(st, tot, eb, a.fin, g.H,
                                                 g.nc, pn4, n4);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  ssd_out_kernel<P, N><<<dim3(g.nc * go * nqt, g.Bt), kBlock, s3,
                         a.stream>>>(x, a.dt, a.A, Bm,
                                     static_cast<const bf16*>(a.Cm), a.D,
                                     eb, static_cast<bf16*>(a.y), g);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch(const Args& a, int dtype) {
  return dtype == 0 ? launch_f32<P, N>(a) : launch_bf16<P, N>(a);
}

template <int P>
int launch_n(const Args& a, int N, int dtype) {
  switch (N) {
    case 32: return launch<P, 32>(a, dtype);
    case 64: return launch<P, 64>(a, dtype);
    case 128: return launch<P, 128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  x (Bt, L, H, P)
// with batch stride x_sb and row stride x_st (elements), heads and the
// head dim contiguous; dt (Bt, L, H) float32, contiguous; A, D (H,)
// float32; B, C (Bt, L, N) with batch and row strides, N contiguous;
// y (Bt, L, H, P) contiguous; fin (Bt, H, P, N) float32.  bf16 only:
// scratch of 2·Bt·nc·H·P·N + Bt·nc·H float32, nc = ceil(L / Q), 16-byte
// aligned; float32 calls may pass null.  P in {32, 64}, N in {32, 64,
// 128}, 1 <= Q <= 256.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, const float* D,
                          void* y, float* fin, float* scratch, int Bt,
                          int L, int H, int P, int N, int Q, long long x_sb,
                          long long x_st, long long b_sb, long long b_st,
                          long long c_sb, long long c_st, int dtype,
                          void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0) return 0;
  if (Q <= 0 || Q > kMaxQ || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, Bm, Cm, dt, A, D, y, fin, scratch,
               Geom{Bt, L, H, Q, (L + Q - 1) / Q, x_sb, x_st, b_sb, b_st,
                    c_sb, c_st},
               static_cast<cudaStream_t>(stream)};
  switch (P) {
    case 32: return launch_n<32>(a, N, dtype);
    case 64: return launch_n<64>(a, N, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

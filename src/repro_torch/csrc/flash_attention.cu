// Causal / sliding-window flash attention with native GQA, for Hopper.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:84, body _kernel :30,
// pallas_call :102).  Plain version:
// repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
//   o[b, s, h] = Σ_t softmax_t(scale · q[b, s, h] · k[b, t, h / group])
//                · v[b, t, h / group]
//   over keys t with t <= s (causal) and t > s - window (window > 0).
//
// What bounds it on an H100: operations.  At the model's shapes (head_dim
// 256, one kv head, window 2048) each key a query reaches costs 4·D FLOP
// against 2·D bytes of k and v read once per kv head, so the tensor cores'
// bf16 rate, not the bytes, sets the least time.
//
// bf16 (flash_wg_kernel): Hopper's warpgroup tensor-core products
// (wgmma, bf16 in, float32 accumulate).  One block of two warpgroups per
// (batch, head, 128-query tile); each warpgroup owns 64 query rows.  The q
// tile and a two-stage ring of 64-key k and v tiles stay bf16 in shared
// memory in wgmma's 128-byte-swizzled layout (192 KB at D=256, one block
// an SM), filled by cp.async 16-byte copies with commit/wait groups, so
// the next key tile loads while the current one is multiplied (rows past
// the end are zero-filled, so masked keys multiply finite zeros); a
// proxy fence hands the copies to the tensor cores.  Per key tile:
// S = Q·Kᵀ as D/16 wgmma m64n64k16 with both operands read from shared
// memory through descriptors (q is never held in registers: at D=256 the
// 128-register accumulator leaves no room), the scale applied to the
// float32 scores (not to bf16 q: 1/√D is not a power of two for odd
// log2 D), the mask, the online softmax on the accumulator fragments (row
// max and sum by quad shuffles, m, l and o in float32), then O += P·V as
// wgmma with P from registers as the A operand and V's MN-major tile from
// shared memory.  P enters as two bf16 products, its bf16 head plus the
// bf16 remainder, so P·V carries ~16 bits of P: with a single bf16 P (the
// plain version's rounding of the normalised probabilities) outputs near
// zero fall outside the one-bf16-ulp bar against the float32 function.
// The two warpgroups share each k and v tile, so they meet at a barrier
// every tile and run in step: one's softmax does not yet overlap the
// other's products.
//
// float32 (flash_f32_kernel): CUDA-core math, the first port's design
// kept as its own instantiation: TF32 is pinned off in the port (channel
// gains sit near 1e-13) and the float32 cases are held at 2e-5, which TF32
// tensor cores would not meet.  Four warps own eight query rows each of a
// 32-row tile; lane j takes key j of a 32-key tile; q (pre-scaled), k and
// v convert to float32 in shared memory.
//
// Both: tiles that the causal/window test proves empty for the whole block
// are never visited (the TPU kernel's `reachable`); the longest rows are
// scheduled first; GQA reads kv head h / group in place, never repeated;
// masked scores are the finite -2e38 of the TPU kernel, never -inf (a row
// whose first visited tile holds none of its keys gets exp(0) garbage
// there, and the next tile's alpha = exp(-2e38 - m) = 0 wipes it); the
// denominator is floored at 1e-30.  q, k, v and o are read and written at
// their (batch, sequence, head) strides, so the model's (B, S, H, D)
// layout needs no copy; every row starts on a 16-byte boundary and D is
// contiguous (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Sizes and strides of one call; strides in elements, (batch, seq, head).
struct Geom {
  int B, H, group, S, T, causal, window;
  long long q[3], k[3], v[3], o[3];
};

// the keys any row in [q0, q0 + rows) can reach, rounded out to tiles
__device__ __forceinline__ void key_range(const Geom& g, int q0, int rows,
                                          int bk, int* begin, int* end) {
  *begin = g.window ? max(0, q0 - g.window + 1) / bk * bk : 0;
  *end = g.causal ? min(g.T, q0 + rows) : g.T;
}

__device__ __forceinline__ bool visible(const Geom& g, int qpos, int kpos) {
  bool ok = kpos < g.T;
  if (g.causal) ok = ok && kpos <= qpos;
  if (g.window) ok = ok && kpos > qpos - g.window;
  return ok;
}

// ---------------------------------------------------------------- bf16

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x0, x1) -> their bf16 heads and the bf16 of what the heads leave out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                          uint32_t* lo) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  *hi = pack_bf16(h0, h1);
  *lo = pack_bf16(__float2bfloat16(x0 - __bfloat162float(h0)),
                  __float2bfloat16(x1 - __bfloat162float(h1)));
}

constexpr int kWgGroups = 2;                  // warpgroups per block
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgBQ = 64 * kWgGroups;         // query rows per block
constexpr int kWgBK = 64;                     // keys per tile

template <int D>
constexpr size_t wg_smem_bytes() {            // + slack to align to 1 KB
  return (size_t)(kWgBQ + 4 * kWgBK) * D * sizeof(bf16) + 1024;
}

// wgmma's 128-byte-swizzled layout: a (ROWS, D) tile is D/64 slabs of
// ROWS x 128 bytes; 16-byte chunk c of row r sits at chunk c ^ (r % 8),
// and every 8 rows form one 1024-byte atom.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

template <int ROWS, int D>
__device__ __forceinline__ void load_rows_swz(uint8_t* dst, const bf16* src,
                                              long long stride, int r0,
                                              int limit) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kWgThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = r0 + r < limit;
    cp_async_16(dst + swz<ROWS>(r, ch),
                src + (ok ? (long long)(r0 + r) * stride : 0) + ch * 8, ok);
  }
}

// shared-memory matrix descriptor: 128-byte swizzle, 1024-byte stride
// between 8-row atoms (the leading offset is unused at these widths)
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers the asynchronous wgmma reads or writes stay put across it
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// d (+)= A·B, m64n64k16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, m64n64k16, A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, Geom g,
                float scale_log2) {
  constexpr int NS = D / 64;              // 128-byte slabs of a row
  constexpr int NT = kWgBK / 8;           // score n-tiles per key tile
  constexpr int KK = kWgBK / 16;          // k16 steps of P·V per tile
  constexpr int QB = kWgBQ * 128, KB = kWgBK * 128;   // bytes of a slab
  extern __shared__ uint8_t smem_wg[];
  uint8_t* Qs = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint8_t* Ks = Qs + NS * QB;             // 2 stages of NS slabs
  uint8_t* Vs = Ks + 2 * NS * KB;         // 2 stages of NS slabs

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H, kh = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;  // long rows first
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gr = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + b * g.q[0] + h * g.q[2];
  const bf16* kb = k + b * g.k[0] + kh * g.k[2];
  const bf16* vb = v + b * g.v[0] + kh * g.v[2];
  int k_begin, k_end;
  key_range(g, q0, kWgBQ, kWgBK, &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWgBK - 1) / kWgBK
                                      : 0;

  load_rows_swz<kWgBQ, D>(Qs, qb, g.q[1], q0, g.S);
  if (n_tiles > 0) {
    load_rows_swz<kWgBK, D>(Ks, kb, g.k[1], k_begin, g.T);
    load_rows_swz<kWgBK, D>(Vs, vb, g.v[1], k_begin, g.T);
  }
  cp_async_commit();

  float acc[NS][32];                      // O, one m64n64 tile per slab
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part
  const int row0 = q0 + wg * 64 + warp * 16 + gr;
  const int qrow[2] = {row0, row0 + 8};
  const uint8_t* q_wg = Qs + wg * 64 * 128;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kWgBK, st = it & 1;
    if (it + 1 < n_tiles) {
      load_rows_swz<kWgBK, D>(Ks + (st ^ 1) * NS * KB, kb, g.k[1],
                              k0 + kWgBK, g.T);
      load_rows_swz<kWgBK, D>(Vs + (st ^ 1) * NS * KB, vb, g.v[1],
                              k0 + kWgBK, g.T);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // this tile (and q) has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint8_t* k_st = Ks + st * NS * KB;
    const uint8_t* v_st = Vs + st * NS * KB;

    // S = Q·Kᵀ for the warpgroup's 64 rows and the tile's 64 keys
    float s[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss(s, wg_desc(q_wg + (kd >> 2) * QB + (kd & 3) * 32),
               wg_desc(k_st + (kd >> 2) * KB + (kd & 3) * 32), 1);
    wg_commit();
    wg_wait_all();
    pin(s);

    // scale (log2 domain), mask, online softmax on the fragments
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + t4 * 2 + (e & 1);
        const float x = visible(g, qrow[e >> 1], kpos)
                            ? s[j * 4 + e] * scale_log2 : kNegInf;
        s[j * 4 + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      const float p = exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];

    // O += P·V, P as its bf16 head plus its bf16 remainder
    uint32_t ph[KK][4], pl[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const float* s0 = s + (2 * kk) * 4;
      const float* s1 = s + (2 * kk + 1) * 4;
      split_bf16(s0[0], s0[1], &ph[kk][0], &pl[kk][0]);
      split_bf16(s0[2], s0[3], &ph[kk][1], &pl[kk][1]);
      split_bf16(s1[0], s1[1], &ph[kk][2], &pl[kk][2]);
      split_bf16(s1[2], s1[3], &ph[kk][3], &pl[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) pin(acc[j]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint64_t dv = wg_desc(v_st + j * KB + kk * 16 * 128);
        wgmma_rs(acc[j], ph[kk], dv);
        wgmma_rs(acc[j], pl[kk], dv);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < NS; ++j) pin(acc[j]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      pin(ph[kk]);
      pin(pl[kk]);
    }
    __syncthreads();                      // this stage is free to refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= g.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = o + b * g.o[0] + (long long)qrow[r] * g.o[1] + h * g.o[2]
                 + t4 * 2;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 64 + n * 8) =
            __floats2bfloat162_rn(acc[j][n * 4 + 2 * r] * inv,
                                  acc[j][n * 4 + 2 * r + 1] * inv);
  }
}

// -------------------------------------------------------------- float32

constexpr int kF32Warps = 4;
constexpr int kF32Rows = 8;                   // query rows per warp
constexpr int kF32BQ = kF32Warps * kF32Rows;  // query rows per block
constexpr int kF32BK = 32;                    // keys per tile: one per lane

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

// Rows [r0, r0 + n) of a (rows, D) view with row stride `stride` into
// float32 shared memory with row stride ld, times mul; rows at or past
// `limit` read as 0.  16-byte global loads, float4 shared stores.
template <int D>
__device__ void load_tile_f32(const float* __restrict__ src, long long stride,
                              int r0, int n, int limit, float* dst, int ld,
                              float mul) {
  constexpr int kChunks = D / 4;          // loads per row
  for (int c = threadIdx.x; c < n * kChunks; c += blockDim.x) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) {
      f = __ldg(reinterpret_cast<const float4*>(
          src + (long long)(r0 + r) * stride + col));
      f.x *= mul; f.y *= mul; f.z *= mul; f.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * ld + col) = f;
  }
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return (size_t)(kF32BQ * D + kF32BK * (D + 4) + kF32BK * D) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Geom g,
                 float scale) {
  constexpr int KLD = D + 4;    // padded k row: lanes' float4 reads
  constexpr int DL = D / 32;     // hit distinct banks; DL columns a lane
  extern __shared__ float4 smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);  // kF32BQ x D, pre-scaled
  float* Ks = Qs + kF32BQ * D;                     // kF32BK x KLD
  float* Vs = Ks + kF32BK * KLD;                   // kF32BK x D

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H, kh = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BQ;  // long rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* kb = k + b * g.k[0] + kh * g.k[2];
  const float* vb = v + b * g.v[0] + kh * g.v[2];
  load_tile_f32<D>(q + b * g.q[0] + h * g.q[2], g.q[1], q0, kF32BQ, g.S, Qs,
                   D, scale);

  float m[kF32Rows], l[kF32Rows], acc[kF32Rows][DL];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  int k_begin, k_end;
  key_range(g, q0, kF32BQ, kF32BK, &k_begin, &k_end);
  const float* qw = Qs + warp * kF32Rows * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kF32BK) {
    __syncthreads();                      // the last tile is consumed
    load_tile_f32<D>(kb, g.k[1], k0, kF32BK, g.T, Ks, KLD, 1.f);
    load_tile_f32<D>(vb, g.v[1], k0, kF32BK, g.T, Vs, D, 1.f);
    __syncthreads();

    float s[kF32Rows];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KLD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const int qpos = q0 + warp * kF32Rows + r;
      const float sr = visible(g, qpos, kpos) ? s[r] : kNegInf;
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
    for (int j = 0; j < kF32BK; ++j) {
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = Vs[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int qpos = q0 + warp * kF32Rows + r;
    if (qpos >= g.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = o + b * g.o[0] + (long long)qpos * g.o[1] + h * g.o[2];
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane + 32 * i] = acc[r][i] / denom;
  }
}

// ---------------------------------------------------------------- launch

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
             const Geom& g, float scale, cudaStream_t stream) {
  if (dtype == 1) {
    constexpr size_t smem = wg_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)flash_wg_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(g.B * g.H, (g.S + kWgBQ - 1) / kWgBQ);
    flash_wg_kernel<D><<<grid, kWgThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), g,
        scale * kLog2e);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = f32_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)flash_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(g.B * g.H, (g.S + kF32BQ - 1) / kF32BQ);
  flash_f32_kernel<D><<<grid, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k and v (B, T, KH, D), o (B, S, H, D), each at the
// strides in `strides` (elements; q, k, v, o in turn, each as batch,
// sequence, head).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KH, int S, int T, int D,
                                      int causal, int window, int dtype,
                                      float scale, const long long* strides,
                                      void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0) return 0;
  if (KH <= 0 || H % KH || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Geom g{B, H, H / KH, S, T, causal, window, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    g.q[i] = strides[i];
    g.k[i] = strides[3 + i];
    g.v[i] = strides[6 + i];
    g.o[i] = strides[9 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(dtype, q, k, v, o, g, scale, st);
    case 128: return launch_d<128>(dtype, q, k, v, o, g, scale, st);
    case 256: return launch_d<256>(dtype, q, k, v, o, g, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

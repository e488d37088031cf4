// Decode attention with grouped queries (flash-decoding), for Hopper.
//
// Replaces no TPU kernel: the JAX package's decode step
// (src/repro/models/attention.py:248 decode_step) is plain jnp, which
// repeats the ring cache across each KV head's query group
// (``jnp.repeat``) and attends with two einsums.  The port did the same
// until the chip's profiles of the mixtral-8x22b serve cell put ~0.39 s of
// a ~2.2-s round in the copies of that path: every decode step and layer
// wrote the cache expanded H/K times and permuted it into the einsums'
// layouts, ~25x the bytes of the cache.  Plain version:
// repro_torch/kernels/decode_attention/ref.py::decode_attention_ref.
//
//   o[b, h] = Σ_t softmax_t(scale · q[b, h] · k[b, t, h / G]) · v[b, t, h / G]
//   over the ring slots t whose position p = pos[t] has p >= 0,
//   p <= position and, with a window, p > position - window.
//
// What bounds it on an H100: bytes.  One query token a head costs 4·D FLOP
// per (head, key) against 4·D bytes of k and v per (KV head, key): G FLOP
// a byte, far under the ~295 at which the tensor cores bind.  So the
// least time is the cache read once, and the design reads each k and v
// byte once.
//
// Design.  One block of four warps per (batch row, KV head, key split,
// chunk of up to 16 of the group's query heads: every config has G <= 16,
// so one chunk).  The block's query heads are the 16 rows of one m16
// tile (rows past G are zero and never written).  It walks its split's
// keys in 64-key tiles: k and v stream into a two-stage ring of
// shared-memory tiles by cp.async 16-byte copies (rows past the split
// zero-filled), so the next tile loads while this one is multiplied; the
// rows are XOR-swizzled by 16-byte chunk so that ldmatrix reads them
// without bank conflicts.  Each warp takes 16 keys of a tile: S = Q·Kᵀ as
// mma.sync m16n8k16 (bf16 in, float32 accumulate), the scale applied to
// the float32 scores, the mask computed from the ring's positions and the
// position tensor (read by pointer, so a graph that captured the launch
// replays at any position), an online softmax in float32 on the
// fragments, then O += P·V as mma.sync with P from the score registers
// and V read through ldmatrix.trans.  P enters as two bf16 products, its
// bf16 head plus its bf16 remainder (as in flash_attention.cu), so P·V
// carries ~16 bits of P.  The four warps' (m, l, O) merge in shared memory
// into the block's float32 partial (m, l, O[G×D]) of its split; a second
// launch merges the splits of each (batch row, head) and writes the bf16
// output, rounded once.  Masked keys get p = 0 exactly, so a split with
// no key leaves (m = -2e38, l = 0, O = 0) and weighs 0 in the merge.
// Nothing here depends on the position on the host: the grid is a
// function of the cache's shape alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                 // query heads a block: one m16 tile
constexpr int kTile = 16 * kWarps;        // keys a tile, 16 a warp
constexpr int kStages = 2;

// Sizes and strides (elements) of one call.
struct Geom {
  int KH, G, T, window, splits, tiles_per_split, head_chunks;
  long long q[2];                         // q's (batch, head) strides
  long long k[3], v[3];                   // (batch, slot, head) strides
};

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kRows + 2 * kStages * kTile) * D * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of D-wide bf16 rows:
// the chunk's low three bits XOR the row's, so the 8 rows an ldmatrix
// reads at one chunk fall on 8 distinct 16-byte bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * D * 2 + ((c ^ (r & 7)) << 4));
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

// rows [r0, r0 + ROWS) of a (rows, D) view with row stride `stride` into
// a swizzled tile; rows at or past `limit` are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          long long stride, int r0,
                                          int limit) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = r0 + r < limit;
    cp_async_16(dst + swz<D>(r, ch),
                src + (ok ? (long long)(r0 + r) * stride : 0) + ch * 8, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A·B, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4·gr + t4.
// A (16 x 16): a0 (gr, 2t4..), a1 (gr+8, 2t4..), a2 (gr, 8+2t4..),
// a3 (gr+8, 8+2t4..); B (16 x 8): b0 (k 2t4.., n gr), b1 (k 8+2t4.., n gr);
// C (16 x 8): c0 c1 (gr, 2t4..), c2 c3 (gr+8, 2t4..).  ldmatrix.x4 gives
// lane l's address to matrix l / 8, row l % 8.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const long long* __restrict__ pos,
                   const long long* __restrict__ position,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   Geom g, float scale_log2) {
  constexpr int NK = D / 16;               // k16 steps of Q·Kᵀ; n16 of P·V
  constexpr int TB = kTile * D * 2;        // bytes of one k (or v) stage
  extern __shared__ __align__(16) uint8_t smem_da[];
  __shared__ float red_m[kWarps][kRows], red_l[kWarps][kRows];
  uint8_t* Qs = smem_da;
  uint8_t* Ks = Qs + kRows * D * 2;
  uint8_t* Vs = Ks + kStages * TB;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / g.head_chunks;
  const int h0 = (blockIdx.y % g.head_chunks) * kRows;  // within the group
  const int rows = min(kRows, g.G - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const bf16* kb = k + b * g.k[0] + kh * g.k[2];
  const bf16* vb = v + b * g.v[0] + kh * g.v[2];
  const int t_begin = split * g.tiles_per_split * kTile;
  const int t_end = min(g.T, t_begin + g.tiles_per_split * kTile);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile
                                      : 0;
  const long long now = *position;

  load_tile<kRows, D>(Qs, q + b * g.q[0] + (long long)(kh * g.G + h0) * g.q[1],
                      g.q[1], 0, rows);
  if (n_tiles > 0) {
    load_tile<kTile, D>(Ks, kb, g.k[1], t_begin, t_end);
    load_tile<kTile, D>(Vs, vb, g.v[1], t_begin, t_end);
  }
  cp_async_commit();

  float acc[2 * NK][4];                    // O, n8 tiles of the warp's rows
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part
  const uint32_t q_s = smem_u32(Qs);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile, st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<kTile, D>(Ks + (st ^ 1) * TB, kb, g.k[1], t0 + kTile, t_end);
      load_tile<kTile, D>(Vs + (st ^ 1) * TB, vb, g.v[1], t0 + kTile, t_end);
    }
    cp_async_commit();
    cp_async_wait<1>();                    // this tile (and q) has landed
    __syncthreads();
    const uint32_t k_s = smem_u32(Ks + st * TB), v_s = smem_u32(Vs + st * TB);

    // S = Q·Kᵀ over the warp's 16 keys: two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, q_s + swz<D>((mi & 1) * 8 + r8, 2 * kk + (mi >> 1)));
      ldsm_x4(bk, k_s + swz<D>(warp * 16 + (mi >> 1) * 8 + r8,
                               2 * kk + (mi & 1)));
      mma(s[0], a, bk[0], bk[1]);
      mma(s[1], a, bk[2], bk[3]);
    }

    // scale (log2 domain), the mask from the ring's positions, online
    // softmax; s[j][e] is row gr + 8·(e / 2), key 8·j + 2·t4 + e % 2
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        const int t = t0 + warp * 16 + j * 8 + t4 * 2 + e0;
        bool ok = t < t_end;
        if (ok) {
          const long long p = pos[t];
          ok = p >= 0 && p <= now && (g.window == 0 || p > now - g.window);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = ok ? s[j][2 * r + e0] * scale_log2 : kNegInf;
          s[j][2 * r + e0] = x;
          mx[r] = fmaxf(mx[r], x);
        }
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == kNegInf ? 0.f : exp2f(x - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= alpha[i >> 1];

    // O += P·V, P as its bf16 head plus its bf16 remainder
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], &ph[0], &pl[0]);
    split_bf16(s[0][2], s[0][3], &ph[1], &pl[1]);
    split_bf16(s[1][0], s[1][1], &ph[2], &pl[2]);
    split_bf16(s[1][2], s[1][3], &ph[3], &pl[3]);
#pragma unroll
    for (int dp = 0; dp < NK; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, v_s + swz<D>(warp * 16 + (mi & 1) * 8 + r8,
                                 2 * dp + (mi >> 1)));
      mma(acc[2 * dp], ph, bv[0], bv[1]);
      mma(acc[2 * dp], pl, bv[0], bv[1]);
      mma(acc[2 * dp + 1], ph, bv[2], bv[3]);
      mma(acc[2 * dp + 1], pl, bv[2], bv[3]);
    }
    __syncthreads();                       // this stage is free to refill
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warps' (m, l, O) into the block's partial; the stages hold
  // the warps' O now (kWarps·kRows·D floats fit in 2·kStages·kTile·D bf16)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if (t4 == 0) {
    red_m[warp][gr] = m[0];
    red_m[warp][gr + 8] = m[1];
    red_l[warp][gr] = l[0];
    red_l[warp][gr + 8] = l[1];
  }
  float* Os = reinterpret_cast<float*>(Ks);
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(
          Os + (warp * kRows + gr + 8 * r) * D + j * 8 + t4 * 2) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w][r]);
    float o = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = exp2f(red_m[w][r] - mm);
      o += Os[(w * kRows + r) * D + d] * sc;
      ll += red_l[w][r] * sc;
    }
    // (batch row, head, split)
    const long long row =
        ((long long)b * g.KH * g.G + kh * g.G + h0 + r) * g.splits + split;
    part_o[row * D + d] = o;
    if (d == 0) {
      part_ml[2 * row] = mm;
      part_ml[2 * row + 1] = ll;
    }
  }
}

// one block per (batch row, head), a thread per output column: the
// splits' partials merged, the output rounded to bf16 once
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      bf16* __restrict__ o, int H, int D,
                                      int splits) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float mm = kNegInf;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f, ll = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = exp2f(ml[2 * s] - mm);
      ll += ml[2 * s + 1] * w;
      acc += part_o[(bh * splits + s) * D + d] * w;
    }
    o[bh * D + d] = __float2bfloat16(acc / fmaxf(ll, 1e-30f));
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v,
             const long long* pos, const long long* position, float* part,
             void* o, int B, const Geom& g, float scale,
             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)decode_attn_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int H = g.KH * g.G;
  float* part_ml = part + (long long)B * H * g.splits * D;
  const dim3 grid(g.splits, g.KH * g.head_chunks, B);
  decode_attn_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pos, position, part, part_ml, g,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * H, D, 0, stream>>>(part, part_ml,
                                                 static_cast<bf16*>(o), H, D,
                                                 g.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D) at (batch, head) strides q_strides; k and v (B, T, KH, D)
// at (batch, slot, head) strides kv_strides (k's three, then v's); pos
// (T,) and position (0-d) int64 on the device; o (B, 1, H, D) contiguous;
// part float32 scratch of B·H·splits·(D + 2).  Keys split into `splits`
// ranges of `tiles_per_split` 64-key tiles.  bf16 only.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* position, void* part, void* o, int B, int H, int KH, int T,
    int D, int window, int splits, int tiles_per_split, float scale,
    const long long* q_strides, const long long* kv_strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if (KH <= 0 || H % KH || splits <= 0 || tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  Geom g{KH, G, T, window, splits, tiles_per_split,
         (G + kRows - 1) / kRows, {}, {}, {}};
  for (int i = 0; i < 2; ++i) g.q[i] = q_strides[i];
  for (int i = 0; i < 3; ++i) {
    g.k[i] = kv_strides[i];
    g.v[i] = kv_strides[3 + i];
  }
  const long long* p = static_cast<const long long*>(pos);
  const long long* now = static_cast<const long long*>(position);
  float* scratch = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, p, now, scratch, o, B, g, scale, st);
    case 128:
      return launch_d<128>(q, k, v, p, now, scratch, o, B, g, scale, st);
    case 256:
      return launch_d<256>(q, k, v, p, now, scratch, o, B, g, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

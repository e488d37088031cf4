// Fused ERA GD step (Γ and ∂Γ/∂(β_up, β_dn, p, p_ap, r)) for Hopper.
//
// Replaces the TPU kernel era_step_fused (src/repro/kernels/era_step/
// kernel.py:177, body _kernel :113, pallas_call :231).  Its plain version is
// repro_torch/kernels/era_step/ref.py::fused_step_math; the arithmetic below
// follows that file line for line, in the same order of operations.
//
// What bounds it on an H100: bytes.  One step reads each (B, M, U) operand
// row once (β up/down, SIC rank/gid) plus the 2·N cross-gain slabs, which
// also hold each user's own-AP gain (the entry at its serving AP), and
// writes the two β-gradient rows: about 22.5 MB per cell at U=1250, M=250,
// N=5.  Its arithmetic is the in-group SIC sums plus a few dozen flops per
// (channel, user): about 3x fewer float32 operations than the 67 TFLOP/s
// CUDA-core rate would need to catch the 3.35 TB/s memory rate.
//
// Design.  The TPU kernel walks a sequential (2, M/bm) grid and carries the
// per-user rate rows in VMEM scratch; Hopper blocks run in no order, so the
// cross-channel sums become separate launches, all in fixed order with no
// atomics (repeated calls are bit-identical, which the solver's |ΔΓ| stop
// test needs):
//   1. pass0  <<<(M, B)>>>  one block per (channel, cell): the channel's
//      SIC contributions are scattered into decode order in shared memory,
//      the per-AP other-cell sums come from a fixed-order block reduction,
//      and every user's in-group suffix comes from one exclusive segmented
//      scan over the decode ranks (seg_scan.cuh); writes β·rate partials
//      to a (2, B, M, U) scratch.
//   2. colsum  sums the partials over m -> the (2, B, U) rate rows.
//   3. tail   <<<B>>>  the M-free delay/energy/QoE/Γ forward and backward.
//   4. pass1  <<<(M, B)>>>  recomputes the channel's forward, keeps ψ in
//      shared memory in decode order, applies the transposed suffix (the
//      forward exclusive segmented scan), writes the β-gradient rows and
//      the d_p / d_p_ap partials.
//   5. colsum  d_p = d_p0 + Σ_m partials, the same for d_p_ap.
// The TPU kernel takes the in-group sums as a masked matvec on the MXU
// (U² work per channel); the scan takes U adds and a few shuffles.  The
// scan relies on each SIC group occupying consecutive decode ranks, which
// build_aux guarantees (gid is the group's first rank).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "seg_scan.cuh"

namespace {

constexpr int kMaxAps = 8;
constexpr int kThreads = 256;
constexpr int kTailThreads = 1024;   // the tail has one block per cell
constexpr int kStripes = 32;         // colsum's stripes of m
constexpr int kEnvLanes = 16;
constexpr float kLn2 = 0.6931471805599453f;
enum { NOISE = 0, BW, C_DEV, C_MIN, LAM_EXP, XI_D, XI_E,
       W_T, W_Q, W_R, QOE_A, T_SCALE, E_SCALE, R_COST };

// max(x, 0) as jnp.maximum: NaN propagates
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }
// d/dx max(x, 0) with the balanced tie rule (0.5 at x == 0)
__device__ __forceinline__ float tie(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? 0.f : 0.5f);
}

__device__ __forceinline__ int serving_ap(const float* oh, int i, int U,
                                          int N) {
  int a = 0;
  for (int n = N - 1; n >= 0; --n)
    if (oh[(size_t)n * U + i] != 0.f) a = n;
  return a;
}

// Sum each of K per-thread values over the block, in a fixed order (warp
// shuffle tree, then warps in index order).  red: K * 32 floats of shared.
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[k * 32 + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = red[threadIdx.x * 32];
    for (int w = 1; w < nw; ++w) s += red[threadIdx.x * 32 + w];
    red[threadIdx.x * 32] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[k * 32];
  __syncthreads();
}

struct Ops {
  const float *beta_up_t, *beta_dn_t, *p, *p_ap, *r, *q, *dev_fl, *edge_fl,
      *wup, *wdn, *envp, *h_up_r, *h_dn_r, *onehot;
  const int *up_rank, *up_gid, *dn_rank, *dn_gid;
};

// Per-(channel, cell) view of the operands.  A user's own-AP gain is the
// entry of the cross-gain slab at its serving AP, so it is read from there.
struct Chan {
  const float *bu, *bd, *pu, *pd, *oh;
  const int *urank, *ugid, *drank, *dgid;
  const float *hup, *hdn;    // (N, M, U) slabs of this cell
  size_t row;                // offset of (b, m, 0) in (B, M, U)
  int M, U, N, m;
  float noise, bw;
  __device__ float h_up(int n, int i) const {
    return hup[((size_t)n * M + m) * U + i];
  }
  __device__ float h_dn(int n, int i) const {
    return hdn[((size_t)n * M + m) * U + i];
  }
};

__device__ Chan make_chan(const Ops& o, int b, int m, int M, int U, int N) {
  Chan c;
  c.row = ((size_t)b * M + m) * U;
  c.bu = o.beta_up_t + c.row;
  c.bd = o.beta_dn_t + c.row;
  c.urank = o.up_rank + c.row;
  c.ugid = o.up_gid + c.row;
  c.drank = o.dn_rank + c.row;
  c.dgid = o.dn_gid + c.row;
  c.pu = o.p + (size_t)b * U;
  c.pd = o.p_ap + (size_t)b * U;
  c.oh = o.onehot + (size_t)b * N * U;
  c.hup = o.h_up_r + (size_t)b * N * M * U;
  c.hdn = o.h_dn_r + (size_t)b * N * M * U;
  c.M = M; c.U = U; c.N = N; c.m = m;
  c.noise = o.envp[b * kEnvLanes + NOISE];
  c.bw = o.envp[b * kEnvLanes + BW];
  return c;
}

// Scatter the channel's uplink contributions and downlink components into
// decode order, and reduce the per-AP sums: acc[n] = uplink β·p·h received
// at AP n from other-cell users, acc[kMaxAps + n] = AP n's downlink power.
// s_ap keeps each user's serving AP (user order) for the later loops.
__device__ void load_channel(const Chan& c, float* s_cu, int* s_gu,
                             float* s_cd, int* s_gd, int* s_ap, float* red,
                             float (&acc)[2 * kMaxAps]) {
#pragma unroll
  for (int k = 0; k < 2 * kMaxAps; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < c.U; i += blockDim.x) {
    const int a = serving_ap(c.oh, i, c.U, c.N);
    s_ap[i] = a;
    const float bp = c.bu[i] * c.pu[i];
    const int ku = c.urank[i];
    s_cu[ku] = bp * c.h_up(a, i);
    s_gu[ku] = c.ugid[i];
    const float cd = c.bd[i] * c.pd[i];
    const int kd = c.drank[i];
    s_cd[kd] = cd;
    s_gd[kd] = c.dgid[i];
#pragma unroll
    for (int n = 0; n < kMaxAps; ++n) {
      if (n >= c.N) break;
      if (n != a) acc[n] += bp * c.h_up(n, i);
      else acc[kMaxAps + n] += cd;
    }
  }
  block_sum<2 * kMaxAps>(acc, red);
}

// The in-group sums of both directions at once (seg_scan.cuh).
template <bool kSuffix>
__device__ void seg_scan2(float* v0, const int* g0, float* v1,
                          const int* g1, int U, float* red) {
  float* v[2] = {v0, v1};
  const int* g[2] = {g0, g1};
  seg_scan<kSuffix, 2>(v, g, U, red);
}

struct UpFwd { float intra, d, sinr, rate; };
struct DnFwd { float intra, raw, d, sinr, rate; };

__device__ __forceinline__ UpFwd up_forward(const Chan& c, const float* s_cu,
                                            const float (&acc)[2 * kMaxAps],
                                            int i, int a) {
  UpFwd f;
  f.intra = s_cu[c.urank[i]];
  float raw_a = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxAps; ++n)
    if (n == a) raw_a = acc[n];
  f.d = relu(f.intra) + relu(raw_a) + c.noise;
  f.sinr = (c.pu[i] * c.h_up(a, i)) / f.d;
  f.rate = c.bw * log2f(1.f + f.sinr);
  return f;
}

__device__ __forceinline__ DnFwd dn_forward(const Chan& c, const float* s_cd,
                                            const float (&acc)[2 * kMaxAps],
                                            int i, int a) {
  DnFwd f;
  const float own = c.h_dn(a, i);
  f.intra = s_cd[c.drank[i]] * own;
  f.raw = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxAps; ++n) {
    if (n >= c.N) break;
    if (n != a) f.raw += acc[kMaxAps + n] * c.h_dn(n, i);
  }
  f.d = relu(f.intra) + relu(f.raw) + c.noise;
  f.sinr = (c.pd[i] * own) / f.d;
  f.rate = c.bw * log2f(1.f + f.sinr);
  return f;
}

__global__ void __launch_bounds__(kThreads)
pass0_kernel(Ops o, float* parts, int B, int M, int U, int N) {
  extern __shared__ float smem[];
  __shared__ float red[2 * kMaxAps * 32];
  float* s_cu = smem;
  int* s_gu = reinterpret_cast<int*>(smem + U);
  float* s_cd = smem + 2 * U;
  int* s_gd = reinterpret_cast<int*>(smem + 3 * U);
  int* s_ap = reinterpret_cast<int*>(smem + 4 * U);
  const int m = blockIdx.x, b = blockIdx.y;
  const Chan c = make_chan(o, b, m, M, U, N);
  float acc[2 * kMaxAps];
  load_channel(c, s_cu, s_gu, s_cd, s_gd, s_ap, red, acc);
  seg_scan2<true>(s_cu, s_gu, s_cd, s_gd, U, red);
  float* part_up = parts + c.row;
  float* part_dn = parts + (size_t)B * M * U + c.row;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const int a = s_ap[i];
    const UpFwd fu = up_forward(c, s_cu, acc, i, a);
    part_up[i] = c.bu[i] * fu.rate;
    const DnFwd fd = dn_forward(c, s_cd, acc, i, a);
    part_dn[i] = c.bd[i] * fd.rate;
  }
}

// out[pl, j] = add0[pl, j] + Σ_m in[pl, m, j], m summed in a fixed order:
// kStripes stripes of m, then the stripes in index order.
__global__ void colsum_kernel(const float* in, const float* add0, float* out,
                              int M, int U) {
  __shared__ float part[kStripes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  const size_t pl = blockIdx.y;
  float s = 0.f;
  if (j < U) {
    const float* base = in + pl * M * U + j;
#pragma unroll 4
    for (int m = ty; m < M; m += kStripes) s += base[(size_t)m * U];
  }
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < U) {
    float t = part[0][tx];
#pragma unroll
    for (int k = 1; k < kStripes; ++k) t += part[k][tx];
    out[pl * U + j] = add0 ? add0[pl * U + j] + t : t;
  }
}

// The M-free tail (ref.tail_grads): rows (4, B, U) = g_rup, g_rdn, d_p0,
// d_pap0; gamma (B,); d_r (B, U).
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(Ops o, const float* rates, float* gamma, float* rows,
            float* d_r, int B, int U) {
  __shared__ float red[5 * 32];
  const int b = blockIdx.x;
  const float* env = o.envp + b * kEnvLanes;
  const float c_dev = env[C_DEV], c_min = env[C_MIN], lam_exp = env[LAM_EXP];
  const float xi_d = env[XI_D], xi_e = env[XI_E];
  const float w_t = env[W_T], w_q = env[W_Q], w_r = env[W_R];
  const float qoe_a = env[QOE_A], t_scale = env[T_SCALE];
  const float e_scale = env[E_SCALE], r_cost = env[R_COST];
  const size_t bu = (size_t)b * U, plane = (size_t)B * U;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < U; j += blockDim.x) {
    const size_t ix = bu + j;
    const float r_up = rates[ix], r_dn = rates[plane + ix];
    const float p = o.p[ix], p_ap = o.p_ap[ix], r = o.r[ix], q = o.q[ix];
    const float dev_fl = o.dev_fl[ix], edge_fl = o.edge_fl[ix];
    const float wup = o.wup[ix], wdn = o.wdn[ix];
    const float lam = powf(r, lam_exp);
    const float lam_p = lam_exp * powf(r, lam_exp - 1.f);
    const float edge_c = lam * c_min;
    const float t_dev = dev_fl / c_dev;
    const float t_srv = edge_fl / edge_c;
    const float mup = r_up < 1.f ? 1.f : r_up;
    const float mdn = r_dn < 1.f ? 1.f : r_dn;
    const float t = t_dev + t_srv + wup / mup + wdn / mdn;
    const float e = xi_d * (c_dev * c_dev) * dev_fl
                    + xi_e * (edge_c * edge_c) * edge_fl
                    + p * wup / mup + p_ap * wdn / mdn;
    const float rq = 1.f / (1.f + expf(-(qoe_a * (t / q - 1.f))));
    acc[0] += t;
    acc[1] += (t - q) * rq;
    acc[2] += rq;
    acc[3] += e;
    acc[4] += lam;
    const float rp = qoe_a * rq * (1.f - rq) / q;
    const float g_t = w_t * t_scale
                      + w_q * (t_scale * (rq + (t - q) * rp) + rp);
    const float g_e = w_r * e_scale;
    d_r[ix] = g_t * (-edge_fl * c_min * lam_p / (edge_c * edge_c))
              + g_e * (2.f * xi_e * (c_min * c_min) * lam * lam_p * edge_fl)
              + w_r * r_cost * lam_p;
    rows[ix] = -tie(r_up - 1.f) * (wup / (mup * mup)) * (g_t + g_e * p);
    rows[plane + ix] =
        -tie(r_dn - 1.f) * (wdn / (mdn * mdn)) * (g_t + g_e * p_ap);
    rows[2 * plane + ix] = g_e * wup / mup;
    rows[3 * plane + ix] = g_e * wdn / mdn;
  }
  block_sum<5>(acc, red);
  if (threadIdx.x == 0)
    gamma[b] = w_t * acc[0] * t_scale + w_q * (acc[1] * t_scale + acc[2])
               + w_r * (acc[3] * e_scale + acc[4] * r_cost);
}

__global__ void __launch_bounds__(kThreads)
pass1_kernel(Ops o, const float* rows, float* d_bu, float* d_bd,
             float* parts, int B, int M, int U, int N) {
  extern __shared__ float smem[];
  __shared__ float red[2 * kMaxAps * 32];
  float* s_cu = smem;
  int* s_gu = reinterpret_cast<int*>(smem + U);
  float* s_wu = smem + 2 * U;
  float* s_cd = smem + 3 * U;
  int* s_gd = reinterpret_cast<int*>(smem + 4 * U);
  float* s_wd = smem + 5 * U;
  float* u_rate = smem + 6 * U;    // user order from here on
  float* u_q = smem + 7 * U;       // d_sinr / D, uplink
  float* d_rate = smem + 8 * U;
  float* d_q = smem + 9 * U;
  int* s_ap = reinterpret_cast<int*>(smem + 10 * U);   // user order
  const int m = blockIdx.x, b = blockIdx.y;
  const Chan c = make_chan(o, b, m, M, U, N);
  const size_t plane = (size_t)B * U;
  const float* g_rup = rows + (size_t)b * U;
  const float* g_rdn = rows + plane + (size_t)b * U;
  float acc[2 * kMaxAps];
  load_channel(c, s_cu, s_gu, s_cd, s_gd, s_ap, red, acc);
  seg_scan2<true>(s_cu, s_gu, s_cd, s_gd, U, red);

  // forward again, then the cotangents of the SINR denominators
  float gsum[2 * kMaxAps];
#pragma unroll
  for (int k = 0; k < 2 * kMaxAps; ++k) gsum[k] = 0.f;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const int a = s_ap[i];
    const UpFwd fu = up_forward(c, s_cu, acc, i, a);
    const float d_sinr = (g_rup[i] * c.bu[i]) * c.bw / ((1.f + fu.sinr) * kLn2);
    const float psi = -d_sinr * fu.sinr / fu.d;
    s_wu[c.urank[i]] = psi * tie(fu.intra);
    u_rate[i] = fu.rate;
    u_q[i] = d_sinr / fu.d;
    const DnFwd fd = dn_forward(c, s_cd, acc, i, a);
    const float d_sinr_d =
        (g_rdn[i] * c.bd[i]) * c.bw / ((1.f + fd.sinr) * kLn2);
    const float psi_d = -d_sinr_d * fd.sinr / fd.d;
    const float d_inter = psi_d * tie(fd.raw);
    s_wd[c.drank[i]] = psi_d * tie(fd.intra) * c.h_dn(a, i);
    d_rate[i] = fd.rate;
    d_q[i] = d_sinr_d / fd.d;
#pragma unroll
    for (int n = 0; n < kMaxAps; ++n) {
      if (n >= N) break;
      if (n == a) gsum[n] += psi;
      else gsum[kMaxAps + n] += d_inter * c.h_dn(n, i);
    }
  }
  block_sum<2 * kMaxAps>(gsum, red);   // also orders s_w* writes before reads
#pragma unroll
  for (int n = 0; n < kMaxAps; ++n) gsum[n] *= tie(acc[n]);
  seg_scan2<false>(s_wu, s_gu, s_wd, s_gd, U, red);

  float* part_p = parts + c.row;
  float* part_pap = parts + (size_t)B * M * U + c.row;
  for (int j = threadIdx.x; j < U; j += blockDim.x) {
    const int a = s_ap[j];
    const float own_up = c.h_up(a, j), own_dn = c.h_dn(a, j);
    // uplink: β gradient row and the d_p partial
    float d_bp = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxAps; ++n) {
      if (n >= N) break;
      if (n != a) d_bp += gsum[n] * c.h_up(n, j);
    }
    d_bp = d_bp + s_wu[c.urank[j]] * own_up;
    d_bu[c.row + j] = g_rup[j] * u_rate[j] + d_bp * c.pu[j];
    part_p[j] = d_bp * c.bu[j] + u_q[j] * own_up;
    // downlink
    float d_ap_a = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxAps; ++n)
      if (n == a) d_ap_a = gsum[kMaxAps + n];
    const float d_comp = s_wd[c.drank[j]] + d_ap_a;
    d_bd[c.row + j] = g_rdn[j] * d_rate[j] + d_comp * c.pd[j];
    part_pap[j] = d_comp * c.bd[j] + d_q[j] * own_dn;
  }
}

// The dynamic shared-memory limit a kernel was raised to, per device.  The
// attribute is a property of the function in the device's context, not of a
// launch: raising it once per device (and again only for a larger U) keeps
// the call out of launches a CUDA graph captures after its warm-up call.
// The record is stored only after the attribute is set, under one mutex, so
// host threads with different U can neither lower the attribute below the
// record nor skip a raise that another thread has not finished.
constexpr int kMaxDevices = 64;
std::atomic<size_t> g_smem_set[2][kMaxDevices];
std::mutex g_smem_mu;

cudaError_t smem_limit(int which, const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<size_t>& set = g_smem_set[which][dev];
  if (set.load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_smem_mu);
  if (set.load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) set.store(bytes, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" int era_step_launch(
    const float* beta_up_t, const float* beta_dn_t, const float* p,
    const float* p_ap, const float* r, const float* q, const float* dev_fl,
    const float* edge_fl, const float* wup, const float* wdn,
    const float* envp, const float* h_up_r, const float* h_dn_r,
    const float* onehot,
    const int* up_rank, const int* up_gid, const int* dn_rank,
    const int* dn_gid,
    float* gamma, float* d_bu, float* d_bd, float* d_pp, float* d_r,
    float* parts, float* rates, float* rows,
    int B, int M, int U, int N, void* stream) {
  if (N > kMaxAps || N < 1) return (int)cudaErrorInvalidValue;
  const Ops o{beta_up_t, beta_dn_t, p, p_ap, r, q, dev_fl, edge_fl, wup, wdn,
              envp, h_up_r, h_dn_r, onehot,
              up_rank, up_gid, dn_rank, dn_gid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem0 = 5 * (size_t)U * sizeof(float);
  const size_t smem1 = 11 * (size_t)U * sizeof(float);
  cudaError_t err = smem_limit(0, (const void*)pass0_kernel, smem0);
  if (err != cudaSuccess) return (int)err;
  err = smem_limit(1, (const void*)pass1_kernel, smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 chan_grid(M, B);
  const dim3 sum_grid((U + 31) / 32, 2 * B), sum_block(32, kStripes);
  pass0_kernel<<<chan_grid, kThreads, smem0, s>>>(o, parts, B, M, U, N);
  colsum_kernel<<<sum_grid, sum_block, 0, s>>>(parts, nullptr, rates, M, U);
  tail_kernel<<<B, kTailThreads, 0, s>>>(o, rates, gamma, rows, d_r, B, U);
  pass1_kernel<<<chan_grid, kThreads, smem1, s>>>(o, rows, d_bu, d_bd, parts,
                                                  B, M, U, N);
  colsum_kernel<<<sum_grid, sum_block, 0, s>>>(parts, rows + 2 * (size_t)B * U,
                                               d_pp, M, U);
  return (int)cudaGetLastError();
}

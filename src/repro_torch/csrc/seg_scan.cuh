// Exclusive segmented block scan over SIC decode order, shared by
// era_step.cu (the in-group sums of both directions) and noma_rate.cu (the
// uplink suffix).
#pragma once

namespace {

// Groups are runs of consecutive decode ranks (build_aux's layout; the
// non-decreasing group-end keys of a Scenario), so a group boundary sits
// after k when the next rank's group differs: k is the last of its group
// in the suffix direction, the first in the prefix one.
template <bool kSuffix>
__device__ __forceinline__ bool seg_head(const int* g, int k, int U) {
  if (kSuffix) return k == U - 1 || g[k + 1] != g[k];
  return k == 0 || g[k - 1] != g[k];
}

// Exclusive segmented scan, in place, of K decode-order arrays at once:
//   kSuffix:  v[k] <- Σ v[kk] over kk > k in k's group (the SIC suffix)
//   !kSuffix: v[k] <- Σ v[kk] over kk < k in k's group (its transpose)
// Each thread owns R = ceil(U / blockDim) consecutive ranks.  A serial
// pass gives its run's aggregate (the sum carried out of the run and
// whether a group boundary inside it stops an incoming carry); a warp
// shuffle scan and then the warps' aggregates in index order give the
// carry into each run; a second serial pass writes the exclusive sums.
// The position at a group's far end gets the scan's identity, 0.0, not a
// difference of two sums, so the balanced relu tie fires as in autodiff.
// Fixed order, no atomics: repeated calls are bit-identical.  red: K·64
// floats of shared; the caller has synchronised v and g.
template <bool kSuffix, int K>
__device__ void seg_scan(float* (&v)[K], const int* (&g)[K], int U,
                         float* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int R = (U + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * R, U), hi = min(lo + R, U), n = hi - lo;
  float agg[K];
  bool stop[K];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    float s = 0.f;
    bool f = false;
    for (int j = 0; j < n; ++j) {
      const int k = kSuffix ? hi - 1 - j : lo + j;
      if (seg_head<kSuffix>(g[a], k, U)) { s = 0.f; f = true; }
      s += v[a][k];
    }
    // inclusive scan over the warp's runs, toward the carry's direction
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float os = kSuffix ? __shfl_down_sync(0xffffffffu, s, d)
                               : __shfl_up_sync(0xffffffffu, s, d);
      const int of = kSuffix ? __shfl_down_sync(0xffffffffu, (int)f, d)
                             : __shfl_up_sync(0xffffffffu, (int)f, d);
      if (kSuffix ? lane + d < 32 : lane >= d) {
        if (!f) s += os;
        f = f || of;
      }
    }
    agg[a] = s;
    stop[a] = f;
    if (lane == (kSuffix ? 0 : 31)) {
      red[a * 64 + warp] = s;
      red[a * 64 + 32 + warp] = f ? 1.f : 0.f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < K; ++a) {
    // carry into this warp: the warps beyond it, nearest last
    float c = 0.f;
    if (kSuffix) {
      for (int w = nw - 1; w > warp; --w)
        c = red[a * 64 + 32 + w] != 0.f ? red[a * 64 + w]
                                        : red[a * 64 + w] + c;
    } else {
      for (int w = 0; w < warp; ++w)
        c = red[a * 64 + 32 + w] != 0.f ? red[a * 64 + w]
                                        : red[a * 64 + w] + c;
    }
    const float incl = stop[a] ? agg[a] : agg[a] + c;
    // carry into this run: the inclusive value of the neighbouring run
    const float nb = kSuffix ? __shfl_down_sync(0xffffffffu, incl, 1)
                             : __shfl_up_sync(0xffffffffu, incl, 1);
    float s = lane == (kSuffix ? 31 : 0) ? c : nb;
    for (int j = 0; j < n; ++j) {
      const int k = kSuffix ? hi - 1 - j : lo + j;
      if (seg_head<kSuffix>(g[a], k, U)) s = 0.f;
      const float x = v[a][k];
      v[a][k] = s;
      s += x;
    }
  }
  __syncthreads();
}

}  // namespace

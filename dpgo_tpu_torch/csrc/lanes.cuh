// The lane layout of the cluster and spread kernels at rank r, shared by
// rtr_cluster.cu and rtr_spread.cu (ops/rtr_kernel.py mirrors the
// formulae).  Up to r = 32 a pose takes r lanes of a warp, one row each,
// and a warp holds 32 / r poses; above it a pose takes ceil(r / 32) whole
// warps, row q on lane q % 32 of warp q / 32, and its group sums meet in
// kGroupSums shared slots a warp (D (D + 1) / 2 <= 6 values).  At r = 512 a
// pose of 16 warps fills a CTA of 512 threads, the cluster route's cap
// (pose_fits).  Above it the spread route folds a pose's rows over the
// CTA's lanes: row q on thread q % kFoldRows at fold q / kFoldRows, so a
// lane holds pose_folds(r) rows and the pose takes pose_warps(kFoldRows)
// = 16 warps.  The cluster route's B2 and B4 at 11 <= r <= 32 may fold a
// pose's rows over an aligned segment of L lanes instead (L in {8, 16}):
// row q on lane q % L at fold q / L, lane_folds(r, L) <= 4 rows a lane,
// 32 / L poses a warp, and a group sum is each lane's folds added in fold
// order, then log2 L butterfly steps within the segment (segment_sum).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kGroupSums = 8;
// Rows of a pose on distinct lanes at most: 16 warps of one CTA.
constexpr int kFoldRows = 512;

// Rows a lane holds of its pose (its folds): one up to r = kFoldRows,
// ceil(r / kFoldRows) above (the spread route only).
__host__ __device__ constexpr int pose_folds(int r) {
  return r <= kFoldRows ? 1 : (r + kFoldRows - 1) / kFoldRows;
}

// Poses a warp holds: 32 / r up to r = 32, one (over several warps) above.
__host__ __device__ constexpr int poses_per_warp(int r) {
  return r <= 32 ? 32 / r : 1;
}

// Warps one pose takes, one row a lane: 1 up to r = 32, ceil(r / 32)
// above.
__host__ __device__ constexpr int pose_warps(int r) {
  return r <= 32 ? 1 : (r + 31) / 32;
}

// Whether one pose's lane group, one row a lane, fits a CTA of
// `max_threads` threads; the cluster launchers refuse a rank whose pose
// does not (r > 512).
__host__ __device__ constexpr bool pose_fits(int r, int max_threads) {
  return pose_warps(r) <= max_threads / 32;
}

// Shared floats of the group-sum slots of a CTA of `warps` warps: only a
// pose that spans warps (r > 32) sums through them.
__host__ __device__ constexpr int group_slots(int r, int warps) {
  return r > 32 ? warps * kGroupSums : 0;
}

// Sums of N values over the rows of a pose that spans warps (r > 32; a
// folded pose passes r = kFoldRows, each lane the sum of its rows' terms
// added in fold order): each warp's butterfly sum goes to its slot of
// `gslots` ([warps][kGroupSums], shared), and after a block barrier every
// lane adds its pose's warps' slots in order, so every lane of the pose
// ends with the same values.  A second barrier frees the slots.  Every
// thread of the CTA must call it.
template <int N>
__device__ void wide_group_sum(float* gslots, int r, float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  const int warp = threadIdx.x >> 5;
  const int W = pose_warps(r);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) gslots[warp * kGroupSums + i] = v[i];
  }
  __syncthreads();
  const float* first = gslots + (warp - warp % W) * kGroupSums;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = first[i];
    for (int j = 1; j < W; ++j) s += first[j * kGroupSums + i];
    v[i] = s;
  }
  __syncthreads();
}

// Rows a lane holds of its pose on a segment of L lanes: ceil(r / L).
__host__ __device__ constexpr int lane_folds(int r, int L) {
  return (r + L - 1) / L;
}

// Sums of N values over an aligned segment of L lanes (a power of two up
// to 32): log2 L butterfly steps, each adding the same two operands on
// both lanes it pairs, so every lane of the segment ends with bit-identical
// values and no barrier is needed.  All 32 lanes of the warp must call it.
template <int L, int N>
__device__ __forceinline__ void segment_sum(float (&v)[N]) {
  static_assert(L > 0 && L <= 32 && (L & (L - 1)) == 0,
                "a segment is a power of two lanes");
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

}  // namespace

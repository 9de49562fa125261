// The phases of the spread and grid kernels (rtr_spread.cu, rtr_grid.cu):
// one agent over C CTAs, lane groups walking the CTAs' poses in stripes.
// rtr_spread.cu's header says what they compute and how; this file holds
// what both routes run.  Three primitives differ between them, picked by
// the template parameter GRID of the phases below (false: the spread route,
// true: the grid route):
//   * where the CG direction (twice) and z live: the owning CTA's shared
//     memory, read across the cluster through distributed shared memory;
//     on the grid route the agent's workspace, like every other vector,
//     rows another CTA wrote read at L2;
//   * the reduction (cluster_sum): slots in every CTA's shared memory; on
//     the grid route one slot per CTA in the workspace (grid_sum);
//   * the barrier: the cluster's; on the grid route the agent's own
//     arrival counter in the workspace (grid_barrier).
// At GRID = false every phase compiles to the text it had before the grid
// route existed.

#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "lanes.cuh"
#include "shapes.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace dpgo_spread {
namespace {

// Threads per CTA at most (ops/rtr_kernel.SPREAD_THREADS); values a
// reduction slot holds.
constexpr int kThreads = 512;
constexpr int kMaxSums = 4;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
// Shared memory one CTA can use on sm_90 (ops/rtr_kernel.MAX_SMEM_BYTES).
constexpr size_t kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-30f;
constexpr int kNsSweeps = 24;
// Loop vectors, each [pose][vec_stride(RK)], a pose's rows in order.  The
// first kSmemVecs live in the owning CTA's shared memory, the rest in the
// agent's workspace.  The refine kernel adds the correction D and the
// reference Rc; its kX holds Y = Rc + D.
enum Vec {
  kDelta, kDeltaB, kZv, kSmemVecs,
  kX = kSmemVecs, kXp, kG, kEta, kHeta, kR, kHd, kVecs,
  kD = kVecs, kRc, kRefineVecs
};
// An ELL entry's word (rtr_cluster.cu's): where the other endpoint's values
// are (a pose: its CTA's rank and its slot there; a neighbor slot: its
// index into Z; neither: zero) and three flags.
constexpr int kIndexMask = (1 << 20) - 1;
constexpr int kRankShift = 20;  // 4 bits: cluster ranks below 16
constexpr int kPose = 1 << 24;
constexpr int kSlot = 1 << 25;
constexpr int kLive = 1 << 26;
constexpr int kCostOwner = 1 << 27;
constexpr int kSideJ = 1 << 28;
// Launcher errors: the card cannot place one cluster of this size (or one
// CTA's shared memory exceeds kMaxSmemBytes); more neighbor slots than a
// payload word can index; an unknown kernel number.
constexpr int kUnplaceable = -2;
constexpr int kTooManySlots = -3;
constexpr int kUnknownKernel = -4;
// The kernels, as the launchers and the host plan number them
// (ops/rtr_kernel.KERNELS).
constexpr int kRtrFull = 0;
constexpr int kRtr = 1;
constexpr int kTcg = 2;
constexpr int kRefine = 3;

__host__ __device__ constexpr int vec_stride(int rk) {
  return ((rk + 3) / 4) % 2 ? (rk + 3) / 4 * 4 : (rk + 3) / 4 * 4 + 4;
}

// Floats rounded up to whole float4s.
__host__ __device__ constexpr int quad(int n) { return (n + 3) / 4 * 4; }

// Per-pose records of the workspace, each whole float4s: the factor's
// lower triangle (row-major, i(i+1)/2 + q), the curvature S [D][D]; and
// per edge: rot (D*D), trn (D), wk, wt.
__host__ __device__ constexpr int l_floats(int d) {
  return quad((d + 1) * (d + 2) / 2);
}

__host__ __device__ constexpr int s_floats(int d) { return quad(d * d); }

__host__ __device__ constexpr int edge_floats(int d) {
  return quad(d * d + d + 2);
}

struct SpreadShape {
  int P, threads, stripes;
  size_t smem;
};

// The one formula for the spread kernels' shape (ops/rtr_kernel.
// spread_shape mirrors it): 32 / r poses per warp (ceil(r / 32) warps per
// pose above r = 32, 16 warps and pose_folds(r) rows a lane above r =
// 512), at most kThreads threads of whole groups, ceil(P / groups)
// stripes; shared memory holds the kSmemVecs vectors [P][vec_stride], the
// double-buffered reduction slots [2][C * warps][4] and, above r = 32, the
// group-sum slots [warps][kGroupSums].  B1-B4 share it.  A shape of
// more than kMaxSmemBytes does not fit, and the launchers refuse it.
SpreadShape spread_shape(int r, int d, int n, int C) {
  const int P = (n + C - 1) / C;
  const int per_warp = poses_per_warp(r);
  const int W = pose_warps(r < kFoldRows ? r : kFoldRows);
  int threads = (P + per_warp - 1) / per_warp * 32 * W;
  if (threads > kThreads) threads = kThreads / 32 / W * W * 32;
  const int groups = threads / 32 / W * per_warp;
  const int stripes = (P + groups - 1) / groups;
  const size_t floats = (size_t)kSmemVecs * P * vec_stride(r * (d + 1)) +
                        2 * (size_t)C * (threads / 32) * kMaxSums +
                        group_slots(r, threads / 32);
  return {P, threads, stripes, floats * sizeof(float)};
}

// Floats of one agent's workspace: the device-memory vectors [C P][vs],
// the records L [C P][l_floats] and S [C P][s_floats], each CTA's edge
// records of its poses' live ELL entries [Kinc][P][edge_floats], the
// reference residuals [E][R][K] (refine: a row of rho_rot and rho_trn
// each), and each CTA's ints: live counts [P], then words, edge numbers
// and the setup's slot numbers [Kinc][P].  On the grid route (grid) every
// vector is a device-memory one, and the workspace starts with
// grid_head_floats(C): the reduction buffers and the arrival counter.
__host__ __device__ constexpr int grid_head_floats(int C) {
  return 2 * C * kMaxSums + 4;
}

long long workspace_floats(int r, int d, int n, int e_max, int kinc, int C,
                           bool refine, bool grid = false) {
  const long long P = (n + C - 1) / C;
  const long long np = C * P;
  const int vecs = (refine ? kRefineVecs : kVecs) - (grid ? 0 : kSmemVecs);
  const long long floats =
      vecs * np * vec_stride(r * (d + 1)) +
      (long long)(l_floats(d) + s_floats(d)) * np +
      (long long)C * kinc * P * edge_floats(d) +
      (refine ? (long long)e_max * r * (d + 1) : 0) +
      C * P * (1 + 3LL * kinc);
  return (floats + 3) / 4 * 4 + (grid ? grid_head_floats(C) : 0);
}

}  // namespace

// The launchers' arguments: a type every translation unit of this source
// shares (see shapes.cuh).
struct SpreadArgs {
  int n, s, Ep, T, E, kinc;
  const int* idx_i;
  const int* idx_j;
  const float* rot;
  const float* trn;
  const float* wk;
  const float* wt;
  const float* X;        // X, or the correction D in refine
  const float* Z;        // Z, or Dz in refine
  const float* L;
  const float* S;        // S0 in refine, else nullptr
  const float* g;        // g0 in refine, else nullptr
  const float* Rc;       // refine only, else nullptr
  const float* Gref;     // refine only
  const float* rho_rot;  // refine only
  const float* rho_trn;  // refine only
  const int* inc;
  const float* incm;
  const int* n_local;
  float* ws;
  long long ws_stride;
  int max_iters;
  float kappa, theta;
};

// The arguments of the rank-generic instantiation (R = 0): the rank too.
// The templated shapes keep SpreadArgs, so their kernels compile as they
// did before R = 0 existed.
struct SpreadArgsR : SpreadArgs {
  int r;
};

template <int R>
using ArgsOf = std::conditional_t<R == 0, SpreadArgsR, SpreadArgs>;

namespace {

// One thread's view of its agent: the cluster's shape, this thread's lane
// group and row, the pose of the current stripe, and where the vectors,
// factors and payload live.
struct Ctx {
  int n, s, kinc, n_act, P, C, rank, parity;
  int np;           // C P: poses in a workspace vector
  int groups;       // lane groups per CTA
  int stripes;      // ceil(P / groups)
  int grp;          // this thread's lane group
  int row;          // this thread's row of the pose's block
  int base;         // the lane of row 0 of the pose
  bool lane_ok;     // the lane belongs to a group (32 / R groups a warp)
  int pl;           // the current stripe's pose slot in this CTA
  bool own;         // this thread holds a row of it (slot < P, pose < n)
  const float* Z;   // [RK, s] neighbor slots, device memory
  float* vec;       // shared [kSmemVecs][P][VS]
  float* gv;        // workspace [vecs][C P][VS]
  float* L;         // workspace [C P][l_floats]
  float* S;         // workspace [C P][s_floats]
  float* rec;       // workspace [Kinc][P][edge_floats] of this CTA
  float* rho;       // workspace [E][R][K] (refine), else nullptr
  int* cnt;         // workspace [P]: live ELL entries of each pose
  int* words;       // workspace [Kinc][P]: words of the live entries
  int* eids;        // workspace [Kinc][P]: their edges
  float* red;       // shared [2][C * warps][kMaxSums]
};

// rtr_cluster.cu's CtxR: the launch's rank and the group-sum slots of the
// rank-generic instantiation (R = 0), read through rank_of and
// wide_group_sum at R = 0 only.
struct CtxR : Ctx {
  int r;
  float* gslots;  // shared [warps][kGroupSums] (r > 32)
};

// The fold kernels' view (r > 512): the thread's folds of a pose.
struct CtxF : CtxR {
  int folds;  // rows this thread holds of a pose (pose_folds)
  int row0;   // its row at fold 0
};

template <int R>
using CtxOf = std::conditional_t<R == 0, CtxR, Ctx>;

// The rank: the template's, or at R = 0 the launch's.
template <int R>
__device__ __forceinline__ int rank_of(const Ctx& cx) {
  if constexpr (R == 0) {
    return static_cast<const CtxR&>(cx).r;
  } else {
    return R;
  }
}

// Point the thread at stripe st: pose slot st * groups + grp of its CTA.
__device__ __forceinline__ void at_stripe(Ctx& cx, int st) {
  cx.pl = st * cx.groups + cx.grp;
  cx.own = cx.lane_ok && cx.pl < cx.P && cx.rank * cx.P + cx.pl < cx.n;
}

// Point the thread at fold f of the current stripe's pose: row row0 + f
// kFoldRows, held when the pose is and the row lies below r.
__device__ __forceinline__ void at_fold(CtxF& cx, int f) {
  cx.row = cx.row0 + f * kFoldRows;
  cx.own = cx.lane_ok && cx.pl < cx.P && cx.rank * cx.P + cx.pl < cx.n &&
           cx.row < cx.r;
}

// The agent-wide index of this CTA's pose slot pl.
__device__ __forceinline__ int pose_of(const Ctx& cx, int pl) {
  return cx.rank * cx.P + pl;
}

template <int K>
__device__ __forceinline__ void ld_row(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) v[q] = p[q];
  }
}

// A row another CTA wrote: read at L2 (ld.global.cg), never from a copy
// this SM's L1 may hold from before the barrier that published it.
template <int K>
__device__ __forceinline__ void ld_row_l2(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) v[q] = __ldcg(p + q);
  }
}

// N floats (whole float4s) of a record this CTA wrote.
template <int N>
__device__ __forceinline__ void ld_rec(const float* p, float (&v)[N]) {
  static_assert(N % 4 == 0, "records are whole float4s");
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 t = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = t.x;
    v[4 * j + 1] = t.y;
    v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}

template <int K>
__device__ __forceinline__ void st_row(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) p[q] = v[q];
  }
}

// Floats a pose takes in a vector: vec_stride of the template's rank, or
// at R = 0 of the launch's.
template <int R, int K>
__device__ __forceinline__ int vs_of(const Ctx& cx) {
  if constexpr (R == 0) {
    return vec_stride(rank_of<0>(cx) * K);
  } else {
    return vec_stride(R * K);
  }
}

// Row `row` of pose slot pl of this CTA in vector v: shared memory for the
// first kSmemVecs, else the workspace; on the grid route (GRID) the workspace
// for every vector, [v][C P][VS] from its start.
template <int R, int K, bool GRID = false>
__device__ __forceinline__ float* row_at(const Ctx& cx, int v, int pl) {
  if constexpr (GRID) {
    return cx.gv + ((size_t)v * cx.np + pose_of(cx, pl)) * vs_of<R, K>(cx) +
           cx.row * K;
  }
  if constexpr (R == 0) {
    const int VS = vec_stride(rank_of<0>(cx) * K);
    if (v < kSmemVecs)
      return cx.vec + ((size_t)v * cx.P + pl) * VS + cx.row * K;
    return cx.gv + ((size_t)(v - kSmemVecs) * cx.np + pose_of(cx, pl)) * VS +
           cx.row * K;
  }
  constexpr int VS = vec_stride(R * K);
  if (v < kSmemVecs)
    return cx.vec + ((size_t)v * cx.P + pl) * VS + cx.row * K;
  return cx.gv + ((size_t)(v - kSmemVecs) * cx.np + pose_of(cx, pl)) * VS +
         cx.row * K;
}

// This thread's row of vector v at the current stripe, zero where it holds
// none.
template <int R, int K, bool GRID = false>
__device__ __forceinline__ void ld_own(const Ctx& cx, int v, float (&x)[K]) {
  if (cx.own) {
    ld_row<K>(row_at<R, K, GRID>(cx, v, cx.pl), x);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = 0.f;
  }
}

template <int R, int K, bool GRID = false>
__device__ __forceinline__ void st_own(const Ctx& cx, int v,
                                       const float (&x)[K]) {
  if (cx.own) st_row<K>(row_at<R, K, GRID>(cx, v, cx.pl), x);
}

// ld_other on the grid route: the word holds the other endpoint's
// agent-wide pose index, and every vector is read from the workspace at
// L2, whichever CTA wrote it.
template <int R, int K>
__device__ __forceinline__ void ld_other_grid(const Ctx& cx, int v, int w,
                                              float (&x)[K], int prev,
                                              float beta) {
  const int VS = vs_of<R, K>(cx);
  const int at = w & kIndexMask;
  if (w & kPose) {
    auto at_pose = [&](int vec) {
      return cx.gv + ((size_t)vec * cx.np + at) * VS + cx.row * K;
    };
    if (prev < 0) {
      ld_row_l2<K>(at_pose(v), x);
    } else {
      float z[K];
      ld_row_l2<K>(at_pose(v), z);
      ld_row_l2<K>(at_pose(prev), x);
#pragma unroll
      for (int q = 0; q < K; ++q) x[q] = -z[q] + beta * x[q];
    }
  } else if (w & kSlot) {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = cx.Z[(cx.row * K + q) * cx.s + at];
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = 0.f;
  }
}

// ld_other at R = 0, the stride of the launch's rank.
template <int K>
__device__ __forceinline__ void ld_other_rt(const Ctx& cx, int v, int w,
                                            float (&x)[K], int prev,
                                            float beta) {
  const int VS = vec_stride(rank_of<0>(cx) * K);
  const int at = w & kIndexMask;
  if (w & kPose) {
    const int rank = (w >> kRankShift) & 15;
    if (v >= kSmemVecs) {
      ld_row_l2<K>(cx.gv + ((size_t)(v - kSmemVecs) * cx.np + rank * cx.P +
                            at) * VS + cx.row * K,
                   x);
      return;
    }
    auto at_owner = [&](int vec) {
      float* p = cx.vec + ((size_t)vec * cx.P + at) * VS + cx.row * K;
      return rank == cx.rank ? p : cg::this_cluster().map_shared_rank(p, rank);
    };
    if (prev < 0) {
      ld_row<K>(at_owner(v), x);
    } else {
      float z[K];
      ld_row<K>(at_owner(v), z);
      ld_row<K>(at_owner(prev), x);
#pragma unroll
      for (int q = 0; q < K; ++q) x[q] = -z[q] + beta * x[q];
    }
  } else if (w & kSlot) {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = cx.Z[(cx.row * K + q) * cx.s + at];
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = 0.f;
  }
}

// This thread's row of the other endpoint of the ELL entry with payload
// word w: a pose's shared vector v from the CTA that owns it (or, with
// prev >= 0, -v + beta prev: the next CG direction, which its owner may
// not have stored yet), its workspace vector v at L2, a neighbor slot from
// Z, else zero.
template <int R, int K, bool GRID = false>
__device__ __forceinline__ void ld_other(const Ctx& cx, int v, int w,
                                         float (&x)[K], int prev,
                                         float beta) {
  if constexpr (GRID) {
    ld_other_grid<R, K>(cx, v, w, x, prev, beta);
    return;
  }
  if constexpr (R == 0) {
    ld_other_rt<K>(cx, v, w, x, prev, beta);
    return;
  }
  constexpr int VS = vec_stride(R * K);
  const int at = w & kIndexMask;
  if (w & kPose) {
    const int rank = (w >> kRankShift) & 15;
    if (v >= kSmemVecs) {
      ld_row_l2<K>(cx.gv + ((size_t)(v - kSmemVecs) * cx.np + rank * cx.P +
                            at) * VS + cx.row * K,
                   x);
      return;
    }
    auto at_owner = [&](int vec) {
      float* p = cx.vec + ((size_t)vec * cx.P + at) * VS + cx.row * K;
      return rank == cx.rank ? p : cg::this_cluster().map_shared_rank(p, rank);
    };
    if (prev < 0) {
      ld_row<K>(at_owner(v), x);
    } else {
      float z[K];
      ld_row<K>(at_owner(v), z);
      ld_row<K>(at_owner(prev), x);
#pragma unroll
      for (int q = 0; q < K; ++q) x[q] = -z[q] + beta * x[q];
    }
  } else if (w & kSlot) {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = cx.Z[(cx.row * K + q) * cx.s + at];
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = 0.f;
  }
}

template <int K>
__device__ __forceinline__ float dot(const float (&a)[K],
                                     const float (&b)[K]) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < K; ++q) s += a[q] * b[q];
  return s;
}

// Sums of N values over the R lanes of this thread's pose, rows in order:
// every lane of the group ends with the same values.  All 32 lanes of the
// warp must call it (at R = 0 above r = 32, every thread of the CTA).
template <int R, int N>
__device__ __forceinline__ void group_sum(const Ctx& cx, float (&v)[N]) {
  if constexpr (R == 0) {
    const int r = rank_of<0>(cx);
    if (r > 32) {
      const CtxR& cr = static_cast<const CtxR&>(cx);
      wide_group_sum<N>(cr.gslots, cr.r, v);
    } else {
      float s[N];
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = __shfl_sync(kFull, v[i], cx.base);
      for (int j = 1; j < r; ++j)
#pragma unroll
        for (int i = 0; i < N; ++i)
          s[i] += __shfl_sync(kFull, v[i], cx.base + j);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = s[i];
    }
    return;
  }
  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __shfl_sync(kFull, v[i], cx.base);
#pragma unroll
  for (int j = 1; j < R; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] += __shfl_sync(kFull, v[i], cx.base + j);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = s[i];
}

template <int R, int D>
__device__ __forceinline__ void group_sym(const Ctx& cx,
                                          float (&m)[D * (D + 1) / 2],
                                          float (&sy)[D * D]) {
  group_sum<R, D * (D + 1) / 2>(cx, m);
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i) {
      sy[b * D + c] = m[i];
      sy[c * D + b] = m[i];
    }
}

template <int R, int D>
__device__ __forceinline__ void sym_ytw(const Ctx& cx, const float (&x)[D + 1],
                                        const float (&w)[D + 1],
                                        float (&sy)[D * D]) {
  float m[D * (D + 1) / 2];
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i) m[i] = 0.5f * (x[b] * w[c] + x[c] * w[b]);
  group_sym<R, D>(cx, m, sy);
}

// This row's terms of sym(Y^T W) (sym_ytw's), added to m: the fold
// kernels sum a thread's folds before the group sum.
template <int D>
__device__ __forceinline__ void add_sym(const float (&x)[D + 1],
                                        const float (&w)[D + 1],
                                        float (&m)[D * (D + 1) / 2]) {
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i)
      m[i] += 0.5f * (x[b] * w[c] + x[c] * w[b]);
}

template <int D>
__device__ __forceinline__ void sub_ysym(const float (&x)[D + 1],
                                         const float (&sy)[D * D],
                                         float (&w)[D + 1]) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += x[b] * sy[b * D + c];
    w[c] -= s;
  }
}

template <int R, int D>
__device__ __forceinline__ void tangent_project(const Ctx& cx,
                                                const float (&x)[D + 1],
                                                float (&w)[D + 1]) {
  float sy[D * D];
  sym_ytw<R, D>(cx, x, w, sy);
  sub_ysym<D>(x, sy, w);
}

// The current stripe's factor record (the identity where the thread holds
// no row).  Loaded with the stripe's other operands, before any of its
// stores, so its round trip overlaps theirs.
template <int D>
__device__ __forceinline__ void ld_factor(const Ctx& cx,
                                          float (&Lp)[l_floats(D)]) {
  constexpr int K = D + 1;
  if (cx.own) {
    ld_rec<l_floats(D)>(cx.L + (size_t)pose_of(cx, cx.pl) * l_floats(D), Lp);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int q = 0; q <= i; ++q) Lp[i * (i + 1) / 2 + q] = i == q ? 1.f : 0.f;
  }
}

// The fold kernels' block-Jacobi solve of one row with its pose's factor
// record Lp (precond's substitutions without its tangent projection; the
// diagonal holds reciprocals).  precond keeps its own copy: with precond
// calling this helper and retract_stripes calling ns_polar, the templated
// d = 2 B2 kernels' ptxas spills moved.
template <int D>
__device__ __forceinline__ void block_solve(const float (&Lp)[l_floats(D)],
                                            float (&v)[D + 1]) {
  constexpr int K = D + 1;
  float y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = v[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= Lp[i * (i + 1) / 2 + q] * y[q];
    y[i] = s * Lp[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < K; ++q) s -= Lp[q * (q + 1) / 2 + i] * v[q];
    v[i] = s * Lp[i * (i + 1) / 2 + i];
  }
}

// Tangent-projected block-Jacobi solve of this thread's row at the current
// stripe (rtr_cluster.cu's precond) with its factor record Lp.
template <int R, int D>
__device__ __forceinline__ void precond(const Ctx& cx,
                                        const float (&Lp)[l_floats(D)],
                                        const float (&x)[D + 1],
                                        float (&v)[D + 1]) {
  constexpr int K = D + 1;
  float y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = v[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= Lp[i * (i + 1) / 2 + q] * y[q];
    y[i] = s * Lp[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < K; ++q) s -= Lp[q * (q + 1) / 2 + i] * v[q];
    v[i] = s * Lp[i * (i + 1) / 2 + i];
  }
  tangent_project<R, D>(cx, x, v);
}

template <int D>
__device__ __forceinline__ void matmul3(const float (&A)[D][D],
                                        const float (&B)[D][D],
                                        float (&C)[D][D]) {
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) s += A[b][e] * B[e][c];
      C[b][c] = s;
    }
}

// The fold retraction's polar factor of a pose from its M^T M (MM,
// symmetric): Zm ends as the 24-sweep Newton-Schulz inverse square root of
// MM / s, s its trace (at least 1e-37); returns 1 / sqrt(s).  The same
// sweeps as retract_stripes' and retract_rows', which keep their own copy
// (see block_solve).
template <int D>
__device__ __forceinline__ float ns_polar(const float (&MM)[D * D],
                                          float (&Zm)[D][D]) {
  float Y[D][D], T[D][D], tmp[D][D];
  float s = 0.f;
#pragma unroll
  for (int b = 0; b < D; ++b) s += MM[b * D + b];
  s = fmaxf(s, 1e-37f);
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      Y[b][c] = MM[b * D + c] / s;
      Zm[b][c] = (b == c) ? 1.f : 0.f;
    }
  for (int it = 0; it < kNsSweeps; ++it) {
    matmul3<D>(Zm, Y, tmp);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c)
        T[b][c] = 0.5f * (((b == c) ? 3.f : 0.f) - tmp[b][c]);
    matmul3<D>(Y, T, tmp);
    matmul3<D>(T, Zm, Y);  // Y holds the new Z for a moment
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        Zm[b][c] = Y[b][c];
        Y[b][c] = tmp[b][c];
      }
  }
  return 1.f / sqrtf(s);
}

// The retraction of every stripe into kXp: rtr_cluster.cu's retract (this
// thread's row of the Newton-Schulz polar factor of Y + V_Y, translations
// added), with the same arithmetic, but the sweeps run once per pose
// rather than once per row.  For a batch of up to R stripes every lane
// adds its rows' part of each stripe's M^T M and the group sums it; lane j
// of the group keeps the batch's j-th sum and runs that stripe's sweeps;
// the group then reads each stripe's factor back from lane j by shuffles.
// Poses at or past the agent's own count keep X.  All lanes of the warp
// call it.
template <int R, int D, bool GRID = false>
__device__ void retract_stripes(Ctx& cx) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  for (int b0 = 0; b0 < cx.stripes; b0 += R) {
    float M[R][D], tr[R], mine[NM];
#pragma unroll
    for (int i = 0; i < NM; ++i) mine[i] = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (b0 + j >= cx.stripes) break;
      at_stripe(cx, b0 + j);
      float x[K], et[K], m[NM];
      ld_own<R, K, GRID>(cx, kX, x);
      ld_own<R, K, GRID>(cx, kEta, et);
#pragma unroll
      for (int c = 0; c < D; ++c) M[j][c] = x[c] + et[c];
      tr[j] = x[D] + et[D];
      int i = 0;
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = b; c < D; ++c, ++i) m[i] = M[j][b] * M[j][c];
      group_sum<R, NM>(cx, m);
      if (cx.row == j) {
#pragma unroll
        for (int q = 0; q < NM; ++q) mine[q] = m[q];
      }
    }
    float MM[D * D], Y[D][D], Zm[D][D], T[D][D], tmp[D][D];
    int i = 0;
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = b; c < D; ++c, ++i) {
        MM[b * D + c] = mine[i];
        MM[c * D + b] = mine[i];
      }
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += MM[b * D + b];
    s = fmaxf(s, 1e-37f);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        Y[b][c] = MM[b * D + c] / s;
        Zm[b][c] = (b == c) ? 1.f : 0.f;
      }
    for (int it = 0; it < kNsSweeps; ++it) {
      matmul3<D>(Zm, Y, tmp);
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c)
          T[b][c] = 0.5f * (((b == c) ? 3.f : 0.f) - tmp[b][c]);
      matmul3<D>(Y, T, tmp);
      matmul3<D>(T, Zm, Y);  // Y holds the new Z for a moment
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c) {
          Zm[b][c] = Y[b][c];
          Y[b][c] = tmp[b][c];
        }
    }
    const float inv = 1.f / sqrtf(s);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (b0 + j >= cx.stripes) break;
      float Zj[D][D];
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c)
          Zj[b][c] = __shfl_sync(kFull, Zm[b][c], cx.base + j);
      const float inv_j = __shfl_sync(kFull, inv, cx.base + j);
      at_stripe(cx, b0 + j);
      float o[K];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) acc += M[j][b] * Zj[b][c];
        o[c] = acc * inv_j;
      }
      o[D] = tr[j];
      if (pose_of(cx, cx.pl) >= cx.n_act) ld_own<R, K, GRID>(cx, kX, o);
      st_own<R, K, GRID>(cx, kXp, o);
    }
  }
}

// B2's retraction of every stripe into kXp at R = 0: rtr_cluster.cu's
// retract, each lane of the pose's group running the Newton-Schulz sweeps
// on the group's sum of M^T M and keeping its own row of the polar factor,
// translations added.  Poses at or past the agent's own count keep X.  All
// threads of the CTA call it.
template <int D, bool GRID = false>
__device__ void retract_rows(Ctx& cx) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    float x[K], et[K], M[D], m[NM], MM[D * D];
    ld_own<0, K, GRID>(cx, kX, x);
    ld_own<0, K, GRID>(cx, kEta, et);
#pragma unroll
    for (int c = 0; c < D; ++c) M[c] = x[c] + et[c];
    int i = 0;
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = b; c < D; ++c, ++i) m[i] = M[b] * M[c];
    group_sym<0, D>(cx, m, MM);
    float Y[D][D], Zm[D][D], T[D][D], tmp[D][D];
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += MM[b * D + b];
    s = fmaxf(s, 1e-37f);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        Y[b][c] = MM[b * D + c] / s;
        Zm[b][c] = (b == c) ? 1.f : 0.f;
      }
    for (int it = 0; it < kNsSweeps; ++it) {
      matmul3<D>(Zm, Y, tmp);
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c)
          T[b][c] = 0.5f * (((b == c) ? 3.f : 0.f) - tmp[b][c]);
      matmul3<D>(Y, T, tmp);
      matmul3<D>(T, Zm, Y);  // Y holds the new Z for a moment
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c) {
          Zm[b][c] = Y[b][c];
          Y[b][c] = tmp[b][c];
        }
    }
    const float inv = 1.f / sqrtf(s);
    float o[K];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b) acc += M[b] * Zm[b][c];
      o[c] = acc * inv;
    }
    o[D] = x[D] + et[D];
    if (pose_of(cx, cx.pl) < cx.n_act) {
      st_own<0, K, GRID>(cx, kXp, o);
    } else {
      st_own<0, K, GRID>(cx, kXp, x);
    }
  }
}

// One row of the refine step's D_new from the pose's E = sym(Rc^T U + U^T
// Rc + U^T U) (Ef): U + (Rc + U)(-E / 2 + 3 E^2 / 8 - 5 E^3 / 16 +
// 35 E^4 / 128), the translation U's.
template <int D>
__device__ __forceinline__ void refine_series(const float (&Ef)[D * D],
                                              const float (&rc)[D + 1],
                                              const float (&u)[D + 1],
                                              float (&o)[D + 1]) {
  float E[D][D], E2[D][D], E3[D][D], E4[D][D];
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) E[b][c] = Ef[b * D + c];
  matmul3<D>(E, E, E2);
  matmul3<D>(E2, E, E3);
  matmul3<D>(E2, E2, E4);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b)
      s += (rc[b] + u[b]) * (-0.5f * E[b][c] + 0.375f * E2[b][c] -
                             0.3125f * E3[b][c] + 0.2734375f * E4[b][c]);
    o[c] = u[c] + s;
  }
  o[D] = u[D];
}

// rtr_cluster.cu's retract_refine: this thread's row of the refine step's
// D_new (the four-term polar-correction series on U = D + V about Rc).
template <int R, int D>
__device__ void retract_refine(const Ctx& cx, const float (&rc)[D + 1],
                               const float (&dd)[D + 1],
                               const float (&v)[D + 1], float (&o)[D + 1]) {
  float u[D + 1];
#pragma unroll
  for (int q = 0; q <= D; ++q) u[q] = dd[q] + v[q];
  float m[D * (D + 1) / 2], Ef[D * D];
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i)
      m[i] = rc[b] * u[c] + u[b] * rc[c] + u[b] * u[c];
  group_sym<R, D>(cx, m, Ef);
  refine_series<D>(Ef, rc, u, o);
}

template <int NV>
__device__ __forceinline__ void warp_sum(float (&v)[NV]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
}

// The grid route's barrier over the agent's C CTAs (the launch is
// cooperative, so they are all resident).  The agent's arrival counter
// (workspace, zeroed by the launcher) only grows: a CTA arriving at the
// k-th barrier finds it between k C and (k + 1) C - 1, since no CTA can
// pass that barrier before this one arrives, and waits for (k + 1) C.  A
// CTA's writes before the barrier are published by its first thread's
// fence after the block barrier (cooperative_groups' grid sync does the
// same).  A wait past kGridWaitNs traps: a fault shows as a launch error,
// never as a hang.  Agents leave their loops after different counts, so
// no barrier spans the grid.
constexpr unsigned long long kGridWaitNs = 5000000000ull;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The agent's arrival counter: after the two reduction buffers.
__device__ __forceinline__ unsigned* grid_counter(const Ctx& cx) {
  return reinterpret_cast<unsigned*>(cx.red + 2 * cx.C * kMaxSums);
}

__device__ __forceinline__ void grid_barrier(const Ctx& cx) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* bar = grid_counter(cx);
    __threadfence();
    const unsigned old = atomicAdd(bar, 1u);
    const unsigned target = old - old % (unsigned)cx.C + (unsigned)cx.C;
    if ((int)(ld_acquire(bar) - target) < 0) {
      const unsigned long long t0 = global_ns();
      unsigned ns = 32;
      while ((int)(ld_acquire(bar) - target) < 0) {
        __nanosleep(ns);
        if (ns < 512) ns *= 2;
        if (global_ns() - t0 > kGridWaitNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// cluster_sum on the grid route: each CTA adds its warps' sums in warp
// order (shared scratch at cx.vec) into its slot of the agent's buffer of
// this parity (workspace [2][C][kMaxSums] at cx.red); after the barrier
// every warp adds the C slots, lane q the slots q, q + 32, ..., then the
// butterfly.  Every thread of the agent returns the same sums in one fixed
// order, and the two buffers let one barrier per reduction suffice.
template <int NV>
__device__ __forceinline__ void grid_sum(Ctx& cx, float (&v)[NV]) {
  warp_sum<NV>(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) cx.vec[warp * kMaxSums + i] = v[i];
  }
  __syncthreads();
  float* slots = cx.red + cx.parity * cx.C * kMaxSums;
  if (warp == 0) {
    float s[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      s[i] = lane < nw ? cx.vec[lane * kMaxSums + i] : 0.f;
    warp_sum<NV>(s);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) slots[cx.rank * kMaxSums + i] = s[i];
    }
  }
  grid_barrier(cx);
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.f;
  for (int q = lane; q < cx.C; q += 32) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __ldcg(slots + q * kMaxSums + i);
  }
  warp_sum<NV>(v);
  cx.parity ^= 1;
}

// The barrier after a phase whose workspace rows other CTAs read next.
template <bool GRID>
__device__ __forceinline__ void agent_sync(const Ctx& cx) {
  if constexpr (GRID) {
    grid_barrier(cx);
  } else {
    __threadfence();
    cg::this_cluster().sync();
  }
}

// rtr_cluster.cu's cluster_sum: every thread of the cluster returns the
// same sums of NV values, in one fixed order; the slots alternate between
// two buffers, so one cluster barrier per reduction suffices (grid_sum on
// the grid route).
template <int NV, bool GRID = false>
__device__ __forceinline__ void cluster_sum(Ctx& cx, float (&v)[NV]) {
  if constexpr (GRID) {
    grid_sum<NV>(cx, v);
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  warp_sum<NV>(v);
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int count = cx.C * nw;
  float* slots = cx.red + cx.parity * count * kMaxSums;
  if (lane < cx.C) {
    float* dst = cl.map_shared_rank(slots, lane) +
                 (cx.rank * nw + (threadIdx.x >> 5)) * kMaxSums;
#pragma unroll
    for (int i = 0; i < NV; ++i) dst[i] = v[i];
  }
  cl.sync();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.f;
  for (int q = lane; q < count; q += 32) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += slots[q * kMaxSums + i];
  }
  warp_sum<NV>(v);
  cx.parity ^= 1;
}

// rtr_cluster.cu's sweep, at the current stripe's pose: this thread's row
// summed over the pose's ELL entries in ELL order at the point given by
// vector v (GRAD: the gradient rows; COST: twice the cost, or with REFINE
// the cost increment, over the entries that own their edge).  Only
// threads that hold a row call it.
template <int R, int D, bool GRAD, bool COST, bool REFINE = false,
          bool GRID = false>
__device__ void sweep(const Ctx& cx, int v, bool with_z,
                      const float (&own)[D + 1], float (&acc)[D + 1],
                      float* cost2, int prev = -1, float beta = 0.f) {
  constexpr int K = D + 1;
  constexpr int DD = D * D;
  if (GRAD) {
#pragma unroll
    for (int q = 0; q < K; ++q) acc[q] = 0.f;
  }
  constexpr int EF = edge_floats(D);
  float f = 0.f;
  const int need = GRAD ? kLive : kCostOwner;
  const int keep = with_z ? ~0 : ~kSlot;
  // The pose's live entries in ELL order.  Words are loaded two entries
  // ahead and the other endpoint's row one ahead, so an entry waits on
  // its own record only, whose address no load decides.
  // The first two words are read whatever the count (the edge numbers
  // follow the words, so a second row is there even at Kinc = 1), so
  // their loads start with the count's.
  const int live = cx.cnt[cx.pl];
  float ov[K], nx[K] = {};
  int wa = cx.words[cx.pl] & keep;
  int wb = cx.words[cx.P + cx.pl] & keep;
  if (live < 1) wa = 0;
  if (live < 2) wb = 0;
  if (wa & need) ld_other<R, K, GRID>(cx, v, wa, nx, prev, beta);
  for (int c = 0; c < live; ++c) {
    const int at = c * cx.P + cx.pl;
    const int w = wa;
#pragma unroll
    for (int q = 0; q < K; ++q) ov[q] = nx[q];
    float rec[EF];
    if (w & need) ld_rec<EF>(cx.rec + (size_t)at * EF, rec);
    wa = wb;
    wb = c + 2 < live ? cx.words[at + 2 * cx.P] & keep : 0;
    if (wa & need) ld_other<R, K, GRID>(cx, v, wa, nx, prev, beta);
    if (!(w & need)) continue;
    const bool side_j = (w & kSideJ) != 0;
    float Rm[DD], t[D];
#pragma unroll
    for (int k = 0; k < DD; ++k) Rm[k] = rec[k];
#pragma unroll
    for (int k = 0; k < D; ++k) t[k] = rec[DD + k];
    const float wk = rec[DD + D];
    const float wt = rec[DD + D + 1];
    float vi[K], vj[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      vi[q] = side_j ? ov[q] : own[q];
      vj[q] = side_j ? own[q] : ov[q];
    }
    float rR[D];
#pragma unroll
    for (int cc = 0; cc < D; ++cc) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b) s += vi[b] * Rm[b * D + cc];
      rR[cc] = vj[cc] - s;
    }
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += vi[b] * t[b];
    const float rt = vj[D] - vi[D] - s;
    if (GRAD) {
      if (side_j) {
#pragma unroll
        for (int cc = 0; cc < D; ++cc) acc[cc] += wk * rR[cc];
        acc[D] += wt * rt;
      } else {
#pragma unroll
        for (int cc = 0; cc < D; ++cc) {
          float u = 0.f;
#pragma unroll
          for (int b = 0; b < D; ++b) u += rR[b] * Rm[cc * D + b];
          acc[cc] += -wk * u - wt * rt * t[cc];
        }
        acc[D] += -wt * rt;
      }
    }
    if (COST && (w & kCostOwner)) {
      float sR = 0.f;
#pragma unroll
      for (int cc = 0; cc < D; ++cc) sR += rR[cc] * rR[cc];
      if (REFINE) {
        // This row's reference residuals: rho_rot's row, then rho_trn.
        float rh[K];
        if constexpr (R == 0) {
          ld_row_l2<K>(
              cx.rho + ((size_t)cx.eids[at] * rank_of<0>(cx) + cx.row) * K,
              rh);
        } else {
          ld_row_l2<K>(cx.rho + ((size_t)cx.eids[at] * R + cx.row) * K, rh);
        }
        float cR = 0.f;
#pragma unroll
        for (int cc = 0; cc < D; ++cc) cR += rh[cc] * rR[cc];
        const float ct = rh[D] * rt;
        f += wk * cR + wt * ct + 0.5f * (wk * sR + wt * (rt * rt));
      } else {
        f += wk * sR + wt * (rt * rt);
      }
    }
  }
  if (COST) *cost2 += f;
}

// Carve this CTA's shared memory and its part of the agent's workspace,
// copy its poses' operands into the workspace's layout (X, or with REFINE
// the correction D into kD and Rc into kRc; the lower triangle of L with
// its diagonal replaced by reciprocals; S and g when given: B1's and B3's
// Sc and gc, B4's S0 and g0), write its
// share of the reference residuals (REFINE) and, for its poses' live ELL
// entries in ELL order, their words (rtr_cluster.cu's), edge numbers and
// edge records, then publish everything to the cluster.
// setup of the rank-generic instantiation (R = 0): r from the launch, the
// lane layout of that r (r lanes a pose up to 32, ceil(r / 32) warps a
// pose above), and the group-sum slots after the reduction slots.  FOLD:
// the fold kernels' (r > 512: 16 warps a pose, every fold's rows copied);
// its branch leaves the other kernels' text as it was.
template <int D, bool REFINE, bool FOLD = false, bool GRID = false>
__device__ CtxR setup_rt(const SpreadArgsR& g, float* smem, int a,
                         int grid_C = 0) {
  constexpr int K = D + 1;
  constexpr int DD = D * D;
  constexpr int KK = K * K;
  constexpr int LF = l_floats(D);
  constexpr int SF = s_floats(D);
  constexpr int EF = edge_floats(D);
  cg::cluster_group cl = cg::this_cluster();
  CtxR cx;
  cx.r = g.r;
  const int r = g.r;
  const int RK = r * K;
  const int VS = vec_stride(RK);
  cx.n = g.n;
  cx.s = g.s;
  cx.kinc = g.kinc;
  cx.n_act = g.n_local[a];
  if constexpr (GRID) {
    cx.C = grid_C;
    cx.rank = blockIdx.x - a * grid_C;
  } else {
    cx.C = (int)cl.num_blocks();
    cx.rank = (int)cl.block_rank();
  }
  cx.P = (g.n + cx.C - 1) / cx.C;
  cx.np = cx.C * cx.P;
  cx.parity = 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (r <= 32) {
    const int per_warp = poses_per_warp(r);
    const int group = lane / r;
    cx.row = lane - group * r;
    cx.base = group * r;
    cx.lane_ok = group < per_warp;
    cx.groups = (blockDim.x >> 5) * per_warp;
    cx.grp = warp * per_warp + group;
  } else {
    const int W = pose_warps(FOLD ? kFoldRows : r);
    cx.grp = warp / W;
    cx.row = (warp - cx.grp * W) * 32 + lane;
    cx.base = 0;
    cx.lane_ok = cx.row < r;
    cx.groups = (blockDim.x >> 5) / W;
  }
  cx.stripes = (cx.P + cx.groups - 1) / cx.groups;
  cx.Z = g.Z + (size_t)a * RK * g.s;
  cx.vec = smem;
  cx.red = smem + (size_t)kSmemVecs * cx.P * VS;  // [2][C nw][4]
  cx.gslots = cx.red + 2 * (size_t)cx.C * (blockDim.x >> 5) * kMaxSums;
  float* ws = g.ws + (size_t)a * g.ws_stride;
  if constexpr (GRID) {
    // Shared memory: the block sums [warps][kMaxSums] at cx.vec, then the
    // group-sum slots; the workspace starts with the agent's reduction
    // buffers and its arrival counter.
    cx.gslots = smem + (blockDim.x >> 5) * kMaxSums;
    cx.red = ws;
    ws += grid_head_floats(cx.C);
  }
  cx.gv = ws;
  cx.L = ws + (size_t)((REFINE ? kRefineVecs : kVecs) -
                       (GRID ? 0 : kSmemVecs)) * cx.np * VS;
  cx.S = cx.L + (size_t)LF * cx.np;
  const size_t stride = (size_t)g.kinc * cx.P;
  float* recs = cx.S + (size_t)SF * cx.np;
  cx.rec = recs + (size_t)cx.rank * stride * EF;
  cx.rho = REFINE ? recs + (size_t)cx.C * stride * EF : nullptr;
  cx.cnt = reinterpret_cast<int*>(recs + (size_t)cx.C * stride * EF +
                                  (REFINE ? (size_t)RK * g.E : 0)) +
           (size_t)cx.rank * (cx.P + 3 * stride);
  cx.words = cx.cnt + cx.P;
  cx.eids = cx.words + stride;
  int* slots = cx.eids + stride;

  if constexpr (FOLD) {
    const int row0 = cx.row;
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      const bool pose_own = cx.own;
      for (int f = 0; f < pose_folds(r); ++f) {
        cx.row = row0 + f * kFoldRows;
        cx.own = pose_own && cx.row < r;
        if (!cx.own) continue;
        const int p = pose_of(cx, cx.pl);
        const size_t comp = (size_t)a * RK + cx.row * K;
        float x[K];
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = __ldg(g.X + (comp + q) * g.n + p);
        st_own<0, K>(cx, REFINE ? kD : kX, x);
        if (REFINE) {
#pragma unroll
          for (int q = 0; q < K; ++q)
            x[q] = __ldg(g.Rc + (comp + q) * g.n + p);
          st_own<0, K>(cx, kRc, x);
        }
        if (g.S != nullptr) {
#pragma unroll
          for (int q = 0; q < K; ++q)
            x[q] = __ldg(g.g + (comp + q) * g.n + p);
          st_own<0, K>(cx, kG, x);
        }
      }
    }
    cx.row = row0;
  } else {
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      if (!cx.own) continue;
      const int p = pose_of(cx, cx.pl);
      const size_t comp = (size_t)a * RK + cx.row * K;
      float x[K];
#pragma unroll
      for (int q = 0; q < K; ++q) x[q] = __ldg(g.X + (comp + q) * g.n + p);
      st_own<0, K, GRID>(cx, REFINE ? kD : kX, x);
      if (REFINE) {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = __ldg(g.Rc + (comp + q) * g.n + p);
        st_own<0, K, GRID>(cx, kRc, x);
      }
      if (g.S != nullptr) {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = __ldg(g.g + (comp + q) * g.n + p);
        st_own<0, K, GRID>(cx, kG, x);
      }
    }
  }
  // The factors' lower triangles (diagonal reciprocals) and S0, one entry
  // a thread at a time, consecutive threads on consecutive poses.
  const int c0 = cx.rank * cx.P;
  const int np_cta = min(cx.P, g.n - c0);
  constexpr int NL = K * (K + 1) / 2;
#pragma unroll 4
  for (int t = threadIdx.x; t < NL * np_cta; t += blockDim.x) {
    const int e = t / np_cta;
    const int p = c0 + t - e * np_cta;
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    const int q = e - i * (i + 1) / 2;
    const float l = __ldg(g.L + ((size_t)a * KK + i * K + q) * g.n + p);
    cx.L[(size_t)p * LF + e] = i == q ? 1.f / l : l;
  }
  if (g.S != nullptr) {
#pragma unroll 4
    for (int t = threadIdx.x; t < DD * np_cta; t += blockDim.x) {
      const int e = t / np_cta;
      const int p = c0 + t - e * np_cta;
      cx.S[(size_t)p * SF + e] = __ldg(g.S + ((size_t)a * DD + e) * g.n + p);
    }
  }
  // The reference residuals, one (edge, row) pair a thread over the
  // agent's CTAs: one thread walking an edge's r rows would make setup grow
  // with r.
  const int nt = g.Ep / g.T;
  if (REFINE) {
    const long long pairs = (long long)g.E * r;
    for (long long t = cx.rank * blockDim.x + threadIdx.x; t < pairs;
         t += (long long)cx.C * blockDim.x) {
      const int e = (int)(t / r);
      const int row = (int)(t - (long long)e * r);
      const int tl = e / g.T;
      const int ln = e - tl * g.T;
      const size_t tile = (size_t)a * nt + tl;
      float* rh = cx.rho + (size_t)e * RK + row * K;
#pragma unroll
      for (int k = 0; k < D; ++k)
        rh[k] = g.rho_rot[(tile * (r * D) + row * D + k) * g.T + ln];
      rh[D] = g.rho_trn[(tile * r + row) * g.T + ln];
    }
  }
  // Each pose's live ELL entries, numbered in ELL order: the slot of
  // entry (c, pose) among them (-1 when it is not live), and their count.
  for (int pl = threadIdx.x; pl < cx.P; pl += blockDim.x) {
    const int pe = c0 + pl;
    int live = 0;
#pragma unroll 4
    for (int c = 0; c < g.kinc; ++c) {
      const bool on =
          pe < g.n &&
          __ldg(g.incm + ((size_t)a * g.n + min(pe, g.n - 1)) * g.kinc +
                c) != 0.f;
      slots[c * cx.P + pl] = on ? live : -1;
      live += on;
    }
    cx.cnt[pl] = live;
  }
  __syncthreads();
  // The words, edge numbers and edge records (rot, trn, wk, wt) of the
  // live entries at their slots.
#pragma unroll 4
  for (int t = threadIdx.x; t < (int)stride; t += blockDim.x) {
    const int slot = slots[t];
    if (slot < 0) continue;
    const int c = t / cx.P;
    const int pl = t - c * cx.P;
    const int pe = c0 + pl;
    const int sl = __ldg(g.inc + ((size_t)a * g.n + pe) * g.kinc + c);
    const bool side_j = sl >= g.E;
    const int e = side_j ? sl - g.E : sl;
    const size_t ge = (size_t)a * g.Ep + e;
    const int ii = __ldg(g.idx_i + ge);
    const int other = side_j ? ii : __ldg(g.idx_j + ge);
    int w = kLive | (side_j ? kSideJ : 0) |
            ((!side_j || ii >= g.n) ? kCostOwner : 0);
    if (other < g.n) {
      if constexpr (GRID) {
        w |= kPose | other;
      } else {
        const int rank = other / cx.P;
        w |= kPose | (rank << kRankShift) | (other - rank * cx.P);
      }
    } else if (other < g.n + g.s) {
      w |= kSlot | (other - g.n);
    }
    const int at = slot * cx.P + pl;
    cx.words[at] = w;
    cx.eids[at] = e;
    const int tl = e / g.T;
    const int ln = e - tl * g.T;
    const size_t tile = (size_t)a * nt + tl;
    float rec[EF] = {};
#pragma unroll
    for (int k = 0; k < DD; ++k)
      rec[k] = __ldg(g.rot + (tile * DD + k) * g.T + ln);
#pragma unroll
    for (int k = 0; k < D; ++k)
      rec[DD + k] = __ldg(g.trn + (tile * D + k) * g.T + ln);
    rec[DD + D] = __ldg(g.wk + ge);
    rec[DD + D + 1] = __ldg(g.wt + ge);
#pragma unroll
    for (int j = 0; j < EF / 4; ++j)
      reinterpret_cast<float4*>(cx.rec + (size_t)at * EF)[j] = make_float4(
          rec[4 * j], rec[4 * j + 1], rec[4 * j + 2], rec[4 * j + 3]);
  }
  if constexpr (GRID) {
    grid_barrier(cx);
  } else {
    __threadfence();  // the workspace rows other CTAs read, before the barrier
    cl.sync();
  }
  return cx;
}

template <int R, int D, bool REFINE, bool GRID = false>
__device__ CtxOf<R> setup(const ArgsOf<R>& g, float* smem, int a,
                          int grid_C = 0) {
  if constexpr (R == 0) {
    return setup_rt<D, REFINE, false, GRID>(g, smem, a, grid_C);
  } else {
    constexpr int K = D + 1;
    constexpr int RK = R * K;
    constexpr int DD = D * D;
    constexpr int KK = K * K;
    constexpr int kPerWarp = 32 / R;
    constexpr int VS = vec_stride(RK);
    constexpr int LF = l_floats(D);
    constexpr int SF = s_floats(D);
    constexpr int EF = edge_floats(D);
    cg::cluster_group cl = cg::this_cluster();
    Ctx cx;
    cx.n = g.n;
    cx.s = g.s;
    cx.kinc = g.kinc;
    cx.n_act = g.n_local[a];
    if constexpr (GRID) {
      cx.C = grid_C;
      cx.rank = blockIdx.x - a * grid_C;
    } else {
      cx.C = (int)cl.num_blocks();
      cx.rank = (int)cl.block_rank();
    }
    cx.P = (g.n + cx.C - 1) / cx.C;
    cx.np = cx.C * cx.P;
    cx.parity = 0;
    const int lane = threadIdx.x & 31;
    const int group = lane / R;
    cx.row = lane - group * R;
    cx.base = group * R;
    cx.lane_ok = group < kPerWarp;
    cx.groups = (blockDim.x >> 5) * kPerWarp;
    cx.grp = (threadIdx.x >> 5) * kPerWarp + group;
    cx.stripes = (cx.P + cx.groups - 1) / cx.groups;
    cx.Z = g.Z + (size_t)a * RK * g.s;
    cx.vec = smem;
    cx.red = smem + (size_t)kSmemVecs * cx.P * VS;  // [2][C nw][4]
    float* ws = g.ws + (size_t)a * g.ws_stride;
    if constexpr (GRID) {
      // setup_rt's grid carve.
      cx.red = ws;
      ws += grid_head_floats(cx.C);
    }
    cx.gv = ws;
    cx.L = ws + (size_t)((REFINE ? kRefineVecs : kVecs) -
                         (GRID ? 0 : kSmemVecs)) * cx.np * VS;
    cx.S = cx.L + (size_t)LF * cx.np;
    const size_t stride = (size_t)g.kinc * cx.P;
    float* recs = cx.S + (size_t)SF * cx.np;
    cx.rec = recs + (size_t)cx.rank * stride * EF;
    cx.rho = REFINE ? recs + (size_t)cx.C * stride * EF : nullptr;
    cx.cnt = reinterpret_cast<int*>(recs + (size_t)cx.C * stride * EF +
                                    (REFINE ? (size_t)RK * g.E : 0)) +
             (size_t)cx.rank * (cx.P + 3 * stride);
    cx.words = cx.cnt + cx.P;
    cx.eids = cx.words + stride;
    int* slots = cx.eids + stride;

    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      if (!cx.own) continue;
      const int p = pose_of(cx, cx.pl);
      const size_t comp = (size_t)a * RK + cx.row * K;
      float x[K];
#pragma unroll
      for (int q = 0; q < K; ++q) x[q] = __ldg(g.X + (comp + q) * g.n + p);
      st_own<R, K, GRID>(cx, REFINE ? kD : kX, x);
      if (REFINE) {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = __ldg(g.Rc + (comp + q) * g.n + p);
        st_own<R, K, GRID>(cx, kRc, x);
      }
      if (g.S != nullptr) {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = __ldg(g.g + (comp + q) * g.n + p);
        st_own<R, K, GRID>(cx, kG, x);
      }
    }
    // The factors' lower triangles (diagonal reciprocals) and S0, one entry
    // a thread at a time, consecutive threads on consecutive poses.
    const int c0 = cx.rank * cx.P;
    const int np_cta = min(cx.P, g.n - c0);
    constexpr int NL = K * (K + 1) / 2;
#pragma unroll 4
    for (int t = threadIdx.x; t < NL * np_cta; t += blockDim.x) {
      const int e = t / np_cta;
      const int p = c0 + t - e * np_cta;
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      const int q = e - i * (i + 1) / 2;
      const float l = __ldg(g.L + ((size_t)a * KK + i * K + q) * g.n + p);
      cx.L[(size_t)p * LF + e] = i == q ? 1.f / l : l;
    }
    if (g.S != nullptr) {
#pragma unroll 4
      for (int t = threadIdx.x; t < DD * np_cta; t += blockDim.x) {
        const int e = t / np_cta;
        const int p = c0 + t - e * np_cta;
        cx.S[(size_t)p * SF + e] = __ldg(g.S + ((size_t)a * DD + e) * g.n + p);
      }
    }
    // The reference residuals, one (edge, row) pair a thread (setup_rt's
    // copy).
    const int nt = g.Ep / g.T;
    if (REFINE) {
      const long long pairs = (long long)g.E * R;
      for (long long t = cx.rank * blockDim.x + threadIdx.x; t < pairs;
           t += (long long)cx.C * blockDim.x) {
        const int e = (int)(t / R);
        const int row = (int)(t - (long long)e * R);
        const int tl = e / g.T;
        const int ln = e - tl * g.T;
        const size_t tile = (size_t)a * nt + tl;
        float* rh = cx.rho + (size_t)e * RK + row * K;
#pragma unroll
        for (int k = 0; k < D; ++k)
          rh[k] = g.rho_rot[(tile * (R * D) + row * D + k) * g.T + ln];
        rh[D] = g.rho_trn[(tile * R + row) * g.T + ln];
      }
    }
    // Each pose's live ELL entries, numbered in ELL order: the slot of
    // entry (c, pose) among them (-1 when it is not live), and their count.
    for (int pl = threadIdx.x; pl < cx.P; pl += blockDim.x) {
      const int pe = c0 + pl;
      int live = 0;
#pragma unroll 4
      for (int c = 0; c < g.kinc; ++c) {
        const bool on =
            pe < g.n &&
            __ldg(g.incm + ((size_t)a * g.n + min(pe, g.n - 1)) * g.kinc +
                  c) != 0.f;
        slots[c * cx.P + pl] = on ? live : -1;
        live += on;
      }
      cx.cnt[pl] = live;
    }
    __syncthreads();
    // The words, edge numbers and edge records (rot, trn, wk, wt) of the
    // live entries at their slots.
#pragma unroll 4
    for (int t = threadIdx.x; t < (int)stride; t += blockDim.x) {
      const int slot = slots[t];
      if (slot < 0) continue;
      const int c = t / cx.P;
      const int pl = t - c * cx.P;
      const int pe = c0 + pl;
      const int sl = __ldg(g.inc + ((size_t)a * g.n + pe) * g.kinc + c);
      const bool side_j = sl >= g.E;
      const int e = side_j ? sl - g.E : sl;
      const size_t ge = (size_t)a * g.Ep + e;
      const int ii = __ldg(g.idx_i + ge);
      const int other = side_j ? ii : __ldg(g.idx_j + ge);
      int w = kLive | (side_j ? kSideJ : 0) |
              ((!side_j || ii >= g.n) ? kCostOwner : 0);
      if (other < g.n) {
        if constexpr (GRID) {
          w |= kPose | other;
        } else {
          const int rank = other / cx.P;
          w |= kPose | (rank << kRankShift) | (other - rank * cx.P);
        }
      } else if (other < g.n + g.s) {
        w |= kSlot | (other - g.n);
      }
      const int at = slot * cx.P + pl;
      cx.words[at] = w;
      cx.eids[at] = e;
      const int tl = e / g.T;
      const int ln = e - tl * g.T;
      const size_t tile = (size_t)a * nt + tl;
      float rec[EF] = {};
#pragma unroll
      for (int k = 0; k < DD; ++k)
        rec[k] = __ldg(g.rot + (tile * DD + k) * g.T + ln);
#pragma unroll
      for (int k = 0; k < D; ++k)
        rec[DD + k] = __ldg(g.trn + (tile * D + k) * g.T + ln);
      rec[DD + D] = __ldg(g.wk + ge);
      rec[DD + D + 1] = __ldg(g.wt + ge);
#pragma unroll
      for (int j = 0; j < EF / 4; ++j)
        reinterpret_cast<float4*>(cx.rec + (size_t)at * EF)[j] = make_float4(
            rec[4 * j], rec[4 * j + 1], rec[4 * j + 2], rec[4 * j + 3]);
    }
    if constexpr (GRID) {
      grid_barrier(cx);
    } else {
      // The workspace rows other CTAs read, before the barrier.
      __threadfence();
      cl.sync();
    }
    return cx;
  }
}

// rtr_cluster.cu's tcg over the stripes: Steihaug-Toint truncated CG from
// g in kG, eta and Heta left in kEta and kHeta; two cluster barriers per
// iteration, the next direction formed by the Hessian sweep of a remote
// pose from the z and delta the last barriers published.  Every thread of
// the cluster calls it.
template <int R, int D, bool GRID = false>
__device__ int tcg(Ctx& cx, float radius, int max_iters, float kappa,
                   float theta, bool* hit) {
  constexpr int K = D + 1;
  constexpr int SF = s_floats(D);
  float s2[2] = {0.f, 0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    float x[K], v[K], zz[K], Lp[l_floats(D)];
    const float zero[K] = {};
    ld_own<R, K, GRID>(cx, kX, x);
    ld_own<R, K, GRID>(cx, kG, v);
    ld_factor<D>(cx, Lp);
    st_own<R, K, GRID>(cx, kR, v);
#pragma unroll
    for (int q = 0; q < K; ++q) zz[q] = v[q];
    precond<R, D>(cx, Lp, x, zz);
    st_own<R, K, GRID>(cx, kZv, zz);
    s2[0] += dot<K>(v, zz);
    s2[1] += dot<K>(v, v);
#pragma unroll
    for (int q = 0; q < K; ++q) zz[q] = -zz[q];
    st_own<R, K, GRID>(cx, kDelta, zz);
    st_own<R, K, GRID>(cx, kEta, zero);
    st_own<R, K, GRID>(cx, kHeta, zero);
  }
  cluster_sum<2, GRID>(cx, s2);  // also publishes delta
  float rz = s2[0];
  const float r0n = sqrtf(s2[1]);
  float r0n_th;
  if (theta == 1.f) {
    r0n_th = r0n;
  } else if (theta == 0.f) {
    r0n_th = 1.f;
  } else {
    r0n_th = expf(theta * logf(fmaxf(r0n, kEps)));
  }
  const float target = r0n * fminf(kappa, r0n_th);
  const float rad2 = radius * radius;

  int k = 0;
  bool done = rz <= 0.f;
  *hit = false;
  int cur = kDelta, prev = kDeltaB;
  bool fresh = true;
  float beta = 0.f;
  while (k < max_iters && !done) {
    // Hd = P_X(EucHess[delta] - [delta_Y S | 0]) and the four dots; the
    // stripe's X, delta, eta and S are loaded before its sweep.
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      float x[K], dl[K], h[K] = {}, et[K], S[SF];
      ld_own<R, K, GRID>(cx, kX, x);
      ld_own<R, K, GRID>(cx, cur, dl);
      ld_own<R, K, GRID>(cx, kEta, et);
      if (cx.own) {
        ld_rec<SF>(cx.S + (size_t)pose_of(cx, cx.pl) * SF, S);
        if (fresh) {
          sweep<R, D, true, false, false, GRID>(cx, cur, false, dl, h,
                                                nullptr);
        } else {
          sweep<R, D, true, false, false, GRID>(cx, kZv, false, dl, h,
                                                nullptr, prev, beta);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float s = 0.f;
#pragma unroll
          for (int b = 0; b < D; ++b) s += dl[b] * S[b * D + c];
          h[c] -= s;
        }
      }
      tangent_project<R, D>(cx, x, h);
      st_own<R, K, GRID>(cx, kHd, h);
      s4[0] += dot<K>(dl, h);
      s4[1] += dot<K>(et, et);
      s4[2] += dot<K>(et, dl);
      s4[3] += dot<K>(dl, dl);
    }
    cluster_sum<4, GRID>(cx, s4);
    const float d_hd = s4[0], e_e = s4[1], e_d = s4[2], d_d = s4[3];
    const float alpha = rz / (fabsf(d_hd) < kEps ? kEps : d_hd);
    const float e_e_next = e_e + 2.f * alpha * e_d + alpha * alpha * d_d;
    const bool crossing = (d_hd <= 0.f) || (e_e_next >= rad2);
    const float disc = fmaxf(e_d * e_d + d_d * (rad2 - e_e), 0.f);
    const float tau = (-e_d + sqrtf(disc)) / (d_d < kEps ? kEps : d_d);
    const float step = crossing ? tau : alpha;

    // eta += step delta, Heta += step Hd, r += alpha Hd, z = M^-1 r; every
    // operand of the stripe is loaded before its first store.
    s2[0] = 0.f;
    s2[1] = 0.f;
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      float x[K], dl[K], h[K], et[K], he[K], v[K], zz[K], Lp[l_floats(D)];
      ld_own<R, K, GRID>(cx, kX, x);
      ld_own<R, K, GRID>(cx, cur, dl);
      ld_own<R, K, GRID>(cx, kHd, h);
      ld_own<R, K, GRID>(cx, kEta, et);
      ld_own<R, K, GRID>(cx, kHeta, he);
      ld_own<R, K, GRID>(cx, kR, v);
      ld_factor<D>(cx, Lp);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        et[q] += step * dl[q];
        he[q] += step * h[q];
        v[q] += alpha * h[q];
        zz[q] = v[q];
      }
      st_own<R, K, GRID>(cx, kEta, et);
      st_own<R, K, GRID>(cx, kHeta, he);
      st_own<R, K, GRID>(cx, kR, v);
      precond<R, D>(cx, Lp, x, zz);
      st_own<R, K, GRID>(cx, kZv, zz);
      s2[0] += dot<K>(v, zz);
      s2[1] += dot<K>(v, v);
    }
    cluster_sum<2, GRID>(cx, s2);
    const float rz_in = s2[0];
    const bool converged = sqrtf(s2[1]) <= target;
    beta = rz_in / (fabsf(rz) < kEps ? kEps : rz);
    rz = rz_in;
    ++k;
    done = crossing || converged;
    *hit = *hit || crossing;
    if (!done && k < max_iters) {
      for (int st = 0; st < cx.stripes; ++st) {
        at_stripe(cx, st);
        if (!cx.own) continue;
        float dl[K], zz[K];
        ld_own<R, K, GRID>(cx, cur, dl);
        ld_own<R, K, GRID>(cx, kZv, zz);
#pragma unroll
        for (int q = 0; q < K; ++q) dl[q] = -zz[q] + beta * dl[q];
        st_own<R, K, GRID>(cx, prev, dl);
      }
      const int t = cur;
      cur = prev;
      prev = t;
      fresh = false;
    }
  }
  return k;
}

struct Attempts {
  int k_att;
  bool accepted;
  float f_best;
  int iters;
};

// rtr_cluster.cu's attempt loop over the stripes: at most max_rejections
// attempts of {tCG, retraction into xp, cost; accept (xp written to xo)
// when rho > 0.1 and f did not rise, else radius / 4}.  Poses at or past
// the agent's own count are left untouched.
template <int R, int D, bool REFINE, bool GRID = false>
__device__ Attempts attempts(Ctx& cx, const SpreadArgs& args, float* xo,
                             float f0, int k_att, float radius,
                             int max_rejections) {
  constexpr int K = D + 1;
  constexpr int kVar = REFINE ? kD : kX;
  Attempts at{k_att, false, f0, 0};
  while (at.k_att < max_rejections && !at.accepted) {
    bool hit;
    at.iters += tcg<R, D, GRID>(cx, radius, args.max_iters, args.kappa,
                             args.theta, &hit);
    if constexpr (REFINE) {
      for (int st = 0; st < cx.stripes; ++st) {
        at_stripe(cx, st);
        float x[K], et[K], rc[K], xp[K];
        ld_own<R, K, GRID>(cx, kVar, x);
        ld_own<R, K, GRID>(cx, kEta, et);
        ld_own<R, K, GRID>(cx, kRc, rc);
        retract_refine<R, D>(cx, rc, x, et, xp);
        if (pose_of(cx, cx.pl) < cx.n_act) {
          st_own<R, K, GRID>(cx, kXp, xp);
        } else {
          st_own<R, K, GRID>(cx, kXp, x);
        }
      }
    } else if constexpr (R == 0) {
      retract_rows<D, GRID>(cx);
    } else {
      retract_stripes<R, D, GRID>(cx);
    }
    agent_sync<GRID>(cx);  // the cost reads xp across CTAs
    float s3[3] = {0.f, 0.f, 0.f};
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      if (!cx.own) continue;
      float xp[K], unused[K], gv[K], et[K], he[K];
      ld_own<R, K, GRID>(cx, kXp, xp);
      ld_own<R, K, GRID>(cx, kG, gv);
      ld_own<R, K, GRID>(cx, kEta, et);
      ld_own<R, K, GRID>(cx, kHeta, he);
      sweep<R, D, false, true, REFINE, GRID>(cx, kXp, true, xp, unused, &s3[0]);
      s3[1] += dot<K>(gv, et);
      s3[2] += dot<K>(et, he);
    }
    cluster_sum<3, GRID>(cx, s3);
    const float f_prop = (REFINE ? 1.f : 0.5f) * s3[0];
    const float mdec = -(s3[1] + 0.5f * s3[2]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      for (int st = 0; st < cx.stripes; ++st) {
        at_stripe(cx, st);
        if (!cx.own) continue;
        const int p = pose_of(cx, cx.pl);
        float xp[K];
        ld_own<R, K, GRID>(cx, kXp, xp);
#pragma unroll
        for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = xp[q];
      }
      at.f_best = f_prop;
    } else {
      radius = radius / 4.f;
    }
    ++at.k_att;
    at.accepted = ok;
  }
  return at;
}

// B2 on agent a (the body of rtr_full_spread_kernel, and at GRID of
// rtr_full_grid_kernel over grid_C CTAs an agent): the start point, then
// the attempts; stats [A, 5].
template <int R, int D, bool GRID>
__device__ __forceinline__ void rtr_full_agent(
    ArgsOf<R> args, float* smem, int a, int grid_C, float initial_radius,
    int max_rejections, float grad_tol, float* X_out, float* stats,
    int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  CtxOf<R> cx = setup<R, D, false, GRID>(args, smem, a, grid_C);
  if constexpr (R == 0) {
    // RK is 0 at R = 0: the agent's slices start at the launch's rank.
    const size_t off = (size_t)a * rank_of<0>(cx) * K * cx.n;
    X_out += off;
  }
  float* xo = X_out + (size_t)a * RK * cx.n;

  // Start point: G = egrad([X | Z]), S = sym(Y^T G_Y), g = P_X(G), f0.
  float s2[2] = {0.f, 0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    const int p = pose_of(cx, cx.pl);
    float x[K], G[K] = {};
    ld_own<R, K, GRID>(cx, kX, x);
    if (cx.own) {
      sweep<R, D, true, true, false, GRID>(cx, kX, true, x, G, &s2[1]);
#pragma unroll
      for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = x[q];
    }
    float sy[D * D];
    sym_ytw<R, D>(cx, x, G, sy);
    if (cx.own && cx.row == 0) {
#pragma unroll
      for (int i = 0; i < D * D; ++i)
        cx.S[(size_t)p * s_floats(D) + i] = sy[i];
    }
    sub_ysym<D>(x, sy, G);
    st_own<R, K, GRID>(cx, kG, G);
    s2[0] += dot<K>(G, G);
  }
  cluster_sum<2, GRID>(cx, s2);
  const float gn0 = sqrtf(s2[0]);
  const float f0 = 0.5f * s2[1];

  const Attempts at = attempts<R, D, false, GRID>(
      cx, args, xo, f0, (gn0 < grad_tol) ? max_rejections : 0,
      initial_radius, max_rejections);
  if (cx.rank == 0 && threadIdx.x == 0) {
    float* st = stats + (size_t)a * 5;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    st[4] = gn0;
    tcg_iters[a] = at.iters;
  }
}

// B4 on agent a (the body of rtr_refine_full_spread_kernel, and at GRID of
// rtr_refine_full_grid_kernel): args.X is the correction D, args.Z its
// neighbor slots Dz, args.S and args.g the constants S0 and g0.
template <int R, int D, bool GRID>
__device__ __forceinline__ void refine_agent(
    ArgsOf<R> args, float* smem, int a, int grid_C, float initial_radius,
    int max_rejections, float grad_tol, float* D_out, float* stats,
    int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  constexpr int DD = D * D;
  CtxOf<R> cx = setup<R, D, true, GRID>(args, smem, a, grid_C);
  if constexpr (R == 0) {
    // RK is 0 at R = 0: the agent's slices start at the launch's rank.
    const size_t off = (size_t)a * rank_of<0>(cx) * K * cx.n;
    D_out += off;
    args.Gref += off;
  }
  float* xo = D_out + (size_t)a * RK * cx.n;

  // rtr_cluster.cu's re-centered start: dG and the cost increment at D in
  // one sweep; Y = Rc + D into kX, S = S0 + S1 and the re-centered
  // gradient into kG, |g|^2 and |precond(g)|^2.
  float s3[3] = {0.f, 0.f, 0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    const int p = pose_of(cx, cx.pl);
    float dd[K], rc[K], y[K], G[K] = {}, gr[K] = {}, gv[K], S0[DD] = {},
        Lp[l_floats(D)];
    ld_own<R, K, GRID>(cx, kD, dd);
    ld_own<R, K, GRID>(cx, kRc, rc);
    ld_own<R, K, GRID>(cx, kG, gv);  // g0
    ld_factor<D>(cx, Lp);
    if (cx.own) {
      const size_t comp = (size_t)a * RK + cx.row * K;
#pragma unroll
      for (int q = 0; q < K; ++q) gr[q] = args.Gref[(comp + q) * cx.n + p];
#pragma unroll
      for (int j = 0; j < DD; ++j) S0[j] = cx.S[(size_t)p * s_floats(D) + j];
    }
#pragma unroll
    for (int q = 0; q < K; ++q) y[q] = rc[q] + dd[q];
    st_own<R, K, GRID>(cx, kX, y);
    if (cx.own) {
      sweep<R, D, true, true, true, GRID>(cx, kD, true, dd, G, &s3[2]);
#pragma unroll
      for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = dd[q];
    }
    float m[D * (D + 1) / 2], S1[DD], St[DD];
    int i = 0;
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = b; c < D; ++c, ++i)
        m[i] = 0.5f * (dd[b] * gr[c] + dd[c] * gr[b] + y[b] * G[c] +
                       y[c] * G[b]);
    group_sym<R, D>(cx, m, S1);
#pragma unroll
    for (int j = 0; j < DD; ++j) St[j] = S0[j] + S1[j];
    // Every row has read S0 before row 0 overwrites it (a pose spans
    // warps at R = 0 above r = 32).
    if constexpr (R == 0) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    if (cx.own && cx.row == 0) {
#pragma unroll
      for (int j = 0; j < DD; ++j) cx.S[(size_t)p * s_floats(D) + j] = St[j];
    }
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b)
        s += rc[b] * S1[b * D + c] + dd[b] * St[b * D + c];
      gv[c] = gv[c] + G[c] - s;
    }
    gv[D] = gv[D] + G[D];
    st_own<R, K, GRID>(cx, kG, gv);
    s3[0] += dot<K>(gv, gv);
    precond<R, D>(cx, Lp, y, gv);
    s3[1] += dot<K>(gv, gv);
  }
  cluster_sum<3, GRID>(cx, s3);  // also publishes S to the pose's rows
  const float gn0 = sqrtf(s3[0]);
  const float radius = fminf(initial_radius, 10.f * sqrtf(s3[1]));
  const float f0 = s3[2];

  const Attempts at = attempts<R, D, true, GRID>(
      cx, args, xo, f0, (gn0 < grad_tol) ? max_rejections : 0, radius,
      max_rejections);
  if (cx.rank == 0 && threadIdx.x == 0) {
    float* st = stats + (size_t)a * 5;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    st[4] = gn0;
    tcg_iters[a] = at.iters;
  }
}

// The launchers' arguments from the entry points' (rtr_spread.cu's and
// rtr_grid.cu's).
SpreadArgs make_args(int n, int s, int Ep, int T, int E, int kinc,
                     const void* idx_i, const void* idx_j, const void* rot,
                     const void* trn, const void* wk, const void* wt,
                     const void* X, const void* Z, const void* S,
                     const void* L, const void* g, const void* inc_slot,
                     const void* inc_mask, const void* n_local, void* ws,
                     long long ws_stride, int max_iters, float kappa,
                     float theta) {
  SpreadArgs a{};
  a.n = n;
  a.s = s;
  a.Ep = Ep;
  a.T = T;
  a.E = E;
  a.kinc = kinc;
  a.idx_i = static_cast<const int*>(idx_i);
  a.idx_j = static_cast<const int*>(idx_j);
  a.rot = static_cast<const float*>(rot);
  a.trn = static_cast<const float*>(trn);
  a.wk = static_cast<const float*>(wk);
  a.wt = static_cast<const float*>(wt);
  a.X = static_cast<const float*>(X);
  a.Z = static_cast<const float*>(Z);
  a.L = static_cast<const float*>(L);
  a.S = static_cast<const float*>(S);
  a.g = static_cast<const float*>(g);
  a.inc = static_cast<const int*>(inc_slot);
  a.incm = static_cast<const float*>(inc_mask);
  a.n_local = static_cast<const int*>(n_local);
  a.ws = static_cast<float*>(ws);
  a.ws_stride = ws_stride;
  a.max_iters = max_iters;
  a.kappa = kappa;
  a.theta = theta;
  return a;
}

}  // namespace
}  // namespace dpgo_spread

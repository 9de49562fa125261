// Fused single-step Riemannian trust-region solve of RBCD on Hopper
// thread-block clusters: one cluster per agent.
//
// Replaces the TPU kernels of dpgo_tpu/ops/pallas_tcg.py:
//   * _rtr_full_kernel (rtr_full_call) -> rtr_full_cluster_kernel below:
//     one launch is the whole local solve of every agent for one RBCD
//     round (start-point gradient, S = sym(Y^T G_Y), gn0, the early exit,
//     then at most max_rejections attempts of {truncated CG, 24-sweep
//     Newton-Schulz retraction, cost, accept or radius / 4}).
//   * _rtr_kernel (rtr_call) -> rtr_cluster_kernel below: the attempt loop
//     alone from a given S and Riemannian gradient g (no early exit).
//   * _tcg_kernel (tcg_call) -> tcg_cluster_kernel below: the truncated CG
//     alone from a given S, g and radius per agent.
//   * _rtr_refine_full_kernel (rtr_refine_full_call) ->
//     rtr_refine_full_cluster_kernel below: the re-centered step of the
//     terminal refinement on the correction D about an f64 host reference
//     Rc (expansion point Y = Rc + D): the increment gradient dG at
//     [D | Dz], S = S0 + sym(D_Y^T Gref_Y + Y_Y^T dG_Y), g = g0 + dG with
//     g_Y -= Rc_Y S1 + D_Y S, the radius min(r0, 10 |precond(g)|), then
//     the attempts with the cost increment against the reference residuals
//     rho and the four-term polar-correction retraction.
// The functions are those of rtr_full.cu's kernels, which stay as the
// workspace route for agents too large for any cluster
// (ops/rtr_kernel.cluster_plan picks the route from the shape before the
// launch).  The four kernels share one core: setup, sweep, tcg,
// cluster_sum and attempts (whose mode picks the plain step or the refine
// step's retraction and cost).
//
// What bounds it on this card: neither bytes (~2 MB per launch) nor
// operations (~60 MFLOP): both bounds are under 1 us.  The time is the
// length of the dependency chain of the tCG iterations, each a Hessian
// sweep, two reductions over the agent and three updates of its vectors,
// run by threads that have too few neighbours on their SM to hide their
// latencies.
//
// What the design does about it:
//   * Grid: A clusters of C CTAs (cluster dims (C, 1, 1), cudaLaunchKernelEx).
//     CTA c of a cluster owns the poses [c P, (c + 1) P) of its agent,
//     P = ceil(n_max / C), so the agent spreads over C SMs.
//   * A group of R lanes owns one pose, one row of its r x (d+1) block
//     each (32 / R poses per warp): every per-pose phase runs in one pass,
//     each thread's chain is a row's, and a CTA has ~R times the warps of
//     one thread per pose.  The rows meet only in the tangent projection
//     (sym(Y^T W)) and the retraction (M^T M): sums of the d(d+1)/2
//     entries of a symmetric d x d matrix over the group's lanes by
//     shuffles, in a fixed order that every lane of the group shares.
//   * The rank-generic instantiation (R = 0, r >= 11; shapes.cuh) reads r
//     from the launch and keeps that layout up to r = 32 (at r = 17..31 a
//     warp holds one pose and leaves 32 - r lanes idle).  Above 32 a pose
//     takes ceil(r / 32) whole warps, row q on lane q % 32 of its
//     (q / 32)-th warp, so a thread still holds one row of d + 1 floats;
//     its group sums are warp butterflies met in shared slots after a
//     block barrier (lanes.cuh's wide_group_sum), which every group sum's
//     callers reach together (all threads of the CTA call them).  A CTA of
//     kMaxThreads holds a pose of at most 16 warps: this route ends at
//     r = 512, and its launchers refuse a higher rank (rtr_spread.cu's fold
//     kernels take B1-B4 above it).
//   * B2 and B4 at 11 <= r <= 32 also have a folded layout
//     (rtr_full_cluster_fold_kernel<L, d>, rtr_refine_full_cluster_fold_
//     kernel<L, d>; the section at the end, built in parts of its own): a
//     pose on an aligned segment of L in {8, 16} lanes, ceil(r / L) rows a
//     lane, 32 / L poses a warp, its group sums log2 L butterfly steps
//     (lanes.cuh's segment_sum).  ops/rtr_kernel.cluster_plan picks the
//     layout by a rule measured on the card.
//   * State on chip: every loop vector (eta, Heta, r, z, delta, Hd, g, the
//     proposal xp) and the operands read only (X, L, S) live in the owning
//     CTA's shared memory for the whole launch; nothing of the tCG loop
//     goes through device memory.  delta and z (read by the Hessian), X
//     (by the start-point gradient) and xp (by the cost) of a pose another
//     CTA owns are read through distributed shared memory.  Neighbor-slot
//     poses Z are read from device memory (once per cost).
//   * Edge payload: at launch start each CTA gathers the payload of its
//     poses' ELL entries into shared memory in ELL order, [field][Kinc][P]
//     (where the other endpoint lives, with flags; rot, trn, wk, wt), with
//     cp.async, together with its poses' X, L (and S, g), then waits once.
//   * Pose-centric sweeps: for the Hessian-vector product and the gradient
//     each thread walks its pose's ELL entries in ELL order, computes its
//     row of that endpoint's part of the edge from the payload and both
//     endpoints' rows, and adds it in: no per-edge scratch rows, no
//     barrier between an edge pass and a gather, no dependent incidence ->
//     row loads, and the next entry's row is loaded while this one is
//     added.  Each edge's arithmetic runs once per endpoint.
//   * Cost: an ELL entry counts its edge when its pose is the edge's i
//     endpoint, or its j endpoint while i is a neighbor slot, so each live
//     edge counts once, in a fixed order (ops/rtr_kernel.cost_owner).  The
//     refine kernel's payload adds, at the cost-owner entries, the edge's
//     reference residuals (rho_rot rows, then rho_trn), r (d+1) fields:
//     each thread reads the d + 1 of its own row.
//   * Reductions: warp butterfly; each warp stores its partial into every
//     CTA of the cluster through distributed shared memory; cluster.sync();
//     then every warp reads all the partials from its own shared memory (a
//     lane each) and adds them by a second butterfly: every loop condition
//     is the same in every thread of the cluster.  The partial slots are
//     double-buffered, so one cluster barrier per reduction suffices.
//   * Two cluster barriers per tCG iteration (Hd and four dots; the
//     eta/Heta/r/z update and two dots): the next direction delta is
//     double-buffered, and a Hessian sweep computes a remote pose's delta
//     from the z and delta the last barriers published (see tcg), so the
//     delta update needs no barrier of its own.
//   * The block-Jacobi solves multiply by reciprocals of the factors'
//     diagonals, taken once at setup.
//   * No atomics and a fixed order for every sum: launches repeat bit for
//     bit.  No tensor cores: the products are d x d and 1 x d per row.
//   * A CTA never leaves while another may still read its shared memory:
//     the kernels end with cluster.sync().
//
// Layout (matches rtr_full.cu and models/rbcd.build_graph):
//   idx_i, idx_j  [A, nt, 1, T] int32 into the [n + s] pose buffer (n + s
//                 is padding); rot [A, nt, D*D, T], trn [A, nt, D, T],
//                 wk, wt [A, nt, 1, T] f32
//   X [A, RK, n], Z [A, RK, s], L [A, K*K, n]; S [A, D*D, n] and
//   g [A, RK, n] (rtr, tcg; S0 and g0 in refine); inc_slot / inc_mask
//   [A, n, Kinc]: ELL incidence into [gi (E) | gj (E)]
//   refine: X is D and Z is Dz; Rc, Gref [A, RK, n]; rho_rot
//   [A, nt, R*D, T] (component a*D + c), rho_trn [A, nt, R, T]

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lanes.cuh"
#include "shapes.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace dpgo_cluster {
namespace {

// Threads per CTA (ops/rtr_kernel.MAX_CLUSTER_THREADS); values a
// reduction slot holds.
constexpr int kMaxThreads = 512;
constexpr int kMaxSums = 4;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;  // the card's largest (non-portable) size
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-30f;
constexpr int kNsSweeps = 24;
// Shared-memory vectors, each [P][vec_stride(RK)], a pose's rows in order.
// delta alternates between two buffers (see tcg).  The refine kernel adds
// the correction D and the reference Rc; its kX holds Y = Rc + D.
enum Vec {
  kX, kXp, kDelta, kDeltaB, kG, kEta, kHeta, kR, kZv, kHd, kVecs,
  kD = kVecs, kRc, kRefineVecs
};
// An ELL entry's first payload word says where the other endpoint's values
// are (a pose: the rank of its CTA and its slot there; a neighbor slot:
// its index into Z; neither: zero) and carries three flags.
constexpr int kIndexMask = (1 << 20) - 1;
constexpr int kRankShift = 20;  // 4 bits: cluster ranks below 16
constexpr int kPose = 1 << 24;
constexpr int kSlot = 1 << 25;
constexpr int kLive = 1 << 26;
constexpr int kCostOwner = 1 << 27;
constexpr int kSideJ = 1 << 28;  // the pose is the edge's j endpoint
// Launcher errors: the card cannot place one cluster of this size; more
// neighbor slots than a payload word can index; a kernel number that is not
// one of Kernel.
constexpr int kUnplaceable = -2;
constexpr int kTooManySlots = -3;
constexpr int kUnknownKernel = -4;

// Floats per pose in a shared vector: RK padded to whole float4s (a row
// of K = 4 is one float4) and to an odd count of them, which spreads a
// warp's poses over the banks.
__host__ __device__ constexpr int vec_stride(int rk) {
  return ((rk + 3) / 4) % 2 ? (rk + 3) / 4 * 4 : (rk + 3) / 4 * 4 + 4;
}

// Per-entry payload fields: the word, rot (D*D), trn (D), wk, wt; the
// refine kernel's reference residuals follow (refine_fields).
__host__ __device__ constexpr int payload_fields(int d) {
  return d * d + d + 3;
}

__host__ __device__ constexpr int refine_fields(int r, int d) {
  return r * (d + 1);
}

// The kernels, as the launchers and the host plan number them.
enum Kernel { kRtrFull = 0, kRtr = 1, kTcg = 2, kRefine = 3 };

struct ClusterShape {
  int P, threads;
  size_t smem;
};

// The one formula for the cluster kernels' shape (cluster_plan mirrors it):
// 32 / r poses per warp (ceil(r / 32) warps per pose above r = 32);
// vectors, then L [K*K][P], S [D*D][P], the payload [F][Kinc][P], the
// double-buffered reduction slots [2][C * warps][4] and, above r = 32, the
// group-sum slots [warps][kGroupSums].  B1-B3 share it; B4 adds two vectors
// (D, Rc) and the rho fields.
ClusterShape cluster_shape(int r, int d, int n, int kinc, int C,
                           bool refine) {
  const int P = (n + C - 1) / C;
  const int per_warp = poses_per_warp(r);
  const int threads = (P + per_warp - 1) / per_warp * 32 * pose_warps(r);
  const int k = d + 1;
  const int vecs = refine ? kRefineVecs : kVecs;
  const int fields = payload_fields(d) + (refine ? refine_fields(r, d) : 0);
  const size_t floats = (size_t)vecs * P * vec_stride(r * k) +
                        (size_t)(k * k + d * d) * P +
                        (size_t)fields * kinc * P +
                        2 * (size_t)C * (threads / 32) * kMaxSums +
                        group_slots(r, threads / 32);
  return {P, threads, floats * sizeof(float)};
}

// The folded lane layout of B2 and B4 at kMinGenericRank <= r <=
// kFoldMaxRank (fold_shape; rtr_kernel.cluster_fold_shape mirrors it): a
// pose on an aligned segment of L lanes, 32 / L poses a warp, the same
// shared arrays as cluster_shape and no group-sum slots.
constexpr int kFoldMaxRank = 32;
constexpr size_t kMaxSmemBytes = 232448;

ClusterShape fold_shape(int r, int d, int n, int kinc, int C, int L,
                        bool refine) {
  const int P = (n + C - 1) / C;
  const int per_warp = 32 / L;
  const int threads = (P + per_warp - 1) / per_warp * 32;
  const int k = d + 1;
  const int vecs = refine ? kRefineVecs : kVecs;
  const int fields = payload_fields(d) + (refine ? refine_fields(r, d) : 0);
  const size_t floats = (size_t)vecs * P * vec_stride(r * k) +
                        (size_t)(k * k + d * d) * P +
                        (size_t)fields * kinc * P +
                        2 * (size_t)C * (threads / 32) * kMaxSums;
  return {P, threads, floats * sizeof(float)};
}

// The build part of the folded layout at L lanes a segment: the parts
// after the generic one (ops/rtr_kernel.FOLD_PARTS), one per L.
constexpr int fold_part(int L) { return DPGO_PARTS + (L == 8 ? 1 : 2); }

}  // namespace

// The launchers' arguments: a type every translation unit of this source
// shares (see shapes.cuh).
struct ClusterArgs {
  int n, s, Ep, T, E, kinc;
  const int* idx_i;
  const int* idx_j;
  const float* rot;
  const float* trn;
  const float* wk;
  const float* wt;
  const float* X;
  const float* Z;
  const float* L;
  const float* S;  // rtr, tcg; S0 in refine; else nullptr
  const float* g;  // rtr, tcg; g0 in refine; else nullptr
  const float* Rc;       // refine only, else nullptr
  const float* Gref;     // refine only
  const float* rho_rot;  // refine only
  const float* rho_trn;  // refine only
  const int* inc;
  const float* incm;
  const int* n_local;
  int max_iters;
  float kappa, theta;
};

// The arguments of the rank-generic instantiation (R = 0): the rank too.
// The templated shapes keep ClusterArgs, so their kernels compile as they
// did before R = 0 existed.
struct ClusterArgsR : ClusterArgs {
  int r;
};

template <int R>
using ArgsOf = std::conditional_t<R == 0, ClusterArgsR, ClusterArgs>;

namespace {

// One thread's view of its agent: the cluster's shape, this thread's pose
// slot and row, and the carved shared memory of its CTA.
struct Ctx {
  int n, s, kinc, n_act, P, C, rank, parity;
  int pl;           // the pose's slot in this CTA
  int row;          // this thread's row of the pose's block
  int base;         // the lane of row 0 of the pose
  bool own;         // this thread holds a row (slot < P, pose < n)
  const float* Z;   // [RK, s] neighbor slots, device memory
  float* vec;       // [kVecs][P][RKS]
  float* L;         // [K*K][P]
  float* S;         // [D*D][P]
  float* pay;       // [F][Kinc][P]
  float* red;       // [2][C * warps][kMaxSums]
};

// The context of the rank-generic instantiation (R = 0): the launch's rank
// and the group-sum slots of a pose that spans warps.  Helpers take a Ctx
// and read these through rank_of and wide_group_sum at R = 0 only.
struct CtxR : Ctx {
  int r;
  float* gslots;  // [warps][kGroupSums] (r > 32)
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

template <int K>
__device__ __forceinline__ void st_row(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) p[q] = v[q];
  }
}

// Row `row` of pose slot pl of vector v in this CTA's shared memory.
template <int R, int K>
__device__ __forceinline__ float* row_at(const Ctx& cx, int v, int pl) {
  if constexpr (R == 0) {
    return cx.vec + ((size_t)v * cx.P + pl) * vec_stride(rank_of<0>(cx) * K) +
           cx.row * K;
  } else {
    return cx.vec + ((size_t)v * cx.P + pl) * vec_stride(R * K) + cx.row * K;
  }
}

// This thread's row of vector v, zero where it holds none.
template <int R, int K>
__device__ __forceinline__ void ld_own(const Ctx& cx, int v, float (&x)[K]) {
  if (cx.own) {
    ld_row<K>(row_at<R, K>(cx, v, cx.pl), x);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = 0.f;
  }
}

template <int R, int K>
__device__ __forceinline__ void st_own(const Ctx& cx, int v,
                                       const float (&x)[K]) {
  if (cx.own) st_row<K>(row_at<R, K>(cx, v, cx.pl), x);
}

// This thread's row of the other endpoint of the ELL entry with payload
// word w: a pose's vector v from the shared memory of the CTA that owns it
// (or, with prev >= 0, -v + beta prev: the next CG direction, which its
// owner may not have stored yet), a neighbor slot from Z, else zero.
template <int R, int K>
__device__ __forceinline__ void ld_other(const Ctx& cx, int v, int w,
                                         float (&x)[K], int prev,
                                         float beta) {
  const int at = w & kIndexMask;
  if (w & kPose) {
    const int rank = (w >> kRankShift) & 15;
    auto at_owner = [&](int vec) {
      float* p = row_at<R, K>(cx, vec, at);
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

// The D(D+1)/2 entries b <= c of a symmetric D x D matrix, summed over
// the pose's rows, into the full row-major matrix.
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

// sym(Y^T W) of this thread's pose from its row of Y (x) and of W (w),
// row-major [D][D]; all lanes of the warp call it.
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

// This thread's row of W_Y - Y sym(Y^T W_Y) given sym(Y^T W_Y).
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

// W <- P_Y(W): W_Y - Y sym(Y^T W_Y), translation unchanged.
template <int R, int D>
__device__ __forceinline__ void tangent_project(const Ctx& cx,
                                                const float (&x)[D + 1],
                                                float (&w)[D + 1]) {
  float sy[D * D];
  sym_ytw<R, D>(cx, x, w, sy);
  sub_ysym<D>(x, sy, w);
}

// Tangent-projected block-Jacobi solve of this thread's row: the row solves
// the (D+1)x(D+1) SPD block from its lower Cholesky factor (its diagonal
// replaced by reciprocals at setup).
template <int R, int D>
__device__ __forceinline__ void precond(const Ctx& cx, const float (&x)[D + 1],
                                        float (&v)[D + 1]) {
  constexpr int K = D + 1;
  float Lp[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i)
    Lp[i] = cx.own ? cx.L[i * cx.P + cx.pl] : (i % (K + 1) == 0 ? 1.f : 0.f);
  float y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = v[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= Lp[i * K + q] * y[q];
    y[i] = s * Lp[i * K + i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < K; ++q) s -= Lp[q * K + i] * v[q];
    v[i] = s * Lp[i * K + i];
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

// This thread's row of R_X(V): the Newton-Schulz polar factor of
// (Y + V_Y), translations added.  M^T M is summed over the pose's rows;
// every lane of the group then runs the same sweeps.  All lanes of the
// warp call it.
template <int R, int D>
__device__ void retract(const Ctx& cx, const float (&x)[D + 1],
                        const float (&v)[D + 1], float (&o)[D + 1]) {
  float M[D];
#pragma unroll
  for (int c = 0; c < D; ++c) M[c] = x[c] + v[c];
  float m[D * (D + 1) / 2], MM[D * D];
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i) m[i] = M[b] * M[c];
  group_sym<R, D>(cx, m, MM);
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
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) acc += M[b] * Zm[b][c];
    o[c] = acc * inv;
  }
  o[D] = x[D] + v[D];
}

// This thread's row of the refine step's D_new, with Rc + D_new =
// polar(Rc + D + V), from the small quantities only
// (pallas_tcg._build_math.retract_refine): U = D + V, E = Rc^T U + U^T Rc
// + U^T U (symmetric as it stands; Rc^T Rc = I, projected in float64 on
// the host) summed over the pose's rows, C = -E/2 + 3/8 E^2 - 5/16 E^3 +
// 35/128 E^4 ~ (I + E)^(-1/2) - I, D_new_Y = U_Y + (Rc_Y + U_Y) C,
// D_new_t = U_t.  All lanes of the warp call it.
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

// Butterfly sums over the warp: every lane ends with the same values.
template <int NV>
__device__ __forceinline__ void warp_sum(float (&v)[NV]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
}

// Cluster-wide sums of NV values.  Every thread of the cluster returns the
// same values: each warp's butterfly sum is stored, by lane q, into slot
// (rank, warp) of CTA q's shared memory, so every CTA holds all the
// partials of the cluster after the barrier; lane q of every warp then
// adds the local slots q, q + 32, ... (rank-major) and a second butterfly
// adds the lanes.  Every warp runs the same sums on the same operands in
// the same order.  The slots alternate between two buffers, so a
// reduction's slots are written only after every reader of the previous
// reduction into them has passed a later barrier.
template <int NV>
__device__ __forceinline__ void cluster_sum(Ctx& cx, float (&v)[NV]) {
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

// This thread's row of its pose summed over the pose's ELL entries, in
// ELL order, at the point given by vector v (the agent's poses, or -v +
// beta prev with prev >= 0; neighbor slots from cx.Z when with_z, else
// zero, as in a Hessian sweep):
//   GRAD: acc = the pose's endpoint rows of its edges' gradient (the
//         formula of rtr_full.cu's grad_sweep);
//   COST: *cost2 += sum over the entries that own their edge of
//         wk |rR|^2 + wt |rt|^2 of this row (twice the cost), or with
//         REFINE wk (<rhoR, rR> + |rR|^2 / 2) + wt (rhot rt + rt^2 / 2)
//         against the row's reference residuals (the cost increment,
//         rtr_full.cu's refine_cost).
// Only threads that hold a row call it.
template <int R, int D, bool GRAD, bool COST, bool REFINE = false>
__device__ void sweep(const Ctx& cx, int v, bool with_z,
                      const float (&own)[D + 1], float (&acc)[D + 1],
                      float* cost2, int prev = -1, float beta = 0.f) {
  constexpr int K = D + 1;
  constexpr int DD = D * D;
  if (GRAD) {
#pragma unroll
    for (int q = 0; q < K; ++q) acc[q] = 0.f;
  }
  float f = 0.f;
  const int stride = cx.kinc * cx.P;
  const int* words = reinterpret_cast<const int*>(cx.pay);
  // The entries this sweep adds, and the neighbor slots it reads (a
  // Hessian sweep holds them at zero).
  const int need = GRAD ? kLive : kCostOwner;
  const int keep = with_z ? ~0 : ~kSlot;
  // The next entry's other endpoint is loaded before this one is added,
  // so a load's latency overlaps the arithmetic of the entry before it.
  float ov[K], nx[K] = {};
  int wn = words[cx.pl] & keep;
  if (wn & need) ld_other<R, K>(cx, v, wn, nx, prev, beta);
  for (int c = 0; c < cx.kinc; ++c) {
    const int at = c * cx.P + cx.pl;
    const int w = wn;
#pragma unroll
    for (int q = 0; q < K; ++q) ov[q] = nx[q];
    wn = c + 1 < cx.kinc ? words[at + cx.P] & keep : 0;
    if (wn & need) ld_other<R, K>(cx, v, wn, nx, prev, beta);
    if (!(w & need)) continue;
    const bool side_j = (w & kSideJ) != 0;
    float Rm[DD], t[D];
#pragma unroll
    for (int k = 0; k < DD; ++k) Rm[k] = cx.pay[(1 + k) * stride + at];
#pragma unroll
    for (int k = 0; k < D; ++k) t[k] = cx.pay[(1 + DD + k) * stride + at];
    const float wk = cx.pay[(1 + DD + D) * stride + at];
    const float wt = cx.pay[(2 + DD + D) * stride + at];
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
        const int rho = payload_fields(D) + cx.row * D;
        float cR = 0.f;
#pragma unroll
        for (int cc = 0; cc < D; ++cc)
          cR += cx.pay[(rho + cc) * stride + at] * rR[cc];
        if constexpr (R == 0) {
          const float ct =
              cx.pay[(payload_fields(D) + rank_of<0>(cx) * D + cx.row) *
                         stride +
                     at] *
              rt;
          f += wk * cR + wt * ct + 0.5f * (wk * sR + wt * (rt * rt));
        } else {
          const float ct =
              cx.pay[(payload_fields(D) + R * D + cx.row) * stride + at] * rt;
          f += wk * cR + wt * ct + 0.5f * (wk * sR + wt * (rt * rt));
        }
      } else {
        f += wk * sR + wt * (rt * rt);
      }
    }
  }
  if (COST) *cost2 += f;
}

// No "memory" clobber: the copies only write shared memory that nothing
// reads before cp_async_wait_all (which has one), so the loads that feed
// later copies may start ahead of earlier ones.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Carve this CTA's shared memory, gather its poses' operands and the
// payload of their ELL entries with cp.async, wait, and make everything
// visible to the cluster.  REFINE: X (the correction D) lands in kD, Rc in
// kRc, and the cost-owner entries carry the reference residuals.
// setup of the rank-generic instantiation (R = 0): r from the launch, the
// lane layout of rank_of's r (r lanes a pose up to 32, ceil(r / 32) warps a
// pose above), and the group-sum slots after the reduction slots.
template <int D, bool REFINE>
__device__ CtxR setup_rt(const ClusterArgsR& g, float* smem, int a) {
  constexpr int K = D + 1;
  constexpr int DD = D * D;
  constexpr int KK = K * K;
  constexpr int F0 = payload_fields(D);
  cg::cluster_group cl = cg::this_cluster();
  CtxR cx;
  cx.r = g.r;
  const int r = g.r;
  const int RK = r * K;
  const int F = F0 + (REFINE ? refine_fields(r, D) : 0);
  cx.n = g.n;
  cx.s = g.s;
  cx.kinc = g.kinc;
  cx.n_act = g.n_local[a];
  cx.C = (int)cl.num_blocks();
  cx.rank = (int)cl.block_rank();
  cx.P = (g.n + cx.C - 1) / cx.C;
  cx.parity = 0;
  const int lane = threadIdx.x & 31;
  bool lane_ok;  // the lane holds a row of a pose group
  const int warp = threadIdx.x >> 5;
  if (r <= 32) {
    const int group = lane / r;
    cx.row = lane - group * r;
    cx.base = group * r;
    cx.pl = warp * poses_per_warp(r) + group;
    lane_ok = group < poses_per_warp(r);
  } else {
    const int W = pose_warps(r);
    cx.pl = warp / W;
    cx.row = (warp - cx.pl * W) * 32 + lane;
    cx.base = 0;
    lane_ok = cx.row < r;
  }
  const int c0 = cx.rank * cx.P;
  const int p = c0 + cx.pl;
  cx.own = lane_ok && cx.pl < cx.P && p < g.n;
  cx.Z = g.Z + (size_t)a * RK * g.s;
  cx.vec = smem;
  cx.L = cx.vec + (size_t)(REFINE ? kRefineVecs : kVecs) * cx.P *
                      vec_stride(RK);
  cx.S = cx.L + (size_t)KK * cx.P;
  cx.pay = cx.S + (size_t)DD * cx.P;
  cx.red = cx.pay + (size_t)F * g.kinc * cx.P;  // [2][C nw][4]
  cx.gslots = cx.red + 2 * (size_t)cx.C * (blockDim.x >> 5) * kMaxSums;

  if (cx.own) {
    float* x = row_at<0, K>(cx, REFINE ? kD : kX, cx.pl);
    const size_t comp = (size_t)a * RK + cx.row * K;
#pragma unroll
    for (int q = 0; q < K; ++q) cp_async4(x + q, g.X + (comp + q) * g.n + p);
    if (REFINE) {
      float* rc = row_at<0, K>(cx, kRc, cx.pl);
#pragma unroll
      for (int q = 0; q < K; ++q)
        cp_async4(rc + q, g.Rc + (comp + q) * g.n + p);
    }
    for (int i = cx.row; i < KK; i += r)
      cp_async4(cx.L + i * cx.P + cx.pl, g.L + ((size_t)a * KK + i) * g.n + p);
    if (g.S != nullptr) {
      for (int i = cx.row; i < DD; i += r)
        cp_async4(cx.S + i * cx.P + cx.pl,
                  g.S + ((size_t)a * DD + i) * g.n + p);
      float* gv = row_at<0, K>(cx, kG, cx.pl);
#pragma unroll
      for (int q = 0; q < K; ++q)
        cp_async4(gv + q, g.g + (comp + q) * g.n + p);
    }
  }
  const int nt = g.Ep / g.T;
  const int stride = g.kinc * cx.P;
  int* words = reinterpret_cast<int*>(cx.pay);
  // The incidence and index loads do not depend on the branch (padded
  // entries read slot 0 of a real pose), so unrolled iterations start them
  // together.
#pragma unroll 4
  for (int t = threadIdx.x; t < stride; t += blockDim.x) {
    const int c = t / cx.P;
    const int pe = c0 + t - c * cx.P;
    const size_t ie = ((size_t)a * g.n + min(pe, g.n - 1)) * g.kinc + c;
    const float m = g.incm[ie];
    const int sl = g.inc[ie];
    const bool side_j = sl >= g.E;
    const int e = side_j ? sl - g.E : sl;
    const size_t ge = (size_t)a * g.Ep + e;
    const int ii = g.idx_i[ge];
    const int other = side_j ? ii : g.idx_j[ge];
    int w = 0;
    if (pe < g.n && m != 0.f) {
      w = kLive | (side_j ? kSideJ : 0) |
          ((!side_j || ii >= g.n) ? kCostOwner : 0);
      if (other < g.n) {
        const int rank = other / cx.P;
        w |= kPose | (rank << kRankShift) | (other - rank * cx.P);
      } else if (other < g.n + g.s) {
        w |= kSlot | (other - g.n);
      }
      const int tl = e / g.T;
      const int ln = e - tl * g.T;
      const size_t tile = (size_t)a * nt + tl;
#pragma unroll
      for (int k = 0; k < DD; ++k)
        cp_async4(cx.pay + (1 + k) * stride + t,
                  g.rot + (tile * DD + k) * g.T + ln);
#pragma unroll
      for (int k = 0; k < D; ++k)
        cp_async4(cx.pay + (1 + DD + k) * stride + t,
                  g.trn + (tile * D + k) * g.T + ln);
      cp_async4(cx.pay + (1 + DD + D) * stride + t, g.wk + ge);
      cp_async4(cx.pay + (2 + DD + D) * stride + t, g.wt + ge);
      if (REFINE && (w & kCostOwner)) {
#pragma unroll
        for (int k = 0; k < r * D; ++k)
          cp_async4(cx.pay + (F0 + k) * stride + t,
                    g.rho_rot + (tile * (r * D) + k) * g.T + ln);
#pragma unroll
        for (int k = 0; k < r; ++k)
          cp_async4(cx.pay + (F0 + r * D + k) * stride + t,
                    g.rho_trn + (tile * r + k) * g.T + ln);
      }
    }
    words[t] = w;
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's copies of L have landed
  if (cx.own && cx.row == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      cx.L[i * (K + 1) * cx.P + cx.pl] = 1.f / cx.L[i * (K + 1) * cx.P + cx.pl];
  }
  cl.sync();
  return cx;
}

template <int R, int D, bool REFINE>
__device__ CtxOf<R> setup(const ArgsOf<R>& g, float* smem, int a) {
  if constexpr (R == 0) {
    return setup_rt<D, REFINE>(g, smem, a);
  } else {
    constexpr int K = D + 1;
    constexpr int RK = R * K;
    constexpr int DD = D * D;
    constexpr int KK = K * K;
    constexpr int kPerWarp = 32 / R;
    constexpr int F0 = payload_fields(D);
    constexpr int F = F0 + (REFINE ? refine_fields(R, D) : 0);
    cg::cluster_group cl = cg::this_cluster();
    Ctx cx;
    cx.n = g.n;
    cx.s = g.s;
    cx.kinc = g.kinc;
    cx.n_act = g.n_local[a];
    cx.C = (int)cl.num_blocks();
    cx.rank = (int)cl.block_rank();
    cx.P = (g.n + cx.C - 1) / cx.C;
    cx.parity = 0;
    const int lane = threadIdx.x & 31;
    const int group = lane / R;
    cx.row = lane - group * R;
    cx.base = group * R;
    cx.pl = (threadIdx.x >> 5) * kPerWarp + group;
    const int c0 = cx.rank * cx.P;
    const int p = c0 + cx.pl;
    cx.own = group < kPerWarp && cx.pl < cx.P && p < g.n;
    cx.Z = g.Z + (size_t)a * RK * g.s;
    cx.vec = smem;
    cx.L = cx.vec + (size_t)(REFINE ? kRefineVecs : kVecs) * cx.P *
                        vec_stride(RK);
    cx.S = cx.L + (size_t)KK * cx.P;
    cx.pay = cx.S + (size_t)DD * cx.P;
    cx.red = cx.pay + (size_t)F * g.kinc * cx.P;  // [2][C nw][4]

    if (cx.own) {
      float* x = row_at<R, K>(cx, REFINE ? kD : kX, cx.pl);
      const size_t comp = (size_t)a * RK + cx.row * K;
#pragma unroll
      for (int q = 0; q < K; ++q) cp_async4(x + q, g.X + (comp + q) * g.n + p);
      if (REFINE) {
        float* rc = row_at<R, K>(cx, kRc, cx.pl);
#pragma unroll
        for (int q = 0; q < K; ++q)
          cp_async4(rc + q, g.Rc + (comp + q) * g.n + p);
      }
      for (int i = cx.row; i < KK; i += R)
        cp_async4(cx.L + i * cx.P + cx.pl,
                  g.L + ((size_t)a * KK + i) * g.n + p);
      if (g.S != nullptr) {
        for (int i = cx.row; i < DD; i += R)
          cp_async4(cx.S + i * cx.P + cx.pl,
                    g.S + ((size_t)a * DD + i) * g.n + p);
        float* gv = row_at<R, K>(cx, kG, cx.pl);
#pragma unroll
        for (int q = 0; q < K; ++q)
          cp_async4(gv + q, g.g + (comp + q) * g.n + p);
      }
    }
    const int nt = g.Ep / g.T;
    const int stride = g.kinc * cx.P;
    int* words = reinterpret_cast<int*>(cx.pay);
    // The incidence and index loads do not depend on the branch (padded
    // entries read slot 0 of a real pose), so unrolled iterations start them
    // together.
#pragma unroll 4
    for (int t = threadIdx.x; t < stride; t += blockDim.x) {
      const int c = t / cx.P;
      const int pe = c0 + t - c * cx.P;
      const size_t ie = ((size_t)a * g.n + min(pe, g.n - 1)) * g.kinc + c;
      const float m = g.incm[ie];
      const int sl = g.inc[ie];
      const bool side_j = sl >= g.E;
      const int e = side_j ? sl - g.E : sl;
      const size_t ge = (size_t)a * g.Ep + e;
      const int ii = g.idx_i[ge];
      const int other = side_j ? ii : g.idx_j[ge];
      int w = 0;
      if (pe < g.n && m != 0.f) {
        w = kLive | (side_j ? kSideJ : 0) |
            ((!side_j || ii >= g.n) ? kCostOwner : 0);
        if (other < g.n) {
          const int rank = other / cx.P;
          w |= kPose | (rank << kRankShift) | (other - rank * cx.P);
        } else if (other < g.n + g.s) {
          w |= kSlot | (other - g.n);
        }
        const int tl = e / g.T;
        const int ln = e - tl * g.T;
        const size_t tile = (size_t)a * nt + tl;
#pragma unroll
        for (int k = 0; k < DD; ++k)
          cp_async4(cx.pay + (1 + k) * stride + t,
                    g.rot + (tile * DD + k) * g.T + ln);
#pragma unroll
        for (int k = 0; k < D; ++k)
          cp_async4(cx.pay + (1 + DD + k) * stride + t,
                    g.trn + (tile * D + k) * g.T + ln);
        cp_async4(cx.pay + (1 + DD + D) * stride + t, g.wk + ge);
        cp_async4(cx.pay + (2 + DD + D) * stride + t, g.wt + ge);
        if (REFINE && (w & kCostOwner)) {
#pragma unroll
          for (int k = 0; k < R * D; ++k)
            cp_async4(cx.pay + (F0 + k) * stride + t,
                      g.rho_rot + (tile * (R * D) + k) * g.T + ln);
#pragma unroll
          for (int k = 0; k < R; ++k)
            cp_async4(cx.pay + (F0 + R * D + k) * stride + t,
                      g.rho_trn + (tile * R + k) * g.T + ln);
        }
      }
      words[t] = w;
    }
    cp_async_wait_all();
    __syncthreads();  // every thread's copies of L have landed
    if (cx.own && cx.row == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        cx.L[i * (K + 1) * cx.P + cx.pl] =
            1.f / cx.L[i * (K + 1) * cx.P + cx.pl];
    }
    cl.sync();
    return cx;
  }
}

// Steihaug-Toint truncated CG (pallas_tcg._build_math.tcg) on this
// thread's row of the cluster's agent, from g in kG.  Returns the
// iteration count and sets *hit when the trust-region boundary or
// negative curvature stopped it; eta and Heta are left in kEta and kHeta.
// Every thread of the cluster calls it.
//
// Two cluster barriers per iteration, one per reduction.  The direction
// delta_{k+1} = -z_{k+1} + beta_k delta_k is stored by each owner after
// the second reduction into the buffer that held delta_{k-1}, with no
// barrier before the next Hessian sweep; that sweep computes a remote
// pose's delta_{k+1} from its z_{k+1} and delta_k, which the barriers of
// iteration k published, by the owner's own expression.
template <int R, int D>
__device__ int tcg(Ctx& cx, float radius, int max_iters, float kappa,
                   float theta, bool* hit) {
  constexpr int K = D + 1;
  float s2[2] = {0.f, 0.f};
  {
    float x[K], v[K], zz[K];
    const float zero[K] = {};
    ld_own<R, K>(cx, kX, x);
    ld_own<R, K>(cx, kG, v);
    st_own<R, K>(cx, kR, v);
#pragma unroll
    for (int q = 0; q < K; ++q) zz[q] = v[q];
    precond<R, D>(cx, x, zz);
    st_own<R, K>(cx, kZv, zz);
    s2[0] = dot<K>(v, zz);
    s2[1] = dot<K>(v, v);
#pragma unroll
    for (int q = 0; q < K; ++q) zz[q] = -zz[q];
    st_own<R, K>(cx, kDelta, zz);
    st_own<R, K>(cx, kEta, zero);
    st_own<R, K>(cx, kHeta, zero);
  }
  cluster_sum<2>(cx, s2);  // also publishes delta
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
  int cur = kDelta, prev = kDeltaB;  // this iteration's delta, the last one's
  bool fresh = true;                 // remote poses' delta stored in cur
  float beta = 0.f;
  while (k < max_iters && !done) {
    // Hd = P_X(EucHess[delta] - [delta_Y S | 0]) and the four dots.
    float s4[4];
    {
      float x[K], dl[K], h[K] = {}, et[K];
      ld_own<R, K>(cx, kX, x);
      ld_own<R, K>(cx, cur, dl);
      if (cx.own) {
        if (fresh) {
          sweep<R, D, true, false>(cx, cur, false, dl, h, nullptr);
        } else {
          sweep<R, D, true, false>(cx, kZv, false, dl, h, nullptr, prev,
                                   beta);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float s = 0.f;
#pragma unroll
          for (int b = 0; b < D; ++b)
            s += dl[b] * cx.S[(b * D + c) * cx.P + cx.pl];
          h[c] -= s;
        }
      }
      tangent_project<R, D>(cx, x, h);
      st_own<R, K>(cx, kHd, h);
      ld_own<R, K>(cx, kEta, et);
      s4[0] = dot<K>(dl, h);
      s4[1] = dot<K>(et, et);
      s4[2] = dot<K>(et, dl);
      s4[3] = dot<K>(dl, dl);
    }
    cluster_sum<4>(cx, s4);
    const float d_hd = s4[0], e_e = s4[1], e_d = s4[2], d_d = s4[3];
    const float alpha = rz / (fabsf(d_hd) < kEps ? kEps : d_hd);
    const float e_e_next = e_e + 2.f * alpha * e_d + alpha * alpha * d_d;
    const bool crossing = (d_hd <= 0.f) || (e_e_next >= rad2);
    const float disc = fmaxf(e_d * e_d + d_d * (rad2 - e_e), 0.f);
    const float tau = (-e_d + sqrtf(disc)) / (d_d < kEps ? kEps : d_d);
    const float step = crossing ? tau : alpha;

    // eta += step delta, Heta += step Hd, r += alpha Hd, z = M^-1 r.
    {
      float x[K], dl[K], h[K], v[K], zz[K];
      ld_own<R, K>(cx, kX, x);
      ld_own<R, K>(cx, cur, dl);
      ld_own<R, K>(cx, kHd, h);
      ld_own<R, K>(cx, kEta, v);
#pragma unroll
      for (int q = 0; q < K; ++q) v[q] += step * dl[q];
      st_own<R, K>(cx, kEta, v);
      ld_own<R, K>(cx, kHeta, v);
#pragma unroll
      for (int q = 0; q < K; ++q) v[q] += step * h[q];
      st_own<R, K>(cx, kHeta, v);
      ld_own<R, K>(cx, kR, v);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        v[q] += alpha * h[q];
        zz[q] = v[q];
      }
      st_own<R, K>(cx, kR, v);
      precond<R, D>(cx, x, zz);
      st_own<R, K>(cx, kZv, zz);
      s2[0] = dot<K>(v, zz);
      s2[1] = dot<K>(v, v);
    }
    cluster_sum<2>(cx, s2);
    const float rz_in = s2[0];
    const bool converged = sqrtf(s2[1]) <= target;
    beta = rz_in / (fabsf(rz) < kEps ? kEps : rz);
    rz = rz_in;
    ++k;
    done = crossing || converged;
    *hit = *hit || crossing;
    if (!done && k < max_iters) {
      if (cx.own) {
        float dl[K], zz[K];
        ld_own<R, K>(cx, cur, dl);
        ld_own<R, K>(cx, kZv, zz);
#pragma unroll
        for (int q = 0; q < K; ++q) dl[q] = -zz[q] + beta * dl[q];
        st_own<R, K>(cx, prev, dl);
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

// The attempt loop (pallas_tcg._rtr_kernel :635-655): from k_att attempts
// already spent, at most max_rejections attempts of {tCG at the radius,
// retraction into xp, cost; accept (xp written to xo) when rho > 0.1 and
// f did not rise, else radius / 4}.  xo holds the variable on entry: X
// (B2, B3), or with REFINE the correction D, retracted by retract_refine
// and costed by the increment against rho (B4).  Poses at or past the
// agent's own count (padding) are left untouched.
template <int R, int D, bool REFINE>
__device__ Attempts attempts(Ctx& cx, const ClusterArgs& args, float* xo,
                             float f0, int k_att, float radius,
                             int max_rejections) {
  constexpr int K = D + 1;
  constexpr int kVar = REFINE ? kD : kX;
  const int p = cx.rank * cx.P + cx.pl;
  Attempts at{k_att, false, f0, 0};
  while (at.k_att < max_rejections && !at.accepted) {
    bool hit;
    at.iters += tcg<R, D>(cx, radius, args.max_iters, args.kappa, args.theta,
                          &hit);
    {
      float x[K], et[K], xp[K];
      ld_own<R, K>(cx, kVar, x);
      ld_own<R, K>(cx, kEta, et);
      if constexpr (REFINE) {
        float rc[K];
        ld_own<R, K>(cx, kRc, rc);
        retract_refine<R, D>(cx, rc, x, et, xp);
      } else {
        retract<R, D>(cx, x, et, xp);
      }
      if (p < cx.n_act) {
        st_own<R, K>(cx, kXp, xp);
      } else {
        st_own<R, K>(cx, kXp, x);
      }
    }
    cg::this_cluster().sync();  // the cost reads xp across CTAs
    float s3[3] = {0.f, 0.f, 0.f};
    if (cx.own) {
      float xp[K], unused[K], gv[K], et[K], he[K];
      ld_own<R, K>(cx, kXp, xp);
      sweep<R, D, false, true, REFINE>(cx, kXp, true, xp, unused, &s3[0]);
      ld_own<R, K>(cx, kG, gv);
      ld_own<R, K>(cx, kEta, et);
      ld_own<R, K>(cx, kHeta, he);
      s3[1] = dot<K>(gv, et);
      s3[2] = dot<K>(et, he);
    }
    cluster_sum<3>(cx, s3);
    // The plain sweep sums twice the cost; the increment's terms carry
    // their own halves.
    const float f_prop = (REFINE ? 1.f : 0.5f) * s3[0];
    const float mdec = -(s3[1] + 0.5f * s3[2]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      if (cx.own) {
        float xp[K];
        ld_own<R, K>(cx, kXp, xp);
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

template <int R, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
rtr_full_cluster_kernel(ArgsOf<R> args, float initial_radius,
                        int max_rejections, float grad_tol, float* X_out,
                        float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxOf<R> cx = setup<R, D, false>(args, smem, a);
  if constexpr (R == 0) {
    // RK is 0 at R = 0: the agent's slices start at the launch's rank.
    const size_t off = (size_t)a * rank_of<0>(cx) * K * cx.n;
    X_out += off;
  }
  float* xo = X_out + (size_t)a * RK * cx.n;

  // Start point: G = egrad([X | Z]), S = sym(Y^T G_Y), g = P_X(G), f0.
  float s2[2] = {0.f, 0.f};
  {
    const int p = cx.rank * cx.P + cx.pl;
    float x[K], G[K] = {};
    ld_own<R, K>(cx, kX, x);
    if (cx.own) {
      sweep<R, D, true, true>(cx, kX, true, x, G, &s2[1]);
#pragma unroll
      for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = x[q];
    }
    float sy[D * D];
    sym_ytw<R, D>(cx, x, G, sy);
    if (cx.own && cx.row == 0) {
#pragma unroll
      for (int i = 0; i < D * D; ++i) cx.S[i * cx.P + cx.pl] = sy[i];
    }
    sub_ysym<D>(x, sy, G);
    st_own<R, K>(cx, kG, G);
    s2[0] = dot<K>(G, G);
  }
  cluster_sum<2>(cx, s2);
  const float gn0 = sqrtf(s2[0]);
  const float f0 = 0.5f * s2[1];

  const Attempts at = attempts<R, D, false>(
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
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

template <int R, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
rtr_cluster_kernel(ArgsOf<R> args, float initial_radius,
                   int max_rejections, float* X_out, float* stats,
                   int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxOf<R> cx = setup<R, D, false>(args, smem, a);
  if constexpr (R == 0) {
    // RK is 0 at R = 0: the agent's slices start at the launch's rank.
    const size_t off = (size_t)a * rank_of<0>(cx) * K * cx.n;
    X_out += off;
  }
  float* xo = X_out + (size_t)a * RK * cx.n;
  float s1[1] = {0.f};
  if (cx.own) {
    const int p = cx.rank * cx.P + cx.pl;
    float x[K], unused[K];
    ld_own<R, K>(cx, kX, x);
    sweep<R, D, false, true>(cx, kX, true, x, unused, &s1[0]);
#pragma unroll
    for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = x[q];
  }
  cluster_sum<1>(cx, s1);
  const float f0 = 0.5f * s1[0];
  const Attempts at = attempts<R, D, false>(cx, args, xo, f0, 0,
                                            initial_radius, max_rejections);
  if (cx.rank == 0 && threadIdx.x == 0) {
    float* st = stats + (size_t)a * 4;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    tcg_iters[a] = at.iters;
  }
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

template <int R, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
tcg_cluster_kernel(ArgsOf<R> args, const float* radius, float* eta_out,
                   float* heta_out, float* stats) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxOf<R> cx = setup<R, D, false>(args, smem, a);
  if constexpr (R == 0) {
    // RK is 0 at R = 0: the agent's slices start at the launch's rank.
    const size_t off = (size_t)a * rank_of<0>(cx) * K * cx.n;
    eta_out += off;
    heta_out += off;
  }
  bool hit;
  const int k = tcg<R, D>(cx, radius[a], args.max_iters, args.kappa,
                          args.theta, &hit);
  if (cx.own) {
    const int p = cx.rank * cx.P + cx.pl;
    const size_t comp = (size_t)a * RK + cx.row * K;
    float et[K], he[K];
    ld_own<R, K>(cx, kEta, et);
    ld_own<R, K>(cx, kHeta, he);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      eta_out[(comp + q) * cx.n + p] = et[q];
      heta_out[(comp + q) * cx.n + p] = he[q];
    }
  }
  if (cx.rank == 0 && threadIdx.x == 0) {
    stats[(size_t)a * 2] = (float)k;
    stats[(size_t)a * 2 + 1] = hit ? 1.f : 0.f;
  }
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// args.X is the correction D, args.Z its neighbor slots Dz, args.S and
// args.g the constants S0 and g0.
template <int R, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
rtr_refine_full_cluster_kernel(ArgsOf<R> args, float initial_radius,
                               int max_rejections, float grad_tol,
                               float* D_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  constexpr int DD = D * D;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxOf<R> cx = setup<R, D, true>(args, smem, a);
  if constexpr (R == 0) {
    // RK is 0 at R = 0: the agent's slices start at the launch's rank.
    const size_t off = (size_t)a * rank_of<0>(cx) * K * cx.n;
    D_out += off;
    args.Gref += off;
  }
  float* xo = D_out + (size_t)a * RK * cx.n;

  // dG = egrad([D | Dz]) (the residual map is affine with this linear
  // part) and the cost increment at D in one sweep; then Y = Rc + D into
  // kX (the tangent projections, curvature and preconditioner are taken
  // there), S = S0 + S1 and the re-centered gradient g into kG, |g|^2 and
  // |precond(g)|^2.
  float s3[3] = {0.f, 0.f, 0.f};
  {
    const int p = cx.rank * cx.P + cx.pl;
    float dd[K], rc[K], y[K], G[K] = {}, gr[K] = {}, gv[K];
    ld_own<R, K>(cx, kD, dd);
    ld_own<R, K>(cx, kRc, rc);
    ld_own<R, K>(cx, kG, gv);  // g0
#pragma unroll
    for (int q = 0; q < K; ++q) y[q] = rc[q] + dd[q];
    st_own<R, K>(cx, kX, y);
    if (cx.own) {
      sweep<R, D, true, true, true>(cx, kD, true, dd, G, &s3[2]);
      const size_t comp = (size_t)a * RK + cx.row * K;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        gr[q] = args.Gref[(comp + q) * cx.n + p];
        xo[(cx.row * K + q) * cx.n + p] = dd[q];
      }
    }
    // S1 = sym(D_Y^T Gref_Y + Y_Y^T dG_Y) over the pose's rows.
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
    for (int j = 0; j < DD; ++j)
      St[j] = (cx.own ? cx.S[j * cx.P + cx.pl] : 0.f) + S1[j];
    // Every row has read S0 before row 0 overwrites it (a pose spans
    // warps at R = 0 above r = 32).
    if constexpr (R == 0) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    if (cx.own && cx.row == 0) {
#pragma unroll
      for (int j = 0; j < DD; ++j) cx.S[j * cx.P + cx.pl] = St[j];
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
    st_own<R, K>(cx, kG, gv);
    s3[0] = dot<K>(gv, gv);
    precond<R, D>(cx, y, gv);
    s3[1] = dot<K>(gv, gv);
  }
  cluster_sum<3>(cx, s3);  // also publishes S to the pose's rows
  const float gn0 = sqrtf(s3[0]);
  // The initial radius at the preconditioned-gradient (Cauchy) scale.
  const float radius = fminf(initial_radius, 10.f * sqrtf(s3[1]));
  const float f0 = s3[2];

  const Attempts at = attempts<R, D, true>(
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
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// Launch configuration of A clusters of C CTAs.  A non-portable size (C >
// 8) is allowed only where the card can place one such cluster.
template <typename... KArgs>
int cluster_config(void (*kern)(KArgs...), int A, int C,
                   const ClusterShape& sh, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err =
      raise_smem_limit(reinterpret_cast<const void*>(kern), (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  if (C > kPortableCluster) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(A * C);
  cfg->blockDim = dim3(sh.threads);
  cfg->dynamicSmemBytes = sh.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <typename... KArgs>
int max_clusters(void (*kern)(KArgs...), int C, const ClusterShape& sh,
                 int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = cluster_config(kern, 1, C, sh, nullptr, &cfg, &attr);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(kern), &cfg);
}

template <typename... KArgs, typename... Args>
int launch_cluster(void (*kern)(KArgs...), int A, int C,
                   const ClusterShape& sh, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (C > kMaxCluster) return kUnplaceable;
  int err = cluster_config(kern, A, C, sh, stream, &cfg, &attr);
  if (err != 0) return err;
  if (C > kPortableCluster) {
    int count = 0;
    err = (int)cudaOccupancyMaxActiveClusters(
        &count, reinterpret_cast<const void*>(kern), &cfg);
    if (err != 0) return err;
    if (count < 1) return kUnplaceable;
  }
  err = (int)cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

ClusterArgs make_args(int n, int s, int Ep, int T, int E, int kinc,
                      const void* idx_i, const void* idx_j, const void* rot,
                      const void* trn, const void* wk, const void* wt,
                      const void* X, const void* Z, const void* S,
                      const void* L, const void* g, const void* inc_slot,
                      const void* inc_mask, const void* n_local,
                      int max_iters, float kappa, float theta) {
  ClusterArgs a{};
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
  a.max_iters = max_iters;
  a.kappa = kappa;
  a.theta = theta;
  return a;
}

}  // namespace

// The launchers of one (r, d).  Each kernel part of the build defines them
// and instantiates them for its share of DPGO_SHAPES; the dispatch part
// calls them (shapes.cuh).  Launchers<R, D, false> is a shape another part
// instantiates.
template <int R, int D, bool kInPart = true>
struct Launchers {};

template <int R, int D>
struct Launchers<R, D, true> {
  static int rtr_full(const ClusterArgs& g, int r, int A, int C,
                      float initial_radius, int max_rejections,
                      float grad_tol, float* X_out, float* stats,
                      int* tcg_iters, cudaStream_t stream);
  static int rtr(const ClusterArgs& g, int r, int A, int C,
                 float initial_radius, int max_rejections, float* X_out,
                 float* stats, int* tcg_iters, cudaStream_t stream);
  static int tcg(const ClusterArgs& g, int r, int A, int C,
                 const float* radius, float* eta, float* heta, float* stats,
                 cudaStream_t stream);
  static int refine(const ClusterArgs& g, int r, int A, int C,
                    float initial_radius, int max_rejections, float grad_tol,
                    float* D_out, float* stats, int* tcg_iters,
                    cudaStream_t stream);
  static int query_clusters(int kernel, int r, int n, int kinc, int C,
                            int* count);
};

// The launchers of the folded layout at L lanes a segment and d = D (B2 and
// B4 only, r from the launch): defined and instantiated in part
// fold_part(L), called by the dispatch part.
template <int L, int D, bool kInPart = true>
struct FoldLaunchers {};

template <int L, int D>
struct FoldLaunchers<L, D, true> {
  static int rtr_full(const ClusterArgs& g, int r, int A, int C,
                      float initial_radius, int max_rejections,
                      float grad_tol, float* X_out, float* stats,
                      int* tcg_iters, cudaStream_t stream);
  static int refine(const ClusterArgs& g, int r, int A, int C,
                    float initial_radius, int max_rejections, float grad_tol,
                    float* D_out, float* stats, int* tcg_iters,
                    cudaStream_t stream);
  static int query_clusters(int kernel, int r, int n, int kinc, int C,
                            int* count);
};

#if DPGO_PART >= 0

// The kernels' arguments at this shape: the rank joins them at R = 0.
template <int R>
ArgsOf<R> args_of(const ClusterArgs& g, int r) {
  if constexpr (R == 0) {
    ClusterArgsR a;
    static_cast<ClusterArgs&>(a) = g;
    a.r = r;
    return a;
  } else {
    return g;
  }
}

template <int R, int D>
int Launchers<R, D, true>::rtr_full(const ClusterArgs& g, int r, int A,
                                    int C, float initial_radius,
                                    int max_rejections, float grad_tol,
                                    float* X_out, float* stats,
                                    int* tcg_iters, cudaStream_t stream) {
  if (!pose_fits(r, kMaxThreads)) return dpgo_shapes::kUnsupportedShape;
  if (g.s > kIndexMask + 1) return kTooManySlots;
  const ClusterShape sh = cluster_shape(r, D, g.n, g.kinc, C, false);
  return launch_cluster(rtr_full_cluster_kernel<R, D>, A, C, sh, stream,
                        args_of<R>(g, r), initial_radius, max_rejections,
                        grad_tol, X_out, stats, tcg_iters);
}

template <int R, int D>
int Launchers<R, D, true>::rtr(const ClusterArgs& g, int r, int A, int C,
                               float initial_radius, int max_rejections,
                               float* X_out, float* stats, int* tcg_iters,
                               cudaStream_t stream) {
  if (!pose_fits(r, kMaxThreads)) return dpgo_shapes::kUnsupportedShape;
  if (g.s > kIndexMask + 1) return kTooManySlots;
  const ClusterShape sh = cluster_shape(r, D, g.n, g.kinc, C, false);
  return launch_cluster(rtr_cluster_kernel<R, D>, A, C, sh, stream,
                        args_of<R>(g, r), initial_radius, max_rejections,
                        X_out, stats, tcg_iters);
}

template <int R, int D>
int Launchers<R, D, true>::tcg(const ClusterArgs& g, int r, int A, int C,
                               const float* radius, float* eta, float* heta,
                               float* stats, cudaStream_t stream) {
  if (!pose_fits(r, kMaxThreads)) return dpgo_shapes::kUnsupportedShape;
  const ClusterShape sh = cluster_shape(r, D, g.n, g.kinc, C, false);
  return launch_cluster(tcg_cluster_kernel<R, D>, A, C, sh, stream,
                        args_of<R>(g, r), radius, eta, heta, stats);
}

template <int R, int D>
int Launchers<R, D, true>::refine(const ClusterArgs& g, int r, int A, int C,
                                  float initial_radius, int max_rejections,
                                  float grad_tol, float* D_out, float* stats,
                                  int* tcg_iters, cudaStream_t stream) {
  if (!pose_fits(r, kMaxThreads)) return dpgo_shapes::kUnsupportedShape;
  if (g.s > kIndexMask + 1) return kTooManySlots;
  const ClusterShape sh = cluster_shape(r, D, g.n, g.kinc, C, true);
  return launch_cluster(rtr_refine_full_cluster_kernel<R, D>, A, C, sh,
                        stream, args_of<R>(g, r), initial_radius,
                        max_rejections, grad_tol, D_out, stats, tcg_iters);
}

template <int R, int D>
int Launchers<R, D, true>::query_clusters(int kernel, int r, int n, int kinc,
                                          int C, int* count) {
  if (!pose_fits(r, kMaxThreads)) return dpgo_shapes::kUnsupportedShape;
  const ClusterShape sh = cluster_shape(r, D, n, kinc, C, kernel == kRefine);
  switch (kernel) {
    case kRtrFull:
      return max_clusters(rtr_full_cluster_kernel<R, D>, C, sh, count);
    case kRtr:
      return max_clusters(rtr_cluster_kernel<R, D>, C, sh, count);
    case kTcg:
      return max_clusters(tcg_cluster_kernel<R, D>, C, sh, count);
    case kRefine:
      return max_clusters(rtr_refine_full_cluster_kernel<R, D>, C, sh,
                          count);
  }
  return kUnknownKernel;
}

#define DPGO_INSTANTIATE(R_, D_) \
  template struct Launchers<R_, D_, dpgo_shapes::in_part(R_, D_)>;
DPGO_SHAPES(DPGO_INSTANTIATE)
DPGO_GENERIC_SHAPES(DPGO_INSTANTIATE)
#undef DPGO_INSTANTIATE

#if DPGO_PART > DPGO_PARTS

// ---------------------------------------------------------------------------
// The folded lane layout of B2 and B4 at 11 <= r <= 32 (parts fold_part(L)).
//
// Replaces, as a second cluster layout, the same TPU kernels as
// rtr_full_cluster_kernel and rtr_refine_full_cluster_kernel
// (pallas_tcg.py's _rtr_full_kernel and _rtr_refine_full_kernel).  Like
// them it is bound by neither bytes nor operations (both bounds are a few
// microseconds) but by the dependency chain of the tCG iterations.
//
// The row-a-lane layout gives a pose r lanes, one row each, so a warp
// holds 32 / r poses and leaves 32 mod r lanes idle (10 at r = 11, 32 - r
// above r = 16); a 316-pose agent then needs a 16-CTA cluster at r >= 11
// (the CTA's 512-thread cap), and a group sum is a chain of r dependent
// shuffles.  Here a pose sits on an aligned segment of L lanes (L in {8,
// 16}), row q on lane q % L at fold q / L, so a lane holds F = ceil(r / L)
// <= 4 rows and a warp 32 / L poses: the same agent fits an 8-CTA cluster
// at L = 8 (B2 up to r = 17, B4 up to r = 12 at d = 3), and a group sum is
// each lane's folds added in fold order, then log2 L butterfly steps in the
// segment (lanes.cuh's segment_sum), bit-identical on every lane of the
// segment.  Each per-row phase loops over the folds; a phase that needs a
// sum over the pose's rows runs in two passes, the first parking each
// fold's row in a shared vector it writes anyway (or in one the phase does
// not use yet), the second finishing it.  Rows stay in the CTA's shared
// vectors at their usual places, so the sweeps, the reductions and the
// remote reads are the rank-generic ones (R = 0), with the context's row
// set to the fold's.  What it costs: a lane with F rows runs F times the
// per-row chain of a Hessian sweep, which is why L = 8 pays only where it
// halves the cluster (ops/rtr_kernel.FOLD_RULE holds the measured rule).
// ---------------------------------------------------------------------------

namespace {

// One thread's view of its agent in the folded layout: its segment lane,
// its pose's folds, and whether its CTA holds the pose; row and own follow
// the fold the thread is at (at_lane_fold).
struct CtxL : CtxR {
  int folds;  // ceil(r / L): rows a lane holds of its pose
  int seg;    // the lane's place in its segment: its row at fold 0
  bool held;  // the pose is this CTA's (slot < P, pose < n)
};

// Point the thread at fold f: row seg + f L, held when the pose is and the
// row lies below r.
template <int L>
__device__ __forceinline__ void at_lane_fold(CtxL& cx, int f) {
  cx.row = cx.seg + f * L;
  cx.own = cx.held && cx.row < cx.r;
}

// m += the D(D+1)/2 entries b <= c of sym(x^T w) for one row.
template <int D>
__device__ __forceinline__ void add_sym(float (&m)[D * (D + 1) / 2],
                                        const float (&x)[D + 1],
                                        const float (&w)[D + 1]) {
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i)
      m[i] += 0.5f * (x[b] * w[c] + x[c] * w[b]);
}

// The pose's sums of m over its segment into the full row-major matrix.
template <int L, int D>
__device__ __forceinline__ void segment_sym(float (&m)[D * (D + 1) / 2],
                                            float (&sy)[D * D]) {
  segment_sum<L, D * (D + 1) / 2>(m);
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i) {
      sy[b * D + c] = m[i];
      sy[c * D + b] = m[i];
    }
}

// The block-Jacobi solve of the thread's row (precond's substitutions,
// without the tangent projection, which needs the pose's other rows).
template <int D>
__device__ __forceinline__ void jacobi_solve(const Ctx& cx,
                                             float (&v)[D + 1]) {
  constexpr int K = D + 1;
  float Lp[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) Lp[i] = cx.L[i * cx.P + cx.pl];
  float y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = v[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= Lp[i * K + q] * y[q];
    y[i] = s * Lp[i * K + i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < K; ++q) s -= Lp[q * K + i] * v[q];
    v[i] = s * Lp[i * K + i];
  }
}

// retract's Newton-Schulz sweeps on the pose's M^T M (MM): the polar
// factor's right part Zm and 1 / sqrt(trace).
template <int D>
__device__ void ns_polar(const float (&MM)[D * D], float (&Zm)[D][D],
                         float* inv) {
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
  *inv = 1.f / sqrtf(s);
}

// retract_refine's correction C ~ (I + E)^(-1/2) - I from the pose's E.
template <int D>
__device__ void polar_correction(const float (&Ef)[D * D],
                                 float (&Cm)[D][D]) {
  float E[D][D], E2[D][D], E3[D][D], E4[D][D];
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) E[b][c] = Ef[b * D + c];
  matmul3<D>(E, E, E2);
  matmul3<D>(E2, E, E3);
  matmul3<D>(E2, E2, E4);
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c)
      Cm[b][c] = -0.5f * E[b][c] + 0.375f * E2[b][c] - 0.3125f * E3[b][c] +
                 0.2734375f * E4[b][c];
}

// setup_rt in the folded layout: the segment's lanes gather the pose's
// rows fold by fold, and L and S by segment lane.
template <int L, int D, bool REFINE>
__device__ CtxL setup_fold(const ClusterArgsR& g, float* smem, int a) {
  constexpr int K = D + 1;
  constexpr int DD = D * D;
  constexpr int KK = K * K;
  constexpr int F0 = payload_fields(D);
  cg::cluster_group cl = cg::this_cluster();
  CtxL cx;
  cx.r = g.r;
  const int r = g.r;
  const int RK = r * K;
  const int F = F0 + (REFINE ? refine_fields(r, D) : 0);
  cx.n = g.n;
  cx.s = g.s;
  cx.kinc = g.kinc;
  cx.n_act = g.n_local[a];
  cx.C = (int)cl.num_blocks();
  cx.rank = (int)cl.block_rank();
  cx.P = (g.n + cx.C - 1) / cx.C;
  cx.parity = 0;
  const int lane = threadIdx.x & 31;
  const int group = lane / L;
  cx.seg = lane - group * L;
  cx.base = group * L;
  cx.pl = (threadIdx.x >> 5) * (32 / L) + group;
  cx.folds = lane_folds(r, L);
  const int c0 = cx.rank * cx.P;
  const int p = c0 + cx.pl;
  cx.held = cx.pl < cx.P && p < g.n;
  cx.Z = g.Z + (size_t)a * RK * g.s;
  cx.vec = smem;
  cx.L = cx.vec + (size_t)(REFINE ? kRefineVecs : kVecs) * cx.P *
                      vec_stride(RK);
  cx.S = cx.L + (size_t)KK * cx.P;
  cx.pay = cx.S + (size_t)DD * cx.P;
  cx.red = cx.pay + (size_t)F * g.kinc * cx.P;  // [2][C nw][4]
  cx.gslots = nullptr;

  if (cx.held) {
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float* x = row_at<0, K>(cx, REFINE ? kD : kX, cx.pl);
      const size_t comp = (size_t)a * RK + cx.row * K;
#pragma unroll
      for (int q = 0; q < K; ++q)
        cp_async4(x + q, g.X + (comp + q) * g.n + p);
      if (REFINE) {
        float* rc = row_at<0, K>(cx, kRc, cx.pl);
#pragma unroll
        for (int q = 0; q < K; ++q)
          cp_async4(rc + q, g.Rc + (comp + q) * g.n + p);
      }
      if (g.S != nullptr) {
        float* gv = row_at<0, K>(cx, kG, cx.pl);
#pragma unroll
        for (int q = 0; q < K; ++q)
          cp_async4(gv + q, g.g + (comp + q) * g.n + p);
      }
    }
    for (int i = cx.seg; i < KK; i += L)
      cp_async4(cx.L + i * cx.P + cx.pl, g.L + ((size_t)a * KK + i) * g.n + p);
    if (g.S != nullptr) {
      for (int i = cx.seg; i < DD; i += L)
        cp_async4(cx.S + i * cx.P + cx.pl,
                  g.S + ((size_t)a * DD + i) * g.n + p);
    }
  }
  const int nt = g.Ep / g.T;
  const int stride = g.kinc * cx.P;
  int* words = reinterpret_cast<int*>(cx.pay);
#pragma unroll 4
  for (int t = threadIdx.x; t < stride; t += blockDim.x) {
    const int c = t / cx.P;
    const int pe = c0 + t - c * cx.P;
    const size_t ie = ((size_t)a * g.n + min(pe, g.n - 1)) * g.kinc + c;
    const float m = g.incm[ie];
    const int sl = g.inc[ie];
    const bool side_j = sl >= g.E;
    const int e = side_j ? sl - g.E : sl;
    const size_t ge = (size_t)a * g.Ep + e;
    const int ii = g.idx_i[ge];
    const int other = side_j ? ii : g.idx_j[ge];
    int w = 0;
    if (pe < g.n && m != 0.f) {
      w = kLive | (side_j ? kSideJ : 0) |
          ((!side_j || ii >= g.n) ? kCostOwner : 0);
      if (other < g.n) {
        const int rank = other / cx.P;
        w |= kPose | (rank << kRankShift) | (other - rank * cx.P);
      } else if (other < g.n + g.s) {
        w |= kSlot | (other - g.n);
      }
      const int tl = e / g.T;
      const int ln = e - tl * g.T;
      const size_t tile = (size_t)a * nt + tl;
#pragma unroll
      for (int k = 0; k < DD; ++k)
        cp_async4(cx.pay + (1 + k) * stride + t,
                  g.rot + (tile * DD + k) * g.T + ln);
#pragma unroll
      for (int k = 0; k < D; ++k)
        cp_async4(cx.pay + (1 + DD + k) * stride + t,
                  g.trn + (tile * D + k) * g.T + ln);
      cp_async4(cx.pay + (1 + DD + D) * stride + t, g.wk + ge);
      cp_async4(cx.pay + (2 + DD + D) * stride + t, g.wt + ge);
      if (REFINE && (w & kCostOwner)) {
        for (int k = 0; k < r * D; ++k)
          cp_async4(cx.pay + (F0 + k) * stride + t,
                    g.rho_rot + (tile * (r * D) + k) * g.T + ln);
        for (int k = 0; k < r; ++k)
          cp_async4(cx.pay + (F0 + r * D + k) * stride + t,
                    g.rho_trn + (tile * r + k) * g.T + ln);
      }
    }
    words[t] = w;
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's copies of L have landed
  if (cx.held && cx.seg == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float* diag = cx.L + i * (K + 1) * cx.P + cx.pl;
      *diag = 1.f / *diag;
    }
  }
  cl.sync();
  at_lane_fold<L>(cx, 0);
  return cx;
}

// tcg in the folded layout: the same iteration, scalars and barriers; each
// per-row phase loops over the folds, and each tangent projection takes
// two passes (the rows' sym(Y^T W) summed over the segment between them).
template <int L, int D>
__device__ int tcg_fold(CtxL& cx, float radius, int max_iters, float kappa,
                        float theta, bool* hit) {
  constexpr int K = D + 1;
  constexpr int M = D * (D + 1) / 2;
  float s2[2] = {0.f, 0.f};
  {
    // r = g; z = precond(g), parked unprojected in kZv; then z projected,
    // delta = -z, eta = Heta = 0.
    float m[M] = {}, sy[D * D];
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float x[K], v[K];
      ld_own<0, K>(cx, kX, x);
      ld_own<0, K>(cx, kG, v);
      st_own<0, K>(cx, kR, v);
      jacobi_solve<D>(cx, v);
      st_own<0, K>(cx, kZv, v);
      add_sym<D>(m, x, v);
    }
    segment_sym<L, D>(m, sy);
    const float zero[K] = {};
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float x[K], v[K], zz[K];
      ld_own<0, K>(cx, kX, x);
      ld_own<0, K>(cx, kR, v);
      ld_own<0, K>(cx, kZv, zz);
      sub_ysym<D>(x, sy, zz);
      st_own<0, K>(cx, kZv, zz);
      s2[0] += dot<K>(v, zz);
      s2[1] += dot<K>(v, v);
#pragma unroll
      for (int q = 0; q < K; ++q) zz[q] = -zz[q];
      st_own<0, K>(cx, kDelta, zz);
      st_own<0, K>(cx, kEta, zero);
      st_own<0, K>(cx, kHeta, zero);
    }
  }
  cluster_sum<2>(cx, s2);  // also publishes delta
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
  int cur = kDelta, prev = kDeltaB;  // this iteration's delta, the last one's
  bool fresh = true;                 // remote poses' delta stored in cur
  float beta = 0.f;
  while (k < max_iters && !done) {
    // Hd = P_X(EucHess[delta] - [delta_Y S | 0]), parked unprojected in
    // kHd; then projected, and the four dots.
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    {
      float m[M] = {}, sy[D * D];
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float x[K], dl[K], h[K];
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, cur, dl);
        if (fresh) {
          sweep<0, D, true, false>(cx, cur, false, dl, h, nullptr);
        } else {
          sweep<0, D, true, false>(cx, kZv, false, dl, h, nullptr, prev,
                                   beta);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float s = 0.f;
#pragma unroll
          for (int b = 0; b < D; ++b)
            s += dl[b] * cx.S[(b * D + c) * cx.P + cx.pl];
          h[c] -= s;
        }
        st_own<0, K>(cx, kHd, h);
        add_sym<D>(m, x, h);
      }
      segment_sym<L, D>(m, sy);
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float x[K], dl[K], h[K], et[K];
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, cur, dl);
        ld_own<0, K>(cx, kHd, h);
        ld_own<0, K>(cx, kEta, et);
        sub_ysym<D>(x, sy, h);
        st_own<0, K>(cx, kHd, h);
        s4[0] += dot<K>(dl, h);
        s4[1] += dot<K>(et, et);
        s4[2] += dot<K>(et, dl);
        s4[3] += dot<K>(dl, dl);
      }
    }
    cluster_sum<4>(cx, s4);
    const float d_hd = s4[0], e_e = s4[1], e_d = s4[2], d_d = s4[3];
    const float alpha = rz / (fabsf(d_hd) < kEps ? kEps : d_hd);
    const float e_e_next = e_e + 2.f * alpha * e_d + alpha * alpha * d_d;
    const bool crossing = (d_hd <= 0.f) || (e_e_next >= rad2);
    const float disc = fmaxf(e_d * e_d + d_d * (rad2 - e_e), 0.f);
    const float tau = (-e_d + sqrtf(disc)) / (d_d < kEps ? kEps : d_d);
    const float step = crossing ? tau : alpha;

    // eta += step delta, Heta += step Hd, r += alpha Hd; z = M^-1 r parked
    // unprojected in kZv, then projected, and the two dots.
    {
      float m[M] = {}, sy[D * D];
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float x[K], dl[K], h[K], v[K];
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, cur, dl);
        ld_own<0, K>(cx, kHd, h);
        ld_own<0, K>(cx, kEta, v);
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] += step * dl[q];
        st_own<0, K>(cx, kEta, v);
        ld_own<0, K>(cx, kHeta, v);
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] += step * h[q];
        st_own<0, K>(cx, kHeta, v);
        ld_own<0, K>(cx, kR, v);
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] += alpha * h[q];
        st_own<0, K>(cx, kR, v);
        jacobi_solve<D>(cx, v);
        st_own<0, K>(cx, kZv, v);
        add_sym<D>(m, x, v);
      }
      segment_sym<L, D>(m, sy);
      s2[0] = 0.f;
      s2[1] = 0.f;
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float x[K], v[K], zz[K];
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, kR, v);
        ld_own<0, K>(cx, kZv, zz);
        sub_ysym<D>(x, sy, zz);
        st_own<0, K>(cx, kZv, zz);
        s2[0] += dot<K>(v, zz);
        s2[1] += dot<K>(v, v);
      }
    }
    cluster_sum<2>(cx, s2);
    const float rz_in = s2[0];
    const bool converged = sqrtf(s2[1]) <= target;
    beta = rz_in / (fabsf(rz) < kEps ? kEps : rz);
    rz = rz_in;
    ++k;
    done = crossing || converged;
    *hit = *hit || crossing;
    if (!done && k < max_iters) {
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float dl[K], zz[K];
        ld_own<0, K>(cx, cur, dl);
        ld_own<0, K>(cx, kZv, zz);
#pragma unroll
        for (int q = 0; q < K; ++q) dl[q] = -zz[q] + beta * dl[q];
        st_own<0, K>(cx, prev, dl);
      }
      const int t = cur;
      cur = prev;
      prev = t;
      fresh = false;
    }
  }
  return k;
}

// attempts in the folded layout: the retraction's sum over the pose's rows
// (M^T M, or the refine step's E) between a pass that accumulates it and a
// pass that writes each row's proposal.
template <int L, int D, bool REFINE>
__device__ Attempts attempts_fold(CtxL& cx, const ClusterArgs& args,
                                  float* xo, float f0, int k_att,
                                  float radius, int max_rejections) {
  constexpr int K = D + 1;
  constexpr int M = D * (D + 1) / 2;
  constexpr int kVar = REFINE ? kD : kX;
  const int p = cx.rank * cx.P + cx.pl;
  Attempts at{k_att, false, f0, 0};
  while (at.k_att < max_rejections && !at.accepted) {
    bool hit;
    at.iters += tcg_fold<L, D>(cx, radius, args.max_iters, args.kappa,
                               args.theta, &hit);
    {
      float m[M] = {}, sy[D * D];
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float x[K], et[K];
        ld_own<0, K>(cx, kVar, x);
        ld_own<0, K>(cx, kEta, et);
        int i = 0;
        if constexpr (REFINE) {
          float rc[K];
          ld_own<0, K>(cx, kRc, rc);
#pragma unroll
          for (int b = 0; b < D; ++b)
#pragma unroll
            for (int c = b; c < D; ++c, ++i) {
              const float ub = x[b] + et[b], uc = x[c] + et[c];
              m[i] += rc[b] * uc + ub * rc[c] + ub * uc;
            }
        } else {
#pragma unroll
          for (int b = 0; b < D; ++b)
#pragma unroll
            for (int c = b; c < D; ++c, ++i)
              m[i] += (x[b] + et[b]) * (x[c] + et[c]);
        }
      }
      segment_sym<L, D>(m, sy);
      float Cm[D][D], inv = 1.f;
      if constexpr (REFINE) {
        polar_correction<D>(sy, Cm);
      } else {
        ns_polar<D>(sy, Cm, &inv);
      }
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float x[K], et[K], xp[K];
        ld_own<0, K>(cx, kVar, x);
        ld_own<0, K>(cx, kEta, et);
        if constexpr (REFINE) {
          float rc[K], u[K];
          ld_own<0, K>(cx, kRc, rc);
#pragma unroll
          for (int q = 0; q < K; ++q) u[q] = x[q] + et[q];
#pragma unroll
          for (int c = 0; c < D; ++c) {
            float s = 0.f;
#pragma unroll
            for (int b = 0; b < D; ++b) s += (rc[b] + u[b]) * Cm[b][c];
            xp[c] = u[c] + s;
          }
          xp[D] = u[D];
        } else {
#pragma unroll
          for (int c = 0; c < D; ++c) {
            float acc = 0.f;
#pragma unroll
            for (int b = 0; b < D; ++b) acc += (x[b] + et[b]) * Cm[b][c];
            xp[c] = acc * inv;
          }
          xp[D] = x[D] + et[D];
        }
        if (p < cx.n_act) {
          st_own<0, K>(cx, kXp, xp);
        } else {
          st_own<0, K>(cx, kXp, x);
        }
      }
    }
    cg::this_cluster().sync();  // the cost reads xp across CTAs
    float s3[3] = {0.f, 0.f, 0.f};
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float xp[K], unused[K], gv[K], et[K], he[K];
      ld_own<0, K>(cx, kXp, xp);
      sweep<0, D, false, true, REFINE>(cx, kXp, true, xp, unused, &s3[0]);
      ld_own<0, K>(cx, kG, gv);
      ld_own<0, K>(cx, kEta, et);
      ld_own<0, K>(cx, kHeta, he);
      s3[1] += dot<K>(gv, et);
      s3[2] += dot<K>(et, he);
    }
    cluster_sum<3>(cx, s3);
    const float f_prop = (REFINE ? 1.f : 0.5f) * s3[0];
    const float mdec = -(s3[1] + 0.5f * s3[2]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      for (int f = 0; f < cx.folds; ++f) {
        at_lane_fold<L>(cx, f);
        if (!cx.own) continue;
        float xp[K];
        ld_own<0, K>(cx, kXp, xp);
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

// B2 in the folded layout (rtr_full_cluster_kernel's phases).
template <int L, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
rtr_full_cluster_fold_kernel(ClusterArgsR args, float initial_radius,
                             int max_rejections, float grad_tol,
                             float* X_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int M = D * (D + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxL cx = setup_fold<L, D, false>(args, smem, a);
  float* xo = X_out + (size_t)a * cx.r * K * cx.n;

  // Start point: G = egrad([X | Z]) parked in kG with f0's terms; S =
  // sym(Y^T G_Y) over the segment; g = P_X(G), |g|^2.
  float s2[2] = {0.f, 0.f};
  {
    const int p = cx.rank * cx.P + cx.pl;
    float m[M] = {}, sy[D * D];
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float x[K], G[K];
      ld_own<0, K>(cx, kX, x);
      sweep<0, D, true, true>(cx, kX, true, x, G, &s2[1]);
#pragma unroll
      for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = x[q];
      st_own<0, K>(cx, kG, G);
      add_sym<D>(m, x, G);
    }
    segment_sym<L, D>(m, sy);
    if (cx.held && cx.seg == 0) {
#pragma unroll
      for (int i = 0; i < D * D; ++i) cx.S[i * cx.P + cx.pl] = sy[i];
    }
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float x[K], G[K];
      ld_own<0, K>(cx, kX, x);
      ld_own<0, K>(cx, kG, G);
      sub_ysym<D>(x, sy, G);
      st_own<0, K>(cx, kG, G);
      s2[0] += dot<K>(G, G);
    }
  }
  cluster_sum<2>(cx, s2);
  const float gn0 = sqrtf(s2[0]);
  const float f0 = 0.5f * s2[1];

  const Attempts at = attempts_fold<L, D, false>(
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
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// B4 in the folded layout (rtr_refine_full_cluster_kernel's phases): dG
// parks in kHd and precond(g) in kZv between their passes (tcg writes both
// before it reads them).
template <int L, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
rtr_refine_full_cluster_fold_kernel(ClusterArgsR args, float initial_radius,
                                    int max_rejections, float grad_tol,
                                    float* D_out, float* stats,
                                    int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int M = D * (D + 1) / 2;
  constexpr int DD = D * D;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxL cx = setup_fold<L, D, true>(args, smem, a);
  const size_t off = (size_t)a * cx.r * K * cx.n;
  float* xo = D_out + off;
  const float* gref = args.Gref + off;

  float s3[3] = {0.f, 0.f, 0.f};
  {
    const int p = cx.rank * cx.P + cx.pl;
    float m[M] = {}, S1[DD], St[DD];
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float dd[K], rc[K], y[K], G[K], gr[K];
      ld_own<0, K>(cx, kD, dd);
      ld_own<0, K>(cx, kRc, rc);
#pragma unroll
      for (int q = 0; q < K; ++q) y[q] = rc[q] + dd[q];
      st_own<0, K>(cx, kX, y);
      sweep<0, D, true, true, true>(cx, kD, true, dd, G, &s3[2]);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        gr[q] = gref[(cx.row * K + q) * cx.n + p];
        xo[(cx.row * K + q) * cx.n + p] = dd[q];
      }
      st_own<0, K>(cx, kHd, G);
      int i = 0;
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = b; c < D; ++c, ++i)
          m[i] += 0.5f * (dd[b] * gr[c] + dd[c] * gr[b] + y[b] * G[c] +
                          y[c] * G[b]);
    }
    segment_sym<L, D>(m, S1);
#pragma unroll
    for (int j = 0; j < DD; ++j)
      St[j] = (cx.held ? cx.S[j * cx.P + cx.pl] : 0.f) + S1[j];
    __syncwarp();  // every lane of the segment has read S0
    if (cx.held && cx.seg == 0) {
#pragma unroll
      for (int j = 0; j < DD; ++j) cx.S[j * cx.P + cx.pl] = St[j];
    }
    float m2[M] = {}, sy[DD];
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float dd[K], rc[K], y[K], G[K], gv[K];
      ld_own<0, K>(cx, kD, dd);
      ld_own<0, K>(cx, kRc, rc);
      ld_own<0, K>(cx, kX, y);
      ld_own<0, K>(cx, kHd, G);
      ld_own<0, K>(cx, kG, gv);  // g0
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b)
          s += rc[b] * S1[b * D + c] + dd[b] * St[b * D + c];
        gv[c] = gv[c] + G[c] - s;
      }
      gv[D] = gv[D] + G[D];
      st_own<0, K>(cx, kG, gv);
      s3[0] += dot<K>(gv, gv);
      jacobi_solve<D>(cx, gv);
      st_own<0, K>(cx, kZv, gv);
      add_sym<D>(m2, y, gv);
    }
    segment_sym<L, D>(m2, sy);
    for (int f = 0; f < cx.folds; ++f) {
      at_lane_fold<L>(cx, f);
      if (!cx.own) continue;
      float y[K], z[K];
      ld_own<0, K>(cx, kX, y);
      ld_own<0, K>(cx, kZv, z);
      sub_ysym<D>(y, sy, z);
      s3[1] += dot<K>(z, z);
    }
  }
  cluster_sum<3>(cx, s3);  // also publishes S to the pose's rows
  const float gn0 = sqrtf(s3[0]);
  const float radius = fminf(initial_radius, 10.f * sqrtf(s3[1]));
  const float f0 = s3[2];

  const Attempts at = attempts_fold<L, D, true>(
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
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// A folded launch's shape, or kUnsupportedShape outside kMinGenericRank <=
// r <= kFoldMaxRank, or kUnplaceable where one CTA exceeds the card's
// threads or shared memory (the plan does not offer such a shape; a
// forced one raises with it).
int fold_launch_shape(int r, int d, int n, int kinc, int C, int L,
                             bool refine, ClusterShape* sh) {
  if (r < dpgo_shapes::kMinGenericRank || r > kFoldMaxRank)
    return dpgo_shapes::kUnsupportedShape;
  *sh = fold_shape(r, d, n, kinc, C, L, refine);
  if (sh->threads > kMaxThreads || sh->smem > kMaxSmemBytes)
    return kUnplaceable;
  return 0;
}

}  // namespace

template <int L, int D>
int FoldLaunchers<L, D, true>::rtr_full(const ClusterArgs& g, int r, int A,
                                        int C, float initial_radius,
                                        int max_rejections, float grad_tol,
                                        float* X_out, float* stats,
                                        int* tcg_iters, cudaStream_t stream) {
  if (g.s > kIndexMask + 1) return kTooManySlots;
  ClusterShape sh;
  const int err = fold_launch_shape(r, D, g.n, g.kinc, C, L, false, &sh);
  if (err != 0) return err;
  return launch_cluster(rtr_full_cluster_fold_kernel<L, D>, A, C, sh, stream,
                        args_of<0>(g, r), initial_radius, max_rejections,
                        grad_tol, X_out, stats, tcg_iters);
}

template <int L, int D>
int FoldLaunchers<L, D, true>::refine(const ClusterArgs& g, int r, int A,
                                      int C, float initial_radius,
                                      int max_rejections, float grad_tol,
                                      float* D_out, float* stats,
                                      int* tcg_iters, cudaStream_t stream) {
  if (g.s > kIndexMask + 1) return kTooManySlots;
  ClusterShape sh;
  const int err = fold_launch_shape(r, D, g.n, g.kinc, C, L, true, &sh);
  if (err != 0) return err;
  return launch_cluster(rtr_refine_full_cluster_fold_kernel<L, D>, A, C, sh,
                        stream, args_of<0>(g, r), initial_radius,
                        max_rejections, grad_tol, D_out, stats, tcg_iters);
}

template <int L, int D>
int FoldLaunchers<L, D, true>::query_clusters(int kernel, int r, int n,
                                              int kinc, int C, int* count) {
  if (kernel != kRtrFull && kernel != kRefine) return kUnknownKernel;
  ClusterShape sh;
  const int err = fold_launch_shape(r, D, n, kinc, C, L, kernel == kRefine,
                                    &sh);
  if (err == kUnplaceable) {
    *count = 0;
    return 0;
  }
  if (err != 0) return err;
  if (kernel == kRtrFull)
    return max_clusters(rtr_full_cluster_fold_kernel<L, D>, C, sh, count);
  return max_clusters(rtr_refine_full_cluster_fold_kernel<L, D>, C, sh,
                      count);
}

template struct FoldLaunchers<8, 3, DPGO_PART == fold_part(8)>;
template struct FoldLaunchers<8, 2, DPGO_PART == fold_part(8)>;
template struct FoldLaunchers<16, 3, DPGO_PART == fold_part(16)>;
template struct FoldLaunchers<16, 2, DPGO_PART == fold_part(16)>;

#endif  // DPGO_PART > DPGO_PARTS

#endif  // DPGO_PART >= 0

#if DPGO_PART < 0

using dpgo_shapes::dispatch;

// The folded layout's launchers at L lanes a segment (8 or 16) and d,
// else kUnsupportedShape.
template <typename F>
int fold_dispatch(int lanes, int d, F&& f) {
  if (lanes == 8 && d == 3) return f(FoldLaunchers<8, 3>{});
  if (lanes == 8 && d == 2) return f(FoldLaunchers<8, 2>{});
  if (lanes == 16 && d == 3) return f(FoldLaunchers<16, 3>{});
  if (lanes == 16 && d == 2) return f(FoldLaunchers<16, 2>{});
  return dpgo_shapes::kUnsupportedShape;
}

// The entry points have C linkage: their names are global, whatever the
// namespace.
extern "C" {

// Shared-memory bytes of one CTA of cluster kernel `kernel` (Kernel) for
// an agent of n_max poses and Kinc incidence entries per pose split over C
// CTAs.
long long dpgo_rtr_cluster_smem_bytes(int r, int d, int n_max, int kinc,
                                      int C, int kernel) {
  return (long long)cluster_shape(r, d, n_max, kinc, C, kernel == kRefine)
      .smem;
}

// How many clusters of C CTAs of cluster kernel `kernel` the card can hold
// at once (cudaOccupancyMaxActiveClusters) into *count; returns a
// cudaError_t, -1 for an (r, d) without instantiation or whose pose spans
// more warps than a CTA holds (r > 512), -4 for an unknown kernel.
int dpgo_rtr_cluster_max_clusters(int r, int d, int n_max, int kinc, int C,
                                  int kernel, void* count) {
  int* c = static_cast<int*>(count);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.query_clusters(kernel, r, n_max, kinc, C, c);
  });
}

int dpgo_rtr_full_cluster_launch(
    int r, int d, int C, int A, int n, int s, int Ep, int T, int e_max,
    int kinc, const void* idx_i, const void* idx_j, const void* rot,
    const void* trn, const void* wk, const void* wt, const void* X,
    const void* Z, const void* L, const void* inc_slot, const void* inc_mask,
    const void* n_local, void* X_out, void* stats, void* tcg_iters,
    int max_iters, float kappa, float theta, float initial_radius,
    int max_rejections, float grad_tol, void* stream) {
  const ClusterArgs g = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j,
                                  rot, trn, wk, wt, X, Z, nullptr, L, nullptr,
                                  inc_slot, inc_mask, n_local, max_iters,
                                  kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr_full(g, r, A, C, initial_radius, max_rejections,
                              grad_tol, xo, st, it, cs);
  });
}

int dpgo_rtr_cluster_launch(
    int r, int d, int C, int A, int n, int s, int Ep, int T, int e_max,
    int kinc, const void* idx_i, const void* idx_j, const void* rot,
    const void* trn, const void* wk, const void* wt, const void* X,
    const void* Z, const void* S, const void* L, const void* g,
    const void* inc_slot, const void* inc_mask, const void* n_local,
    void* X_out, void* stats, void* tcg_iters, int max_iters, float kappa,
    float theta, float initial_radius, int max_rejections, void* stream) {
  const ClusterArgs a = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j,
                                  rot, trn, wk, wt, X, Z, S, L, g, inc_slot,
                                  inc_mask, n_local, max_iters, kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr(a, r, A, C, initial_radius, max_rejections, xo, st,
                         it, cs);
  });
}

int dpgo_tcg_cluster_launch(
    int r, int d, int C, int A, int n, int Ep, int T, int e_max, int kinc,
    const void* idx_i, const void* idx_j, const void* rot, const void* trn,
    const void* wk, const void* wt, const void* X, const void* S,
    const void* L, const void* g, const void* radius, const void* inc_slot,
    const void* inc_mask, const void* n_local, void* eta, void* heta,
    void* stats, int max_iters, float kappa, float theta, void* stream) {
  // The tCG sweeps are Hessian sweeps only: no neighbor slots are read.
  const ClusterArgs a = make_args(n, 0, Ep, T, e_max, kinc, idx_i, idx_j,
                                  rot, trn, wk, wt, X, X, S, L, g, inc_slot,
                                  inc_mask, n_local, max_iters, kappa, theta);
  const float* rd = static_cast<const float*>(radius);
  float* e = static_cast<float*>(eta);
  float* h = static_cast<float*>(heta);
  float* st = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.tcg(a, r, A, C, rd, e, h, st, cs);
  });
}

int dpgo_rtr_refine_full_cluster_launch(
    int r, int d, int C, int A, int n, int s, int Ep, int T, int e_max,
    int kinc, const void* idx_i, const void* idx_j, const void* rot,
    const void* trn, const void* wk, const void* wt, const void* rho_rot,
    const void* rho_trn, const void* Rc, const void* D, const void* Dz,
    const void* g0, const void* Gref, const void* S0, const void* L,
    const void* inc_slot, const void* inc_mask, const void* n_local,
    void* D_out, void* stats, void* tcg_iters, int max_iters, float kappa,
    float theta, float initial_radius, int max_rejections, float grad_tol,
    void* stream) {
  ClusterArgs a = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j, rot, trn,
                            wk, wt, D, Dz, S0, L, g0, inc_slot, inc_mask,
                            n_local, max_iters, kappa, theta);
  a.Rc = static_cast<const float*>(Rc);
  a.Gref = static_cast<const float*>(Gref);
  a.rho_rot = static_cast<const float*>(rho_rot);
  a.rho_trn = static_cast<const float*>(rho_trn);
  float* dout = static_cast<float*>(D_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.refine(a, r, A, C, initial_radius, max_rejections,
                            grad_tol, dout, st, it, cs);
  });
}

// Shared-memory bytes of one CTA of B2 (kernel 0) or B4 (kernel 3) in the
// folded layout at `lanes` lanes a pose.
long long dpgo_rtr_cluster_fold_smem_bytes(int lanes, int r, int d,
                                           int n_max, int kinc, int C,
                                           int kernel) {
  return (long long)fold_shape(r, d, n_max, kinc, C, lanes, kernel == kRefine)
      .smem;
}

// As dpgo_rtr_cluster_max_clusters, for the folded layout (0 clusters
// where one CTA exceeds the card's threads or shared memory); -1 for a
// lane count, d or r (11 <= r <= 32) without instantiation, -4 for a
// kernel other than B2 and B4.
int dpgo_rtr_cluster_fold_max_clusters(int lanes, int r, int d, int n_max,
                                       int kinc, int C, int kernel,
                                       void* count) {
  int* c = static_cast<int*>(count);
  return fold_dispatch(lanes, d, [&](auto launchers) {
    return launchers.query_clusters(kernel, r, n_max, kinc, C, c);
  });
}

int dpgo_rtr_full_cluster_fold_launch(
    int lanes, int r, int d, int C, int A, int n, int s, int Ep, int T,
    int e_max, int kinc, const void* idx_i, const void* idx_j,
    const void* rot, const void* trn, const void* wk, const void* wt,
    const void* X, const void* Z, const void* L, const void* inc_slot,
    const void* inc_mask, const void* n_local, void* X_out, void* stats,
    void* tcg_iters, int max_iters, float kappa, float theta,
    float initial_radius, int max_rejections, float grad_tol, void* stream) {
  const ClusterArgs g = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j,
                                  rot, trn, wk, wt, X, Z, nullptr, L, nullptr,
                                  inc_slot, inc_mask, n_local, max_iters,
                                  kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return fold_dispatch(lanes, d, [&](auto launchers) {
    return launchers.rtr_full(g, r, A, C, initial_radius, max_rejections,
                              grad_tol, xo, st, it, cs);
  });
}

int dpgo_rtr_refine_full_cluster_fold_launch(
    int lanes, int r, int d, int C, int A, int n, int s, int Ep, int T,
    int e_max, int kinc, const void* idx_i, const void* idx_j,
    const void* rot, const void* trn, const void* wk, const void* wt,
    const void* rho_rot, const void* rho_trn, const void* Rc, const void* D,
    const void* Dz, const void* g0, const void* Gref, const void* S0,
    const void* L, const void* inc_slot, const void* inc_mask,
    const void* n_local, void* D_out, void* stats, void* tcg_iters,
    int max_iters, float kappa, float theta, float initial_radius,
    int max_rejections, float grad_tol, void* stream) {
  ClusterArgs a = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j, rot, trn,
                            wk, wt, D, Dz, S0, L, g0, inc_slot, inc_mask,
                            n_local, max_iters, kappa, theta);
  a.Rc = static_cast<const float*>(Rc);
  a.Gref = static_cast<const float*>(Gref);
  a.rho_rot = static_cast<const float*>(rho_rot);
  a.rho_trn = static_cast<const float*>(rho_trn);
  float* dout = static_cast<float*>(D_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return fold_dispatch(lanes, d, [&](auto launchers) {
    return launchers.refine(a, r, A, C, initial_radius, max_rejections,
                            grad_tol, dout, st, it, cs);
  });
}

}  // extern "C"

#endif  // DPGO_PART < 0

}  // namespace dpgo_cluster

// Fused single-step Riemannian trust-region solve of RBCD, for Hopper: the
// workspace route of kernels B1-B4, one CTA per agent, for agents too
// large for any thread-block cluster.  Every agent that fits a cluster
// runs rtr_cluster.cu's kernels instead (ops/rtr_kernel.cluster_plan picks
// the route from the shape before the launch).
//
// Replaces the TPU kernels of dpgo_tpu/ops/pallas_tcg.py:
//   * _rtr_full_kernel (rtr_full_call) -> rtr_full_kernel below: one launch
//     is the whole local solve of every agent for one RBCD round: the
//     Euclidean gradient at [X | Z], the curvature term S = sym(Y^T G_Y), the
//     Riemannian gradient and its norm gn0, the early exit when
//     gn0 < grad_tol, then at most max_rejections attempts of {truncated CG,
//     24-sweep Newton-Schulz polar retraction, cost, accept when rho > 0.1
//     and f did not rise, else radius / 4}.
//   * _rtr_kernel (rtr_call) -> rtr_kernel below: B2's attempt loop alone,
//     from a given Riemannian gradient g and curvature term S: f0 = cost(X),
//     then at most max_rejections attempts from initial_radius, with no
//     gradient sweep and no early exit (the kernel of the round ablation,
//     experiments/measure_r3.py).  It reads B2's operands plus S and g.
//   * _tcg_kernel (tcg_call) -> tcg_kernel below: the Steihaug-Toint
//     truncated CG alone, from a given S and g.
//   * _rtr_refine_full_kernel (rtr_refine_full_call) ->
//     rtr_refine_full_kernel below: the re-centered step of the terminal
//     refinement (models/refine.py).  The variable is a small float32
//     correction D about a reference point Rc that the host holds in
//     float64; the expansion point is Y = Rc + D.  One launch is the whole
//     step of every agent for one refine round: the increment gradient dG
//     at [D | Dz], S1 = sym(D_Y^T Gref_Y + Y_Y^T dG_Y), S = S0 + S1,
//     g = g0 + dG with g_Y -= Rc_Y S1 + D_Y S, gn0, the early exit, the
//     initial radius min(initial_radius, 10 |precond(g)|), then the
//     attempts of B2 with the cost replaced by the increment
//     f(Rc + D) - f(Rc) = sum_e w [<rho, L> + |L|^2 / 2] against the
//     reference residuals rho, and the Newton-Schulz retraction replaced
//     by the four-term polar-correction series on U = D + eta.  Every f32
//     rounding error therefore scales with |D|, never with f or |G|.
//
// What bounds it on this card: neither bytes nor flops.  At the sphere2500
// shape (8 agents) one agent is ~310 poses, ~900 edges and ~25 KB per tCG
// vector; the whole launch moves ~1.6 MB and does ~60 MFLOP, but
// every tCG iteration is a chain of dependent phases (edge sweep, ELL gather,
// per-pose update, block reduction), each ending in a __syncthreads(), and
// the grid is one CTA per agent (8 CTAs on 132 SMs).  The kernel is
// latency-bound: the time is the length of that dependency chain.
//
// What the design does about it: everything that the TPU version expressed
// as one-hot MXU matmuls becomes indexed loads (gathers) and a deterministic
// ELL gather over the per-pose incidence list instead of atomics (so results
// repeat bit for bit from run to run and tCG iteration counts do not flip
// against the plain version); the edge payload of the agent stays in shared
// memory for all sweeps when it fits (up to ~3.6k edges per agent at d = 3)
// and in the per-agent global workspace otherwise; the loop vectors live in
// that workspace, which stays in L2; reductions are a warp-shuffle tree plus
// one shared-memory pass whose result every thread reads in the same order, so
// every loop condition is block-uniform.  The per-pose math (tangent
// projection, the (d+1)x(d+1) preconditioner solves, the Newton-Schulz
// sweeps) is unrolled over the template parameters (R, D).  Spreading one
// agent over several CTAs is what rtr_cluster.cu does.  Above the
// templated ranks (r >= 11, shapes.cuh) the *_rt kernels below read r from
// the launch and walk a pose's rows one at a time, so no thread holds
// r (d + 1) floats and the route has no rank limit of its own; it is the
// catch-all where neither a cluster nor a spread holds an agent: above
// r = 512, where a pose no longer fits the 16 warps of a cluster CTA, it
// takes B1-B4 only where the spread route's folded rows do not fit a
// CTA's shared memory.
//
// The refine kernel is bound the same way: its payload adds r*d + r floats
// of reference residuals per edge (144 B an edge at r = 5, d = 3 instead of
// 64), which still fits in shared memory at the sphere2500 shape (e_max 920,
// ~132 KB) and moves to the global workspace from ~1.6k edges per agent.
//
// Layout (matches the tile-major arrays of models/rbcd.build_graph):
//   idx_i, idx_j  [A, nt, 1, T] int32 into the [n + s] pose buffer; index
//                 n + s is padding and gathers zero, as does any index >= n
//                 in a Hessian sweep (neighbors are constants)
//   rot           [A, nt, D*D, T] f32, component b*D + c = R[b][c]
//   trn           [A, nt, D, T] f32;  wk, wt [A, nt, 1, T] f32
//   X [A, RK, n], Z [A, RK, s], L [A, K*K, n] (lower Cholesky, i*K + p)
//   inc_slot / inc_mask [A, n, Kinc]: ELL incidence into [gi (E) | gj (E)]
//   rho_rot       [A, nt, R*D, T] f32 reference rotation residuals (refine),
//                 component a*D + c;  rho_trn [A, nt, R, T] (refine)
// Only the first E = e_max tile positions carry edges.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shapes.cuh"
#include "smem_limit.cuh"

namespace dpgo_full {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 4;
constexpr float kEps = 1e-30f;
constexpr size_t kRedBytes = kWarps * kMaxSums * sizeof(float);
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kNsSweeps = 24;
constexpr int kVecs = 8;        // per-agent loop vectors of B1/B2
constexpr int kRefineVecs = 9;  // B4 adds the expansion point Y

struct Problem {
  int n, s, E, kinc, n_act;
  const float* X;      // [RK, n]
  const float* Z;      // [RK, s]
  const float* L;      // [K*K, n]
  const float* S;      // [D*D, n]
  const int* inc;      // [n, kinc]
  const float* incm;   // [n, kinc]
  const int* ei;       // payload [E] (shared, or global when too large)
  const int* ej;       // payload [E]
  const float* rot;    // payload [D*D, E]
  const float* trn;    // payload [D, E]
  const float* wk;     // payload [E]
  const float* wt;     // payload [E]
  const float* rho_rot;  // payload [R*D, E] (refine only)
  const float* rho_trn;  // payload [R, E] (refine only)
  float* gbuf;         // global [2E, RK]
  float* red;          // shared [kWarps * kMaxSums]
};

// Block-wide sums of NV values.  Every thread returns the same values:
// lane 0 of each warp publishes its warp's tree sum and every thread adds
// the kWarps partials in the same order.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[i] = x;
  }
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[w * kMaxSums + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float t = 0.f;
    for (int j = 0; j < kWarps; ++j) t += red[j * kMaxSums + i];
    v[i] = t;
  }
}

template <int RK>
__device__ __forceinline__ void load_pose(const float* V, int n, int p,
                                          float (&v)[RK]) {
#pragma unroll
  for (int q = 0; q < RK; ++q) v[q] = V[q * n + p];
}

template <int RK>
__device__ __forceinline__ void store_pose(float* V, int n, int p,
                                           const float (&v)[RK]) {
#pragma unroll
  for (int q = 0; q < RK; ++q) V[q * n + p] = v[q];
}

template <int RK>
__device__ __forceinline__ float dot(const float (&a)[RK],
                                     const float (&b)[RK]) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < RK; ++q) s += a[q] * b[q];
  return s;
}

// W_Y <- W_Y - Y sym(Y^T W_Y); translation rows unchanged.
template <int R, int D>
__device__ __forceinline__ void tangent_project(const float (&x)[R * (D + 1)],
                                                float (&w)[R * (D + 1)]) {
  constexpr int K = D + 1;
  float M[D][D];
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < R; ++a) s += x[a * K + b] * w[a * K + c];
      M[b][c] = s;
    }
  float sy[D][D];
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) sy[b][c] = 0.5f * (M[b][c] + M[c][b]);
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b) s += x[a * K + b] * sy[b][c];
      w[a * K + c] -= s;
    }
}

// Tangent-projected block-Jacobi solve: each row a of the pose block solves
// the (D+1)x(D+1) SPD block from its lower Cholesky factor.
template <int R, int D>
__device__ __forceinline__ void precond(const Problem& P, int p,
                                        const float (&x)[R * (D + 1)],
                                        float (&v)[R * (D + 1)]) {
  constexpr int K = D + 1;
  float Lp[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) Lp[i] = P.L[i * P.n + p];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float y[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float s = v[a * K + i];
#pragma unroll
      for (int q = 0; q < i; ++q) s -= Lp[i * K + q] * y[q];
      y[i] = s / Lp[i * K + i];
    }
    float z[K];
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int q = i + 1; q < K; ++q) s -= Lp[q * K + i] * z[q];
      z[i] = s / Lp[i * K + i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) v[a * K + i] = z[i];
  }
  tangent_project<R, D>(x, v);
}

// Endpoint value of component q: local poses from V, neighbor slots from Zv
// (nullptr in Hessian sweeps), zero for padding.
__device__ __forceinline__ float gather(const float* V, int n, const float* Zv,
                                        int s, int idx, int q) {
  if (idx < n) return V[q * n + idx];
  if (Zv != nullptr && idx < n + s) return Zv[q * s + (idx - n)];
  return 0.f;
}

// Lifted residuals of edge e at the buffer point [V | Zv].
template <int R, int D>
__device__ __forceinline__ void edge_residuals(const Problem& P, int e,
                                               const float* V, const float* Zv,
                                               float (&rR)[R][D],
                                               float (&rt)[R], float (&Rm)[D * D],
                                               float (&t)[D]) {
  constexpr int K = D + 1;
  const int i = P.ei[e];
  const int j = P.ej[e];
#pragma unroll
  for (int c = 0; c < D * D; ++c) Rm[c] = P.rot[c * P.E + e];
#pragma unroll
  for (int c = 0; c < D; ++c) t[c] = P.trn[c * P.E + e];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float vi[K], vj[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      vi[c] = gather(V, P.n, Zv, P.s, i, a * K + c);
      vj[c] = gather(V, P.n, Zv, P.s, j, a * K + c);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b) s += vi[b] * Rm[b * D + c];
      rR[a][c] = vj[c] - s;
    }
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += vi[b] * t[b];
    rt[a] = vj[D] - vi[D] - s;
  }
}

// Edge sweep: per-edge endpoint gradient rows into gbuf (gi at row e,
// gj at row E + e), then an ELL gather of the local rows into out [RK, n].
template <int R, int D>
__device__ void grad_sweep(const Problem& P, const float* V, const float* Zv,
                           float* out) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    float rR[R][D], rt[R], Rm[D * D], t[D];
    edge_residuals<R, D>(P, e, V, Zv, rR, rt, Rm, t);
    const float wk = P.wk[e];
    const float wt = P.wt[e];
    float* gi = P.gbuf + (size_t)e * RK;
    float* gj = P.gbuf + (size_t)(P.E + e) * RK;
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) s += rR[a][b] * Rm[c * D + b];
        gj[a * K + c] = wk * rR[a][c];
        gi[a * K + c] = -wk * s - wt * rt[a] * t[c];
      }
      gj[a * K + D] = wt * rt[a];
      gi[a * K + D] = -wt * rt[a];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P.n; p += blockDim.x) {
    float acc[RK];
#pragma unroll
    for (int q = 0; q < RK; ++q) acc[q] = 0.f;
    for (int c = 0; c < P.kinc; ++c) {
      if (P.incm[p * P.kinc + c] != 0.f) {
        const float* row = P.gbuf + (size_t)P.inc[p * P.kinc + c] * RK;
#pragma unroll
        for (int q = 0; q < RK; ++q) acc[q] += row[q];
      }
    }
    store_pose<RK>(out, P.n, p, acc);
  }
  __syncthreads();
}

// f over the buffer [V | Zv]: 0.5 sum_e (wk ||rR||^2 + wt ||rt||^2).
template <int R, int D>
__device__ float cost(const Problem& P, const float* V, const float* Zv) {
  float acc[1] = {0.f};
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    float rR[R][D], rt[R], Rm[D * D], t[D];
    edge_residuals<R, D>(P, e, V, Zv, rR, rt, Rm, t);
    float sR = 0.f, st = 0.f;
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < D; ++c) sR += rR[a][c] * rR[a][c];
      st += rt[a] * rt[a];
    }
    acc[0] += P.wk[e] * sR + P.wt[e] * st;
  }
  block_sum<1>(acc, P.red);
  return 0.5f * acc[0];
}

// Refine mode: f(Rc + V) - f(Rc) over the buffer [V | Zv], the cross term
// against the reference residuals plus half the quadratic term
// (pallas_tcg._build_math.cost with refine set).
template <int R, int D>
__device__ float refine_cost(const Problem& P, const float* V,
                             const float* Zv) {
  float acc[1] = {0.f};
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    float rR[R][D], rt[R], Rm[D * D], t[D];
    edge_residuals<R, D>(P, e, V, Zv, rR, rt, Rm, t);
    float cR = 0.f, ct = 0.f, qR = 0.f, qt = 0.f;
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        cR += P.rho_rot[(a * D + c) * P.E + e] * rR[a][c];
        qR += rR[a][c] * rR[a][c];
      }
      ct += P.rho_trn[a * P.E + e] * rt[a];
      qt += rt[a] * rt[a];
    }
    const float wk = P.wk[e];
    const float wt = P.wt[e];
    acc[0] += wk * cR + wt * ct + 0.5f * (wk * qR + wt * qt);
  }
  block_sum<1>(acc, P.red);
  return acc[0];
}

struct TcgVecs {
  float *eta, *heta, *rr, *z, *delta, *hd;
};

// Steihaug-Toint truncated CG (pallas_tcg._build_math.tcg).  Returns the
// iteration count; *hit is set when the trust-region boundary (or negative
// curvature) stopped it.
template <int R, int D>
__device__ int tcg(const Problem& P, const float* g, float radius,
                   int max_iters, float kappa, float theta, const TcgVecs& W,
                   bool* hit_out) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  const int n = P.n;
  float s2[2] = {0.f, 0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float x[RK], v[RK], zz[RK], zero[RK];
    load_pose<RK>(P.X, n, p, x);
    load_pose<RK>(g, n, p, v);
    store_pose<RK>(W.rr, n, p, v);
#pragma unroll
    for (int q = 0; q < RK; ++q) {
      zz[q] = v[q];
      zero[q] = 0.f;
    }
    precond<R, D>(P, p, x, zz);
    store_pose<RK>(W.z, n, p, zz);
    s2[0] += dot<RK>(v, zz);
    s2[1] += dot<RK>(v, v);
#pragma unroll
    for (int q = 0; q < RK; ++q) zz[q] = -zz[q];
    store_pose<RK>(W.delta, n, p, zz);
    store_pose<RK>(W.eta, n, p, zero);
    store_pose<RK>(W.heta, n, p, zero);
  }
  block_sum<2>(s2, P.red);
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
  bool hit = false;
  while (k < max_iters && !done) {
    // Hd = P_X(EucHess[delta] - [delta_Y S | 0])
    grad_sweep<R, D>(P, W.delta, nullptr, W.hd);
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float x[RK], dl[RK], h[RK], et[RK];
      load_pose<RK>(P.X, n, p, x);
      load_pose<RK>(W.delta, n, p, dl);
      load_pose<RK>(W.hd, n, p, h);
      float Sp[D * D];
#pragma unroll
      for (int i = 0; i < D * D; ++i) Sp[i] = P.S[i * n + p];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float s = 0.f;
#pragma unroll
          for (int b = 0; b < D; ++b) s += dl[a * K + b] * Sp[b * D + c];
          h[a * K + c] -= s;
        }
      tangent_project<R, D>(x, h);
      store_pose<RK>(W.hd, n, p, h);
      load_pose<RK>(W.eta, n, p, et);
      s4[0] += dot<RK>(dl, h);
      s4[1] += dot<RK>(et, et);
      s4[2] += dot<RK>(et, dl);
      s4[3] += dot<RK>(dl, dl);
    }
    block_sum<4>(s4, P.red);
    const float d_hd = s4[0], e_e = s4[1], e_d = s4[2], d_d = s4[3];
    const float alpha = rz / (fabsf(d_hd) < kEps ? kEps : d_hd);
    const float e_e_next = e_e + 2.f * alpha * e_d + alpha * alpha * d_d;
    const bool crossing = (d_hd <= 0.f) || (e_e_next >= rad2);
    const float disc = fmaxf(e_d * e_d + d_d * (rad2 - e_e), 0.f);
    const float tau = (-e_d + sqrtf(disc)) / (d_d < kEps ? kEps : d_d);
    const float step = crossing ? tau : alpha;

    s2[0] = 0.f;
    s2[1] = 0.f;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float x[RK], dl[RK], h[RK], v[RK], zz[RK];
      load_pose<RK>(P.X, n, p, x);
      load_pose<RK>(W.delta, n, p, dl);
      load_pose<RK>(W.hd, n, p, h);
      load_pose<RK>(W.eta, n, p, v);
#pragma unroll
      for (int q = 0; q < RK; ++q) v[q] += step * dl[q];
      store_pose<RK>(W.eta, n, p, v);
      load_pose<RK>(W.heta, n, p, v);
#pragma unroll
      for (int q = 0; q < RK; ++q) v[q] += step * h[q];
      store_pose<RK>(W.heta, n, p, v);
      load_pose<RK>(W.rr, n, p, v);
#pragma unroll
      for (int q = 0; q < RK; ++q) {
        v[q] += alpha * h[q];
        zz[q] = v[q];
      }
      store_pose<RK>(W.rr, n, p, v);
      precond<R, D>(P, p, x, zz);
      store_pose<RK>(W.z, n, p, zz);
      s2[0] += dot<RK>(v, zz);
      s2[1] += dot<RK>(v, v);
    }
    block_sum<2>(s2, P.red);
    const float rz_in = s2[0];
    const bool converged = sqrtf(s2[1]) <= target;
    const float beta = rz_in / (fabsf(rz) < kEps ? kEps : rz);
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float dl[RK], zz[RK];
      load_pose<RK>(W.delta, n, p, dl);
      load_pose<RK>(W.z, n, p, zz);
#pragma unroll
      for (int q = 0; q < RK; ++q) dl[q] = -zz[q] + beta * dl[q];
      store_pose<RK>(W.delta, n, p, dl);
    }
    __syncthreads();
    rz = rz_in;
    ++k;
    done = crossing || converged;
    hit = hit || crossing;
  }
  *hit_out = hit;
  return k;
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

// R_X(V): Newton-Schulz polar factor of (Y + V_Y), translations added.
// Poses at or past the agent's own count (padding) are left untouched.
template <int R, int D>
__device__ void retract(const Problem& P, const float* V, float* out) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  const int n = P.n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float x[RK], v[RK];
    load_pose<RK>(P.X, n, p, x);
    if (p >= P.n_act) {
      store_pose<RK>(out, n, p, x);
      continue;
    }
    load_pose<RK>(V, n, p, v);
    float M[R][D];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < D; ++c) M[a][c] = x[a * K + c] + v[a * K + c];
    float Y[D][D], Zm[D][D], T[D][D], tmp[D][D];
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < R; ++a) acc += M[a][b] * M[a][c];
        Y[b][c] = acc;
      }
#pragma unroll
    for (int b = 0; b < D; ++b) s += Y[b][b];
    s = fmaxf(s, 1e-37f);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        Y[b][c] = Y[b][c] / s;
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
    float o[RK];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) acc += M[a][b] * Zm[b][c];
        o[a * K + c] = acc * inv;
      }
      o[a * K + D] = x[a * K + D] + v[a * K + D];
    }
    store_pose<RK>(out, n, p, o);
  }
  __syncthreads();
}

// Refine mode: D_new with Rc + D_new = polar(Rc + D + V), from the small
// quantities only (pallas_tcg._build_math.retract_refine): U = D + V,
// E = sym(Rc^T U + U^T Rc + U^T U) (Rc^T Rc = I, projected in float64 on
// the host), C = -E/2 + 3/8 E^2 - 5/16 E^3 + 35/128 E^4 ~ (I + E)^(-1/2) - I,
// D_new_Y = U_Y + (Rc_Y + U_Y) C, D_new_t = U_t.  Poses at or past the
// agent's own count keep their D.
template <int R, int D>
__device__ void retract_refine(const Problem& P, const float* Rc,
                               const float* Dv, const float* V, float* out) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  const int n = P.n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float u[RK];
    load_pose<RK>(Dv, n, p, u);
    if (p >= P.n_act) {
      store_pose<RK>(out, n, p, u);
      continue;
    }
    float rc[RK], v[RK];
    load_pose<RK>(Rc, n, p, rc);
    load_pose<RK>(V, n, p, v);
#pragma unroll
    for (int q = 0; q < RK; ++q) u[q] += v[q];
    float M[D][D], E[D][D], E2[D][D], E3[D][D], E4[D][D];
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < R; ++a)
          s += rc[a * K + b] * u[a * K + c] + u[a * K + b] * rc[a * K + c] +
               u[a * K + b] * u[a * K + c];
        M[b][c] = s;
      }
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) E[b][c] = 0.5f * (M[b][c] + M[c][b]);
    matmul3<D>(E, E, E2);
    matmul3<D>(E2, E, E3);
    matmul3<D>(E2, E2, E4);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c)
        M[b][c] = -0.5f * E[b][c] + 0.375f * E2[b][c] -
                  0.3125f * E3[b][c] + 0.2734375f * E4[b][c];
    float o[RK];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b)
          s += (rc[a * K + b] + u[a * K + b]) * M[b][c];
        o[a * K + c] = u[a * K + c] + s;
      }
      o[a * K + D] = u[a * K + D];
    }
    store_pose<RK>(out, n, p, o);
  }
  __syncthreads();
}

// Layout of one agent's edge payload (payload_bytes), in shared memory or
// in the global workspace; the refine kernel's reference residuals follow
// the edge transforms and weights.
template <int R, int D>
__device__ void load_edges(Problem& P, unsigned char* payload, int a, int Ep,
                           int T, const int* idx_i, const int* idx_j,
                           const float* rot, const float* trn,
                           const float* wk, const float* wt,
                           const float* rho_rot, const float* rho_trn) {
  const int E = P.E;
  int* ei = reinterpret_cast<int*>(payload);
  int* ej = ei + E;
  float* srot = reinterpret_cast<float*>(ej + E);
  float* strn = srot + D * D * E;
  float* swk = strn + D * E;
  float* swt = swk + E;
  float* srr = swt + E;
  float* srt = srr + R * D * E;
  const int nt = Ep / T;
  const size_t base = (size_t)a * Ep;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int tl = e / T;
    const int ln = e - tl * T;
    const size_t tile = (size_t)a * nt + tl;
    ei[e] = idx_i[base + e];
    ej[e] = idx_j[base + e];
    swk[e] = wk[base + e];
    swt[e] = wt[base + e];
#pragma unroll
    for (int c = 0; c < D * D; ++c)
      srot[c * E + e] = rot[(tile * (D * D) + c) * T + ln];
#pragma unroll
    for (int c = 0; c < D; ++c)
      strn[c * E + e] = trn[(tile * D + c) * T + ln];
    if (rho_rot != nullptr) {
#pragma unroll
      for (int c = 0; c < R * D; ++c)
        srr[c * E + e] = rho_rot[(tile * (R * D) + c) * T + ln];
#pragma unroll
      for (int c = 0; c < R; ++c)
        srt[c * E + e] = rho_trn[(tile * R + c) * T + ln];
    }
  }
  P.ei = ei;
  P.ej = ej;
  P.rot = srot;
  P.trn = strn;
  P.wk = swk;
  P.wt = swt;
  P.rho_rot = srr;
  P.rho_trn = srt;
  __syncthreads();
}

}  // namespace

// The launchers' arguments: types every translation unit of this source
// shares (see shapes.cuh).
struct Args {
  int A, n, s, Ep, T, E, kinc;
  int payload_in_smem;  // else the payload follows gbuf in the workspace
  const int* idx_i;
  const int* idx_j;
  const float* rot;
  const float* trn;
  const float* wk;
  const float* wt;
  const float* rho_rot;  // refine only, else nullptr
  const float* rho_trn;
  const float* X;
  const float* Z;
  const float* L;
  const int* inc;
  const float* incm;
  const int* n_local;
  float* ws;
  long long ws_stride;
  int max_iters;
  float kappa, theta;
};

namespace {

template <int R, int D>
__device__ Problem setup(const Args& g, unsigned char* smem, int a,
                         float** vecs, int nvec) {
  constexpr int RK = R * (D + 1);
  Problem P;
  P.n = g.n;
  P.s = g.s;
  P.E = g.E;
  P.kinc = g.kinc;
  P.n_act = g.n_local[a];
  P.X = g.X + (size_t)a * RK * g.n;
  P.Z = g.Z + (size_t)a * RK * g.s;
  P.L = g.L + (size_t)a * (D + 1) * (D + 1) * g.n;
  P.inc = g.inc + (size_t)a * g.n * g.kinc;
  P.incm = g.incm + (size_t)a * g.n * g.kinc;
  float* ws = g.ws + (size_t)a * g.ws_stride;
  const size_t vec = (size_t)RK * g.n;
  for (int i = 0; i < nvec; ++i) vecs[i] = ws + i * vec;
  float* S = ws + nvec * vec;
  P.S = S;
  P.gbuf = S + (size_t)D * D * g.n;
  P.red = reinterpret_cast<float*>(smem);
  unsigned char* payload =
      g.payload_in_smem
          ? smem + kRedBytes
          : reinterpret_cast<unsigned char*>(P.gbuf + 2 * (size_t)g.E * RK);
  load_edges<R, D>(P, payload, a, g.Ep, g.T, g.idx_i, g.idx_j, g.rot, g.trn,
                   g.wk, g.wt, g.rho_rot, g.rho_trn);
  return P;
}

struct Attempts {
  int k_att;
  bool accepted;
  float f_best;
  int iters;
};

// The attempt loop of B2 and B3 (pallas_tcg._rtr_kernel :635-655): from
// k_att attempts already spent, at most max_rejections attempts of {tCG at
// the radius, retraction into xp, cost; accept (xp copied into xo) when
// rho > 0.1 and f did not rise, else radius / 4}.  xo holds X on entry.
template <int R, int D>
__device__ Attempts attempts(const Problem& P, const float* g,
                             const TcgVecs& W, float* xp, float* xo, float f0,
                             int k_att, float radius, int max_rejections,
                             const Args& args) {
  constexpr int RK = R * (D + 1);
  const int n = P.n;
  Attempts at{k_att, false, f0, 0};
  while (at.k_att < max_rejections && !at.accepted) {
    bool hit;
    at.iters += tcg<R, D>(P, g, radius, args.max_iters, args.kappa,
                          args.theta, W, &hit);
    retract<R, D>(P, W.eta, xp);
    const float f_prop = cost<R, D>(P, xp, P.Z);
    float m2[2] = {0.f, 0.f};
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float gv[RK], et[RK], he[RK];
      load_pose<RK>(g, n, p, gv);
      load_pose<RK>(W.eta, n, p, et);
      load_pose<RK>(W.heta, n, p, he);
      m2[0] += dot<RK>(gv, et);
      m2[1] += dot<RK>(et, he);
    }
    block_sum<2>(m2, P.red);
    const float mdec = -(m2[0] + 0.5f * m2[1]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        float x[RK];
        load_pose<RK>(xp, n, p, x);
        store_pose<RK>(xo, n, p, x);
      }
      at.f_best = f_prop;
    } else {
      radius = radius / 4.f;
    }
    ++at.k_att;
    at.accepted = ok;
    __syncthreads();
  }
  return at;
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads)
rtr_full_kernel(Args args, float initial_radius, int max_rejections,
                float grad_tol, float* X_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kVecs];
  Problem P = setup<R, D>(args, smem, a, v, kVecs);
  float* g = v[0];
  float* xp = v[7];
  TcgVecs W{v[1], v[2], v[3], v[4], v[5], v[6]};
  float* xo = X_out + (size_t)a * RK * P.n;
  float* S = const_cast<float*>(P.S);
  const int n = P.n;

  // Start point: G = egrad([X | Z]) into W.hd, S = sym(Y^T G_Y), g = P_X(G).
  grad_sweep<R, D>(P, P.X, P.Z, W.hd);
  float gg[1] = {0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float x[RK], G[RK];
    load_pose<RK>(P.X, n, p, x);
    load_pose<RK>(W.hd, n, p, G);
    store_pose<RK>(xo, n, p, x);
    float M[D][D];
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q) s += x[q * K + b] * G[q * K + c];
        M[b][c] = s;
      }
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c)
        S[(b * D + c) * n + p] = 0.5f * (M[b][c] + M[c][b]);
    tangent_project<R, D>(x, G);
    store_pose<RK>(g, n, p, G);
    gg[0] += dot<RK>(G, G);
  }
  block_sum<1>(gg, P.red);
  const float gn0 = sqrtf(gg[0]);
  const float f0 = cost<R, D>(P, P.X, P.Z);

  const Attempts at =
      attempts<R, D>(P, g, W, xp, xo, f0, (gn0 < grad_tol) ? max_rejections : 0,
                     initial_radius, max_rejections, args);
  if (threadIdx.x == 0) {
    float* st = stats + (size_t)a * 5;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    st[4] = gn0;
    tcg_iters[a] = at.iters;
  }
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads)
rtr_kernel(Args args, const float* Sc, const float* gc, float initial_radius,
           int max_rejections, float* X_out, float* stats, int* tcg_iters) {
  constexpr int RK = R * (D + 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kVecs];
  Problem P = setup<R, D>(args, smem, a, v, kVecs);
  const int n = P.n;
  const size_t off = (size_t)a * RK * n;
  P.S = Sc + (size_t)a * D * D * n;
  const float* g = gc + off;
  float* xp = v[7];
  TcgVecs W{v[1], v[2], v[3], v[4], v[5], v[6]};
  float* xo = X_out + off;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float x[RK];
    load_pose<RK>(P.X, n, p, x);
    store_pose<RK>(xo, n, p, x);
  }
  const float f0 = cost<R, D>(P, P.X, P.Z);
  const Attempts at = attempts<R, D>(P, g, W, xp, xo, f0, 0, initial_radius,
                                     max_rejections, args);
  if (threadIdx.x == 0) {
    float* st = stats + (size_t)a * 4;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    tcg_iters[a] = at.iters;
  }
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads)
tcg_kernel(Args args, const float* Sc, const float* gc, const float* radius,
           float* eta_out, float* heta_out, float* stats) {
  constexpr int RK = R * (D + 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kVecs];
  Problem P = setup<R, D>(args, smem, a, v, kVecs);
  P.S = Sc + (size_t)a * D * D * P.n;
  const size_t off = (size_t)a * RK * P.n;
  TcgVecs W{eta_out + off, heta_out + off, v[3], v[4], v[5], v[6]};
  bool hit;
  const int k = tcg<R, D>(P, gc + off, radius[a], args.max_iters, args.kappa,
                          args.theta, W, &hit);
  if (threadIdx.x == 0) {
    stats[(size_t)a * 2] = (float)k;
    stats[(size_t)a * 2 + 1] = hit ? 1.f : 0.f;
  }
}

}  // namespace

// Per-recenter constants of the refine kernel, [A, ...] component-major.
struct RefineConsts {
  const float* Rc;    // [RK, n] reference point
  const float* g0;    // [RK, n] Riemannian gradient at Rc
  const float* Gref;  // [RK, n] Euclidean gradient at Rc
  const float* S0;    // [D*D, n] sym(Rc_Y^T Gref_Y)
};

namespace {

// Args.X is the correction D and Args.Z its neighbor slots Dz.
template <int R, int D>
__global__ void __launch_bounds__(kThreads)
rtr_refine_full_kernel(Args args, RefineConsts rc, float initial_radius,
                       int max_rejections, float grad_tol, float* D_out,
                       float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kRefineVecs];
  Problem P = setup<R, D>(args, smem, a, v, kRefineVecs);
  const int n = P.n;
  const size_t off = (size_t)a * RK * n;
  const float* Dst = P.X;
  const float* Rc = rc.Rc + off;
  const float* g0 = rc.g0 + off;
  const float* Gref = rc.Gref + off;
  const float* S0 = rc.S0 + (size_t)a * D * D * n;
  float* g = v[0];
  float* dp = v[7];
  float* Y = v[8];
  TcgVecs W{v[1], v[2], v[3], v[4], v[5], v[6]};
  float* dout = D_out + off;
  float* S = const_cast<float*>(P.S);

  // dG = egrad([D | Dz]) into W.hd (the residual map is affine with this
  // linear part), then Y, S = S0 + S1 and the re-centered gradient g.
  grad_sweep<R, D>(P, Dst, P.Z, W.hd);
  float gg[1] = {0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float dd[RK], y[RK], G[RK], Gr[RK], gv[RK];
    load_pose<RK>(Dst, n, p, dd);
    load_pose<RK>(Rc, n, p, y);
    load_pose<RK>(W.hd, n, p, G);
    load_pose<RK>(Gref, n, p, Gr);
    load_pose<RK>(g0, n, p, gv);
    store_pose<RK>(dout, n, p, dd);
    float S1[D][D], St[D][D];
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q)
          s += dd[q * K + b] * Gr[q * K + c] +
               (y[q * K + b] + dd[q * K + b]) * G[q * K + c];
        S1[b][c] = s;  // M1 for now
      }
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = b; c < D; ++c) {
        const float sy = 0.5f * (S1[b][c] + S1[c][b]);
        S1[b][c] = sy;
        S1[c][b] = sy;
      }
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        St[b][c] = S0[(b * D + c) * n + p] + S1[b][c];
        S[(b * D + c) * n + p] = St[b][c];
      }
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b)
          s += y[q * K + b] * S1[b][c] + dd[q * K + b] * St[b][c];
        gv[q * K + c] = gv[q * K + c] + G[q * K + c] - s;
      }
      gv[q * K + D] = gv[q * K + D] + G[q * K + D];
    }
    store_pose<RK>(g, n, p, gv);
    gg[0] += dot<RK>(gv, gv);
#pragma unroll
    for (int q = 0; q < RK; ++q) y[q] += dd[q];
    store_pose<RK>(Y, n, p, y);
  }
  block_sum<1>(gg, P.red);
  const float gn0 = sqrtf(gg[0]);
  P.X = Y;  // projections, curvature and preconditioner are taken at Y

  // Initial radius at the preconditioned-gradient (Cauchy) scale.
  float pp[1] = {0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float y[RK], pg[RK];
    load_pose<RK>(Y, n, p, y);
    load_pose<RK>(g, n, p, pg);
    precond<R, D>(P, p, y, pg);
    pp[0] += dot<RK>(pg, pg);
  }
  block_sum<1>(pp, P.red);
  float radius = fminf(initial_radius, 10.f * sqrtf(pp[0]));
  const float f0 = refine_cost<R, D>(P, Dst, P.Z);

  int k_att = (gn0 < grad_tol) ? max_rejections : 0;
  float f_best = f0;
  bool accepted = false;
  int iters = 0;
  while (k_att < max_rejections && !accepted) {
    bool hit;
    iters += tcg<R, D>(P, g, radius, args.max_iters, args.kappa, args.theta,
                       W, &hit);
    retract_refine<R, D>(P, Rc, Dst, W.eta, dp);
    const float f_prop = refine_cost<R, D>(P, dp, P.Z);
    float m2[2] = {0.f, 0.f};
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float gv[RK], et[RK], he[RK];
      load_pose<RK>(g, n, p, gv);
      load_pose<RK>(W.eta, n, p, et);
      load_pose<RK>(W.heta, n, p, he);
      m2[0] += dot<RK>(gv, et);
      m2[1] += dot<RK>(et, he);
    }
    block_sum<2>(m2, P.red);
    const float mdec = -(m2[0] + 0.5f * m2[1]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        float x[RK];
        load_pose<RK>(dp, n, p, x);
        store_pose<RK>(dout, n, p, x);
      }
      f_best = f_prop;
    } else {
      radius = radius / 4.f;
    }
    ++k_att;
    accepted = ok;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float* st = stats + (size_t)a * 5;
    st[0] = (float)k_att;
    st[1] = accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = f_best;
    st[4] = gn0;
    tcg_iters[a] = iters;
  }
}

// ---------------------------------------------------------------------------
// The rank-generic instantiation (R = 0, any r >= 11; shapes.cuh): the
// same kernels with r read from the launch.  A thread still owns whole
// poses (and edges), but never holds a pose's r (d + 1) floats: it walks
// the rows one at a time, d + 1 floats each, through the workspace.  Where
// the rows meet (sym(Y^T W) of a tangent projection, M^T M of a retraction,
// E of the refine step's), a first pass over the rows sums the d x d matrix
// and a second pass applies it, reading each row again (the loop vectors
// stay in L2).  Every sum keeps one fixed order.
// ---------------------------------------------------------------------------

// setup and load_edges at rank r.
template <int D>
__device__ void load_edges_rt(Problem& P, unsigned char* payload, int a,
                              int Ep, int T, const int* idx_i,
                              const int* idx_j, const float* rot,
                              const float* trn, const float* wk,
                              const float* wt, const float* rho_rot,
                              const float* rho_trn, int r) {
  const int rr = r;
  const int E = P.E;
  int* ei = reinterpret_cast<int*>(payload);
  int* ej = ei + E;
  float* srot = reinterpret_cast<float*>(ej + E);
  float* strn = srot + D * D * E;
  float* swk = strn + D * E;
  float* swt = swk + E;
  float* srr = swt + E;
  float* srt = srr + (size_t)rr * D * E;
  const int nt = Ep / T;
  const size_t base = (size_t)a * Ep;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int tl = e / T;
    const int ln = e - tl * T;
    const size_t tile = (size_t)a * nt + tl;
    ei[e] = idx_i[base + e];
    ej[e] = idx_j[base + e];
    swk[e] = wk[base + e];
    swt[e] = wt[base + e];
#pragma unroll
    for (int c = 0; c < D * D; ++c)
      srot[c * E + e] = rot[(tile * (D * D) + c) * T + ln];
#pragma unroll
    for (int c = 0; c < D; ++c)
      strn[c * E + e] = trn[(tile * D + c) * T + ln];
    if (rho_rot != nullptr) {
      // The payload's [r D][E] and [r][E] columns stepped by E: r D E
      // passes 2^31 on agents of many edges at high rank.
      float* col = srr + e;
#pragma unroll
      for (int c = 0; c < rr * D; ++c, col += E)
        *col = rho_rot[(tile * (rr * D) + c) * T + ln];
      col = srt + e;
#pragma unroll
      for (int c = 0; c < rr; ++c, col += E)
        *col = rho_trn[(tile * rr + c) * T + ln];
    }
  }
  P.ei = ei;
  P.ej = ej;
  P.rot = srot;
  P.trn = strn;
  P.wk = swk;
  P.wt = swt;
  P.rho_rot = srr;
  P.rho_trn = srt;
  __syncthreads();
}

template <int D>
__device__ Problem setup_rt(const Args& g, int r, unsigned char* smem,
                            int a, float** vecs, int nvec) {
  const int RK = r * (D + 1);
  Problem P;
  P.n = g.n;
  P.s = g.s;
  P.E = g.E;
  P.kinc = g.kinc;
  P.n_act = g.n_local[a];
  P.X = g.X + (size_t)a * RK * g.n;
  P.Z = g.Z + (size_t)a * RK * g.s;
  P.L = g.L + (size_t)a * (D + 1) * (D + 1) * g.n;
  P.inc = g.inc + (size_t)a * g.n * g.kinc;
  P.incm = g.incm + (size_t)a * g.n * g.kinc;
  float* ws = g.ws + (size_t)a * g.ws_stride;
  const size_t vec = (size_t)RK * g.n;
  for (int i = 0; i < nvec; ++i) vecs[i] = ws + i * vec;
  float* S = ws + nvec * vec;
  P.S = S;
  P.gbuf = S + (size_t)D * D * g.n;
  P.red = reinterpret_cast<float*>(smem);
  unsigned char* payload =
      g.payload_in_smem
          ? smem + kRedBytes
          : reinterpret_cast<unsigned char*>(P.gbuf + 2 * (size_t)g.E * RK);
  load_edges_rt<D>(P, payload, a, g.Ep, g.T, g.idx_i, g.idx_j, g.rot,
                   g.trn, g.wk, g.wt, g.rho_rot, g.rho_trn, r);
  return P;
}

// Row a of pose p of the component-major vector V [r K, n].
template <int K>
__device__ __forceinline__ void ld_prow(const float* V, int n, int p, int a,
                                        float (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = V[(a * K + q) * n + p];
}

template <int K>
__device__ __forceinline__ void st_prow(float* V, int n, int p, int a,
                                        const float (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) V[(a * K + q) * n + p] = v[q];
}

// sym(sum_a X_a^T W_a) over the r rows of pose p, rotation columns only.
template <int D>
__device__ void sym_rows(const float* X, const float* W, int n, int p, int r,
                         float (&sy)[D * D]) {
  constexpr int K = D + 1;
  float M[D][D];
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) M[b][c] = 0.f;
  for (int a = 0; a < r; ++a) {
    float x[K], w[K];
    ld_prow<K>(X, n, p, a, x);
    ld_prow<K>(W, n, p, a, w);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) M[b][c] += x[b] * w[c];
  }
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = 0; c < D; ++c) sy[b * D + c] = 0.5f * (M[b][c] + M[c][b]);
}

// w <- w - x sy on one row (translation unchanged).
template <int D>
__device__ __forceinline__ void sub_row(const float (&x)[D + 1],
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

// One row's block-Jacobi solve from pose p's lower Cholesky factor Lp
// (precond's arithmetic, without the projection).
template <int D>
__device__ __forceinline__ void chol_row(const float (&Lp)[(D + 1) * (D + 1)],
                                         float (&v)[D + 1]) {
  constexpr int K = D + 1;
  float y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = v[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= Lp[i * K + q] * y[q];
    y[i] = s / Lp[i * K + i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < K; ++q) s -= Lp[q * K + i] * v[q];
    v[i] = s / Lp[i * K + i];
  }
}

template <int D>
__device__ __forceinline__ void ld_factor(const Problem& P, int p,
                                          float (&Lp)[(D + 1) * (D + 1)]) {
#pragma unroll
  for (int i = 0; i < (D + 1) * (D + 1); ++i) Lp[i] = P.L[i * P.n + p];
}

// Edge e's transform, read once for all its rows.
template <int D>
__device__ __forceinline__ void edge_consts(const Problem& P, int e,
                                            float (&Rm)[D * D],
                                            float (&t)[D]) {
#pragma unroll
  for (int c = 0; c < D * D; ++c) Rm[c] = P.rot[c * P.E + e];
#pragma unroll
  for (int c = 0; c < D; ++c) t[c] = P.trn[c * P.E + e];
}

// Row a of the lifted residuals of the edge (i, j) at the buffer point
// [V | Zv] (edge_residuals' arithmetic for one row).
template <int D>
__device__ __forceinline__ void edge_row(const Problem& P, int i, int j,
                                         int a, const float* V,
                                         const float* Zv,
                                         const float (&Rm)[D * D],
                                         const float (&t)[D], float (&rR)[D],
                                         float& rt) {
  constexpr int K = D + 1;
  float vi[K], vj[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    vi[c] = gather(V, P.n, Zv, P.s, i, a * K + c);
    vj[c] = gather(V, P.n, Zv, P.s, j, a * K + c);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += vi[b] * Rm[b * D + c];
    rR[c] = vj[c] - s;
  }
  float s = 0.f;
#pragma unroll
  for (int b = 0; b < D; ++b) s += vi[b] * t[b];
  rt = vj[D] - vi[D] - s;
}

// grad_sweep at rank r: the edge pass writes each edge's rows one at a
// time, the ELL gather sums each pose's rows one at a time.
template <int D>
__device__ void grad_sweep_rt(const Problem& P, int r, const float* V,
                              const float* Zv, float* out) {
  constexpr int K = D + 1;
  const int RK = r * K;
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    float Rm[D * D], t[D];
    edge_consts<D>(P, e, Rm, t);
    const int i = P.ei[e];
    const int j = P.ej[e];
    const float wk = P.wk[e];
    const float wt = P.wt[e];
    float* gi = P.gbuf + (size_t)e * RK;
    float* gj = P.gbuf + (size_t)(P.E + e) * RK;
    for (int a = 0; a < r; ++a) {
      float rR[D], rt;
      edge_row<D>(P, i, j, a, V, Zv, Rm, t, rR, rt);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) s += rR[b] * Rm[c * D + b];
        gj[a * K + c] = wk * rR[c];
        gi[a * K + c] = -wk * s - wt * rt * t[c];
      }
      gj[a * K + D] = wt * rt;
      gi[a * K + D] = -wt * rt;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P.n; p += blockDim.x) {
    for (int a = 0; a < r; ++a) {
      float acc[K];
#pragma unroll
      for (int q = 0; q < K; ++q) acc[q] = 0.f;
      for (int c = 0; c < P.kinc; ++c) {
        if (P.incm[p * P.kinc + c] != 0.f) {
          const float* row =
              P.gbuf + (size_t)P.inc[p * P.kinc + c] * RK + a * K;
#pragma unroll
          for (int q = 0; q < K; ++q) acc[q] += row[q];
        }
      }
      st_prow<K>(out, P.n, p, a, acc);
    }
  }
  __syncthreads();
}

// cost (REFINE false) or refine_cost (true) at rank r, row by row.
template <int D, bool REFINE>
__device__ float cost_rt(const Problem& P, int r, const float* V,
                         const float* Zv) {
  float acc[1] = {0.f};
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    float Rm[D * D], t[D];
    edge_consts<D>(P, e, Rm, t);
    const int i = P.ei[e];
    const int j = P.ej[e];
    float cR = 0.f, ct = 0.f, qR = 0.f, qt = 0.f;
    for (int a = 0; a < r; ++a) {
      float rR[D], rt;
      edge_row<D>(P, i, j, a, V, Zv, Rm, t, rR, rt);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        if (REFINE) cR += P.rho_rot[((size_t)a * D + c) * P.E + e] * rR[c];
        qR += rR[c] * rR[c];
      }
      if (REFINE) ct += P.rho_trn[(size_t)a * P.E + e] * rt;
      qt += rt * rt;
    }
    const float wk = P.wk[e];
    const float wt = P.wt[e];
    acc[0] += REFINE ? wk * cR + wt * ct + 0.5f * (wk * qR + wt * qt)
                     : wk * qR + wt * qt;
  }
  block_sum<1>(acc, P.red);
  return REFINE ? acc[0] : 0.5f * acc[0];
}

// tcg at rank r: the same iteration, each preconditioner solve row by row
// into W.z and projected by a second pass over the pose's rows.
template <int D>
__device__ int tcg_rt(const Problem& P, int r, const float* g, float radius,
                      int max_iters, float kappa, float theta,
                      const TcgVecs& W, bool* hit_out) {
  constexpr int K = D + 1;
  const int n = P.n;
  float s2[2] = {0.f, 0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float Lp[K * K], sy[D * D];
    ld_factor<D>(P, p, Lp);
    for (int a = 0; a < r; ++a) {
      float v[K];
      ld_prow<K>(g, n, p, a, v);
      st_prow<K>(W.rr, n, p, a, v);
      chol_row<D>(Lp, v);
      st_prow<K>(W.z, n, p, a, v);
    }
    sym_rows<D>(P.X, W.z, n, p, r, sy);
    for (int a = 0; a < r; ++a) {
      float x[K], v[K], zz[K];
      const float zero[K] = {};
      ld_prow<K>(P.X, n, p, a, x);
      ld_prow<K>(g, n, p, a, v);
      ld_prow<K>(W.z, n, p, a, zz);
      sub_row<D>(x, sy, zz);
      st_prow<K>(W.z, n, p, a, zz);
      s2[0] += dot<K>(v, zz);
      s2[1] += dot<K>(v, v);
#pragma unroll
      for (int q = 0; q < K; ++q) zz[q] = -zz[q];
      st_prow<K>(W.delta, n, p, a, zz);
      st_prow<K>(W.eta, n, p, a, zero);
      st_prow<K>(W.heta, n, p, a, zero);
    }
  }
  block_sum<2>(s2, P.red);
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
  bool hit = false;
  while (k < max_iters && !done) {
    // Hd = P_X(EucHess[delta] - [delta_Y S | 0])
    grad_sweep_rt<D>(P, r, W.delta, nullptr, W.hd);
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float Sp[D * D], sy[D * D];
#pragma unroll
      for (int i = 0; i < D * D; ++i) Sp[i] = P.S[i * n + p];
      for (int a = 0; a < r; ++a) {
        float dl[K], h[K];
        ld_prow<K>(W.delta, n, p, a, dl);
        ld_prow<K>(W.hd, n, p, a, h);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float s = 0.f;
#pragma unroll
          for (int b = 0; b < D; ++b) s += dl[b] * Sp[b * D + c];
          h[c] -= s;
        }
        st_prow<K>(W.hd, n, p, a, h);
      }
      sym_rows<D>(P.X, W.hd, n, p, r, sy);
      for (int a = 0; a < r; ++a) {
        float x[K], dl[K], h[K], et[K];
        ld_prow<K>(P.X, n, p, a, x);
        ld_prow<K>(W.delta, n, p, a, dl);
        ld_prow<K>(W.hd, n, p, a, h);
        ld_prow<K>(W.eta, n, p, a, et);
        sub_row<D>(x, sy, h);
        st_prow<K>(W.hd, n, p, a, h);
        s4[0] += dot<K>(dl, h);
        s4[1] += dot<K>(et, et);
        s4[2] += dot<K>(et, dl);
        s4[3] += dot<K>(dl, dl);
      }
    }
    block_sum<4>(s4, P.red);
    const float d_hd = s4[0], e_e = s4[1], e_d = s4[2], d_d = s4[3];
    const float alpha = rz / (fabsf(d_hd) < kEps ? kEps : d_hd);
    const float e_e_next = e_e + 2.f * alpha * e_d + alpha * alpha * d_d;
    const bool crossing = (d_hd <= 0.f) || (e_e_next >= rad2);
    const float disc = fmaxf(e_d * e_d + d_d * (rad2 - e_e), 0.f);
    const float tau = (-e_d + sqrtf(disc)) / (d_d < kEps ? kEps : d_d);
    const float step = crossing ? tau : alpha;

    s2[0] = 0.f;
    s2[1] = 0.f;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float Lp[K * K], sy[D * D];
      ld_factor<D>(P, p, Lp);
      for (int a = 0; a < r; ++a) {
        float dl[K], h[K], v[K];
        ld_prow<K>(W.delta, n, p, a, dl);
        ld_prow<K>(W.hd, n, p, a, h);
        ld_prow<K>(W.eta, n, p, a, v);
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] += step * dl[q];
        st_prow<K>(W.eta, n, p, a, v);
        ld_prow<K>(W.heta, n, p, a, v);
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] += step * h[q];
        st_prow<K>(W.heta, n, p, a, v);
        ld_prow<K>(W.rr, n, p, a, v);
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] += alpha * h[q];
        st_prow<K>(W.rr, n, p, a, v);
        chol_row<D>(Lp, v);
        st_prow<K>(W.z, n, p, a, v);
      }
      sym_rows<D>(P.X, W.z, n, p, r, sy);
      for (int a = 0; a < r; ++a) {
        float x[K], v[K], zz[K];
        ld_prow<K>(P.X, n, p, a, x);
        ld_prow<K>(W.rr, n, p, a, v);
        ld_prow<K>(W.z, n, p, a, zz);
        sub_row<D>(x, sy, zz);
        st_prow<K>(W.z, n, p, a, zz);
        s2[0] += dot<K>(v, zz);
        s2[1] += dot<K>(v, v);
      }
    }
    block_sum<2>(s2, P.red);
    const float rz_in = s2[0];
    const bool converged = sqrtf(s2[1]) <= target;
    const float beta = rz_in / (fabsf(rz) < kEps ? kEps : rz);
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      for (int a = 0; a < r; ++a) {
        float dl[K], zz[K];
        ld_prow<K>(W.delta, n, p, a, dl);
        ld_prow<K>(W.z, n, p, a, zz);
#pragma unroll
        for (int q = 0; q < K; ++q) dl[q] = -zz[q] + beta * dl[q];
        st_prow<K>(W.delta, n, p, a, dl);
      }
    }
    __syncthreads();
    rz = rz_in;
    ++k;
    done = crossing || converged;
    hit = hit || crossing;
  }
  *hit_out = hit;
  return k;
}

// retract at rank r: M^T M summed over the pose's rows, the Newton-Schulz
// sweeps once per pose, then each row of the polar factor.  Poses at or
// past the agent's own count are left untouched.
template <int D>
__device__ void retract_rt(const Problem& P, int r, const float* V,
                           float* out) {
  constexpr int K = D + 1;
  const int n = P.n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    if (p >= P.n_act) {
      for (int a = 0; a < r; ++a) {
        float x[K];
        ld_prow<K>(P.X, n, p, a, x);
        st_prow<K>(out, n, p, a, x);
      }
      continue;
    }
    float Y[D][D], Zm[D][D], T[D][D], tmp[D][D];
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) Y[b][c] = 0.f;
    for (int a = 0; a < r; ++a) {
      float x[K], v[K], M[D];
      ld_prow<K>(P.X, n, p, a, x);
      ld_prow<K>(V, n, p, a, v);
#pragma unroll
      for (int c = 0; c < D; ++c) M[c] = x[c] + v[c];
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c) Y[b][c] += M[b] * M[c];
    }
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < D; ++b) s += Y[b][b];
    s = fmaxf(s, 1e-37f);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        Y[b][c] = Y[b][c] / s;
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
    for (int a = 0; a < r; ++a) {
      float x[K], v[K], o[K];
      ld_prow<K>(P.X, n, p, a, x);
      ld_prow<K>(V, n, p, a, v);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) acc += (x[b] + v[b]) * Zm[b][c];
        o[c] = acc * inv;
      }
      o[D] = x[D] + v[D];
      st_prow<K>(out, n, p, a, o);
    }
  }
  __syncthreads();
}

// retract_refine at rank r: E summed over the pose's rows, its series once
// per pose, then each row of D_new.  Poses at or past the agent's own count
// keep their D.
template <int D>
__device__ void retract_refine_rt(const Problem& P, int r, const float* Rc,
                                  const float* Dv, const float* V,
                                  float* out) {
  constexpr int K = D + 1;
  const int n = P.n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    if (p >= P.n_act) {
      for (int a = 0; a < r; ++a) {
        float u[K];
        ld_prow<K>(Dv, n, p, a, u);
        st_prow<K>(out, n, p, a, u);
      }
      continue;
    }
    float M[D][D], E[D][D], E2[D][D], E3[D][D], E4[D][D];
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) M[b][c] = 0.f;
    for (int a = 0; a < r; ++a) {
      float rc[K], u[K], v[K];
      ld_prow<K>(Rc, n, p, a, rc);
      ld_prow<K>(Dv, n, p, a, u);
      ld_prow<K>(V, n, p, a, v);
#pragma unroll
      for (int q = 0; q < K; ++q) u[q] += v[q];
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c)
          M[b][c] += rc[b] * u[c] + u[b] * rc[c] + u[b] * u[c];
    }
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) E[b][c] = 0.5f * (M[b][c] + M[c][b]);
    matmul3<D>(E, E, E2);
    matmul3<D>(E2, E, E3);
    matmul3<D>(E2, E2, E4);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c)
        M[b][c] = -0.5f * E[b][c] + 0.375f * E2[b][c] -
                  0.3125f * E3[b][c] + 0.2734375f * E4[b][c];
    for (int a = 0; a < r; ++a) {
      float rc[K], u[K], v[K], o[K];
      ld_prow<K>(Rc, n, p, a, rc);
      ld_prow<K>(Dv, n, p, a, u);
      ld_prow<K>(V, n, p, a, v);
#pragma unroll
      for (int q = 0; q < K; ++q) u[q] += v[q];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) s += (rc[b] + u[b]) * M[b][c];
        o[c] = u[c] + s;
      }
      o[D] = u[D];
      st_prow<K>(out, n, p, a, o);
    }
  }
  __syncthreads();
}

// out <- V, row by row.
template <int K>
__device__ void copy_rows(const float* V, int n, int r, float* out) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    for (int a = 0; a < r; ++a) {
      float x[K];
      ld_prow<K>(V, n, p, a, x);
      st_prow<K>(out, n, p, a, x);
    }
  }
}

// (<g, eta>, <eta, Heta>) over the agent.
template <int K>
__device__ void model_dots(const Problem& P, int r, const float* g,
                           const TcgVecs& W, float (&m2)[2]) {
  m2[0] = 0.f;
  m2[1] = 0.f;
  for (int p = threadIdx.x; p < P.n; p += blockDim.x) {
    for (int a = 0; a < r; ++a) {
      float gv[K], et[K], he[K];
      ld_prow<K>(g, P.n, p, a, gv);
      ld_prow<K>(W.eta, P.n, p, a, et);
      ld_prow<K>(W.heta, P.n, p, a, he);
      m2[0] += dot<K>(gv, et);
      m2[1] += dot<K>(et, he);
    }
  }
  block_sum<2>(m2, P.red);
}

// attempts at rank r.
template <int D>
__device__ Attempts attempts_rt(const Problem& P, int r, const float* g,
                                const TcgVecs& W, float* xp, float* xo,
                                float f0, int k_att, float radius,
                                int max_rejections, const Args& args) {
  constexpr int K = D + 1;
  Attempts at{k_att, false, f0, 0};
  while (at.k_att < max_rejections && !at.accepted) {
    bool hit;
    at.iters += tcg_rt<D>(P, r, g, radius, args.max_iters, args.kappa,
                          args.theta, W, &hit);
    retract_rt<D>(P, r, W.eta, xp);
    const float f_prop = cost_rt<D, false>(P, r, xp, P.Z);
    float m2[2];
    model_dots<K>(P, r, g, W, m2);
    const float mdec = -(m2[0] + 0.5f * m2[1]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      copy_rows<K>(xp, P.n, r, xo);
      at.f_best = f_prop;
    } else {
      radius = radius / 4.f;
    }
    ++at.k_att;
    at.accepted = ok;
    __syncthreads();
  }
  return at;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rtr_full_kernel_rt(Args args, int r, float initial_radius,
                   int max_rejections, float grad_tol, float* X_out,
                   float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kVecs];
  Problem P = setup_rt<D>(args, r, smem, a, v, kVecs);
  float* g = v[0];
  float* xp = v[7];
  TcgVecs W{v[1], v[2], v[3], v[4], v[5], v[6]};
  float* xo = X_out + (size_t)a * r * K * P.n;
  float* S = const_cast<float*>(P.S);
  const int n = P.n;

  // Start point: G = egrad([X | Z]) into W.hd, S = sym(Y^T G_Y), g = P_X(G).
  grad_sweep_rt<D>(P, r, P.X, P.Z, W.hd);
  float gg[1] = {0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float sy[D * D];
    sym_rows<D>(P.X, W.hd, n, p, r, sy);
#pragma unroll
    for (int i = 0; i < D * D; ++i) S[i * n + p] = sy[i];
    for (int q = 0; q < r; ++q) {
      float x[K], G[K];
      ld_prow<K>(P.X, n, p, q, x);
      ld_prow<K>(W.hd, n, p, q, G);
      st_prow<K>(xo, n, p, q, x);
      sub_row<D>(x, sy, G);
      st_prow<K>(g, n, p, q, G);
      gg[0] += dot<K>(G, G);
    }
  }
  block_sum<1>(gg, P.red);
  const float gn0 = sqrtf(gg[0]);
  const float f0 = cost_rt<D, false>(P, r, P.X, P.Z);

  const Attempts at = attempts_rt<D>(P, r, g, W, xp, xo, f0,
                                     (gn0 < grad_tol) ? max_rejections : 0,
                                     initial_radius, max_rejections, args);
  if (threadIdx.x == 0) {
    float* st = stats + (size_t)a * 5;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    st[4] = gn0;
    tcg_iters[a] = at.iters;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rtr_kernel_rt(Args args, int r, const float* Sc, const float* gc,
              float initial_radius, int max_rejections, float* X_out,
              float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kVecs];
  Problem P = setup_rt<D>(args, r, smem, a, v, kVecs);
  const int n = P.n;
  const size_t off = (size_t)a * r * K * n;
  P.S = Sc + (size_t)a * D * D * n;
  const float* g = gc + off;
  float* xp = v[7];
  TcgVecs W{v[1], v[2], v[3], v[4], v[5], v[6]};
  float* xo = X_out + off;
  copy_rows<K>(P.X, n, r, xo);
  const float f0 = cost_rt<D, false>(P, r, P.X, P.Z);
  const Attempts at = attempts_rt<D>(P, r, g, W, xp, xo, f0, 0,
                                     initial_radius, max_rejections, args);
  if (threadIdx.x == 0) {
    float* st = stats + (size_t)a * 4;
    st[0] = (float)at.k_att;
    st[1] = at.accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = at.f_best;
    tcg_iters[a] = at.iters;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
tcg_kernel_rt(Args args, int r, const float* Sc, const float* gc,
              const float* radius, float* eta_out, float* heta_out,
              float* stats) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kVecs];
  Problem P = setup_rt<D>(args, r, smem, a, v, kVecs);
  P.S = Sc + (size_t)a * D * D * P.n;
  const size_t off = (size_t)a * r * K * P.n;
  TcgVecs W{eta_out + off, heta_out + off, v[3], v[4], v[5], v[6]};
  bool hit;
  const int k = tcg_rt<D>(P, r, gc + off, radius[a], args.max_iters,
                          args.kappa, args.theta, W, &hit);
  if (threadIdx.x == 0) {
    stats[(size_t)a * 2] = (float)k;
    stats[(size_t)a * 2 + 1] = hit ? 1.f : 0.f;
  }
}

// rtr_refine_full_kernel at rank r.
template <int D>
__global__ void __launch_bounds__(kThreads)
rtr_refine_full_kernel_rt(Args args, int r, RefineConsts rc,
                          float initial_radius, int max_rejections,
                          float grad_tol, float* D_out, float* stats,
                          int* tcg_iters) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[kRefineVecs];
  Problem P = setup_rt<D>(args, r, smem, a, v, kRefineVecs);
  const int n = P.n;
  const size_t off = (size_t)a * r * K * n;
  const float* Dst = P.X;
  const float* Rc = rc.Rc + off;
  const float* g0 = rc.g0 + off;
  const float* Gref = rc.Gref + off;
  const float* S0 = rc.S0 + (size_t)a * D * D * n;
  float* g = v[0];
  float* dp = v[7];
  float* Y = v[8];
  TcgVecs W{v[1], v[2], v[3], v[4], v[5], v[6]};
  float* dout = D_out + off;
  float* S = const_cast<float*>(P.S);

  // dG = egrad([D | Dz]) into W.hd, then S1 = sym(D_Y^T Gref_Y + Y_Y^T
  // dG_Y) over the rows, S = S0 + S1, the re-centered gradient g and Y.
  grad_sweep_rt<D>(P, r, Dst, P.Z, W.hd);
  float gg[1] = {0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float M1[D][D], S1[D][D], St[D][D];
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) M1[b][c] = 0.f;
    for (int q = 0; q < r; ++q) {
      float dd[K], y[K], G[K], Gr[K];
      ld_prow<K>(Dst, n, p, q, dd);
      ld_prow<K>(Rc, n, p, q, y);
      ld_prow<K>(W.hd, n, p, q, G);
      ld_prow<K>(Gref, n, p, q, Gr);
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = 0; c < D; ++c)
          M1[b][c] += dd[b] * Gr[c] + (y[b] + dd[b]) * G[c];
    }
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) S1[b][c] = 0.5f * (M1[b][c] + M1[c][b]);
#pragma unroll
    for (int b = 0; b < D; ++b)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        St[b][c] = S0[(b * D + c) * n + p] + S1[b][c];
        S[(b * D + c) * n + p] = St[b][c];
      }
    for (int q = 0; q < r; ++q) {
      float dd[K], y[K], G[K], gv[K];
      ld_prow<K>(Dst, n, p, q, dd);
      ld_prow<K>(Rc, n, p, q, y);
      ld_prow<K>(W.hd, n, p, q, G);
      ld_prow<K>(g0, n, p, q, gv);
      st_prow<K>(dout, n, p, q, dd);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) s += y[b] * S1[b][c] + dd[b] * St[b][c];
        gv[c] = gv[c] + G[c] - s;
      }
      gv[D] = gv[D] + G[D];
      st_prow<K>(g, n, p, q, gv);
      gg[0] += dot<K>(gv, gv);
#pragma unroll
      for (int i = 0; i < K; ++i) y[i] += dd[i];
      st_prow<K>(Y, n, p, q, y);
    }
  }
  block_sum<1>(gg, P.red);
  const float gn0 = sqrtf(gg[0]);
  P.X = Y;  // projections, curvature and preconditioner are taken at Y

  // Initial radius at the preconditioned-gradient (Cauchy) scale; the
  // solve goes through W.z, which tcg overwrites.
  float pp[1] = {0.f};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float Lp[K * K], sy[D * D];
    ld_factor<D>(P, p, Lp);
    for (int q = 0; q < r; ++q) {
      float pg[K];
      ld_prow<K>(g, n, p, q, pg);
      chol_row<D>(Lp, pg);
      st_prow<K>(W.z, n, p, q, pg);
    }
    sym_rows<D>(Y, W.z, n, p, r, sy);
    for (int q = 0; q < r; ++q) {
      float y[K], pg[K];
      ld_prow<K>(Y, n, p, q, y);
      ld_prow<K>(W.z, n, p, q, pg);
      sub_row<D>(y, sy, pg);
      pp[0] += dot<K>(pg, pg);
    }
  }
  block_sum<1>(pp, P.red);
  float radius = fminf(initial_radius, 10.f * sqrtf(pp[0]));
  const float f0 = cost_rt<D, true>(P, r, Dst, P.Z);

  int k_att = (gn0 < grad_tol) ? max_rejections : 0;
  float f_best = f0;
  bool accepted = false;
  int iters = 0;
  while (k_att < max_rejections && !accepted) {
    bool hit;
    iters += tcg_rt<D>(P, r, g, radius, args.max_iters, args.kappa,
                       args.theta, W, &hit);
    retract_refine_rt<D>(P, r, Rc, Dst, W.eta, dp);
    const float f_prop = cost_rt<D, true>(P, r, dp, P.Z);
    float m2[2];
    model_dots<K>(P, r, g, W, m2);
    const float mdec = -(m2[0] + 0.5f * m2[1]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      copy_rows<K>(dp, n, r, dout);
      f_best = f_prop;
    } else {
      radius = radius / 4.f;
    }
    ++k_att;
    accepted = ok;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float* st = stats + (size_t)a * 5;
    st[0] = (float)k_att;
    st[1] = accepted ? 1.f : 0.f;
    st[2] = f0;
    st[3] = f_best;
    st[4] = gn0;
    tcg_iters[a] = iters;
  }
}

// The one formula for an agent's edge payload: indices, transforms and
// weights, plus the reference residuals in refine mode.
size_t payload_bytes(int r, int d, int E, bool refine) {
  return (size_t)E * 4 * (d * d + d + 4 + (refine ? r * d + r : 0));
}

bool payload_fits_smem(int r, int d, int E, bool refine) {
  return kRedBytes + payload_bytes(r, d, E, refine) <= kMaxSharedBytes;
}

size_t smem_bytes(const Args& args, int r, int d) {
  return kRedBytes + (args.payload_in_smem
                          ? payload_bytes(r, d, args.E,
                                          args.rho_rot != nullptr)
                          : 0);
}

template <typename Kern>
int prepare_launch(Kern kern, const Args& args, int r, int d, size_t* smem) {
  *smem = smem_bytes(args, r, d);
  return (int)raise_smem_limit(reinterpret_cast<const void*>(kern),
                               (int)*smem);
}

Args make_args(int r, int d, int A, int n, int s, int Ep, int T, int E,
               int kinc, const void* idx_i, const void* idx_j,
               const void* rot, const void* trn, const void* wk,
               const void* wt, const void* rho_rot, const void* rho_trn,
               const void* X, const void* Z, const void* L,
               const void* inc_slot, const void* inc_mask,
               const void* n_local, void* ws, long long ws_stride,
               int max_iters, float kappa, float theta) {
  Args g;
  g.A = A;
  g.n = n;
  g.s = s;
  g.Ep = Ep;
  g.T = T;
  g.E = E;
  g.kinc = kinc;
  g.payload_in_smem = payload_fits_smem(r, d, E, rho_rot != nullptr) ? 1 : 0;
  g.idx_i = static_cast<const int*>(idx_i);
  g.idx_j = static_cast<const int*>(idx_j);
  g.rot = static_cast<const float*>(rot);
  g.trn = static_cast<const float*>(trn);
  g.wk = static_cast<const float*>(wk);
  g.wt = static_cast<const float*>(wt);
  g.rho_rot = static_cast<const float*>(rho_rot);
  g.rho_trn = static_cast<const float*>(rho_trn);
  g.X = static_cast<const float*>(X);
  g.Z = static_cast<const float*>(Z);
  g.L = static_cast<const float*>(L);
  g.inc = static_cast<const int*>(inc_slot);
  g.incm = static_cast<const float*>(inc_mask);
  g.n_local = static_cast<const int*>(n_local);
  g.ws = static_cast<float*>(ws);
  g.ws_stride = ws_stride;
  g.max_iters = max_iters;
  g.kappa = kappa;
  g.theta = theta;
  return g;
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
  static int rtr_full(const Args& args, int r, float initial_radius,
                      int max_rejections, float grad_tol, float* X_out,
                      float* stats, int* tcg_iters, cudaStream_t stream);
  static int rtr(const Args& args, int r, const float* Sc, const float* gc,
                 float initial_radius, int max_rejections, float* X_out,
                 float* stats, int* tcg_iters, cudaStream_t stream);
  static int tcg(const Args& args, int r, const float* Sc, const float* gc,
                 const float* radius, float* eta, float* heta, float* stats,
                 cudaStream_t stream);
  static int rtr_refine_full(const Args& args, int r, const RefineConsts& rc,
                             float initial_radius, int max_rejections,
                             float grad_tol, float* D_out, float* stats,
                             int* tcg_iters, cudaStream_t stream);
};

#if DPGO_PART >= 0

template <int R, int D>
int Launchers<R, D, true>::rtr_full(const Args& args, int r,
                                    float initial_radius, int max_rejections,
                                    float grad_tol, float* X_out,
                                    float* stats, int* tcg_iters,
                                    cudaStream_t stream) {
  size_t smem;
  if constexpr (R == 0) {
    const int err = prepare_launch(rtr_full_kernel_rt<D>, args, r, D, &smem);
    if (err != 0) return err;
    rtr_full_kernel_rt<D><<<args.A, kThreads, smem, stream>>>(
        args, r, initial_radius, max_rejections, grad_tol, X_out, stats,
        tcg_iters);
    return (int)cudaGetLastError();
  } else {
    const int err = prepare_launch(rtr_full_kernel<R, D>, args, R, D, &smem);
    if (err != 0) return err;
    rtr_full_kernel<R, D><<<args.A, kThreads, smem, stream>>>(
        args, initial_radius, max_rejections, grad_tol, X_out, stats,
        tcg_iters);
    return (int)cudaGetLastError();
  }
}

template <int R, int D>
int Launchers<R, D, true>::rtr(const Args& args, int r, const float* Sc,
                               const float* gc, float initial_radius,
                               int max_rejections, float* X_out, float* stats,
                               int* tcg_iters, cudaStream_t stream) {
  size_t smem;
  if constexpr (R == 0) {
    const int err = prepare_launch(rtr_kernel_rt<D>, args, r, D, &smem);
    if (err != 0) return err;
    rtr_kernel_rt<D><<<args.A, kThreads, smem, stream>>>(
        args, r, Sc, gc, initial_radius, max_rejections, X_out, stats,
        tcg_iters);
    return (int)cudaGetLastError();
  } else {
    const int err = prepare_launch(rtr_kernel<R, D>, args, R, D, &smem);
    if (err != 0) return err;
    rtr_kernel<R, D><<<args.A, kThreads, smem, stream>>>(
        args, Sc, gc, initial_radius, max_rejections, X_out, stats,
        tcg_iters);
    return (int)cudaGetLastError();
  }
}

template <int R, int D>
int Launchers<R, D, true>::tcg(const Args& args, int r, const float* Sc,
                               const float* gc, const float* radius,
                               float* eta, float* heta, float* stats,
                               cudaStream_t stream) {
  size_t smem;
  if constexpr (R == 0) {
    const int err = prepare_launch(tcg_kernel_rt<D>, args, r, D, &smem);
    if (err != 0) return err;
    tcg_kernel_rt<D><<<args.A, kThreads, smem, stream>>>(
        args, r, Sc, gc, radius, eta, heta, stats);
    return (int)cudaGetLastError();
  } else {
    const int err = prepare_launch(tcg_kernel<R, D>, args, R, D, &smem);
    if (err != 0) return err;
    tcg_kernel<R, D><<<args.A, kThreads, smem, stream>>>(args, Sc, gc, radius,
                                                          eta, heta, stats);
    return (int)cudaGetLastError();
  }
}

template <int R, int D>
int Launchers<R, D, true>::rtr_refine_full(
    const Args& args, int r, const RefineConsts& rc, float initial_radius,
    int max_rejections, float grad_tol, float* D_out, float* stats,
    int* tcg_iters, cudaStream_t stream) {
  size_t smem;
  if constexpr (R == 0) {
    const int err =
        prepare_launch(rtr_refine_full_kernel_rt<D>, args, r, D, &smem);
    if (err != 0) return err;
    rtr_refine_full_kernel_rt<D><<<args.A, kThreads, smem, stream>>>(
        args, r, rc, initial_radius, max_rejections, grad_tol, D_out, stats,
        tcg_iters);
    return (int)cudaGetLastError();
  } else {
    const int err =
        prepare_launch(rtr_refine_full_kernel<R, D>, args, R, D, &smem);
    if (err != 0) return err;
    rtr_refine_full_kernel<R, D><<<args.A, kThreads, smem, stream>>>(
        args, rc, initial_radius, max_rejections, grad_tol, D_out, stats,
        tcg_iters);
    return (int)cudaGetLastError();
  }
}

#define DPGO_INSTANTIATE(R_, D_) \
  template struct Launchers<R_, D_, dpgo_shapes::in_part(R_, D_)>;
DPGO_SHAPES(DPGO_INSTANTIATE)
DPGO_GENERIC_SHAPES(DPGO_INSTANTIATE)
#undef DPGO_INSTANTIATE

#endif  // DPGO_PART >= 0

#if DPGO_PART < 0

using dpgo_shapes::dispatch;

// The entry points have C linkage: their names are global, whatever the
// namespace.
extern "C" {

// Floats of per-agent workspace: the loop vectors [RK, n] (8, or 9 for
// the refine kernel), S [D*D, n], the per-edge gradient rows [2E, RK] and,
// when it does not fit in shared memory, the edge payload.
long long dpgo_rtr_workspace_floats(int r, int d, int n, int e_max,
                                    int refine) {
  const long long rk = (long long)r * (d + 1);
  const bool rf = refine != 0;
  const long long payload =
      payload_fits_smem(r, d, e_max, rf) ? 0
                                         : payload_bytes(r, d, e_max, rf) / 4;
  return (rf ? kRefineVecs : kVecs) * rk * n + (long long)d * d * n +
         2LL * e_max * rk + payload;
}

int dpgo_rtr_full_launch(int r, int d, int A, int n, int s, int Ep, int T,
                         int e_max, int kinc, const void* idx_i,
                         const void* idx_j, const void* rot, const void* trn,
                         const void* wk, const void* wt, const void* X,
                         const void* Z, const void* L, const void* inc_slot,
                         const void* inc_mask, const void* n_local,
                         void* X_out, void* stats, void* tcg_iters, void* ws,
                         long long ws_stride, int max_iters, float kappa,
                         float theta, float initial_radius,
                         int max_rejections, float grad_tol, void* stream) {
  const Args g = make_args(r, d, A, n, s, Ep, T, e_max, kinc, idx_i, idx_j,
                           rot, trn, wk, wt, nullptr, nullptr, X, Z, L,
                           inc_slot, inc_mask, n_local, ws, ws_stride,
                           max_iters, kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr_full(g, r, initial_radius, max_rejections, grad_tol,
                              xo, st, it, cs);
  });
}

int dpgo_rtr_launch(int r, int d, int A, int n, int s, int Ep, int T,
                    int e_max, int kinc, const void* idx_i, const void* idx_j,
                    const void* rot, const void* trn, const void* wk,
                    const void* wt, const void* X, const void* Z,
                    const void* S, const void* L, const void* g,
                    const void* inc_slot, const void* inc_mask,
                    const void* n_local, void* X_out, void* stats,
                    void* tcg_iters, void* ws, long long ws_stride,
                    int max_iters, float kappa, float theta,
                    float initial_radius, int max_rejections, void* stream) {
  const Args a = make_args(r, d, A, n, s, Ep, T, e_max, kinc, idx_i, idx_j,
                           rot, trn, wk, wt, nullptr, nullptr, X, Z, L,
                           inc_slot, inc_mask, n_local, ws, ws_stride,
                           max_iters, kappa, theta);
  const float* sc = static_cast<const float*>(S);
  const float* gc = static_cast<const float*>(g);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr(a, r, sc, gc, initial_radius, max_rejections, xo, st,
                         it, cs);
  });
}

int dpgo_tcg_launch(int r, int d, int A, int n, int Ep, int T, int e_max,
                    int kinc, const void* idx_i, const void* idx_j,
                    const void* rot, const void* trn, const void* wk,
                    const void* wt, const void* X, const void* S,
                    const void* L, const void* g, const void* radius,
                    const void* inc_slot, const void* inc_mask,
                    const void* n_local, void* eta, void* heta, void* stats,
                    void* ws, long long ws_stride, int max_iters, float kappa,
                    float theta, void* stream) {
  // The tCG sweeps are Hessian sweeps only: no neighbor slots are read.
  const Args a = make_args(r, d, A, n, 0, Ep, T, e_max, kinc, idx_i, idx_j,
                           rot, trn, wk, wt, nullptr, nullptr, X, X, L,
                           inc_slot, inc_mask, n_local, ws, ws_stride,
                           max_iters, kappa, theta);
  const float* sc = static_cast<const float*>(S);
  const float* gc = static_cast<const float*>(g);
  const float* rd = static_cast<const float*>(radius);
  float* e = static_cast<float*>(eta);
  float* h = static_cast<float*>(heta);
  float* st = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.tcg(a, r, sc, gc, rd, e, h, st, cs);
  });
}

int dpgo_rtr_refine_full_launch(
    int r, int d, int A, int n, int s, int Ep, int T, int e_max, int kinc,
    const void* idx_i, const void* idx_j, const void* rot, const void* trn,
    const void* wk, const void* wt, const void* rho_rot, const void* rho_trn,
    const void* Rc, const void* D, const void* Dz, const void* g0,
    const void* Gref, const void* S0, const void* L, const void* inc_slot,
    const void* inc_mask, const void* n_local, void* D_out, void* stats,
    void* tcg_iters, void* ws, long long ws_stride, int max_iters,
    float kappa, float theta, float initial_radius, int max_rejections,
    float grad_tol, void* stream) {
  const Args g = make_args(r, d, A, n, s, Ep, T, e_max, kinc, idx_i, idx_j,
                           rot, trn, wk, wt, rho_rot, rho_trn, D, Dz, L,
                           inc_slot, inc_mask, n_local, ws, ws_stride,
                           max_iters, kappa, theta);
  const RefineConsts rc{static_cast<const float*>(Rc),
                        static_cast<const float*>(g0),
                        static_cast<const float*>(Gref),
                        static_cast<const float*>(S0)};
  float* dout = static_cast<float*>(D_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr_refine_full(g, r, rc, initial_radius,
                                     max_rejections, grad_tol, dout, st, it,
                                     cs);
  });
}

}  // extern "C"

#endif  // DPGO_PART < 0

}  // namespace dpgo_full

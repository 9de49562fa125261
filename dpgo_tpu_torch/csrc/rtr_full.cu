// Fused single-step Riemannian trust-region solve of RBCD, for Hopper.
//
// Replaces the TPU kernels of dpgo_tpu/ops/pallas_tcg.py:
//   * _rtr_full_kernel (rtr_full_call) -> rtr_full_kernel below: one launch
//     is the whole local solve of every agent for one RBCD round: the
//     Euclidean gradient at [X | Z], the curvature term S = sym(Y^T G_Y), the
//     Riemannian gradient and its norm gn0, the early exit when
//     gn0 < grad_tol, then at most max_rejections attempts of {truncated CG,
//     24-sweep Newton-Schulz polar retraction, cost, accept when rho > 0.1
//     and f did not rise, else radius / 4}.
//   * _tcg_kernel (tcg_call) -> tcg_kernel below: the Steihaug-Toint
//     truncated CG alone, from a given S and g.
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
// agent over several CTAs, to occupy more SMs, is left for later work.
//
// Layout (matches the tile-major arrays of models/rbcd.build_graph):
//   idx_i, idx_j  [A, nt, 1, T] int32 into the [n + s] pose buffer; index
//                 n + s is padding and gathers zero, as does any index >= n
//                 in a Hessian sweep (neighbors are constants)
//   rot           [A, nt, D*D, T] f32, component b*D + c = R[b][c]
//   trn           [A, nt, D, T] f32;  wk, wt [A, nt, 1, T] f32
//   X [A, RK, n], Z [A, RK, s], L [A, K*K, n] (lower Cholesky, i*K + p)
//   inc_slot / inc_mask [A, n, Kinc]: ELL incidence into [gi (E) | gj (E)]
// Only the first E = e_max tile positions carry edges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 4;
constexpr float kEps = 1e-30f;
constexpr size_t kRedBytes = kWarps * kMaxSums * sizeof(float);
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kNsSweeps = 24;

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

// Layout of one agent's edge payload (payload_bytes), in shared memory or
// in the global workspace.
template <int D>
__device__ void load_edges(Problem& P, unsigned char* payload, int a, int Ep,
                           int T, const int* idx_i, const int* idx_j,
                           const float* rot, const float* trn,
                           const float* wk, const float* wt) {
  const int E = P.E;
  int* ei = reinterpret_cast<int*>(payload);
  int* ej = ei + E;
  float* srot = reinterpret_cast<float*>(ej + E);
  float* strn = srot + D * D * E;
  float* swk = strn + D * E;
  float* swt = swk + E;
  const int nt = Ep / T;
  const size_t base = (size_t)a * Ep;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int tl = e / T;
    const int ln = e - tl * T;
    ei[e] = idx_i[base + e];
    ej[e] = idx_j[base + e];
    swk[e] = wk[base + e];
    swt[e] = wt[base + e];
#pragma unroll
    for (int c = 0; c < D * D; ++c)
      srot[c * E + e] = rot[(((size_t)a * nt + tl) * (D * D) + c) * T + ln];
#pragma unroll
    for (int c = 0; c < D; ++c)
      strn[c * E + e] = trn[(((size_t)a * nt + tl) * D + c) * T + ln];
  }
  P.ei = ei;
  P.ej = ej;
  P.rot = srot;
  P.trn = strn;
  P.wk = swk;
  P.wt = swt;
  __syncthreads();
}

struct Args {
  int A, n, s, Ep, T, E, kinc;
  int payload_in_smem;  // else the payload follows gbuf in the workspace
  const int* idx_i;
  const int* idx_j;
  const float* rot;
  const float* trn;
  const float* wk;
  const float* wt;
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

template <int R, int D>
__device__ Problem setup(const Args& g, unsigned char* smem, int a,
                         float** vecs) {
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
  for (int i = 0; i < 8; ++i) vecs[i] = ws + i * vec;
  float* S = ws + 8 * vec;
  P.S = S;
  P.gbuf = S + (size_t)D * D * g.n;
  P.red = reinterpret_cast<float*>(smem);
  unsigned char* payload =
      g.payload_in_smem
          ? smem + kRedBytes
          : reinterpret_cast<unsigned char*>(P.gbuf + 2 * (size_t)g.E * RK);
  load_edges<D>(P, payload, a, g.Ep, g.T, g.idx_i, g.idx_j, g.rot, g.trn,
                g.wk, g.wt);
  return P;
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads)
rtr_full_kernel(Args args, float initial_radius, int max_rejections,
                float grad_tol, float* X_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int RK = R * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[8];
  Problem P = setup<R, D>(args, smem, a, v);
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

  int k_att = (gn0 < grad_tol) ? max_rejections : 0;
  float radius = initial_radius;
  float f_best = f0;
  bool accepted = false;
  int iters = 0;
  while (k_att < max_rejections && !accepted) {
    bool hit;
    iters += tcg<R, D>(P, g, radius, args.max_iters, args.kappa, args.theta,
                       W, &hit);
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

template <int R, int D>
__global__ void __launch_bounds__(kThreads)
tcg_kernel(Args args, const float* Sc, const float* gc, const float* radius,
           float* eta_out, float* heta_out, float* stats) {
  constexpr int RK = R * (D + 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  float* v[8];
  Problem P = setup<R, D>(args, smem, a, v);
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

size_t payload_bytes(int d, int E) {
  return (size_t)E * 4 * (d * d + d + 4);
}

bool payload_fits_smem(int d, int E) {
  return kRedBytes + payload_bytes(d, E) <= kMaxSharedBytes;
}

size_t smem_bytes(const Args& args, int d) {
  return kRedBytes + (args.payload_in_smem ? payload_bytes(d, args.E) : 0);
}

template <int R, int D>
int launch_rtr_full(const Args& args, float initial_radius, int max_rejections,
                    float grad_tol, float* X_out, float* stats, int* tcg_iters,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes(args, D);
  cudaError_t err = cudaFuncSetAttribute(
      rtr_full_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rtr_full_kernel<R, D><<<args.A, kThreads, smem, stream>>>(
      args, initial_radius, max_rejections, grad_tol, X_out, stats, tcg_iters);
  return (int)cudaGetLastError();
}

template <int R, int D>
int launch_tcg(const Args& args, const float* Sc, const float* gc,
               const float* radius, float* eta, float* heta, float* stats,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(args, D);
  cudaError_t err = cudaFuncSetAttribute(
      tcg_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tcg_kernel<R, D><<<args.A, kThreads, smem, stream>>>(args, Sc, gc, radius,
                                                        eta, heta, stats);
  return (int)cudaGetLastError();
}

Args make_args(int d, int A, int n, int s, int Ep, int T, int E, int kinc,
               const void* idx_i, const void* idx_j, const void* rot,
               const void* trn, const void* wk, const void* wt,
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
  g.payload_in_smem = payload_fits_smem(d, E) ? 1 : 0;
  g.idx_i = static_cast<const int*>(idx_i);
  g.idx_j = static_cast<const int*>(idx_j);
  g.rot = static_cast<const float*>(rot);
  g.trn = static_cast<const float*>(trn);
  g.wk = static_cast<const float*>(wk);
  g.wt = static_cast<const float*>(wt);
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

constexpr int kUnsupportedShape = -1;

}  // namespace

#define DPGO_DISPATCH(R_, D_, CALL)            \
  if (r == R_ && d == D_) return CALL<R_, D_>

extern "C" {

// Floats of per-agent workspace: 8 loop vectors [RK, n], S [D*D, n], the
// per-edge gradient rows [2E, RK] and, when it does not fit in shared
// memory, the edge payload.
long long dpgo_rtr_workspace_floats(int r, int d, int n, int e_max) {
  const long long rk = (long long)r * (d + 1);
  const long long payload =
      payload_fits_smem(d, e_max) ? 0 : payload_bytes(d, e_max) / 4;
  return 8 * rk * n + (long long)d * d * n + 2LL * e_max * rk + payload;
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
  const Args g = make_args(d, A, n, s, Ep, T, e_max, kinc, idx_i, idx_j, rot,
                           trn, wk, wt, X, Z, L, inc_slot, inc_mask, n_local,
                           ws, ws_stride, max_iters, kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  DPGO_DISPATCH(5, 3, launch_rtr_full)(g, initial_radius, max_rejections,
                                       grad_tol, xo, st, it, cs);
  DPGO_DISPATCH(4, 3, launch_rtr_full)(g, initial_radius, max_rejections,
                                       grad_tol, xo, st, it, cs);
  DPGO_DISPATCH(3, 3, launch_rtr_full)(g, initial_radius, max_rejections,
                                       grad_tol, xo, st, it, cs);
  DPGO_DISPATCH(3, 2, launch_rtr_full)(g, initial_radius, max_rejections,
                                       grad_tol, xo, st, it, cs);
  DPGO_DISPATCH(2, 2, launch_rtr_full)(g, initial_radius, max_rejections,
                                       grad_tol, xo, st, it, cs);
  return kUnsupportedShape;
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
  const Args a = make_args(d, A, n, 0, Ep, T, e_max, kinc, idx_i, idx_j, rot,
                           trn, wk, wt, X, X, L, inc_slot, inc_mask, n_local,
                           ws, ws_stride, max_iters, kappa, theta);
  const float* sc = static_cast<const float*>(S);
  const float* gc = static_cast<const float*>(g);
  const float* rd = static_cast<const float*>(radius);
  float* e = static_cast<float*>(eta);
  float* h = static_cast<float*>(heta);
  float* st = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  DPGO_DISPATCH(5, 3, launch_tcg)(a, sc, gc, rd, e, h, st, cs);
  DPGO_DISPATCH(4, 3, launch_tcg)(a, sc, gc, rd, e, h, st, cs);
  DPGO_DISPATCH(3, 3, launch_tcg)(a, sc, gc, rd, e, h, st, cs);
  DPGO_DISPATCH(3, 2, launch_tcg)(a, sc, gc, rd, e, h, st, cs);
  DPGO_DISPATCH(2, 2, launch_tcg)(a, sc, gc, rd, e, h, st, cs);
  return kUnsupportedShape;
}

}  // extern "C"

// Fused single-step Riemannian trust-region solve of RBCD for agents above
// the thread-block cluster ceiling: the spread route of kernels B1-B4.
//
// Replaces the TPU kernels of dpgo_tpu/ops/pallas_tcg.py for agents that no
// cluster of rtr_cluster.cu holds (ops/rtr_kernel.cluster_plan picks the
// route from the shape and the card's SM count before the launch):
//   * _rtr_full_kernel (rtr_full_call) -> rtr_full_spread_kernel below: one
//     launch is the whole local solve of every agent for one RBCD round
//     (start-point gradient, S = sym(Y^T G_Y), gn0, the early exit, then at
//     most max_rejections attempts of {truncated CG, 24-sweep Newton-Schulz
//     retraction, cost, accept or radius / 4}).
//   * _rtr_kernel (rtr_call) -> rtr_spread_kernel below: B2's attempt loop
//     from a given gradient g and curvature term S (setup copies them in;
//     no gradient sweep, no early exit), after a cost-only sweep for f0.
//   * _tcg_kernel (tcg_call) -> tcg_spread_kernel below: one truncated CG
//     from a given g and S at a per-agent radius, every pose live and no
//     neighbor slot read.
//   * _rtr_refine_full_kernel (rtr_refine_full_call) ->
//     rtr_refine_full_spread_kernel below: the re-centered step of the
//     terminal refinement on the correction D about the reference Rc.
// The functions are rtr_cluster.cu's.  For B2 and B4, rtr_grid.cu's grid
// route takes the agents no spread holds (the same phases, spread_core.cuh,
// over one cooperative launch); rtr_full.cu's workspace route takes B1 and
// B3 there, and every kernel at an agent the grid cannot hold.
//
// What bounds it on this card: at BASELINE.md config #5 (64 agents of
// 1,594 poses, r = 5) a launch does ~1.6 GFLOP (~0.024 ms at the fp32
// peak) and must move ~36 MB of operands (~0.011 ms); neither bounds it.
// Each tCG iteration's two sweeps read and write the loop vectors of all
// ~100k poses (~1.2 KB a pose), which fit neither on chip nor together in
// the 50 MB L2: the time is that traffic and the chain of loads each
// sweep waits on.
//
// What the design does about it:
//   * One wave: A clusters of C CTAs, C picked by the plan so that the A C
//     CTAs cover the card's SMs (C = 2 at config #5: 128 CTAs on 132 SMs),
//     CTA c owning the poses [c P, (c + 1) P), P = ceil(n_max / C).
//   * Stripes: a group of R lanes owns one pose at a time, one row of its
//     block each; the CTA's G = (threads / 32) (32 / R) groups walk the
//     CTA's poses in ceil(P / G) stripes (pose s G + g in stripe s), so the
//     thread count no longer caps P.  Consecutive groups own consecutive
//     poses, so a stripe's loads of a vector are one contiguous run.
//   * On chip: the two CG direction buffers and z, the vectors a Hessian
//     sweep reads at the other endpoints, live in the owning CTA's shared
//     memory and are read across the cluster through distributed shared
//     memory (three vectors of ~800 poses fill an SM at config #5).  The
//     rest (X, the proposal xp, g, eta, Heta, r, Hd; D and Rc in refine)
//     live in a per-agent workspace in device memory, pose-major with a
//     pose's rows contiguous, so each lane's row is one float4 and a
//     warp's stripe is one coalesced run.  Beside them, read as whole
//     float4s: per pose the lower triangle of its factor (diagonal
//     replaced by reciprocals at setup) and its curvature S; per live ELL
//     entry of a CTA's poses, compacted in ELL order at setup, its word
//     (rtr_cluster.cu's), edge number and edge record (rot, trn, wk, wt),
//     so a sweep visits no dead entry and no record's address waits on a
//     load; per edge the refine step's reference residuals, a row of
//     rho_rot and rho_trn per lane.  Rows another CTA wrote (X, xp, the
//     residuals) are read at L2 (ld.global.cg) after a fence and a
//     cluster barrier.
//   * Each stripe loads all its operands before its first store or sweep,
//     so their round trips overlap; B2's retraction runs each pose's 24
//     Newton-Schulz sweeps on one lane of its group, not on every row's
//     (retract_stripes).
//   * The rank-generic instantiation (R = 0, r >= 11; shapes.cuh) reads r
//     from the launch: up to r = 32 a group is r lanes of a warp as above;
//     above, a pose takes ceil(r / 32) whole warps (row q on lane q % 32 of
//     its (q / 32)-th warp) and its group sums meet in shared slots after a
//     block barrier (lanes.cuh's wide_group_sum).  Up to r = 512 (a pose
//     of 16 warps) a thread holds one row of d + 1 floats; B2's retraction
//     runs on every row of the pose (retract_rows), since a batch of r
//     stripes' sums would hold r (d + 1) floats a thread.
//   * Above r = 512 the fold kernels (rtr_full_fold_kernel, rtr_fold_kernel,
//     tcg_fold_kernel, rtr_refine_full_fold_kernel) fold a pose's rows over
//     the CTA's 16 warps: row q on thread q % 512 at fold q / 512, F =
//     ceil(r / 512) folds (lanes.cuh's pose_folds), one pose a stripe.
//     B3's only phase of its own there is the cost sweep, B1's the
//     write-back of eta and Heta, each fold by fold.  Every per-row
//     phase loops over the thread's folds; a phase that needs a group sum
//     of its rows (the tangent projection, the retractions' Y^T Y, the
//     refine start's S1) runs in two passes: the first adds the folds'
//     terms in fold order and leaves each fold's row in the vector it
//     writes anyway (kHd, kZv, kG), the group sum follows, the second
//     finishes each row.  A fold's loads of a vector are one coalesced run
//     of 512 rows, issued before the fold's first store; a thread holds
//     one fold's rows at a time (all F folds of a vector would take
//     F (d + 1) of its 128 registers).  The shared vectors hold every fold
//     of the CTA's poses, 3 P vec_stride floats (P = 2 at r = 1636 over 16
//     CTAs, ~160 KB); a shape whose shared memory does not fit is refused
//     (kUnplaceable).  A thread adds its folds' terms in fold order within
//     each stripe's, so the sums below keep one fixed order.
//   * No tensor cores: per edge and row the work is a product of inner
//     dimension d + 1 <= 4, and the f32 parity gates (bit for bit across
//     launches, one fixed order of every sum) rule out TF32 wgmma.
//   * Sweeps, cost ownership, reductions, the retractions' arithmetic and
//     the double-buffered direction with two cluster barriers per tCG
//     iteration are rtr_cluster.cu's.  A thread adds its stripes' terms in
//     stripe order before the warp butterfly: every sum has one fixed
//     order, no atomics, launches repeat bit for bit, and every loop
//     condition is the same in every thread of the cluster.
//   * A CTA never leaves while another may still read its shared memory:
//     the kernels end with cluster.sync().
//
// Layout: rtr_cluster.cu's inputs; ws [A, ws_stride] the workspace
// (dpgo_rtr_spread_workspace_floats).

#include "spread_core.cuh"

namespace dpgo_spread {
namespace {

// ---------------------------------------------------------------------------
// The fold kernels (r > 512): a pose's rows folded over the CTA's 16 warps,
// one pose a stripe.  Each phase is the one of the same name in
// spread_core.cuh, its per-row work looped over the thread's folds
// (at_fold); a group sum takes the folds' terms added in fold order
// (add_sym), and the rows it finishes are reloaded from the vector the
// first pass wrote.
// ---------------------------------------------------------------------------

// group_sym over a folded pose: all 16 warps of the CTA sum (lanes.cuh's
// wide_group_sum at r = kFoldRows), each lane passing its folds' terms.
template <int D>
__device__ __forceinline__ void fold_sym(const CtxF& cx,
                                         float (&m)[D * (D + 1) / 2],
                                         float (&sy)[D * D]) {
  wide_group_sum<D * (D + 1) / 2>(cx.gslots, kFoldRows, m);
  int i = 0;
#pragma unroll
  for (int b = 0; b < D; ++b)
#pragma unroll
    for (int c = b; c < D; ++c, ++i) {
      sy[b * D + c] = m[i];
      sy[c * D + b] = m[i];
    }
}

// tcg over the folds: tcg's iterations, the Hessian's and z's tangent
// projections in two passes (kHd and kZv hold each fold's row between
// them).  Every thread of the cluster calls it.
template <int D>
__device__ int tcg_fold(CtxF& cx, float radius, int max_iters, float kappa,
                        float theta, bool* hit) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  constexpr int SF = s_floats(D);
  float s2[2] = {0.f, 0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    at_fold(cx, 0);
    float Lp[l_floats(D)], m[NM] = {}, sy[D * D];
    ld_factor<D>(cx, Lp);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float x[K], v[K];
      ld_own<0, K>(cx, kX, x);
      ld_own<0, K>(cx, kG, v);
      st_own<0, K>(cx, kR, v);
      block_solve<D>(Lp, v);
      st_own<0, K>(cx, kZv, v);
      add_sym<D>(x, v, m);
    }
    fold_sym<D>(cx, m, sy);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float x[K], v[K], zz[K];
      const float zero[K] = {};
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
  int cur = kDelta, prev = kDeltaB;
  bool fresh = true;
  float beta = 0.f;
  while (k < max_iters && !done) {
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      at_fold(cx, 0);
      float S[SF], m[NM] = {}, sy[D * D];
      if (cx.own) ld_rec<SF>(cx.S + (size_t)pose_of(cx, cx.pl) * SF, S);
      for (int f = 0; f < cx.folds; ++f) {
        at_fold(cx, f);
        float x[K], dl[K], h[K] = {};
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, cur, dl);
        if (cx.own) {
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
            for (int b = 0; b < D; ++b) s += dl[b] * S[b * D + c];
            h[c] -= s;
          }
          st_own<0, K>(cx, kHd, h);
        }
        add_sym<D>(x, h, m);
      }
      fold_sym<D>(cx, m, sy);
      for (int f = 0; f < cx.folds; ++f) {
        at_fold(cx, f);
        float x[K], dl[K], h[K], et[K];
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, cur, dl);
        ld_own<0, K>(cx, kEta, et);
        ld_own<0, K>(cx, kHd, h);
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

    s2[0] = 0.f;
    s2[1] = 0.f;
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      at_fold(cx, 0);
      float Lp[l_floats(D)], m[NM] = {}, sy[D * D];
      ld_factor<D>(cx, Lp);
      for (int f = 0; f < cx.folds; ++f) {
        at_fold(cx, f);
        float x[K], dl[K], h[K], et[K], he[K], v[K], zz[K];
        ld_own<0, K>(cx, kX, x);
        ld_own<0, K>(cx, cur, dl);
        ld_own<0, K>(cx, kHd, h);
        ld_own<0, K>(cx, kEta, et);
        ld_own<0, K>(cx, kHeta, he);
        ld_own<0, K>(cx, kR, v);
#pragma unroll
        for (int q = 0; q < K; ++q) {
          et[q] += step * dl[q];
          he[q] += step * h[q];
          v[q] += alpha * h[q];
          zz[q] = v[q];
        }
        st_own<0, K>(cx, kEta, et);
        st_own<0, K>(cx, kHeta, he);
        st_own<0, K>(cx, kR, v);
        block_solve<D>(Lp, zz);
        st_own<0, K>(cx, kZv, zz);
        add_sym<D>(x, zz, m);
      }
      fold_sym<D>(cx, m, sy);
      for (int f = 0; f < cx.folds; ++f) {
        at_fold(cx, f);
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
      for (int st = 0; st < cx.stripes; ++st) {
        at_stripe(cx, st);
        for (int f = 0; f < cx.folds; ++f) {
          at_fold(cx, f);
          if (!cx.own) continue;
          float dl[K], zz[K];
          ld_own<0, K>(cx, cur, dl);
          ld_own<0, K>(cx, kZv, zz);
#pragma unroll
          for (int q = 0; q < K; ++q) dl[q] = -zz[q] + beta * dl[q];
          st_own<0, K>(cx, prev, dl);
        }
      }
      const int t = cur;
      cur = prev;
      prev = t;
      fresh = false;
    }
  }
  return k;
}

// retract_rows over the folds: each pose's M^T M summed over its folds,
// then every fold's row of the polar factor into kXp.
template <int D>
__device__ void retract_rows_fold(CtxF& cx) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    float m[NM] = {}, MM[D * D];
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float x[K], et[K], M[D];
      ld_own<0, K>(cx, kX, x);
      ld_own<0, K>(cx, kEta, et);
#pragma unroll
      for (int c = 0; c < D; ++c) M[c] = x[c] + et[c];
      int i = 0;
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = b; c < D; ++c, ++i) m[i] += M[b] * M[c];
    }
    fold_sym<D>(cx, m, MM);
    float Zm[D][D];
    const float inv = ns_polar<D>(MM, Zm);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float x[K], et[K], o[K];
      ld_own<0, K>(cx, kX, x);
      ld_own<0, K>(cx, kEta, et);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) acc += (x[b] + et[b]) * Zm[b][c];
        o[c] = acc * inv;
      }
      o[D] = x[D] + et[D];
      if (pose_of(cx, cx.pl) < cx.n_act) {
        st_own<0, K>(cx, kXp, o);
      } else {
        st_own<0, K>(cx, kXp, x);
      }
    }
  }
}

// retract_refine over the folds: each pose's E summed over its folds, then
// every fold's row of D_new into kXp.
template <int D>
__device__ void retract_refine_fold(CtxF& cx) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    float m[NM] = {}, Ef[D * D];
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float dd[K], et[K], rc[K], u[K];
      ld_own<0, K>(cx, kD, dd);
      ld_own<0, K>(cx, kEta, et);
      ld_own<0, K>(cx, kRc, rc);
#pragma unroll
      for (int q = 0; q < K; ++q) u[q] = dd[q] + et[q];
      int i = 0;
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = b; c < D; ++c, ++i)
          m[i] += rc[b] * u[c] + u[b] * rc[c] + u[b] * u[c];
    }
    fold_sym<D>(cx, m, Ef);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float dd[K], et[K], rc[K], u[K], o[K];
      ld_own<0, K>(cx, kD, dd);
      ld_own<0, K>(cx, kEta, et);
      ld_own<0, K>(cx, kRc, rc);
#pragma unroll
      for (int q = 0; q < K; ++q) u[q] = dd[q] + et[q];
      refine_series<D>(Ef, rc, u, o);
      if (pose_of(cx, cx.pl) < cx.n_act) {
        st_own<0, K>(cx, kXp, o);
      } else {
        st_own<0, K>(cx, kXp, dd);
      }
    }
  }
}

// attempts over the folds.
template <int D, bool REFINE>
__device__ Attempts attempts_fold(CtxF& cx, const SpreadArgs& args,
                                  float* xo, float f0, int k_att,
                                  float radius, int max_rejections) {
  constexpr int K = D + 1;
  Attempts at{k_att, false, f0, 0};
  while (at.k_att < max_rejections && !at.accepted) {
    bool hit;
    at.iters += tcg_fold<D>(cx, radius, args.max_iters, args.kappa,
                            args.theta, &hit);
    if constexpr (REFINE) {
      retract_refine_fold<D>(cx);
    } else {
      retract_rows_fold<D>(cx);
    }
    __threadfence();
    cg::this_cluster().sync();  // the cost reads xp across CTAs
    float s3[3] = {0.f, 0.f, 0.f};
    for (int st = 0; st < cx.stripes; ++st) {
      at_stripe(cx, st);
      for (int f = 0; f < cx.folds; ++f) {
        at_fold(cx, f);
        if (!cx.own) continue;
        float xp[K], unused[K], gv[K], et[K], he[K];
        ld_own<0, K>(cx, kXp, xp);
        ld_own<0, K>(cx, kG, gv);
        ld_own<0, K>(cx, kEta, et);
        ld_own<0, K>(cx, kHeta, he);
        sweep<0, D, false, true, REFINE>(cx, kXp, true, xp, unused, &s3[0]);
        s3[1] += dot<K>(gv, et);
        s3[2] += dot<K>(et, he);
      }
    }
    cluster_sum<3>(cx, s3);
    const float f_prop = (REFINE ? 1.f : 0.5f) * s3[0];
    const float mdec = -(s3[1] + 0.5f * s3[2]);
    const float rho = (f0 - f_prop) / fmaxf(mdec, kEps);
    const bool ok = (rho > 0.1f) && (f_prop <= f0);
    if (ok) {
      for (int st = 0; st < cx.stripes; ++st) {
        at_stripe(cx, st);
        for (int f = 0; f < cx.folds; ++f) {
          at_fold(cx, f);
          if (!cx.own) continue;
          const int p = pose_of(cx, cx.pl);
          float xp[K];
          ld_own<0, K>(cx, kXp, xp);
#pragma unroll
          for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = xp[q];
        }
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
__global__ void __launch_bounds__(kThreads, 1)
rtr_full_spread_kernel(ArgsOf<R> args, float initial_radius,
                       int max_rejections, float grad_tol, float* X_out,
                       float* stats, int* tcg_iters) {
  extern __shared__ __align__(16) float smem[];
  rtr_full_agent<R, D, false>(
      args, smem, blockIdx.x / cg::this_cluster().num_blocks(), 0,
      initial_radius, max_rejections, grad_tol, X_out, stats, tcg_iters);
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// B3: args.S and args.g are the given curvature term Sc and gradient gc,
// which setup copies into the S records and kG.  f0 from a cost-only sweep
// (X copied to the output), then the attempts from the first, with no
// early exit; stats [A, 4].
template <int R, int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_spread_kernel(ArgsOf<R> args, float initial_radius, int max_rejections,
                  float* X_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxOf<R> cx = setup<R, D, false>(args, smem, a);
  float* xo = X_out + (size_t)a * rank_of<R>(cx) * K * cx.n;
  float s1[1] = {0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    if (!cx.own) continue;
    const int p = pose_of(cx, cx.pl);
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

// B1: one truncated CG from the given Sc and gc (as B3's) at the agent's
// radius; eta and Heta written back component-major, stats [A, 2]
// (iterations, hit the boundary).  No neighbor slot is read (s = 0) and
// every pose is live.
template <int R, int D>
__global__ void __launch_bounds__(kThreads, 1)
tcg_spread_kernel(ArgsOf<R> args, const float* radius, float* eta_out,
                  float* heta_out, float* stats) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxOf<R> cx = setup<R, D, false>(args, smem, a);
  const size_t off = (size_t)a * rank_of<R>(cx) * K * cx.n;
  bool hit;
  const int k = tcg<R, D>(cx, radius[a], args.max_iters, args.kappa,
                          args.theta, &hit);
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    if (!cx.own) continue;
    const int p = pose_of(cx, cx.pl);
    float et[K], he[K];
    ld_own<R, K>(cx, kEta, et);
    ld_own<R, K>(cx, kHeta, he);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      eta_out[off + (cx.row * K + q) * cx.n + p] = et[q];
      heta_out[off + (cx.row * K + q) * cx.n + p] = he[q];
    }
  }
  if (cx.rank == 0 && threadIdx.x == 0) {
    stats[(size_t)a * 2] = (float)k;
    stats[(size_t)a * 2 + 1] = hit ? 1.f : 0.f;
  }
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_refine_full_spread_kernel(ArgsOf<R> args, float initial_radius,
                              int max_rejections, float grad_tol,
                              float* D_out, float* stats, int* tcg_iters) {
  extern __shared__ __align__(16) float smem[];
  refine_agent<R, D, false>(
      args, smem, blockIdx.x / cg::this_cluster().num_blocks(), 0,
      initial_radius, max_rejections, grad_tol, D_out, stats, tcg_iters);
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// rtr_full_spread_kernel above r = 512, the rows folded (the fold kernels'
// note above).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_full_fold_kernel(SpreadArgsR args, float initial_radius,
                     int max_rejections, float grad_tol, float* X_out,
                     float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxF cx;
  static_cast<CtxR&>(cx) = setup_rt<D, false, true>(args, smem, a);
  cx.folds = pose_folds(cx.r);
  cx.row0 = cx.row;
  float* xo = X_out + (size_t)a * cx.r * K * cx.n;

  // Start point: G = egrad([X | Z]) into kG, S = sym(Y^T G_Y), then g =
  // P_X(G) over kG, f0.
  float s2[2] = {0.f, 0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    const int p = pose_of(cx, cx.pl);
    float m[NM] = {}, sy[D * D];
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float x[K], G[K] = {};
      ld_own<0, K>(cx, kX, x);
      if (cx.own) {
        sweep<0, D, true, true>(cx, kX, true, x, G, &s2[1]);
#pragma unroll
        for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = x[q];
        st_own<0, K>(cx, kG, G);
      }
      add_sym<D>(x, G, m);
    }
    fold_sym<D>(cx, m, sy);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      if (cx.own && cx.row == 0) {
#pragma unroll
        for (int i = 0; i < D * D; ++i)
          cx.S[(size_t)p * s_floats(D) + i] = sy[i];
      }
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

  const Attempts at = attempts_fold<D, false>(
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

// rtr_spread_kernel above r = 512, the rows folded: the cost sweep fold
// by fold, then attempts_fold.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_fold_kernel(SpreadArgsR args, float initial_radius, int max_rejections,
                float* X_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxF cx;
  static_cast<CtxR&>(cx) = setup_rt<D, false, true>(args, smem, a);
  cx.folds = pose_folds(cx.r);
  cx.row0 = cx.row;
  float* xo = X_out + (size_t)a * cx.r * K * cx.n;
  float s1[1] = {0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      if (!cx.own) continue;
      const int p = pose_of(cx, cx.pl);
      float x[K], unused[K];
      ld_own<0, K>(cx, kX, x);
      sweep<0, D, false, true>(cx, kX, true, x, unused, &s1[0]);
#pragma unroll
      for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = x[q];
    }
  }
  cluster_sum<1>(cx, s1);
  const float f0 = 0.5f * s1[0];
  const Attempts at = attempts_fold<D, false>(cx, args, xo, f0, 0,
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

// tcg_spread_kernel above r = 512, the rows folded: tcg_fold, then eta and
// Heta written back fold by fold.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tcg_fold_kernel(SpreadArgsR args, const float* radius, float* eta_out,
                float* heta_out, float* stats) {
  constexpr int K = D + 1;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxF cx;
  static_cast<CtxR&>(cx) = setup_rt<D, false, true>(args, smem, a);
  cx.folds = pose_folds(cx.r);
  cx.row0 = cx.row;
  const size_t off = (size_t)a * cx.r * K * cx.n;
  bool hit;
  const int k = tcg_fold<D>(cx, radius[a], args.max_iters, args.kappa,
                            args.theta, &hit);
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      if (!cx.own) continue;
      const int p = pose_of(cx, cx.pl);
      float et[K], he[K];
      ld_own<0, K>(cx, kEta, et);
      ld_own<0, K>(cx, kHeta, he);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        eta_out[off + (cx.row * K + q) * cx.n + p] = et[q];
        heta_out[off + (cx.row * K + q) * cx.n + p] = he[q];
      }
    }
  }
  if (cx.rank == 0 && threadIdx.x == 0) {
    stats[(size_t)a * 2] = (float)k;
    stats[(size_t)a * 2 + 1] = hit ? 1.f : 0.f;
  }
  cg::this_cluster().sync();  // no CTA leaves while its partials are read
}

// rtr_refine_full_spread_kernel above r = 512, the rows folded: the
// re-centered start's S1 and preconditioned gradient in three passes (kHd
// holds dG, kZv the solved gradient between them).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_refine_full_fold_kernel(SpreadArgsR args, float initial_radius,
                            int max_rejections, float grad_tol,
                            float* D_out, float* stats, int* tcg_iters) {
  constexpr int K = D + 1;
  constexpr int NM = D * (D + 1) / 2;
  constexpr int DD = D * D;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x / cg::this_cluster().num_blocks();
  CtxF cx;
  static_cast<CtxR&>(cx) = setup_rt<D, true, true>(args, smem, a);
  cx.folds = pose_folds(cx.r);
  cx.row0 = cx.row;
  const size_t off = (size_t)a * cx.r * K * cx.n;
  float* xo = D_out + off;
  const float* gref = args.Gref + off;

  float s3[3] = {0.f, 0.f, 0.f};
  for (int st = 0; st < cx.stripes; ++st) {
    at_stripe(cx, st);
    at_fold(cx, 0);
    const int p = pose_of(cx, cx.pl);
    float Lp[l_floats(D)], S0[DD] = {}, m[NM] = {}, S1[DD], St[DD];
    ld_factor<D>(cx, Lp);
    if (cx.own) {
#pragma unroll
      for (int j = 0; j < DD; ++j) S0[j] = cx.S[(size_t)p * s_floats(D) + j];
    }
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float dd[K], rc[K], y[K], G[K] = {}, gr[K] = {};
      ld_own<0, K>(cx, kD, dd);
      ld_own<0, K>(cx, kRc, rc);
#pragma unroll
      for (int q = 0; q < K; ++q) y[q] = rc[q] + dd[q];
      st_own<0, K>(cx, kX, y);
      if (cx.own) {
#pragma unroll
        for (int q = 0; q < K; ++q) gr[q] = gref[(cx.row * K + q) * cx.n + p];
        sweep<0, D, true, true, true>(cx, kD, true, dd, G, &s3[2]);
#pragma unroll
        for (int q = 0; q < K; ++q) xo[(cx.row * K + q) * cx.n + p] = dd[q];
        st_own<0, K>(cx, kHd, G);
      }
      int i = 0;
#pragma unroll
      for (int b = 0; b < D; ++b)
#pragma unroll
        for (int c = b; c < D; ++c, ++i)
          m[i] += 0.5f * (dd[b] * gr[c] + dd[c] * gr[b] + y[b] * G[c] +
                          y[c] * G[b]);
    }
    // Every thread has read S0 before the group sum's barriers, so fold 0's
    // row 0 may overwrite it after them.
    fold_sym<D>(cx, m, S1);
#pragma unroll
    for (int j = 0; j < DD; ++j) St[j] = S0[j] + S1[j];
    float m2[NM] = {}, sy[DD];
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      if (cx.own && cx.row == 0) {
#pragma unroll
        for (int j = 0; j < DD; ++j) cx.S[(size_t)p * s_floats(D) + j] = St[j];
      }
      float dd[K], rc[K], y[K], G[K], gv[K];
      ld_own<0, K>(cx, kD, dd);
      ld_own<0, K>(cx, kRc, rc);
      ld_own<0, K>(cx, kG, gv);  // g0
      ld_own<0, K>(cx, kHd, G);
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
#pragma unroll
      for (int q = 0; q < K; ++q) y[q] = rc[q] + dd[q];
      block_solve<D>(Lp, gv);
      st_own<0, K>(cx, kZv, gv);
      add_sym<D>(y, gv, m2);
    }
    fold_sym<D>(cx, m2, sy);
    for (int f = 0; f < cx.folds; ++f) {
      at_fold(cx, f);
      float y[K], gv[K];
      ld_own<0, K>(cx, kX, y);
      ld_own<0, K>(cx, kZv, gv);
      sub_ysym<D>(y, sy, gv);
      s3[1] += dot<K>(gv, gv);
    }
  }
  cluster_sum<3>(cx, s3);  // also publishes S to the pose's rows
  const float gn0 = sqrtf(s3[0]);
  const float radius = fminf(initial_radius, 10.f * sqrtf(s3[1]));
  const float f0 = s3[2];

  const Attempts at = attempts_fold<D, true>(
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

// Launch configuration of A clusters of C CTAs of the spread shape.
template <typename... KArgs>
int spread_config(void (*kern)(KArgs...), int A, int C,
                  const SpreadShape& sh, cudaStream_t stream,
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

// cudaOccupancyMaxActiveClusters of one kernel at (C, threads, bytes),
// asked once per process and shape (the answer belongs to the card).
template <typename... KArgs>
int max_clusters(void (*kern)(KArgs...), int C, const SpreadShape& sh,
                 int* count) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int, size_t>, int> seen;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  const auto key = std::make_tuple(device, reinterpret_cast<const void*>(kern),
                                   C, sh.threads, sh.smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *count = it->second;
    return 0;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = spread_config(kern, 1, C, sh, nullptr, &cfg, &attr);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(kern), &cfg);
  if (err != 0) return err;
  seen[key] = *count;
  return 0;
}

// Every launch first asks whether the card can place one cluster of this
// shape, and refuses with kUnplaceable when it cannot.
template <typename... KArgs, typename... Args>
int launch_spread(void (*kern)(KArgs...), int A, int C,
                  const SpreadShape& sh, cudaStream_t stream, Args... args) {
  if (C > kMaxCluster || sh.smem > kMaxSmemBytes) return kUnplaceable;
  int count = 0;
  int err = max_clusters(kern, C, sh, &count);
  if (err != 0) return err;
  if (count < 1) return kUnplaceable;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = spread_config(kern, A, C, sh, stream, &cfg, &attr);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != 0) return err;
  return (int)cudaGetLastError();
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
  static int rtr_full(const SpreadArgs& g, int r, int A, int C,
                      float initial_radius, int max_rejections,
                      float grad_tol, float* X_out, float* stats,
                      int* tcg_iters, cudaStream_t stream);
  static int rtr(const SpreadArgs& g, int r, int A, int C,
                 float initial_radius, int max_rejections, float* X_out,
                 float* stats, int* tcg_iters, cudaStream_t stream);
  static int tcg(const SpreadArgs& g, int r, int A, int C,
                 const float* radius, float* eta, float* heta, float* stats,
                 cudaStream_t stream);
  static int refine(const SpreadArgs& g, int r, int A, int C,
                    float initial_radius, int max_rejections, float grad_tol,
                    float* D_out, float* stats, int* tcg_iters,
                    cudaStream_t stream);
  static int query_clusters(int kernel, int r, int n, int C, int* count);
};

#if DPGO_PART >= 0

// The kernels' arguments at this shape: the rank joins them at R = 0.
template <int R>
ArgsOf<R> args_of(const SpreadArgs& g, int r) {
  if constexpr (R == 0) {
    SpreadArgsR a;
    static_cast<SpreadArgs&>(a) = g;
    a.r = r;
    return a;
  } else {
    return g;
  }
}

template <int R, int D>
int Launchers<R, D, true>::rtr_full(const SpreadArgs& g, int r, int A, int C,
                                    float initial_radius, int max_rejections,
                                    float grad_tol, float* X_out,
                                    float* stats, int* tcg_iters,
                                    cudaStream_t stream) {
  if (g.s > kIndexMask + 1) return kTooManySlots;
  const SpreadShape sh = spread_shape(r, D, g.n, C);
  if constexpr (R == 0) {
    if (pose_folds(r) > 1)
      return launch_spread(rtr_full_fold_kernel<D>, A, C, sh, stream,
                           args_of<0>(g, r), initial_radius, max_rejections,
                           grad_tol, X_out, stats, tcg_iters);
  }
  return launch_spread(rtr_full_spread_kernel<R, D>, A, C, sh, stream,
                       args_of<R>(g, r), initial_radius, max_rejections,
                       grad_tol, X_out, stats, tcg_iters);
}

template <int R, int D>
int Launchers<R, D, true>::rtr(const SpreadArgs& g, int r, int A, int C,
                               float initial_radius, int max_rejections,
                               float* X_out, float* stats, int* tcg_iters,
                               cudaStream_t stream) {
  if (g.s > kIndexMask + 1) return kTooManySlots;
  const SpreadShape sh = spread_shape(r, D, g.n, C);
  if constexpr (R == 0) {
    if (pose_folds(r) > 1)
      return launch_spread(rtr_fold_kernel<D>, A, C, sh, stream,
                           args_of<0>(g, r), initial_radius, max_rejections,
                           X_out, stats, tcg_iters);
  }
  return launch_spread(rtr_spread_kernel<R, D>, A, C, sh, stream,
                       args_of<R>(g, r), initial_radius, max_rejections,
                       X_out, stats, tcg_iters);
}

template <int R, int D>
int Launchers<R, D, true>::tcg(const SpreadArgs& g, int r, int A, int C,
                               const float* radius, float* eta, float* heta,
                               float* stats, cudaStream_t stream) {
  const SpreadShape sh = spread_shape(r, D, g.n, C);
  if constexpr (R == 0) {
    if (pose_folds(r) > 1)
      return launch_spread(tcg_fold_kernel<D>, A, C, sh, stream,
                           args_of<0>(g, r), radius, eta, heta, stats);
  }
  return launch_spread(tcg_spread_kernel<R, D>, A, C, sh, stream,
                       args_of<R>(g, r), radius, eta, heta, stats);
}

template <int R, int D>
int Launchers<R, D, true>::refine(const SpreadArgs& g, int r, int A, int C,
                                  float initial_radius, int max_rejections,
                                  float grad_tol, float* D_out, float* stats,
                                  int* tcg_iters, cudaStream_t stream) {
  if (g.s > kIndexMask + 1) return kTooManySlots;
  const SpreadShape sh = spread_shape(r, D, g.n, C);
  if constexpr (R == 0) {
    if (pose_folds(r) > 1)
      return launch_spread(rtr_refine_full_fold_kernel<D>, A, C, sh, stream,
                           args_of<0>(g, r), initial_radius, max_rejections,
                           grad_tol, D_out, stats, tcg_iters);
  }
  return launch_spread(rtr_refine_full_spread_kernel<R, D>, A, C, sh, stream,
                       args_of<R>(g, r), initial_radius, max_rejections,
                       grad_tol, D_out, stats, tcg_iters);
}

template <int R, int D>
int Launchers<R, D, true>::query_clusters(int kernel, int r, int n, int C,
                                          int* count) {
  const SpreadShape sh = spread_shape(r, D, n, C);
  if (C > kMaxCluster || sh.smem > kMaxSmemBytes) {
    *count = 0;
    return 0;
  }
  switch (kernel) {
    case kRtrFull:
      if constexpr (R == 0) {
        if (pose_folds(r) > 1)
          return max_clusters(rtr_full_fold_kernel<D>, C, sh, count);
      }
      return max_clusters(rtr_full_spread_kernel<R, D>, C, sh, count);
    case kRtr:
      if constexpr (R == 0) {
        if (pose_folds(r) > 1)
          return max_clusters(rtr_fold_kernel<D>, C, sh, count);
      }
      return max_clusters(rtr_spread_kernel<R, D>, C, sh, count);
    case kTcg:
      if constexpr (R == 0) {
        if (pose_folds(r) > 1)
          return max_clusters(tcg_fold_kernel<D>, C, sh, count);
      }
      return max_clusters(tcg_spread_kernel<R, D>, C, sh, count);
    case kRefine:
      if constexpr (R == 0) {
        if (pose_folds(r) > 1)
          return max_clusters(rtr_refine_full_fold_kernel<D>, C, sh, count);
      }
      return max_clusters(rtr_refine_full_spread_kernel<R, D>, C, sh, count);
  }
  return kUnknownKernel;
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

// The spread shape of kernel `kernel` for agents of n_max poses over C
// CTAs: writes P, threads, stripes and the rows a lane holds (pose_folds)
// to out[0..3] and returns the shared memory bytes of one CTA; -4 for an
// unknown kernel.
long long dpgo_rtr_spread_shape(int r, int d, int n_max, int C, int kernel,
                                void* out) {
  if (kernel < kRtrFull || kernel > kRefine) return kUnknownKernel;
  const SpreadShape sh = spread_shape(r, d, n_max, C);
  int* o = static_cast<int*>(out);
  o[0] = sh.P;
  o[1] = sh.threads;
  o[2] = sh.stripes;
  o[3] = pose_folds(r);
  return (long long)sh.smem;
}

// Floats of one agent's workspace on the spread route of `kernel`: B4's
// adds D, Rc and the reference residuals.
long long dpgo_rtr_spread_workspace_floats(int r, int d, int n_max, int e_max,
                                           int kinc, int C, int kernel) {
  return workspace_floats(r, d, n_max, e_max, kinc, C, kernel == kRefine);
}

// How many clusters of C CTAs of spread kernel `kernel` the card can hold
// at once (cudaOccupancyMaxActiveClusters) into *count, 0 for a shape whose
// shared memory does not fit; returns a cudaError_t, -1 for an (r, d)
// without instantiation, -4 for an unknown kernel.
int dpgo_rtr_spread_max_clusters(int r, int d, int n_max, int C, int kernel,
                                 void* count) {
  int* c = static_cast<int*>(count);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.query_clusters(kernel, r, n_max, C, c);
  });
}

int dpgo_rtr_full_spread_launch(
    int r, int d, int C, int A, int n, int s, int Ep, int T, int e_max,
    int kinc, const void* idx_i, const void* idx_j, const void* rot,
    const void* trn, const void* wk, const void* wt, const void* X,
    const void* Z, const void* L, const void* inc_slot, const void* inc_mask,
    const void* n_local, void* X_out, void* stats, void* tcg_iters, void* ws,
    long long ws_stride, int max_iters, float kappa, float theta,
    float initial_radius, int max_rejections, float grad_tol, void* stream) {
  const SpreadArgs g = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j, rot,
                                 trn, wk, wt, X, Z, nullptr, L, nullptr,
                                 inc_slot, inc_mask, n_local, ws, ws_stride,
                                 max_iters, kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr_full(g, r, A, C, initial_radius, max_rejections,
                              grad_tol, xo, st, it, cs);
  });
}

int dpgo_rtr_spread_launch(
    int r, int d, int C, int A, int n, int s, int Ep, int T, int e_max,
    int kinc, const void* idx_i, const void* idx_j, const void* rot,
    const void* trn, const void* wk, const void* wt, const void* X,
    const void* Z, const void* S, const void* L, const void* g,
    const void* inc_slot, const void* inc_mask, const void* n_local,
    void* X_out, void* stats, void* tcg_iters, void* ws, long long ws_stride,
    int max_iters, float kappa, float theta, float initial_radius,
    int max_rejections, void* stream) {
  const SpreadArgs a = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j, rot,
                                 trn, wk, wt, X, Z, S, L, g, inc_slot,
                                 inc_mask, n_local, ws, ws_stride, max_iters,
                                 kappa, theta);
  float* xo = static_cast<float*>(X_out);
  float* st = static_cast<float*>(stats);
  int* it = static_cast<int*>(tcg_iters);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.rtr(a, r, A, C, initial_radius, max_rejections, xo, st,
                         it, cs);
  });
}

int dpgo_tcg_spread_launch(
    int r, int d, int C, int A, int n, int Ep, int T, int e_max, int kinc,
    const void* idx_i, const void* idx_j, const void* rot, const void* trn,
    const void* wk, const void* wt, const void* X, const void* S,
    const void* L, const void* g, const void* radius, const void* inc_slot,
    const void* inc_mask, const void* n_local, void* eta, void* heta,
    void* stats, void* ws, long long ws_stride, int max_iters, float kappa,
    float theta, void* stream) {
  // The tCG sweeps are Hessian sweeps only: no neighbor slots are read.
  const SpreadArgs a = make_args(n, 0, Ep, T, e_max, kinc, idx_i, idx_j, rot,
                                 trn, wk, wt, X, X, S, L, g, inc_slot,
                                 inc_mask, n_local, ws, ws_stride, max_iters,
                                 kappa, theta);
  const float* rd = static_cast<const float*>(radius);
  float* e = static_cast<float*>(eta);
  float* h = static_cast<float*>(heta);
  float* st = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch<Launchers>(r, d, [&](auto launchers) {
    return launchers.tcg(a, r, A, C, rd, e, h, st, cs);
  });
}

int dpgo_rtr_refine_full_spread_launch(
    int r, int d, int C, int A, int n, int s, int Ep, int T, int e_max,
    int kinc, const void* idx_i, const void* idx_j, const void* rot,
    const void* trn, const void* wk, const void* wt, const void* rho_rot,
    const void* rho_trn, const void* Rc, const void* D, const void* Dz,
    const void* g0, const void* Gref, const void* S0, const void* L,
    const void* inc_slot, const void* inc_mask, const void* n_local,
    void* D_out, void* stats, void* tcg_iters, void* ws, long long ws_stride,
    int max_iters, float kappa, float theta, float initial_radius,
    int max_rejections, float grad_tol, void* stream) {
  SpreadArgs a = make_args(n, s, Ep, T, e_max, kinc, idx_i, idx_j, rot, trn,
                           wk, wt, D, Dz, S0, L, g0, inc_slot, inc_mask,
                           n_local, ws, ws_stride, max_iters, kappa, theta);
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

}  // extern "C"

#endif  // DPGO_PART < 0

}  // namespace dpgo_spread

// Fused single-step Riemannian trust-region solve of RBCD for agents that
// no cluster and no spread holds: the grid route of kernels B2 and B4.
//
// Replaces the TPU kernels of dpgo_tpu/ops/pallas_tcg.py for such agents
// (ops/rtr_kernel.cluster_plan picks the route from the shape and the
// card's SM count before the launch):
//   * _rtr_full_kernel (rtr_full_call) -> rtr_full_grid_kernel below: the
//     whole local solve of every agent for one RBCD round;
//   * _rtr_refine_full_kernel (rtr_refine_full_call) ->
//     rtr_refine_full_grid_kernel below: the re-centered step of the
//     terminal refinement.
// The functions are the spread kernels' (rtr_spread.cu), phase for phase:
// the phases of spread_core.cuh at GRID = true.
//
// Who lands here: an agent whose three shared vectors do not fit a cluster
// of 16 CTAs (above ~15k poses at r = 5, d = 3: a team of 1-6 robots on a
// 100,000-pose map, one PGOAgent with a large map, a served request of few
// large agents).  Before this route such an agent ran on the workspace
// route, one CTA of 256 threads on one SM, its time the chain of its
// poses' dependent phases.
//
// What bounds it on this card: as the spread route's, the traffic of the
// loop vectors (~1.2 KB a pose at r = 5 per tCG iteration) and the chain of
// loads each sweep waits on; per launch a few GFLOP and ~0.1 GB at config
// #5's 100,000 poses, 0.03-0.04 ms at the card's peaks.
//
// What the design does about it:
//   * The whole card: each of the A agents gets C = sms / A CTAs of 512
//     threads, one CTA an SM (33 at A = 4, 132 at A = 1), CTA c owning the
//     poses [c P, (c + 1) P), its lane groups walking them in stripes, as
//     on the spread route.
//   * Every loop vector in the agent's device-memory workspace, the CG
//     direction (twice) and z too: other CTAs read them at the other
//     endpoints, at L2 (ld.global.cg) after the barrier that published
//     them.  An ELL word holds the other endpoint's agent-wide pose index
//     (up to 2^20 poses an agent), not a cluster rank.
//   * One barrier per agent, not per grid: the agents leave their tCG and
//     attempt loops after different counts (grid_barrier).  The launch is
//     cooperative, so all A C CTAs are resident; where the card cannot
//     keep them so (another process holds SMs, or the build's occupancy),
//     the launcher refuses (kNotResident) and the wrapper raises: nothing
//     retries another route.  A wait past 5 s traps.
//   * Reductions through the workspace (grid_sum): each CTA's block sum in
//     its slot of the agent's buffer of this parity, two buffers so one
//     barrier per reduction suffices, every thread adding all C slots in
//     one fixed order.  Every loop condition is the same across the agent
//     and launches repeat bit for bit.
//   * No tensor cores, for rtr_spread.cu's reason.
//
// Layout: rtr_cluster.cu's inputs; ws [A, ws_stride] the workspace
// (dpgo_rtr_grid_workspace_floats): the reduction buffers [2][C][4] and
// the arrival counter (zeroed by the launcher before each launch), then
// the vectors [kVecs or kRefineVecs][C P][vec_stride] and the spread
// route's records.

#include "spread_core.cuh"

namespace dpgo_spread {
namespace {

// The launcher's own error codes: the card cannot keep A C CTAs of this
// shape resident at once; more poses in an agent than an ELL word can
// index (2^20).
constexpr int kNotResident = -5;
constexpr int kTooManyPoses = -6;

// The grid kernels' shape: the spread shape's CTAs, lane groups and
// stripes; shared memory holds only the block sums [warps][kMaxSums] and,
// above r = 32, the group-sum slots.
SpreadShape grid_shape(int r, int d, int n, int C) {
  SpreadShape sh = spread_shape(r, d, n, C);
  const int warps = sh.threads / 32;
  sh.smem = (size_t)(warps * kMaxSums + group_slots(r, warps)) *
            sizeof(float);
  return sh;
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_full_grid_kernel(ArgsOf<R> args, int C, float initial_radius,
                     int max_rejections, float grad_tol, float* X_out,
                     float* stats, int* tcg_iters) {
  extern __shared__ __align__(16) float smem[];
  rtr_full_agent<R, D, true>(args, smem, blockIdx.x / C, C, initial_radius,
                             max_rejections, grad_tol, X_out, stats,
                             tcg_iters);
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads, 1)
rtr_refine_full_grid_kernel(ArgsOf<R> args, int C, float initial_radius,
                            int max_rejections, float grad_tol, float* D_out,
                            float* stats, int* tcg_iters) {
  extern __shared__ __align__(16) float smem[];
  refine_agent<R, D, true>(args, smem, blockIdx.x / C, C, initial_radius,
                           max_rejections, grad_tol, D_out, stats,
                           tcg_iters);
}

// CTAs of one kernel at (threads, bytes) the card keeps resident at once:
// its blocks per SM times the SMs, asked once per process and shape.
template <typename... KArgs>
int resident_ctas(void (*kern)(KArgs...), const SpreadShape& sh,
                  int* count) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int> seen;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  const auto key = std::make_tuple(device, reinterpret_cast<const void*>(kern),
                                   sh.threads, sh.smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *count = it->second;
    return 0;
  }
  err = (int)raise_smem_limit(reinterpret_cast<const void*>(kern),
                              (int)sh.smem);
  if (err != 0) return err;
  int per_sm = 0, sms = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kern), sh.threads, sh.smem);
  if (err != 0) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (err != 0) return err;
  *count = per_sm * sms;
  seen[key] = *count;
  return 0;
}

// One cooperative launch of A C CTAs, after the agents' arrival counters
// are zeroed on the stream; kNotResident when the card cannot keep them
// all resident.
template <typename... KArgs, typename... Args>
int launch_grid(void (*kern)(KArgs...), int A, int C, const SpreadShape& sh,
                float* ws, long long ws_stride, cudaStream_t stream,
                Args... args) {
  if (sh.smem > kMaxSmemBytes) return kNotResident;
  int count = 0;
  int err = resident_ctas(kern, sh, &count);
  if (err != 0) return err;
  if ((long long)A * C > count) return kNotResident;
  err = (int)cudaMemset2DAsync(ws + 2 * C * kMaxSums,
                               (size_t)ws_stride * sizeof(float), 0,
                               sizeof(unsigned), A, stream);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(A * C);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// The launchers of one (r, d) (rtr_spread.cu's Launchers, for the grid
// kernels; shapes.cuh deals them to this source's parts).
template <int R, int D, bool kInPart = true>
struct GridLaunchers {};

template <int R, int D>
struct GridLaunchers<R, D, true> {
  static int rtr_full(const SpreadArgs& g, int r, int A, int C,
                      float initial_radius, int max_rejections,
                      float grad_tol, float* X_out, float* stats,
                      int* tcg_iters, cudaStream_t stream);
  static int refine(const SpreadArgs& g, int r, int A, int C,
                    float initial_radius, int max_rejections, float grad_tol,
                    float* D_out, float* stats, int* tcg_iters,
                    cudaStream_t stream);
  static int query_ctas(int kernel, int r, int n, int C, int* count);
};

#if DPGO_PART >= 0

template <int R>
ArgsOf<R> grid_args_of(const SpreadArgs& g, int r) {
  if constexpr (R == 0) {
    SpreadArgsR a;
    static_cast<SpreadArgs&>(a) = g;
    a.r = r;
    return a;
  } else {
    return g;
  }
}

// The lane layout holds a pose of at most 16 warps (r <= 512): above it
// only the fold kernels of the spread route do, and the grid route has
// none.
constexpr bool grid_rank_ok(int r) { return r <= kFoldRows; }

template <int R, int D>
int GridLaunchers<R, D, true>::rtr_full(const SpreadArgs& g, int r, int A,
                                        int C, float initial_radius,
                                        int max_rejections, float grad_tol,
                                        float* X_out, float* stats,
                                        int* tcg_iters, cudaStream_t stream) {
  if (!grid_rank_ok(r)) return dpgo_shapes::kUnsupportedShape;
  if (g.s > kIndexMask + 1) return kTooManySlots;
  if (g.n > kIndexMask + 1) return kTooManyPoses;
  return launch_grid(rtr_full_grid_kernel<R, D>, A, C,
                     grid_shape(r, D, g.n, C), g.ws, g.ws_stride, stream,
                     grid_args_of<R>(g, r), C, initial_radius,
                     max_rejections, grad_tol, X_out, stats, tcg_iters);
}

template <int R, int D>
int GridLaunchers<R, D, true>::refine(const SpreadArgs& g, int r, int A,
                                      int C, float initial_radius,
                                      int max_rejections, float grad_tol,
                                      float* D_out, float* stats,
                                      int* tcg_iters, cudaStream_t stream) {
  if (!grid_rank_ok(r)) return dpgo_shapes::kUnsupportedShape;
  if (g.s > kIndexMask + 1) return kTooManySlots;
  if (g.n > kIndexMask + 1) return kTooManyPoses;
  return launch_grid(rtr_refine_full_grid_kernel<R, D>, A, C,
                     grid_shape(r, D, g.n, C), g.ws, g.ws_stride, stream,
                     grid_args_of<R>(g, r), C, initial_radius,
                     max_rejections, grad_tol, D_out, stats, tcg_iters);
}

template <int R, int D>
int GridLaunchers<R, D, true>::query_ctas(int kernel, int r, int n, int C,
                                          int* count) {
  if (!grid_rank_ok(r)) return dpgo_shapes::kUnsupportedShape;
  const SpreadShape sh = grid_shape(r, D, n, C);
  switch (kernel) {
    case kRtrFull:
      return resident_ctas(rtr_full_grid_kernel<R, D>, sh, count);
    case kRefine:
      return resident_ctas(rtr_refine_full_grid_kernel<R, D>, sh, count);
  }
  return kUnknownKernel;
}

#define DPGO_INSTANTIATE(R_, D_) \
  template struct GridLaunchers<R_, D_, dpgo_shapes::in_part(R_, D_)>;
DPGO_SHAPES(DPGO_INSTANTIATE)
DPGO_GENERIC_SHAPES(DPGO_INSTANTIATE)
#undef DPGO_INSTANTIATE

#endif  // DPGO_PART >= 0

#if DPGO_PART < 0

using dpgo_shapes::dispatch;

extern "C" {

// The grid shape for agents of n_max poses over C CTAs: writes P, threads
// and stripes to out[0..2] and returns the shared memory bytes of one CTA.
long long dpgo_rtr_grid_shape(int r, int d, int n_max, int C, void* out) {
  const SpreadShape sh = grid_shape(r, d, n_max, C);
  int* o = static_cast<int*>(out);
  o[0] = sh.P;
  o[1] = sh.threads;
  o[2] = sh.stripes;
  return (long long)sh.smem;
}

// Floats of one agent's workspace on the grid route of `kernel` (B2 or B4;
// B4's adds D, Rc and the reference residuals); -4 for another kernel.
long long dpgo_rtr_grid_workspace_floats(int r, int d, int n_max, int e_max,
                                         int kinc, int C, int kernel) {
  if (kernel != kRtrFull && kernel != kRefine) return kUnknownKernel;
  return workspace_floats(r, d, n_max, e_max, kinc, C, kernel == kRefine,
                          true);
}

// CTAs of grid kernel `kernel` of this shape the card keeps resident at
// once into *count; returns a cudaError_t, -1 for an (r, d) without
// instantiation or above r = 512, -4 for a kernel without a grid route.
int dpgo_rtr_grid_max_ctas(int r, int d, int n_max, int C, int kernel,
                           void* count) {
  int* c = static_cast<int*>(count);
  return dispatch<GridLaunchers>(r, d, [&](auto launchers) {
    return launchers.query_ctas(kernel, r, n_max, C, c);
  });
}

int dpgo_rtr_full_grid_launch(
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
  return dispatch<GridLaunchers>(r, d, [&](auto launchers) {
    return launchers.rtr_full(g, r, A, C, initial_radius, max_rejections,
                              grad_tol, xo, st, it, cs);
  });
}

int dpgo_rtr_refine_full_grid_launch(
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
  return dispatch<GridLaunchers>(r, d, [&](auto launchers) {
    return launchers.refine(a, r, A, C, initial_radius, max_rejections,
                            grad_tol, dout, st, it, cs);
  });
}

}  // extern "C"

#endif  // DPGO_PART < 0

}  // namespace dpgo_spread

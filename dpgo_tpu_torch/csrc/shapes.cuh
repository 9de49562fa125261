// The (r, d) shapes every kernel of this directory is instantiated for,
// and how the build splits each source over translation units.
//
// Two kinds of instantiation:
//   * templated shapes: the ranks the staircase reaches with the JAX
//     package's defaults (r_max = 10), d = 3 with 3 <= r <= 10 and d = 2
//     with 2 <= r <= 10 (DPGO_SHAPES), each with r and d as template
//     parameters, its loops unrolled over them;
//   * the rank-generic instantiation, R = 0, one for each d in {2, 3}: the
//     kernels read r from the launch (any r >= kMinGenericRank).  A
//     source's R = 0 code keeps every per-thread array bounded by d (a lane
//     holds one row of d + 1 floats, or above r = 512 on the spread route
//     one at a time of its ceil(r / 512) folds), never by r (d + 1).  The
//     cluster route lays a pose over ceil(r / 32) warps of a CTA of at most
//     512 threads, so its launchers refuse r > 512 (a pose of more than 16
//     warps); the spread route folds such a pose's rows over 16 warps, as
//     far as its shared memory fits; the workspace route walks a pose's
//     rows one at a time and takes any rank.
// A launcher returns -1 for any other (r, d); the Python side keeps no copy
// of the templated list.
//
// The build (ops/rtr_kernel._compile) compiles each source several times,
// all at once, with -DDPGO_PARTS=n and -DDPGO_PART=p:
//   * a kernel part (0 <= p < n) defines the per-shape launchers and
//     instantiates them, with their kernels, for the templated shapes at
//     places p, p + n, p + 2n, ... of DPGO_SHAPES;
//   * the generic part (p = n) instantiates the launchers of R = 0 for both
//     d, so that they compile beside the templated shapes;
//   * the dispatch part (p = -1) holds the extern "C" entry points, which
//     pick the launchers of the (r, d) they are given (dispatch below) and
//     call them across translation units.
// A part's launchers are the static members of Launchers<R, D, true>,
// explicitly instantiated as Launchers<R, D, in_part(R, D)>: the shapes of
// other parts instantiate the empty Launchers<R, D, false>.

#pragma once

#define DPGO_SHAPES(X)                                                    \
  X(3, 3) X(4, 3) X(5, 3) X(6, 3) X(7, 3) X(8, 3) X(9, 3) X(10, 3)        \
  X(2, 2) X(3, 2) X(4, 2) X(5, 2) X(6, 2) X(7, 2) X(8, 2) X(9, 2) X(10, 2)

// The rank-generic instantiation: R = 0 at each d.
#define DPGO_GENERIC_SHAPES(X) X(0, 3) X(0, 2)

#if !defined(DPGO_PART) || !defined(DPGO_PARTS)
#error "compile with -DDPGO_PARTS=n -DDPGO_PART=p (ops/rtr_kernel._compile)"
#endif

namespace dpgo_shapes {

struct Shape {
  int r, d;
};

constexpr Shape kShapes[] = {
#define DPGO_SHAPE_ENTRY(R_, D_) {R_, D_},
    DPGO_SHAPES(DPGO_SHAPE_ENTRY)
#undef DPGO_SHAPE_ENTRY
};

// The lowest rank the generic instantiation serves: it takes every rank
// above the templated ones.
constexpr int kMinGenericRank = 11;

// The part that compiles the generic instantiation.
constexpr int kGenericPart = DPGO_PARTS;

// Whether this part instantiates (r, d): the templated shapes are dealt to
// the kernel parts in list order; R = 0 belongs to the generic part.
constexpr bool in_part(int r, int d) {
  if (r == 0) return DPGO_PART == kGenericPart;
  int i = 0;
  while (kShapes[i].r != r || kShapes[i].d != d) ++i;
  return i % DPGO_PARTS == DPGO_PART;
}

// What a launcher returns for an (r, d) without instantiation.
constexpr int kUnsupportedShape = -1;

// f(Launchers<R, D>{}) for a listed (r, d), f(Launchers<0, d>{}) for d in
// {2, 3} and r >= kMinGenericRank, else kUnsupportedShape:
// `Launchers` is a source's class of per-shape launchers (static members),
// which take r from their arguments at R = 0.
template <template <int, int, bool> class Launchers, typename F>
int dispatch(int r, int d, F&& f) {
#define DPGO_SHAPE_CASE(R_, D_) \
  if (r == R_ && d == D_) return f(Launchers<R_, D_, true>{});
  DPGO_SHAPES(DPGO_SHAPE_CASE)
#undef DPGO_SHAPE_CASE
  if (r >= kMinGenericRank) {
    if (d == 3) return f(Launchers<0, 3, true>{});
    if (d == 2) return f(Launchers<0, 2, true>{});
  }
  return kUnsupportedShape;
}

}  // namespace dpgo_shapes

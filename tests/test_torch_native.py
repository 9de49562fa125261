"""The port's native host paths (``dpgo_tpu_torch.utils.native_io``,
``graph_plan.plan_native``, ``g2o.read_g2o(backend=...)``), mirroring the
JAX package's ``tests/test_native_io.py`` and ``tests/test_graph_plan.py``
without their dataset cases, plus the port against the JAX package.

Bitwise: every planner against every other (integers), in the port and
across the packages; the Python parsers of the two packages; and in the
port the native loader against the Python parser on every field but
SE(3)'s ``tau``.  That one the C++ loader computes as
``3 / (tr adj(I) / det I)`` and the Python parser as ``3 / tr(inv(I))``
through LAPACK: they differ by up to one ulp, in the JAX package as in the
port (its own test allows 1e-9).  The two native libraries agree on every
integer, and on the floats to the JAX package's own native-against-Python
tolerance (1e-9 of the field's scale; measured: under 1e-15): the JAX
package's is built by ``native/Makefile`` with ``-march=native``, which
lets the compiler fuse multiply-adds, the port's with the portable ``-O3``
flags."""

import threading

import numpy as np
import pytest
import torch

from dpgo_tpu.utils import g2o as jg2o
from dpgo_tpu.utils import graph_plan as jplan
from dpgo_tpu.utils import native_io as jnative
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.utils import g2o, graph_plan, native_io
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements

FIELDS = ("r1", "p1", "r2", "p2", "R", "t", "kappa", "tau", "weight",
          "is_known_inlier")


def _assert_bitwise(a, b, ulp_fields=(), scale_tol=0.0):
    """Every field bitwise equal, but those in ``ulp_fields``: within one
    ulp of each entry, or with ``scale_tol`` within that much of the
    field's largest magnitude (at least 1)."""
    assert (a.d, a.num_poses, len(a)) == (b.d, b.num_poses, len(b))
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        if f not in ulp_fields:
            assert np.array_equal(x, y), f
        elif scale_tol:
            tol = scale_tol * max(1.0, float(np.abs(x).max()))
            assert np.all(np.abs(x - y) <= tol), f
        else:
            assert np.all(np.abs(x - y) <= np.spacing(np.abs(x))), f


def _native_vs_python(a, b):
    """Port native ``a`` against port Python ``b``: bitwise but for the
    one-ulp ``tau`` of SE(3) (module docstring)."""
    _assert_bitwise(a, b, ulp_fields=("tau",) if a.d == 3 else ())


def _native_vs_jax_native(a, b):
    """The two packages' native libraries (module docstring)."""
    _assert_bitwise(a, b, ulp_fields=("R", "t", "kappa", "tau"),
                    scale_tol=1e-9)


def _written(tmp_path, d, seed=0, n=40, num_lc=12):
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=d,
                                num_lc=num_lc, rot_noise=0.05,
                                trans_noise=0.05)
    path = str(tmp_path / f"g{d}_{seed}.g2o")
    g2o.write_g2o(meas, path)
    return path


def test_library_builds_into_the_ports_build_dir():
    lib = native_io.build()
    assert lib.parent == native_io.BUILD_DIR
    assert lib.name.startswith("libdpgo_native_") and lib.exists()
    assert native_io.native_available()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_matches_python_and_jax(tmp_path, d, seed):
    path = _written(tmp_path, d, seed)
    nat = g2o.read_g2o(path, backend="native")
    py = g2o.read_g2o(path, backend="python")
    _native_vs_python(nat, py)
    # Port against JAX: like against like, bitwise.
    _assert_bitwise(py, jg2o.read_g2o(path, backend="python"))
    _native_vs_jax_native(nat, jnative.read_g2o_native(path))
    _native_vs_jax_native(g2o.read_g2o(path), jg2o.read_g2o(path))
    _assert_bitwise(g2o.read_g2o_python(path), jg2o.read_g2o_python(path))


def test_native_key_encoded_multi_robot(tmp_path):
    """gtsam symbol keys (robot char in the top byte) round-trip exactly —
    they exceed 2^53, so a float path would corrupt the index bits."""
    def key(c, i):
        return (ord(c) << 56) | i

    info = "1 0 0 0 0 0 1 0 0 0 0 1 0 0 0 1 0 0 1 0 1"
    lines = []
    for c in "ab":
        for i in range(3):
            lines.append(f"EDGE_SE3:QUAT {key(c, i)} {key(c, i + 1)} "
                         f"1 0 0 0 0 0 1 {info}")
    lines.append(f"EDGE_SE3:QUAT {key('a', 0)} {key('b', 0)} "
                 f"0 1 0 0 0 0 1 {info}")
    p = tmp_path / "two_robot.g2o"
    p.write_text("\n".join(lines) + "\n")
    a = g2o.read_g2o_python(str(p))
    b = native_io.read_g2o_native(str(p))
    _assert_bitwise(a, b)
    _native_vs_jax_native(b, jnative.read_g2o_native(str(p)))
    assert set(int(x) for x in np.unique(b.r1)) | \
        set(int(x) for x in np.unique(b.r2)) == {ord("a"), ord("b")}


def test_native_accepts_fix_lines(tmp_path):
    info = "1 0 0 1 0 1"
    p = tmp_path / "fix.g2o"
    p.write_text("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\nFIX 0\n"
                 f"EDGE_SE2 0 1 1 0 0 {info}\n")
    _assert_bitwise(g2o.read_g2o_python(str(p)),
                    native_io.read_g2o_native(str(p)))


def test_native_error_surfaces(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        native_io.read_g2o_native(str(tmp_path / "missing.g2o"))
    bad = tmp_path / "bad.g2o"
    bad.write_text("EDGE_BOGUS 0 1\n")
    with pytest.raises(ValueError, match="unrecognized token"):
        native_io.read_g2o_native(str(bad))
    empty = tmp_path / "empty.g2o"
    empty.write_text("VERTEX_SE2 0 0 0 0\n")
    with pytest.raises(ValueError, match="no edges"):
        native_io.read_g2o_native(str(empty))
    trunc = tmp_path / "trunc.g2o"
    trunc.write_text("EDGE_SE3:QUAT 0 1 1 0 0\n"
                     "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n")
    with pytest.raises(ValueError, match="malformed"):
        native_io.read_g2o_native(str(trunc))


def test_backend_dispatch_surfaces(tmp_path):
    path = _written(tmp_path, 3)
    data = open(path, "rb").read()
    for mod in (g2o, jg2o):
        with pytest.raises(ValueError, match="filesystem path"):
            mod.read_g2o(data, backend="native")
        with pytest.raises(ValueError, match="unknown backend"):
            mod.read_g2o(path, backend="bogus")
    # In-memory sources parse in Python under "auto", as in JAX.
    _assert_bitwise(g2o.read_g2o(data), jg2o.read_g2o(data))


def test_auto_falls_back_to_python_with_the_jax_warning(tmp_path,
                                                        monkeypatch):
    path = _written(tmp_path, 2)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_load_error", None)

    def fail():
        raise RuntimeError("no C++ compiler (g++) to build the native loader")
    monkeypatch.setattr(native_io, "build", fail)
    with pytest.warns(UserWarning, match="falling back to the Python parser"):
        meas = g2o.read_g2o(path)
    _assert_bitwise(meas, g2o.read_g2o_python(path))
    with pytest.raises(RuntimeError, match="unavailable"):
        g2o.read_g2o(path, backend="native")
    with pytest.raises(RuntimeError, match="unavailable"):
        graph_plan.plan_topology(meas.r1, meas.p1, meas.r2, meas.p2, 1,
                                 meas.num_poses, backend="native")


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    """Four threads racing the first build: one compile, one library, no
    temporary left behind."""
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    calls = []
    real_run = native_io.subprocess.run

    def counting(*a, **kw):
        calls.append(a[0][0])
        return real_run(*a, **kw)
    monkeypatch.setattr(native_io.subprocess, "run", counting)
    out, errs = [], []

    def go():
        try:
            out.append(native_io.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)
    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and len(out) == 4 and len(set(out)) == 1
    assert len(calls) == 1
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == \
        [out[0].name]


@pytest.mark.parametrize("seed,n,A,lc", [(0, 48, 8, 20), (1, 100, 7, 40),
                                         (2, 30, 3, 12), (3, 20, 1, 5)])
def test_native_planner_matches_python_and_jax(seed, n, A, lc):
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=lc)
    part = partition_contiguous(meas, A)
    m = part.meas
    a = graph_plan.plan_native(m.r1, m.p1, m.r2, m.p2, A, part.n_max)
    for b in (graph_plan.plan_python(m.r1, m.p1, m.r2, m.p2, A, part.n_max),
              graph_plan.plan_topology(m.r1, m.p1, m.r2, m.p2, A,
                                       part.n_max),
              jplan.plan_topology(m.r1, m.p1, m.r2, m.p2, A, part.n_max),
              jplan.plan_python(m.r1, m.p1, m.r2, m.p2, A, part.n_max)):
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("backend", ["native", "python"])
def test_planners_reject_bad_input(backend):
    plan = getattr(graph_plan, f"plan_{backend}")
    r1 = np.array([0], np.int32)
    p1 = np.array([0], np.int64)
    r2 = np.array([5], np.int32)  # robot out of range for A=2
    p2 = np.array([0], np.int64)
    with pytest.raises(ValueError, match="out of range"):
        plan(r1, p1, r2, p2, 2, 4)
    with pytest.raises(ValueError, match="out of range"):
        plan(np.array([0], np.int32), np.array([9], np.int64),
             np.array([1], np.int32), np.array([0], np.int64), 2, 4)
    with pytest.raises(ValueError, match="unknown planner backend"):
        graph_plan.plan_topology(r1, p1, r2, p2, 2, 4, backend="bogus")


def test_build_graph_planner_backends_agree():
    meas, _ = make_measurements(np.random.default_rng(4), n=40, d=3,
                                num_lc=16, outlier_lc=3, rot_noise=0.01,
                                trans_noise=0.01)
    part = partition_contiguous(meas, 5)
    g1, m1 = rbcd.build_graph(part, 5, torch.float64, "cpu",
                              planner="python")
    g2, m2 = rbcd.build_graph(part, 5, torch.float64, "cpu",
                              planner="native")
    assert m1 == m2

    def leaves(tree):
        for t in tree:
            if isinstance(t, torch.Tensor):
                yield t
            elif isinstance(t, tuple):
                yield from leaves(t)
    for t1, t2 in zip(leaves(g1), leaves(g2)):
        assert t1.dtype == t2.dtype and torch.equal(t1, t2)


def test_partition_by_keys_matches_jax(tmp_path):
    """A multi-robot keyed file read natively and partitioned by its keys:
    the port's ``partition_by_keys`` equals the JAX package's."""
    from dpgo_tpu.utils.partition import partition_by_keys as j_pbk
    from dpgo_tpu_torch.utils.partition import partition_by_keys

    info = "1 0 0 0 0 0 1 0 0 0 0 1 0 0 0 1 0 0 1 0 1"
    lines = [f"EDGE_SE3:QUAT {(ord(c) << 56) | (i + 3)} "
             f"{(ord(c) << 56) | (i + 4)} 1 0 0 0 0 0 1 {info}"
             for c in "ab" for i in range(4)]
    lines.append(f"EDGE_SE3:QUAT {(ord('a') << 56) | 5} {ord('b') << 56 | 3} "
                 f"0 1 0 0 0 0 1 {info}")
    p = tmp_path / "keys.g2o"
    p.write_text("\n".join(lines) + "\n")
    meas = g2o.read_g2o(str(p), backend="native")
    a, b = partition_by_keys(meas), j_pbk(jg2o.read_g2o_python(str(p)))
    assert a.num_robots == b.num_robots == 2
    np.testing.assert_array_equal(a.n, b.n)
    np.testing.assert_array_equal(a.global_index, b.global_index)
    for f in ("r1", "p1", "r2", "p2"):
        np.testing.assert_array_equal(getattr(a.meas, f), getattr(b.meas, f))
        np.testing.assert_array_equal(getattr(a.meas_global, f),
                                      getattr(b.meas_global, f))
    assert a.meas_global.num_poses == b.meas_global.num_poses == 10

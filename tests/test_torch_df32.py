"""The port's double-float32 arithmetic (``dpgo_tpu_torch.ops.df32``)
against the JAX package's (``dpgo_tpu.ops.df32`` under ``precise_jit``, as
its own tests run it on the CPU) and against numpy float64.

Each case of ``tests/test_df32.py`` has a counterpart here.  The
primitives are bitwise equal to JAX's on the same float32 inputs: both
round every operation to float32 in IEEE order (the port's square root
takes its float32 estimate correctly rounded, as XLA's is).  Each case
also keeps the JAX test's accuracy bound against float64, and asserts that
``hi`` and ``lo`` are float32 — a float64 part would pass the accuracy
bounds vacuously on the CPU, where the port's default dtype is float64.
"""

import numpy as np
import pytest
import torch

from dpgo_tpu.ops import df32 as jdf
from dpgo_tpu_torch.ops import df32


def _rand(n, lo=-8, hi=8, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * np.exp(rng.uniform(lo, hi, n))


def _relerr(got64, ref64):
    return np.max(np.abs(got64 - ref64) / np.maximum(np.abs(ref64), 1e-300))


def _f64(a):
    return df32.from_f64(a, "cpu")


def _assert_f32(x):
    parts = x if isinstance(x, tuple) else (x,)
    for p in parts:
        assert p.dtype == torch.float32


def _assert_bitwise(ours, theirs):
    """A port result (a DF or a tuple of float32 tensors) equals JAX's bit
    for bit."""
    _assert_f32(tuple(ours))
    for o, t in zip(ours, theirs):
        assert np.array_equal(o.numpy().view(np.uint32),
                              np.asarray(t).view(np.uint32))


def test_from_f64_roundtrip():
    a = _rand(1000, seed=1)
    x = _f64(a)
    _assert_bitwise(x, jdf.from_f64(a))
    assert df32.to_f64(x).dtype == np.float64
    assert np.array_equal(df32.to_f64(x), jdf.to_f64(jdf.from_f64(a)))
    assert _relerr(df32.to_f64(x), a) < 2.0 ** -48
    a32 = a.astype(np.float32).astype(np.float64)
    assert np.array_equal(df32.to_f64(_f64(a32)), a32)


@pytest.mark.parametrize("prim", ["two_sum", "quick_two_sum", "two_prod"])
def test_error_free_transforms_match_jax_and_are_exact(prim):
    a, b = _rand(4096, seed=2), _rand(4096, seed=3)
    ta, tb = _f64(a).hi, _f64(b).hi
    if prim == "quick_two_sum":  # requires |a| >= |b|
        ta, tb = torch.maximum(ta.abs(), tb.abs()) * torch.sign(ta), \
            torch.minimum(ta.abs(), tb.abs())
    ours = getattr(df32, prim)(ta, tb)
    theirs = jdf.precise_jit(getattr(jdf, prim))(ta.numpy(), tb.numpy())
    _assert_bitwise(ours, theirs)
    a64, b64 = ta.double().numpy(), tb.double().numpy()
    exact = a64 * b64 if prim == "two_prod" else a64 + b64
    # Exact in float64 (the float32 parts have <= 48 significant bits
    # together; products of two 24-bit values are exact in 53 bits).
    assert np.array_equal(ours[0].double().numpy() + ours[1].double().numpy(),
                          exact)


def test_add_mul_relative_accuracy():
    a, b = _rand(4096, seed=2), _rand(4096, seed=3)
    da, db = _f64(a), _f64(b)
    s, p = df32.add(da, db), df32.mul(da, db)
    js, jp = jdf.precise_jit(
        lambda x, y: (jdf.add(x, y), jdf.mul(x, y)))(jdf.from_f64(a),
                                                     jdf.from_f64(b))
    _assert_bitwise(s, js)
    _assert_bitwise(p, jp)
    mag = np.maximum(np.abs(a), np.abs(b))
    assert np.max(np.abs(df32.to_f64(s) - (a + b)) / mag) < 1e-13
    assert _relerr(df32.to_f64(p), a * b) < 1e-13


def test_dot_and_fold_sum():
    a, b = _rand(5000, seed=4), _rand(5000, seed=5)
    da, db = _f64(a), _f64(b)
    d = df32.dot(da, db)
    _assert_bitwise(d, jdf.precise_jit(jdf.dot)(jdf.from_f64(a),
                                                jdf.from_f64(b)))
    ref = float(np.sum(a * b))
    assert abs(df32.to_f64(d) - ref) / abs(ref) < 1e-12
    s = df32.fold_sum(da)
    _assert_bitwise(s, jdf.precise_jit(jdf.fold_sum)(jdf.from_f64(a)))
    assert abs(df32.to_f64(s) - a.sum()) / max(abs(a.sum()), 1e-300) < 1e-11


def test_fold_sum_cancellation():
    """+x and -x pairs plus a tiny residual: float32 loses it, df32 keeps
    ~1e-9 relative."""
    x = _rand(512, 0, 6, seed=6)
    tiny = _rand(512, -14, -10, seed=8)
    seq = np.concatenate([x, -x, tiny])
    got = df32.fold_sum(_f64(seq))
    _assert_bitwise(got, jdf.precise_jit(jdf.fold_sum)(jdf.from_f64(seq)))
    s = df32.to_f64(got)
    ref = seq.sum()
    f32_s = float(np.float32(seq.astype(np.float32).sum()))
    assert abs(s - ref) / abs(ref) < 1e-6
    assert abs(s - ref) < abs(f32_s - ref) / 100


def test_matmul_small():
    a = _rand(6 * 5 * 3, seed=9).reshape(6, 5, 3)
    b = _rand(6 * 3 * 4, seed=10).reshape(6, 3, 4)
    got = df32.matmul_small(_f64(a), _f64(b))
    _assert_bitwise(got, jdf.precise_jit(jdf.matmul_small)(
        jdf.from_f64(a), jdf.from_f64(b)))
    mag = np.abs(a) @ np.abs(b)
    assert np.max(np.abs(df32.to_f64(got) - a @ b) / mag) < 1e-13


def test_div_sqrt():
    a = np.abs(_rand(2048, seed=11)) + 1e-6
    b = np.abs(_rand(2048, seed=12)) + 1e-6
    q = df32.div(_f64(a), _f64(b))
    _assert_bitwise(q, jdf.precise_jit(jdf.div)(jdf.from_f64(a),
                                                jdf.from_f64(b)))
    assert _relerr(df32.to_f64(q), a / b) < 1e-12
    r = df32.sqrt(_f64(a))
    _assert_bitwise(r, jdf.precise_jit(jdf.sqrt)(jdf.from_f64(a)))
    assert _relerr(df32.to_f64(r), np.sqrt(a)) < 1e-12


def test_sym_scale_sub():
    m = _rand(4 * 3 * 3, seed=13).reshape(4, 3, 3)
    s = df32.sym(_f64(m))
    _assert_bitwise(s, jdf.precise_jit(jdf.sym)(jdf.from_f64(m)))
    assert _relerr(df32.to_f64(s), 0.5 * (m + np.swapaxes(m, -1, -2))) \
        < 1e-13
    d = df32.sub(_f64(m), _f64(m))
    _assert_f32(tuple(d))
    assert np.all(df32.to_f64(d) == 0.0)
    t = df32.transpose(_f64(m), (0, 2, 1))
    assert np.array_equal(df32.to_f64(t), np.swapaxes(
        df32.to_f64(_f64(m)), -1, -2))


def test_from_f32_and_mixed_ops_stay_float32():
    """On the CPU the port's default dtype is float64: a float64 operand
    must not leak into a df32 value."""
    x = df32.from_f32(torch.tensor([1.5, -2.25], dtype=torch.float64))
    _assert_f32(tuple(x))
    assert not bool(x.lo.any())
    y = df32.add_f(x, torch.tensor([3.0, 0.5], dtype=torch.float32))
    z = df32.mul_f(y, torch.tensor([0.1, 7.0], dtype=torch.float32))
    _assert_f32(tuple(z))
    _assert_bitwise(z, jdf.precise_jit(lambda a, b, c: jdf.mul_f(
        jdf.add_f(a, b), c))(jdf.from_f32(np.array([1.5, -2.25])),
                             np.array([3.0, 0.5], np.float32),
                             np.array([0.1, 7.0], np.float32)))
    w = df32.index(df32.scale(z, 2.0), torch.tensor([1]))
    assert float(w.hi[0]) == 2.0 * float(z.hi[1])

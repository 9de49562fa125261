"""The port's certification (``dpgo_tpu_torch.models.certify``, its
LOBPCG ``ops.lobpcg`` and the sync-free small decompositions of
``ops.smallmat``) and the certified terminal epilogue of
``models.rbcd`` against the JAX package's, in float64 on the CPU, on
problems made with numpy from a seed.

The port draws its probes from a ``torch.Generator``; here JAX's draws
(``PRNGKey(seed)`` for the power iteration, ``fold_in(key, 1)`` for
LOBPCG's block) are fed through the seam ``certify._probe_draws``, so both
eigensolves start from the same vectors.  Tolerances: the operator maps
1e-12; the eigensolver outputs rtol 1e-8 (the two LOBPCGs stop on the
same rule but their small decompositions are different algorithms:
Jacobi against LAPACK), the direction up to sign at 1e-6 where the
spectral gap is clear; the numpy/scipy host tier rtol 1e-12; the
decision ladders exactly.  Quantities that are rounding noise at an
optimum (a deflation residual, a gauge eigenvalue) are held at an
absolute tolerance of 1e-9 of the spectral shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import certify as jcert
from dpgo_tpu.models import local_pgo as jlocal
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.ops import solver as jsolver
from dpgo_tpu.types import edge_set_from_measurements as j_edges
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu.utils.synthetic import make_stitched_winding as j_winding
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.models import certify, local_pgo, rbcd
from dpgo_tpu_torch.ops import lobpcg, smallmat, solver
from dpgo_tpu_torch.types import Measurements
from dpgo_tpu_torch.types import edge_set_from_measurements as t_edges
from dpgo_tpu_torch.utils.synthetic import make_stitched_winding

EIG_RTOL, DIR_TOL, HOST_RTOL = 1e-8, 1e-6, 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_probe_draws(seed, n, dh, num_probe, dtype, device):
    """JAX's draws of ``_min_eig_jit`` / ``device_certificate_payload``
    for ``seed``, in the port's seam signature."""
    key = jax.random.PRNGKey(int(seed))
    v0 = np.array(jax.random.normal(key, (n, 1, dh), jnp.float64))
    V0 = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                    (n * dh, num_probe), jnp.float64))
    return interop.fixed_probe_draws({int(seed): (v0, V0)})(
        seed, n, dh, num_probe, dtype, device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(certify, "_probe_draws", jax_probe_draws)


def _tmeas(meas):
    return Measurements(**{f: getattr(meas, f)
                           for f in meas.__dataclass_fields__})


def _meas(seed=0, n=12, num_lc=6, d=3):
    return make_measurements(np.random.default_rng(seed), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]


def _edges(meas):
    return (j_edges(meas, dtype=jnp.float64),
            t_edges(_tmeas(meas), dtype=torch.float64, device="cpu"))


def _optimum(meas, rank=5):
    res = jlocal.solve_local(meas, rank=rank, grad_norm_tol=1e-9,
                             max_iters=500)
    return np.array(res.X)


def _moving(meas, iters=2, rank=5):
    """A non-stationary iterate: ``iters`` RTR iterations from chordal."""
    je, _ = _edges(meas)
    from dpgo_tpu.ops import chordal as jchordal
    from dpgo_tpu.utils.lie import lifting_matrix

    X0 = jlocal.lift(jchordal.chordal_initialization(je, meas.num_poses),
                     lifting_matrix(rank, meas.d, jnp.float64))
    out = jsolver.rtr_solve(jlocal.make_problem(je, meas.num_poses), X0,
                            jconfig.SolverParams(initial_radius=1e1,
                                                 max_inner_iters=50),
                            max_iters=iters, grad_norm_tol=0.0)
    return np.array(out.X)


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol,
                               atol=atol)


def _gap_is_clear(X, edges, shift=0.0, rel=1e-3):
    """Is the bottom eigenvalue of S (of S on the complement of the
    gauge zeros when ``shift`` is the deflation) separated from the next?
    From the dense f64 spectrum of the assembled operator."""
    w = np.linalg.eigvalsh(certify.sparse_certificate(X, edges).toarray())
    if shift:
        w = w[np.abs(w) > shift]
    return w[1] - w[0] > rel * max(1.0, abs(w[0]))


def _same_direction(a, b, tol=DIR_TOL):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < tol


# ---------------------------------------------------------------------------
# The small decompositions and LOBPCG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 5, 12, 15])
def test_eigh_small_matches_linalg(n):
    rng = np.random.default_rng(n)
    B = torch.as_tensor(rng.standard_normal((3, n, n)))
    A = B + B.transpose(-1, -2)
    A[1] = A[1] @ A[1].T                      # PSD, spread spectrum
    if n > 2:
        A[2, :, : n // 2] = 0.0               # exact zero eigenvalues
        A[2, : n // 2, :] = 0.0
    w, V = smallmat.eigh_small(A)
    w_ref = torch.linalg.eigvalsh(A)
    scale = A.abs().amax(dim=(-2, -1), keepdim=True)[..., 0]
    assert ((w - w_ref).abs() <= 1e-12 * scale).all()
    assert torch.all(w[..., 1:] >= w[..., :-1])
    rec = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    assert ((rec - A).abs() <= 1e-12 * scale[..., None]).all()
    assert torch.allclose(V.transpose(-1, -2) @ V,
                          torch.eye(n, dtype=A.dtype), atol=1e-12)


@pytest.mark.parametrize("m,r", [(40, 4), (100, 5), (600, 7), (3, 3)])
def test_svd_thin_matches_linalg(m, r):
    rng = np.random.default_rng(m + r)
    A = torch.as_tensor(rng.standard_normal((m, r)))
    A[:, 0] = 2.0 * A[:, 1]                   # rank deficient
    A[:, -1] *= 1e-9                          # a small singular value
    U, s, V = smallmat.svd_thin(A)
    s_ref = torch.linalg.svdvals(A)
    assert torch.all(s[1:] <= s[:-1])
    assert ((s - s_ref).abs() <= 1e-12 * s_ref[0]).all()
    # Relative accuracy of the small (nonzero) singular value.
    assert abs(float(s[-2] / s_ref[-2]) - 1.0) < 1e-9
    assert torch.allclose(U @ torch.diag(s) @ V.T, A, atol=1e-12)
    keep = s > 1e-6 * s[0]
    Uk = U[:, keep]
    assert torch.allclose(Uk.T @ Uk, torch.eye(int(keep.sum()),
                                               dtype=A.dtype), atol=1e-12)


def test_qr_small_and_det_small_match_linalg():
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.standard_normal((8, 4)))
    q_ref, _ = torch.linalg.qr(A)
    assert torch.allclose(smallmat.qr_small(A), q_ref, atol=1e-12)
    A[:, 2] = 0.0
    q = smallmat.qr_small(A)
    assert torch.allclose(q.T @ q, torch.eye(4, dtype=A.dtype), atol=1e-12)
    for d in (1, 2, 3, 4):
        M = torch.as_tensor(rng.standard_normal((5, d, d)))
        assert torch.allclose(smallmat.det_small(M), torch.linalg.det(M),
                              rtol=1e-12, atol=1e-12)


def test_lobpcg_matches_jax():
    from jax.experimental.sparse.linalg import lobpcg_standard

    rng = np.random.default_rng(0)
    n = 120
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.concatenate([np.linspace(0.1, 5.0, n - 4), [7.0, 8.0, 9.0,
                                                        10.0]])
    M = Q @ np.diag(ev) @ Q.T
    X0 = rng.standard_normal((n, 3))
    for m in (4, 200):
        th_j, U_j, it_j = lobpcg_standard(jnp.asarray(M), jnp.asarray(X0),
                                          m=m)
        th_t, U_t, it_t = lobpcg.lobpcg_standard(
            lambda V: torch.as_tensor(M) @ V, torch.as_tensor(X0), m=m)
        _close(th_j, th_t, rtol=1e-10)
        for c in range(3):
            _same_direction(np.asarray(U_j)[:, c], U_t[:, c].numpy())
        if m == 4:
            assert int(it_t) == int(it_j) == 4
        else:
            assert int(it_t) < m
    with pytest.raises(ValueError, match="search dim"):
        lobpcg.lobpcg_standard(lambda V: V, torch.zeros(10, 2))


# ---------------------------------------------------------------------------
# The operator and the weight scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["moving", "optimum"])
def test_dual_blocks_and_certificate_matvec_match_jax(where):
    meas = _meas()
    je, te = _edges(meas)
    X = _moving(meas) if where == "moving" else _optimum(meas)
    lam_j = jcert.dual_blocks(jnp.asarray(X), je)
    lam_t = certify.dual_blocks(torch.as_tensor(X), te)
    _close(lam_j, lam_t, rtol=1e-12, atol=1e-12)
    V = np.random.default_rng(1).standard_normal((meas.num_poses, 6, 4))
    _close(jcert.certificate_matvec(jnp.asarray(V), je, lam_j),
           certify.certificate_matvec(torch.as_tensor(V), te, lam_t),
           rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("live", ["even", "odd", "none"])
def test_weight_scale_matches_jax(live):
    meas = _meas(n=20, num_lc=8)
    je, te = _edges(meas)
    rng = np.random.default_rng(4)
    M = len(meas)
    w = rng.uniform(0.2, 2.0, M)
    mask = np.ones(M)
    off = {"even": M % 2 + 2, "odd": 1 - M % 2 + 2, "none": M}[live]
    mask[rng.permutation(M)[:off]] = 0.0
    je = je._replace(weight=jnp.asarray(w), mask=jnp.asarray(mask))
    te = te._replace(weight=torch.as_tensor(w), mask=torch.as_tensor(mask))
    host = certify.weight_scale(te)
    assert host == jcert.weight_scale(je)
    dev = float(certify.weight_scale_device(te))
    assert dev == float(jcert.weight_scale_device(je))
    if live == "even":
        # The median of an even count averages the two middle values,
        # where torch.nanmedian takes the lower one.
        assert int(mask.sum()) % 2 == 0
        x = (w * mask * meas.kappa)[mask > 0]
        assert float(certify._masked_median(
            torch.as_tensor(w * mask * meas.kappa),
            torch.as_tensor(mask > 0))) == float(np.median(x))
        assert float(np.median(x)) != float(torch.as_tensor(x).nanmedian())
    if live == "none":
        assert host == dev == 1.0


# ---------------------------------------------------------------------------
# The eigensolves, with JAX's draws
# ---------------------------------------------------------------------------

def _winding(n_cycles=3, cycle_len=12):
    meas, Xw = j_winding(n_cycles, cycle_len)
    tm, Xt = make_stitched_winding(n_cycles, cycle_len)
    assert np.array_equal(Xw, Xt)
    for f in meas.__dataclass_fields__:
        assert np.array_equal(np.asarray(getattr(meas, f)),
                              np.asarray(getattr(tm, f))), f
    return meas, Xw


@pytest.mark.parametrize("case", ["moving", "wound"])
def test_min_eig_matches_jax(case, jax_draws):
    if case == "wound":
        meas, X = _winding()
    else:
        meas = _meas()
        X = _moving(meas)
    je, te = _edges(meas)
    k = certify._clamp_probes(4, X.shape[0] * X.shape[2])
    lam_j, vec_j, stat_j, sig_j = jcert._min_eig_jit(
        jnp.asarray(X), je, jax.random.PRNGKey(0), num_probe=k)
    lam_t, vec_t, stat_t, sig_t = certify._min_eig(
        torch.as_tensor(X), te, 0, num_probe=k)
    _close(sig_j, sig_t, rtol=EIG_RTOL)
    _close(lam_j, lam_t, rtol=EIG_RTOL)
    _close(stat_j, stat_t, rtol=EIG_RTOL, atol=1e-12)
    if case == "wound":
        assert float(lam_t) < -1e-3
    if _gap_is_clear(X, te):
        _same_direction(vec_j, vec_t.numpy())


@pytest.mark.parametrize("case", ["moving", "optimum", "wound", "tiny"])
def test_device_certificate_payload_matches_jax(case, jax_draws):
    if case == "wound":
        meas, X = _winding()
    elif case == "tiny":
        meas = _meas(n=4, num_lc=2)
        X = _optimum(meas)
    else:
        meas = _meas()
        X = _moving(meas) if case == "moving" else _optimum(meas)
    je, te = _edges(meas)
    pj = interop.payload_to_numpy(jcert.device_certificate_payload(
        jnp.asarray(X), je, jax.random.PRNGKey(0)))
    pt = interop.payload_to_numpy(certify.device_certificate_payload(
        torch.as_tensor(X), te, 0))
    sig = pj["sigma"]
    noise = 1e-9 * sig
    _close(pj["sigma"], pt["sigma"], rtol=EIG_RTOL)
    _close(pj["wscale"], pt["wscale"], rtol=0.0)
    _close(pj["stat"], pt["stat"], rtol=EIG_RTOL, atol=noise)
    _close(pj["defl_resid"], pt["defl_resid"], rtol=EIG_RTOL, atol=noise)
    _close(pj["lam_min"], pt["lam_min"], rtol=EIG_RTOL, atol=noise)
    _close(pj["rq"], pt["rq"], rtol=EIG_RTOL, atol=noise)
    if case in ("moving", "wound") and _gap_is_clear(X, te, 1e-9 * sig):
        _same_direction(pj["direction"], pt["direction"])
    eps = float(np.finfo(np.float64).eps)
    cj = jcert.decide_device_certificate(pj, 1e-5, eps)
    ct = certify.decide_device_certificate(pt, 1e-5, eps)
    assert (ct.device_verdict, ct.certified, ct.decidable) == \
        (cj.device_verdict, cj.certified, cj.decidable)
    expect = {"optimum": certify.CERT_ACCEPT, "wound": certify.CERT_FAIL,
              "tiny": certify.CERT_ACCEPT}
    if case in expect:
        assert ct.device_verdict == expect[case]


def test_certify_solution_matches_jax_f64_and_f32_refusal(jax_draws):
    meas = _meas(n=15)
    je, te = _edges(meas)
    X = _optimum(meas)
    cj = jcert.certify_solution(jnp.asarray(X), je)
    ct = certify.certify_solution(torch.as_tensor(X), te)
    assert (ct.certified, ct.decidable) == (cj.certified, cj.decidable)
    assert ct.certified and ct.weight_scale == cj.weight_scale
    _close(cj.sigma, ct.sigma, rtol=EIG_RTOL)
    _close(cj.lambda_min, ct.lambda_min, rtol=EIG_RTOL, atol=1e-9 * cj.sigma)
    # f32 on the same problem at an eta below its error band: refused
    # without the f64 verification, decided (certified) with it.
    je32 = j_edges(meas, dtype=jnp.float32)
    te32 = t_edges(_tmeas(meas), dtype=torch.float32, device="cpu")
    X32 = np.asarray(X, np.float32)
    for verify in ("never", "auto"):
        cj = jcert.certify_solution(jnp.asarray(X32), je32, eta=5e-8,
                                    f64_verify=verify)
        ct = certify.certify_solution(torch.as_tensor(X32), te32, eta=5e-8,
                                      f64_verify=verify)
        assert (ct.certified, ct.decidable) == (cj.certified, cj.decidable)
        assert (ct.lambda_min_f64 is None) == (cj.lambda_min_f64 is None)
    assert ct.certified and ct.decidable


# ---------------------------------------------------------------------------
# The decision ladders
# ---------------------------------------------------------------------------

def _payload(lam, sigma, rq, wscale, defl):
    return {"lam_min": lam, "sigma": sigma, "rq": rq, "wscale": wscale,
            "defl_resid": defl, "stat": 1e-9,
            "direction": np.zeros((2, 4))}


def _f64(lam, resid):
    return lambda t: (lam, None, resid)


LAMS = [0.0, -5e-6, -2e-5, -3e-3, 1e-3]
SIGMAS = [1.0, 1e4, 1e9, 1e11]
F64 = [None, (0.0, 1e-9), (-1.0, 1e-9), (-1e-5, 1e-4)]


@pytest.mark.parametrize("eps", [2.220446049250313e-16, 1.1920929e-07])
def test_decide_device_certificate_ladder_matches_jax(eps):
    seen = set()
    for lam in LAMS:
        for sigma in SIGMAS:
            for rq in (lam, lam - 1.0):
                for defl in (0.0, 1.0):
                    for f64 in F64:
                        p = _payload(lam, sigma, rq, 1.0, defl)
                        fs = None if f64 is None else _f64(*f64)
                        cj = jcert.decide_device_certificate(
                            p, 1e-5, eps, f64_solve=fs)
                        ct = certify.decide_device_certificate(
                            p, 1e-5, eps, f64_solve=fs)
                        got = (ct.device_verdict, ct.certified,
                               ct.decidable, ct.lambda_min_f64, ct.tol)
                        assert got == (cj.device_verdict, cj.certified,
                                       cj.decidable, cj.lambda_min_f64,
                                       cj.tol)
                        seen.add((ct.device_verdict, ct.certified,
                                  ct.decidable))
    # Every rung: ACCEPT, decided FAIL, REFUSE undecided, REFUSE decided
    # by f64 both ways.
    assert {(1, True, True), (3, False, True), (2, False, False),
            (2, True, True), (2, False, True)} <= seen


@pytest.mark.parametrize("eps", [2.220446049250313e-16, 1.1920929e-07])
def test_decide_certificate_ladder_matches_jax(eps):
    seen = set()
    for lam in LAMS:
        for sigma in SIGMAS:
            for f64 in F64:
                fs = None if f64 is None else _f64(*f64)
                tj = jcert.decide_certificate(lam, sigma, 1e-5, eps, fs)
                tt = certify.decide_certificate(lam, sigma, 1e-5, eps, fs)
                assert tt == tj
                seen.add(tt[:2])
    assert {(True, True), (False, True), (False, False)} <= seen


# ---------------------------------------------------------------------------
# The host f64 tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["optimum", "wound"])
def test_sparse_certificate_is_identical(case):
    if case == "wound":
        meas, X = _winding()
    else:
        meas = _meas()
        X = _optimum(meas)
    je, te = _edges(meas)
    Sj = jcert.sparse_certificate(X, je)
    St = certify.sparse_certificate(X, te)
    assert np.array_equal(Sj.indptr, St.indptr)
    assert np.array_equal(Sj.indices, St.indices)
    assert np.array_equal(Sj.data, St.data)


def test_lambda_min_f64_matches_jax():
    meas = _meas()
    je, te = _edges(meas)
    X = _optimum(meas)
    lj = jcert.lambda_min_f64(X, je)
    lt = certify.lambda_min_f64(X, te)
    _close(lj[0], lt[0], rtol=HOST_RTOL, atol=1e-14)
    _close(lj[2], lt[2], rtol=HOST_RTOL)
    measw, Xw = _winding()
    jw, tw = _edges(measw)
    for kw in ({}, {"deflate": True}):
        lj = jcert.lambda_min_f64(Xw, jw, **kw)
        lt = certify.lambda_min_f64(Xw, tw, **kw)
        _close(lj[0], lt[0], rtol=HOST_RTOL)
        _close(lj[1], lt[1], rtol=HOST_RTOL, atol=1e-14)
        assert lt[0] < -1e-3
    # The shift-invert route (on its own, and through lambda_min_f64's
    # size switch being bypassed by calling it directly).
    for tol_cert in (1e-4, 1e-1):
        lj = jcert.lambda_min_f64_shift_invert(Xw, jw, tol_cert=tol_cert)
        lt = certify.lambda_min_f64_shift_invert(Xw, tw, tol_cert=tol_cert)
        _close(lj[0], lt[0], rtol=HOST_RTOL)
        _close(lj[2], lt[2], rtol=HOST_RTOL, atol=1e-14)
    lj = jcert.lambda_min_f64_shift_invert(X, je, tol_cert=1e-4)
    lt = certify.lambda_min_f64_shift_invert(X, te, tol_cert=1e-4)
    _close(lj[0], lt[0], rtol=HOST_RTOL, atol=1e-14)


# ---------------------------------------------------------------------------
# The staircase
# ---------------------------------------------------------------------------

def test_escape_rank_matches_jax(jax_draws):
    meas, Xw = _winding()
    je, te = _edges(meas)
    cert = jcert.certify_solution(jnp.asarray(Xw), je)
    v = np.array(cert.direction)
    Xj = jcert.escape_rank(jnp.asarray(Xw), jnp.asarray(v), je)
    Xt = certify.escape_rank(torch.as_tensor(Xw), torch.as_tensor(v), te)
    assert Xt.shape == (meas.num_poses, 3, 3)
    _close(Xj, Xt, rtol=1e-12, atol=1e-14)
    # A flat direction finds no improving step: the new row stays zero.
    Xt0 = certify.escape_rank(torch.as_tensor(Xw), torch.zeros(
        meas.num_poses, 3, dtype=torch.float64), te, max_halvings=3)
    assert float(Xt0[:, 2].abs().max()) == 0.0


def _jax_staircase(meas, X, r_max=6):
    """The JAX package's staircase loop (``solve_staircase``'s body) from a
    given iterate."""
    je = j_edges(meas, dtype=jnp.float64)
    params = jconfig.SolverParams(initial_radius=1e1, max_inner_iters=50)
    problem = jlocal.make_problem(je, meas.num_poses, params.precond_shift)
    X = jnp.asarray(X)
    hist = []
    for r in range(X.shape[1], r_max + 1):
        out = jsolver.rtr_solve(problem, X, params, max_iters=300,
                                grad_norm_tol=1e-6)
        X = out.X
        cert = jcert.certify_solution(X, je, seed=r)
        hist.append((r, float(out.f), cert.lambda_min))
        if cert.certified or r == r_max:
            return hist, cert
        X = jcert.escape_rank(X, cert.direction, je)


def _torch_staircase(meas, X, r_max=6):
    """The port's staircase loop (``solve_staircase``'s body) from a given
    iterate, as ``_jax_staircase``."""
    te = t_edges(_tmeas(meas), dtype=torch.float64, device="cpu")
    params = tconfig.SolverParams(initial_radius=1e1, max_inner_iters=50)
    problem = local_pgo.make_problem(te, meas.num_poses,
                                     params.precond_shift)
    X = torch.as_tensor(X)
    hist = []
    for r in range(X.shape[1], r_max + 1):
        out = solver.rtr_solve(problem, X, params, max_iters=300,
                               grad_norm_tol=1e-6)
        X = out.X
        cert = certify.certify_solution(X, te, seed=r)
        hist.append((r, float(out.f), cert.lambda_min))
        if cert.certified or r == r_max:
            return hist, cert, X
        X = certify.escape_rank(X, cert.direction, te)


def test_staircase_escapes_the_stitched_winding_as_jax(jax_draws):
    meas, Xw = _winding()
    hist_j, cert_j = _jax_staircase(meas, Xw)
    hist_t, cert_t, X = _torch_staircase(meas, Xw)
    assert [h[0] for h in hist_t] == [h[0] for h in hist_j]
    _close([h[1] for h in hist_j], [h[1] for h in hist_t], rtol=1e-9,
           atol=1e-12)
    assert cert_t.certified == cert_j.certified
    assert cert_t.certified and hist_t[-1][0] >= 3
    assert hist_t[0][1] > 1.0 and hist_t[0][2] < -1e-3
    assert hist_t[-1][1] < 1e-6
    T = local_pgo.round_solution(X, certify._recover_rounding_basis(X, 2))
    R = T[..., :2]
    assert torch.allclose(R.transpose(-1, -2) @ R,
                          torch.eye(2, dtype=R.dtype), atol=1e-8)


def test_solve_staircase_matches_jax(jax_draws):
    meas = _meas(n=16, num_lc=6)
    rj = jcert.solve_staircase(meas, grad_norm_tol=1e-8)
    rt = certify.solve_staircase(_tmeas(meas), grad_norm_tol=1e-8,
                                 device="cpu")
    assert [h[0] for h in rt.history] == [h[0] for h in rj.history]
    _close([h[1] for h in rj.history], [h[1] for h in rt.history],
           rtol=1e-9)
    assert rt.certificate.certified == rj.certificate.certified
    assert rt.rank == rj.rank
    _close(rj.cost, rt.cost, rtol=1e-9)


# ---------------------------------------------------------------------------
# The certified solve
# ---------------------------------------------------------------------------

def _solve_pair(mode, verdict_every, max_iters=12):
    meas = _meas(seed=5, n=24, num_lc=10)
    kw = dict(max_iters=max_iters, eval_every=4, grad_norm_tol=1e-9,
              verdict_every=verdict_every)
    jr = jrbcd.solve_rbcd(meas, 2, params=jconfig.AgentParams(
        d=3, r=5, num_robots=2, rel_change_tol=0.0, certify_mode=mode),
        dtype=jnp.float64, **kw)
    tr = rbcd.solve_rbcd(_tmeas(meas), 2, params=tconfig.AgentParams(
        d=3, r=5, num_robots=2, rel_change_tol=0.0, certify_mode=mode),
        device="cpu", **kw)
    return jr, tr


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("verdict_every", [None, 8])
def test_certified_solve_matches_jax(mode, verdict_every, jax_draws):
    jr, tr = _solve_pair(mode, verdict_every)
    assert tr.iterations == jr.iterations
    cj, ct = jr.certificate, tr.certificate
    assert (ct.certified, ct.decidable, ct.device_verdict) == \
        (cj.certified, cj.decidable, cj.device_verdict)
    # The eigensolves' own rounding is a few ulps of sigma.
    _close(cj.lambda_min, ct.lambda_min, rtol=EIG_RTOL,
           atol=1e-12 * cj.sigma)
    _close(cj.sigma, ct.sigma, rtol=EIG_RTOL)
    _close(cj.stationarity_gap, ct.stationarity_gap, rtol=EIG_RTOL)
    assert ct.tol == cj.tol
    if mode == "device":
        assert ct.device_verdict != certify.CERT_NONE
    else:
        assert ct.device_verdict == certify.CERT_NONE


def test_certified_solve_single_terminal_fetch(monkeypatch):
    """certify_mode="device" adds no host sync: the verdict loop reads
    rounds / K words plus ONE fused terminal fetch that carries the
    certificate payload."""
    meas = _meas(seed=42, n=50, num_lc=25)
    params = tconfig.AgentParams(d=3, r=5, num_robots=2, rel_change_tol=0.0,
                                 certify_mode="device")
    count = [0]
    orig = rbcd._host_fetch

    def counting(x):
        count[0] += 1
        return orig(x)
    monkeypatch.setattr(rbcd, "_host_fetch", counting)
    res = rbcd.solve_rbcd(_tmeas(meas), 2, params=params, max_iters=32,
                          eval_every=4, grad_norm_tol=0.0,
                          verdict_every=16, device="cpu")
    assert res.iterations == 32
    assert count[0] == 32 // 16 + 1
    cert = res.certificate
    assert cert is not None and cert.device_verdict != certify.CERT_NONE
    if cert.certified:
        assert cert.stationarity_gap < 1e-3
    # The per-eval loop: one fetch per eval plus one terminal fetch.
    count[0] = 0
    res = rbcd.solve_rbcd(_tmeas(meas), 2, params=params, max_iters=8,
                          eval_every=4, grad_norm_tol=0.0, device="cpu")
    assert count[0] == 8 // 4 + 1 and res.certificate is not None
    assert res.T.device.type == "cpu"


def test_certify_off_keeps_certificate_none():
    meas = _meas(seed=1, n=24, num_lc=8)
    res = rbcd.solve_rbcd(_tmeas(meas), 2, params=tconfig.AgentParams(
        d=3, r=5, num_robots=2), max_iters=8, eval_every=4,
        verdict_every=4, device="cpu")
    assert res.certificate is None


def test_certificate_to_numpy_carries_every_field(jax_draws):
    meas = _meas()
    je, te = _edges(meas)
    X = _optimum(meas)
    nj = interop.certificate_to_numpy(jcert.certify_solution(
        jnp.asarray(X), je))
    nt = interop.certificate_to_numpy(certify.certify_solution(
        torch.as_tensor(X), te))
    assert set(nj) == set(nt)
    assert nt["direction"].shape == nj["direction"].shape


def _witness(path):
    """The JAX package's eigensolves on the iterate that
    ``dpgo_tpu_torch.experiments.cert_witness`` wrote to ``path``, with
    its own draws (seed 0), beside the port's on the CPU with the same
    draws and the numbers in the file: one JSON line."""
    import json

    from dpgo_tpu_torch.experiments import cert_witness

    z = np.load(path)
    X = z["X"]
    meas = cert_witness.standin()
    je, te = _edges(meas)
    key = jax.random.PRNGKey(cert_witness.SEED)
    lam, vec, stat, sigma = jcert._min_eig_jit(jnp.asarray(X), je, key)
    vec = np.array(vec)
    lam_b = np.array(jcert.dual_blocks(jnp.asarray(X), je))
    Sv = np.array(jcert.certificate_matvec(jnp.asarray(vec[:, None, :]), je,
                                           jnp.asarray(lam_b)))[:, 0]
    pay = jcert.device_certificate_payload(jnp.asarray(X), je, key)
    row = {"jax": {"lambda_min": float(lam), "sigma": float(sigma),
                   "stationarity_gap": float(stat),
                   "rq": float(np.sum(vec * Sv) / np.sum(vec * vec)),
                   "payload_lam_min": float(pay["lam_min"]),
                   "payload_sigma": float(pay["sigma"]),
                   "payload_rq": float(pay["rq"]),
                   "payload_defl_resid": float(pay["defl_resid"])}}
    orig = certify._probe_draws
    certify._probe_draws = jax_probe_draws
    try:
        Xt = torch.as_tensor(X)
        cert = certify.certify_solution(Xt, te, seed=cert_witness.SEED)
        tpay = certify.device_certificate_payload(Xt, te, cert_witness.SEED)
    finally:
        certify._probe_draws = orig
    row["port_cpu"] = {
        "lambda_min": cert.lambda_min, "sigma": cert.sigma,
        "stationarity_gap": cert.stationarity_gap,
        "rq": cert_witness.rayleigh(Xt, te, cert.direction),
        "payload_lam_min": float(tpay["lam_min"]),
        "payload_sigma": float(tpay["sigma"]),
        "payload_rq": float(tpay["rq"]),
        "payload_defl_resid": float(tpay["defl_resid"])}
    row["file"] = {k: float(z[k]) for k in row["jax"] if k in z.files}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    # python tests/test_torch_certify.py draws OUT.npz | witness IN.npz
    # (JAX_PLATFORMS=cpu, from the root of the checkout).
    import sys

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    mode, path = sys.argv[1:3]
    if mode == "draws":
        from dpgo_tpu_torch.experiments import cert_witness

        m = cert_witness.standin()
        v0, V0 = jax_probe_draws(cert_witness.SEED, m.num_poses, 4, 4,
                                 torch.float64, "cpu")
        np.savez(path, v0=v0.numpy(), V0=V0.numpy())
    else:
        _witness(path)

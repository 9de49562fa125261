"""The port's distributed certificate (``parallel.certify``:
``certify_sharded``, the distributed block LOBPCG over all-reduced Grams
with the sync-free ``smallmat`` factorizations, and
``solve_staircase_sharded``) against the JAX package's
``dpgo_tpu.parallel.certify`` and the centralized certificates, at the
tolerance of ``tests/test_dist_certify.py``: lambda_min within
``1e-3 * max(1, sigma)``, the stationarity gap within ``1e-6 * max(1,
sigma)``, the same verdict.  The random probes differ between the
packages (the port's draw through ``certify._probe_draws``); the converged
eigenvalue does not depend on them at that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.parallel import certify as jdcert
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import types as ttypes
from dpgo_tpu_torch.models import certify, rbcd
from dpgo_tpu_torch.parallel import certify as dcert
from dpgo_tpu_torch.parallel import make_mesh
from dpgo_tpu_torch.parallel.world import spawn_world
from dpgo_tpu_torch.types import edge_set_from_measurements
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

A, ROUNDS = 8, 150
#: The kill bound of the 4-rank world.  ``python -m
#: dpgo_tpu_torch.experiments.world_timing`` splits such a world: 3-4 s
#: start and join the interpreters, the rest is the job on every rank
#: (eager compute and 1,916 or 3,642 gloo all-reduces, each waiting on the
#: slowest rank), so the world stretches with the host's load: 35-81 s
#: were seen under the tier-1 run's six workers.  Three times the worst.
WORLD_BOUND_S = 240


def _meas(pkg, n=48):
    make = tmake if pkg == "torch" else jmake
    return make(np.random.default_rng(42), n=n, d=3, num_lc=n // 2,
                rot_noise=0.01, trans_noise=0.01)[0]


def _params(mod):
    return mod.AgentParams(d=3, r=5, num_robots=A)


_SETUP = {}


def _setup(meas, rounds=ROUNDS, r=5):
    key = (meas.num_poses, meas.d, rounds, r)
    if key not in _SETUP:
        _SETUP[key] = _build(meas, rounds, r)
    return _SETUP[key]


def _build(meas, rounds, r):
    params = tconfig.AgentParams(d=meas.d, r=r, num_robots=A)
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, r, torch.float64, "cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    state = rbcd.init_state(graph, meta, X0, params=params)
    if rounds:
        state = rbcd.rbcd_steps(state, graph, rounds, meta, params)
    Xg = rbcd.gather_to_global(state.X, graph, meas.num_poses)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float64, device="cpu")
    return state, graph, part, Xg, edges_g


_JREF = {}
_CENTRAL = {}


def _central(Xg, edges_g, key):
    """The centralized certificate of the (weighted) problem, once per
    module."""
    if key not in _CENTRAL:
        _CENTRAL[key] = certify.certify_solution(Xg, edges_g)
    return _CENTRAL[key]


def _weighted(graph, part, edges_g, wA):
    wg = np.ones(len(part.meas_global))
    ids, m = graph.meas_id.numpy(), graph.edges.mask.numpy() > 0
    wg[ids[m]] = wA[m]
    return edges_g._replace(weight=torch.as_tensor(wg))


def _jax_cert(weights=None):
    key = weights is not None
    if key not in _JREF:
        meas = _meas("jax")
        part = jpartition(meas, A)
        graph, meta = jrbcd.build_graph(part, 5, jnp.float64)
        X0 = jrbcd.centralized_chordal_init(part, meta, graph, jnp.float64)
        p = _params(jconfig)
        state = jrbcd.rbcd_steps(jrbcd.init_state(graph, meta, X0, params=p),
                                 graph, ROUNDS, meta, p)
        _JREF[key] = jdcert.certify_sharded(
            state.X, graph, mesh=jmake_mesh(4),
            weights=None if weights is None else jnp.asarray(weights))
    return _JREF[key]


def _close(cd, c):
    scale = max(1.0, c.sigma)
    assert abs(cd.sigma - c.sigma) < 0.2 * scale
    assert abs(cd.stationarity_gap - c.stationarity_gap) < 1e-6 * scale
    assert abs(cd.lambda_min - c.lambda_min) < 1e-3 * scale
    assert cd.certified == c.certified


def _weights(graph, part):
    rw = np.random.default_rng(7)
    wg = 0.3 + 0.7 * rw.random(len(part.meas_global))
    return wg[graph.meas_id.numpy()] * graph.edges.mask.numpy()


def test_sharded_certificate_matches_centralized_and_jax():
    state, graph, part, Xg, edges_g = _setup(_meas("torch"))
    c = _central(Xg, edges_g, "unit")
    cd = dcert.certify_sharded(state.X, graph, mesh=make_mesh(device="cpu"))
    _close(cd, c)
    _close(cd, _jax_cert())
    assert cd.certified
    assert cd.direction.shape == (A, state.X.shape[1], 4)


def test_sharded_certificate_on_four_ranks(tmp_path):
    """Four gloo ranks against JAX's 4-device mesh and the port's own
    world-1 certificate; every rank returns the same value."""
    state, graph, part, Xg, edges_g = _setup(_meas("torch"))
    c = _central(Xg, edges_g, "unit")
    wA = _weights(graph, part)
    jobs = [("dpgo_tpu_torch.parallel.world:certify_job",
             dict(meas=_meas("torch"), num_robots=A,
                  params=_params(tconfig), rounds=ROUNDS, weights=w))
            for w in (None, wA)]
    out = spawn_world(4, "dpgo_tpu_torch.parallel.world:multi_job",
                      kwargs=dict(jobs=jobs), workdir=tmp_path,
                      timeout_s=WORLD_BOUND_S)
    for r in out[1:]:
        assert r[0]["lambda_min"] == out[0][0]["lambda_min"]
        assert np.array_equal(r[0]["direction"], out[0][0]["direction"])

    class R:
        def __init__(self, d):
            self.__dict__.update(d)

    _close(R(out[0][0]), c)
    _close(R(out[0][0]), _jax_cert())
    cw = _central(Xg, _weighted(graph, part, edges_g, wA), "weighted")
    _close(R(out[0][1]), cw)
    _close(R(out[0][1]), _jax_cert(wA))


def test_sharded_certificate_uses_given_weights():
    state, graph, part, Xg, edges_g = _setup(_meas("torch"))
    wA = _weights(graph, part)
    c = _central(Xg, _weighted(graph, part, edges_g, wA), "weighted")
    cd = dcert.certify_sharded(state.X, graph, mesh=make_mesh(device="cpu"),
                               weights=torch.as_tensor(wA))
    _close(cd, c)
    c_unit = _central(Xg, edges_g, "unit")
    assert abs(c.stationarity_gap - c_unit.stationarity_gap) > 1e-9


def _winding(n=16):
    """The rank-2 critical winding of an identity SE(2) cycle (the JAX
    package's ``tests/test_certify.py`` construction)."""
    edges = np.asarray([(k, (k + 1) % n) for k in range(n)])
    m = len(edges)
    meas = ttypes.Measurements(
        d=2, num_poses=n, r1=np.zeros(m, np.int32),
        p1=edges[:, 0].astype(np.int64), r2=np.zeros(m, np.int32),
        p2=edges[:, 1].astype(np.int64), R=np.tile(np.eye(2), (m, 1, 1)),
        t=np.zeros((m, 2)), kappa=np.full(m, 10.0), tau=np.full(m, 1.0),
        weight=np.ones(m), is_known_inlier=np.zeros(m, bool))
    th = 2 * np.pi * np.arange(n) / n
    Rw = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                   np.stack([np.sin(th), np.cos(th)], -1)], -2)
    return meas, np.concatenate([Rw, np.zeros((n, 2, 1))], axis=-1)


def test_sharded_certificate_detects_suboptimality():
    meas, Xw = _winding()
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, 2, torch.float64, "cpu")
    Xa = rbcd.scatter_to_agents(torch.as_tensor(Xw), graph)
    Xg = rbcd.gather_to_global(Xa, graph, meas.num_poses)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float64, device="cpu")
    c = certify.certify_solution(Xg, edges_g)
    assert not c.certified and c.lambda_min < -1e-3
    cd = dcert.certify_sharded(Xa, graph, mesh=make_mesh(device="cpu"))
    assert not cd.certified
    assert abs(cd.lambda_min - c.lambda_min) < 1e-2 * abs(c.lambda_min)


def test_sharded_staircase_certifies_clean_graph():
    meas = tmake(np.random.default_rng(42), n=32, d=3, num_lc=16,
                 rot_noise=0.01, trans_noise=0.01)[0]
    T, Xa, rank, cert, hist = dcert.solve_staircase_sharded(
        meas, A, mesh=make_mesh(device="cpu"), r_max=6,
        rounds_per_rank=60, dtype=torch.float64)
    assert cert.certified
    assert rank == meas.d + 1 and len(hist) == 1
    assert T.shape == (meas.num_poses, meas.d, meas.d + 1)
    assert Xa.shape[0] == A


def test_probe_draw_seam_feeds_the_certificate(monkeypatch):
    """Every random draw of the sharded certificate passes through
    ``_probe_draws``: fixed draws give the same value twice."""
    state, graph, *_ = _setup(_meas("torch"), rounds=20)
    calls = []
    orig = dcert._probe_draws

    def fixed(seed, rank, A_loc, n, dh, p, dtype, device):
        calls.append((seed, rank))
        return orig(0, 0, A_loc, n, dh, p, dtype, device)

    monkeypatch.setattr(dcert, "_probe_draws", fixed)
    kw = dict(mesh=make_mesh(device="cpu"), sub_iters=20, power_iters=10)
    a = dcert.certify_sharded(state.X, graph, seed=3, **kw)
    b = dcert.certify_sharded(state.X, graph, seed=4, **kw)
    assert calls == [(3, 0), (4, 0)]
    assert a.lambda_min == b.lambda_min

"""Resilience of the port's sharded plane (``dpgo_tpu_torch.parallel.
resilience`` behind ``solve_rbcd_sharded(resilience=...)``): the pieces
against the JAX package's (the same seeded faults, the same checkpoint
files), and the chaos scenarios of ``tests/test_mesh_resilience.py`` on a
4-rank gloo world against JAX's 4-device mesh: the same recoveries, mesh
sizes, fault kinds, injector stats and checkpoints, and histories at rtol
1e-9 (the resumed history's length pins the rewind iteration).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.parallel import resilience as jres
from dpgo_tpu.parallel import solve_rbcd_sharded as jsolve
from dpgo_tpu.serve.session import SessionStore as JSessionStore
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.parallel import (CollectiveFaultInjector,
                                     DeviceLostError, MeshFaultError,
                                     MeshFaultSpec, ResilienceConfig,
                                     Watchdog, shrink_mesh_size,
                                     solve_rbcd_sharded)
from dpgo_tpu_torch.parallel import resilience as resilience_mod
from dpgo_tpu_torch.parallel import sharded as sharded_mod
from dpgo_tpu_torch.parallel.world import spawn_world
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

A, K, ROUNDS = 8, 4, 24
JOB = "dpgo_tpu_torch.parallel.world:solve_job"


@pytest.fixture(autouse=True)
def _no_ambient_run():
    obs.end_run()
    yield
    obs.end_run()


def _noisy(pkg, seed=3, n=24, num_lc=6, noise=0.01):
    make = tmake if pkg == "torch" else jmake
    return make(np.random.default_rng(seed), n=n, d=3, num_lc=num_lc,
                rot_noise=noise, trans_noise=noise)[0]


def _params(mod):
    return mod.AgentParams(d=3, r=5, num_robots=A, rel_change_tol=0.0)


def _graph_for(meas):
    params = _params(tconfig)
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, params.r, torch.float64, "cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    return graph, meta, rbcd.init_state(graph, meta, X0, params=params)


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def test_resilience_config_validation(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        ResilienceConfig()
    with pytest.raises(ValueError, match="rewind_on"):
        ResilienceConfig(checkpoint_dir=str(tmp_path),
                         rewind_on=("non_finite", "flux_capacitor"))
    with pytest.raises(ValueError, match="checkpoint_every"):
        ResilienceConfig(checkpoint_dir=str(tmp_path), checkpoint_every=0)
    with pytest.raises(ValueError, match="fetch_deadline_s"):
        ResilienceConfig(checkpoint_dir=str(tmp_path), fetch_deadline_s=0.0)
    with pytest.raises(ValueError, match="max_rewinds"):
        ResilienceConfig(checkpoint_dir=str(tmp_path), max_rewinds=-1)
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"), keep=4)
    store = cfg.resolve_store(device="cpu")
    assert store.keep == 4 and store.device.type == "cpu"
    with pytest.raises(ValueError, match="verdict_every"):
        solve_rbcd_sharded(_noisy("torch"), A, params=_params(tconfig),
                           max_iters=4, device="cpu",
                           resilience=ResilienceConfig(
                               checkpoint_dir=str(tmp_path)))


@pytest.mark.parametrize("cur,A_,floor", [(8, 8, 1), (4, 8, 1), (2, 8, 1),
                                          (1, 8, 1), (4, 12, 1), (8, 8, 4),
                                          (4, 8, 4)])
def test_shrink_mesh_size_matches_jax(cur, A_, floor):
    assert shrink_mesh_size(cur, A_, floor) == \
        jres.shrink_mesh_size(cur, A_, floor)


def test_watchdog_deadline_names_phase():
    wd = Watchdog(0.15)
    release = threading.Event()
    try:
        with pytest.raises(MeshFaultError) as ei:
            wd.fetch(lambda x: release.wait(30.0), None, "sharded_verdict")
        assert ei.value.kind == "fetch_timeout"
        assert ei.value.phase == "sharded_verdict"
        assert "watchdog deadline" in str(ei.value)
        # The stuck worker was abandoned: a fresh fetch works at once.
        assert wd.fetch(lambda x: x + 1, 41, "gn_tail") == 42
    finally:
        release.set()
        wd.close()
    with pytest.raises(ValueError, match="deadline"):
        Watchdog(0.0)


def test_fetch_guard_composes_with_counting_shim():
    counted = [0]
    orig = rbcd._host_fetch

    def shim(x):
        counted[0] += 1
        return orig(x)

    rbcd._host_fetch = shim
    try:
        with resilience_mod.fetch_guard(Watchdog(5.0), None,
                                        ["sharded_verdict"], close=True):
            assert rbcd._host_fetch is not shim
            out = rbcd._host_fetch(torch.tensor([1.0, 2.0]))
            assert out.tolist() == [1.0, 2.0]
        assert rbcd._host_fetch is shim
    finally:
        rbcd._host_fetch = orig
    assert counted[0] == 1


def test_injector_poisons_the_pose_jax_poisons():
    """Same seed -> the same poisoned (agent, public pose) as the JAX
    package's injector; another seed moves it; on a mesh block only the
    owner rank's copy is written."""
    graph, _meta, state = _graph_for(_noisy("torch"))
    jgraph, _ = jrbcd.build_graph(jpartition(_noisy("jax"), A), 5)
    jstate = jrbcd.init_state(jgraph, _, jnp.zeros(
        (A,) + tuple(state.X.shape[1:])), params=_params(jconfig))

    def poisoned(seed, pkg):
        mod = resilience_mod if pkg == "torch" else jres
        inj = mod.CollectiveFaultInjector(
            mod.MeshFaultSpec(nan_halo_rounds=(2,)), seed=seed)
        inj.arm(graph if pkg == "torch" else jgraph)
        st = state if pkg == "torch" else jstate
        for _ in range(3):
            st = inj.before_dispatch(st, 1)
        assert inj.stats["rounds_dispatched"] == 3
        assert inj.stats["halo_nan"] == 1
        bad = np.argwhere(~np.isfinite(np.asarray(st.X)))
        a, p = int(bad[0][0]), int(bad[0][1])
        assert p in set(graph.pub_idx[a].tolist())
        return a, p

    assert poisoned(11, "torch") == poisoned(11, "jax")
    assert poisoned(12, "torch") == poisoned(12, "jax")
    assert poisoned(11, "torch") != poisoned(12, "torch")
    a, p = poisoned(11, "torch")

    def block(lo):
        inj = CollectiveFaultInjector(MeshFaultSpec(nan_halo_rounds=(0,)),
                                      seed=11)
        inj.arm(graph)
        return inj.before_dispatch(state._replace(X=state.X[lo:lo + 2]), 0,
                                   offset=lo, num_robots=A).X

    owner = 2 * (a // 2)
    assert torch.isnan(block(owner)[a - owner, p]).all()
    other = (owner + 2) % A
    assert torch.equal(block(other), state.X[other:other + 2])


def test_injector_wrap_exchange_and_installed_hooks():
    inj = CollectiveFaultInjector(MeshFaultSpec(nan_halo_rounds=(0,)),
                                  seed=2)
    jinj = jres.CollectiveFaultInjector(
        jres.MeshFaultSpec(nan_halo_rounds=(0,)), seed=2)
    Z0 = torch.zeros((4, 6), dtype=torch.float64)
    out = inj.wrap_exchange(lambda Xl: Z0)(None)
    jout = np.asarray(jinj.wrap_exchange(
        lambda Xl: jnp.zeros((4, 6), jnp.float64))(None))
    assert torch.isnan(out).sum() == 1
    assert np.array_equal(np.isnan(out.numpy()), np.isnan(jout))
    assert inj.stats["links_wrapped"] == 1
    inj.enabled = False
    assert torch.equal(inj.wrap_exchange(lambda Xl: Z0)(None), Z0)
    inj.enabled = True
    # One hook serves the round's exchange and the all-gather exchange of
    # the GN tail and certificate: both are built through it while it is
    # installed, and neither is touched once it is gone.
    graph, _meta, state = _graph_for(_noisy("torch"))

    class OneRank:  # the all-gather of a world of one rank
        def all_gather_start(self, t):
            return lambda: t

    def builds():
        start = rbcd._exchange_for(graph, None, None, ())
        return (lambda X: start(X)(),
                sharded_mod._gather_exchange(graph, OneRank()))

    clean = rbcd.neighbor_buffer(rbcd.public_table(state.X, graph), graph)
    n0 = inj.stats["links_wrapped"]
    assert rbcd._exchange_wrap is None
    with inj.installed():
        assert rbcd._exchange_wrap.__self__ is inj
        wrapped = builds()
    assert rbcd._exchange_wrap is None
    assert inj.stats["links_wrapped"] == n0 + 2
    for ex in wrapped:
        Z = ex(state.X)
        assert torch.isnan(Z).any()
        assert torch.equal(Z[~torch.isnan(Z)], clean[~torch.isnan(Z)])
    for ex in builds():
        assert torch.equal(ex(state.X), clean)


def test_injector_fetch_side_device_loss_and_hang():
    inj = CollectiveFaultInjector(
        MeshFaultSpec(device_loss_rounds=(0,), lost_device=5), seed=1)
    with pytest.raises(DeviceLostError) as ei:
        inj.on_fetch("sharded_verdict")
    assert ei.value.device == 5 and ei.value.kind == "device_loss"
    assert inj.stats["device_loss"] == 1
    inj.on_fetch("sharded_verdict")  # fires once, then clean
    hang = CollectiveFaultInjector(
        MeshFaultSpec(hang_rounds=(0,), hang_s=0.05), seed=1)
    t0 = time.perf_counter()
    hang.on_fetch("gn_tail")
    assert time.perf_counter() - t0 >= 0.04
    assert hang.stats["hung_fetches"] == 1
    hang.release_hangs()


def test_boundary_cb_checkpoints_clean_and_rewinds_anomalous(tmp_path):
    graph, _meta, state = _graph_for(_noisy("torch"))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                           rewind_on=("non_finite",))
    sup = resilience_mod.CheckpointSupervisor(
        cfg, cfg.resolve_store(device="cpu"), graph, session_id="s")
    sup.attach_mesh(8)
    clean = rbcd.pack_verdict(rbcd.VERDICT_RUNNING)
    sup.boundary_cb(4, 1, state, clean, False)
    assert sup.checkpoints == 1
    snap = sup.store.load_newest("s")
    assert snap.iteration == 4 and snap.mesh_shape == (8,)
    assert np.array_equal(snap.global_index, graph.global_index.numpy())
    bad = rbcd.pack_verdict(rbcd.VERDICT_RUNNING, rbcd.ANOMALY_NON_FINITE)
    with pytest.raises(resilience_mod.AnomalyRewind) as ei:
        sup.boundary_cb(8, 2, state, bad, False)
    assert ei.value.anomaly == "non_finite" and ei.value.iteration == 8
    with pytest.raises(resilience_mod.AnomalyRewind):
        sup.boundary_cb(8, 2, state, bad, True)
    stall = rbcd.pack_verdict(rbcd.VERDICT_RUNNING, rbcd.ANOMALY_STALL)
    sup.boundary_cb(8, 2, state, stall, False)
    assert sup.checkpoints == 1
    # A reader rank (not the mesh's first) counts the checkpoint but
    # never writes it.
    sup.writer = False
    sup.boundary_cb(12, 3, state, clean, False)
    assert sup.checkpoints == 2
    assert sup.store.load_newest("s").iteration == 4


def test_checkpoints_cross_packages(tmp_path):
    """A snapshot the port's supervisor writes loads in the JAX package's
    store with the same arrays, and the JAX package's loads in the
    port's recovery."""
    graph, _meta, state = _graph_for(_noisy("torch"))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path / "p"),
                           async_checkpoint=False)
    sup = resilience_mod.CheckpointSupervisor(
        cfg, cfg.resolve_store(device="cpu"), graph)
    sup.attach_mesh(4)
    sup.save(state, 8, 2)
    snap = JSessionStore(str(tmp_path / "p")).load_newest(cfg.session_id)
    assert snap.iteration == 8 and snap.num_weight_updates == 2
    assert snap.mesh_shape == (4,)
    assert np.array_equal(np.asarray(snap.state.X), state.X.numpy())
    assert np.array_equal(np.asarray(snap.state.weights),
                          state.weights.numpy())

    jgraph, jmeta = jrbcd.build_graph(jpartition(_noisy("jax"), A), 5)
    jX0 = jrbcd.centralized_chordal_init(jpartition(_noisy("jax"), A),
                                         jmeta, jgraph)
    jstate = jrbcd.init_state(jgraph, jmeta, jX0,
                              params=_params(jconfig))
    jcfg = jres.ResilienceConfig(checkpoint_dir=str(tmp_path / "j"),
                                 async_checkpoint=False)
    jsup = jres.CheckpointSupervisor(jcfg, jcfg.resolve_store(), jgraph)
    jsup.attach_mesh(4)
    jsup.save(jstate, 4, 1)
    cfg2 = ResilienceConfig(checkpoint_dir=str(tmp_path / "j"))
    sup2 = resilience_mod.CheckpointSupervisor(
        cfg2, cfg2.resolve_store(device="cpu"), graph)
    new_size, host_state, it, nwu = sup2.recover(
        DeviceLostError("x", phase="p", device=1), 4, A)
    assert (new_size, it, nwu) == (2, 4, 1)
    np.testing.assert_allclose(host_state.X.numpy(), np.asarray(jstate.X),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("corrupt", ["truncate", "bitflip", "schema"])
def test_corrupt_checkpoint_falls_back_a_boundary(tmp_path, corrupt):
    graph, _meta, state = _graph_for(_noisy("torch"))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path))
    sup = resilience_mod.CheckpointSupervisor(
        cfg, cfg.resolve_store(device="cpu"), graph)
    sup.attach_mesh(8)
    sup.save(state, 4, 1)
    sup.store.flush()
    sup.save(state, 8, 2)
    sup.store.flush()
    sdir = tmp_path / cfg.session_id
    path = sdir / "snap-00000008.npz"
    if corrupt == "schema":
        blob = dict(np.load(path, allow_pickle=False))
        blob["__schema__"] = np.asarray(99, np.int64)
        with open(path, "wb") as fh:
            np.savez_compressed(fh, **blob)
    elif corrupt == "truncate":
        raw = path.read_bytes()
        path.write_bytes(raw[: len(raw) // 3])
    else:
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        path.write_bytes(bytes(raw))
    fault = DeviceLostError("boom", phase="sharded_verdict", device=7)
    new_size, host_state, it, nwu = sup.recover(fault, 8, 8)
    assert (new_size, it, nwu) == (4, 4, 1)
    assert host_state is not None
    assert "snap-00000008.npz.quarantined" in \
        sorted(p.name for p in sdir.iterdir())
    assert sup.fault_kinds == ["device_loss"]


def test_global_index_mismatch_degrades_to_cold_restart(tmp_path):
    graph, _meta, state = _graph_for(_noisy("torch"))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path))
    store = cfg.resolve_store(device="cpu")
    sup = resilience_mod.CheckpointSupervisor(cfg, store, graph)
    sup.attach_mesh(8)
    host = resilience_mod.checkpoint_arrays(state)
    store.save(cfg.session_id, resilience_mod._host_state(host),
               iteration=4, mesh_shape=(8,),
               global_index=graph.global_index.numpy() + 1)
    new_size, host_state, it, nwu = sup.recover(
        MeshFaultError("hang", phase="gn_tail", kind="fetch_timeout"), 8, 8)
    assert host_state is None and (it, nwu) == (0, 0)
    assert sup.cold_restarts == 1 and new_size == 4


def test_rewind_budget_exhaustion_is_structured(tmp_path):
    graph, _meta, _state = _graph_for(_noisy("torch"))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path), max_rewinds=1)
    sup = resilience_mod.CheckpointSupervisor(
        cfg, cfg.resolve_store(device="cpu"), graph)
    sup.recover(DeviceLostError("x", phase="p", device=0), 8, 8)
    with pytest.raises(MeshFaultError) as ei:
        sup.recover(DeviceLostError("x", phase="p", device=1), 4, 8)
    assert ei.value.kind == "rewind_budget"


def test_checkpoint_gather_has_its_own_seam(monkeypatch):
    _graph, _meta, state = _graph_for(_noisy("torch"))
    rbcd_counted, rz_counted = [], []
    orig = rbcd._host_fetch
    monkeypatch.setattr(rbcd, "_host_fetch",
                        lambda x: (rbcd_counted.append(0), orig(x))[1])
    orig_rz = resilience_mod._host_fetch
    monkeypatch.setattr(resilience_mod, "_host_fetch",
                        lambda x: (rz_counted.append(0), orig_rz(x))[1])
    host = resilience_mod.checkpoint_arrays(state)
    assert len(rz_counted) == len(host) > 0
    assert not rbcd_counted


# ---------------------------------------------------------------------------
# The chaos scenarios on a 4-rank world against JAX's 4-device mesh
# ---------------------------------------------------------------------------

#: scenario -> (MeshFaultSpec keywords, injector seed, extra config)
SCENARIOS = {
    "device_loss": (dict(device_loss_rounds=(9,), lost_device=3), 5, {}),
    "nan_halo": (dict(nan_halo_rounds=(10,)), 3, {}),
    "double_loss": (dict(device_loss_rounds=(9, 17), lost_device=0), 5, {}),
    "hang": (dict(hang_rounds=(9,), hang_s=120.0), 3,
             dict(fetch_deadline_s=2.0)),
    "clean": (None, 0, {}),
}


def _scenario_kw(pkg):
    meas = _noisy(pkg, seed=7, n=80, num_lc=16, noise=0.1)
    mod = tconfig if pkg == "torch" else jconfig
    return dict(params=_params(mod), max_iters=ROUNDS, verdict_every=K,
                grad_norm_tol=0.0, eval_every=K), meas


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("chaos")
    kw, meas = _scenario_kw("torch")
    jobs = [(JOB, dict(kw, meas=meas, num_robots=A))]
    for name, (spec, seed, extra) in SCENARIOS.items():
        fault = (MeshFaultSpec(**spec), seed) if spec is not None else None
        jobs.append((JOB, dict(kw, meas=meas, num_robots=A,
                               resilience=dict(
                                   checkpoint_dir=str(work / name), **extra),
                               fault=fault,
                               count_fetches=name == "clean")))
    res = spawn_world(4, "dpgo_tpu_torch.parallel.world:multi_job",
                      kwargs=dict(jobs=jobs), workdir=work, timeout_s=60)
    for r in res[1:]:  # the result is replicated, leavers included
        for a, b in zip(r, res[0]):
            assert a["cost_history"] == b["cost_history"]
            if a["resilience"] is not None:
                assert _summary(a["resilience"]) == \
                    _summary(b["resilience"])
    return dict(zip(["ref"] + list(SCENARIOS), res[0]))


_JREF = {}


def _jax_chaos(name, tmp_path):
    kw, meas = _scenario_kw("jax")
    if name == "ref":
        return jsolve(meas, A, mesh=jmake_mesh(4), **kw)
    spec, seed, extra = SCENARIOS[name]
    inj = jres.CollectiveFaultInjector(jres.MeshFaultSpec(**spec),
                                       seed=seed) if spec else None
    return jsolve(meas, A, mesh=jmake_mesh(4), **kw,
                  resilience=jres.ResilienceConfig(
                      checkpoint_dir=str(tmp_path / name), injector=inj,
                      **extra))


def _summary(rz):
    return {k: v for k, v in rz.items() if k != "recovery_overhead_s"}


@pytest.mark.parametrize("name", ["device_loss", "nan_halo",
                                  "double_loss"])
def test_chaos_scenario_matches_jax(chaos_runs, name, tmp_path):
    got = chaos_runs[name]
    ref = _jax_chaos(name, tmp_path)
    assert got["recovered"] is True and ref.recovered is True
    assert _summary(got["resilience"]) == _summary(ref.resilience)
    assert got["iterations"] == ref.iterations
    np.testing.assert_allclose(got["cost_history"], ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(got["grad_norm_history"],
                               ref.grad_norm_history, rtol=1e-9)
    # The resumed history is a suffix of the fault-free run's.
    clean = chaos_runs["ref"]["cost_history"]
    nsuf = len(got["cost_history"])
    if name != "nan_halo":
        np.testing.assert_allclose(got["cost_history"], clean[-nsuf:],
                                   rtol=1e-9)
    assert abs(got["cost_history"][-1] - clean[-1]) <= 1e-6 * abs(clean[-1])


def test_chaos_mesh_sizes_and_watchdog(chaos_runs):
    """4 -> 2 on a loss, 4 -> 2 -> 1 on two, the same size on an anomaly,
    a hung fetch reshards like a loss; every result replicated."""
    rz = {k: chaos_runs[k]["resilience"] for k in SCENARIOS}
    assert rz["device_loss"]["mesh_sizes"] == [4, 2]
    assert rz["double_loss"]["mesh_sizes"] == [4, 2, 1]
    assert rz["nan_halo"]["mesh_sizes"] == [4, 4]
    assert rz["nan_halo"]["fault_kinds"] == ["anomaly:non_finite"]
    assert rz["hang"]["fault_kinds"] == ["fetch_timeout"]
    assert rz["hang"]["injector"]["hung_fetches"] == 1
    assert rz["hang"]["mesh_sizes"] == [4, 2]
    ref = chaos_runs["ref"]["cost_history"][-1]
    assert abs(chaos_runs["hang"]["cost_history"][-1] - ref) \
        <= 1e-6 * abs(ref)


def test_resilience_sync_rate_unchanged(chaos_runs):
    """Words + one terminal epilogue through rbcd._host_fetch with
    checkpoints on: the gathers ride the resilience plane's own seam."""
    clean = chaos_runs["clean"]
    assert clean["fetches"] == ROUNDS // K + 1
    assert clean["resilience"]["checkpoints"] >= ROUNDS // K - 1
    assert clean["cost_history"] == chaos_runs["ref"]["cost_history"]

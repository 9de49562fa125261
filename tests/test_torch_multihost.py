"""Multi-process execution of the port (``dpgo_tpu_torch.parallel.
multihost``): the verdict-boundary lockstep protocol over a store (a fake
that records the barrier waits, and a real ``HashStore``), world-shrink
planning, the exit classifier, the checkpoint-writer gating, and the real
thing on the CPU — worker processes joined through the launcher's
``TCPStore``, a 2-process solve equal to the 1-process one, and a ``kill
-9``'d worker whose survivor respawns on a shrunken world and resumes from
the checkpoint: the JAX package's exit classes, and a final cost within
1e-9 of the fault-free world's.
"""

import json
import signal
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dpgo_tpu.parallel import multihost as jmh
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.comms.protocol import mh_rank_actor
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.parallel import MeshFaultError, ResilienceConfig
from dpgo_tpu_torch.parallel import resilience as resilience_mod
from dpgo_tpu_torch.parallel.multihost import (EXIT_DESYNC,
                                               EXIT_PROCESS_LOST,
                                               MultihostWorld, WorldConfig,
                                               _classify, launch_world,
                                               shrink_world)


@pytest.fixture(autouse=True)
def _no_ambient_run():
    obs.end_run()
    yield
    obs.end_run()


class FakeStore:
    """An in-memory store with the ``TCPStore`` calls the protocol makes;
    records the barrier waits and can be armed to time them out."""

    def __init__(self):
        self.kv = {}
        self.waits = []
        self.fail_barrier = False

    def set(self, key, value):
        self.kv[key] = value if isinstance(value, str) else value.decode()

    def get(self, key):
        return self.kv[key].encode()

    def add(self, key, n):
        self.kv[key] = str(int(self.kv.get(key, "0")) + n)
        return int(self.kv[key])

    def wait(self, keys, timeout):
        self.waits.append((tuple(keys), timeout.total_seconds()))
        if any(k.endswith("/done") for k in keys) and self.fail_barrier:
            raise RuntimeError("Wait timeout")
        missing = [k for k in keys if k not in self.kv]
        if missing and not any(k.endswith("/done") for k in keys):
            raise RuntimeError(f"Wait timeout: {missing}")


def _world(rank=1, world_size=2, client=None, **kw):
    cfg = WorldConfig(coordinator="127.0.0.1:0", world_size=world_size,
                      rank=rank, **kw)
    return MultihostWorld(cfg, client=client if client is not None
                          else FakeStore())


def _barrier_waits(store):
    return [(k[0], t) for k, t in store.waits if k[0].endswith("/done")]


def test_world_config_validation():
    with pytest.raises(ValueError, match="world_size"):
        WorldConfig(coordinator="c", world_size=0, rank=0)
    with pytest.raises(ValueError, match="rank"):
        WorldConfig(coordinator="c", world_size=2, rank=2)
    with pytest.raises(ValueError, match="timeouts"):
        WorldConfig(coordinator="c", world_size=2, rank=0,
                    barrier_timeout_s=0.0)


@pytest.mark.parametrize("cur", [4, 3, 2, 1])
def test_shrink_world_matches_jax(cur):
    assert shrink_world(cur, 8) == jmh.shrink_world(cur, 8)


@pytest.mark.parametrize("rc", [0, EXIT_PROCESS_LOST, EXIT_DESYNC,
                                -int(signal.SIGKILL), 3])
def test_exit_code_classifier_matches_jax(rc):
    assert _classify(rc) == jmh._classify(rc)
    assert (EXIT_PROCESS_LOST, EXIT_DESYNC) == (jmh.EXIT_PROCESS_LOST,
                                                jmh.EXIT_DESYNC)


def test_single_process_world_syncs_without_a_client():
    w = _world(rank=0, world_size=1)
    w.client = None  # must never be consulted
    w.verdict_sync(4, 123)
    assert w.boundaries == 1 and w.desync_checks == 0


def test_verdict_sync_publishes_and_cross_checks():
    store = FakeStore()
    store.kv["dpgo/mh/g0/s0/r0"] = "4:123"
    w = _world(rank=1, world_size=2, client=store)
    w.verdict_sync(4, 123)
    assert store.kv["dpgo/mh/g0/s0/r1"] == "4:123"
    assert w.boundaries == 1 and w.desync_checks == 1


def test_two_ranks_pass_a_real_hashstore_barrier():
    """Two ranks on one ``HashStore``: rank 0 arrives first and waits,
    rank 1 completes the barrier; both see the other's word."""
    import threading

    store = dist.HashStore()
    w0 = _world(rank=0, world_size=2, client=store)
    w1 = _world(rank=1, world_size=2, client=store)
    t = threading.Thread(target=w0.verdict_sync, args=(4, 7))
    t.start()
    w1.verdict_sync(4, 7)
    t.join(10)
    assert w0.boundaries == w1.boundaries == 1
    assert w1.desync_checks == 1
    lone = _world(rank=0, world_size=2, client=dist.HashStore(),
                  barrier_timeout_s=0.2, first_barrier_timeout_s=0.2)
    with pytest.raises(MeshFaultError) as ei:
        lone.verdict_sync(4, 7)
    assert ei.value.kind == "process_lost"


def test_verdict_desync_is_a_structured_world_fault():
    store = FakeStore()
    store.kv["dpgo/mh/g0/s0/r0"] = "4:999"  # controller disagrees
    w = _world(rank=1, world_size=2, client=store)
    with pytest.raises(MeshFaultError) as ei:
        w.verdict_sync(4, 123)
    assert ei.value.kind == "desync" and ei.value.phase == "verdict_sync"
    assert ei.value.kind in resilience_mod.WORLD_FAULT_KINDS


def test_barrier_timeout_reads_as_process_lost():
    store = FakeStore()
    store.fail_barrier = True
    w = _world(rank=0, world_size=2, client=store)
    with pytest.raises(MeshFaultError) as ei:
        w.verdict_sync(8, 5)
    assert ei.value.kind == "process_lost"
    assert ei.value.phase == "verdict_sync"
    assert w.boundaries == 0


def test_first_boundary_gets_the_long_start_skew_timeout():
    store = FakeStore()
    store.kv["dpgo/mh/g0/s0/r0"] = "0:1"
    store.kv["dpgo/mh/g0/s1/r0"] = "4:1"
    w = _world(rank=1, world_size=2, client=store,
               barrier_timeout_s=7.0, first_barrier_timeout_s=120.0)
    w.verdict_sync(0, 1)
    w.verdict_sync(4, 1)
    assert [t for _, t in _barrier_waits(store)] == [120.0, 7.0]


def test_rank0_never_runs_the_desync_check():
    class NoGetStore(FakeStore):
        def get(self, key):
            raise AssertionError("rank 0 must not read its own word back")

    w = _world(rank=0, world_size=2, client=NoGetStore())
    w.verdict_sync(4, 7)
    assert w.boundaries == 1 and w.desync_checks == 0


def test_generation_scopes_the_keyspace():
    store = FakeStore()
    store.kv["dpgo/mh/g3/s0/r0"] = "12:9"
    w = _world(rank=1, world_size=2, client=store, generation=3)
    w.verdict_sync(12, 9)
    assert store.kv["dpgo/mh/g3/s0/r1"] == "12:9"
    assert _barrier_waits(store)[0][0] == "dpgo/mh/g3/b0/done"


def test_telemetry_off_keeps_the_kv_wire_word_only():
    store = FakeStore()
    store.kv["dpgo/mh/g0/s0/r0"] = "4:123"
    w = _world(rank=1, world_size=2, client=store)
    w.verdict_sync(4, 123)
    # The words and the barrier's arrival counter (the fake's barrier
    # never completes by itself), no clock-stamp keys.
    assert set(store.kv) == {"dpgo/mh/g0/s0/r0", "dpgo/mh/g0/s0/r1",
                             "dpgo/mh/g0/b0"}


def test_telemetry_on_stamps_and_samples_the_barrier(tmp_path):
    store = FakeStore()
    store.kv["dpgo/mh/g0/s0/r0"] = "4:123"
    store.kv["dpgo/mh/g0/c0/r0"] = "12.5:1000.5"  # controller's stamp
    w = _world(rank=1, world_size=2, client=store)
    with obs.run_scope(str(tmp_path / "r1")):
        w.verdict_sync(4, 123)
    mono, wall = map(float, store.kv["dpgo/mh/g0/c0/r1"].split(":"))
    assert mono > 0 and wall > 0
    with open(tmp_path / "r1" / "events.jsonl") as fh:
        evs = [json.loads(ln) for ln in fh if ln.strip()]
    (pub,) = [e for e in evs if e["event"] == "verdict_publish"]
    assert pub["word"] == 123 and pub["robot"] == mh_rank_actor(1)
    (bw,) = [e for e in evs if e.get("name") == "barrier_wait"]
    assert bw["robot"] == mh_rank_actor(1) and bw["seq_boundary"] == 0
    (cs,) = [e for e in evs if e["event"] == "clock_sample"]
    assert cs["src"] == mh_rank_actor(0) and cs["t_send_mono"] == 12.5


def test_telemetry_on_survives_a_stampless_controller(tmp_path):
    store = FakeStore()
    store.kv["dpgo/mh/g0/s0/r0"] = "4:123"
    w = _world(rank=1, world_size=2, client=store)
    with obs.run_scope(str(tmp_path / "r1")):
        w.verdict_sync(4, 123)
    assert w.boundaries == 1


def _supervisor(tmp_path, **cfg_kw):
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path), **cfg_kw)
    graph = types.SimpleNamespace(global_index=np.arange(8))
    return resilience_mod.CheckpointSupervisor(
        cfg, cfg.resolve_store(device="cpu"), graph, session_id="mh")


def test_recover_reraises_world_faults(tmp_path):
    sup = _supervisor(tmp_path)
    for kind in sorted(resilience_mod.WORLD_FAULT_KINDS):
        exc = MeshFaultError("peer gone", phase="verdict_sync", kind=kind)
        with pytest.raises(MeshFaultError):
            sup.recover(exc, mesh_size=2, num_robots=8)
    assert sup.recoveries == 0


def test_checkpoint_writer_gating(tmp_path, monkeypatch):
    clean = rbcd.pack_verdict(rbcd.VERDICT_RUNNING)
    saves = []
    reader = _supervisor(tmp_path, checkpoint_writer=False)
    monkeypatch.setattr(reader, "save",
                        lambda *a, **k: saves.append(("reader", a)))
    reader.boundary_cb(4, 1, state=None, word=clean, terminal=False)
    assert saves == []
    writer = _supervisor(tmp_path)
    monkeypatch.setattr(writer, "save",
                        lambda *a, **k: saves.append(("writer", a)))
    writer.boundary_cb(4, 1, state=None, word=clean, terminal=False)
    assert [who for who, _ in saves] == ["writer"]


def test_launch_world_refusals():
    with pytest.raises(ValueError, match="ONE device"):
        launch_world(2, mesh_size=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_world(2)


_DEMO = dict(robots=8, n=40, num_lc=8, rounds=12, verdict_every=4,
             device="cpu", first_barrier_timeout_s=60.0,
             worker_timeout_s=60.0)


def test_multihost_worlds_and_kill9_recovery(tmp_path):
    """One process, two processes, and two with rank 1 SIGKILLing itself
    at boundary 2: the same histories, ``100/K`` host syncs, the JAX
    package's exit classes, the resumed solve's final cost within 1e-9 of
    the fault-free world's, and one merged trace of the generations."""
    ref = launch_world(1, workdir=str(tmp_path / "w1"), **_DEMO)
    two = launch_world(2, workdir=str(tmp_path / "w2"), **_DEMO)
    assert ref["world_sizes"] == [1] and two["world_sizes"] == [2]
    assert not two["recovered"]
    r1, r2 = ref["result"], two["result"]
    assert r2["cost_history"] == r1["cost_history"]
    assert r2["grad_norm_history"] == r1["grad_norm_history"]
    assert r2["host_syncs_per_100_rounds"] == pytest.approx(100.0 / 4)
    assert r2["boundaries"] == _DEMO["rounds"] // _DEMO["verdict_every"]
    assert r2["desync_checks"] == 0 and r2["device"] == "cpu"

    chaos = launch_world(2, workdir=str(tmp_path / "chaos"), kill_rank=1,
                         kill_at_boundary=2, barrier_timeout_s=5.0,
                         telemetry_dir=str(tmp_path / "tel"), **_DEMO)
    assert chaos["recovered"] is True
    assert chaos["world_sizes"] == [2, 1]
    gen0 = chaos["generations"][0]
    assert sorted(gen0["outcomes"]) == ["process_lost", "signal:SIGKILL"]
    assert chaos["generations"][1]["outcomes"] == ["ok"]
    assert all(f["kind"] == "process_lost" and f["phase"] == "verdict_sync"
               for f in gen0["faults"])
    res = chaos["result"]
    assert res["resumed"] is True
    assert res["resume_iteration"] == 2 * _DEMO["verdict_every"]
    assert res["iterations"] == _DEMO["rounds"]
    assert abs(res["final_cost"] - r1["final_cost"]) \
        <= 1e-9 * abs(r1["final_cost"])
    nsuf = len(res["cost_history"])
    np.testing.assert_allclose(res["cost_history"],
                               r1["cost_history"][-nsuf:], rtol=1e-12)
    assert res["host_syncs_per_100_rounds"] == pytest.approx(100.0 / 4)
    tel = chaos["telemetry"]
    assert "error" not in tel, tel
    assert tel["streams"] == 4  # launcher + g0 r0/r1 + g1 r0
    with open(tel["trace"]) as fh:
        trace = json.load(fh)
    lost = [e for e in trace["traceEvents"]
            if e.get("ph") == "i" and e["name"] == "process_lost"]
    assert lost


def test_coordinator_barrier_over_tcpstore():
    """The launcher's coordination service: a ``TCPStore`` client of it
    passes a one-rank barrier and times out a two-rank one."""
    from dpgo_tpu_torch.parallel.multihost import _coordinator

    coord = _coordinator()
    w = MultihostWorld.join(WorldConfig(
        coordinator=f"127.0.0.1:{coord.port}", world_size=1, rank=0))
    w._barrier("b", 5.0)
    w2 = _world(rank=0, world_size=2, client=w.client)
    with pytest.raises(Exception):
        w2._barrier("b2", 0.3)

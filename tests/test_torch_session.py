"""The port's session durability (``dpgo_tpu_torch.serve.session``) and
server elasticity on the CPU: snapshot robustness (truncation / bit flips
/ wrong schema -> quarantine fallback, never a crash), the worker
crash-recovery path and graceful drain — the port counterparts of
``tests/test_session.py`` — and snapshots crossing between the packages:
a JAX-written snapshot resumes in the port and a port-written one in the
JAX package, each continuing as the writer's own solve would (rtol 1e-9).

The crash-recovery test carries no ``allow_leaks`` marker: the leakcheck
plugin asserting zero orphan threads/sockets after a mid-batch worker
kill + recovery is part of the contract."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.models.incremental import LiveProblem as JLive
from dpgo_tpu.serve.session import SessionStore as JStore
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.models.incremental import LiveProblem, state_to_arrays
from dpgo_tpu_torch.serve import (OverCapacityError, SessionStore,
                                  SolveRequest, SolveServer)
from dpgo_tpu_torch.serve import server as server_mod
from dpgo_tpu_torch.serve.session import SESSION_SCHEMA_VERSION

PARAMS = AgentParams(d=3, r=5, num_robots=2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_ambient_run():
    obs.end_run()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.end_run()


def _problem(seed=0, n=24):
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=8, rot_noise=0.01, trans_noise=0.01)
    return meas


def _solved_state(meas):
    live = LiveProblem(meas, 2, params=PARAMS, device="cpu")
    return live.solve(max_iters=6, grad_norm_tol=1e-9).state


def _store(path, **kw):
    return SessionStore(str(path), device="cpu", **kw)


def _server(**kw):
    return SolveServer(device="cpu", **kw)


# ---------------------------------------------------------------------------
# SessionStore robustness
# ---------------------------------------------------------------------------

def test_store_round_trip_and_prune(tmp_path):
    st = _solved_state(_problem())
    store = _store(tmp_path / "s", keep=2)
    for it in (10, 20, 30):
        store.save("sess", st, iteration=it, meta={"tenant": "t"})
    sdir = tmp_path / "s" / "sess"
    names = sorted(p.name for p in sdir.iterdir())
    assert names == ["snap-00000020.npz", "snap-00000030.npz"]
    snap = store.load_newest("sess")
    assert snap.iteration == 30 and snap.meta == {"tenant": "t"}
    for f, v in state_to_arrays(st).items():
        np.testing.assert_array_equal(state_to_arrays(snap.state)[f], v)
    store.discard("sess")
    assert store.load_newest("sess") is None
    assert not sdir.exists()


@pytest.mark.parametrize("corrupt", ["truncate", "bitflip", "schema"])
def test_corrupt_newest_falls_back_to_previous(tmp_path, corrupt):
    st = _solved_state(_problem())
    store = _store(tmp_path / "s", keep=3)
    store.save("sess", st, iteration=10)
    path = tmp_path / "s" / "sess" / "snap-00000020.npz"
    if corrupt == "schema":
        arrays = state_to_arrays(st)
        arrays["__schema__"] = np.asarray(SESSION_SCHEMA_VERSION + 7)
        arrays["__iteration__"] = np.asarray(20)
        arrays["__nwu__"] = np.asarray(0)
        with open(path, "wb") as fh:
            np.savez_compressed(fh, **arrays)
    else:
        store.save("sess", st, iteration=20)
        blob = bytearray(path.read_bytes())
        if corrupt == "truncate":
            path.write_bytes(bytes(blob[: len(blob) // 3]))
        else:
            blob[len(blob) // 2] ^= 0xFF
            path.write_bytes(bytes(blob))
    snap = store.load_newest("sess")
    assert snap is not None and snap.iteration == 10
    names = sorted(p.name for p in (tmp_path / "s" / "sess").iterdir())
    assert "snap-00000020.npz.quarantined" in names
    assert "snap-00000020.npz" not in names
    assert store.load_newest("sess").iteration == 10


@pytest.mark.parametrize("kill_at", ["mid_write", "pre_replace"])
def test_sigkill_mid_save_leaves_store_loadable(tmp_path, kill_at):
    """A writer SIGKILLed mid-save leaves a ``.tmp`` the snapshot regex
    never admits: the previous boundary keeps loading and the next writer
    reuses the name."""
    st = _solved_state(_problem())
    store = _store(tmp_path / "s", keep=3)
    store.save("sess", st, iteration=10)
    script = textwrap.dedent(f"""
        import io, os, signal
        import numpy as np
        from dpgo_tpu_torch.serve import session as session_mod
        from dpgo_tpu_torch.serve.session import SessionStore

        store = SessionStore({str(tmp_path / "s")!r}, keep=3, device="cpu")
        snap = store.load_newest("sess")
        if {kill_at!r} == "mid_write":
            real = np.savez_compressed

            def torn(fh, **arrays):
                buf = io.BytesIO()
                real(buf, **arrays)
                data = buf.getvalue()
                fh.write(data[: len(data) // 2])
                fh.flush()
                os.fsync(fh.fileno())
                os.kill(os.getpid(), signal.SIGKILL)

            session_mod.np.savez_compressed = torn
        else:
            def boom(src, dst):
                os.kill(os.getpid(), signal.SIGKILL)

            session_mod.os.replace = boom
        store.save("sess", snap.state, iteration=20)
        raise SystemExit("unreachable: the save must have died")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    sdir = tmp_path / "s" / "sess"
    names = sorted(p.name for p in sdir.iterdir())
    assert "snap-00000010.npz" in names
    assert "snap-00000020.npz" not in names
    assert "snap-00000020.npz.tmp" in names
    assert store.load_newest("sess").iteration == 10
    store.save("sess", st, iteration=20)
    assert store.load_newest("sess").iteration == 20
    assert "snap-00000020.npz.tmp" not in sorted(
        p.name for p in sdir.iterdir())


def test_v1_snapshot_loads_under_v2_reader(tmp_path):
    st = _solved_state(_problem())
    store = _store(tmp_path / "s")
    arrays = state_to_arrays(st)
    arrays["__schema__"] = np.asarray(1, np.int64)
    arrays["__iteration__"] = np.asarray(40, np.int64)
    arrays["__nwu__"] = np.asarray(3, np.int64)
    sdir = tmp_path / "s" / "sess"
    sdir.mkdir(parents=True)
    with open(sdir / "snap-00000040.npz", "wb") as fh:
        np.savez_compressed(fh, **arrays)
    snap = store.load_newest("sess")
    assert snap.iteration == 40 and snap.num_weight_updates == 3
    assert snap.mesh_shape is None and snap.global_index is None


def test_mesh_tagged_snapshot_round_trips_and_old_reader_fails_open(
        tmp_path, monkeypatch):
    from dpgo_tpu_torch.serve import session as session_mod

    st = _solved_state(_problem())
    store = _store(tmp_path / "s", keep=3)
    arrays = state_to_arrays(st)
    arrays["__schema__"] = np.asarray(1, np.int64)
    arrays["__iteration__"] = np.asarray(10, np.int64)
    sdir = tmp_path / "s" / "sess"
    sdir.mkdir(parents=True)
    with open(sdir / "snap-00000010.npz", "wb") as fh:
        np.savez_compressed(fh, **arrays)
    gidx = np.arange(48).reshape(2, 24)
    store.save("sess", st, iteration=20, mesh_shape=(8,), global_index=gidx)
    snap = store.load_newest("sess")
    assert snap.iteration == 20 and snap.mesh_shape == (8,)
    np.testing.assert_array_equal(snap.global_index, gidx)
    monkeypatch.setattr(session_mod, "_COMPAT_SCHEMAS", (1,))
    old = store.load_newest("sess")
    assert old is not None and old.iteration == 10
    names = sorted(p.name for p in sdir.iterdir())
    assert "snap-00000020.npz.quarantined" in names


def test_all_snapshots_corrupt_yields_none(tmp_path):
    store = _store(tmp_path / "s")
    store.save("sess", _solved_state(_problem()), iteration=10)
    (tmp_path / "s" / "sess" / "snap-00000010.npz").write_bytes(b"junk")
    assert store.load_newest("sess") is None


def test_save_async_read_after_save_and_last_writer_wins(tmp_path):
    st = _solved_state(_problem())
    store = _store(tmp_path / "a", keep=4, async_write=True)
    path = store.save_async("sess", st, iteration=10)
    assert path.endswith("snap-00000010.npz")
    assert store.load_newest("sess").iteration == 10
    assert store.flush(timeout=10) and store.last_write_error is None

    store = _store(tmp_path / "b", keep=8, async_write=True)
    gate, started = threading.Event(), threading.Event()
    orig_write = store._write

    def slow_write(session_id, arrays, iteration):
        started.set()
        assert gate.wait(10)
        return orig_write(session_id, arrays, iteration)

    store._write = slow_write
    store.save_async("sess", st, iteration=1)
    assert started.wait(10)
    store.save_async("sess", st, iteration=2)
    store.save_async("sess", st, iteration=3)  # replaces 2
    gate.set()
    assert store.flush(timeout=10)
    names = sorted(p.name for p in (tmp_path / "b" / "sess").iterdir())
    assert names == ["snap-00000001.npz", "snap-00000003.npz"]


def test_session_id_sanitization(tmp_path):
    store = _store(tmp_path / "s")
    store.save("tenant/../../evil", _solved_state(_problem()), iteration=1)
    (entry,) = (tmp_path / "s").iterdir()
    assert "/" not in entry.name and entry.parent == tmp_path / "s"
    assert store.load_newest("tenant/../../evil").iteration == 1


# ---------------------------------------------------------------------------
# Snapshots across the packages
# ---------------------------------------------------------------------------

def _jax_live(meas):
    jp = jconfig.AgentParams(d=3, r=5, num_robots=2)
    return JLive(meas, 2, params=jp, dtype=jnp.float64)


def _continue_jax(live, state):
    state = jrbcd.refresh_problem(state, live.padded.graph, live.padded.meta,
                                  live.params)
    return jrbcd.dispatch_prepared(live.prob, max_iters=4,
                                   grad_norm_tol=1e-12, state=state)


def _continue_port(live, state):
    state = rbcd.refresh_problem(state, live.padded.graph, live.padded.meta,
                                 live.params)
    return rbcd.dispatch_prepared(live.prob, max_iters=4,
                                  grad_norm_tol=1e-12, state=state)


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """A snapshot the JAX package's store wrote loads in the port's store
    and continues exactly as the JAX solve continues from it."""
    meas = _problem(seed=5)
    jl = _jax_live(meas)
    jst = jl.solve(max_iters=6, grad_norm_tol=1e-9).state
    JStore(str(tmp_path)).save("s", jst, iteration=6, meta={"by": "jax"})
    snap = _store(tmp_path).load_newest("s")
    assert snap.iteration == 6 and snap.meta == {"by": "jax"}
    np.testing.assert_array_equal(snap.state.X.numpy(), np.asarray(jst.X))
    np.testing.assert_array_equal(snap.state.weights.numpy(),
                                  np.asarray(jst.weights))
    assert snap.state.iteration == int(jst.iteration)
    a = _continue_jax(jl, jst)
    b = _continue_port(LiveProblem(meas, 2, params=PARAMS, device="cpu"),
                       snap.state)
    np.testing.assert_allclose(b.cost_history, a.cost_history, rtol=1e-9)


def test_port_snapshot_resumes_in_jax(tmp_path):
    """The reverse: a port-written snapshot loads in the JAX package's
    store and continues as the port's solve continues from it."""
    meas = _problem(seed=6)
    tl = LiveProblem(meas, 2, params=PARAMS, device="cpu")
    tst = tl.solve(max_iters=6, grad_norm_tol=1e-9).state
    _store(tmp_path).save("s", tst, iteration=6)
    snap = JStore(str(tmp_path)).load_newest("s")
    assert snap is not None and snap.iteration == 6
    np.testing.assert_array_equal(np.asarray(snap.state.X), tst.X.numpy())
    a = _continue_port(tl, tst)
    b = _continue_jax(_jax_live(meas), jax.tree.map(jnp.asarray,
                                                    snap.state))
    np.testing.assert_allclose(a.cost_history, b.cost_history, rtol=1e-9)


# ---------------------------------------------------------------------------
# Crash recovery — no allow_leaks: leakcheck must stay clean
# ---------------------------------------------------------------------------

class _WorkerKilled(BaseException):
    """Escapes ``_run_batch``'s Exception handling — a stand-in for a
    mid-batch worker death."""


def test_worker_killed_mid_batch_recovers_from_snapshot(tmp_path,
                                                        monkeypatch):
    """The worker dies mid-batch after a session snapshot landed; the
    supervisor respawns, re-admits the request from the snapshot, the
    reply completes with ``recovered=True`` and
    ``session_recoveries_total`` increments."""
    meas = _problem()
    real_run_bucket = server_mod.run_bucket
    calls = {"n": 0}

    def killer(padded, cache, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            real_run_bucket(padded, cache, max_iters=4,
                            grad_norm_tol=kw["grad_norm_tol"],
                            eval_every=kw["eval_every"],
                            session_cb=kw["session_cb"], session_every=1)
            raise _WorkerKilled("killed mid-batch")
        return real_run_bucket(padded, cache, **kw)

    monkeypatch.setattr(server_mod, "run_bucket", killer)
    with obs.run_scope(str(tmp_path / "run")) as run:
        store = _store(tmp_path / "sessions")
        with _server(max_batch=2, batch_window_s=0.0,
                     session_store=store) as srv:
            t = srv.submit(SolveRequest(
                meas=meas, num_robots=2, params=PARAMS, max_iters=40,
                grad_norm_tol=1e-3, session_id="tenant-a-42"))
            res = t.result(timeout=300)
            assert res.recovered is True
            assert calls["n"] == 2
            assert srv.status()["worker_crashes"] == 1
        snap = run.registry.snapshot()
    families = [v for k, v in snap.items()
                if "session_recoveries_total" in k]
    assert families and families[0]["series"][0]["value"] == 1.0
    assert store.load_newest("tenant-a-42") is None


def test_worker_kill_without_session_fails_cleanly(monkeypatch, tmp_path):
    meas = _problem()
    real_run_bucket = server_mod.run_bucket
    calls = {"n": 0}

    def killer(padded, cache, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _WorkerKilled("killed")
        return real_run_bucket(padded, cache, **kw)

    monkeypatch.setattr(server_mod, "run_bucket", killer)
    with _server(max_batch=2, batch_window_s=0.0,
                 session_store=_store(tmp_path)) as srv:
        t = srv.submit(SolveRequest(meas=meas, num_robots=2, params=PARAMS,
                                    max_iters=10, grad_norm_tol=1e-3))
        with pytest.raises(RuntimeError, match="died mid-batch"):
            t.result(timeout=300)
        t2 = srv.submit(SolveRequest(meas=meas, num_robots=2, params=PARAMS,
                                     max_iters=10, grad_norm_tol=1e-3))
        assert t2.result(timeout=300).recovered is False


def test_crash_loop_gives_up_and_sheds(monkeypatch):
    meas = _problem()

    def always_dies(padded, cache, **kw):
        raise _WorkerKilled("again")

    monkeypatch.setattr(server_mod, "run_bucket", always_dies)
    srv = _server(max_batch=2, batch_window_s=0.0, worker_restarts=0)
    try:
        t = srv.submit(SolveRequest(meas=meas, num_robots=2, params=PARAMS,
                                    max_iters=10))
        with pytest.raises((OverCapacityError, RuntimeError)):
            t.result(timeout=300)
        deadline = time.monotonic() + 30
        while srv._worker.is_alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not srv._worker.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(SolveRequest(meas=meas, num_robots=2, params=PARAMS))
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Graceful drain
# ---------------------------------------------------------------------------

def test_close_drain_stops_admission_and_reports(tmp_path, monkeypatch):
    """close(drain=True): the in-flight batch finishes and replies;
    admission during the drain is a structured shed (reason=closed);
    /healthz says draining (200) for the window and 503 once closed."""
    meas = _problem()
    gate = threading.Event()
    release = threading.Event()
    real_run_bucket = server_mod.run_bucket

    def slow(padded, cache, **kw):
        gate.set()
        assert release.wait(60)
        return real_run_bucket(padded, cache, **kw)

    monkeypatch.setattr(server_mod, "run_bucket", slow)
    with obs.run_scope(str(tmp_path / "run")):
        srv = _server(max_batch=1, batch_window_s=0.0, metrics_port=0)
        base = f"http://{srv.sidecar.host}:{srv.sidecar.port}"
        t1 = srv.submit(SolveRequest(meas=meas, num_robots=2, params=PARAMS,
                                     max_iters=6, grad_norm_tol=1e-3))
        assert gate.wait(60)
        closer = threading.Thread(target=lambda: srv.close(drain=True))
        closer.start()
        deadline = time.monotonic() + 10
        while not srv.status()["draining"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.status()["draining"] is True
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            body = json.loads(r.read())
            assert r.status == 200 and body["draining"] is True
        with pytest.raises(OverCapacityError) as exc:
            srv.submit(SolveRequest(meas=meas, num_robots=2, params=PARAMS))
        assert exc.value.reason == "closed"
        release.set()
        closer.join(timeout=120)
        assert not closer.is_alive()
        assert t1.result(timeout=60).iterations >= 1
        st = srv.status()
        assert st["closed"] is True and st["draining"] is False
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                raise AssertionError(f"healthz still ok after close: "
                                     f"{r.status}")
        except urllib.error.HTTPError as e:
            assert e.code == 503
            e.close()
        except urllib.error.URLError:
            pass


def test_drain_evacuates_and_resumes_on_another_server(tmp_path,
                                                       monkeypatch):
    """``drain()`` breaks the in-flight batch at its next boundary after
    the snapshot lands and hands the ticket back; a ``resume_sessions``
    server re-admits it from the snapshot, flagged ``recovered``."""
    meas = _problem()
    store_dir = tmp_path / "sessions"
    stepped = threading.Event()
    real_run_bucket = server_mod.run_bucket

    def slow_stop(padded, cache, **kw):
        stop = kw["should_stop"]

        def should_stop():
            stepped.set()
            time.sleep(0.05)
            return stop()

        return real_run_bucket(padded, cache,
                               **dict(kw, should_stop=should_stop))

    monkeypatch.setattr(server_mod, "run_bucket", slow_stop)
    srv = _server(max_batch=1, batch_window_s=0.0,
                  session_store=str(store_dir))
    req = SolveRequest(meas=meas, num_robots=2, params=PARAMS, max_iters=40,
                       grad_norm_tol=1e-9, eval_every=2, session_id="mig")
    srv.submit(req)
    assert stepped.wait(60)
    evacuated = srv.drain()
    assert len(evacuated) == 1
    assert _store(store_dir).load_newest("mig") is not None
    monkeypatch.setattr(server_mod, "run_bucket", real_run_bucket)
    with _server(max_batch=1, batch_window_s=0.0,
                 session_store=str(store_dir),
                 resume_sessions=True) as srv2:
        res = srv2.solve(req, timeout=300)
    assert res.recovered is True and np.isfinite(res.cost_history[-1])

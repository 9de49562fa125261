"""The port's artifact tier (``dpgo_tpu_torch.serve.fleet.aotcache``) on
the CPU: the kernel library's disk entry, with a real shared library built
here by ``g++`` standing in for the ``nvcc`` one (the same file layout and
``ctypes`` binding; the tier never reads the library's code).

Pinned: a round trip across fresh caches, bound by ``ctypes`` in a fresh
process; an identity mismatch refused and quarantined; the schema version
keys the entry; torn, corrupt, non-ELF and symbol-less entries quarantined
and the caller falls back to a build (fail-open); a store failure
swallowed; the resolution order bound -> disk -> build with
``serve_compile_seconds_total`` growing only when nvcc ran; a library in
``_build/`` that another toolchain built is neither reused nor stored; a
server binds once, before its first batch on the card, and a CPU server
never touches the tier.  The card's own round trip (a warm child binding the
``nvcc`` library from disk) is in ``tests/test_torch_cuda.py``."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.ops import rtr_kernel
from dpgo_tpu_torch.serve import SolveRequest, SolveServer
from dpgo_tpu_torch.serve.fleet import aotcache
from dpgo_tpu_torch.serve.fleet.aotcache import AOTDiskCache, entry_identity
from dpgo_tpu_torch.utils.synthetic import make_measurements

#: The stand-in library's entry points (the tier checks names only).
SYMBOLS = ("dpgo_test_answer", "dpgo_test_twice")
SOURCE = """
extern "C" int dpgo_test_answer(void) { return 42; }
extern "C" int dpgo_test_twice(int x) { return 2 * x; }
"""
CAPABILITY = (9, 0)


@pytest.fixture(autouse=True)
def _no_ambient_run():
    obs.end_run()
    yield
    obs.end_run()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """A real shared library built by g++ (as ``utils.native_io`` builds
    the port's native loader)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the stand-in library")
    d = tmp_path_factory.mktemp("lib")
    src = d / "stand_in.cpp"
    src.write_text(SOURCE)
    out = d / "libdpgo_stand_in.so"
    subprocess.run([cxx, "-O2", "-fPIC", "-shared", "-o", str(out),
                    str(src)], check=True, timeout=120)
    return str(out)


def _ident(**over):
    return dict(entry_identity(capability=CAPABILITY), **over)


def _load(ds, ident):
    return ds.load(ident, symbols=SYMBOLS)


def test_entry_identity_names_the_build():
    ident = entry_identity(capability=CAPABILITY)
    assert ident["schema"] == aotcache.AOT_CACHE_SCHEMA_VERSION
    assert ident["sources"] == rtr_kernel.source_digest()
    assert ident["torch"] == torch.__version__
    assert ident["cuda"] == torch.version.cuda
    assert ident["capability"] == [9, 0]
    assert "nvcc" in ident  # None here: this machine has no nvcc
    assert entry_identity(capability=(8, 0)) != ident


def test_disk_round_trip_binds_in_a_fresh_process(tmp_path, lib):
    root = str(tmp_path / "aot")
    ident = _ident()
    ds = AOTDiskCache(root)
    assert _load(ds, ident) is None  # a plain miss first
    assert ds.store(ident, lib)
    st = ds.stats()
    assert st["disk_misses"] == 1 and st["stores"] == 1
    assert st["quarantined"] == 0 and st["store_errors"] == 0
    path = _load(AOTDiskCache(root), ident)  # a fresh tier
    assert path is not None and os.path.dirname(path) == root
    code = (
        "import ctypes, json, sys\n"
        f"sys.path.insert(0, {os.getcwd()!r})\n"
        "from dpgo_tpu_torch.serve.fleet.aotcache import AOTDiskCache\n"
        f"ident = json.loads({json.dumps(ident)!r})\n"
        f"ds = AOTDiskCache({root!r})\n"
        f"path = ds.load(ident, symbols={SYMBOLS!r})\n"
        "lib = ctypes.CDLL(path)\n"
        "lib.dpgo_test_twice.argtypes = [ctypes.c_int]\n"
        "print(lib.dpgo_test_answer(), lib.dpgo_test_twice(21),\n"
        "      ds.stats()['disk_hits'], 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["42", "42", "1", "False"]


def test_identity_mismatch_refused_and_quarantined(tmp_path, lib):
    ds = AOTDiskCache(str(tmp_path / "aot"))
    ident = _ident()
    ds.store(_ident(sources="0" * 64), lib)
    # Put the foreign entry where ``ident``'s would be (a digest
    # collision or a stale file under the same name).
    os.replace(ds._path(_ident(sources="0" * 64)), ds._path(ident))
    assert _load(ds, ident) is None
    assert ds.stats()["quarantined"] == 1
    assert os.path.exists(ds._path(ident) + ".quarantined")
    assert not os.path.exists(ds._path(ident))


def test_schema_version_keys_the_entry(tmp_path, lib, monkeypatch):
    ds = AOTDiskCache(str(tmp_path / "aot"))
    ds.store(_ident(), lib)
    monkeypatch.setattr(aotcache, "AOT_CACHE_SCHEMA_VERSION",
                        aotcache.AOT_CACHE_SCHEMA_VERSION + 1)
    assert _load(ds, _ident()) is None  # another path: a plain miss
    st = ds.stats()
    assert st["disk_misses"] == 1 and st["quarantined"] == 0


def _corrupt(path, how):
    with open(path, "rb") as fh:
        blob = bytearray(fh.read())
    if how == "torn":
        blob = blob[:len(blob) // 2]
    elif how == "flipped":
        blob[len(blob) // 3] ^= 0xFF
    elif how == "garbage":
        blob = bytearray(b"\x00not a library")
    with open(path, "wb") as fh:
        fh.write(blob)


@pytest.mark.parametrize("how", ["torn", "flipped", "garbage"])
def test_corrupt_entry_quarantined(tmp_path, lib, how):
    ds = AOTDiskCache(str(tmp_path / "aot"))
    ident = _ident()
    ds.store(ident, lib)
    _corrupt(ds._path(ident), how)
    assert _load(ds, ident) is None
    assert ds.stats()["quarantined"] == 1
    assert os.path.exists(ds._path(ident) + ".quarantined")


def test_non_elf_and_symbolless_entries_quarantined(tmp_path, lib):
    """An entry whose trailer and identity check out but whose bytes are
    no loadable library, or a library lacking an entry point, is refused
    at ``dlopen`` / symbol lookup."""
    ds = AOTDiskCache(str(tmp_path / "aot"))
    not_elf = tmp_path / "not_elf.so"
    not_elf.write_bytes(b"\x7fELF but not really" * 10)
    ident = _ident()
    assert ds.store(ident, str(not_elf))
    assert _load(ds, ident) is None
    assert ds.store(ident, lib)
    assert ds.load(ident, symbols=SYMBOLS + ("dpgo_missing",)) is None
    assert ds.stats()["quarantined"] == 2
    assert ds.store(ident, lib)
    assert _load(ds, ident) is not None


def test_store_failure_swallowed(tmp_path):
    ds = AOTDiskCache(str(tmp_path / "aot"))
    assert ds.store(_ident(), str(tmp_path / "no_such_library.so")) is False
    assert ds.stats()["store_errors"] == 1 and ds.stats()["stores"] == 0
    assert os.listdir(ds.root) == []  # no temp file left behind


@pytest.fixture
def fake_kernel_library(monkeypatch, lib):
    """``rtr_kernel``'s build and bind, replaced by the stand-in library:
    ``builds`` counts builds, ``binds`` records the bound paths, and a
    build counts as an nvcc run when ``nvcc`` says so."""
    state = {"bound": None, "builds": 0, "binds": [], "nvcc": True}

    def build():
        state["builds"] += 1
        if state["nvcc"]:
            rtr_kernel.NVCC_RUNS += 1
        return lib

    def bind(path):
        state["binds"].append(str(path))
        state["bound"] = str(path)

    real_ident = aotcache.entry_identity
    monkeypatch.setattr(rtr_kernel, "SYMBOLS", SYMBOLS)
    monkeypatch.setattr(rtr_kernel, "_need_cuda", lambda: None)
    monkeypatch.setattr(rtr_kernel, "build", build)
    monkeypatch.setattr(rtr_kernel, "bind", bind)
    monkeypatch.setattr(rtr_kernel, "bound",
                        lambda: state["bound"] is not None)
    monkeypatch.setattr(aotcache, "entry_identity",
                        lambda: real_ident(capability=CAPABILITY))
    return state


def _compile_seconds(run) -> float:
    return sum(run.counter("serve_compile_seconds_total").series().values())


def test_resolution_order_bound_disk_build(tmp_path, fake_kernel_library):
    st = fake_kernel_library
    root = str(tmp_path / "aot")
    with obs.run_scope(str(tmp_path / "cold")) as run:
        ds = AOTDiskCache(root)
        assert aotcache.resolve_kernel_library(ds, label="segment") == \
            "build"
        assert st["builds"] == 1 and ds.stats()["stores"] == 1
        assert ds.stats()["disk_misses"] == 1
        assert _compile_seconds(run) > 0.0  # nvcc ran
        assert aotcache.resolve_kernel_library(ds) == "bound"
        assert ds.stats()["disk_misses"] == 1  # bound: no disk access
    st["bound"] = None  # a fresh process
    with obs.run_scope(str(tmp_path / "warm")) as run:
        ds = AOTDiskCache(root)
        assert aotcache.resolve_kernel_library(ds, label="segment") == \
            "disk"
        assert st["builds"] == 1 and st["binds"][-1].startswith(root)
        assert ds.stats()["disk_hits"] == 1
        assert ds.stats()["disk_misses"] == 0
        assert _compile_seconds(run) == 0.0
    evs = obs.read_events(str(tmp_path / "warm" / "events.jsonl"))
    (cp,) = [e for e in evs if e["event"] == "compile_profile"]
    assert cp["disk_hit"] is True and cp["load_s"] >= 0.0
    assert cp["label"] == "segment"


def test_build_without_nvcc_adds_no_compile_seconds(tmp_path,
                                                    fake_kernel_library):
    """A cold tier whose build found the library already built (no nvcc
    run) stores it and adds nothing to the compile seconds."""
    fake_kernel_library["nvcc"] = False
    with obs.run_scope(str(tmp_path / "run")) as run:
        ds = AOTDiskCache(str(tmp_path / "aot"))
        assert aotcache.resolve_kernel_library(ds) == "build"
        assert ds.stats()["stores"] == 1
        assert _compile_seconds(run) == 0.0
    evs = obs.read_events(str(tmp_path / "run" / "events.jsonl"))
    (cp,) = [e for e in evs if e["event"] == "compile_profile"]
    assert cp["disk_hit"] is False and cp["nvcc"] is False


def test_corrupt_entry_falls_back_to_a_build_and_restores(
        tmp_path, fake_kernel_library):
    st = fake_kernel_library
    root = str(tmp_path / "aot")
    ds = AOTDiskCache(root)
    aotcache.resolve_kernel_library(ds)
    _corrupt(ds._path(aotcache.entry_identity()), "flipped")
    st["bound"] = None
    ds2 = AOTDiskCache(root)
    assert aotcache.resolve_kernel_library(ds2) == "build"  # fail-open
    assert st["builds"] == 2
    assert ds2.stats()["quarantined"] == 1 and ds2.stats()["stores"] == 1
    st["bound"] = None
    assert aotcache.resolve_kernel_library(AOTDiskCache(root)) == "disk"


def test_failed_build_raises(tmp_path, fake_kernel_library, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed to build rtr_full.cu")

    monkeypatch.setattr(rtr_kernel, "build", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        aotcache.resolve_kernel_library(AOTDiskCache(str(tmp_path)))


def test_cpu_tensors_never_touch_the_tier(tmp_path, fake_kernel_library):
    """A server binds the library once, before its first batch on the
    card; a CPU server never touches the tier."""
    aot = str(tmp_path / "aot")
    with SolveServer(device="cpu", aot_cache_dir=aot) as srv:
        srv._bind_kernels()
        st = srv.cache.disk.stats()
    assert (st["disk_hits"], st["disk_misses"], st["stores"]) == (0, 0, 0)
    assert fake_kernel_library["builds"] == 0
    assert os.listdir(aot) == []
    with SolveServer(device="cpu", aot_cache_dir=aot) as srv:
        srv.device = torch.device("cuda", 0)  # as a server on the card
        srv._bind_kernels()
        srv._bind_kernels()  # the second batch: already bound
        st = srv.cache.disk.stats()
    assert fake_kernel_library["builds"] == 1
    assert (st["disk_misses"], st["stores"]) == (1, 1)


def test_library_of_another_toolchain_is_not_stored(tmp_path, lib,
                                                    monkeypatch):
    """``_build/`` names the library by its sources AND its toolchain: a
    library another nvcc built from the same sources is not returned by
    ``build()``, so a cold tier stores only what this toolchain built."""
    version = {"nvcc": "nvcc: release 12.4"}
    compiled = []

    def compile_(path):
        shutil.copyfile(lib, path)
        compiled.append(str(path))

    monkeypatch.setattr(rtr_kernel, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(rtr_kernel, "nvcc_version", lambda: version["nvcc"])
    monkeypatch.setattr(rtr_kernel, "_compile", compile_)
    monkeypatch.setattr(rtr_kernel, "SYMBOLS", SYMBOLS)
    monkeypatch.setattr(rtr_kernel, "_need_cuda", lambda: None)
    monkeypatch.setattr(rtr_kernel, "bound", lambda: False)
    monkeypatch.setattr(rtr_kernel, "bind", lambda path: None)
    monkeypatch.setattr(aotcache, "entry_identity",
                        lambda: entry_identity(capability=CAPABILITY))
    stale = rtr_kernel.build()  # what the older nvcc left in _build/
    assert compiled == [str(stale)]
    assert rtr_kernel.build() == stale and len(compiled) == 1  # reused
    version["nvcc"] = "nvcc: release 12.8"
    runs0 = rtr_kernel.NVCC_RUNS
    ds = AOTDiskCache(str(tmp_path / "aot"))
    assert aotcache.resolve_kernel_library(ds) == "build"
    assert rtr_kernel.NVCC_RUNS == runs0 + 1  # nvcc ran: no stale reuse
    assert len(compiled) == 2 and compiled[1] != str(stale)
    ident = aotcache.entry_identity()
    assert ident["nvcc"] == "nvcc: release 12.8"
    assert ds.stats()["stores"] == 1
    assert _load(ds, ident) is not None
    old = dict(ident, nvcc="nvcc: release 12.4")
    assert _load(ds, old) is None  # no entry claims the old toolchain


def test_cpu_server_with_aot_cache_dir_serves_and_reports(tmp_path):
    meas = make_measurements(np.random.default_rng(0), n=24, d=3, num_lc=8,
                             rot_noise=0.01, trans_noise=0.01)[0]
    params = AgentParams(d=3, r=5, num_robots=2)
    req = SolveRequest(meas=meas, num_robots=2, params=params, max_iters=4,
                       grad_norm_tol=1e-12, eval_every=2)
    with SolveServer(max_batch=2, batch_window_s=0.0, device="cpu") as srv:
        ref = srv.solve(req, timeout=300)
    aot = str(tmp_path / "aot")
    with SolveServer(max_batch=2, batch_window_s=0.0, device="cpu",
                     aot_cache_dir=aot) as srv:
        res = srv.solve(req, timeout=300)
        disk = srv.status()["cache"]["disk"]
    assert res.cost_history == ref.cost_history
    assert torch.equal(res.T, ref.T)
    assert disk["root"] == aot
    assert (disk["disk_hits"], disk["disk_misses"], disk["stores"]) == \
        (0, 0, 0)
    assert os.listdir(aot) == []


def test_tier_server_keeps_first_calls_out_of_compile_seconds(tmp_path):
    """With the tier, a server's programs still record their first calls,
    but ``serve_compile_seconds_total`` counts nvcc builds only (the
    library is bound through the tier before the first batch); without
    it the first calls' walls are the metric."""
    meas = make_measurements(np.random.default_rng(0), n=24, d=3, num_lc=8,
                             rot_noise=0.01, trans_noise=0.01)[0]
    req = SolveRequest(meas=meas, num_robots=2,
                       params=AgentParams(d=3, r=5, num_robots=2),
                       max_iters=4, grad_norm_tol=1e-12, eval_every=2)
    seconds = {}
    for arm, aot in (("plain", None), ("tier", str(tmp_path / "aot"))):
        with obs.run_scope(str(tmp_path / arm)) as run:
            with SolveServer(max_batch=2, batch_window_s=0.0, device="cpu",
                             aot_cache_dir=aot) as srv:
                srv.solve(req, timeout=300)
            seconds[arm] = _compile_seconds(run)
        evs = obs.read_events(str(tmp_path / arm / "events.jsonl"))
        firsts = [e for e in evs if e["event"] == "compile_profile"]
        assert firsts and all("first_call_s" in e for e in firsts)
    assert seconds["plain"] > 0.0 and seconds["tier"] == 0.0


def test_serve_cli_accepts_aot_cache_dir(tmp_path):
    out = subprocess.run([sys.executable, "-m", "dpgo_tpu_torch.serve",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=os.getcwd())
    assert out.returncode == 0 and "--aot-cache-dir" in out.stdout

"""The port's TCP front-end (``dpgo_tpu_torch.serve.frontend``) on the
CPU: wire round-trip, frame-size caps, structured error replies — the
port counterparts of ``tests/test_serve_tcp.py`` — and the wire across
the packages: the port's request frame encodes to the JAX package's bytes,
and a JAX ``solve_g2o`` client gets the same reply (keys, types, values
at rtol 1e-9) from the port's front-end as from the JAX package's.  Every
server and socket closes in a ``with`` block."""

import numpy as np
import pytest
import torch

from dpgo_tpu.serve import SolveServer as JServer
from dpgo_tpu.serve import frontend as jfrontend
from dpgo_tpu.utils.g2o import write_g2o
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch.comms.protocol import ProtocolError, encode_frame
from dpgo_tpu_torch.comms.transport import TcpTransport, connect_tcp
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.serve import SolveServer
from dpgo_tpu_torch.serve import frontend
from dpgo_tpu_torch.serve.frontend import (ServeFrontend, _pack_str,
                                           _unpack_str, handle_request,
                                           solve_g2o)
from dpgo_tpu_torch.utils.g2o import read_g2o

PARAMS = AgentParams(d=3, r=5, num_robots=2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(**kw):
    return SolveServer(device="cpu", **kw)


def _g2o_bytes(tmp_path, n=24, seed=0):
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=5, rot_noise=0.01, trans_noise=0.01)
    path = str(tmp_path / f"prob_{n}_{seed}.g2o")
    write_g2o(meas, path)
    with open(path, "rb") as fh:
        return fh.read()


def test_frontend_ping_and_unknown_op():
    with _server(max_batch=2, batch_window_s=0.0) as srv:
        with ServeFrontend(srv) as fe:
            tr = TcpTransport(connect_tcp("127.0.0.1", fe.port),
                              src="test-client")
            try:
                tr.send({"op": _pack_str("ping")})
                assert int(np.asarray(tr.recv(timeout=10)["ok"])) == 1
                tr.send({"op": _pack_str("launch-missiles")})
                reply = tr.recv(timeout=10)
                assert int(np.asarray(reply["ok"])) == 0
                assert "unknown op" in _unpack_str(reply["error"])
            finally:
                tr.close()


def test_client_side_frame_cap_raises_protocol_error(tmp_path):
    raw = _g2o_bytes(tmp_path)
    with _server(max_batch=2, batch_window_s=0.0) as srv:
        with ServeFrontend(srv) as fe:
            with pytest.raises(ProtocolError, match="exceeds"):
                solve_g2o("127.0.0.1", fe.port, raw, num_robots=2,
                          max_frame_bytes=256)


def test_server_side_frame_cap_reports_structured_error(tmp_path):
    raw = _g2o_bytes(tmp_path)
    with _server(max_batch=2, batch_window_s=0.0) as srv:
        with ServeFrontend(srv, max_frame_bytes=1024) as fe:
            tr = TcpTransport(connect_tcp("127.0.0.1", fe.port),
                              src="test-client")
            try:
                tr.send({"op": _pack_str("solve"),
                         "g2o": np.frombuffer(raw, np.uint8),
                         "num_robots": np.int32(2)})
                reply = tr.recv(timeout=10)
                assert int(np.asarray(reply["ok"])) == 0
                assert "protocol error" in _unpack_str(reply["error"])
            finally:
                tr.close()


def test_handle_request_solves_g2o_payload_in_process(tmp_path):
    raw = _g2o_bytes(tmp_path)
    with _server(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        reply = handle_request(srv, {
            "op": _pack_str("solve"), "g2o": np.frombuffer(raw, np.uint8),
            "num_robots": np.int32(2), "max_iters": np.int32(4),
            "grad_norm_tol": np.float64(1e-12), "eval_every": np.int32(2),
            "tenant": _pack_str("acme")})
    assert int(np.asarray(reply["ok"])) == 1
    assert np.isfinite(np.asarray(reply["cost_history"])).all()
    assert reply["T"].shape[-2:] == (3, 4)
    assert _unpack_str(reply["terminated_by"]) in (
        "grad_norm", "consensus", "max_iters")


def test_handle_request_bad_payload_structured_error():
    with _server(max_batch=2, batch_window_s=0.0) as srv:
        reply = handle_request(srv, {
            "op": _pack_str("solve"),
            "g2o": np.frombuffer(b"VERTEX_SE3:QUAT 0 garbage\n", np.uint8),
            "num_robots": np.int32(2)})
    assert int(np.asarray(reply["ok"])) == 0
    assert _unpack_str(reply["error"])


def test_solve_g2o_over_tcp_matches_the_library(tmp_path):
    """Full solve over a real socket against the library path."""
    raw = _g2o_bytes(tmp_path, n=30, seed=3)
    ref = rbcd.solve_rbcd(read_g2o(raw), 2, params=PARAMS, max_iters=4,
                          grad_norm_tol=1e-12, eval_every=2, device="cpu")
    with _server(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        with ServeFrontend(srv) as fe:
            out = solve_g2o("127.0.0.1", fe.port, raw, num_robots=2,
                            max_iters=4, grad_norm_tol=1e-12, eval_every=2,
                            timeout=120)
    assert out["ok"]
    assert abs(out["cost_history"][-1] - ref.cost_history[-1]) <= \
        1e-8 * max(1.0, abs(ref.cost_history[-1]))
    assert out["T"].shape == tuple(ref.T.shape)


def test_request_frames_encode_to_the_jax_bytes(tmp_path, monkeypatch):
    """The frame the port's ``solve_g2o`` sends is the JAX client's,
    byte for byte, on every wire format."""
    raw = _g2o_bytes(tmp_path)
    sent = {}

    class Capture:
        def __init__(self, sock, src, max_frame_bytes, wire_format):
            self.fmt = wire_format

        def send(self, frame):
            sent.setdefault(self.fmt, []).append(
                encode_frame(frame, self.fmt))

        def recv(self, timeout=None):
            return {"ok": np.int8(0), "error": _pack_str("captured")}

        def close(self):
            pass

    for mod in (frontend, jfrontend):
        monkeypatch.setattr(mod, "TcpTransport", Capture)
        monkeypatch.setattr(mod, "connect_tcp", lambda h, p: None)
    for fmt in ("packed", "npz"):
        for solve in (solve_g2o, jfrontend.solve_g2o):
            out = solve("127.0.0.1", 1, raw, num_robots=3, tenant="t",
                        rank=5, max_iters=7, grad_norm_tol=1e-4,
                        eval_every=2, deadline_s=9.0, session_id="s1",
                        certify_mode="device", wire_format=fmt)
            assert out == {"ok": False, "error": "captured", "shed": False}
        assert sent[fmt][0] == sent[fmt][1]


def test_jax_client_gets_the_same_reply_from_both_frontends(tmp_path):
    """A JAX ``solve_g2o`` client against the port's front-end and the
    JAX package's: the same reply keys and types, equal iterations and
    reason, histories and trajectory at rtol 1e-9."""
    raw = _g2o_bytes(tmp_path, n=28, seed=4)
    kw = dict(num_robots=2, max_iters=6, grad_norm_tol=1e-12, eval_every=2,
              tenant="acme", timeout=120)
    with JServer(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        with jfrontend.ServeFrontend(srv) as fe:
            a = jfrontend.solve_g2o("127.0.0.1", fe.port, raw, **kw)
    with _server(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        with ServeFrontend(srv) as fe:
            b = jfrontend.solve_g2o("127.0.0.1", fe.port, raw, **kw)
    assert a["ok"] and b["ok"]
    assert set(a) == set(b)
    for k in a:
        assert type(a[k]) is type(b[k]), k
    for k in ("iterations", "terminated_by", "recovered"):
        assert a[k] == b[k], k
    for k in ("T", "cost_history", "grad_norm_history"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=1e-10,
                                   err_msg=k)

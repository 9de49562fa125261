"""The port's live-session layer (``dpgo_tpu_torch.models.incremental``) on
the CPU in float64: streamed edge deltas into the padded bucket layout,
warm restarts from exact state, the state codec — the port counterparts of
``tests/test_incremental.py``, held against the JAX package's
``LiveProblem`` on the same seeded streams.

Tolerances: a delta-applied graph equals the JAX package's and a full
rebuild's exactly (indices and values), its tile-major kernel fields
equal a fresh ``pad_problem`` of the same measurements bit for bit; the
objective at one iterate agrees with a full rebuild at 1e-12; the warm
restart reaches the cold cost at 1e-6 relative (both run to the block
fixed point).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models.incremental import LiveProblem as JLive
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch.config import AgentParams, Schedule
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.models.incremental import (LiveProblem,
                                               state_from_arrays,
                                               state_to_arrays)
from dpgo_tpu_torch.serve.bucketing import pad_problem
from dpgo_tpu_torch.types import (edge_set_from_measurements,
                                  loop_closure_mask)

PARAMS = AgentParams(d=3, r=5, num_robots=3, rel_change_tol=0.0)
TILES = ("eidx_i", "eidx_j", "rot_t", "trn_t")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_stream(seed=0, n=30, num_lc=14, hold=3, noise=0.02):
    """A synthetic problem with ``hold`` loop closures withheld as the
    stream (num_poses pinned so the pose set is identical)."""
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=num_lc, rot_noise=noise,
                                trans_noise=noise)
    lc_idx = np.nonzero(loop_closure_mask(meas))[0]
    keep = np.ones(len(meas), bool)
    keep[lc_idx[-hold:]] = False
    base = dataclasses.replace(meas.select(keep), num_poses=meas.num_poses)
    extra = dataclasses.replace(meas.select(~keep), num_poses=meas.num_poses)
    return meas, base, extra


def _live(meas, params=PARAMS):
    return LiveProblem(meas, 3, params=params, device="cpu")


def _central(graph, part, num_meas, X, weights):
    body = rbcd._central_metrics_body(
        graph, edge_set_from_measurements(part.meas_global, device="cpu"),
        part.meas_global.num_poses, num_meas, telemetry=False)
    A = X.shape[0]
    return body(X, weights, torch.zeros(A, dtype=torch.bool),
                torch.tensor(0.1, dtype=torch.float64),
                torch.zeros(A, dtype=torch.float64)).numpy()


def _fresh_pad(live):
    full = rbcd.prepare_problem(live.meas, 3, params=live.params,
                                init=None, device="cpu")
    return full, pad_problem(full, live.shape)


def test_delta_append_matches_full_rebuild_exactly():
    """The masked-append graph evaluates the SAME objective as a full
    rebuild padded to the same bucket, and its kernel tiles are the fresh
    pad's, bit for bit (stale tiles would be wrong on the card only)."""
    meas, base, extra = _split_stream()
    live = _live(base)
    res0 = live.solve(max_iters=40, grad_norm_tol=1e-6)
    tiles0 = {f: getattr(live.padded.graph, f).clone() for f in TILES}

    d = live.apply_edges(extra)
    assert d.mode == "delta" and not d.recompiles
    full, ref = _fresh_pad(live)
    for f in TILES:
        assert torch.equal(getattr(live.padded.graph, f),
                           getattr(ref.graph, f)), f
    assert not all(torch.equal(tiles0[f], getattr(live.padded.graph, f))
                   for f in TILES)
    for f in range(3):
        assert torch.equal(live.padded.graph.dense_inc[f],
                           ref.graph.dense_inc[f])
    X = res0.state.X
    v1 = _central(live.padded.graph, live.part, len(meas), X,
                  torch.ones_like(live.padded.graph.edges.weight))
    v2 = _central(ref.graph, full.part, len(meas), X,
                  torch.ones_like(ref.graph.edges.weight))
    np.testing.assert_allclose(v1[:2], v2[:2], rtol=1e-12, atol=1e-12)


def test_delta_graph_equals_jax_delta_graph():
    """The same stream through both packages' ``LiveProblem``: the
    delta-applied padded graph and global edge set are equal, field by
    field."""
    meas, base, extra = _split_stream(seed=3, num_lc=16)
    jp = jconfig.AgentParams(d=3, r=5, num_robots=3, rel_change_tol=0.0)
    jl = JLive(base, 3, params=jp, dtype=jnp.float64)
    tl = _live(base)
    assert tuple(jl.shape) == tuple(tl.shape)
    assert jl.apply_edges(extra).mode == tl.apply_edges(extra).mode == \
        "delta"
    jg, tg = jl.padded.graph, tl.padded.graph
    for f in ("i", "j", "R", "t", "kappa", "tau", "weight", "mask", "is_lc",
              "fixed_weight"):
        np.testing.assert_array_equal(getattr(tg.edges, f).numpy(),
                                      np.asarray(getattr(jg.edges, f)))
        np.testing.assert_array_equal(
            getattr(tl.padded.edges_g, f).numpy(),
            np.asarray(getattr(jl.padded.edges_g, f)))
    for f in ("meas_id", "pub_idx", "pub_mask", "nbr_robot", "nbr_pub",
              "nbr_mask", "inc_slot", "inc_mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def test_delta_keeps_bucket_and_meta_stable():
    """A fitting delta leaves the bucket shape AND the padded GraphMeta
    (what the cached programs are keyed on) untouched; a stream too large
    for the padding re-buckets with an honest ``recompiles`` flag."""
    meas, base, extra = _split_stream()
    live = _live(base)
    shape0, meta0 = live.shape, live.padded.meta
    assert live.apply_edges(extra).mode == "delta"
    assert live.shape == shape0
    assert live.padded.meta == meta0

    n = meas.num_poses
    burst, _ = make_measurements(np.random.default_rng(5), n=n, d=3,
                                 num_lc=80, rot_noise=0.01,
                                 trans_noise=0.01)
    burst = dataclasses.replace(burst.select(loop_closure_mask(burst)),
                                num_poses=n)
    d2 = live.apply_edges(burst)
    assert d2.mode == "rebucket" and d2.recompiles
    assert live.shape != shape0
    assert len(live.meas) == len(meas) + len(burst)
    _, ref = _fresh_pad(live)
    for f in TILES:
        assert torch.equal(getattr(live.padded.graph, f),
                           getattr(ref.graph, f))


def test_delta_new_shared_edge_grows_slots_and_publics():
    """A streamed CROSS-robot edge between poses that were never shared
    exercises the slot/public append path; the graph still matches a full
    rebuild, tiles included."""
    meas, _ = make_measurements(np.random.default_rng(3), n=30, d=3,
                                num_lc=6, rot_noise=0.01, trans_noise=0.01)
    live = _live(meas)
    s_used_before = int(live.padded.graph.nbr_mask.sum())
    new = dataclasses.replace(
        meas.select(np.zeros(len(meas), bool)), num_poses=meas.num_poses)
    new = dataclasses.replace(
        new, r1=np.zeros(1, np.int32), p1=np.asarray([2], np.int64),
        r2=np.zeros(1, np.int32), p2=np.asarray([27], np.int64),
        R=np.eye(3)[None], t=np.zeros((1, 3)),
        kappa=np.asarray([100.0]), tau=np.asarray([10.0]),
        weight=np.ones(1), is_known_inlier=np.zeros(1, bool))
    npr = meas.num_poses // 3
    expected = int((2, 27 - 2 * npr) not in live._slot_of[0]) + \
        int((0, 2) not in live._slot_of[2])
    assert expected >= 1
    assert live.apply_edges(new).mode == "delta"
    assert int(live.padded.graph.nbr_mask.sum()) == s_used_before + expected

    full, ref = _fresh_pad(live)
    for f in TILES:
        assert torch.equal(getattr(live.padded.graph, f),
                           getattr(ref.graph, f))
    X = ref.X0
    v1 = _central(live.padded.graph, live.part, len(live.meas), X,
                  torch.ones_like(live.padded.graph.edges.weight))
    v2 = _central(ref.graph, full.part, len(live.meas), X,
                  torch.ones_like(ref.graph.edges.weight))
    np.testing.assert_allclose(v1[:2], v2[:2], rtol=1e-12, atol=1e-12)


def test_warm_dispatch_reaches_cold_cost():
    """After +edges the warm restart converges to the SAME final cost as
    a cold re-solve (rel <= 1e-6), and to the JAX package's warm cost."""
    meas, base, extra = _split_stream(seed=1, n=40, num_lc=18, hold=2)
    live = _live(base)
    res0 = live.solve(max_iters=300, grad_norm_tol=1e-9, eval_every=2)
    resc = _live(meas).solve(max_iters=300, grad_norm_tol=1e-9,
                             eval_every=2)
    resw = live.warm_dispatch(res0, new_edges=extra, max_iters=300,
                              grad_norm_tol=1e-9, eval_every=2)
    assert live.last_delta.mode == "delta"
    rel = abs(resw.cost_history[-1] - resc.cost_history[-1]) / \
        max(1.0, abs(resc.cost_history[-1]))
    assert rel <= 1e-6, (resw.cost_history[-1], resc.cost_history[-1])


def test_warm_dispatch_without_delta_terminates_immediately():
    meas, base, _ = _split_stream(seed=2)
    live = _live(base)
    res0 = live.solve(max_iters=300, grad_norm_tol=1e-9, eval_every=2)
    resw = live.warm_dispatch(res0, max_iters=300, grad_norm_tol=1e-9,
                              eval_every=2)
    assert resw.iterations <= 4
    assert resw.cost_history[-1] == res0.cost_history[-1]


def test_warm_dispatch_remaps_gnc_weights():
    """Carried GNC weights follow their measurements onto the new rows."""
    meas, base, extra = _split_stream(seed=4)
    live = _live(base)
    st = live.solve(max_iters=20, grad_norm_tol=1e-6).state
    g = live.padded.graph
    meas_id = g.meas_id.numpy().copy()
    mask = g.edges.mask.numpy().copy()
    is_lc = g.edges.is_lc.numpy() > 0
    a, e = map(int, np.argwhere(is_lc & (mask > 0))[0])
    victim = int(meas_id[a, e])
    w = st.weights.numpy().copy()
    w[(meas_id == victim) & (mask > 0)] = 0.125
    st = st._replace(weights=torch.as_tensor(w))

    live.apply_edges(extra)
    adapted = live._adapt_state(st, (meas_id, mask, len(base)))
    w2 = adapted.weights.numpy()
    id2 = live.padded.graph.meas_id.numpy()
    m2 = live.padded.graph.edges.mask.numpy() > 0
    rows = (id2 == victim) & m2
    assert rows.any()
    np.testing.assert_allclose(w2[rows], 0.125)
    fresh = (id2 >= len(base)) & m2
    assert fresh.any()
    np.testing.assert_allclose(w2[fresh], 1.0)


def test_new_poses_are_rejected():
    meas, base, _ = _split_stream()
    live = _live(base)
    bad = dataclasses.replace(base.select([0]),
                              num_poses=base.num_poses + 1,
                              p2=np.asarray([base.num_poses]))
    with pytest.raises(ValueError, match="NEW poses"):
        live.apply_edges(bad)


def test_colored_schedule_falls_back_to_rebuild():
    meas, base, extra = _split_stream()
    live = _live(base, dataclasses.replace(PARAMS,
                                           schedule=Schedule.COLORED))
    assert live.apply_edges(extra).mode in ("repad", "rebucket")


def test_state_codec_round_trip_and_jax_names():
    """The codec round-trips every persisted field, drops the factors,
    and writes the JAX package's names and types (iteration int32, key
    ``[0, seed]`` uint32)."""
    meas, base, _ = _split_stream()
    res = _live(base).solve(max_iters=10, grad_norm_tol=1e-6)
    st = res.state._replace(seed=7)
    arrays = state_to_arrays(st)
    assert arrays["iteration"].dtype == np.int32
    np.testing.assert_array_equal(arrays["key"],
                                  np.asarray([0, 7], np.uint32))
    back = state_from_arrays(arrays, device="cpu")
    for f in ("X", "weights", "rel_change", "ready", "gamma", "alpha",
              "mu"):
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    assert (back.iteration, back.seed) == (st.iteration, 7)
    assert back.chol is None and back.Qbuf is None
    assert set(arrays) <= {"X", "weights", "iteration", "key", "rel_change",
                           "ready", "gamma", "alpha", "mu", "V", "X_init"}


def test_live_problem_on_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    meas, base, _ = _split_stream()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiveProblem(base, 3, params=PARAMS)

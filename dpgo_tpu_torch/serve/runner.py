"""Batched dispatch: many problems per round (port of
``dpgo_tpu.serve.runner``).

``run_bucket`` stacks shape-identical padded problems (``bucketing``) and
steps them together.  The JAX package ``vmap``\\ s its fused RBCD segment
over a leading problem axis; the port's kernel is bound through ``ctypes``
and has no vmap, so the batch is laid out as one graph of ``B*A`` agents
(``stack_graphs``: member b's agents at rows ``[b*A, (b+1)*A)``, its
neighbor robots, global pose indices and measurement ids offset into
member b's block) and one state (``stack_states``: ``mu`` is ``[B]``),
and ``models.rbcd``'s round steps it as it is: everything per agent stays
per agent, and what vmap keeps per member (GNC's freeze test and ``mu``,
Nesterov's ``A``, GREEDY's argmax, COLORED's classes, ASYNC's clocks)
stays per member.  On a CUDA device every float32 round is ONE launch of
the fused RTR kernel for all ``B*A`` agents; the metric rows, the
verdict words and the terminal epilogue are computed for all members at
once (``[B, ...]`` tensors), with the certificate payload per member.

The batch axis is padded to the next power of two by replicating the last
problem, so one cached program set per (bucket, pow2-width) serves every
occupancy instead of one per exact batch size.

Programs come from the caller's ``ExecutableCache`` keyed by the config
fingerprint (``cache.problem_fingerprint``): segment, metrics, verdict and
terminal-epilogue programs are each cached independently; with
``params.certify_mode="device"`` the epilogue also computes the
per-member dual-certificate payload so the certificate rides the batch's
single terminal fetch.  With telemetry on, the cached entries are
``obs.profile.ProfiledExecutable``\\ s (first-call wall, kernel launches
and device time recorded per fingerprint key), each dispatch window times
itself into ``serve_dispatch_device_seconds``, and the stack/dispatch/
slice stages emit spans under the server's per-batch ``dispatch`` span —
each ``device_dispatch`` span carries the rounds it stepped and the
process's B2 launches meanwhile (exact in a process with one serving
thread, as a fleet child is); with telemetry off none of that machinery
exists.

Termination mirrors ``run_rbcd``: per problem, the centralized gradient
norm against ``grad_norm_tol`` or all-agents consensus; the batch keeps
stepping until every member has terminated (a converged member's extra
rounds only polish its iterate), with each member's history truncated at
its own termination eval.  Every readback goes through
``rbcd._host_fetch``: one ``[B, 3]`` row per eval, or one ``[B]`` int32
verdict word per K rounds, and one terminal fetch.  Nothing is enqueued
past the boundary a fetch reads, so the rounds a bucket enqueued are
``info["rounds"]``.
"""

from __future__ import annotations

import time

import torch

from .. import obs
from ..config import RobustCostType
from ..models import rbcd
from ..obs.trace import span
from ..ops import manifold, quadratic
from ..ops import rtr_kernel as rk
from ..types import EdgeSet
from .bucketing import PaddedProblem
from .cache import ExecutableCache, fingerprint_key, problem_fingerprint


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def stack_graphs(graphs: list, meta: rbcd.GraphMeta, n_total: int,
                 num_meas: int, dense: bool = False
                 ) -> rbcd.MultiAgentGraph:
    """One graph of ``B*A`` agents from ``B`` same-bucket member graphs:
    every field concatenated along the agent axis, with each member's
    neighbor robots offset by ``b*A`` (the exchange stays within the
    member), its global pose indices by ``b*n_total`` and its measurement
    ids by ``b*num_meas`` (the gathers land in member b's block).  The
    dense-Q incidence is built for the stacked rows when ``dense``."""
    A = meta.num_robots

    def cat(get, step=0):
        vals = [get(g) for g in graphs]
        if any(v is None for v in vals):
            return None
        return torch.cat([v + b * step if step else v
                          for b, v in enumerate(vals)])

    edges = EdgeSet(*(cat(lambda g, f=f: getattr(g.edges, f))
                      for f in EdgeSet._fields))
    dense_inc = None
    if dense:
        dense_inc = quadratic.dense_q_incidence(
            edges.i.cpu().numpy(), edges.j.cpu().numpy(),
            meta.n_max + meta.s_max, edges.i.device)
    return rbcd.MultiAgentGraph(
        edges=edges,
        meas_id=cat(lambda g: g.meas_id, num_meas),
        n=cat(lambda g: g.n),
        pose_mask=cat(lambda g: g.pose_mask),
        pub_idx=cat(lambda g: g.pub_idx),
        pub_mask=cat(lambda g: g.pub_mask),
        nbr_robot=cat(lambda g: g.nbr_robot, A),
        nbr_pub=cat(lambda g: g.nbr_pub),
        nbr_mask=cat(lambda g: g.nbr_mask),
        global_index=cat(lambda g: g.global_index, n_total),
        inc_slot=cat(lambda g: g.inc_slot),
        inc_mask=cat(lambda g: g.inc_mask),
        eidx_i=cat(lambda g: g.eidx_i),
        eidx_j=cat(lambda g: g.eidx_j),
        rot_t=cat(lambda g: g.rot_t),
        trn_t=cat(lambda g: g.trn_t),
        color=cat(lambda g: g.color),
        dense_inc=dense_inc)


def stack_states(states: list) -> rbcd.RBCDState:
    """One batch state from member states: per-agent fields concatenated,
    ``mu`` stacked to ``[B]``.  The members share the host round index and
    the ASYNC seed (a batch steps them in lockstep)."""
    s0 = states[0]
    for s in states[1:]:
        if s.iteration != s0.iteration or s.seed != s0.seed:
            raise ValueError(
                "run_bucket requires members at one round index and ASYNC "
                f"seed (got iteration {s.iteration} vs {s0.iteration}, "
                f"seed {s.seed} vs {s0.seed})")

    def cat(f):
        vals = [getattr(s, f) for s in states]
        return None if vals[0] is None else torch.cat(vals)

    return s0._replace(
        X=cat("X"), weights=cat("weights"), rel_change=cat("rel_change"),
        ready=cat("ready"), chol=cat("chol"), V=cat("V"),
        gamma=cat("gamma"), alpha=cat("alpha"),
        mu=torch.stack([s.mu.reshape(()) for s in states]),
        X_init=cat("X_init"), Qbuf=cat("Qbuf"))


def slice_states(state: rbcd.RBCDState, A: int,
                 n: int) -> list[rbcd.RBCDState]:
    """The first ``n`` members' states of a batch state (device views; the
    session store materializes them on save)."""
    out = []
    for b in range(n):
        rows = slice(b * A, (b + 1) * A)

        def part(t):
            return None if t is None else t[rows]

        out.append(state._replace(
            X=part(state.X), weights=part(state.weights),
            rel_change=part(state.rel_change), ready=part(state.ready),
            chol=part(state.chol), V=part(state.V), gamma=part(state.gamma),
            alpha=part(state.alpha), mu=state.mu[b],
            X_init=part(state.X_init), Qbuf=part(state.Qbuf)))
    return out


def _stack_edges(edge_sets: list) -> EdgeSet:
    return EdgeSet(*(torch.stack([getattr(e, f) for e in edge_sets])
                     for f in EdgeSet._fields))


def _batch_metrics(Xa, weights, ready, graph_b, eg_b, inc_g, B: int,
                   n_total: int, num_meas: int) -> torch.Tensor:
    """Per member: the centralized cost, Riemannian gradient norm and
    consensus flag, ``[B, 3]`` — the metric row of ``run_rbcd`` (its
    Euclidean gradient summed over the ELL incidence ``inc_g`` of the
    global edges), shared by the per-eval and the verdict programs so
    both record the same rows bit for bit."""
    Xg = rbcd.gather_to_global(Xa, graph_b, B * n_total)
    Xg = Xg.reshape((B, n_total) + Xg.shape[1:])
    w = rbcd.global_weights(weights, graph_b, B * num_meas)
    eg = eg_b._replace(weight=w.reshape(B, num_meas))
    f = quadratic.cost(Xg, eg)
    g = manifold.rgrad(Xg, quadratic.egrad_ell(Xg, eg, *inc_g))
    consensus = torch.all(ready.reshape(B, -1), dim=1).to(f.dtype)
    return torch.stack([f, manifold.norm(g), consensus], dim=1)


def _make_segment_exec(meta: rbcd.GraphMeta, params):
    def seg(state_b, graph_b, k, uw=False, rs=False):
        return rbcd.rbcd_segment(state_b, graph_b, k, meta, params,
                                 first_update_weights=uw, first_restart=rs)

    return seg


def _make_metrics_exec(B: int, n_total: int, num_meas: int):
    def met(Xa, weights, ready, graph_b, eg_b, inc_g):
        return _batch_metrics(Xa, weights, ready, graph_b, eg_b, inc_g, B,
                              n_total, num_meas)

    return met


def _make_verdict_exec(B: int, n_total: int, num_meas: int,
                       grad_norm_tol: float):
    """Batched eval program of the verdict mode: per problem, the
    centralized metrics, the convergence test, and a non-finite sentinel
    fold into a packed per-problem verdict word and the terminal eval
    latches on device (``rbcd.fold_verdict``), and the metric row lands
    in a device-side history — so the host reads back ONE ``[B]`` int32
    vector per K rounds instead of the ``[B, 3]`` float rows per eval.
    The eval index and the round index are the host's."""

    def vex(Xa, weights, ready, graph_b, eg_b, inc_g, iteration: int,
            eval_idx: int, word, term_eval, term_it, hist):
        vec = _batch_metrics(Xa, weights, ready, graph_b, eg_b, inc_g, B,
                             n_total, num_meas)
        f, gn, consensus = vec.unbind(1)
        finite = torch.isfinite(f) & torch.isfinite(gn)
        anom = torch.where(finite, 0, rbcd.ANOMALY_NON_FINITE).to(
            torch.int32)
        word, term_eval, term_it = rbcd.fold_verdict(
            word, term_eval, term_it, term_eval.new_full((), eval_idx),
            iteration, gn, consensus, anom, 0, grad_norm_tol)
        hist = hist.index_copy(1, torch.full((1,), eval_idx,
                                             dtype=torch.long,
                                             device=hist.device),
                               vec[:, None].to(hist.dtype))
        return word, term_eval, term_it, hist

    return vex


def _make_epilogue_exec(meta: rbcd.GraphMeta, B: int, n_total: int,
                        num_meas: int, certify_mode: str = "off",
                        certify_seed: int = 0):
    """Batched terminal epilogue (``rbcd.make_terminal_epilogue`` over the
    members): rounding/anchoring and the weight collapse, plus — with
    ``certify_mode="device"`` — the gauge-deflated device-certificate
    eigensolve of each member.  Padded members are benign: a padded pose
    contributes zero rows to the dual operator, whose zero eigenvalue is
    clamped by the payload's ``min(lam, 0)``."""
    device_cert = certify_mode == "device"
    want_xg = certify_mode in ("device", "host")
    if device_cert:
        from ..models import certify as certify_mod

    def fin(Xa, weights, graph_b, eg_b, inc_g):
        Xg = rbcd.gather_to_global(Xa, graph_b, B * n_total)
        Xg = Xg.reshape((B, n_total) + Xg.shape[1:])
        w = rbcd.global_weights(weights, graph_b,
                                B * num_meas).reshape(B, num_meas)
        ylift = rbcd.lifting_matrix(meta, Xg.dtype, Xg.device)
        out = {"T": torch.stack([rbcd.round_global(Xg[b], ylift)
                                 for b in range(B)]),
               "w": w}
        if want_xg:
            out["Xg"] = Xg
        if device_cert:
            out["cert"] = [certify_mod.device_certificate_payload(
                Xg[b], EdgeSet(*(getattr(eg_b, f)[b]
                                 for f in EdgeSet._fields))._replace(
                                     weight=w[b]),
                certify_seed, inc=(inc_g[0][b], inc_g[1][b]))
                for b in range(B)]
        return out

    return fin


def _cached_exec(cache: ExecutableCache, fp: dict, make,
                 static_names: tuple = ()):
    """Cache lookup with the first-call profiling wrap applied behind the
    telemetry fence: with a run live, the cached entry is a
    ``ProfiledExecutable`` (first-call wall, kernel launches and device
    time recorded per fingerprint key); with telemetry off the bare
    program is stored and no profiling object ever exists.  A cache
    carrying the artifact tier keeps first calls out of
    ``serve_compile_seconds_total``: its server bound the kernel library
    through the tier before the first batch, so there the metric counts
    nvcc builds only."""
    run = obs.get_run()
    if run is None:
        return cache.get(fp, make)
    from ..obs.profile import ProfiledExecutable

    return cache.get(fp, lambda: ProfiledExecutable(
        make(), key=fingerprint_key(fp), label=fp.get("kind", "?"),
        static_names=static_names, count_compile=cache.disk is None,
        bucket=fp.get("bucket_shape"), batch=fp.get("batch")))


def _dispatch_time(run, t_d0: float) -> None:
    dt = time.monotonic() - t_d0
    run.gauge("serve_dispatch_device_seconds",
              "wall-clock of the last batched dispatch window "
              "(segment launches through metrics readback)",
              unit="s").set(dt)
    run.counter("serve_device_time_seconds_total",
                "cumulative batched-dispatch wall-clock",
                unit="s").inc(dt)


def run_bucket(padded: list[PaddedProblem], cache: ExecutableCache,
               max_iters: int | None = None, grad_norm_tol: float = 0.1,
               eval_every: int = 1, verdict_every: int | None = None,
               session_cb=None, session_every: int = 1,
               should_stop=None):
    """Solve a list of same-bucket padded problems as one batch.

    Returns ``(results, info)``: per-problem ``RBCDResult`` (trajectories
    and weights sliced back to the problem's real pose/measurement counts,
    on the host), and a dict of batch statistics (rounds, evals, batch
    width, occupancy) for the serving metrics.

    ``verdict_every`` (a positive multiple of ``eval_every``) switches
    the batch to the device-resident verdict loop: per-problem
    termination latches on device (``_make_verdict_exec``) and the host
    reads back one packed ``[B]`` int32 verdict vector per K rounds per
    bucket, with the per-eval histories fetched once at the end.  A
    member that terminates mid-window runs up to ``K - eval_every``
    extra polish rounds; its reported history and round count are
    truncated at its latched terminal eval.

    ``session_cb(iteration, states)`` — the crash-recovery hook
    (``serve.session``): called every ``session_every`` eval boundaries
    (and at the verdict-mode K boundaries) with the per-problem sliced
    solver states, so a server can persist resumable snapshots while the
    batch is in flight.  A member problem carrying ``state0`` resumes
    from that exact state instead of its ``X0`` init.

    ``should_stop()`` — the interruption hook (``SolveServer.drain`` /
    ``kill``): polled at eval/verdict boundaries, AFTER the boundary's
    ``session_cb`` snapshot lands (when one is due it is forced, so a
    stopping batch always leaves a resume point).  A True return breaks
    the loop early; the partial results return as usual and ``info``
    carries ``interrupted=True``."""
    if not padded:
        return [], {"rounds": 0, "evals": 0, "batch": 0, "occupancy": 0.0,
                    "interrupted": False}
    first = padded[0]
    meta, params, dtype = first.meta, first.prob.params, first.prob.dtype
    shape = first.shape
    for p in padded[1:]:
        if p.shape != shape or p.meta != meta or p.prob.params != params \
                or p.prob.dtype != dtype:
            raise ValueError(
                "run_bucket requires shape/config-identical problems — "
                "bucketing must never mix incompatible shapes "
                f"({p.shape} vs {shape})")
    max_iters = params.max_num_iters if max_iters is None else max_iters
    if verdict_every is not None and (verdict_every <= 0
                                      or verdict_every % eval_every != 0):
        raise ValueError(
            f"verdict_every={verdict_every} must be a positive "
            f"multiple of eval_every={eval_every}")
    A = meta.num_robots
    n_total, num_meas = shape.n_total, shape.num_meas
    dev = first.graph.edges.R.device

    B_real = len(padded)
    B = _next_pow2(B_real)

    def _initial_state(p: PaddedProblem):
        if p.state0 is not None:
            st = p.state0
            st = st._replace(**{
                f: getattr(st, f).to(dev) for f in (
                    "X", "weights", "rel_change", "ready", "chol", "V",
                    "gamma", "alpha", "mu", "X_init", "Qbuf")
                if getattr(st, f) is not None})
            # Persisted snapshots drop the recomputable factors; restore
            # them from the carried weights (bit-identical refresh).
            if st.chol is None:
                st = rbcd.refresh_problem(st, p.graph, meta, params)
            return st
        return rbcd.init_state(p.graph, meta, p.X0, params=params)

    with span("stack", phase="serve", batch=B, size=B_real):
        members = list(padded) + [padded[-1]] * (B - B_real)
        states = [_initial_state(p) for p in padded]
        states += [states[-1]] * (B - B_real)  # replicate the pow2 tail
        state_b = stack_states(states)
        graph_b = stack_graphs([p.graph for p in members], meta, n_total,
                               num_meas,
                               dense=state_b.Qbuf is not None
                               or rbcd._dense(meta, params, dtype))
        eg_b = _stack_edges([p.edges_g for p in members])
        # Built once per batch: the global edges' incidence reads their
        # indices on the host.
        inc_g = quadratic.edge_incidence(eg_b, n_total)

    seg = _cached_exec(
        cache, problem_fingerprint(meta, params, dtype, shape, B, "segment"),
        lambda: _make_segment_exec(meta, params),
        static_names=("uw", "rs"))
    met = _cached_exec(
        cache, problem_fingerprint(meta, params, dtype, shape, B, "metrics"),
        lambda: _make_metrics_exec(B, n_total, num_meas))
    certify_mode = getattr(params, "certify_mode", "off")
    fin = _cached_exec(
        cache, problem_fingerprint(meta, params, dtype, shape, B,
                                   f"epilogue:{certify_mode}"),
        lambda: _make_epilogue_exec(meta, B, n_total, num_meas,
                                    certify_mode))

    robust_on = params.robust.cost_type != RobustCostType.L2
    accel_on = params.acceleration

    it = 0
    nwu = 0
    evals = 0
    done = [False] * B_real
    cost_hist = [[] for _ in range(B_real)]
    gn_hist = [[] for _ in range(B_real)]
    term = ["max_iters"] * B_real
    iters = [max_iters] * B_real
    interrupted = False
    run = obs.get_run()

    def advance(state_b, it, nwu, target):
        while it < target:
            uw, rs, end = rbcd.schedule_bounds(
                it, nwu, max_iters=max_iters, eval_every=eval_every,
                params=params, robust_on=robust_on, accel_on=accel_on)
            nwu += int(uw)
            state_b = seg(state_b, graph_b, end - it, uw=uw, rs=rs)
            it = end
        return state_b, it, nwu

    if verdict_every is not None:
        vex = _cached_exec(
            cache, problem_fingerprint(meta, params, dtype, shape, B,
                                       f"verdict{grad_norm_tol}"),
            lambda: _make_verdict_exec(B, n_total, num_meas,
                                       grad_norm_tol))
        max_evals = -(-max_iters // eval_every)
        word = torch.zeros((B,), dtype=torch.int32, device=dev)
        term_eval = torch.full((B,), -1, dtype=torch.int32, device=dev)
        term_it = torch.full((B,), -1, dtype=torch.int32, device=dev)
        hist = torch.zeros((B, max_evals, 3), dtype=dtype, device=dev)
        eval_its: list[int] = []
        while True:
            vtarget = min(((it // verdict_every) + 1) * verdict_every,
                          max_iters)
            t_d0 = time.monotonic() if run is not None else 0.0
            it0, k0 = it, rk.LAUNCHES
            with span("device_dispatch", phase="serve", batch=B,
                      verdict=True) as dsp:
                while it < vtarget:
                    state_b, it, nwu = advance(
                        state_b, it, nwu,
                        min(((it // eval_every) + 1) * eval_every, vtarget))
                    word, term_eval, term_it, hist = vex(
                        state_b.X, state_b.weights, state_b.ready, graph_b,
                        eg_b, inc_g, state_b.iteration, evals, word,
                        term_eval, term_it, hist)
                    evals += 1
                    eval_its.append(it)
                # The batch's one readback per K rounds: the packed
                # per-problem verdict vector.
                wv = rbcd._host_fetch(word)
                dsp.add(rounds=it - it0, b2_launches=rk.LAUNCHES - k0)
            if run is not None:
                _dispatch_time(run, t_d0)
            if session_cb is not None:
                # Snapshot at the verdict boundary: the live batch state is
                # on hand and the window's segments have been enqueued.
                session_cb(it, slice_states(state_b, A, B_real))
            if should_stop is not None and should_stop():
                # Stop AFTER the boundary snapshot: the batch leaves a
                # resume point at exactly this iteration.
                interrupted = True
                break
            all_terminal = bool(((wv & 7) != rbcd.VERDICT_RUNNING).all())
            if it >= max_iters or all_terminal:
                break

    while verdict_every is None and it < max_iters and not all(done) \
            and not interrupted:
        target = min(((it // eval_every) + 1) * eval_every, max_iters)
        t_d0 = time.monotonic() if run is not None else 0.0
        it0, k0 = it, rk.LAUNCHES
        with span("device_dispatch", phase="serve", batch=B) as dsp:
            state_b, it, nwu = advance(state_b, it, nwu, target)
            # The metrics readback is the batch's sync point per eval.
            vec = rbcd._host_fetch(met(state_b.X, state_b.weights,
                                       state_b.ready, graph_b, eg_b, inc_g))
            dsp.add(rounds=it - it0, b2_launches=rk.LAUNCHES - k0)
        if run is not None:
            _dispatch_time(run, t_d0)
        evals += 1
        stop = should_stop is not None and should_stop()
        if session_cb is not None and (
                stop or evals % max(int(session_every), 1) == 0):
            # A stopping batch forces the boundary snapshot even when the
            # cadence would skip it — a resumed request needs the point.
            session_cb(it, slice_states(state_b, A, B_real))
        if stop:
            interrupted = True
        rows = vec.tolist()
        for b in range(B_real):
            if done[b]:
                continue
            f, gn, consensus = rows[b]
            cost_hist[b].append(f)
            gn_hist[b].append(gn)
            if gn < grad_norm_tol:
                done[b], term[b], iters[b] = True, "grad_norm", it
            elif consensus > 0:
                done[b], term[b], iters[b] = True, "consensus", it

    with span("slice", phase="serve", batch=B, certify=certify_mode):
        # The batch's ONE terminal read: rounded trajectories, collapsed
        # weights, the raw batch iterate, the verdict mode's device-side
        # histories + latched indices, and (certify on) the per-member
        # certificate payloads — a single fetch through the seam.
        ep = {"fin": fin(state_b.X, state_b.weights, graph_b, eg_b, inc_g),
              "X": state_b.X}
        if verdict_every is not None:
            ep["hist"] = hist
            ep["te"] = torch.stack([term_eval, term_it])
        ep = rbcd._host_fetch(ep)
    if verdict_every is not None:
        hist_h, te_h = ep["hist"], ep["te"].tolist()
        for b in range(B_real):
            te, ti = te_h[0][b], te_h[1][b]
            status = int(wv[b]) & 7
            if te >= 0:
                n_keep = te + 1
                iters[b] = ti
                term[b] = rbcd._VERDICT_STATUS.get(status, "max_iters")
            else:
                n_keep = len(eval_its)
                iters[b] = it
                term[b] = "max_iters"
            cost_hist[b] = hist_h[b, :n_keep, 0].tolist()
            gn_hist[b] = hist_h[b, :n_keep, 1].tolist()
    T_b, w_b, X_b = ep["fin"]["T"], ep["fin"]["w"], ep["X"]
    results = []
    for b, p in enumerate(padded):
        certificate = None
        if certify_mode != "off":
            # Host decision per member on the already-fetched payload —
            # the f64 REFUSE fallback reads the fetched Xg, never the
            # device.
            with span("certify_decide", phase="serve", member=b):
                fin_b = {"T": T_b[b], "w_glob": w_b[b]}
                if "Xg" in ep["fin"]:
                    fin_b["Xg"] = ep["fin"]["Xg"][b]
                if "cert" in ep["fin"]:
                    fin_b["cert"] = ep["fin"]["cert"][b]
                certificate = rbcd._epilogue_certificate(
                    fin_b, p.edges_g, params, dtype)
        results.append(rbcd.RBCDResult(
            T=T_b[b, :p.prob.n_total],
            X=X_b[b * A:(b + 1) * A, :p.prob.meta.n_max],
            cost_history=cost_hist[b],
            grad_norm_history=gn_hist[b],
            iterations=iters[b],
            terminated_by=term[b],
            weights=w_b[b, :p.prob.num_meas],
            certificate=certificate,
        ))
    info = {"rounds": it, "evals": evals, "batch": B,
            "size": B_real, "occupancy": B_real / float(B),
            "interrupted": interrupted}
    return results, info

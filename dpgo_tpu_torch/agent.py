"""Per-robot agent runtime with the reference's message-passing surface —
the PyTorch port of ``dpgo_tpu.agent``.

The batched RBCD core (``models.rbcd``) runs *all* agents on one device.
This module is the *deployment* shape: one ``PGOAgent`` object per robot —
each in its own thread, process or host, with any transport
(``dpgo_tpu_torch.comms``, ROS, in-process calls) carrying the poses —
mirroring the reference's ``PGOAgent`` (``include/DPGO/PGOAgent.h:284-
486``, ``src/PGOAgent.cpp``):

=========================================  ====================================
reference (C++)                            here
=========================================  ====================================
``setPoseGraph``                           ``set_pose_graph``
``setLiftingMatrix``/``getLiftingMatrix``  ``set_lifting_matrix``/``get_lifting_matrix``
``getSharedPoseDict``                      ``get_shared_pose_dict``
``updateNeighborPoses``                    ``update_neighbor_poses``
``getAuxSharedPoseDict``                   ``get_aux_shared_pose_dict``
``updateAuxNeighborPoses``                 ``update_aux_neighbor_poses``
``getStatus``/``setNeighborStatus``        ``get_status``/``set_neighbor_status``
``shouldTerminate``                        ``should_terminate``
``setGlobalAnchor``                        ``set_global_anchor``
``getTrajectoryInLocalFrame``              ``trajectory_in_local_frame``
``getTrajectoryInGlobalFrame``             ``trajectory_in_global_frame``
``iterate``                                ``iterate``
``startOptimizationLoop``                  ``start_optimization_loop``
``endOptimizationLoop``                    ``end_optimization_loop``
``reset``                                  ``reset``
=========================================  ====================================

The compute inside ``iterate`` is the batched core's local step
(``models.rbcd._agent_update``) at A=1 on the robot's own operands
(``rbcd.agent_graph``): on a CUDA device in float32 with RTR it is one
launch of the fused RTR kernel B2 (``ops.rtr_kernel.rtr_full``), which
launches or raises — no iterate falls back to plain PyTorch on the card;
``pallas_tcg=True`` forces the kernel (its plain version on CPU tensors),
``pallas_tcg=False`` runs the "ell" formulation.  The block-Jacobi
preconditioner is factored once and again only when the weights change
(the JAX package refactors it every iterate: the same numbers).

Numerics: the robot's local chordal/odometry init and the lift run in
float64 on the agent's device; the iterate and the step then run in
``dtype`` (float32 on CUDA, float64 on the CPU by default).

Deployment fast path: neighbor poses live in a preallocated slot-indexed
``[S, r, d+1]`` host buffer updated by vectorized scatter
(``update_neighbor_poses_packed`` consumes the packed columnar wire
vocabulary directly) and uploaded (pinned, asynchronous) only after a
scatter landed; the lifted iterate ``X`` stays on the device across
iterates — each step writes a new tensor and the old one is dropped.  An
iterate reads back one scalar, the relative change (none on K-1 of every
K iterates at ``status_fetch_every=K``), and publishing gathers only the
public rows.  Every device->host read of this module goes through one
seam, ``_host_read`` (counted per kind in ``HOST_READS``).  The async
optimization loop (``start_optimization_loop``) is a host thread firing
``iterate`` at ``Exp(rate)``-distributed intervals — the RA-L 2020
Poisson-clock model of ``runOptimizationLoop`` (``PGOAgent.cpp:876-
898``) — with one lock serializing iterate against concurrent pose
updates (the reference's three mutexes, ``PGOAgent.h:589-597``).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import os
import threading
import time

import numpy as np
import torch

from . import obs
from . import robust as robust_mod
from .config import AgentParams, ROptAlg, RobustCostType
from .device import default_dtype, resolve_device
from .models import rbcd
from .models.dist_init import _se, _se_inv, robust_frame_alignment
from .models.local_pgo import lift, round_solution
from .obs import trace
from .ops import chordal, manifold, quadratic
from .types import Measurements, edge_set_from_measurements
from .utils import logger as logger_mod
from .utils.lie import lifting_matrix as make_lifting_matrix

PoseID = tuple[int, int]  # (robot_id, pose_index) — reference DPGO_types.h:64
PoseDict = dict  # PoseID -> np.ndarray [r, d+1]

#: Device->host reads through ``_host_read``, by kind: ``rel_change`` (an
#: iterate's scalar), ``publish`` (the public rows), ``anchor``, ``align``
#: (the received poses' rounding), ``init`` (the local init), ``weights``
#: (GNC residuals), ``X`` / ``aux`` (host mirrors), ``round`` and
#: ``cost`` (diagnostics).
HOST_READS: collections.Counter = collections.Counter()
_READS_LOCK = threading.Lock()


def _host_read(x, kind: str):
    """THE device->host seam of the deployment path: every read of this
    module is one call here (``rbcd._host_fetch``: a pinned copy and its
    event on a card), counted under ``kind``.  Returns CPU tensors."""
    with _READS_LOCK:
        HOST_READS[kind] += 1
    return rbcd._host_fetch(x)


class AgentState(enum.Enum):
    """Agent lifecycle (reference ``PGOAgentState``, ``PGOAgent.h:46-54``)."""

    WAIT_FOR_DATA = 0
    WAIT_FOR_INITIALIZATION = 1
    INITIALIZED = 2


@dataclasses.dataclass
class PGOAgentStatus:
    """Gossiped observability struct (reference ``PGOAgent.h:163-207``)."""

    robot_id: int
    state: AgentState = AgentState.WAIT_FOR_DATA
    instance_number: int = 0
    iteration_number: int = 0
    ready_to_terminate: bool = False
    relative_change: float = float("inf")


class PGOAgent:
    """One robot's PGO runtime on ``device``; the caller supplies the
    transport.  ``dtype`` defaults to float32 on CUDA, float64 on the CPU;
    asking for CUDA where there is none raises."""

    def __init__(self, robot_id: int, params: AgentParams, device="cuda",
                 dtype: torch.dtype | None = None):
        self.robot_id = int(robot_id)
        self.params = params
        self.d = params.d
        self.r = params.r
        self.num_robots = params.num_robots
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self._np_dtype = np.float32 if self.dtype == torch.float32 \
            else np.float64

        self._lock = threading.RLock()
        self._status = PGOAgentStatus(robot_id=self.robot_id)
        self._neighbor_status: dict[int, PGOAgentStatus] = {}

        self._ylift: np.ndarray | None = None
        if self.robot_id == 0:
            # Robot 0 generates the deterministic shared lifting matrix
            # (PGOAgent.cpp:46, fixedStiefelVariable DPGO_utils.cpp:502-507)
            # and its local frame is the global frame (PGOAgent.cpp:182-186).
            self.set_lifting_matrix(make_lifting_matrix(
                self.r, self.d, torch.float64, device="cpu").numpy())

        self._clear_problem()

        # Async loop (startOptimizationLoop, PGOAgent.cpp:861-916)
        self._loop_thread: threading.Thread | None = None
        self._end_loop = threading.Event()

    # -- problem ingestion --------------------------------------------------

    def _clear_problem(self):
        self.n = 0
        self._meas: Measurements | None = None
        self._edges = None                          # EdgeSet in self.dtype
        self._is_shared: np.ndarray | None = None   # [E] bool
        self._shared_other: np.ndarray | None = None  # [E] neighbor robot (or -1)
        self._is_lc: np.ndarray | None = None       # [E] bool (odometry = False)
        self._lc_upd: np.ndarray | None = None      # [E] LC & not known-inlier
        self._nbr_slot: dict[PoseID, int] = {}      # remote PoseID -> buffer slot
        self._slot_pose: list[PoseID] = []
        self._public: list[int] = []                # local public pose indices
        self._public_np = np.zeros(0, np.int64)
        self._public_dev = None                     # device copy of _public_np
        self.X = None                               # [n, r, d+1] lifted
        self._T_local: np.ndarray | None = None     # [n, d, d+1] own frame
        self._X_init = None
        self._weights: np.ndarray | None = None     # [E] float64, host
        self._weights_dev = None                    # device cache of weights
        self._chol = None                           # cached precond factors
        self._graph = None                          # rbcd.agent_graph view
        self._meta = None
        self._kernel = False                        # the step launches B2
        self._shared_key_to_edge: dict = {}         # ((r1,p1),(r2,p2)) -> row
        self._mu = self.params.robust.gnc_init_mu
        self._num_weight_updates = 0
        # Slot-indexed neighbor cache (the deployment fast path): one
        # preallocated [S, r, d+1] buffer per pose family, updated by
        # vectorized scatter, with a device copy re-uploaded only when a
        # neighbor update landed.
        self._nbr_vals = np.zeros((0, self.r, self.d + 1))
        self._nbr_have = np.zeros(0, bool)
        self._aux_vals = np.zeros((0, self.r, self.d + 1))
        self._aux_have = np.zeros(0, bool)
        self._nbr_ver = 0                # bumped on every regular scatter
        self._aux_ver = 0                # bumped on every aux scatter
        self._nbr_dev = None             # device mirror of _nbr_vals
        self._nbr_dev_ver = -1
        self._aux_dev = None             # merged aux-over-regular mirror
        self._aux_dev_ver = (-1, -1)
        self._slot_enc = np.zeros(0, np.int64)    # sorted (robot<<32)|pose
        self._slot_enc_order = np.zeros(0, np.int64)  # slot id per enc row
        # Transport bookkeeping (dpgo_tpu_torch.comms): last accepted
        # pose-frame sequence per neighbor, and neighbors declared dead by
        # the transport (excluded from the should_terminate quorum; their
        # cached poses above stay frozen — the RA-L delay-tolerance model).
        self._nbr_pose_seq: dict[int, int] = {}
        self._nbr_aux_seq: dict[int, int] = {}
        self._lost_neighbors: set[int] = set()
        # Numerical-health bookkeeping (obs.health): anomalies this robot
        # detected locally; the counters ride the outgoing bus frame
        # (``comms.bus.pack_agent_frame``).  Nonzero only with telemetry on.
        self._anom_count = 0
        self._anom_worst = 0  # 0 none / 1 warning / 2 critical
        self._global_anchor: np.ndarray | None = None
        # Nesterov sequences (PGOAgent.cpp:1054-1091), device tensors
        self._V = None
        self._Y = None
        self._gamma = 0.0
        self._alpha = 0.0
        self._status.state = AgentState.WAIT_FOR_DATA
        self._status.iteration_number = 0
        self._status.ready_to_terminate = False
        self._status.relative_change = float("inf")

    # -- device-resident iterate state --------------------------------------
    #
    # ``X`` stays on the device across iterates (each step's output feeds
    # the next step with no host round trip); host code that reads
    # ``self.X`` gets a lazily materialized numpy mirror.  Assigning a
    # tensor or a numpy array works — the other representation is dropped
    # and rebuilt on demand.

    @property
    def X(self):
        if self._X_host is None and self._X_dev is not None:
            self._X_host = _host_read(self._X_dev, "X").numpy().copy()
        return self._X_host

    @X.setter
    def X(self, value):
        if value is None:
            self._X_dev = None
            self._X_host = None
        elif isinstance(value, torch.Tensor):
            self._X_dev = value
            self._X_host = None
        else:
            self._X_host = np.asarray(value)
            self._X_dev = None

    def _upload(self, arr: np.ndarray):
        """A host array as a new device tensor in the agent's dtype.  On a
        card the copy is an asynchronous one from pinned memory (no host
        sync; the caching host allocator keeps the staging buffer until the
        copy ran)."""
        t = torch.tensor(np.asarray(arr), dtype=self.dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _X_device(self):
        """The lifted iterate as a device tensor (uploaded once, reused)."""
        if self._X_dev is None and self._X_host is not None:
            self._X_dev = self._upload(self._X_host)
        return self._X_dev

    def _weights_device(self):
        if self._weights_dev is None:
            self._weights_dev = self._upload(self._weights)
        return self._weights_dev

    def set_lifting_matrix(self, ylift: np.ndarray) -> None:
        """Install the shared lifting matrix (reference ``setLiftingMatrix``,
        broadcast from robot 0, ``MultiRobotExample.cpp:139-146``)."""
        ylift = np.asarray(ylift, np.float64)
        assert ylift.shape == (self.r, self.d), ylift.shape
        self._ylift = ylift

    def get_lifting_matrix(self) -> np.ndarray:
        assert self._ylift is not None, "lifting matrix not set"
        return self._ylift

    def _index_problem(self, all_meas: Measurements, n: int):
        """Buffer indices of every edge (own poses, then neighbor slots in
        first-reference order), public poses and shared-edge bookkeeping
        (under the lock); ``set_pose_graph`` and ``_extend_problem``."""
        me = self.robot_id
        E = len(all_meas)
        is_shared = np.zeros(E, bool)
        shared_other = np.full(E, -1, np.int64)
        ti = np.zeros(E, np.int64)
        hi = np.zeros(E, np.int64)
        pub: dict[int, None] = {}
        self._nbr_slot = {}
        self._slot_pose = []
        for k in range(E):
            a, p = int(all_meas.r1[k]), int(all_meas.p1[k])
            b, q = int(all_meas.r2[k]), int(all_meas.p2[k])
            if a == me and b == me:
                ti[k], hi[k] = p, q
                continue
            is_shared[k] = True
            if a == me:
                shared_other[k] = b
                pub.setdefault(p)
                ti[k] = p
                hi[k] = n + self._slot(b, q)
            else:
                shared_other[k] = a
                pub.setdefault(q)
                hi[k] = q
                ti[k] = n + self._slot(a, p)
        self._public = sorted(pub)
        self._public_np = np.asarray(self._public, np.int64)
        self._public_dev = torch.as_tensor(self._public_np,
                                           device=self.device)
        self._is_shared = is_shared
        self._shared_other = shared_other
        self._shared_key_to_edge = {
            ((int(all_meas.r1[k]), int(all_meas.p1[k])),
             (int(all_meas.r2[k]), int(all_meas.p2[k]))): k
            for k in np.nonzero(is_shared)[0]}
        return ti, hi

    def _build_slot_tables(self):
        """The sorted encoded-key table the vectorized scatter searches."""
        S = len(self._slot_pose)
        enc = np.fromiter(((r << 32) | p for (r, p) in self._slot_pose),
                          np.int64, S)
        order = np.argsort(enc, kind="stable")
        self._slot_enc = enc[order]
        self._slot_enc_order = order.astype(np.int64)

    def set_pose_graph(self, odometry: Measurements,
                       private_loop_closures: Measurements,
                       shared_loop_closures: Measurements) -> None:
        """Ingest this robot's measurements (reference ``setPoseGraph``,
        ``PGOAgent.cpp:126-195`` + ``addOdometry``/``add*LoopClosure``
        ``:197-248``) and run local initialization in the robot's own
        frame (float64, on the agent's device)."""
        with self._lock:
            if self._status.state != AgentState.WAIT_FOR_DATA:
                # Re-ingestion on a live agent rolls to a new problem
                # instance like reset(), so no stale state survives into
                # the new graph (the reference asserts, PGOAgent.cpp:128).
                instance = self._status.instance_number + 1
                self._clear_problem()
                self._status.instance_number = instance
                self._neighbor_status.clear()
            me = self.robot_id
            all_meas = Measurements.concatenate(
                [odometry, private_loop_closures, shared_loop_closures])
            n = 0
            for k in range(len(all_meas)):
                if int(all_meas.r1[k]) == me:
                    n = max(n, int(all_meas.p1[k]) + 1)
                if int(all_meas.r2[k]) == me:
                    n = max(n, int(all_meas.p2[k]) + 1)
            self.n = n
            self._meas = all_meas

            E = len(all_meas)
            ti, hi = self._index_problem(all_meas, n)
            S = len(self._slot_pose)
            self._nbr_vals = np.zeros((S, self.r, self.d + 1))
            self._nbr_have = np.zeros(S, bool)
            self._aux_vals = np.zeros((S, self.r, self.d + 1))
            self._aux_have = np.zeros(S, bool)
            self._build_slot_tables()

            is_lc = np.arange(E) >= len(odometry)
            self._edges = edge_set_from_measurements(
                all_meas, dtype=self.dtype, device=self.device,
                tail_index=ti, head_index=hi, is_lc=is_lc)
            self._is_lc = np.asarray(is_lc, bool)
            self._lc_upd = is_lc & ~np.asarray(all_meas.is_known_inlier,
                                                bool)
            self._weights = np.asarray(all_meas.weight, np.float64).copy()
            self._mu = self.params.robust.gnc_init_mu

            # Local init in own frame (localInitialization,
            # PGOAgent.cpp:947-962), float64 on the device.
            sub = all_meas.select(~self._is_shared)
            sub = dataclasses.replace(sub, num_poses=n,
                                      r1=np.zeros(len(sub), np.int32),
                                      r2=np.zeros(len(sub), np.int32))
            sub_edges = edge_set_from_measurements(
                sub, dtype=torch.float64, device=self.device)
            if self.params.robust.cost_type == RobustCostType.L2:
                T0 = chordal.chordal_initialization(sub_edges, n)
            else:
                T0 = chordal.odometry_from_edges(sub_edges, n)
            self._T_local = _host_read(T0, "init").numpy()

            if self.robot_id == 0:
                self._lift_and_initialize(self._T_local)
            else:
                self._status.state = AgentState.WAIT_FOR_INITIALIZATION
                self._obs_state_event()

    def _slot(self, robot: int, pose: int) -> int:
        key = (robot, pose)
        if key not in self._nbr_slot:
            self._nbr_slot[key] = len(self._slot_pose)
            self._slot_pose.append(key)
        return self._nbr_slot[key]

    def _lift_and_initialize(self, T_global_frame: np.ndarray) -> None:
        """X = YLift . T per pose (PGOAgent.cpp:183, 415), lifted in
        float64 on the device and cast to ``dtype``; enter INITIALIZED."""
        assert self._ylift is not None, "lifting matrix required before init"
        T = torch.as_tensor(np.asarray(T_global_frame, np.float64),
                            device=self.device)
        ylift = torch.as_tensor(self._ylift, device=self.device)
        X = lift(T, ylift).to(self.dtype)
        self.X = X
        self._X_init = X.clone()
        self._V = X.clone()
        self._Y = X.clone()
        self._gamma = 0.0
        self._alpha = 0.0
        self._status.state = AgentState.INITIALIZED
        self._obs_state_event()
        self._build_step()

    def _build_step(self):
        """The robot's A=1 operands (``rbcd.agent_graph``) and the choice
        of formulation (``rbcd._formulation``, the batched core's rule:
        RTR in float32 on CUDA runs kernel B2; ``pallas_tcg=True`` forces
        it and raises where it cannot run).  The dense-Q opt-in does not
        apply to a robot's step."""
        sp = self.params.solver
        s = max(len(self._slot_pose), 1)
        self._graph, self._meta = rbcd.agent_graph(self._edges, self.n, s,
                                                   self.r)
        form = rbcd._formulation(self._meta, self.params, self._graph,
                                 self.dtype, self.device,
                                 rtr=sp.algorithm == ROptAlg.RTR)
        self._kernel = form == "kernel"
        self._chol = None

    def _chol_device(self):
        """Block-Jacobi factors at the current weights, factored once and
        again only after the weights changed."""
        if self._chol is None and \
                self.params.solver.algorithm == ROptAlg.RTR:
            self._chol = rbcd.precond_chol(self._edges_weighted(),
                                           self._graph, self.params)
        return self._chol

    def _edges_weighted(self):
        """The robot's batched [1, E] edges with its live weights."""
        return self._graph.edges._replace(
            weight=self._weights_device()[None])

    def _step(self, X: torch.Tensor, z: torch.Tensor):
        """One local step at ``X [n, r, d+1]`` against neighbor buffer
        ``z [1, s, r, d+1]``: the new iterate and the relative change as a
        0-dim device tensor (no host read)."""
        X_new, _gn = rbcd._agent_update(
            X[None], z, self._edges_weighted(), self.params,
            self._chol_device(), self._graph, self._meta,
            kernel=self._kernel)
        X_new = X_new[0]
        rel = torch.sqrt(torch.sum((X_new - X) ** 2) / max(self.n, 1))
        return X_new, rel

    # -- observability hooks (obs; no-ops when telemetry is off) ------------

    def _obs_state_event(self) -> None:
        """Emit a lifecycle transition event (WAIT_FOR_DATA ->
        WAIT_FOR_INITIALIZATION -> INITIALIZED); zero work when no run is
        ambient."""
        run = obs.get_run()
        if run is None:
            return
        run.event("agent_state", phase="lifecycle", robot=self.robot_id,
                  state=self._status.state.name,
                  instance=self._status.instance_number,
                  iteration=self._status.iteration_number)

    def _obs_comms_bytes(self, direction: str, nbytes: int,
                         neighbor_id: int | None = None) -> None:
        """Account one pose message: messages + bytes, labeled by robot and
        (for receives) the peer (``MultiRobotExample.cpp:274-279``)."""
        run = obs.get_run()
        if run is None or not nbytes:
            return
        labels = {"robot": self.robot_id}
        if neighbor_id is not None:
            labels["neighbor"] = neighbor_id
        run.counter(f"comms_messages_{direction}",
                    f"pose messages {direction}").inc(1, **labels)
        run.counter(f"comms_bytes_{direction}",
                    f"pose payload bytes {direction}",
                    unit="bytes").inc(int(nbytes), **labels)

    def _obs_comms(self, direction: str, pose_dict: PoseDict,
                   neighbor_id: int | None = None) -> None:
        """Dict-vocabulary wrapper of ``_obs_comms_bytes`` (v1 callers)."""
        if obs.get_run() is None or not pose_dict:
            return
        nbytes = sum(np.asarray(b).nbytes for b in pose_dict.values())
        self._obs_comms_bytes(direction, nbytes, neighbor_id)

    # -- pose sharing (the message vocabulary) ------------------------------

    def get_shared_pose_dict(self) -> PoseDict:
        """Public poses of X (reference ``getSharedPoseDict``,
        ``PGOAgent.cpp:95-105``)."""
        with self._lock:
            if self.X is None:
                return {}
            out = {(self.robot_id, p): self.X[p].copy() for p in self._public}
        self._obs_comms("sent", out)
        return out

    def get_public_pose_arrays(self):
        """Packed publish fast path: ``(robot_ids, pose_ids, values)`` for
        this robot's public poses as three arrays (the columnar wire
        vocabulary), or None while uninitialized.  When X is on the device
        only the public rows are gathered and read (one ``publish`` read)."""
        with self._lock:
            if self._X_dev is None and self._X_host is None:
                return None
            idx = self._public_np
            if self._X_host is not None:
                vals = self._X_host[idx].copy()
            else:
                vals = _host_read(
                    self._X_dev.index_select(0, self._public_dev),
                    "publish").numpy()
        self._obs_comms_bytes("sent", vals.nbytes + 8 * len(idx))
        return (np.full(len(idx), self.robot_id, np.int32),
                idx.astype(np.int32), vals)

    def get_aux_shared_pose_dict(self) -> PoseDict:
        """Public poses of the Nesterov aux sequence Y
        (``getAuxSharedPoseDict``, ``PGOAgent.cpp:107-118``)."""
        with self._lock:
            if self._Y is None:
                return {}
            Y = _host_read(self._Y, "aux").numpy()
            out = {(self.robot_id, p): Y[p].copy() for p in self._public}
        self._obs_comms("sent", out)
        return out

    def _check_pose_seq(self, seq_cache: dict, neighbor_id: int,
                        sequence: int | None) -> bool:
        """Monotonic per-neighbor sequence check (under the lock): True
        when the message is fresh; a stale, reordered or duplicate frame
        must not roll the neighbor cache backwards."""
        if sequence is None:
            return True  # sequence-less transport (in-process calls)
        if sequence <= seq_cache.get(neighbor_id, -1):
            return False
        seq_cache[neighbor_id] = int(sequence)
        return True

    def _obs_anomaly(self, kind: str, severity: str, **fields) -> None:
        """Report one locally detected numerical anomaly through the run's
        health monitor and bump the counters riding this robot's outgoing
        bus frame.  Zero work when no run is ambient."""
        run = obs.get_run()
        if run is None:
            return
        from .obs.health import SEVERITIES, monitor_for

        monitor_for(run).anomaly(kind, severity, robot=self.robot_id,
                                 iteration=self._status.iteration_number,
                                 **fields)
        self._anom_count += 1
        self._anom_worst = max(self._anom_worst,
                               SEVERITIES.index(severity) + 1)

    def health_counters(self) -> tuple[int, int]:
        """``(anomaly_count, worst_severity)`` — worst is 0 none /
        1 warning / 2 critical.  The payload ``pack_agent_frame`` ships."""
        return self._anom_count, self._anom_worst

    def _obs_stale_dropped(self, neighbor_id: int) -> None:
        run = obs.get_run()
        if run is None:
            return
        run.counter("comms_stale_dropped",
                    "pose messages dropped as stale/reordered").inc(
            1, robot=self.robot_id, neighbor=neighbor_id)

    def _scatter_neighbor(self, robots: np.ndarray, poses: np.ndarray,
                          vals: np.ndarray, aux: bool = False) -> None:
        """Vectorized slot scatter (under the lock): binary-search the
        incoming ``(robot, pose)`` keys against the sorted encoded slot
        table, write the matching rows of the preallocated buffer in one
        fancy-index assignment, drop keys this agent never references."""
        if robots.size == 0 or self._slot_enc.size == 0:
            return
        enc = (robots.astype(np.int64) << 32) | poses.astype(np.int64)
        pos = np.searchsorted(self._slot_enc, enc)
        pos = np.minimum(pos, self._slot_enc.size - 1)
        ok = self._slot_enc[pos] == enc
        slots = self._slot_enc_order[pos[ok]]
        if slots.size == 0:
            return
        if aux:
            self._aux_vals[slots] = vals[ok]
            self._aux_have[slots] = True
            self._aux_ver += 1
        else:
            self._nbr_vals[slots] = vals[ok]
            self._nbr_have[slots] = True
            self._nbr_ver += 1

    @staticmethod
    def _pose_dict_arrays(pose_dict: PoseDict):
        keys = list(pose_dict)
        robots = np.fromiter((k[0] for k in keys), np.int64, len(keys))
        poses = np.fromiter((k[1] for k in keys), np.int64, len(keys))
        vals = np.stack([np.asarray(pose_dict[k], np.float64) for k in keys])
        return robots, poses, vals

    def update_neighbor_poses(self, neighbor_id: int, pose_dict: PoseDict,
                              sequence: int | None = None) -> None:
        """Receive a neighbor's public poses (``updateNeighborPoses``,
        ``PGOAgent.cpp:434-458``) in the v1 dict vocabulary.  ``sequence``
        is the transport's monotonic frame number for this neighbor: a
        stale or reordered frame is dropped and counted; a fresh frame
        from a neighbor declared lost revives it."""
        if pose_dict:
            robots, poses, vals = self._pose_dict_arrays(pose_dict)
        else:
            robots = poses = np.zeros(0, np.int64)
            vals = np.zeros((0, self.r, self.d + 1))
        self.update_neighbor_poses_packed(neighbor_id, robots, poses, vals,
                                          sequence=sequence)

    def _invalidate_neighbor_cache(self, neighbor_id: int) -> None:
        """Drop every cached pose (regular + aux) received from
        ``neighbor_id`` (under the lock); the iterate skips optimization
        until fresh frames refill its slots."""
        slots = np.asarray([s for (r, _p), s in self._nbr_slot.items()
                            if r == neighbor_id], np.int64)
        if slots.size:
            self._nbr_have[slots] = False
            self._aux_have[slots] = False
            self._nbr_ver += 1
            self._aux_ver += 1

    def update_neighbor_poses_packed(self, neighbor_id: int,
                                     robots: np.ndarray, poses: np.ndarray,
                                     vals: np.ndarray,
                                     sequence: int | None = None) -> None:
        """The columnar receive fast path: index vectors + one contiguous
        value payload feed the vectorized buffer scatter directly.  The
        first message from an INITIALIZED neighbor triggers robust frame
        alignment (``PGOAgent.cpp:369-432``).  A frame from a neighbor
        declared lost revives it with a sequence reset and its pre-outage
        cached poses invalidated."""
        revived = False
        with self._lock:
            if neighbor_id in self._lost_neighbors:
                revived = True
                stale = False
                self._nbr_pose_seq.pop(neighbor_id, None)
                self._nbr_aux_seq.pop(neighbor_id, None)
                self._invalidate_neighbor_cache(neighbor_id)
                self._lost_neighbors.discard(neighbor_id)
                if sequence is not None:
                    self._nbr_pose_seq[neighbor_id] = int(sequence)
            elif not self._check_pose_seq(self._nbr_pose_seq, neighbor_id,
                                          sequence):
                stale = True
            else:
                stale = False
        if stale:
            self._obs_stale_dropped(neighbor_id)
            return
        if revived:
            run = obs.get_run()
            if run is not None:
                run.event("peer_revived", phase="comms",
                          robot=self.robot_id, peer=neighbor_id,
                          iteration=self._status.iteration_number)
        robots, poses = np.asarray(robots), np.asarray(poses)
        vals = np.asarray(vals, np.float64)
        self._obs_comms_bytes("received", vals.nbytes + 8 * robots.size,
                              neighbor_id)
        # NaN sentinel on the ingested frame (telemetry on only); the frame
        # is still applied, so the math is the same with telemetry off.
        if obs.get_run() is not None and vals.size \
                and not np.isfinite(vals).all():
            self._obs_anomaly("non_finite_neighbor_frame", "critical",
                              neighbor=int(neighbor_id),
                              poses=int(vals.shape[0]))
        with self._lock:
            self._scatter_neighbor(robots, poses, vals)
            if (self._status.state == AgentState.WAIT_FOR_INITIALIZATION
                    and self._neighbor_is_initialized(neighbor_id)):
                self._try_initialize_in_global_frame(neighbor_id)

    def update_aux_neighbor_poses(self, neighbor_id: int, pose_dict: PoseDict,
                                  sequence: int | None = None) -> None:
        """(``updateAuxNeighborPoses``, ``PGOAgent.cpp:460-479``)."""
        if pose_dict:
            robots, poses, vals = self._pose_dict_arrays(pose_dict)
        else:
            robots = poses = np.zeros(0, np.int64)
            vals = np.zeros((0, self.r, self.d + 1))
        self.update_aux_neighbor_poses_packed(neighbor_id, robots, poses,
                                              vals, sequence=sequence)

    def update_aux_neighbor_poses_packed(self, neighbor_id: int,
                                         robots: np.ndarray,
                                         poses: np.ndarray,
                                         vals: np.ndarray,
                                         sequence: int | None = None) -> None:
        with self._lock:
            stale = not self._check_pose_seq(self._nbr_aux_seq, neighbor_id,
                                             sequence)
        if stale:
            self._obs_stale_dropped(neighbor_id)
            return
        robots, poses = np.asarray(robots), np.asarray(poses)
        vals = np.asarray(vals, np.float64)
        self._obs_comms_bytes("received", vals.nbytes + 8 * robots.size,
                              neighbor_id)
        with self._lock:
            self._scatter_neighbor(robots, poses, vals, aux=True)

    # -- dict-compat views of the slot-indexed neighbor cache ---------------

    def _nbr_lookup(self, key: PoseID, aux: bool = False) -> np.ndarray | None:
        """One cached neighbor block by ``(robot, pose)`` key (under the
        lock), or None when it has not been received."""
        slot = self._nbr_slot.get(key)
        if slot is None:
            return None
        if aux:
            if not self._aux_have[slot]:
                return None
            return self._aux_vals[slot]
        if not self._nbr_have[slot]:
            return None
        return self._nbr_vals[slot]

    @property
    def _neighbor_poses(self) -> dict:
        """Received regular neighbor poses as a dict (diagnostics/tests)."""
        return {key: self._nbr_vals[slot]
                for key, slot in self._nbr_slot.items()
                if self._nbr_have[slot]}

    def _neighbor_is_initialized(self, neighbor_id: int) -> bool:
        st = self._neighbor_status.get(neighbor_id)
        if st is not None:
            return st.state == AgentState.INITIALIZED
        if self._neighbor_status:
            # The transport gossips statuses: a neighbor whose status has
            # not arrived cannot be assumed initialized (PGOAgent.cpp:434-
            # 458 gates on the gossiped mState).
            return False
        # Status-less transport: receiving poses implies the sender is
        # initialized (the reference transport only publishes after init).
        return True

    def _try_initialize_in_global_frame(self, neighbor_id: int) -> None:
        """Robust frame alignment against ``neighbor_id``
        (``initializeInGlobalFrame`` + two-stage GNC averaging,
        ``PGOAgent.cpp:250-331``, ``369-432``).  Abort-and-retry on an
        empty inlier set (``:396-400``).  The received poses are rounded
        on the device in one batch (one ``align`` read)."""
        if self._meas is None or self._ylift is None:
            # The lifting matrix has not arrived yet; the next pose message
            # retries (same contract as the empty-inlier abort).
            return
        me, d = self.robot_id, self.d
        m = self._meas
        rows = []
        for k in np.nonzero(self._shared_other == neighbor_id)[0]:
            a, p = int(m.r1[k]), int(m.p1[k])
            b, q = int(m.r2[k]), int(m.p2[k])
            dT = _se(np.asarray(m.R[k]), np.asarray(m.t[k]), d)
            if a == me:  # outgoing me -> neighbor; frame1 = my p
                blk = self._nbr_lookup((b, q))
                if blk is None:
                    continue
                rows.append((blk, dT, p))
            else:        # incoming neighbor -> me; frame1 = my q
                blk = self._nbr_lookup((a, p))
                if blk is None:
                    continue
                rows.append((blk, _se_inv(dT, d), q))
        if not rows:
            return
        # Round the neighbor's lifted public poses to SE(d) via YLift^T
        # (computeNeighborTransform, PGOAgent.cpp:250-288).
        blocks = torch.as_tensor(np.stack([r[0] for r in rows]),
                                 dtype=torch.float64, device=self.device)
        Tn_all = _host_read(round_solution(
            blocks, torch.as_tensor(self._ylift, device=self.device)),
            "align").numpy()
        Rs, ts = [], []
        for (_blk, T_f1_f2, p_mine), Tn in zip(rows, Tn_all):
            T_w2_f2 = _se(Tn[:, :d], Tn[:, d], d)
            T_w1_f1 = _se(self._T_local[p_mine, :, :d],
                          self._T_local[p_mine, :, d], d)
            T = T_w2_f2 @ _se_inv(T_f1_f2, d) @ _se_inv(T_w1_f1, d)
            Rs.append(T[:d, :d])
            ts.append(T[:d, d])
        R, t, ninl = robust_frame_alignment(np.stack(Rs), np.stack(ts),
                                            device=self.device)
        if ninl == 0:
            return  # abort; retry on the next message (PGOAgent.cpp:396-400)
        Rl = self._T_local[:, :, :d]
        tl = self._T_local[:, :, d]
        T_global = np.zeros_like(self._T_local)
        T_global[:, :, :d] = np.einsum("ab,nbc->nac", R, Rl)
        T_global[:, :, d] = tl @ R.T + t
        self._lift_and_initialize(T_global)

    # -- status gossip ------------------------------------------------------

    def get_status(self) -> PGOAgentStatus:
        with self._lock:
            return dataclasses.replace(self._status)

    def set_neighbor_status(self, status: PGOAgentStatus) -> None:
        """(``setNeighborStatus``, ``PGOAgent.h:383-388``)."""
        with self._lock:
            self._neighbor_status[status.robot_id] = dataclasses.replace(status)

    def mark_neighbor_lost(self, neighbor_id: int) -> None:
        """The transport declared ``neighbor_id`` dead.  Its cached poses
        stay frozen (the RA-L 2020 delay tolerance) and it no longer blocks
        the ``should_terminate`` quorum; a fresh pose message revives it
        with a sequence reset and its stale cache invalidated."""
        neighbor_id = int(neighbor_id)
        if neighbor_id == self.robot_id:
            return
        with self._lock:
            if neighbor_id in self._lost_neighbors:
                return
            self._lost_neighbors.add(neighbor_id)
        run = obs.get_run()
        if run is not None:
            run.event("peer_lost", phase="comms", robot=self.robot_id,
                      peer=neighbor_id,
                      iteration=self._status.iteration_number)

    @property
    def lost_neighbors(self) -> list[int]:
        with self._lock:
            return sorted(self._lost_neighbors)

    def admit_neighbor(self, neighbor_id: int,
                       shared_loop_closures: "Measurements | None" = None
                       ) -> int:
        """The inverse of ``mark_neighbor_lost``: a robot JOINED the live
        solve.  Clears any lost/sequence state for it and its cached poses,
        grows the termination quorum when its id exceeds the known fleet
        size, and — with ``shared_loop_closures`` (robot-local indexing) —
        extends the live problem in place (``_extend_problem``).  Returns
        the number of edges added; this agent's ``ready_to_terminate``
        resets."""
        neighbor_id = int(neighbor_id)
        if neighbor_id == self.robot_id:
            return 0
        with self._lock:
            self._lost_neighbors.discard(neighbor_id)
            self._nbr_pose_seq.pop(neighbor_id, None)
            self._nbr_aux_seq.pop(neighbor_id, None)
            self._invalidate_neighbor_cache(neighbor_id)
            if neighbor_id >= self.num_robots:
                self.num_robots = neighbor_id + 1
            added = 0
            if shared_loop_closures is not None \
                    and len(shared_loop_closures):
                added = self._extend_problem(shared_loop_closures)
            self._status.ready_to_terminate = False
        run = obs.get_run()
        if run is not None:
            run.event("peer_joined", phase="comms", robot=self.robot_id,
                      peer=neighbor_id, edges_added=added,
                      num_robots=self.num_robots,
                      iteration=self._status.iteration_number)
        return added

    def _extend_problem(self, new_meas: "Measurements") -> int:
        """Append measurements to the live problem (under the lock): the
        same deterministic index build as ``set_pose_graph`` over the
        concatenated edge list, so the prefix slots keep their ids and the
        neighbor buffers carry over by prefix copy.  The iterate, the GNC
        weights of existing edges and mu are untouched; the step's operands
        are rebuilt for the grown shapes."""
        me = self.robot_id
        if self._meas is None:
            raise RuntimeError("admit_neighbor with measurements requires "
                               "set_pose_graph first")
        mine = (np.asarray(new_meas.r1) == me) | \
            (np.asarray(new_meas.r2) == me)
        sub = new_meas.select(mine) if not mine.all() else new_meas
        if len(sub) == 0:
            return 0
        own1 = np.asarray(sub.r1) == me
        own2 = np.asarray(sub.r2) == me
        if (np.asarray(sub.p1)[own1] >= self.n).any() or \
                (np.asarray(sub.p2)[own2] >= self.n).any():
            raise ValueError(
                "admitted measurements reference own poses this agent "
                "does not have — the joiner cannot add poses to a "
                "survivor's trajectory")
        all_meas = Measurements.concatenate([self._meas, sub])
        is_lc = np.concatenate([self._is_lc, np.ones(len(sub), bool)])

        old_S = len(self._slot_pose)
        old_nbr_vals, old_nbr_have = self._nbr_vals, self._nbr_have
        old_aux_vals, old_aux_have = self._aux_vals, self._aux_have
        ti, hi = self._index_problem(all_meas, self.n)
        assert len(self._slot_pose) >= old_S and all(
            self._nbr_slot[key] == s
            for s, key in enumerate(self._slot_pose[:old_S])), \
            "prefix slot assignment must be stable across an extension"
        S = len(self._slot_pose)
        self._nbr_vals = np.zeros((S, self.r, self.d + 1))
        self._nbr_have = np.zeros(S, bool)
        self._aux_vals = np.zeros((S, self.r, self.d + 1))
        self._aux_have = np.zeros(S, bool)
        self._nbr_vals[:old_S] = old_nbr_vals
        self._nbr_have[:old_S] = old_nbr_have
        self._aux_vals[:old_S] = old_aux_vals
        self._aux_have[:old_S] = old_aux_have
        self._build_slot_tables()
        self._nbr_ver += 1
        self._aux_ver += 1
        self._meas = all_meas
        self._is_lc = np.asarray(is_lc, bool)
        self._edges = edge_set_from_measurements(
            all_meas, dtype=self.dtype, device=self.device, tail_index=ti,
            head_index=hi, is_lc=is_lc)
        self._lc_upd = is_lc & ~np.asarray(all_meas.is_known_inlier, bool)
        # Existing edges keep their live (possibly GNC-updated) weights;
        # new edges start at their measurement weight.
        self._weights = np.concatenate(
            [self._weights, np.asarray(sub.weight, np.float64)])
        self._weights_dev = None
        self._chol = None
        if self._status.state == AgentState.INITIALIZED:
            self._build_step()
        return len(sub)

    def should_terminate(self) -> bool:
        """Team consensus (``shouldTerminate``, ``PGOAgent.cpp:1007-1031``):
        every robot INITIALIZED on this instance and ready to terminate;
        robots declared lost are excluded from the quorum."""
        with self._lock:
            me = self._status
            if (me.state != AgentState.INITIALIZED
                    or not me.ready_to_terminate):
                return False
            for rid in range(self.num_robots):
                if rid == self.robot_id or rid in self._lost_neighbors:
                    continue
                st = self._neighbor_status.get(rid)
                if (st is None or st.state != AgentState.INITIALIZED
                        or st.instance_number != me.instance_number
                        or not st.ready_to_terminate):
                    return False
            return True

    # -- anchors & trajectories --------------------------------------------

    def set_global_anchor(self, anchor: np.ndarray) -> None:
        """Shared gauge for rounding (``setGlobalAnchor``,
        ``PGOAgent.cpp:1001-1005``): robot 0's first pose block of X."""
        with self._lock:
            anchor = np.asarray(anchor, np.float64)
            assert anchor.shape == (self.r, self.d + 1)
            self._global_anchor = anchor

    def get_global_anchor(self) -> np.ndarray | None:
        """Robot 0's first pose block (one ``anchor`` read of that row when
        X is on the device), or the anchor set on this robot."""
        with self._lock:
            if self.robot_id == 0:
                if self._X_host is not None:
                    return self._X_host[0].copy()
                if self._X_dev is not None:
                    return _host_read(self._X_dev[:1],
                                      "anchor").numpy()[0].copy()
            return self._global_anchor

    def _round(self, X) -> np.ndarray:
        """Rounded trajectory of a lifted array (host or device), rounded
        in float64 on the agent's device."""
        assert X is not None, "agent not initialized"
        Xt = X if isinstance(X, torch.Tensor) else \
            torch.tensor(np.asarray(X), dtype=torch.float64)
        Xt = Xt.to(device=self.device, dtype=torch.float64)
        return _host_read(round_solution(
            Xt, torch.as_tensor(self._ylift, device=self.device)),
            "round").numpy()

    def trajectory_in_local_frame(self) -> np.ndarray:
        """Rounded trajectory relative to this robot's first pose
        (``getTrajectoryInLocalFrame``, ``PGOAgent.cpp:481-498``)."""
        with self._lock:
            T = self._round(self._X_device())
            return _express_in_frame(T, T[0])

    def trajectory_in_global_frame(self) -> np.ndarray:
        """Rounded trajectory in the anchor's frame
        (``getTrajectoryInGlobalFrame``, ``PGOAgent.cpp:500-519``)."""
        with self._lock:
            assert self._X_device() is not None, "agent not initialized"
            anchor = self.get_global_anchor()
            assert anchor is not None, "global anchor not set"
            Ta = self._round(np.asarray(anchor)[None])[0]
            return _express_in_frame(self._round(self._X_device()), Ta)

    # -- fine-grained pose getters (PGOAgent.h:312-364) ---------------------

    def get_neighbors(self) -> list[int]:
        """Sorted neighbor robot IDs (``getNeighbors``,
        ``PGOAgent.cpp:577-581``)."""
        with self._lock:
            return sorted({r for (r, _p) in self._nbr_slot})

    def get_neighbor_public_poses(self, neighbor_id: int) -> list[int]:
        """Pose indices needed from ``neighbor_id``
        (``getNeighborPublicPoses``, ``PGOAgent.cpp:564-575``)."""
        with self._lock:
            return sorted(p for (r, p) in self._nbr_slot if r == neighbor_id)

    def get_shared_pose(self, index: int) -> np.ndarray | None:
        """Single pose block of X by local index, or None when the agent is
        uninitialized / the index is out of range (``getSharedPose``,
        ``PGOAgent.cpp:76-83``)."""
        with self._lock:
            if self._status.state != AgentState.INITIALIZED \
                    or not 0 <= index < self.n:
                return None
            return self.X[index].copy()

    def get_aux_shared_pose(self, index: int) -> np.ndarray | None:
        """Single pose block of the Nesterov aux sequence Y
        (``getAuxSharedPose``, ``PGOAgent.cpp:85-93``)."""
        assert self.params.acceleration, \
            "aux poses exist only with acceleration enabled"
        with self._lock:
            if self._status.state != AgentState.INITIALIZED \
                    or self._Y is None or not 0 <= index < self.n:
                return None
            return _host_read(self._Y[index], "aux").numpy().copy()

    def _to_global_frame(self, Xi: np.ndarray) -> np.ndarray | None:
        """Anchor-frame [d, d+1] of one lifted block: ``Ya^T Xi`` with the
        anchor translation subtracted (``getPoseInGlobalFrame``,
        ``PGOAgent.cpp:521-538``), without an SO(d) projection."""
        anchor = self.get_global_anchor()
        if anchor is None:
            return None
        d = self.d
        Ya, pa = anchor[:, :d], anchor[:, d]
        Ti = Ya.T @ Xi
        Ti[:, d] -= Ya.T @ pa
        return Ti

    def get_pose_in_global_frame(self, pose_id: int) -> np.ndarray | None:
        """One of this robot's poses in the global (anchor) frame, or None
        when the anchor/initialization/index is missing
        (``getPoseInGlobalFrame``, ``PGOAgent.cpp:521-538``)."""
        with self._lock:
            if self._status.state != AgentState.INITIALIZED \
                    or not 0 <= pose_id < self.n:
                return None
            return self._to_global_frame(self.X[pose_id])

    def get_neighbor_pose_in_global_frame(self, neighbor_id: int,
                                          pose_id: int) -> np.ndarray | None:
        """A cached neighbor public pose in the global frame, or None when
        it has not been received (``getNeighborPoseInGlobalFrame``,
        ``PGOAgent.cpp:540-562``)."""
        with self._lock:
            if self._status.state != AgentState.INITIALIZED:
                return None
            Xi = self._nbr_lookup((neighbor_id, pose_id))
            if Xi is None:
                return None
            return self._to_global_frame(Xi.copy())

    # -- GNC weights --------------------------------------------------------

    def _update_loop_closure_weights(self) -> bool:
        """Recompute robust weights from current residuals
        (``updateLoopClosuresWeights``, ``PGOAgent.cpp:1181-1245``).

        Ownership (``:1201-1206``): for a shared edge, the LOWER robot id
        computes the weight; the other endpoint receives it via
        ``get_shared_weight_dict``/``update_shared_weights``.  Returns
        False (without consuming the weight-update budget or annealing mu)
        when neighbor poses are missing."""
        z = self._neighbor_buffer()
        if z is None:
            return False
        res = _host_read(rbcd._edge_residuals(
            self._X_device()[None], z, self._edges_weighted())[0],
            "weights")
        w_new = robust_mod.weight(res, self.params.robust, self._mu).numpy()
        own = (~self._is_shared) | (self._shared_other > self.robot_id)
        upd = self._lc_upd & own
        self._weights = np.where(upd, w_new, self._weights)
        self._weights_dev = None  # device copy re-uploads next step
        self._chol = None         # and the factors follow the weights
        self._mu = float(robust_mod.gnc_update_mu(
            torch.tensor(self._mu, dtype=torch.float64), self.params.robust))
        run = obs.get_run()
        if run is not None:
            # ``w_new`` is already a host array (the residual read above).
            w_lc = self._weights[self._lc_upd]
            inl = float((w_lc > 0.5).mean()) if w_lc.size else 1.0
            run.gauge("gnc_mu", "GNC control parameter").set(
                self._mu, robot=self.robot_id)
            run.gauge("gnc_inlier_fraction",
                      "fraction of updatable LC edges at w>0.5").set(
                inl, robot=self.robot_id)
            run.histogram(
                "gnc_weight", "GNC weight distribution over updatable "
                "loop closures",
                buckets=(0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0),
            ).observe_many(w_lc, robot=self.robot_id)
            run.metric("gnc_mu", self._mu, phase="weight_update",
                       robot=self.robot_id,
                       iteration=self._status.iteration_number,
                       inlier_fraction=inl, num_lc=int(w_lc.size))
        if not self.params.robust_opt_warm_start and self._X_init is not None:
            self.X = self._X_init.clone()  # PGOAgent.cpp:657-662
        # initializeAcceleration after a weight update (PGOAgent.cpp:1054-1063)
        if self.params.acceleration:
            self._V = self._X_device().clone()
            self._gamma = 0.0
            self._alpha = 0.0
        return True

    def get_shared_weight_dict(self) -> dict:
        """Weights of owned shared edges, keyed ((r1,p1),(r2,p2)); empty
        before ``set_pose_graph``."""
        with self._lock:
            if self._is_shared is None:
                return {}
            out = {}
            m = self._meas
            for k in np.nonzero(self._is_shared &
                                (self._shared_other > self.robot_id))[0]:
                key = ((int(m.r1[k]), int(m.p1[k])),
                       (int(m.r2[k]), int(m.p2[k])))
                out[key] = float(self._weights[k])
            return out

    def update_shared_weights(self, weight_dict: dict) -> None:
        """Receive weights for shared edges owned by a lower-id robot."""
        with self._lock:
            m = self._meas
            changed = False
            for key, w in weight_dict.items():
                k = self._shared_key_to_edge.get(key)
                if k is not None and not bool(m.is_known_inlier[k]):
                    self._weights[k] = float(w)
                    changed = True
            if changed:
                self._weights_dev = None
                self._chol = None

    # -- the RBCD step ------------------------------------------------------

    def _neighbor_buffer(self, aux: bool = False):
        """The slot-indexed neighbor buffer as a ``[1, s, r, d+1]`` device
        tensor (one zero slot when the robot has no neighbor poses); None
        when any needed pose is missing (constructGMatrix failure -> skip
        update, ``PGOAgent.cpp:1122-1128``).  Uploaded only when a scatter
        landed since the last call."""
        if self._nbr_vals.shape[0] == 0:
            if self._nbr_dev is None:
                self._nbr_dev = torch.zeros(
                    (1, 1, self.r, self.d + 1), dtype=self.dtype,
                    device=self.device)
            return self._nbr_dev
        if aux:
            # Aux poses fall back to regular ones for neighbors that have
            # not published Y yet (first accelerated round).
            if not (self._aux_have | self._nbr_have).all():
                return None
            ver = (self._aux_ver, self._nbr_ver)
            if self._aux_dev is None or self._aux_dev_ver != ver:
                z = np.where(self._aux_have[:, None, None],
                             self._aux_vals, self._nbr_vals)
                self._aux_dev = self._upload(z[None])
                self._aux_dev_ver = ver
            return self._aux_dev
        if not self._nbr_have.all():
            return None
        if self._nbr_dev is None or self._nbr_dev_ver != self._nbr_ver:
            self._nbr_dev = self._upload(self._nbr_vals[None])
            self._nbr_dev_ver = self._nbr_ver
        return self._nbr_dev

    def iterate(self, do_optimization: bool = True) -> bool:
        """One RBCD iteration (reference ``iterate``, ``PGOAgent.cpp:642-
        718``).  Returns True when an optimization step was taken.  With
        acceleration, non-optimizing iterations still advance the momentum
        bookkeeping (X <- Y), as ``updateX(false, true)`` does
        (``PGOAgent.cpp:1094-1098``)."""
        run = obs.get_run()
        # monotonic (not perf_counter) so the iterate span shares the
        # event stream's clock and lands on the merged fleet timeline.
        t0 = time.monotonic() if run is not None else 0.0
        t0_wall = time.time() if run is not None else 0.0
        with self._lock:
            if self._status.state != AgentState.INITIALIZED:
                return False
            params = self.params
            self._status.iteration_number += 1
            # Early-stop trajectory snapshot at iteration 50
            # (reference iterate(), PGOAgent.cpp:646-651).
            if self._status.iteration_number == 50 and params.log_data:
                self._log_global_trajectory("trajectory_early_stop.csv")
            robust_on = params.robust.cost_type != RobustCostType.L2
            if robust_on and \
                    self._status.iteration_number % params.robust_opt_inner_iters == 0 and \
                    (params.robust_opt_num_weight_updates <= 0 or
                     self._num_weight_updates < params.robust_opt_num_weight_updates):
                if self._update_loop_closure_weights():
                    self._num_weight_updates += 1

            accel = params.acceleration
            restart = accel and params.restart_interval > 0 and \
                self._status.iteration_number % params.restart_interval == 0

            if accel and restart:
                # restartNesterovAcceleration (PGOAgent.cpp:1040-1052)
                X = self._X_device()
                self._V = X.clone()
                self._Y = X.clone()
                self._gamma = 0.0
                self._alpha = 0.0
                accel = False

            stepped = False
            if accel:
                # Accelerated path: the momentum bookkeeping runs on the
                # device too; the relative change is read every iterate.
                X_prev = self._X_device()
                N = self.num_robots
                self._gamma = (1.0 + np.sqrt(1.0 + 4.0 * (N * self._gamma) ** 2)) \
                    / (2.0 * N)
                self._alpha = 1.0 / (self._gamma * N)
                Y = manifold.project(
                    (1.0 - self._alpha) * X_prev + self._alpha * self._V)
                self._Y = Y
                z = self._neighbor_buffer(aux=True)
                if do_optimization and z is not None \
                        and self._graph is not None:
                    X_new, _rel = self._step(Y, z)
                    stepped = True
                else:
                    X_new = Y.clone()  # updateX(false, true)
                self.X = X_new
                self._V = manifold.project(
                    self._V + self._gamma * (X_new - Y))
                rel = float(_host_read(torch.sqrt(
                    torch.sum((X_new - X_prev) ** 2) / max(self.n, 1)),
                    "rel_change"))
            else:
                # Deployment fast path: X stays on the device, the neighbor
                # buffer re-uploads only after a scatter, and the host reads
                # back ONE scalar (the relative change), not X.
                z = self._neighbor_buffer()
                rel = 0.0
                if do_optimization and z is not None \
                        and self._graph is not None:
                    X_new, rel_dev = self._step(self._X_device(), z)
                    self.X = X_new
                    stepped = True
                    fetch_k = max(int(params.status_fetch_every), 1)
                    if run is not None or fetch_k == 1 or \
                            self._status.iteration_number % fetch_k == 0:
                        rel = float(_host_read(rel_dev, "rel_change"))
                    else:
                        # Verdict-cadence discipline (status_fetch_every):
                        # the scalar stays on the device; the gossiped
                        # status reuses the last fetched value, so this
                        # iterate reads nothing back.
                        rel = self._status.relative_change
            self._status.relative_change = rel
            ready = stepped and rel <= params.rel_change_tol
            if robust_on and params.robust.cost_type == RobustCostType.GNC_TLS:
                lc = self._lc_upd
                if lc.any():
                    conv = robust_mod.is_weight_converged(
                        torch.as_tensor(self._weights[lc])).numpy()
                    ready = ready and conv.mean() >= \
                        params.robust_opt_min_convergence_ratio
            self._status.ready_to_terminate = bool(ready)
            if run is not None:
                # The scalar read above materialized the step — the latency
                # includes the device work, with no telemetry-added sync.
                dt = time.monotonic() - t0
                run.histogram(
                    "agent_iterate_seconds",
                    "PGOAgent.iterate wall-clock (lock + step + readback)",
                    unit="s").observe(dt, robot=self.robot_id)
                run.counter("agent_iterations",
                            "iterate() calls that took an optimization "
                            "step").inc(int(stepped), robot=self.robot_id)
                run.gauge("agent_rel_change",
                          "per-agent iterate relative change").set(
                    rel, robot=self.robot_id)
                run.event("agent_iterate", phase="iterate",
                          robot=self.robot_id,
                          iteration=self._status.iteration_number,
                          stepped=stepped, rel_change=rel,
                          ready=bool(ready), latency_s=dt)
                if stepped and not np.isfinite(rel):
                    # The one scalar this path reads back went non-finite.
                    self._obs_anomaly("non_finite_rel_change", "critical",
                                      rel_change=rel)
                trace.emit_span(run, "iterate", t0, t0_wall, dt,
                                phase="compute", robot=self.robot_id,
                                iteration=self._status.iteration_number,
                                stepped=stepped, rel_change=rel)
            return stepped

    # -- async runtime ------------------------------------------------------

    def start_optimization_loop(self, rate_hz: float = 10.0,
                                seed: int | None = None) -> None:
        """Spawn the Poisson-clock optimization thread
        (``startOptimizationLoop``, ``PGOAgent.cpp:861-898``): sleep
        ``Exp(rate)`` then ``iterate(True)`` until stopped, drawing from
        ``np.random.default_rng(robot_id)`` (or ``seed``).  Acceleration
        is rejected in async mode as in the reference (``:863``).  On a
        card the thread launches on its current stream, the default one."""
        if self.params.acceleration:
            raise ValueError("acceleration is not supported in async mode")
        if self._loop_thread is not None and self._loop_thread.is_alive():
            return
        self._end_loop.clear()
        rng = np.random.default_rng(self.robot_id if seed is None else seed)

        def run():
            while not self._end_loop.is_set():
                self._end_loop.wait(float(rng.exponential(1.0 / rate_hz)))
                if self._end_loop.is_set():
                    break
                self.iterate(True)

        self._loop_thread = threading.Thread(
            target=run, name=f"pgo-agent-{self.robot_id}", daemon=True)
        self._loop_thread.start()

    def end_optimization_loop(self) -> None:
        """Stop and join (``endOptimizationLoop``, ``PGOAgent.cpp:900-916``);
        an iterate in flight finishes first."""
        if self._loop_thread is None:
            return
        self._end_loop.set()
        self._loop_thread.join()
        self._loop_thread = None

    def is_optimization_running(self) -> bool:
        return self._loop_thread is not None and self._loop_thread.is_alive()

    # -- lifecycle ----------------------------------------------------------

    def reset(self) -> None:
        """Roll to the next problem instance keeping the lifting matrix
        (``reset``, ``PGOAgent.cpp:583-640``), dumping the solve's data first
        when logging is enabled (``:587-603``)."""
        # Join the loop thread BEFORE taking the lock: the thread's iterate()
        # needs the lock, so joining under it would deadlock.
        self.end_optimization_loop()
        with self._lock:
            if self.params.log_data:
                self._log_measurements("measurements.csv")
                self._log_global_trajectory("trajectory_optimized.csv")
                self._log_x("X.txt")
            instance = self._status.instance_number + 1
            self._clear_problem()
            self._status.instance_number = instance
            self._neighbor_status.clear()
            self._obs_state_event()

    def log_trajectory(self) -> None:
        """Mid-run dump with per-robot file names (reference
        ``log_trajectory``, ``PGOAgent.cpp:1301-1319``): measurements incl.
        current GNC weights, the rounded global-frame trajectory as
        ``robot+{id}+trajectory_optimized.csv``, and the raw lifted iterate
        as ``{id}_X.txt``."""
        with self._lock:
            if not self.params.log_data:
                return
            self._log_measurements("measurements.csv")
            self._log_global_trajectory(
                f"robot+{self.robot_id}+trajectory_optimized.csv")
            self._log_x(f"{self.robot_id}_X.txt")

    # -- data logging (reference PGOLogger wiring) --------------------------

    def _log_path(self, name: str) -> str:
        """Per-robot dump location ``log_directory/robot{id}/`` (many
        agents may share one ``AgentParams``; the per-robot subdirectory
        keeps the reference's file names collision-free)."""
        directory = os.path.join(self.params.log_directory or ".",
                                 f"robot{self.robot_id}")
        os.makedirs(directory, exist_ok=True)
        return os.path.join(directory, name)

    def _log_measurements(self, name: str) -> None:
        """All of this robot's measurements with their live GNC weights
        (reference reset()/log_trajectory(), PGOAgent.cpp:587-593)."""
        if self._meas is None:
            return
        meas = dataclasses.replace(
            self._meas, weight=np.asarray(self._weights, np.float64).copy())
        logger_mod.log_measurements(meas, self._log_path(name))

    def _log_global_trajectory(self, name: str) -> None:
        """Rounded global-frame trajectory; skipped (like the reference's
        ``if getTrajectoryInGlobalFrame(T)``) when the agent is not
        initialized or no anchor is known yet."""
        if self._X_device() is None or self.get_global_anchor() is None:
            return
        logger_mod.log_trajectory(self.trajectory_in_global_frame(),
                                  self._log_path(name))

    def _log_x(self, name: str) -> None:
        """Raw lifted iterate before rounding (``writeMatrixToFile(X, ...)``,
        PGOAgent.cpp:602; layout [r, (d+1)n] like the reference's X)."""
        if self.X is None:
            return
        X2d = np.asarray(self.X).transpose(1, 0, 2).reshape(self.r, -1)
        logger_mod.save_matrix(X2d, self._log_path(name))

    # -- diagnostics --------------------------------------------------------

    def local_cost(self) -> float | None:
        """f(X) against cached neighbor poses (None while any are missing)."""
        with self._lock:
            z = self._neighbor_buffer()
            if z is None or self._X_device() is None:
                return None
            buf = torch.cat([self._X_device(), z[0]], dim=0)
            return float(_host_read(quadratic.cost(
                buf, self._edges._replace(weight=self._weights_device())),
                "cost"))


def _express_in_frame(T: np.ndarray, T_frame: np.ndarray) -> np.ndarray:
    """Apply ``T_frame^-1`` to every pose of ``T`` ([n, d, d+1])."""
    d = T.shape[1]
    R0, t0 = T_frame[:, :d], T_frame[:, d]
    R = np.einsum("ba,nbc->nac", R0, T[:, :, :d])
    t = np.einsum("ba,nb->na", R0, T[:, :, d] - t0)
    return np.concatenate([R, t[:, :, None]], axis=-1)

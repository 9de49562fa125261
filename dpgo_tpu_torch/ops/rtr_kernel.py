"""The fused local RTR step of RBCD: the hand-written CUDA kernel
(``csrc/rtr_full.cu``) and its plain PyTorch version.

Port of the TPU kernels ``dpgo_tpu/ops/pallas_tcg.py``:

* ``rtr_full`` replaces ``_rtr_full_kernel`` / ``rtr_full_call`` — one
  launch solves every agent's local problem for one RBCD round (start-point
  gradient, truncated CG, retraction, cost and the accept/shrink loop);
* ``tcg`` replaces ``_tcg_kernel`` / ``tcg_call`` — the truncated CG alone.

Each wrapper runs the kernel for CUDA tensors and raises when it cannot; it
takes its plain version (``rtr_full_reference`` / ``tcg_reference``) only
when the tensors it was given lie on the CPU.  The kernel is compiled with
``nvcc`` for ``sm_90a`` at first use, from the source in this package, into
``dpgo_tpu_torch/_build/``, and bound through ``ctypes``.

Inputs use the JAX package's tile-major layout (``models.rbcd.build_graph``),
batched over agents with a leading ``A``:

* ``idx_i, idx_j [A, nt, 1, T]`` int32 endpoint indices into the
  ``[n + s]`` pose buffer (``n + s`` = padding), ``rot [A, nt, d*d, T]``,
  ``trn [A, nt, d, T]``, ``wk, wt [A, nt, 1, T]`` (weighted kappa / tau);
  the first ``e_max`` positions hold the agent's edge rows;
* poses component-major: ``Xc [A, r(d+1), n]``, ``Zc [A, r(d+1), s]``;
* ``Lc [A, (d+1)^2, n]`` the block-Jacobi Cholesky factors;
* ``inc_slot, inc_mask [A, n, K]`` the ELL incidence into ``[gi | gj]``;
* ``n_local [A]`` int32: the agent's own pose count; padded poses past it
  are returned unchanged.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from ..types import EdgeSet
from . import manifold, quadratic
from .smallmat import polar_orthonormalize
from .solver import _sel, truncated_cg

#: Launches of the ``rtr_full`` kernel (not of its plain version).
LAUNCHES = 0
#: Launches of the ``tcg`` kernel.
TCG_LAUNCHES = 0

#: Newton-Schulz sweeps of the retraction (fixed in the kernel source).
NS_SWEEPS = 24
#: The launchers' own error code (others are ``cudaError_t`` values).
_UNSUPPORTED_SHAPE = -1

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rtr_full.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class RTRFullOut(NamedTuple):
    X: torch.Tensor          # [A, r(d+1), n] updated poses
    stats: torch.Tensor      # [A, 5] attempts, accepted, f0, f, gn0
    tcg_iters: torch.Tensor  # [A] int32 tCG iterations over all attempts


class TCGOut(NamedTuple):
    eta: torch.Tensor    # [A, r(d+1), n]
    heta: torch.Tensor   # [A, r(d+1), n]
    stats: torch.Tensor  # [A, 2] iterations, hit boundary


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def comp_major(X: torch.Tensor) -> torch.Tensor:
    """[..., n, r, k] pose blocks -> [..., r*k, n] component-major."""
    n, r, k = X.shape[-3:]
    return X.movedim(-3, -1).reshape(X.shape[:-3] + (r * k, n)).contiguous()


def comp_minor(Xc: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """[..., r*k, n] -> [..., n, r, k]."""
    n = Xc.shape[-1]
    return Xc.reshape(Xc.shape[:-2] + (r, k, n)).movedim(-1, -3)


def edge_tiles(w: torch.Tensor, nt: int, tile: int) -> torch.Tensor:
    """Pad per-edge rows [..., E] to the tile-major [..., nt, 1, T]."""
    E = w.shape[-1]
    wp = torch.nn.functional.pad(w, (0, nt * tile - E))
    return wp.reshape(w.shape[:-1] + (nt, 1, tile)).contiguous()


def _untile(t: torch.Tensor, e_max: int) -> torch.Tensor:
    """[A, nt, c, T] tiles -> [A, e_max, c] edge rows."""
    A, nt, c, T = t.shape
    return t.permute(0, 1, 3, 2).reshape(A, nt * T, c)[:, :e_max]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

class _Local(NamedTuple):
    edges: EdgeSet
    inc_slot: torch.Tensor
    inc_mask: torch.Tensor
    chol: torch.Tensor  # [A, n, k, k]
    n: int
    n_buf: int


def _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask, *,
           d: int, e_max: int, n: int, s: int, dtype) -> _Local:
    """The kernel's inputs as an edge list over the buffer
    ``[local (n) | neighbors (s) | one zero row]``: indices past the
    neighbor slots (padding, or every non-local index when ``s = 0``) land
    on the zero row and so contribute nothing, as in the kernel."""
    A = idx_i.shape[0]
    k = d + 1
    edges = EdgeSet(
        i=_untile(idx_i, e_max)[..., 0].long().clamp(max=n + s),
        j=_untile(idx_j, e_max)[..., 0].long().clamp(max=n + s),
        R=_untile(rot, e_max).reshape(A, e_max, d, d).to(dtype),
        t=_untile(trn, e_max).to(dtype),
        kappa=_untile(wk, e_max)[..., 0].to(dtype),
        tau=_untile(wt, e_max)[..., 0].to(dtype),
        weight=torch.ones((A, e_max), dtype=dtype, device=idx_i.device),
        mask=torch.ones((A, e_max), dtype=dtype, device=idx_i.device),
        is_lc=torch.zeros((A, e_max), dtype=dtype, device=idx_i.device),
        fixed_weight=torch.zeros((A, e_max), dtype=dtype,
                                 device=idx_i.device))
    chol = Lc.to(dtype).reshape(A, k, k, n).permute(0, 3, 1, 2)
    return _Local(edges, inc_slot.long(), inc_mask.to(dtype), chol, n,
                  n + s + 1)


def _buffer(V: torch.Tensor, Z: torch.Tensor | None, n_buf: int):
    parts = [V] if Z is None else [V, Z]
    used = sum(p.shape[-3] for p in parts)
    parts.append(torch.zeros(V.shape[:-3] + (n_buf - used,) + V.shape[-2:],
                             dtype=V.dtype, device=V.device))
    return torch.cat(parts, dim=-3)


def _rhess(loc: _Local, X, S, V):
    """P_X(EucHess[V] - [V_Y S | 0]) with neighbors held constant."""
    Hd = quadratic.egrad_ell(_buffer(V, None, loc.n_buf), loc.edges,
                             loc.inc_slot, loc.inc_mask)
    corr = manifold.join(V[..., :-1] @ S, torch.zeros_like(V[..., -1]))
    return manifold.tangent_project(X, Hd - corr)


def _precond(loc: _Local, X, V):
    return manifold.tangent_project(X, quadratic.precond_apply(loc.chol, V))


def tcg_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Sc, Lc, gc, radius,
                  inc_slot, inc_mask, *, r: int, d: int, e_max: int,
                  max_iters: int, kappa: float, theta: float) -> TCGOut:
    """Plain version of ``tcg``: Steihaug-Toint truncated CG at ``Xc`` from
    the curvature term ``Sc [A, d*d, n]`` and gradient ``gc``, per agent
    radius ``radius [A]``; computes in ``Xc.dtype``."""
    dtype = Xc.dtype
    k = d + 1
    A, _, n = Xc.shape
    loc = _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                 d=d, e_max=e_max, n=n, s=0, dtype=dtype)
    X = comp_minor(Xc, r, k)
    S = Sc.to(dtype).reshape(A, d, d, n).permute(0, 3, 1, 2)
    g = comp_minor(gc.to(dtype), r, k)
    res = truncated_cg(X, g, lambda V: _rhess(loc, X, S, V),
                       lambda V: _precond(loc, X, V), radius.to(dtype),
                       max_iters, kappa, theta)
    stats = torch.stack([res.iters.to(dtype), res.hit_boundary.to(dtype)],
                        dim=-1)
    return TCGOut(comp_major(res.eta), comp_major(res.heta), stats)


def rtr_full_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Lc, inc_slot,
                       inc_mask, n_local, *, r: int, d: int, e_max: int,
                       max_iters: int, kappa: float, theta: float,
                       initial_radius: float, max_rejections: int,
                       grad_tol: float) -> RTRFullOut:
    """Plain version of ``rtr_full``, computing in ``Xc.dtype``: the same
    gradient, tCG, 24-sweep Newton-Schulz retraction and accept/shrink loop,
    batched over agents (each agent's loops stop on their own)."""
    dtype = Xc.dtype
    k = d + 1
    A, _, n = Xc.shape
    s = Zc.shape[-1]
    loc = _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                 d=d, e_max=e_max, n=n, s=s, dtype=dtype)
    X = comp_minor(Xc, r, k)
    Z = comp_minor(Zc.to(dtype), r, k)

    def cost(V):
        return quadratic.cost(_buffer(V, Z, loc.n_buf), loc.edges)

    G = quadratic.egrad_ell(_buffer(X, Z, loc.n_buf), loc.edges,
                            loc.inc_slot, loc.inc_mask)
    Y = X[..., :-1]
    S = manifold.sym(Y.transpose(-1, -2) @ G[..., :-1])
    g = manifold.tangent_project(X, G)
    gn0 = manifold.norm(g)
    f0 = cost(X)
    live = (torch.arange(n, device=X.device)[None, :]
            < n_local.to(X.device)[:, None])

    k_att = torch.where(gn0 < grad_tol, float(max_rejections), 0.0)
    radius = torch.full_like(gn0, initial_radius)
    X_best, f_best = X, f0
    accepted = torch.zeros(A, dtype=torch.bool, device=X.device)
    iters = torch.zeros(A, dtype=torch.int32, device=X.device)
    while True:
        active = (k_att < max_rejections) & ~accepted
        if not bool(active.any()):
            break
        res = truncated_cg(X, g, lambda V: _rhess(loc, X, S, V),
                           lambda V: _precond(loc, X, V), radius, max_iters,
                           kappa, theta)
        M = X[..., :-1] + res.eta[..., :-1]
        X_prop = manifold.join(polar_orthonormalize(M, NS_SWEEPS),
                               X[..., -1] + res.eta[..., -1])
        X_prop = _sel(live, X_prop, X)
        f_prop = cost(X_prop)
        mdec = -(manifold.inner(g, res.eta)
                 + 0.5 * manifold.inner(res.eta, res.heta))
        rho = (f0 - f_prop) / torch.clamp(mdec, min=1e-30)
        ok = (rho > 0.1) & (f_prop <= f0) & active
        X_best = _sel(ok, X_prop, X_best)
        f_best = torch.where(ok, f_prop, f_best)
        radius = torch.where(active & ~ok, radius / 4.0, radius)
        k_att = torch.where(active, k_att + 1.0, k_att)
        iters = torch.where(active, iters + res.iters, iters)
        accepted = accepted | ok
    stats = torch.stack([k_att.to(dtype), accepted.to(dtype), f0, f_best,
                         gn0], dim=-1)
    return RTRFullOut(comp_major(X_best), stats, iters)


# ---------------------------------------------------------------------------
# The kernel: build, bind, launch
# ---------------------------------------------------------------------------

_lib = None
BUILD_LOG = ""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if nvcc is None and (toolkit / "bin" / "nvcc").exists():
        nvcc = str(toolkit / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the rtr_full kernel is built "
                           "from csrc/rtr_full.cu at first use")
    return nvcc


def build() -> Path:
    """Compile ``csrc/rtr_full.cu`` (if this source has not been built yet)
    and return the shared library's path.  Sets ``BUILD_LOG`` to nvcc's
    output (ptxas register and spill report)."""
    global BUILD_LOG
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"librtr_full_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n"
                           f"{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def load():
    """The bound kernel library; raises when there is no CUDA device or the
    build fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the rtr_full kernel needs a CUDA device and "
                           "none is available")
    lib = ctypes.CDLL(str(build()))
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.dpgo_rtr_workspace_floats.argtypes = [I, I, I, I]
    lib.dpgo_rtr_workspace_floats.restype = LL
    lib.dpgo_rtr_full_launch.argtypes = (
        [I] * 9 + [P] * 16 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_full_launch.restype = I
    lib.dpgo_tcg_launch.argtypes = (
        [I] * 8 + [P] * 18 + [LL, I, F, F, P])
    lib.dpgo_tcg_launch.restype = I
    _lib = lib
    return lib


def _check(name: str, dev, tensors: dict, shapes: dict) -> None:
    """Device, dtype, shape and contiguity checks shared by both wrappers;
    the kernel's launcher checks the shape (r, d) itself."""
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{dev} like the poses")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = shapes[key]
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    for key in ("idx_i", "idx_j", "inc_slot", "n_local"):
        if key in tensors and tensors[key].dtype != torch.int32:
            raise ValueError(f"{name}: {key} must be int32")
    if dev.type != "cpu":
        for key, t in tensors.items():
            if t.is_floating_point() and t.dtype != torch.float32:
                raise ValueError(f"{name}: the kernel is float32-only; "
                                 f"{key} is {t.dtype}")
        if dev.type != "cuda":
            raise RuntimeError(f"{name}: tensors on {dev}; the kernel runs "
                               "on CUDA devices and the plain version on "
                               "the CPU")


def _raise_on(name: str, err: int, r: int, d: int) -> None:
    """Turn a launcher's non-zero return into an exception."""
    if err == _UNSUPPORTED_SHAPE:
        raise ValueError(f"{name}: (r, d) = {(r, d)} is not a shape the "
                         "kernel is instantiated for (DPGO_DISPATCH in "
                         f"{SOURCE.name})")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError_t "
                           f"{err})")


def _shapes(idx_i, r, d, n, s, K, A):
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    rk, k = r * (d + 1), d + 1
    return dict(idx_i=(A, nt, 1, T), idx_j=(A, nt, 1, T),
                rot=(A, nt, d * d, T), trn=(A, nt, d, T),
                wk=(A, nt, 1, T), wt=(A, nt, 1, T),
                Xc=(A, rk, n), Zc=(A, rk, s), Lc=(A, k * k, n),
                Sc=(A, d * d, n), gc=(A, rk, n), radius=(A,),
                inc_slot=(A, n, K), inc_mask=(A, n, K), n_local=(A,))


def rtr_full(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Lc, inc_slot, inc_mask,
             n_local, *, r: int, d: int, e_max: int, max_iters: int,
             kappa: float, theta: float, initial_radius: float,
             max_rejections: int, grad_tol: float) -> RTRFullOut:
    """One local RTR step for every agent (see the module docstring for the
    layouts).  CUDA tensors launch the kernel on the current stream, once
    for all agents; CPU tensors run ``rtr_full_reference``."""
    global LAUNCHES
    A, _, n = Xc.shape
    s, K = Zc.shape[-1], inc_slot.shape[-1]
    tensors = dict(idx_i=idx_i, idx_j=idx_j, rot=rot, trn=trn, wk=wk, wt=wt,
                   Xc=Xc, Zc=Zc, Lc=Lc, inc_slot=inc_slot,
                   inc_mask=inc_mask, n_local=n_local)
    _check("rtr_full", Xc.device, tensors, _shapes(idx_i, r, d, n, s, K, A))
    kw = dict(r=r, d=d, e_max=e_max, max_iters=max_iters, kappa=kappa,
              theta=theta, initial_radius=initial_radius,
              max_rejections=max_rejections, grad_tol=grad_tol)
    if Xc.device.type == "cpu":
        return rtr_full_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Lc,
                                  inc_slot, inc_mask, n_local, **kw)
    lib = load()
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    dev = Xc.device
    ws_floats = lib.dpgo_rtr_workspace_floats(r, d, n, e_max)
    ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
    X_out = torch.empty_like(Xc)
    stats = torch.empty((A, 5), dtype=torch.float32, device=dev)
    iters = torch.empty((A,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dpgo_rtr_full_launch(
        r, d, A, n, s, nt * T, T, e_max, K,
        *(t.data_ptr() for t in (idx_i, idx_j, rot, trn, wk, wt, Xc, Zc,
                                 Lc, inc_slot, inc_mask, n_local, X_out,
                                 stats, iters, ws)),
        ws_floats, max_iters, kappa, theta, initial_radius, max_rejections,
        grad_tol, stream)
    _raise_on("rtr_full", err, r, d)
    LAUNCHES += 1
    return RTRFullOut(X_out, stats, iters)


def tcg(idx_i, idx_j, rot, trn, wk, wt, Xc, Sc, Lc, gc, radius, inc_slot,
        inc_mask, *, r: int, d: int, e_max: int, max_iters: int,
        kappa: float, theta: float) -> TCGOut:
    """Truncated CG for every agent from ``Sc`` and ``gc`` at per-agent
    ``radius [A]``.  CUDA tensors launch the kernel; CPU tensors run
    ``tcg_reference``."""
    global TCG_LAUNCHES
    A, _, n = Xc.shape
    K = inc_slot.shape[-1]
    tensors = dict(idx_i=idx_i, idx_j=idx_j, rot=rot, trn=trn, wk=wk, wt=wt,
                   Xc=Xc, Sc=Sc, Lc=Lc, gc=gc, radius=radius,
                   inc_slot=inc_slot, inc_mask=inc_mask)
    _check("tcg", Xc.device, tensors, _shapes(idx_i, r, d, n, 0, K, A))
    kw = dict(r=r, d=d, e_max=e_max, max_iters=max_iters, kappa=kappa,
              theta=theta)
    if Xc.device.type == "cpu":
        return tcg_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Sc, Lc, gc,
                             radius, inc_slot, inc_mask, **kw)
    lib = load()
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    dev = Xc.device
    ws_floats = lib.dpgo_rtr_workspace_floats(r, d, n, e_max)
    ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
    n_local = torch.full((A,), n, dtype=torch.int32, device=dev)
    eta = torch.empty_like(Xc)
    heta = torch.empty_like(Xc)
    stats = torch.empty((A, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dpgo_tcg_launch(
        r, d, A, n, nt * T, T, e_max, K,
        *(t.data_ptr() for t in (idx_i, idx_j, rot, trn, wk, wt, Xc, Sc,
                                 Lc, gc, radius, inc_slot, inc_mask, n_local,
                                 eta, heta, stats, ws)),
        ws_floats, max_iters, kappa, theta, stream)
    _raise_on("tcg", err, r, d)
    TCG_LAUNCHES += 1
    return TCGOut(eta, heta, stats)

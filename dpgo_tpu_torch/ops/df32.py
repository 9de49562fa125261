"""Double-float32 ("df32") arithmetic: float64-grade scalars from float32
operations — the PyTorch port of ``dpgo_tpu.ops.df32``.

A value is the unevaluated sum ``hi + lo`` of two float32 tensors of one
shape (``DF``), ~49 mantissa bits.  The on-device recenter
(``models.refine_fused``) computes its projection, gradient constants and
reference cost in it, so the terminal refinement's float64-grade work
stays on the card.  ``hi`` and ``lo`` are float32 whatever the default
dtype: a float64 part would make the arithmetic exact by accident.

The primitives are the classical error-free transforms:

* ``two_sum`` (Knuth): a + b = s + e exactly, 6 flops, no branches;
* ``two_prod`` by Dekker's split (2^12 + 1 for the 24-bit mantissa):
  a * b = p + e exactly, provided ``a * b - p`` is neither re-associated
  nor contracted into a fused multiply-add.

The JAX package hides the transforms' expressions from XLA's simplifier
(``_opaque``) and compiles them at optimization level 0 on the CPU
(``precise_jit``), because compilers re-associate or contract them.  Eager
PyTorch needs neither: each ``+``, ``-`` and ``*`` below is its own
operation, rounded to float32 before the next one reads it.  So this
module is built from those operations only — never ``torch.addcmul``,
``lerp``, ``baddbmm``, a matmul or ``torch.compile``, any of which may
fuse a product and a sum and zero the error term on the card.
Reductions fold pairwise (``fold_sum``): O(log n) vectorized df-adds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class DF(NamedTuple):
    """A double-f32 value: the unevaluated exact sum ``hi + lo`` with
    ``|lo| <= ulp(hi)/2`` (after renormalization); both float32."""

    hi: torch.Tensor
    lo: torch.Tensor


_SPLIT = 4097.0  # 2^12 + 1: Dekker's split constant for float32


def two_sum(a, b):
    """Error-free sum: returns (s, e) with a + b == s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: returns (p, e) with a * b == p + e exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# Construction / destruction
# ---------------------------------------------------------------------------

def from_f32(x) -> DF:
    """A float32 value (tensor, on its device) with a zero low part."""
    x = torch.as_tensor(x).to(torch.float32)
    return DF(x, torch.zeros_like(x))


def from_f64(x64, device="cuda") -> DF:
    """Host-side split of a float64 array into an exact df32 pair on
    ``device`` (|x| < ~1e31, so the low part keeps its significance)."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    dev = resolve_device(device)
    return DF(torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev))


def to_f64(x: DF) -> np.ndarray:
    """Host-side exact reconstruction (verification paths)."""
    return (x.hi.detach().cpu().numpy().astype(np.float64)
            + x.lo.detach().cpu().numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# Arithmetic (elementwise, broadcasting)
# ---------------------------------------------------------------------------

def add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DF(*quick_two_sum(s, e))


def add_f(x: DF, y) -> DF:
    s, e = two_sum(x.hi, y)
    e = e + x.lo
    return DF(*quick_two_sum(s, e))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*quick_two_sum(p, e))


def mul_f(x: DF, y) -> DF:
    p, e = two_prod(x.hi, y)
    e = e + x.lo * y
    return DF(*quick_two_sum(p, e))


def scale(x: DF, c: float) -> DF:
    """Multiply by an exactly representable float32 scalar (0.5, -1, 2)."""
    return DF(x.hi * c, x.lo * c)


def div(x: DF, y: DF) -> DF:
    """Quotient by one Newton correction of the float32 estimate (relative
    error ~2^-45)."""
    q1 = x.hi / y.hi
    r = add(x, neg(mul_f(y, q1)))  # x - y*q1, exact to df32
    q2 = r.hi / y.hi
    return DF(*quick_two_sum(q1, q2))


def sqrt(x: DF) -> DF:
    """Square root by one Newton correction of the float32 estimate.  The
    estimate is the correctly rounded float32 root, taken through float64
    (exact for a square root, as 53 >= 2 * 24 + 2 bits), since PyTorch's
    vectorized float32 root on the CPU can be an ulp off."""
    s1 = torch.sqrt(x.hi.double()).float()
    p, e = two_prod(s1, s1)  # s1^2 exactly, as a df pair
    r = add(x, DF(-p, -e))
    s2 = r.hi / (2.0 * s1)
    return DF(*quick_two_sum(s1, s2))


# ---------------------------------------------------------------------------
# Reductions / contractions
# ---------------------------------------------------------------------------

def fold_sum(x: DF, axis: int = -1) -> DF:
    """Pairwise (tree) df32 sum along ``axis``: O(log n) sequential
    vectorized df-adds; error ~ eps_df * log2(n) * sum |terms|."""
    hi = torch.movedim(x.hi, axis, -1)
    lo = torch.movedim(x.lo, axis, -1)
    n = hi.shape[-1]
    m = 1 << max(0, (n - 1)).bit_length()  # next power of two
    if m != n:
        hi = torch.nn.functional.pad(hi, (0, m - n))
        lo = torch.nn.functional.pad(lo, (0, m - n))
    cur = DF(hi, lo)
    while cur.hi.shape[-1] > 1:
        half = cur.hi.shape[-1] // 2
        cur = add(DF(cur.hi[..., :half], cur.lo[..., :half]),
                  DF(cur.hi[..., half:], cur.lo[..., half:]))
    return DF(cur.hi[..., 0], cur.lo[..., 0])


def dot(x: DF, y: DF, axis: int = -1) -> DF:
    """df32 inner product along ``axis`` (pairwise-folded)."""
    return fold_sum(mul(x, y), axis=axis)


def matmul_small(x: DF, y: DF) -> DF:
    """Batched ``[..., m, k] @ [..., k, n]`` with the contraction unrolled
    over the small static k (pose-graph dims d, d+1, r): elementwise df32
    operations, never a matmul (whose float32 is not exact)."""
    k = x.hi.shape[-1]
    assert y.hi.shape[-2] == k
    acc = None
    for t in range(k):
        term = mul(DF(x.hi[..., :, t, None], x.lo[..., :, t, None]),
                   DF(y.hi[..., None, t, :], y.lo[..., None, t, :]))
        acc = term if acc is None else add(acc, term)
    return acc


def transpose(x: DF, axes=None) -> DF:
    """``x`` with its axes permuted (reversed when ``axes`` is None)."""
    if axes is None:
        axes = tuple(reversed(range(x.hi.dim())))
    return DF(x.hi.permute(*axes), x.lo.permute(*axes))


def index(x: DF, idx) -> DF:
    """Exact gather (indexing applies to both components)."""
    return DF(x.hi[idx], x.lo[idx])


def sym(x: DF) -> DF:
    """0.5 * (M + M^T) on the last two axes (exact halving in float32)."""
    xt = DF(x.hi.transpose(-1, -2), x.lo.transpose(-1, -2))
    return scale(add(x, xt), 0.5)

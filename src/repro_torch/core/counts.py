"""Multiplication-count models (paper eqs. 3-5) + an empirical op census.

The paper's analytic claims:
    CGR_M(n) = (2n^3 + 3n^2 - 5n) / 2            (eq. 3)
    GR_M(n)  = (4n^3 - 4n) / 3                   (eq. 4)
    alpha(n) = CGR_M/GR_M = 3(2n+5) / (8(n+1))   (eq. 5)  -> 3/4 as n -> inf

The models are integer arithmetic, identical to the JAX package's.

``count_mults`` is the empirical side.  PyTorch runs eagerly, so there is no
program to walk: the census runs ``fn`` under a ``TorchDispatchMode`` and
counts the scalar multiplications of the aten ops that actually execute,
with the JAX package's convention:

* elementwise ``mul`` / ``div`` (their in-place and ``out=`` forms, and
  ``addcmul``) count their output's elements, as does ``pow`` with exponent 2;
* ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``mv`` / ``addmv`` / ``dot``
  count batch x free x free x contract (the output's elements times the
  contracted length);
* ``aten.linalg_vector_norm`` counts the elements of its input.  JAX lowers
  ``jnp.linalg.norm`` to ``mul`` + reduce, which the reference counts; in
  PyTorch the norm is one opaque op, so it is counted as the squares it
  takes, which keeps the two packages' censuses comparable;
* ops known to take no multiplications (adds, reductions, scans, copies,
  views, comparisons, selects) count nothing.

Loops run for real here, so trip counts are exact.  ``MultCount.exact``
turns False when an op ran whose multiplications the census cannot know:
an op outside the tables above (which includes the ``linalg_*`` solvers and
any custom op) or a launch of one of the port's hand-written CUDA kernels,
which run outside the dispatcher (their launch counters are read before and
after ``fn``).  ``torch.utils.flop_counter`` is no substitute: it counts
matrix products only, and a GGR sweep is all elementwise work.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.backend import dtype_name

__all__ = [
    "cgr_mults",
    "gr_mults",
    "alpha_ratio",
    "ggr_sweep_mults",
    "ggr_append_mults",
    "mults_to_flops",
    "flops_by_dtype",
    "householder_qr2_mults",
    "count_mults",
    "MultCount",
]


def cgr_mults(n: int) -> int:
    return (2 * n**3 + 3 * n**2 - 5 * n) // 2


def gr_mults(n: int) -> int:
    return (4 * n**3 - 4 * n) // 3


def alpha_ratio(n: int) -> float:
    return 3.0 * (2 * n + 5) / (8.0 * (n + 1))


def householder_qr2_mults(m: int, n: int) -> int:
    """~2mn^2 - 2n^3/3 flops; mults ~ half of FMA flops + rank-1 products."""
    return int(m * n**2 - n**3 / 3 + m * n)


def ggr_sweep_mults(m: int, w: int, n_pivots: int | None = None) -> int:
    """Rectangular generalization of eq. 3: mults of one dense GGR sweep.

    One sweep annihilates columns ``0..n_pivots-1`` below their diagonals on
    an (m, w) matrix (trailing ``w - n_pivots`` columns — rhs data — ride
    along).  The square model CGR_M(n) decomposes exactly as ``sum over
    column steps c of 3·(j·j - 1)`` with ``j = n - c``; a rectangular step
    has ``m - c`` active rows and ``w - c`` active columns, so the per-step
    cost is ``3·((m-c)(w-c) - 1)`` and ``ggr_sweep_mults(n, n, n) ==
    cgr_mults(n)``.
    """
    if n_pivots is None:
        n_pivots = min(m, w)
    steps = max(0, min(n_pivots, m - 1, w))
    return sum(3 * ((m - c) * (w - c) - 1) for c in range(steps))


def ggr_append_mults(n: int, p: int, w: int) -> int:
    """Mults of one compact active-set row-append sweep: upper-triangular
    (n, n) R with p appended rows, total width w (>= n; rhs columns ride
    along).  Column step c touches the pivot row plus the p appended rows
    over the remaining ``w - c`` columns: ``3·((p+1)(w-c) - 1)``."""
    steps = max(0, min(n, w))
    return sum(3 * ((p + 1) * (w - c) - 1) for c in range(steps))


def mults_to_flops(mults: int) -> int:
    """Model mults -> flops: each counted multiplication pairs with one
    add/subtract in the DOTk/DET2 macro-op grids (FMA-shaped throughout)."""
    return 2 * int(mults)


def flops_by_dtype(mults: int, compute_dtype="float32",
                   accum_dtype=None) -> dict[str, int]:
    """Split the FMA-shaped flop census by the dtype each half executes in.

    Each counted multiplication runs at the tile's *compute* dtype while its
    paired add lands in the *accumulator* dtype (``kernels.Precision``), so a
    bf16-tile dispatch is m bf16 flops plus m f32 flops.  Returns
    ``{dtype_name: flops}`` keyed by canonical names (``"float32"``) whose
    values sum to ``mults_to_flops(mults)``; uniform policies collapse to
    one entry.  ``mults`` may be a :class:`MultCount`.
    """
    cd = dtype_name(compute_dtype)
    ad = cd if accum_dtype is None else dtype_name(accum_dtype)
    m = int(mults)
    out = {cd: m}
    out[ad] = out.get(ad, 0) + m
    return out


class MultCount(int):
    """An ``int`` mult count carrying an ``exact`` flag.

    ``exact=False`` means an op ran whose multiplications the census cannot
    know (see the module docstring), so the value is a lower bound.
    Arithmetic behaves like a plain int; the flag does not survive
    arithmetic, only the direct result of ``count_mults`` carries it.
    """

    exact: bool = True

    def __new__(cls, value: int, exact: bool = True):
        self = super().__new__(cls, value)
        self.exact = exact
        return self

    def __repr__(self) -> str:
        return f"MultCount({int(self)}, exact={self.exact})"


# elementwise ops counted by their output's elements
_ELEMENTWISE = frozenset({"mul", "div", "addcmul", "multiply", "divide",
                          "true_divide"})
# products counted as the output's elements times the contracted length
_PRODUCTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
             "addmm": 1, "baddbmm": 1, "addmv": 1}
# ops that take no multiplications
_FREE = frozenset("""
    add sub rsub neg abs sqrt sign sgn cumsum flip cat stack where clone copy
    fill zero zeros zeros_like ones ones_like empty empty_like empty_strided
    full full_like new_zeros new_ones new_empty new_full arange eye
    scalar_tensor lift_fresh lift_fresh_copy alias detach view _unsafe_view
    reshape expand slice select unsqueeze squeeze permute transpose t
    as_strided unbind split split_with_sizes narrow diagonal triu tril
    index index_select gather index_put _index_put_impl scatter
    masked_fill _to_copy to contiguous clamp clamp_min clamp_max maximum
    minimum max min amax amin argmax argmin sum eq ne gt ge lt le
    logical_not logical_and logical_or bitwise_not isfinite isnan isinf
    any all sort argsort _local_scalar_dense item flatten unflatten
    constant_pad_nd pad repeat promote_types result_type is_nonzero
""".split())


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 1


class _Census(TorchDispatchMode):
    """Counts the multiplications of every aten op that runs under it."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.exact = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        base = name.rstrip("_") if not name.startswith("_") else name
        ns = func.namespace
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if ns not in ("aten", "prim", "prims"):
            self.exact = False
        elif base in _ELEMENTWISE:
            self.total += _numel(first)
        elif base == "pow":
            if len(args) > 1 and not isinstance(args[1], torch.Tensor) and args[1] == 2:
                self.total += _numel(first)
            else:
                self.exact = False
        elif base in _PRODUCTS:
            a = args[_PRODUCTS[base]]
            self.total += _numel(first) * a.shape[-1]
        elif base == "linalg_vector_norm":
            self.total += _numel(args[0])
        elif base not in _FREE:
            self.exact = False
        return out


def _kernel_launches() -> tuple:
    from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update

    return (ggr_update.batched_update.launches, ggr_panel.batched_geqrt.launches,
            ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches)


def count_mults(fn, *args, **kwargs) -> MultCount:
    """Empirical multiplication count of ``fn(*args, **kwargs)``: a census of
    the aten ops it runs (see the module docstring).

    Returns a ``MultCount`` whose ``exact`` attribute is False when an op
    ran that the census cannot count — check it before trusting a number in
    a model-validation assert.
    """
    before = _kernel_launches()
    census = _Census()
    with census:
        fn(*args, **kwargs)
    exact = census.exact and _kernel_launches() == before
    return MultCount(census.total, exact)

"""How a CUDA kernel is held against its plain version on the card.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both take from here: the
per-kernel, per-tile-dtype tolerance table, the data a bf16 / f16 case runs
on, and the check that a mixed kernel rounds its state to the tile dtype at
every column step.

Two checks hold a kernel's outputs against its plain version's on the same
inputs:

* ``rel_err`` within ``rel_bound``: the worst error over the rms (one wrong
  row of a tall output shows), a per-kernel, per-tile-dtype constant
  ``REL`` a few times the worst reading over random inputs
  (``tools/readings.py``), grown where rounding grows with the shape: the
  rows of a problem (B1, B2), the column steps an entry sees (B3) or the
  square root of the rows a suffix dot runs over (B4); a bf16 / f16 panel
  (B3) also with the square root of its rows, the size of R's entries,
  whose last bit a rounding flips.  An f32 / f64 case holds each output;
  a bf16 / f16 case holds the parts of its outputs that the algorithm
  determines (``determined``): R and the rows above the last pivot, B3's
  suffix norms T, B4's columns.
* for a bf16 / f16 tile with f32 sums, ``per_step``: each part of the
  outputs (``parts``) as far from the exact result (the plain version in
  f64 on the same tile inputs) as the plain version's, within
  ``ROUNDING``, each row's sign taken as the exact result's and the TRIM
  share of entries farthest from it left out (``bulk_err``).  A kernel that
  rounds the state at every step, as the plain version and the JAX kernel
  do, carries the same rounding error; one that keeps the state in f32 and
  rounds once at the end carries far less, and fails it.

At a bf16 / f16 tile the rows below the last pivot (B1, B2) and B3's
scaled columns V are not determined to the tile's precision: they are
formed by cancellation against the pivot rows, and the sign of a row whose
entry in a column rounds near zero flips with the rounding, so two sound
kernels part there by several times the rms.  ``per_step`` holds them in
bulk: a fault confined to fewer than TRIM of a part's entries escapes it.  The bf16 / f16 cases run on ``condition_``-ed data, as the main
path's states are: an upper-triangular state of Gaussian entries has a
condition number near 2^n, and then R itself is roundoff.

The wide pairs (f32 / bf16 / f16 tiles with f64 sums, in all four kernels)
sum in f64 in another order than the plain version (B4 also by another
formula, the rotation form of ``csrc/ggr_apply.cu``), and rounding each
value to the tile dtype hides the difference almost always.  ``wide_held`` holds the
WIDE_DRAWS draws of a shape together: the share of their entries bitwise
equal to the plain version's (``equal_share``) at least WIDE_EQUAL, and
every draw's max|err| / rms within ``wide_bound`` (``wide_accurate``).  The
control, the same inputs through the (tile, float32) instance (a kernel
that quietly sums in f32), must fail it.  A value rounded to the other
side of a tie flips the later column steps of its problem, so the share is
a statistic of many problems: a draw of a few problems may hold a whole
flipped one.  ``narrow_on_card`` runs ``ggr_common.cuh``'s casts from
double alone.
"""
from __future__ import annotations

import math

import torch

# kernel name -> tile dtype name -> bound on max|err| / rms against the
# plain version at the same (tile, accumulation) pair, before rel_bound's
# growth: of each output at f32 / f64, of each determined part at bf16 /
# f16 (f32 accumulation, condition_-ed data)
REL = {"batched_update": {"float32": 7.5e-4, "float64": 1e-12,
                          "bfloat16": 0.25, "float16": 0.04},
       "batched_geqrt": {"float32": 1e-3, "float64": 3e-12,
                         "bfloat16": 0.8, "float16": 0.12},
       "panel_factor": {"float32": 3e-4, "float64": 3e-12,
                        "bfloat16": 1.0, "float16": 0.2},
       "apply_factors": {"float32": 2e-4, "float64": 3e-13,
                         "bfloat16": 0.25, "float16": 0.03}}
# the accumulation dtype of each tile dtype's kernels: the named policies
ACCUM = {"float32": "float32", "float64": "float64", "bfloat16": "float32",
         "float16": "float32"}
# each mixed tile dtype's named policy (f32 accumulation), by its short name
POLICY = {"bfloat16": "bf16", "float16": "mixed_f16"}
# a mixed kernel's distance from the exact result over the plain version's,
# each part of its outputs (bulk_err): the band a kernel that rounds at
# every step lands in (sound kernels read 0.75-1.29 on the card, and the
# f32 plain version rounded once reads 0.17 or less on some part of every
# case that has one of READ_ENTRIES: tools/readings.py)
ROUNDING = (0.5, 2.0)
# the share of a part's entries, those farthest from the exact result, that
# its error leaves out: a row whose sign or whose entry in a column flips
# with the rounding (the parts ``determined`` leaves out) is not rounding
# error, and at f16 one such row can set a part's whole distance
TRIM = 0.01
# a part is read where the plain version misses the exact result in at
# least this many entries: on fewer (the 64 x 64 block a panel's last
# columns leave, a few problems' residual rows) its ratio is not a
# statistic, and two sound kernels read anywhere from 0.04 to 6
READ_ENTRIES = 8192
# a Gaussian block of at least TALL times as many rows as columns has a
# condition number of at most 3, and is left as it is
TALL = 4


def dtype_name(dtype) -> str:
    """'bfloat16' for torch.bfloat16 or 'bfloat16'."""
    return str(dtype).removeprefix("torch.")


def rel_bound(name: str, m: int, w: int, dtype) -> float:
    grow = {"batched_update": m / 64, "batched_geqrt": m / 64,
            "panel_factor": w / 64, "apply_factors": (m / 4096) ** 0.5}[name]
    if name == "panel_factor" and dtype_name(dtype) in POLICY:
        grow = max(grow, (m / 4096) ** 0.5)
    return REL[name][dtype_name(dtype)] * max(1.0, grow)


def rms_of(r: torch.Tensor) -> float:
    return float(r.double().square().mean().sqrt()) if r.numel() else 0.0


def rel_err(o: torch.Tensor, r: torch.Tensor) -> float:
    """max|o - r| / rms(r), in f64; 0 for two empty or equal zero outputs."""
    e = float((o.double() - r.double()).abs().max()) if o.numel() else 0.0
    rms = rms_of(r)
    return e / rms if rms > 0 else (0.0 if e == 0 else math.inf)


def fro_err(o: torch.Tensor, r: torch.Tensor) -> float:
    """||o - r||_F / ||r||_F, in f64 (0 where r is zero and o equals it)."""
    d = float(torch.linalg.norm(o.double() - r.double()))
    n = float(torch.linalg.norm(r.double()))
    return d / n if n > 0 else (0.0 if d == 0 else math.inf)


def _add_diagonal(x: torch.Tensor, row0: int, k: int, c: float) -> None:
    i = torch.arange(k, device=x.device)
    x[:, row0 + i, i] += c


def condition_(x: torch.Tensor, name: str, param) -> torch.Tensor:
    """Make every problem of a (B, m, w) Gaussian batch well conditioned, in
    place, as the kernel ``name`` with ``param`` takes it (the pivot count,
    pivot0, or (b, pivot0) for the panel behind apply_factors' factors):

    * batched_update: the top n_piv rows upper triangular with 3 sqrt(n_piv)
      added to their diagonal (cond of the state at most ~3);
    * batched_geqrt, panel_factor: the pivot block (its rows from the first
      pivot row down, its pivot columns) gets 3 sqrt(max(rows, columns)) on
      its diagonal unless it is TALL (then cond <= 3 already).

    Returns x."""
    B, m, w = x.shape
    if name == "batched_update":
        n = param
        x[:, :n, :n] = torch.triu(x[:, :n, :n])
        _add_diagonal(x, 0, n, 3.0 * math.sqrt(n))
        return x
    row0, cols = (0, min(param, w)) if name == "batched_geqrt" else (
        (param if isinstance(param, int) else param[1]), w)
    rows = m - row0
    if 0 < rows < TALL * cols:
        _add_diagonal(x, row0, min(rows, cols), 3.0 * math.sqrt(max(rows, cols)))
    return x


def mixed_inputs(name: str, shape, param, dtype, generator):
    """(x, plain(z, accum_dtype), factors) of a bf16 / f16 case:
    ``condition_``-ed Gaussian inputs of ``shape`` on the generator's device
    and the kernel's plain version over them; for apply_factors, factors =
    (V, T) of a conditioned (B, m, b) panel (f32 sums) and x is C, else
    None."""
    from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update

    def randn(*s):
        return torch.randn(s, generator=generator, device=generator.device, dtype=dtype)

    x = randn(*shape)
    if name == "apply_factors":
        b, pivot0 = param
        pan = condition_(randn(shape[0], shape[1], b), name, param)
        _, V, T = ggr_panel.panel_factor_plain(pan, pivot0, "float32")
        return x, lambda z, a: ggr_apply.apply_factors_plain(V.to(z.dtype), T.to(z.dtype), z,
                                                             pivot0, a), (V, T)
    plain = {"batched_update": ggr_update.batched_update_plain,
             "batched_geqrt": ggr_panel.batched_geqrt_plain,
             "panel_factor": ggr_panel.panel_factor_plain}[name]
    return condition_(x, name, param), lambda z, a: plain(z, param, a), None


def parts(name: str, param, outs) -> tuple:
    """The parts of a kernel's outputs that ``per_step`` holds each on its
    own: B1's and B2's rows above the last pivot (written once each) and
    the rows below (rewritten at every step: where rounding at every step
    shows most; either may be empty), R, V and T of B3, and B4's columns."""
    if name not in ("batched_update", "batched_geqrt"):
        return tuple(outs)
    (o,) = outs
    return o[:, :param], o[:, param:]


# for each part (``parts``), whether the algorithm determines it at a
# bf16 / f16 tile: what ``rel_bound`` holds there
DETERMINED = {"batched_update": (True, False), "batched_geqrt": (True, False),
              "panel_factor": (True, False, True), "apply_factors": (True,)}


def determined(name: str, param, outs) -> tuple:
    """The parts of a bf16 / f16 kernel's outputs the algorithm determines."""
    return tuple(p for p, d in zip(parts(name, param, outs), DETERMINED[name]) if d)


def _signed_as(o: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """o in f64 with each row (the last dimension) negated where it points
    away from the same row of e."""
    o = o.double()
    flip = (o * e.double()).sum(-1, keepdim=True) < 0
    return torch.where(flip, -o, o)


def bulk_err(o: torch.Tensor, e: torch.Tensor) -> float:
    """||o - e||_F / ||e||_F in f64, each row of o signed as e's, over all
    but the TRIM share of entries farthest from e."""
    d = (_signed_as(o, e) - e.double()).flatten().square()
    drop = int(TRIM * d.numel())
    total = float(d.sum()) - (float(d.topk(drop).values.sum()) if drop else 0.0)
    n = float(torch.linalg.norm(e.double()))
    return math.sqrt(max(total, 0.0)) / n if n > 0 else 0.0


def error_ratios(outs, plains, exacts) -> list:
    """Each part's ``bulk_err`` from the exact result over the plain
    version's, for the parts the plain version misses in at least
    READ_ENTRIES entries, more than TRIM leaves out (a part it gets exactly
    reads inf where the kernel misses it)."""
    ratios = []
    for o, p, e in zip(outs, plains, exacts):
        misses = int((p.double() != e.double()).sum())
        if misses == 0:
            if not torch.equal(o.double(), e.double()):
                ratios.append(math.inf)
        elif misses >= READ_ENTRIES and (ep := bulk_err(p, e)) > 0:
            ratios.append(bulk_err(o, e) / ep)
    return ratios


def per_step(outs, plains, exacts) -> tuple:
    """(every part's error_ratios within ROUNDING, the ratios): whether
    ``outs`` carry the rounding of a state rounded at every step.  Takes
    the parts (``parts``) of the outputs, the plain version's at the same
    pair and the exact result's."""
    ratios = error_ratios(outs, plains, exacts)
    lo, hi = ROUNDING
    return all(lo <= r <= hi for r in ratios), ratios


# ---------------------------------------------------------------- wide pairs
# every kernel has f64-summed instances of f32 / bf16 / f16 tiles
WIDE_DRAWS = 16
# the least share of the entries of a shape's draws bitwise equal to the
# plain version's, by tile dtype: between the sound kernels' least reading
# (f32 0.99960, bf16 0.9999998, f16 0.99950) and the (tile, float32)
# control's most (0.70357, 0.99889, 0.99116) at chip_smoke.py phase 3's
# shapes (PERF.md §6, PR 29)
WIDE_EQUAL = {"float32": 0.998, "bfloat16": 0.9995, "float16": 0.997}


def equal_share(outs, refs) -> float:
    """The share of the entries of ``outs`` whose bits equal those of
    ``refs`` (NaN equal to NaN), over all outputs together."""
    same = total = 0
    for o, r in zip(outs, refs):
        same += int(((o == r) | (o.isnan() & r.isnan())).sum())
        total += o.numel()
    return same / total if total else 1.0


def wide_bound(name: str, m: int, w: int, tile) -> float:
    """The bound on a wide case's max|err| / rms: f32 tiles hold each
    output to the f32 ``rel_bound``; at a bf16 / f16 tile one value rounded
    to the other side of a tie already differs by 2^-8 / 2^-11 of itself,
    and the rows it flips are not determined at the tile dtype, so the
    determined parts are held to the tile dtype's bound, as a mixed case's."""
    return rel_bound(name, m, w, "float32" if dtype_name(tile) == "float32" else tile)


def wide_reading(name: str, param, tile, outs, refs) -> tuple:
    """(equal_share of every entry, the worst rel_err of the parts
    ``wide_bound`` holds) of a wide case's outputs against the plain
    version's at the same pair."""
    held = ((outs, refs) if dtype_name(tile) == "float32" else
            (determined(name, param, outs), determined(name, param, refs)))
    return equal_share(outs, refs), max((rel_err(o, r) for o, r in zip(*held)), default=0.0)


def wide_accurate(name: str, m: int, w: int, tile, readings) -> bool:
    """Every reading's max|err| / rms within ``wide_bound``."""
    return max(r for _, r in readings) <= wide_bound(name, m, w, tile)


def wide_held(name: str, m: int, w: int, tile, readings) -> bool:
    """Whether the draws of a shape pass the wide rule: ``readings`` one
    ``wide_reading`` a draw (draws of one shape, so of as many entries
    each); their mean share at least WIDE_EQUAL[tile] and ``wide_accurate``."""
    shares = [sh for sh, _ in readings]
    return (sum(shares) / len(shares) >= WIDE_EQUAL[dtype_name(tile)]
            and wide_accurate(name, m, w, tile, readings))


_NARROW_SRC = r"""
#include "ggr_common.cuh"

template <typename S>
__global__ void narrow_all(const double* x, S* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = ggr::narrow<S>(x[i]);
}

template <typename S>
static int run(const double* x, S* y, int n, void* stream) {
  narrow_all<S><<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

extern "C" int narrow_f32(const double* x, float* y, int n, void* s) { return run(x, y, n, s); }
extern "C" int narrow_bf16(const double* x, __nv_bfloat16* y, int n, void* s) {
  return run(x, y, n, s);
}
extern "C" int narrow_f16(const double* x, __half* y, int n, void* s) { return run(x, y, n, s); }
"""


def build_narrow():
    """The shared library of ``narrow_on_card``'s kernel, built with nvcc
    into the kernels' build directory (once: the name carries a hash of the
    source, the header and the flags); its path."""
    import hashlib
    import os
    import subprocess

    from repro_torch.kernels import _cuda

    h = hashlib.sha256(_NARROW_SRC.encode() + " ".join(_cuda._FLAGS).encode())
    h.update((_cuda._CSRC / "ggr_common.cuh").read_bytes())
    lib = _cuda.build_dir() / f"libnarrow-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        _cuda.build_dir().mkdir(parents=True, exist_ok=True)
        src = lib.with_name(f"narrow-{os.getpid()}.cu")
        src.write_text(_NARROW_SRC)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run([_cuda._nvcc(), *_cuda._FLAGS, "-I", str(_cuda._CSRC), "-o", str(tmp),
                        str(src)], check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
        src.unlink()
    return lib


def narrow_on_card(x: torch.Tensor, dtype) -> torch.Tensor:
    """Each value of the float64 CUDA tensor ``x`` cast to ``dtype``
    (float32, bfloat16 or float16) by ``ggr_common.cuh``'s ``narrow``, the
    cast every wide kernel stores its values with (``build_narrow``)."""
    import ctypes

    lib = build_narrow()
    dtype = getattr(torch, dtype_name(dtype))
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[dtype]
    fn = getattr(ctypes.CDLL(str(lib)), f"narrow_{suffix}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    err = fn(x.data_ptr(), y.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"narrow_{suffix} launch failed: CUDA error {err}")
    return y


def tie_values() -> torch.Tensor:
    """f64 values near the ties of each narrowing cast, both signs: a
    double just above an f16 tie (1 + 2^-11 + 2^-40: 1 + 2^-10 once
    rounded, 1 through float32), just above a bf16 tie (1 + 2^-8 + 2^-40:
    1 through float32 as torch and XLA round it, 1 + 2^-7 once), an f32 tie
    and the values either side of it, f16 subnormals and overflow."""
    v = [1 + 2.0 ** -11 + 2.0 ** -40, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
         1 + 2.0 ** -8 + 2.0 ** -40, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
         1 + 2.0 ** -24, 1 + 2.0 ** -24 + 2.0 ** -50, 1 + 2.0 ** -24 - 2.0 ** -50,
         2.0 ** -25 + 2.0 ** -70, 3 * 2.0 ** -26, 65519.99, 65520.0, 0.0, 1e-320]
    t = torch.tensor(v, dtype=torch.float64)
    return torch.cat([t, -t])
